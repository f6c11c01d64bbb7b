// K2 -- exact dequant + fixed-point 8x8 IDCT on the [N, 64, BL] layout.
//
// Replaces: espflix_tpu/ops/idct_pallas.py _kernel_T
// (block_residuals_T_pallas).
//
// What bounds it on an H100: memory.  Per 8x8 block it reads 64 int16
// levels and writes 64 int16 residuals (256 B) for ~1k integer ops, far
// below the card's ops:byte balance.  The TPU kernel kept one lane's
// [64, BL] tile in VMEM and ran the butterflies as (8, BL) slab ops.
// Here a CTA of 128 threads takes a tile of TB = 64 consecutive blocks
// of one lane:
//
//   * it copies the tile's [64, TB] levels into shared memory with
//     cp.async, so that no register holds them (39 registers, twelve
//     CTAs an SM), in the widest vector that BL's and the pointers'
//     alignment allow (V of 8, 4, 2 or 1 int16, a template parameter),
//     while it reads the tile's nfinal, intra flags and qscales;
//   * the blocks that run the butterflies (coded, not a DC shortcut) go
//     into a list, and each warp takes four listed blocks at a time:
//     K2F's scheme from the tile, thread j dequantising column j (a
//     row of levels that is zero in all four blocks costs one vote)
//     and running the column pass, an 8 x 9 int32 tile, the row pass
//     on row j and the residuals back into the level tile.  On the
//     bench's I- and P-heavy ticks 31% and 24% of the blocks are
//     listed, while 62% and 58% of the warps of four consecutive blocks
//     held one;
//   * the residual tile goes out with the same vector stores, 0 or the
//     DC in place of each block that ran no butterflies.
//
// Reading only the levels the listed blocks need puts a dependent load
// before the copy, and measured slower than reading them all.  The
// tile's rows are TS = TB + 8 int16: 16-byte rows for the copies, and a
// warp's column accesses fall in distinct banks.
//
// Bit-exact with idct_pallas.py:180-207 and idct.block_residuals_T:
// doubling + oddification + truncating /16, the +-2048 clip, intra DC
// as lev << 8, the 473/196/362 butterflies with (x+128)>>8 rounding on
// the row pass, the nfinal == 1 non-intra DC shortcut and the zero
// block for nfinal == 0; int32 arithmetic wraps, the result wraps to
// int16.
//
// K2F (esp_idct_flat) -- the same dequant and butterflies on the
// lane-minor layout, levels int16[N, MB*384] -> residuals int16[N,
// MB*6, 64].  Replaces: espflix_tpu/ops/idct_pallas.py _kernel
// (block_residuals_pallas) and the XLA block_residuals_flat of the
// lane-minor dense phase (models/mpeg1.py:571-590).  Bound by memory as
// K2 is.  A block's 64 values are contiguous here, so a thread that
// owned a whole block would hold 64 values under dynamic indices
// (local memory) and a warp's accesses would touch 32 lines an
// instruction.  Instead eight threads own a block, four blocks a warp.
// Thread j loads column j (eight 2-byte loads, which together read the
// warp's 512 contiguous bytes), dequantises it and runs the column
// pass in registers, hands the column on through an 8 x 9 int32 tile
// in shared memory (padded so that a warp's four tiles fall in
// distinct banks), runs the row pass on row j and stores it as one
// 16-byte vector.  The eight threads share nfinal and the MB record,
// so they never diverge from each other: an uncoded block costs its
// coalesced zero stores, the DC shortcut one broadcast load.

#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

#include "idct.cuh"
#include "resources.cuh"

namespace {

// K2: a CTA a tile of TB blocks of one lane, T_THREADS threads, eight a
// block in the butterflies (four blocks a warp).
constexpr int T_THREADS = 128;
constexpr int WARPS = T_THREADS / 32;
constexpr int TB = 64;                  // blocks (bl) a tile
constexpr int TS = TB + 8;              // int16 a tile row: 36 words
static_assert(TB % 32 == 0 && TB <= T_THREADS, "a warp's flags a word");

// a tile's V-element vectors, PER a thread: thread t takes vectors
// t, t + T_THREADS, ...; vector i is position i / VPR's blocks
// e .. e + V - 1, e = (i % VPR) * V
template <int V> struct TileVecs {
  static constexpr int VPR = TB / V;    // vectors a tile row
  static constexpr int PER = 64 * VPR / T_THREADS;
  static_assert(64 * VPR % T_THREADS == 0, "whole vectors a thread");
};

// V int16 in 32-bit words (V = 1: one word, its low half)
template <int V> struct Words {
  static constexpr int N = V < 2 ? 1 : V / 2;
  uint32_t w[N];
};

// V int16 to global memory, one access of 2 V bytes
template <int V>
__device__ __forceinline__ void store_vec(int16_t* p, const Words<V>& r) {
  if constexpr (V == 8) {
    *reinterpret_cast<uint4*>(p) = make_uint4(r.w[0], r.w[1], r.w[2], r.w[3]);
  } else if constexpr (V == 4) {
    *reinterpret_cast<uint2*>(p) = make_uint2(r.w[0], r.w[1]);
  } else if constexpr (V == 2) {
    *reinterpret_cast<uint32_t*>(p) = r.w[0];
  } else {
    *reinterpret_cast<uint16_t*>(p) = (uint16_t)r.w[0];
  }
}

// V int16 from shared memory at an element offset that is a multiple of
// V: one access of 2 V bytes
template <int V>
__device__ __forceinline__ Words<V> get_words(const int16_t* src) {
  Words<V> r;
  if constexpr (V == 8) {
    const uint4 x = *reinterpret_cast<const uint4*>(src);
    r.w[0] = x.x; r.w[1] = x.y; r.w[2] = x.z; r.w[3] = x.w;
  } else if constexpr (V == 4) {
    const uint2 x = *reinterpret_cast<const uint2*>(src);
    r.w[0] = x.x; r.w[1] = x.y;
  } else if constexpr (V == 2) {
    r.w[0] = *reinterpret_cast<const uint32_t*>(src);
  } else {
    r.w[0] = (uint16_t)*src;
  }
  return r;
}

template <int V>
__global__ void __launch_bounds__(T_THREADS)
    idct_T_kernel(const int16_t* __restrict__ coeffs_T,
                  const uint8_t* __restrict__ intra_bl,
                  const int* __restrict__ qs_bl,
                  const int* __restrict__ intra_q,
                  const int* __restrict__ non_intra_q,
                  const int* __restrict__ nfinal,
                  const int* __restrict__ scale,
                  int16_t* __restrict__ out, int BL) {
  using TV = TileVecs<V>;
  // non-intra matrix at 0, intra at TILE: other banks for the 8 offset
  __shared__ int qm[TILE + 64];
  __shared__ int sc[64];
  __shared__ __align__(16) int16_t lv[64 * TS];  // levels, then residuals
  __shared__ int tiles[T_THREADS / 8 * TILE];
  __shared__ int qs_s[TB];
  __shared__ uint8_t intra_s[TB];
  // the residual of a block without butterflies: 0, or its DC
  __shared__ __align__(16) int16_t fill[TB];
  // bit b: block b runs the butterflies; the tile's such blocks in order
  __shared__ uint32_t full_s[TB / 32];
  __shared__ uint8_t list[TB];
  const int n = blockIdx.y, bl0 = blockIdx.x * TB, t = threadIdx.x;

  // the tile's levels, every vector inside the lane's rows, straight
  // into the tile (V divides BL, so a vector lies wholly inside or past
  // its row), while the flags load
  const int16_t* src = coeffs_T + (size_t)n * 64 * BL + bl0;
#pragma unroll
  for (int q = 0; q < TV::PER; ++q) {
    const int i = t + q * T_THREADS;
    const int p = i / TV::VPR, e = (i % TV::VPR) * V;
    if (bl0 + e < BL) copy_in<V>(lv + p * TS + e, src + (size_t)p * BL + e);
  }
  for (int i = t; i < 64; i += T_THREADS) {
    qm[i] = non_intra_q[n * 64 + i];
    qm[TILE + i] = intra_q[n * 64 + i];
    sc[i] = scale[i];
  }
  int nf = 0;
  bool full = false;
  if (t < TB) {
    const int bl = bl0 + t;
    int qs = 0;
    bool intra = false;
    if (bl < BL) {
      const size_t i = (size_t)n * BL + bl;
      nf = nfinal[i];
      intra = intra_bl[i] != 0;
      qs = qs_bl[i];
    }
    qs_s[t] = qs;
    intra_s[t] = intra;
    full = nf != 0 && !(nf == 1 && !intra);
    const uint32_t m = __ballot_sync(0xFFFFFFFFu, full);
    if ((t & 31) == 0) full_s[t >> 5] = m;
  }
  copy_wait();
  __syncthreads();

  int nfull = 0;
#pragma unroll
  for (int k = 0; k < TB / 32; ++k) nfull += __popc(full_s[k]);
  if (t < TB) {
    if (full) {
      int pos = __popc(full_s[t >> 5] & ((1u << (t & 31)) - 1));
      for (int k = 0; k < (t >> 5); ++k) pos += __popc(full_s[k]);
      list[pos] = t;
    }
    // an uncoded block's residuals are 0, a DC shortcut's its DC
    fill[t] = nf == 1 && !full
                  ? (int16_t)(dequant(lv[t], 0, false, qs_s[t], qm, sc) >> 8)
                  : 0;
  }
  __syncthreads();

  // the butterflies, four listed blocks a warp at a time: thread j of
  // the warp's group g4 takes column j, then row j, of block
  // list[base + g4]; a group past the list repeats the warp's first
  // block and stores nothing, so that the warp stays converged
  const int g4 = (t >> 3) & 3, j = t & 7;
  int* tt = tiles + (t >> 3) * TILE;
#pragma unroll 1
  for (int base = (t >> 5) * 4; base < nfull; base += WARPS * 4) {
    const bool active = base + g4 < nfull;
    const int b = list[active ? base + g4 : base];
    int16_t* col = lv + b;                    // (p, b) at col[p * TS]
    const int qs = qs_s[b];
    const bool intra = intra_s[b];
    const int* qmat = qm + (intra ? TILE : 0);
    int c[8], o[8];
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int lev = col[(8 * r + j) * TS];
      // a zero level dequantises to 0 (an intra DC too)
      c[r] = __any_sync(0xFFFFFFFFu, lev != 0)
                 ? dequant(lev, 8 * r + j, intra, qs, qmat, sc)
                 : 0;
    }
    butterfly(c, o, false);                   // column j, rows k
#pragma unroll
    for (int k = 0; k < 8; ++k) tt[9 * k + j] = o[k];
    __syncwarp();
#pragma unroll
    for (int m = 0; m < 8; ++m) c[m] = tt[9 * j + m];
    __syncwarp();                             // tt is free for the next
    butterfly(c, o, true);                    // row j, final rounding
    // back to column j through tt: the tile's column stores fall in
    // distinct banks, its row stores would not
#pragma unroll
    for (int m = 0; m < 8; ++m) tt[9 * j + m] = o[m];
    __syncwarp();
    if (active) {
#pragma unroll
      for (int k = 0; k < 8; ++k)
        col[(8 * k + j) * TS] = (int16_t)tt[9 * k + j];
    }
    __syncwarp();                             // tt is free for the next
  }
  __syncthreads();

  // out: the butterflies' residuals where a block ran them, else its
  // fill value, 16 bits at a time
  int16_t* dst = out + (size_t)n * 64 * BL + bl0;
#pragma unroll
  for (int q = 0; q < TV::PER; ++q) {
    const int i = t + q * T_THREADS;
    const int p = i / TV::VPR, e = (i % TV::VPR) * V;
    if (bl0 + e < BL) {
      const Words<V> res = get_words<V>(lv + p * TS + e);
      const Words<V> fw = get_words<V>(fill + e);
      const uint32_t bits = full_s[e >> 5] >> (e & 31);
      Words<V> r;
#pragma unroll
      for (int k = 0; k < Words<V>::N; ++k) {
        const uint32_t keep = (bits >> (2 * k) & 1 ? 0xFFFFu : 0) |
                              (bits >> (2 * k + 1) & 1 ? 0xFFFF0000u : 0);
        r.w[k] = (res.w[k] & keep) | (fw.w[k] & ~keep);
      }
      store_vec<V>(dst + (size_t)p * BL + e, r);
    }
  }
}

// K2F: eight threads a block (a block's group), four blocks a warp;
// thread j of a group holds column j, then row j, in registers.  Intra
// flag and qscale come from the block's MB record.
constexpr int FLAT_THREADS = 128;

__global__ void __launch_bounds__(FLAT_THREADS)
    idct_flat_kernel(const int16_t* __restrict__ coeffs,
                     const int* __restrict__ recs,
                     const int* __restrict__ nfinal,
                     const int* __restrict__ intra_q,
                     const int* __restrict__ non_intra_q,
                     const int* __restrict__ scale,
                     int16_t* __restrict__ out, int MB) {
  // non-intra matrix at 0, intra at TILE: other banks for the 8 offset
  __shared__ int qm[TILE + 64];
  __shared__ int sc[64];
  __shared__ int tiles[FLAT_THREADS / 8 * TILE];
  const int n = blockIdx.y;
  for (int i = threadIdx.x; i < 64; i += blockDim.x) {
    qm[i] = non_intra_q[n * 64 + i];
    qm[TILE + i] = intra_q[n * 64 + i];
    sc[i] = scale[i];
  }
  __syncthreads();
  const int BL = MB * 6;
  const int g = threadIdx.x >> 3, j = threadIdx.x & 7;
  const int bl = blockIdx.x * (FLAT_THREADS / 8) + g;
  if (bl >= BL) return;                    // the ragged tail, by groups
  const size_t base = ((size_t)n * BL + bl) * 64;
  uint4* dst = reinterpret_cast<uint4*>(out + base) + j;     // row j
  const int nf = nfinal[(size_t)n * BL + bl];
  if (nf == 0) {
    *dst = make_uint4(0, 0, 0, 0);
    return;
  }
  const int rec = recs[(size_t)n * MB + bl / 6];
  const bool intra = (rec & 3) == 3;           // MB_INTRA
  const int qs = (rec >> 2) & 31;
  const int* qmat = qm + (intra ? TILE : 0);
  const int16_t* src = coeffs + base;
  if (nf == 1 && !intra) {
    const uint32_t dc =
        (uint16_t)(dequant(__ldg(src), 0, false, qs, qmat, sc) >> 8);
    const uint32_t w = dc | dc << 16;
    *dst = make_uint4(w, w, w, w);
    return;
  }
  int col[8], o[8];
#pragma unroll
  for (int r = 0; r < 8; ++r)
    col[r] = dequant(__ldg(src + 8 * r + j), 8 * r + j, intra, qs, qmat, sc);
  butterfly(col, o, false);                // column j, rows k
  int* t = tiles + g * TILE;
#pragma unroll
  for (int k = 0; k < 8; ++k) t[9 * k + j] = o[k];
  __syncwarp(0xFFu << (threadIdx.x & 24));  // the group's eight lanes
  int row[8];
#pragma unroll
  for (int m = 0; m < 8; ++m) row[m] = t[9 * j + m];
  butterfly(row, o, true);                 // row j, final rounding
  uint32_t w[4];
#pragma unroll
  for (int k = 0; k < 4; ++k)
    w[k] = (uint32_t)(uint16_t)o[2 * k] |
           (uint32_t)(uint16_t)o[2 * k + 1] << 16;
  *dst = make_uint4(w[0], w[1], w[2], w[3]);
}

}  // namespace

extern "C" int esp_idct_T(const void* coeffs_T, const void* intra_bl,
                          const void* qs_bl, const void* intra_q,
                          const void* non_intra_q, const void* nfinal,
                          const void* scale, void* out, int N, int BL,
                          void* stream) {
  if (N == 0 || BL == 0) return (int)cudaSuccess;
  // the widest vector that every row start of both tensors allows
  const uintptr_t a = (uintptr_t)coeffs_T | (uintptr_t)out |
                      (uintptr_t)BL * sizeof(int16_t);
  const auto kernel = a % 16 == 0 ? idct_T_kernel<8>
                      : a % 8 == 0 ? idct_T_kernel<4>
                      : a % 4 == 0 ? idct_T_kernel<2>
                                   : idct_T_kernel<1>;
  dim3 grid((BL + TB - 1) / TB, N);
  kernel<<<grid, T_THREADS, 0, (cudaStream_t)stream>>>(
      (const int16_t*)coeffs_T, (const uint8_t*)intra_bl,
      (const int*)qs_bl, (const int*)intra_q, (const int*)non_intra_q,
      (const int*)nfinal, (const int*)scale, (int16_t*)out, BL);
  return (int)cudaGetLastError();
}

extern "C" int esp_idct_flat(const void* coeffs, const void* recs,
                             const void* nfinal, const void* intra_q,
                             const void* non_intra_q, const void* scale,
                             void* out, int N, int MB, void* stream) {
  const int groups = FLAT_THREADS / 8;
  dim3 grid((MB * 6 + groups - 1) / groups, N);
  idct_flat_kernel<<<grid, FLAT_THREADS, 0, (cudaStream_t)stream>>>(
      (const int16_t*)coeffs, (const int*)recs, (const int*)nfinal,
      (const int*)intra_q, (const int*)non_intra_q, (const int*)scale,
      (int16_t*)out, MB);
  return (int)cudaGetLastError();
}

// K2's (at each vector width) and K2F's registers, local and static
// shared bytes and largest block on the current device (resources.cuh).
extern "C" int esp_idct_resources(int* out, const char** names, int cap) {
  const void* fns[] = {
      (const void*)idct_T_kernel<8>, (const void*)idct_T_kernel<4>,
      (const void*)idct_T_kernel<2>, (const void*)idct_T_kernel<1>,
      (const void*)idct_flat_kernel};
  const char* kernel_names[] = {"idct_T_kernel<8>", "idct_T_kernel<4>",
                                "idct_T_kernel<2>", "idct_T_kernel<1>",
                                "idct_flat_kernel"};
  return kernel_resources(fns, kernel_names, 5, out, names, cap);
}
