// K3 -- half-pel MB prediction fused with compose and the parity put;
// K23 (below) -- K2's dequant and IDCT fused into K3, the main path's
// decode of an MB row in one pass.
//
// Replaces: espflix_tpu/ops/mocomp_pallas.py _phase2p_kernel (luma,
// predict_plane_phase2p) and _packedp_kernel (u+v,
// predict_chroma_pair_packedp accum=True), plus the residual-plane
// assembly, compose and put of models/mpeg1.dense_compose (coeffs_T
// path, mpeg1.py:562-664).  It computes what every predict_plane
// variant of mocomp_pallas.py computes, with the main path's edge rule.
// K3F (esp_compose_put_flat) is the same kernel reading K2F's
// lane-minor residuals int16[N, MB*6, 64] instead of K2's [N, 64, BL]:
// it replaces mocomp_pallas.py _compose_kernel (compose_plane_pallas)
// and _compose2_kernel (compose_plane_pallas2), y, u and v in one
// launch, with the lane-minor plane assembly (models/mpeg1.py:592-609)
// as index arithmetic.
//
// Semantics: mocomp.predict_plane_mxu's edge rule (window origin
// clip(xh >> 1, 0, W - S), zero past the plane), MPEG-1 half-pel
// rounding, chroma MVs >> 1; STALE keeps cur, INTRA is pin(res), else
// pin(int16(pred + res)) with pin = clip to 0..248; inactive lanes keep
// cur.
//
// What bounds it on an H100: memory.  A 352x192 lane moves 608 KB --
// its residuals (2 B a pixel), both frame slots, the parity slot and
// the presented planes written -- and does a few integer operations a
// byte.  A kernel that walks the pixels one byte a thread instead pays
// for instruction issue: a runtime division or modulo to place every
// pixel, byte loads whose latencies queue behind each other, and the
// residuals staged once per plane.
//
// The design: one block per (MB row, lane) covers all three planes,
// blockDim (16, mbw).  Thread (yi, c) owns luma row yi of MB c as one
// 16-byte vector and chroma row yi & 7 of MB c -- in u for yi < 8, in v
// otherwise -- as one 8-byte vector, so every thread does the same work
// and nothing is divided by a runtime value.  cur, out and the put move
// as uint4 / uint2 (an MB column starts at c * S, and W is a multiple
// of 16).  Residuals: K3F's block row is 16 contiguous bytes of [N, BL,
// 64], loaded straight from global memory (a warp's eight threads of a
// block read its 128 bytes); K3's MB row of 64 x 6*mbw int16 is staged
// once per block, read coalesced along bl and stored transposed to
// [bl][72] (8 int16 of padding keep a quarter-warp's 16-byte accesses
// in distinct banks), so a thread reads its block row as one 16-byte
// shared load.  Prediction reads the S/4 + 1 aligned 32-bit words that
// cover a row's S + 1 taps through the read-only path and cuts the
// taps out with funnel shifts; a word past the right edge, and the row
// past the bottom, read 0 (rule A).  Two-tap averages are __vavgu4
// ((a + b + 1) >> 1 a byte), the four-tap one works in 16-bit lanes,
// and pred + res, the int16 wrap and the pin run two pixels a word
// (__vadd2, __vmaxs2, __vmins2).  An INTRA MB reads no reference; a
// STALE MB or an inactive lane reads no residual and writes only `out`
// (from cur), never storing back into cur.
//
// The put writes IN PLACE into frames[:, parity]: the prediction reads
// only the reference slot 1 - parity, and each byte of the parity slot
// is read (as `cur`) and written by the thread that owns it, so no
// thread reads what another writes.  The presented planes go to
// separate tensors.
//
// K3P (esp_predict, which also predicts both chroma planes in one
// launch, as _packed_kernel predicts the pair) -- prediction alone, for
// a band of MB rows.
// Replaces mocomp_pallas.py _kernel (predict_plane_pallas), the
// _phase_kernel, _phase2_kernel and _phase4_kernel luma forms and
// _packed_kernel: every one of them computes predict_plane and nothing
// else; the mesh's decoders compose afterwards in torch ops, as the JAX
// package composes in XLA.  The JAX package has two edge rules, and K3P
// takes the rule as a template parameter:
//   rule A (CLIP_TAPS = false): the window origin is clamped, clip(xh >>
//     1, 0, W - S), and taps past the plane read zero -- the five Pallas
//     kernels and mocomp.predict_plane_mxu (mocomp_pallas.py:55-56,
//     :1221-1225);
//   rule B (CLIP_TAPS = true): each tap is clamped into the plane,
//     clip(x, 0, W - 1) -- mocomp.predict_plane and predict_plane_rows
//     (mocomp.py:54-57, :208-211), which the 'space' split uses.
// The band holds MB rows [row0, row0 + mbh_loc) of a full-height
// reference plane (H rows); the output is the band, [N, mbh_loc*S, W].
//
// What bounds it: memory -- each output byte is written once and the
// windows' taps are mostly cache hits of the reference rows the MBs
// share.  A kernel that makes one 4-byte word a thread instead pays for
// instruction issue: four runtime divisions to place the word, the MB's
// vectors reloaded, sixteen byte loads with their own clamps.  The
// design: a thread owns one S-pixel row of one MB, blockDim (S, mbw, R)
// as K3 has it, with R MB rows a block (PREDICT_THREADS), placed by
// threadIdx and blockIdx alone.  A warp holds two luma MBs or four
// chroma ones, so the few MBs that take rule B's byte path at a plane's
// edge hold up only their own warps (a warp walking along a row spans
// the row's edge MBs, and rule B measured 22% slower that way).  The
// thread reads the MB's two vectors once, predicts its row as S/4 words
// through predict_row<S>, the word-row path K3 runs (aligned 32-bit
// loads, funnel shifts, __vavgu4, avg4), and stores it as one uint4 (S
// = 16) or uint2 (S = 8).  Rule B takes predict_row<S> too wherever the
// MB's taps lie inside the plane, where both rules read the same bytes;
// only an MB whose taps cross an edge clamps each tap, byte by byte
// (predict_row_clamped).  On the mesh's own ticks no MB takes that path
// (chip_smoke.py's 'space' split of a P picture of the encoder's
// content, where the two rules agree in every pixel); on chip_smoke.py's
// band of random vectors up to 24 pixels long, 6% do.

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cuda_runtime.h>

#include "idct.cuh"
#include "resources.cuh"

namespace {

constexpr int MB_STALE = 0, MB_INTRA = 3;
// int16 a staged residual block of K3: 64 and 8 of padding
constexpr int RES_STRIDE = 72;
constexpr int MAX_MB_WIDTH = 64;        // ops/vlc_scan.py MAX_MB_WIDTH

__device__ __forceinline__ int sext12(int x) {
  x &= 0xFFF;
  return x >= 0x800 ? x - 0x1000 : x;
}

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

template <int S>
__device__ __forceinline__ void store_row(uint8_t* p,
                                          const uint32_t (&w)[S / 4]) {
  if constexpr (S == 16)
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  else
    *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
}

__device__ __forceinline__ void unpack(const uint4 v, uint32_t* w) {
  w[0] = v.x;
  w[1] = v.y;
  w[2] = v.z;
  w[3] = v.w;
}

// (a + b + c + d + 2) >> 2 a byte, in 16-bit lanes
__device__ __forceinline__ uint32_t avg4(uint32_t a, uint32_t b, uint32_t c,
                                         uint32_t d) {
  const uint32_t m = 0x00FF00FFu;
  const uint32_t lo = (a & m) + (b & m) + (c & m) + (d & m) + 0x00020002u;
  const uint32_t hi = ((a >> 8) & m) + ((b >> 8) & m) + ((c >> 8) & m) +
                      ((d >> 8) & m) + 0x00020002u;
  return ((lo >> 2) & m) | (((hi >> 2) & m) << 8);
}

// two int16 lanes clipped to 0..248
__device__ __forceinline__ uint32_t pin2(uint32_t x) {
  return __vmins2(__vmaxs2(x, 0u), 0x00F800F8u);
}

// four pixels: pin(int16(pred + res)) from the predicted bytes p and
// the residual pairs r0 (pixels 0, 1) and r1 (pixels 2, 3)
__device__ __forceinline__ uint32_t compose4(uint32_t p, uint32_t r0,
                                             uint32_t r1) {
  return __byte_perm(pin2(__vadd2(__byte_perm(p, 0, 0x4140), r0)),
                     pin2(__vadd2(__byte_perm(p, 0, 0x4342), r1)), 0x6420);
}

// the S taps at x0 (a) and, with hx, at x0 + 1 (b) of one reference
// row, as S/4 words; the word past the right edge reads 0
template <int S>
__device__ __forceinline__ void taps_row(const uint8_t* row, int x0, int W,
                                         bool hx, uint32_t (&a)[S / 4],
                                         uint32_t (&b)[S / 4]) {
  const int w0 = x0 & ~3, sh = (x0 & 3) * 8;
  const uint32_t* p = reinterpret_cast<const uint32_t*>(row + w0);
  uint32_t q[S / 4 + 1];
#pragma unroll
  for (int k = 0; k < S / 4; ++k) q[k] = __ldg(p + k);
  q[S / 4] = w0 + S < W ? __ldg(p + S / 4) : 0u;
#pragma unroll
  for (int k = 0; k < S / 4; ++k) {
    a[k] = __funnelshift_r(q[k], q[k + 1], sh);
    b[k] = hx ? __funnelshift_rc(q[k], q[k + 1], sh + 8) : 0u;
  }
}

// one S-pixel row of an MB's half-pel prediction (rule A): window
// origin x0, reference row sy; the row past the bottom reads 0
template <int S>
__device__ __forceinline__ void predict_row(const uint8_t* ref, int W,
                                            int H, int x0, int sy, bool hx,
                                            bool hy, uint32_t (&pred)[S / 4]) {
  uint32_t a[S / 4], b[S / 4];
  taps_row<S>(ref + (size_t)sy * W, x0, W, hx, a, b);
  if (!hy) {
#pragma unroll
    for (int k = 0; k < S / 4; ++k) pred[k] = hx ? __vavgu4(a[k], b[k]) : a[k];
    return;
  }
  uint32_t c[S / 4], d[S / 4];
  if (sy + 1 < H) {
    taps_row<S>(ref + (size_t)(sy + 1) * W, x0, W, hx, c, d);
  } else {
#pragma unroll
    for (int k = 0; k < S / 4; ++k) c[k] = d[k] = 0u;
  }
#pragma unroll
  for (int k = 0; k < S / 4; ++k)
    pred[k] = hx ? avg4(a[k], b[k], c[k], d[k]) : __vavgu4(a[k], c[k]);
}

// one S-pixel row yi of MB (r, c), INTRA or predicted, into cur and out
template <int S>
__device__ __forceinline__ void compose_row(const uint8_t* ref, uint8_t* cur,
                                            uint8_t* out, int W, int H,
                                            int kind, int mvx, int mvy,
                                            int c, int r, int yi,
                                            const uint32_t (&res)[S / 2]) {
  uint32_t v[S / 4];
  if (kind == MB_INTRA) {
#pragma unroll
    for (int k = 0; k < S / 4; ++k)
      v[k] = __byte_perm(pin2(res[2 * k]), pin2(res[2 * k + 1]), 0x6420);
  } else {
    const int xh = c * 2 * S + mvx, yh = r * 2 * S + mvy;
    uint32_t p[S / 4];
    predict_row<S>(ref, W, H, clampi(xh >> 1, 0, W - S),
                   clampi(yh >> 1, 0, H - S) + yi, xh & 1, yh & 1, p);
#pragma unroll
    for (int k = 0; k < S / 4; ++k)
      v[k] = compose4(p[k], res[2 * k], res[2 * k + 1]);
  }
  store_row<S>(cur, v);
  store_row<S>(out, v);
}

// thread (yi, c)'s rows of MB (r, c) of lane n: luma row yi and chroma
// row yi & 7, of u for yi < 8 and of v otherwise -- in the parity slot
// (cur, read and written in place), the reference slot (ref, the whole
// plane) and the presented planes (out)
struct MbRows {
  uint8_t *cur_y, *cur_c, *out_y, *out_c;
  const uint8_t *ref_y, *ref_c;
};

__device__ __forceinline__ MbRows mb_rows(uint8_t* fy, uint8_t* fu,
                                          uint8_t* fv, uint8_t* py,
                                          uint8_t* pu, uint8_t* pv, int n,
                                          int par, int r, int c, int yi,
                                          int mbw, int mbh) {
  const int W = mbw * 16, H = mbh * 16;
  const size_t ypx = (size_t)H * W, cpx = ypx / 4;
  const size_t yat = (size_t)(r * 16 + yi) * W + c * 16;
  const size_t cat = (size_t)(r * 8 + (yi & 7)) * (W / 2) + c * 8;
  uint8_t* fc = yi < 8 ? fu : fv;
  MbRows m;
  m.cur_y = fy + ((size_t)n * 2 + par) * ypx + yat;
  m.cur_c = fc + ((size_t)n * 2 + par) * cpx + cat;
  m.ref_y = fy + ((size_t)n * 2 + 1 - par) * ypx;
  m.ref_c = fc + ((size_t)n * 2 + 1 - par) * cpx;
  m.out_y = py + n * ypx + yat;
  m.out_c = (yi < 8 ? pu : pv) + n * cpx + cat;
  return m;
}

// a STALE MB's rows, and every MB's of an inactive lane: out from cur,
// cur left as it is
__device__ __forceinline__ void keep_rows(const MbRows& m) {
  *reinterpret_cast<uint4*>(m.out_y) =
      *reinterpret_cast<const uint4*>(m.cur_y);
  *reinterpret_cast<uint2*>(m.out_c) =
      *reinterpret_cast<const uint2*>(m.cur_c);
}

// an INTRA or predicted MB's rows (record rec) into cur and out, from
// the thread's residuals as int16 pairs: ry luma pixels 0-15, rc chroma
// pixels 0-7
__device__ __forceinline__ void compose_rows(const MbRows& m, int rec,
                                             int mbw, int mbh, int r,
                                             int c, int yi,
                                             const uint32_t (&ry)[8],
                                             const uint32_t (&rc)[4]) {
  const int W = mbw * 16, H = mbh * 16, kind = rec & 3;
  const int mvx = sext12(rec >> 7), mvy = sext12(rec >> 19);
  compose_row<16>(m.ref_y, m.cur_y, m.out_y, W, H, kind, mvx, mvy, c, r,
                  yi, ry);
  compose_row<8>(m.ref_c, m.cur_c, m.out_c, W / 2, H / 2, kind, mvx >> 1,
                 mvy >> 1, c, r, yi & 7, rc);
}

// FLAT = false: residuals res int16[N, 64, BL] (K2's output); FLAT =
// true: res int16[N, BL, 64] (K2F's output).  Grid (mbh, N), blockDim
// (16, mbw): thread (yi, c) owns luma row yi and chroma row yi & 7 (u
// for yi < 8, v for yi >= 8) of MB c of MB row blockIdx.x.
template <bool FLAT>
__global__ void __launch_bounds__(1024)
    compose_put_kernel(const int16_t* __restrict__ rsrc,
                       const int* __restrict__ recs,
                       const uint8_t* __restrict__ active,
                       const int* __restrict__ parity, uint8_t* fy,
                       uint8_t* fu, uint8_t* fv, uint8_t* __restrict__ py,
                       uint8_t* __restrict__ pu, uint8_t* __restrict__ pv,
                       int mbw, int mbh) {
  extern __shared__ uint4 sres[];    // K3: [mbw * 6][RES_STRIDE / 8]
  const int yi = threadIdx.x, c = threadIdx.y;
  const int r = blockIdx.x, n = blockIdx.y;
  const int BL = mbw * mbh * 6;
  const bool live = active[n] != 0;
  const int par = parity[n];
  const int rec = recs[(size_t)n * mbw * mbh + r * mbw + c];
  const int kind = live ? rec & 3 : MB_STALE;

  if (!FLAT && live) {
    // the MB row's 6*mbw blocks x 8 block rows, three a thread (16*mbw
    // threads): 2-byte loads along bl, one 16-byte transposed store
    const int ncols = 6 * mbw;
    const int16_t* src = rsrc + (size_t)n * 64 * BL + (size_t)r * ncols;
    int k = yi + 16 * c, row = 0;
#pragma unroll
    for (int m = 0; m < 3; ++m) {
      while (k >= ncols) {
        k -= ncols;
        ++row;
      }
      uint32_t w[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint32_t lo = (uint16_t)src[(size_t)(8 * row + 2 * j) * BL + k];
        const uint32_t hi =
            (uint16_t)src[(size_t)(8 * row + 2 * j + 1) * BL + k];
        w[j] = lo | hi << 16;
      }
      sres[k * (RES_STRIDE / 8) + row] = make_uint4(w[0], w[1], w[2], w[3]);
      k += 16 * mbw;
    }
    __syncthreads();
  }

  const MbRows m = mb_rows(fy, fu, fv, py, pu, pv, n, par, r, c, yi, mbw,
                           mbh);
  if (kind == MB_STALE) {              // and every MB of an inactive lane
    keep_rows(m);
    return;
  }

  // the thread's block rows: luma blocks blk, blk + 1, chroma 4 + (yi >> 3)
  const int yc = yi & 7, blk = (yi >> 3) * 2, cblk = 4 + (yi >> 3);
  uint32_t ry[8], rc[4];
  if (FLAT) {
    const uint4* b = reinterpret_cast<const uint4*>(
        rsrc + ((size_t)n * BL + (size_t)(r * mbw + c) * 6) * 64);
    unpack(__ldg(b + blk * 8 + yc), ry);
    unpack(__ldg(b + (blk + 1) * 8 + yc), ry + 4);
    unpack(__ldg(b + cblk * 8 + yc), rc);
  } else {
    const uint4* b = sres + c * 6 * (RES_STRIDE / 8);
    unpack(b[blk * (RES_STRIDE / 8) + yc], ry);
    unpack(b[(blk + 1) * (RES_STRIDE / 8) + yc], ry + 4);
    unpack(b[cblk * (RES_STRIDE / 8) + yc], rc);
  }
  compose_rows(m, rec, mbw, mbh, r, c, yi, ry, rc);
}

// ---------------------------------------------------------------------
// K23 (esp_idct_compose_put) -- dequant, IDCT, prediction, compose and
// the parity put of one MB row, the residuals kept in shared memory.
//
// Replaces, on the main path (models/mpeg1.dense_compose on the card:
// the chain, the coeffs_T decode): K2 then K3, i.e.
// espflix_tpu/ops/idct_pallas.py _kernel_T (block_residuals_T_pallas),
// then mocomp_pallas.py _phase2p_kernel (luma) and _packedp_kernel (u +
// v, accum=True) with the residual-plane assembly, compose and put of
// espflix_tpu/models/mpeg1.dense_compose (coeffs_T path,
// mpeg1.py:562-664).  K2 stays for the mesh (dense_compose_unfused), K3
// for the split checks of chip_smoke.py and tools/kernel_ab.py.
//
// What bounds it on an H100: memory.  A 352x192 lane moves ~616 KB:
// its levels int16[64, 1584] (202,752 B), nfinal (6,336), records
// (1,056), quantiser matrices (512), the parity slot read and written
// and the presented planes written (101,376 B each), and the reference
// windows its predicted MBs read (at most 101,376).  K2 + K3 moved
// ~1,036 KB: K2 wrote the residuals (202,752 B, a full tile that is 0
// or the DC for the blocks without butterflies) and K3 read them back,
// and the per-block intra flags and qscales (7,920 B) went through two
// torch passes to K2.  At 8,192 lanes that is ~3.4 GB a tick less.
//
// The design.  K3's threads: thread (yi, c) of blockDim (16, mbw) owns
// K3's luma row yi and chroma row yi & 7 of MB c.  A block
// takes `rows` MB rows of one lane in turn (a whole lane's at 8,192
// lanes, fewer when the lanes alone would not give each SM
// K23_BLOCKS_PER_SM blocks), so that the next row's levels load while
// this row composes.  A row's phases, between __syncthreads:
//   * staged (while the row before composes): the row's [64][6 mbw]
//     levels copied with cp.async into a position-major level tile, as
//     K2 stages its tile, in the widest vector the levels' alignment
//     allows (V = 4 at 352x192: a row of 132 blocks is 264 B, so it
//     starts 8-byte aligned); thread t < 6 mbw reads block t's nfinal
//     and, from its MB's record, the intra flag and qscale (no
//     per-block flag tensors), and votes whether the block runs the
//     butterflies: coded, not the non-intra DC shortcut, not in a STALE
//     MB;
//   * listed: the voted blocks in order, and a fill value for every
//     other block -- 0 (uncoded, whatever levels it holds) or its DC
//     (the shortcut);
//   * butterflies: each warp takes four listed blocks at a time; thread
//     j of a group dequantises column j from the level tile and runs
//     the column pass, the 8 x 8 tile turns across the group's eight
//     lanes in three xor-shuffle stages (no shared transpose tile), and
//     it runs the row pass on row j and stores that row as one 16-byte
//     vector into a block-major residual tile [bl][72], K3's staging
//     layout;
//   * composed: K3's prediction first, then each block row from the
//     residual tile (one 16-byte load) or its fill value, then K3's
//     compose and put, unchanged.
// An odd mb_width gets one spare column of threads, which stage and
// run butterflies and compose nothing, so that every warp is whole.
//
// Occupancy (measured on an H100 SXM): 64 registers, no spills, 36,416
// B of dynamic shared memory at 352x192 and 3,200 B static, so two
// blocks of 352 threads an SM (22 warps of 64), held by the registers.
// Measured slower at 8,192 lanes: a cap of 56 registers (three blocks
// an SM, but spills), blocks padded with spare threads to 512 or 1,024,
// a second level tile to start the next row's copy before the
// butterflies, and one MB row a block.
//
// The two tiles: levels [64][TS] int16 with TS = 8 + 64 k >= 6 mbw
// (136 at 352x192), so that a copy's rows are 16-byte aligned and a
// warp's column reads of positions 8 r + j fall in banks 4 j + bl / 2
// (distinct for the list's neighbouring blocks); residuals [6 mbw][72]
// int16, so that a group's eight 16-byte row stores and a quarter-
// warp's eight 16-byte row loads each cover 128 contiguous bytes.  One
// layout for both would need the levels transposed on their way in,
// which a copy cannot do.  36,416 B of dynamic shared memory at
// 352x192 (105,472 at MAX_MB_WIDTH) and 3,200 B static (the flags of
// two rows, by the row's parity).
//
// Bit-exact with K2 then K3, so with idct_pallas.py:180-207,
// idct.block_residuals_T and the K3 semantics above: K2's dequant and
// butterflies (idct.cuh), int32 arithmetic that wraps, the residual
// wrapped to int16 before compose; nfinal 0 gives 0 and the non-intra
// nfinal 1 shortcut its DC whatever other levels the block holds; a
// STALE MB and every MB of an inactive lane read no residual and no
// reference and keep cur.
// ---------------------------------------------------------------------

constexpr int MAX_ROW_BLOCKS = 6 * MAX_MB_WIDTH;   // blocks of an MB row

// int16 a row of K23's level tile for ncols blocks: the least 8 + 64 k
// >= ncols -- a multiple of 8 (16-byte rows for the copies) and 4 words
// past a multiple of the 32 banks, so that a warp's column reads of
// positions 8 r + j fall in banks 4 j + bl / 2
__host__ __device__ constexpr int level_stride(int ncols) {
  return (ncols + 55) / 64 * 64 + 8;
}

// K23's dynamic shared bytes at mb_width mbw: the residual tile [6 mbw]
// [RES_STRIDE], then the level tile [64][level_stride(6 mbw)]
__host__ __device__ constexpr int k23_stage_bytes(int mbw) {
  return (6 * mbw * RES_STRIDE + 64 * level_stride(6 * mbw)) *
         (int)sizeof(int16_t);
}

// an 8 x 8 int32 tile transposed across the eight lanes of a group:
// lane j holds a[k] = element (k, j) before and (j, k) after.  Three
// xor stages; at stage m a lane trades the four values whose index
// differs from its lane in bit m with lane j ^ m
__device__ __forceinline__ void transpose8(int (&a)[8], int j) {
#pragma unroll
  for (int m = 4; m >= 1; m >>= 1) {
    const bool up = j & m;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (i & m) continue;
      const int got = __shfl_xor_sync(0xFFFFFFFFu, up ? a[i] : a[i | m], m);
      if (up)
        a[i] = got;
      else
        a[i | m] = got;
    }
  }
}

// block bl's row yc as int16 pairs: from the residual tile where the
// block ran the butterflies (bit bl of full), else its fill value
__device__ __forceinline__ void block_row(const int16_t* rs,
                                          const uint32_t* full,
                                          const int16_t* fill, int bl,
                                          int yc, uint32_t* w) {
  if (full[bl >> 5] >> (bl & 31) & 1) {
    unpack(reinterpret_cast<const uint4*>(rs + bl * RES_STRIDE)[yc], w);
  } else {
    const uint32_t f = (uint16_t)fill[bl];
    w[0] = w[1] = w[2] = w[3] = f | f << 16;
  }
}

// K23: MB row r's levels, [64][6 mbw] of a lane's [64][BL], straight
// into the level tile lv ([64][TS]; V divides 6 mbw), V int16 a copy;
// returns block t's flags: bit 0 if its nfinal is 1, qscale | intra <<
// 5 in bits 8-13 and bit 16 if it runs the butterflies
template <int V>
__device__ __forceinline__ int stage_row(const int16_t* lane_lv,
                                         const int* lane_recs,
                                         const int* lane_nf, int16_t* lv,
                                         int r, int t, int nthreads, int mbw,
                                         int BL, int TS) {
  const int ncols = 6 * mbw, VPR = ncols / V;
  const int16_t* src = lane_lv + r * ncols;
#pragma unroll 1
  for (int i = t; i < 64 * VPR; i += nthreads) {
    const int p = i / VPR, e = (i - p * VPR) * V;
    copy_in<V>(lv + p * TS + e, src + (p * BL + e));
  }
  if (t >= ncols) return 0;
  const int rec = lane_recs[r * mbw + t / 6];
  const bool intra = (rec & 3) == MB_INTRA;
  const int nf = lane_nf[r * ncols + t];
  // a STALE MB keeps cur, so its blocks need no residuals
  const bool full = (rec & 3) != MB_STALE && nf != 0 && !(nf == 1 && !intra);
  return (nf == 1) | (((rec >> 2) & 31) | intra << 5) << 8 | full << 16;
}

// K23's compose of thread (yi, c)'s S-pixel row of MB (r, c) (K3's
// compose_row): the prediction first, then the row of blocks bl (and bl
// + 1 for luma) from the residual tile or their fill, so that the
// residual words hold no registers across the reference loads
template <int S>
__device__ __forceinline__ void compose_row_staged(
    const uint8_t* ref, uint8_t* cur, uint8_t* out, int W, int H, int kind,
    int mvx, int mvy, int c, int r, int yi, const int16_t* rs,
    const uint32_t* full, const int16_t* fill, int bl) {
  uint32_t p[S / 4];
  if (kind != MB_INTRA) {
    const int xh = c * 2 * S + mvx, yh = r * 2 * S + mvy;
    predict_row<S>(ref, W, H, clampi(xh >> 1, 0, W - S),
                   clampi(yh >> 1, 0, H - S) + yi, xh & 1, yh & 1, p);
  }
  uint32_t res[S / 2], v[S / 4];
  block_row(rs, full, fill, bl, yi & 7, res);
  if (S == 16) block_row(rs, full, fill, bl + 1, yi & 7, res + 4);
#pragma unroll
  for (int k = 0; k < S / 4; ++k)
    v[k] = kind == MB_INTRA
               ? __byte_perm(pin2(res[2 * k]), pin2(res[2 * k + 1]), 0x6420)
               : compose4(p[k], res[2 * k], res[2 * k + 1]);
  store_row<S>(cur, v);
  store_row<S>(out, v);
}

// Grid (ceil(mbh / rows), N), blockDim (16, mbw + (mbw & 1)): the block
// takes MB rows blockIdx.x * rows .. + rows - 1 of lane blockIdx.y in
// turn, thread (yi, c) K3's rows of MB c of each; an odd mb_width's
// spare column of threads stages and runs butterflies only.  Levels
// coeffs_T int16[N, 64, BL], V int16 a copy.
template <int V>
__global__ void __launch_bounds__(1024)
    idct_compose_put_kernel(const int16_t* __restrict__ coeffs_T,
                            const int* __restrict__ recs,
                            const int* __restrict__ nfinal,
                            const int* __restrict__ intra_q,
                            const int* __restrict__ non_intra_q,
                            const int* __restrict__ scale,
                            const uint8_t* __restrict__ active,
                            const int* __restrict__ parity, uint8_t* fy,
                            uint8_t* fu, uint8_t* fv,
                            uint8_t* __restrict__ py,
                            uint8_t* __restrict__ pu,
                            uint8_t* __restrict__ pv, int mbw, int mbh,
                            int rows) {
  extern __shared__ uint4 stage[];          // residuals, then levels
  __shared__ int qm[TILE + 64];             // non-intra at 0, intra at TILE
  __shared__ int sc[64];
  // by the row's parity, written before the barrier that frees the
  // other row's: bit b, block b runs the butterflies; qscale | intra << 5
  __shared__ uint32_t full_s[2][MAX_ROW_BLOCKS / 32];
  __shared__ uint8_t bq[2][MAX_ROW_BLOCKS];
  __shared__ uint16_t list[MAX_ROW_BLOCKS]; // the row's such blocks
  // the residual of a block without butterflies: 0, or its DC
  __shared__ int16_t fill[MAX_ROW_BLOCKS];
  const int yi = threadIdx.x, c = threadIdx.y;
  const int t = yi + 16 * c, nthreads = 16 * blockDim.y;
  const int n = blockIdx.y, r0 = blockIdx.x * rows;
  const int r1 = r0 + rows < mbh ? r0 + rows : mbh;
  const int MB = mbw * mbh, ncols = 6 * mbw, BL = 6 * MB;
  const int par = parity[n];
  if (!active[n]) {                         // every MB keeps cur
    if (c < mbw)
      for (int r = r0; r < r1; ++r)
        keep_rows(mb_rows(fy, fu, fv, py, pu, pv, n, par, r, c, yi, mbw,
                          mbh));
    return;
  }

  int16_t* rs = reinterpret_cast<int16_t*>(stage);  // [ncols][RES_STRIDE]
  const int TS = level_stride(ncols);
  int16_t* lv = rs + ncols * RES_STRIDE;            // [64][TS]
  const int16_t* lane_lv = coeffs_T + (size_t)n * 64 * BL;
  const int* lane_recs = recs + (size_t)n * MB;
  const int* lane_nf = nfinal + (size_t)n * BL;
  for (int i = t; i < 64; i += nthreads) {
    qm[i] = non_intra_q[n * 64 + i];
    qm[TILE + i] = intra_q[n * 64 + i];
    sc[i] = scale[i];
  }
  int flags = stage_row<V>(lane_lv, lane_recs, lane_nf, lv, r0, t,
                          nthreads, mbw, BL, TS);
  const int g4 = (t >> 3) & 3, j = t & 7;
  for (int r = r0; r < r1; ++r) {
    const int s = r & 1, q = flags >> 8 & 63;
    const bool full = flags >> 16;
    const uint32_t vote = __ballot_sync(0xFFFFFFFFu, full);
    if (t < ncols) {
      bq[s][t] = (uint8_t)q;
      if ((t & 31) == 0) full_s[s][t >> 5] = vote;
    }
    // the row's levels are in; the last row's compose is done with the
    // residual tile and fill
    copy_wait();
    __syncthreads();

    int nfull = 0;
    for (int k = 0; k < (ncols + 31) >> 5; ++k) nfull += __popc(full_s[s][k]);
    if (t < ncols) {
      if (full) {
        int pos = __popc(full_s[s][t >> 5] & ((1u << (t & 31)) - 1));
        for (int k = 0; k < (t >> 5); ++k) pos += __popc(full_s[s][k]);
        list[pos] = (uint16_t)t;
      }
      // an uncoded block's residuals are 0, a DC shortcut's its DC
      fill[t] = (flags & 1) && !full
                    ? (int16_t)(dequant(lv[t], 0, false, q & 31, qm, sc) >> 8)
                    : 0;
    }
    __syncthreads();

    // the butterflies, four listed blocks a warp at a time: thread j of
    // the warp's group g4 dequantises column j of block list[base + g4]
    // and runs the column pass, the tile turns across the group's
    // lanes, and it runs the row pass on row j and stores that row as
    // one 16-byte vector into the block's residual rows; a group past
    // the list repeats the warp's first block and stores nothing, so
    // that the warp stays converged
#pragma unroll 1
    for (int base = (t >> 5) * 4; base < nfull;
         base += (nthreads >> 5) * 4) {
      const bool act = base + g4 < nfull;
      const int b = list[act ? base + g4 : base];
      const int16_t* col = lv + b;            // (p, b) at col[p * TS]
      const int qb = bq[s][b];
      const bool intra = qb >> 5;
      const int* qmat = qm + (intra ? TILE : 0);
      int cv[8], o[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int lev = col[(8 * k + j) * TS];
        // a zero level dequantises to 0 (an intra DC too)
        cv[k] = __any_sync(0xFFFFFFFFu, lev != 0)
                    ? dequant(lev, 8 * k + j, intra, qb & 31, qmat, sc)
                    : 0;
      }
      butterfly(cv, o, false);                // column j: o[k] = (k, j)
      transpose8(o, j);                       // o[k] = (j, k)
      butterfly(o, cv, true);                 // row j, final rounding
      if (act) {
        uint32_t w[4];
#pragma unroll
        for (int k = 0; k < 4; ++k)
          w[k] = (uint32_t)(uint16_t)cv[2 * k] |
                 (uint32_t)(uint16_t)cv[2 * k + 1] << 16;
        reinterpret_cast<uint4*>(rs + b * RES_STRIDE)[j] =
            make_uint4(w[0], w[1], w[2], w[3]);
      }
    }
    // the residual tile is whole and the level tile free: the next
    // row's levels and flags load while this row composes (a second
    // level tile, to load them earlier, measured slower)
    __syncthreads();
    if (r + 1 < r1)
      flags = stage_row<V>(lane_lv, lane_recs, lane_nf, lv, r + 1, t,
                           nthreads, mbw, BL, TS);

    if (c >= mbw) continue;                   // a spare column
    const int rec = lane_recs[r * mbw + c];
    const MbRows m = mb_rows(fy, fu, fv, py, pu, pv, n, par, r, c, yi, mbw,
                             mbh);
    if ((rec & 3) == MB_STALE) {
      keep_rows(m);
      continue;
    }
    // the thread's block rows: luma blocks bl, bl + 1, chroma 4 + (yi >> 3)
    const int kind = rec & 3, mvx = sext12(rec >> 7), mvy = sext12(rec >> 19);
    const int W = mbw * 16, H = mbh * 16, bl = c * 6 + (yi >> 3) * 2;
    compose_row_staged<16>(m.ref_y, m.cur_y, m.out_y, W, H, kind, mvx, mvy,
                           c, r, yi, rs, full_s[s], fill, bl);
    compose_row_staged<8>(m.ref_c, m.cur_c, m.out_c, W / 2, H / 2, kind,
                          mvx >> 1, mvy >> 1, c, r, yi & 7, rs, full_s[s],
                          fill, c * 6 + 4 + (yi >> 3));
  }
}

// one S-pixel row of an MB's half-pel prediction with each tap clamped
// into the plane (rule B at an edge): window origin x0, row y
template <int S>
__device__ __forceinline__ void predict_row_clamped(
    const uint8_t* ref, int W, int H, int x0, int y, bool hx, bool hy,
    uint32_t (&pred)[S / 4]) {
  const uint8_t* ra = ref + (size_t)clampi(y, 0, H - 1) * W;
  const uint8_t* rb = ref + (size_t)clampi(y + 1, 0, H - 1) * W;
#pragma unroll
  for (int k = 0; k < S / 4; ++k) {
    uint32_t word = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int xa = clampi(x0 + 4 * k + j, 0, W - 1);
      const int xb = clampi(x0 + 4 * k + j + 1, 0, W - 1);
      const int a = __ldg(ra + xa), b = __ldg(ra + xb);
      const int c = __ldg(rb + xa), d = __ldg(rb + xb);
      const int p = hx ? (hy ? (a + b + c + d + 2) >> 2 : (a + b + 1) >> 1)
                       : (hy ? (a + c + 1) >> 1 : a);
      word |= (uint32_t)p << (8 * j);
    }
    pred[k] = word;
  }
}

// threads a K3P block aims at: R = PREDICT_THREADS / (mbw * S) MB rows
constexpr int PREDICT_THREADS = 512;

// Grid (ceil(mbh_loc / R), N, planes), blockDim (S, mbw, R): thread
// (yi, c, z) owns row yi of MB (blockIdx.x * R + z, c) of the band of
// plane blockIdx.z -- ref / out, or ref2 / out2 (predict_chroma_pair's
// u and v in one launch, with the same vectors).
template <int S, bool CLIP_TAPS>
__global__ void __launch_bounds__(1024)
    predict_kernel(const uint8_t* __restrict__ ref,
                   const uint8_t* __restrict__ ref2,
                   const int* __restrict__ mvh, const int* __restrict__ mvv,
                   uint8_t* __restrict__ out, uint8_t* __restrict__ out2,
                   int H, int W, int mbw, int mbh_loc, int row0) {
  if (blockIdx.z) {
    ref = ref2;
    out = out2;
  }
  const int yi = threadIdx.x, c = threadIdx.y;
  const int r = blockIdx.x * blockDim.z + threadIdx.z, n = blockIdx.y;
  if (r >= mbh_loc) return;
  const size_t mb = ((size_t)n * mbh_loc + r) * mbw + c;
  const int xh = c * 2 * S + __ldg(mvh + mb);
  const int yh = (row0 + r) * 2 * S + __ldg(mvv + mb);
  const bool hx = xh & 1, hy = yh & 1;
  const uint8_t* rp = ref + (size_t)n * H * W;
  int x0 = xh >> 1, y0 = yh >> 1;
  if (!CLIP_TAPS) {
    x0 = clampi(x0, 0, W - S);
    y0 = clampi(y0, 0, H - S);
  }
  uint32_t pred[S / 4];
  if (!CLIP_TAPS || (x0 >= 0 && x0 + S - 1 + hx < W && y0 >= 0 &&
                     y0 + S - 1 + hy < H))
    predict_row<S>(rp, W, H, x0, y0 + yi, hx, hy, pred);
  else
    predict_row_clamped<S>(rp, W, H, x0, y0 + yi, hx, hy, pred);
  store_row<S>(out + (((size_t)n * mbh_loc + r) * S + yi) * W + c * S, pred);
}

template <int S, bool CLIP_TAPS>
void launch_predict(const void* ref, const void* ref2, const void* mvh,
                    const void* mvv, void* out, void* out2, int planes,
                    int N, int H, int W, int mbw, int mbh_loc, int row0,
                    cudaStream_t stream) {
  const int rows = std::max(1, std::min(PREDICT_THREADS / (mbw * S),
                                        mbh_loc));
  const dim3 grid((mbh_loc + rows - 1) / rows, N, planes);
  const dim3 block(S, mbw, rows);
  predict_kernel<S, CLIP_TAPS><<<grid, block, 0, stream>>>(
      (const uint8_t*)ref, (const uint8_t*)ref2, (const int*)mvh,
      (const int*)mvv, (uint8_t*)out, (uint8_t*)out2, H, W, mbw, mbh_loc,
      row0);
}

// raise a kernel's dynamic shared memory limit to `bytes` once for each
// device (a function attribute belongs to the device's context), not on
// every launch; raised holds a bit a device
cudaError_t allow_stage(const void* fn, int bytes,
                        std::atomic<unsigned long long>& raised) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0;
  if (raised.load(std::memory_order_relaxed) & bit) return cudaSuccess;
  e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           bytes);
  if (e == cudaSuccess) raised.fetch_or(bit);
  return e;
}

// K3's stage takes 864 B an MB column, over the 48 KB default from
// mb_width 57 on: its limit is MAX_MB_WIDTH columns
cudaError_t allow_k3_stage() {
  static std::atomic<unsigned long long> raised{0};
  return allow_stage((const void*)compose_put_kernel<false>,
                     MAX_MB_WIDTH * 6 * RES_STRIDE * (int)sizeof(int16_t),
                     raised);
}

// K23's stage, 36,416 B at mb_width 22 and 105,472 at MAX_MB_WIDTH
template <int V>
cudaError_t allow_k23_stage() {
  static std::atomic<unsigned long long> raised{0};
  return allow_stage((const void*)idct_compose_put_kernel<V>,
                     k23_stage_bytes(MAX_MB_WIDTH), raised);
}

// MB rows a K23 block takes: a whole lane's where the lanes alone give
// the card K23_BLOCKS_PER_SM blocks an SM, so that each block's next
// row loads while its row composes; fewer where they do not
constexpr int K23_BLOCKS_PER_SM = 8;

int k23_rows(int N, int mbh) {
  static std::atomic<int> sms{0};
  int m = sms.load(std::memory_order_relaxed);
  if (m == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&m, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      m = 132;                              // an H100 SXM
    sms.store(m, std::memory_order_relaxed);
  }
  const long want = (long)K23_BLOCKS_PER_SM * m;
  const int per_lane = (int)std::min<long>(mbh, (want + N - 1) / N);
  return (mbh + per_lane - 1) / per_lane;
}

template <int V>
int launch_idct_compose_put(const void* coeffs_T, const void* recs,
                            const void* nfinal, const void* intra_q,
                            const void* non_intra_q, const void* scale,
                            const void* active, const void* parity,
                            void* fy, void* fu, void* fv, void* py,
                            void* pu, void* pv, int N, int mbw, int mbh,
                            cudaStream_t stream) {
  const cudaError_t e = allow_k23_stage<V>();
  if (e != cudaSuccess) return (int)e;
  const int rows = k23_rows(N, mbh);
  const dim3 grid((mbh + rows - 1) / rows, N), block(16, mbw + (mbw & 1));
  idct_compose_put_kernel<V><<<grid, block, k23_stage_bytes(mbw), stream>>>(
      (const int16_t*)coeffs_T, (const int*)recs, (const int*)nfinal,
      (const int*)intra_q, (const int*)non_intra_q, (const int*)scale,
      (const uint8_t*)active, (const int*)parity, (uint8_t*)fy,
      (uint8_t*)fu, (uint8_t*)fv, (uint8_t*)py, (uint8_t*)pu, (uint8_t*)pv,
      mbw, mbh, rows);
  return (int)cudaGetLastError();
}

template <bool FLAT>
int launch_compose_put(const void* res, const void* recs, const void* active,
                       const void* parity, void* fy, void* fu, void* fv,
                       void* py, void* pu, void* pv, int N, int mbw, int mbh,
                       void* stream) {
  if (mbw > MAX_MB_WIDTH) return (int)cudaErrorInvalidValue;
  const dim3 grid(mbh, N), block(16, mbw);
  size_t smem = 0;
  if (!FLAT) {
    smem = (size_t)mbw * 6 * RES_STRIDE * sizeof(int16_t);
    const cudaError_t e = allow_k3_stage();
    if (e != cudaSuccess) return (int)e;
  }
  compose_put_kernel<FLAT><<<grid, block, smem, (cudaStream_t)stream>>>(
      (const int16_t*)res, (const int*)recs, (const uint8_t*)active,
      (const int*)parity, (uint8_t*)fy, (uint8_t*)fu, (uint8_t*)fv,
      (uint8_t*)py, (uint8_t*)pu, (uint8_t*)pv, mbw, mbh);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int esp_compose_put(const void* res_T, const void* recs,
                               const void* active, const void* parity,
                               void* fy, void* fu, void* fv, void* py,
                               void* pu, void* pv, int N, int mbw, int mbh,
                               void* stream) {
  return launch_compose_put<false>(res_T, recs, active, parity, fy, fu, fv,
                                   py, pu, pv, N, mbw, mbh, stream);
}

extern "C" int esp_compose_put_flat(const void* res, const void* recs,
                                    const void* active, const void* parity,
                                    void* fy, void* fu, void* fv, void* py,
                                    void* pu, void* pv, int N, int mbw,
                                    int mbh, void* stream) {
  return launch_compose_put<true>(res, recs, active, parity, fy, fu, fv, py,
                                  pu, pv, N, mbw, mbh, stream);
}

// K23: coeffs_T int16[N, 64, mbw * mbh * 6] (2-byte aligned), recs /
// nfinal / intra_q / non_intra_q / scale / active / parity as K2's and
// K3's operands, frames and presented planes as K3's (16-byte aligned).
// The widest copy that the levels' alignment allows: V = 8, 4, 2 or 1
// int16 (4 at 352x192: an MB row's 132 blocks start 8-byte aligned).
extern "C" int esp_idct_compose_put(const void* coeffs_T, const void* recs,
                                    const void* nfinal, const void* intra_q,
                                    const void* non_intra_q,
                                    const void* scale, const void* active,
                                    const void* parity, void* fy, void* fu,
                                    void* fv, void* py, void* pu, void* pv,
                                    int N, int mbw, int mbh, void* stream) {
  if (mbw < 1 || mbw > MAX_MB_WIDTH || mbh < 1 || N < 0)
    return (int)cudaErrorInvalidValue;
  if (N == 0) return (int)cudaSuccess;
  const uintptr_t a = (uintptr_t)coeffs_T |
                      (uintptr_t)(6 * mbw * mbh) * sizeof(int16_t) |
                      (uintptr_t)(6 * mbw) * sizeof(int16_t);
  const auto launch = a % 16 == 0 ? launch_idct_compose_put<8>
                      : a % 8 == 0 ? launch_idct_compose_put<4>
                      : a % 4 == 0 ? launch_idct_compose_put<2>
                                   : launch_idct_compose_put<1>;
  return launch(coeffs_T, recs, nfinal, intra_q, non_intra_q, scale, active,
                parity, fy, fu, fv, py, pu, pv, N, mbw, mbh,
                (cudaStream_t)stream);
}

// ref / ref2 uint8[N, H, W] (4-byte aligned); mvh / mvv int32[N,
// mbh_loc, mbw] (half-pel, at the plane's scale); out / out2 uint8[N,
// mbh_loc * S, W] (S-byte aligned); S is 16 or 8 and W = mbw * S.
// planes = 2 predicts ref2 into out2 from the same vectors in the same
// launch (both chroma planes, as _packed_kernel predicts the pair);
// planes = 1 reads neither ref2 nor out2.
extern "C" int esp_predict(const void* ref, const void* ref2,
                           const void* mvh, const void* mvv, void* out,
                           void* out2, int planes, int N, int H, int W,
                           int S, int mbw, int mbh_loc, int row0,
                           int clip_taps, void* stream) {
  if ((S != 8 && S != 16) || W != mbw * S || mbw * S > 1024 ||
      (planes != 1 && planes != 2) || row0 < 0 ||
      (row0 + mbh_loc) * S > H)
    return (int)cudaErrorInvalidValue;
  if (N <= 0 || mbh_loc <= 0) return (int)cudaGetLastError();
  const cudaStream_t s = (cudaStream_t)stream;
  const auto f = S == 16 ? (clip_taps ? launch_predict<16, true>
                                      : launch_predict<16, false>)
                         : (clip_taps ? launch_predict<8, true>
                                      : launch_predict<8, false>);
  f(ref, ref2, mvh, mvv, out, out2, planes, N, H, W, mbw, mbh_loc, row0, s);
  return (int)cudaGetLastError();
}

// K3's, K3F's, K3P's and K23's (at each copy width) registers, local and
// static shared bytes and largest block on the current device
// (resources.cuh).
extern "C" int esp_compose_resources(int* out, const char** names,
                                     int cap) {
  const void* fns[] = {(const void*)compose_put_kernel<false>,
                       (const void*)compose_put_kernel<true>,
                       (const void*)predict_kernel<16, false>,
                       (const void*)predict_kernel<8, false>,
                       (const void*)predict_kernel<16, true>,
                       (const void*)predict_kernel<8, true>,
                       (const void*)idct_compose_put_kernel<8>,
                       (const void*)idct_compose_put_kernel<4>,
                       (const void*)idct_compose_put_kernel<2>,
                       (const void*)idct_compose_put_kernel<1>};
  const char* kernel_names[] = {
      "compose_put_kernel<false>", "compose_put_kernel<true>",
      "predict_kernel<16, false>", "predict_kernel<8, false>",
      "predict_kernel<16, true>", "predict_kernel<8, true>",
      "idct_compose_put_kernel<8>", "idct_compose_put_kernel<4>",
      "idct_compose_put_kernel<2>", "idct_compose_put_kernel<1>"};
  return kernel_resources(fns, kernel_names, 10, out, names, cap);
}
