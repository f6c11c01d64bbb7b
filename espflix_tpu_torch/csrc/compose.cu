// K3 -- half-pel MB prediction fused with compose and the parity put.
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
  const int W = mbw * 16, H = mbh * 16, BL = mbw * mbh * 6;
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

  const int yc = yi & 7, Wc = W / 2, Hc = H / 2;
  const size_t ypx = (size_t)H * W, cpx = ypx / 4;
  const size_t yat = (size_t)(r * 16 + yi) * W + c * 16;
  const size_t cat = (size_t)(r * 8 + yc) * Wc + c * 8;
  uint8_t* cur_y = fy + ((size_t)n * 2 + par) * ypx;
  uint8_t* fc = yi < 8 ? fu : fv;
  uint8_t* cur_c = fc + ((size_t)n * 2 + par) * cpx;
  uint8_t* out_y = py + n * ypx + yat;
  uint8_t* out_c = (yi < 8 ? pu : pv) + n * cpx + cat;
  if (kind == MB_STALE) {              // and every MB of an inactive lane
    *reinterpret_cast<uint4*>(out_y) =
        *reinterpret_cast<const uint4*>(cur_y + yat);
    *reinterpret_cast<uint2*>(out_c) =
        *reinterpret_cast<const uint2*>(cur_c + cat);
    return;
  }

  // the thread's block rows: luma blocks blk, blk + 1, chroma 4 + (yi >> 3)
  const int blk = (yi >> 3) * 2, cblk = 4 + (yi >> 3);
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
  const int mvx = sext12(rec >> 7), mvy = sext12(rec >> 19);
  compose_row<16>(fy + ((size_t)n * 2 + 1 - par) * ypx, cur_y + yat, out_y,
                  W, H, kind, mvx, mvy, c, r, yi, ry);
  compose_row<8>(fc + ((size_t)n * 2 + 1 - par) * cpx, cur_c + cat, out_c,
                 Wc, Hc, kind, mvx >> 1, mvy >> 1, c, r, yc, rc);
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

// K3's stage takes 864 B an MB column, over the 48 KB default from
// mb_width 57 on: raise its limit to MAX_MB_WIDTH columns once for each
// device (a function attribute belongs to the device's context), not
// on every launch
cudaError_t allow_k3_stage() {
  static std::atomic<unsigned long long> raised{0};   // a bit a device
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0;
  if (raised.load(std::memory_order_relaxed) & bit) return cudaSuccess;
  e = cudaFuncSetAttribute(
      compose_put_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      MAX_MB_WIDTH * 6 * RES_STRIDE * (int)sizeof(int16_t));
  if (e == cudaSuccess) raised.fetch_or(bit);
  return e;
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

// K3's, K3F's and K3P's registers, local and static shared bytes and
// largest block on the current device (resources.cuh).
extern "C" int esp_compose_resources(int* out, const char** names,
                                     int cap) {
  const void* fns[] = {(const void*)compose_put_kernel<false>,
                       (const void*)compose_put_kernel<true>,
                       (const void*)predict_kernel<16, false>,
                       (const void*)predict_kernel<8, false>,
                       (const void*)predict_kernel<16, true>,
                       (const void*)predict_kernel<8, true>};
  const char* kernel_names[] = {
      "compose_put_kernel<false>", "compose_put_kernel<true>",
      "predict_kernel<16, false>", "predict_kernel<8, false>",
      "predict_kernel<16, true>", "predict_kernel<8, true>"};
  return kernel_resources(fns, kernel_names, 6, out, names, cap);
}
