// K3 -- half-pel MB prediction fused with compose and the parity put.
//
// Replaces: espflix_tpu/ops/mocomp_pallas.py _phase2p_kernel (luma,
// predict_plane_phase2p) and _packedp_kernel (u+v,
// predict_chroma_pair_packedp accum=True), plus the residual-plane
// assembly, compose and put of models/mpeg1.dense_compose (coeffs_T
// path, mpeg1.py:562-664).  It computes what every predict_plane
// variant of mocomp_pallas.py computes, with the main path's edge rule.
//
// What bounds it on an H100: memory -- per output pixel one byte of the
// current plane, four taps of the reference (mostly L1 hits), two bytes
// of residual, and two byte stores.  The TPU version materialised the
// predicted planes and a 7-D residual transpose in HBM because a fused
// kernel serialised there on per-MB branches (mpeg1.py:358-368); a GPU
// thread simply branches per pixel.  One block per (MB row, lane,
// plane): it stages the row's residual blocks from K2's [N, 64, BL]
// output in shared memory with coalesced reads, then walks the row's
// pixels in raster order so the reference, current-plane and output
// accesses of a warp are contiguous.
//
// The put writes IN PLACE into frames[:, parity]: the prediction reads
// only the reference slot 1 - parity, and each pixel of the parity slot
// is read (as `cur`) and written by the same thread, so no block reads
// what another writes.  The presented planes go to separate tensors.
//
// K3F (esp_compose_put_flat) is the same kernel reading K2F's
// lane-minor residuals int16[N, MB*6, 64]: the plane assembly of the
// lane-minor dense phase (models/mpeg1.py:592-609) becomes index
// arithmetic in the staging loop, so no residual plane is written.  It
// replaces mocomp_pallas.py _compose_kernel (compose_plane_pallas) and
// _compose2_kernel (compose_plane_pallas2), y, u and v in one launch.
//
// Semantics: mocomp.predict_plane_mxu's edge rule (window origin
// clip(xh >> 1, 0, W - S), zero past the plane), MPEG-1 half-pel
// rounding, chroma MVs >> 1; STALE keeps cur, INTRA is pin(res), else
// pin(int16(pred + res)) with pin = clip to 0..248; inactive lanes keep
// cur.
//
// K3P (esp_predict) -- prediction alone, for a band of MB rows.
// Replaces mocomp_pallas.py _kernel (predict_plane_pallas), the
// _phase_kernel, _phase2_kernel and _phase4_kernel luma forms and
// _packed_kernel: every one of them computes predict_plane and nothing
// else; the mesh's decoders compose afterwards in torch ops, as the JAX
// package composes in XLA.  One block per (MB row of the band, lane),
// each thread four adjacent output bytes stored as one 32-bit word (a
// 4-pixel group never straddles an MB: S is 8 or 16), the taps read
// through the read-only cache.  What bounds it: memory -- each output
// byte is written once and its taps are mostly L1 hits of the window
// the row's MBs share.  The JAX package has two edge rules, and K3P
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

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ int sext12(int x) {
  x &= 0xFFF;
  return x >= 0x800 ? x - 0x1000 : x;
}

__device__ __forceinline__ int pin(int x) {
  return x < 0 ? 0 : (x > 248 ? 248 : x);
}

// FLAT = false: residuals res int16[N, 64, BL] (K2's output); FLAT =
// true: res int16[N, BL, 64] (K2F's output).  Only the staging of the
// MB row's residual blocks into shared memory differs.
template <bool FLAT>
__global__ void compose_put_kernel(const int16_t* __restrict__ rsrc,
                                   const int* __restrict__ recs,
                                   const uint8_t* __restrict__ active,
                                   const int* __restrict__ parity,
                                   uint8_t* fy, uint8_t* fu, uint8_t* fv,
                                   uint8_t* __restrict__ py,
                                   uint8_t* __restrict__ pu,
                                   uint8_t* __restrict__ pv, int mbw,
                                   int mbh) {
  extern __shared__ int16_t sres[];          // [64][mbw * nb]
  __shared__ int s_kind[64], s_mvx[64], s_mvy[64];
  const int r = blockIdx.x, n = blockIdx.y, plane = blockIdx.z;
  const int S = plane == 0 ? 16 : 8;
  const int nb = plane == 0 ? 4 : 1;         // residual blocks per MB
  const int W = mbw * S, H = mbh * S;
  const int BL = mbw * mbh * 6;
  const int cols = mbw * nb;

  for (int c = threadIdx.x; c < mbw; c += blockDim.x) {
    const int rec = recs[(size_t)n * mbw * mbh + r * mbw + c];
    int mvx = sext12(rec >> 7), mvy = sext12(rec >> 19);
    if (plane) { mvx >>= 1; mvy >>= 1; }
    s_kind[c] = rec & 3;
    s_mvx[c] = mvx;
    s_mvy[c] = mvy;
  }
  if (FLAT) {
    // the row's blocks are contiguous: position p fastest for coalescing
    const int16_t* res_n =
        rsrc + ((size_t)n * BL + (size_t)r * mbw * 6) * 64;
    for (int i = threadIdx.x; i < 64 * cols; i += blockDim.x) {
      const int k = i / 64, p = i % 64;
      const int c = k / nb, blk = plane == 0 ? k % nb : 3 + plane;
      sres[p * cols + k] = res_n[(size_t)(c * 6 + blk) * 64 + p];
    }
  } else {
    const int16_t* res_n = rsrc + (size_t)n * 64 * BL + (size_t)r * mbw * 6;
    for (int i = threadIdx.x; i < 64 * cols; i += blockDim.x) {
      const int p = i / cols, k = i % cols;
      const int c = k / nb, blk = plane == 0 ? k % nb : 3 + plane;
      sres[i] = res_n[(size_t)p * BL + c * 6 + blk];
    }
  }
  __syncthreads();

  uint8_t* f = plane == 0 ? fy : (plane == 1 ? fu : fv);
  uint8_t* pres = plane == 0 ? py : (plane == 1 ? pu : pv);
  const int par = parity[n];
  const bool live = active[n] != 0;
  const size_t plane_px = (size_t)H * W;
  const uint8_t* ref = f + ((size_t)n * 2 + (1 - par)) * plane_px;
  uint8_t* cur = f + ((size_t)n * 2 + par) * plane_px;
  uint8_t* out = pres + (size_t)n * plane_px;

  for (int i = threadIdx.x; i < S * W; i += blockDim.x) {
    const int yi = i / W, x = i % W;
    const int c = x / S, xi = x % S;
    const int y = r * S + yi;
    const size_t at = (size_t)y * W + x;
    const int kind = s_kind[c];
    const uint8_t old = cur[at];
    int val = old;
    if (kind != 0 && live) {
      const int blk = plane == 0 ? ((yi >> 3) << 1) | (xi >> 3) : 0;
      const int p = ((yi & 7) << 3) | (xi & 7);
      const int res = sres[p * cols + c * nb + blk];
      if (kind == 3) {
        val = pin(res);
      } else {
        const int xh = c * S * 2 + s_mvx[c];
        const int yh = r * S * 2 + s_mvy[c];
        int x0 = xh >> 1, y0 = yh >> 1;
        x0 = x0 < 0 ? 0 : (x0 > W - S ? W - S : x0);
        y0 = y0 < 0 ? 0 : (y0 > H - S ? H - S : y0);
        const int sx = x0 + xi, sy = y0 + yi;     // >= 0, < W / < H
        const bool xin = sx + 1 < W, yin = sy + 1 < H;
        const uint8_t* rp = ref + (size_t)sy * W + sx;
        const int a = rp[0];
        const int b = xin ? rp[1] : 0;
        const int cc = yin ? rp[W] : 0;
        const int d = (xin && yin) ? rp[W + 1] : 0;
        const bool hx = xh & 1, hy = yh & 1;
        const int pred = !hx ? (!hy ? a : (a + cc + 1) >> 1)
                             : (!hy ? (a + b + 1) >> 1
                                    : (a + b + cc + d + 2) >> 2);
        val = pin((int16_t)(pred + res));
      }
    }
    cur[at] = (uint8_t)val;
    out[at] = (uint8_t)val;
  }
}

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

template <bool CLIP_TAPS>
__global__ void predict_kernel(const uint8_t* __restrict__ ref,
                               const int* __restrict__ mvh,
                               const int* __restrict__ mvv,
                               uint8_t* __restrict__ out, int H, int W,
                               int S, int mbw, int mbh_loc, int row0) {
  const int r = blockIdx.x, n = blockIdx.y;
  const uint8_t* rp = ref + (size_t)n * H * W;
  uint8_t* op = out + ((size_t)n * mbh_loc + r) * S * W;
  const int* mh = mvh + ((size_t)n * mbh_loc + r) * mbw;
  const int* mv = mvv + ((size_t)n * mbh_loc + r) * mbw;
  const int quads = S * W / 4;
  for (int q = threadIdx.x; q < quads; q += blockDim.x) {
    const int yi = (q * 4) / W, x = (q * 4) % W;
    const int c = x / S, xi = x % S;
    const int xh = c * S * 2 + __ldg(mh + c);
    const int yh = (row0 + r) * S * 2 + __ldg(mv + c);
    const bool hx = xh & 1, hy = yh & 1;
    int ya, yb;                       // rows of the a/b and c/d taps
    bool yb_in;
    int xa0;                          // column of the first a tap
    if (CLIP_TAPS) {
      ya = clampi((yh >> 1) + yi, 0, H - 1);
      yb = clampi((yh >> 1) + yi + 1, 0, H - 1);
      yb_in = true;
      xa0 = (xh >> 1) + xi;
    } else {
      ya = clampi(yh >> 1, 0, H - S) + yi;        // < H
      yb = ya + 1;
      yb_in = yb < H;
      xa0 = clampi(xh >> 1, 0, W - S) + xi;       // a taps stay < W
    }
    const uint8_t* ra = rp + (size_t)ya * W;
    const uint8_t* rb = rp + (size_t)(yb_in ? yb : ya) * W;
    uint32_t word = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      int xa = xa0 + k, xb = xa0 + k + 1;
      bool xb_in = true;
      if (CLIP_TAPS) {
        xa = clampi(xa, 0, W - 1);
        xb = clampi(xb, 0, W - 1);
      } else {
        xb_in = xb < W;
        if (!xb_in) xb = xa;
      }
      const int a = __ldg(ra + xa);
      const int b = xb_in ? __ldg(ra + xb) : 0;
      const int cc = yb_in ? __ldg(rb + xa) : 0;
      const int d = (yb_in && xb_in) ? __ldg(rb + xb) : 0;
      const int pred = !hx ? (!hy ? a : (a + cc + 1) >> 1)
                           : (!hy ? (a + b + 1) >> 1
                                  : (a + b + cc + d + 2) >> 2);
      word |= (uint32_t)pred << (8 * k);
    }
    *reinterpret_cast<uint32_t*>(op + (size_t)yi * W + x) = word;
  }
}

template <bool FLAT>
int launch_compose_put(const void* res, const void* recs, const void* active,
                       const void* parity, void* fy, void* fu, void* fv,
                       void* py, void* pu, void* pv, int N, int mbw, int mbh,
                       void* stream) {
  const int threads = 256;
  dim3 grid(mbh, N, 3);
  const size_t smem = (size_t)64 * mbw * 4 * sizeof(int16_t);
  compose_put_kernel<FLAT><<<grid, threads, smem, (cudaStream_t)stream>>>(
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

// ref uint8[N, H, W]; mvh / mvv int32[N, mbh_loc, mbw] (half-pel, at the
// plane's scale); out uint8[N, mbh_loc * S, W].  W % 4 == 0.
extern "C" int esp_predict(const void* ref, const void* mvh, const void* mvv,
                           void* out, int N, int H, int W, int S, int mbw,
                           int mbh_loc, int row0, int clip_taps,
                           void* stream) {
  dim3 grid(mbh_loc, N);
  const int threads = 256;
  if (clip_taps)
    predict_kernel<true><<<grid, threads, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)ref, (const int*)mvh, (const int*)mvv, (uint8_t*)out,
        H, W, S, mbw, mbh_loc, row0);
  else
    predict_kernel<false><<<grid, threads, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)ref, (const int*)mvh, (const int*)mvv, (uint8_t*)out,
        H, W, S, mbw, mbh_loc, row0);
  return (int)cudaGetLastError();
}
