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
// Semantics: mocomp.predict_plane_mxu's edge rule (window origin
// clip(xh >> 1, 0, W - S), zero past the plane), MPEG-1 half-pel
// rounding, chroma MVs >> 1; STALE keeps cur, INTRA is pin(res), else
// pin(int16(pred + res)) with pin = clip to 0..248; inactive lanes keep
// cur.

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

__global__ void compose_put_kernel(const int16_t* __restrict__ res_T,
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
  const int16_t* res_n = res_T + (size_t)n * 64 * BL + (size_t)r * mbw * 6;
  for (int i = threadIdx.x; i < 64 * cols; i += blockDim.x) {
    const int p = i / cols, k = i % cols;
    const int c = k / nb, blk = plane == 0 ? k % nb : 3 + plane;
    sres[i] = res_n[(size_t)p * BL + c * 6 + blk];
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

}  // namespace

extern "C" int esp_compose_put(const void* res_T, const void* recs,
                               const void* active, const void* parity,
                               void* fy, void* fu, void* fv, void* py,
                               void* pu, void* pv, int N, int mbw, int mbh,
                               void* stream) {
  const int threads = 256;
  dim3 grid(mbh, N, 3);
  const size_t smem = (size_t)64 * mbw * 4 * sizeof(int16_t);
  compose_put_kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(
      (const int16_t*)res_T, (const int*)recs, (const uint8_t*)active,
      (const int*)parity, (uint8_t*)fy, (uint8_t*)fu, (uint8_t*)fv,
      (uint8_t*)py, (uint8_t*)pu, (uint8_t*)pv, mbw, mbh);
  return (int)cudaGetLastError();
}
