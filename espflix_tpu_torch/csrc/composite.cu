// K4 -- both composite fields of a frame, parts form, with the per-lane
// canvas byte sum.
//
// Replaces: espflix_tpu/ops/composite_pallas.py _kernel_parts
// (synthesize_field_pair_parts), with the u/v upsample `prep`
// (composite_pallas.py:223-230) fused in.
//
// What bounds it on an H100: memory.  Per active pixel it reads 1 byte
// of luma plus (shared by 4 pixels) a chroma byte pair, and writes two
// packed int16 sample pairs -- ~5 B of traffic for ~60 integer ops.
// The TPU kernel evaluated whole [192, 352] tiles with masked selects
// and packed the two fields into one int32 lane (field 0 low, field 1
// high).  Here one block takes one canvas row of one lane; each thread
// computes one pixel's sample pair for both fields directly (the x-1
// neighbour's dithered luma is recomputed, not shuffled), so the
// chroma QAM chain runs once for both fields; blocks past the 192
// active rows build the 16-row OSD strip.  The byte sum is a block
// reduction plus one atomicAdd per block into chk[lane]; int32 sums
// are order-free, so chk is exact.  The block of row 0 adds the
// constant template base.
//
// Semantics: composite_pallas._kernel_parts (composite_pallas.py:67-186)
// for NTSC and PAL (the PAL V-switch alternates the v phase per line),
// the exact magic divide ((2|m| + 33) * 3972) >> 18 == (2|m| + 33) / 66
// (|m| <= 128 * BLACK_LEVEL = 3072), the chroma vertical interpolation
// (odd lines average the chroma row with the next one, clamped).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int H = 192, W = 352, HC = 96, WC = 176;
constexpr int OSD_W = 80, OSD_H = 16, PROGRESS_W = 240;
constexpr int BLACK_LEVEL = 24;   // video/tables.py BLACK_LEVEL (checked)

__device__ __forceinline__ int amp(int c) {
  const int m = (128 - c) * BLACK_LEVEL;
  const int am = m < 0 ? -m : m;
  const int s = (m > 0) - (m < 0);
  return s * (((2 * am + 33) * 3972) >> 18);
}

__device__ __forceinline__ int clip127(int x) {
  return x < 0 ? 0 : (x > 127 ? 127 : x);
}

// chroma sample after prep(): vertical interpolation on odd rows
__device__ __forceinline__ int chroma_at(const uint8_t* c, int row,
                                        int col) {
  const int r0 = row >> 1;
  const int r1 = r0 + 1 < HC ? r0 + 1 : HC - 1;
  const int c0 = c[r0 * WC + (col >> 1)];
  if (!(row & 1)) return c0;
  return (c0 >> 1) + (c[r1 * WC + (col >> 1)] >> 1);
}

__device__ __forceinline__ int block_sum(int v) {
  __shared__ int warp_sums[32];
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xFFFFFFFFu, v, o);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = v;
  __syncthreads();
  v = 0;
  if (warp == 0) {
    const int nw = (blockDim.x + 31) >> 5;
    v = lane < nw ? warp_sums[lane] : 0;
    for (int o = 16; o > 0; o >>= 1)
      v += __shfl_down_sync(0xFFFFFFFFu, v, o);
  }
  return v;                                   // valid in thread 0
}

__global__ void composite_parts_kernel(
    const uint8_t* __restrict__ y, const uint8_t* __restrict__ u,
    const uint8_t* __restrict__ v, const int* __restrict__ parity,
    const uint8_t* __restrict__ osd, const int* __restrict__ blend,
    const int* __restrict__ progress, const int16_t* __restrict__ tmpl,
    const int16_t* __restrict__ dither, int16_t* __restrict__ act,
    int16_t* __restrict__ strip, int* __restrict__ chk, int W2, int pal,
    int osd_top, int osd_xp, int bar_xp, int base) {
  const int n = blockIdx.x, row = blockIdx.y;
  int sum = 0;
  if (row < H) {
    // ---- active row: both fields' packed sample pairs ---------------
    const int par = parity[n] & 1;
    const int16_t* d0 = dither + (size_t)par * H * W + row * W;
    const int16_t* d1 = dither + (size_t)(1 - par) * H * W + row * W;
    const uint8_t* yr = y + ((size_t)n * H + row) * W;
    const uint8_t* un = u + (size_t)n * HC * WC;
    const uint8_t* vn = v + (size_t)n * HC * WC;
    int16_t* a0 = act + (((size_t)n * 2 + 0) * H + row) * W;
    int16_t* a1 = act + (((size_t)n * 2 + 1) * H + row) * W;
    const int bias = 2 * BLACK_LEVEL;
    const bool vsw = pal && (row & 1);
    for (int x = threadIdx.x; x < W; x += blockDim.x) {
      const int ru = amp(chroma_at(un, row, x));
      const int rv = amp(chroma_at(vn, row, x));
      const int pu_m = clip127(bias - ru), pu_p = clip127(bias + ru);
      const int pv_m = clip127(bias - rv), pv_p = clip127(bias + rv);
      const int k2v = vsw ? pv_p : pv_m, k3v = vsw ? pv_m : pv_p;
      const int cw0 = ((pu_m + bias) & 0xFC) >> 2;
      const int cw1 = ((pu_p + bias) & 0xFC) >> 2;
      const int cw2 = ((bias + k2v) & 0xFC) >> 2;
      const int cw3 = ((bias + k3v) & 0xFC) >> 2;
      const int cxa = (x & 1) ? cw2 : cw3;
      const int cxb = (x & 1) ? cw0 : cw1;
      const int yv = yr[x];
      const int ym = x > 0 ? yr[x - 1] : 0;
      for (int f = 0; f < 2; ++f) {
        const int16_t* d = f ? d1 : d0;
        const int P = (yv + d[x]) & 0xFC;
        const int p0 = P >> 2;
        const int Pm1 = x > 0 ? ((ym + d[x - 1]) & 0xFC) : 0;
        const int p0m1 = Pm1 >> 2;
        const int sa = (x & 3) == 0 ? (p0 + p0m1) >> 1
                                    : ((Pm1 >> 1) + (P >> 1)) >> 2;
        const int sac = (sa + cxa) & 0xFF, pbc = (p0 + cxb) & 0xFF;
        (f ? a1 : a0)[x] = (int16_t)(sac | (pbc << 8));
        sum += sac + pbc;
      }
    }
  } else {
    // ---- OSD strip row (identical in both fields: counted twice) ----
    const int sr = row - H;
    const int b = blend[n];
    const int scale = (b != -1 && b < 32) ? (63 * (b > 0 ? b : 0)) >> 5 : 63;
    const bool show = b != 0;
    const int c0 = ((BLACK_LEVEL << 8) + (scale << 8)) >> 8;
    const int c1 = ((BLACK_LEVEL << 8) + (scale << 7)) >> 8;
    const int prog = progress[n];
    const uint8_t* src = osd + ((size_t)n * OSD_H + sr) * OSD_W;
    int16_t* out = strip + ((size_t)n * OSD_H + sr) * W2;
    for (int x = threadIdx.x; x < W2; x += blockDim.x) {
      int val = tmpl[(osd_top + sr) * W2 + x] & 0xFFFF;
      if (show && x >= osd_xp && x < osd_xp + OSD_W) {
        const int text = ((BLACK_LEVEL << 8) + src[x - osd_xp] * scale) >> 8;
        val = text | (text << 8);
      }
      if (show && sr >= 3 && sr < 9 && x >= bar_xp &&
          x < bar_xp + PROGRESS_W) {
        const int bp = ((x - bar_xp) & ~1) < prog ? c0 : c1;
        val = bp | (bp << 8);
      }
      out[x] = (int16_t)val;
      sum += 2 * ((val & 0xFF) + ((val >> 8) & 0xFF));
    }
  }
  const int total = block_sum(sum);
  if (threadIdx.x == 0) atomicAdd(chk + n, total + (row == 0 ? base : 0));
}

}  // namespace

extern "C" int esp_composite_parts(
    const void* y, const void* u, const void* v, const void* parity,
    const void* osd, const void* blend, const void* progress,
    const void* tmpl, const void* dither, void* act, void* strip,
    void* chk, int N, int W2, int pal, int osd_top, int osd_xp, int bar_xp,
    int base, void* stream) {
  dim3 grid(N, H + OSD_H);
  composite_parts_kernel<<<grid, 128, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)y, (const uint8_t*)u, (const uint8_t*)v,
      (const int*)parity, (const uint8_t*)osd, (const int*)blend,
      (const int*)progress, (const int16_t*)tmpl, (const int16_t*)dither,
      (int16_t*)act, (int16_t*)strip, (int*)chk, W2, pal, osd_top, osd_xp,
      bar_xp, base);
  return (int)cudaGetLastError();
}
