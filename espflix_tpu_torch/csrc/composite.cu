// K4 -- both composite fields of a frame, parts form, with the per-lane
// canvas byte sum.
//
// Replaces: espflix_tpu/ops/composite_pallas.py _kernel_parts
// (synthesize_field_pair_parts), with the u/v upsample `prep`
// (composite_pallas.py:223-230) fused in.
//
// What bounds it on an H100: memory.  A lane reads its y, u and v
// (101,376 B) and writes both fields' packed sample pairs (270,336 B)
// and the OSD strip; the dither planes and the template rows are the
// same for every lane.  The TPU kernel evaluated whole [192, 352] tiles
// with masked selects, one lane a grid step.  Here a thread owns four
// adjacent pixels of one canvas row (x = 4k .. 4k+3, 88 threads a row)
// and walks LANES lanes, so that every access is one aligned word: a
// 32-bit luma load, a 16-bit load of the two chroma columns per plane
// and chroma row, and one 64-bit store a field.  Its dither words (both
// planes, and the x-1 neighbour) load once and serve every lane.
//
//   * The chroma chain amp -> clip127 -> the chroma words is a pure
//     function of the 8-bit prepped sample, so it is a 256-entry table
//     in shared memory, built by each block's threads in its prologue:
//     word cp | cm << 16 (cxb of an even / odd pixel of a u sample, cxa
//     of a v sample) and its half-swapped twin for the PAL V-switch
//     lines.  The exact magic divide ((2|m| + 33) * 3972) >> 18 ==
//     (2|m| + 33) / 66 (|m| <= 128 * BLACK_LEVEL = 3072) stays.
//   * The luma chain runs on pixel pairs in 16-bit halves: P = (y + d)
//     & 0xFC by __vadd2 (exact for any int16 dither), the x-1 neighbour
//     by byte permutes (pixel 4k's from the byte before the word), and
//     every later value fits its half (sa <= 63, chroma words <= 43), so
//     a field's output word is one permute of sac and pbc.  The planes
//     are computed in dither-plane order; plane p is field p ^ parity.
//   * The byte sum: dp4a of each output word, one warp reduction a lane
//     into a per-block lane sum in shared memory, one atomicAdd a lane a
//     block (int32 adds are order-free, so chk is exact); the block of
//     rows 0-3 adds the constant template base.
//   * Blocks past the active rows build the 16-row OSD strip, four
//     elements a thread (one 64-bit template load, one 64-bit store a
//     lane), each element masked on its own, with the strip's bytes
//     counted twice (it is in both fields).
//
// Semantics: composite_pallas._kernel_parts (composite_pallas.py:67-186)
// for NTSC and PAL (the PAL V-switch alternates the v phase per line),
// the chroma vertical interpolation (odd lines average the chroma row
// with the next one, clamped at row 95).

#include <cstdint>
#include <cuda_runtime.h>

#include "resources.cuh"

namespace {

constexpr int H = 192, W = 352, HC = 96, WC = 176;
constexpr int OSD_W = 80, OSD_H = 16, PROGRESS_W = 240;
constexpr int BLACK_LEVEL = 24;   // video/tables.py BLACK_LEVEL (checked)
constexpr int BIAS = 2 * BLACK_LEVEL;
constexpr int GROUPS = W / 4;              // four-pixel groups a row: 88
constexpr int ROWS = 4;                    // canvas rows a block
constexpr int THREADS = ROWS * GROUPS;     // 352, eleven full warps
constexpr int ACTIVE_BLOCKS = H / ROWS;    // 48
constexpr int LANES = 8;                   // lanes a block walks

__device__ __forceinline__ int amp(int c) {
  const int m = (128 - c) * BLACK_LEVEL;
  const int am = m < 0 ? -m : m;
  const int s = (m > 0) - (m < 0);
  return s * (((2 * am + 33) * 3972) >> 18);
}

__device__ __forceinline__ int clip127(int x) {
  return x < 0 ? 0 : (x > 127 ? 127 : x);
}

// one pixel pair's output word of one field: sac | pbc << 8 per pixel
__device__ __forceinline__ uint32_t pack(uint32_t sac, uint32_t pbc) {
  return __byte_perm(sac, pbc, 0x6240);
}

// lane 0 of each warp adds the warp's sum of v into *sum (shared)
__device__ __forceinline__ void warp_add(int* sum, uint32_t v) {
  v = __reduce_add_sync(0xFFFFFFFFu, v);
  if ((threadIdx.x & 31) == 0) atomicAdd(sum, (int)v);
}

__global__ void __launch_bounds__(THREADS) composite_parts_kernel(
    const uint8_t* __restrict__ y, const uint8_t* __restrict__ u,
    const uint8_t* __restrict__ v, const int* __restrict__ parity,
    const uint8_t* __restrict__ osd, const int* __restrict__ blend,
    const int* __restrict__ progress, const int16_t* __restrict__ tmpl,
    const int16_t* __restrict__ dither, int16_t* __restrict__ act,
    int16_t* __restrict__ strip, int* __restrict__ chk, int N, int W2,
    int pal, int osd_top, int osd_xp, int bar_xp, int base) {
  // [0][c]: cp(c) | cm(c) << 16; [1][c]: cm(c) | cp(c) << 16
  __shared__ uint32_t cwords[2][256];
  __shared__ int lane_sum[LANES];
  const int t = threadIdx.x;
  for (int c = t; c < 256; c += THREADS) {
    const int a = amp(c);
    const uint32_t cm = ((clip127(BIAS - a) + BIAS) & 0xFC) >> 2;
    const uint32_t cp = ((clip127(BIAS + a) + BIAS) & 0xFC) >> 2;
    cwords[0][c] = cp | cm << 16;
    cwords[1][c] = cm | cp << 16;
  }
  if (t < LANES) lane_sum[t] = 0;
  __syncthreads();
  const int n0 = blockIdx.y * LANES;
  const int lanes = N - n0 < LANES ? N - n0 : LANES;

  if (blockIdx.x < ACTIVE_BLOCKS) {
    // ---- active rows: thread t owns pixels 4k..4k+3 of one row ---------
    const int row = blockIdx.x * ROWS + t / GROUPS, k = t % GROUPS;
    const int px = row * W + 4 * k;                  // offset in a plane
    const uint2 dw[2] = {*reinterpret_cast<const uint2*>(dither + px),
                         *reinterpret_cast<const uint2*>(dither + H * W +
                                                         px)};
    // the x-1 neighbour: P(-1) reads 0 (kmask), its index clamped
    const int pm = k ? px - 1 : px;
    const int dm[2] = {dither[pm], dither[H * W + pm]};
    const int kmask = k ? 0xFC : 0;
    const bool odd = row & 1;
    const int r0 = row >> 1;
    const int r1 = odd ? (r0 + 1 < HC ? r0 + 1 : HC - 1) : r0;
    const int c0 = r0 * WC + 2 * k, c1 = r1 * WC + 2 * k;
    const uint32_t* vwords = cwords[pal && odd];
    for (int l = 0; l < lanes; ++l) {
      const int n = n0 + l;
      const uint8_t* yn = y + (size_t)n * H * W;
      const uint32_t yw = *reinterpret_cast<const uint32_t*>(yn + px);
      const int ym = yn[pm];
      const uint8_t* un = u + (size_t)n * HC * WC;
      const uint8_t* vn = v + (size_t)n * HC * WC;
      uint32_t uw = *reinterpret_cast<const uint16_t*>(un + c0);
      uint32_t vw = *reinterpret_cast<const uint16_t*>(vn + c0);
      const uint32_t uw1 = *reinterpret_cast<const uint16_t*>(un + c1);
      const uint32_t vw1 = *reinterpret_cast<const uint16_t*>(vn + c1);
      if (odd) {    // (c0 >> 1) + (c1 >> 1) in each byte: no carry out
        uw = ((uw >> 1) & 0x7F7F) + ((uw1 >> 1) & 0x7F7F);
        vw = ((vw >> 1) & 0x7F7F) + ((vw1 >> 1) & 0x7F7F);
      }
      // chroma words of the pairs (4k, 4k+1) and (4k+2, 4k+3)
      const uint32_t cxb01 = cwords[0][uw & 0xFF], cxb23 = cwords[0][uw >> 8];
      const uint32_t cxa01 = vwords[vw & 0xFF], cxa23 = vwords[vw >> 8];
      const uint32_t y01 = __byte_perm(yw, 0, 0x4140);
      const uint32_t y23 = __byte_perm(yw, 0, 0x4342);
      const int par = parity[n] & 1;
      uint32_t sum = 0;
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        const uint32_t P01 = __vadd2(y01, dw[p].x) & 0x00FC00FCu;
        const uint32_t P23 = __vadd2(y23, dw[p].y) & 0x00FC00FCu;
        const uint32_t Pm = (uint32_t)(ym + dm[p]) & kmask;   // P(4k-1)
        const uint32_t M01 = __byte_perm(Pm, P01, 0x5410);   // P(x-1)
        const uint32_t M23 = __byte_perm(P01, P23, 0x5432);
        const uint32_t p01 = P01 >> 2, p23 = P23 >> 2;
        // x & 3 == 0 (pixel 4k): (p0 + p0(x-1)) >> 1; the others
        // ((P(x-1) >> 1) + (P >> 1)) >> 2; the masks drop what a
        // high half shifts into the low one
        const uint32_t a01 = (p01 + (M01 >> 2)) >> 1;
        const uint32_t b01 = ((M01 >> 1) + (P01 >> 1)) >> 2;
        const uint32_t sa01 = __byte_perm(a01, b01, 0x7610) & 0x00FF00FFu;
        const uint32_t sa23 = (((M23 >> 1) + (P23 >> 1)) >> 2) & 0x00FF00FFu;
        const uint32_t o01 = pack(sa01 + cxa01, p01 + cxb01);
        const uint32_t o23 = pack(sa23 + cxa23, p23 + cxb23);
        sum = __dp4a(o01, 0x01010101u, sum);
        sum = __dp4a(o23, 0x01010101u, sum);
        *reinterpret_cast<uint2*>(
            act + (((size_t)n * 2 + (p ^ par)) * H) * W + px) =
            make_uint2(o01, o23);
      }
      warp_add(lane_sum + l, sum);
    }
  } else {
    // ---- OSD strip: four elements a thread, the same in both fields ---
    const int G2 = W2 / 4;
    const int j = (blockIdx.x - ACTIVE_BLOCKS) * THREADS + t;
    const bool live = j < OSD_H * G2;
    const int sr = live ? j / G2 : 0, x = live ? 4 * (j % G2) : 0;
    const uint2 tw =
        *reinterpret_cast<const uint2*>(tmpl + (osd_top + sr) * W2 + x);
    const int tv[4] = {(int)(tw.x & 0xFFFF), (int)(tw.x >> 16),
                       (int)(tw.y & 0xFFFF), (int)(tw.y >> 16)};
    const bool bar_row = sr >= 3 && sr < 9;
    for (int l = 0; l < lanes; ++l) {
      const int n = n0 + l;
      const int b = blend[n];
      const int scale =
          (b != -1 && b < 32) ? (63 * (b > 0 ? b : 0)) >> 5 : 63;
      const bool show = b != 0;
      const int on = ((BLACK_LEVEL << 8) + (scale << 8)) >> 8;
      const int off = ((BLACK_LEVEL << 8) + (scale << 7)) >> 8;
      const int prog = progress[n];
      const uint8_t* src = osd + ((size_t)n * OSD_H + sr) * OSD_W;
      uint32_t sum = 0;
      uint32_t w[2];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int xe = x + e;
        int val = tv[e];
        if (show && xe >= osd_xp && xe < osd_xp + OSD_W) {
          const int text =
              ((BLACK_LEVEL << 8) + src[xe - osd_xp] * scale) >> 8;
          val = text | (text << 8);
        }
        if (show && bar_row && xe >= bar_xp && xe < bar_xp + PROGRESS_W) {
          const int bp = ((xe - bar_xp) & ~1) < prog ? on : off;
          val = bp | (bp << 8);
        }
        sum += 2 * ((val & 0xFF) + ((val >> 8) & 0xFF));
        if (e & 1)
          w[e >> 1] |= (uint32_t)(val & 0xFFFF) << 16;
        else
          w[e >> 1] = (uint32_t)(val & 0xFFFF);
      }
      if (live)
        *reinterpret_cast<uint2*>(strip + ((size_t)n * OSD_H + sr) * W2 +
                                  x) = make_uint2(w[0], w[1]);
      warp_add(lane_sum + l, live ? sum : 0);
    }
  }
  __syncthreads();
  if (t < lanes)
    atomicAdd(chk + n0 + t, lane_sum[t] + (blockIdx.x == 0 ? base : 0));
}

bool aligned(const void* p, uintptr_t a) {
  return ((uintptr_t)p & (a - 1)) == 0;
}

}  // namespace

extern "C" int esp_composite_parts(
    const void* y, const void* u, const void* v, const void* parity,
    const void* osd, const void* blend, const void* progress,
    const void* tmpl, const void* dither, void* act, void* strip,
    void* chk, int N, int W2, int pal, int osd_top, int osd_xp, int bar_xp,
    int base, void* stream) {
  // the word accesses: y by 4 bytes, u and v by 2, the dither, the
  // template rows, act and the strip by 8
  if (W2 % 4 || !aligned(y, 4) || !aligned(u, 2) || !aligned(v, 2) ||
      !aligned(dither, 8) || !aligned(tmpl, 8) || !aligned(act, 8) ||
      !aligned(strip, 8))
    return (int)cudaErrorMisalignedAddress;
  if (N == 0) return (int)cudaSuccess;
  const int strip_blocks = (OSD_H * (W2 / 4) + THREADS - 1) / THREADS;
  dim3 grid(ACTIVE_BLOCKS + strip_blocks, (N + LANES - 1) / LANES);
  composite_parts_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)y, (const uint8_t*)u, (const uint8_t*)v,
      (const int*)parity, (const uint8_t*)osd, (const int*)blend,
      (const int*)progress, (const int16_t*)tmpl, (const int16_t*)dither,
      (int16_t*)act, (int16_t*)strip, (int*)chk, N, W2, pal, osd_top,
      osd_xp, bar_xp, base);
  return (int)cudaGetLastError();
}

// K4's registers, local and static shared bytes and largest block on
// the current device (resources.cuh).
extern "C" int esp_composite_resources(int* out, const char** names,
                                       int cap) {
  const void* fns[] = {(const void*)composite_parts_kernel};
  const char* kernel_names[] = {"composite_parts_kernel"};
  return kernel_resources(fns, kernel_names, 1, out, names, cap);
}
