// The dequant, the IDCT butterflies and the staging copies that K2, K2F
// (idct.cu) and K23 (compose.cu) share.  Bit-exact with
// espflix_tpu/ops/idct.py: see idct.cu's header.

#pragma once

#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

namespace {

// int32 a group's transpose tile (8 x 9); the intra quantiser matrix's
// offset in a CTA's qm[TILE + 64] (other banks for the 8 offset)
constexpr int TILE = 72;

// one 8-point pass (idct._butterfly_parts); in/out are 8 values
__device__ __forceinline__ void butterfly(const int c[8], int o[8],
                                          bool final_pass) {
  const int b1 = c[4];
  const int b3 = c[2] + c[6];
  const int b4 = c[5] - c[3];
  const int tmp1 = c[1] + c[7];
  const int tmp2 = c[3] + c[5];
  const int b6 = c[1] - c[7];
  const int b7 = tmp1 + tmp2;
  const int m0 = c[0];
  const int x4 = ((b6 * 473 - b4 * 196 + 128) >> 8) - b7;
  const int x0 = x4 - (((tmp1 - tmp2) * 362 + 128) >> 8);
  const int x1 = m0 - b1;
  const int x2 = (((c[2] - c[6]) * 362 + 128) >> 8) - b3;
  const int x3 = m0 + b1;
  const int y3 = x1 + x2;
  const int y4 = x3 + b3;
  const int y5 = x1 - x2;
  const int y6 = x3 - b3;
  const int y7 = -x0 - ((b4 * 473 + b6 * 196 + 128) >> 8);
  o[0] = b7 + y4; o[1] = x4 + y3; o[2] = y5 - x0; o[3] = y6 - y7;
  o[4] = y6 + y7; o[5] = x0 + y5; o[6] = y3 - x4; o[7] = y4 - b7;
  if (final_pass)
    for (int k = 0; k < 8; ++k) o[k] = (o[k] + 128) >> 8;
}

// exact dequant of one level at raster position p (idct.py:26-59)
__device__ __forceinline__ int dequant(int lev, int p, bool intra, int qs,
                                       const int* qmat, const int* sc) {
  int v = lev * 2;
  const int sign = (v > 0) - (v < 0);
  if (!intra) v += sign;
  const int num = v * qs * qmat[p];
  int q = num < 0 ? -((-num) >> 4) : (num >> 4);
  if ((q & 1) == 0) q = q > 0 ? q - 1 : (q < 0 ? q + 1 : (lev != 0));
  q = q < -2048 ? -2048 : (q > 2047 ? 2047 : q);
  return (intra && p == 0) ? lev * 256 : q * sc[p];
}

// V int16 from global into shared memory without a register: an
// asynchronous copy for V >= 2 (both addresses aligned to its 2 V
// bytes), a load and a store for V = 1; copy_wait() waits for this
// thread's copies
template <int V>
__device__ __forceinline__ void copy_in(int16_t* dst, const int16_t* src) {
  if constexpr (V == 1) {
    *dst = *src;
  } else {
#ifdef __CUDA_ARCH__
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
    if constexpr (V == 8)
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                   "l"(src));
    else
      asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d),
                   "l"(src), "n"(2 * V));
#else
    memcpy(dst, src, 2 * V);
#endif
  }
}

__device__ __forceinline__ void copy_wait() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.wait_all;\n" ::);
#endif
}

}  // namespace
