// K2 -- exact dequant + fixed-point 8x8 IDCT on the [N, 64, BL] layout.
//
// Replaces: espflix_tpu/ops/idct_pallas.py _kernel_T
// (block_residuals_T_pallas).
//
// What bounds it on an H100: memory.  Per 8x8 block it reads 64 int16
// levels and writes 64 int16 residuals (256 B) for ~1k integer ops, far
// below the card's ops:byte balance.  The TPU kernel kept one lane's
// [64, BL] tile in VMEM and ran the butterflies as (8, BL) slab ops;
// here one thread owns one block: with BL on the fastest axis,
// consecutive threads read and write consecutive int16 of each
// position row (coalesced), the block's 64 values stay in registers
// through dequant and both butterfly passes, and uncoded blocks
// (nfinal == 0) skip the loads and write zeros.  The lane's two
// quantizer matrices sit in shared memory.
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
// K2 is; a block's 64 values are contiguous here, so each thread moves
// them as eight 16-byte vectors instead of one int16 per position row.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

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

// both butterfly passes in place over b[8r + j]: columns, then rows
// with the final rounding
__device__ __forceinline__ void idct_8x8(int b[64]) {
  int c[8], o[8];
  for (int j = 0; j < 8; ++j) {          // column pass: b[8r + j] over r
    for (int r = 0; r < 8; ++r) c[r] = b[8 * r + j];
    butterfly(c, o, false);
    for (int k = 0; k < 8; ++k) b[8 * k + j] = o[k];
  }
  for (int r = 0; r < 8; ++r) {          // row pass: b[8r + j] over j
    for (int j = 0; j < 8; ++j) c[j] = b[8 * r + j];
    butterfly(c, o, true);
    for (int m = 0; m < 8; ++m) b[8 * r + m] = o[m];
  }
}

__global__ void idct_T_kernel(const int16_t* __restrict__ coeffs_T,
                              const uint8_t* __restrict__ intra_bl,
                              const int* __restrict__ qs_bl,
                              const int* __restrict__ intra_q,
                              const int* __restrict__ non_intra_q,
                              const int* __restrict__ nfinal,
                              const int* __restrict__ scale,
                              int16_t* __restrict__ out, int BL) {
  __shared__ int qm[2][64];
  __shared__ int sc[64];
  const int n = blockIdx.y;
  for (int i = threadIdx.x; i < 64; i += blockDim.x) {
    qm[0][i] = non_intra_q[n * 64 + i];
    qm[1][i] = intra_q[n * 64 + i];
    sc[i] = scale[i];
  }
  __syncthreads();
  const int bl = blockIdx.x * blockDim.x + threadIdx.x;
  if (bl >= BL) return;
  const size_t base = (size_t)n * 64 * BL + bl;
  const int nf = nfinal[(size_t)n * BL + bl];
  if (nf == 0) {
    for (int p = 0; p < 64; ++p) out[base + (size_t)p * BL] = 0;
    return;
  }
  const bool intra = intra_bl[(size_t)n * BL + bl] != 0;
  const int qs = qs_bl[(size_t)n * BL + bl];
  const int* qmat = qm[intra ? 1 : 0];

  int b[64];
  for (int p = 0; p < 64; ++p)
    b[p] = dequant(coeffs_T[base + (size_t)p * BL], p, intra, qs, qmat, sc);
  if (nf == 1 && !intra) {
    const int16_t dc = (int16_t)(b[0] >> 8);
    for (int p = 0; p < 64; ++p) out[base + (size_t)p * BL] = dc;
    return;
  }
  idct_8x8(b);
  for (int p = 0; p < 64; ++p) out[base + (size_t)p * BL] = (int16_t)b[p];
}

// K2F: the same arithmetic on the lane-minor layout.  One thread per
// block; the block's 64 levels are contiguous (128 B), so a thread
// reads and writes them as eight 16-byte vectors.  Intra flag and
// qscale come from the block's MB record.
__global__ void idct_flat_kernel(const int16_t* __restrict__ coeffs,
                                 const int* __restrict__ recs,
                                 const int* __restrict__ nfinal,
                                 const int* __restrict__ intra_q,
                                 const int* __restrict__ non_intra_q,
                                 const int* __restrict__ scale,
                                 int16_t* __restrict__ out, int MB) {
  __shared__ int qm[2][64];
  __shared__ int sc[64];
  const int n = blockIdx.y;
  for (int i = threadIdx.x; i < 64; i += blockDim.x) {
    qm[0][i] = non_intra_q[n * 64 + i];
    qm[1][i] = intra_q[n * 64 + i];
    sc[i] = scale[i];
  }
  __syncthreads();
  const int BL = MB * 6;
  const int bl = blockIdx.x * blockDim.x + threadIdx.x;
  if (bl >= BL) return;
  const size_t base = ((size_t)n * BL + bl) * 64;
  int4* dst = reinterpret_cast<int4*>(out + base);
  const int nf = nfinal[(size_t)n * BL + bl];
  if (nf == 0) {
    for (int k = 0; k < 8; ++k) dst[k] = make_int4(0, 0, 0, 0);
    return;
  }
  const int rec = recs[(size_t)n * MB + bl / 6];
  const bool intra = (rec & 3) == 3;           // MB_INTRA
  const int qs = (rec >> 2) & 31;
  const int* qmat = qm[intra ? 1 : 0];

  int16_t lv[64];
  const int4* src = reinterpret_cast<const int4*>(coeffs + base);
  for (int k = 0; k < 8; ++k) {
    const int4 v = src[k];
    const int w[4] = {v.x, v.y, v.z, v.w};
    for (int j = 0; j < 4; ++j) {
      lv[8 * k + 2 * j] = (int16_t)(w[j] & 0xFFFF);
      lv[8 * k + 2 * j + 1] = (int16_t)((unsigned)w[j] >> 16);
    }
  }
  int b[64];
  for (int p = 0; p < 64; ++p) b[p] = dequant(lv[p], p, intra, qs, qmat, sc);

  int16_t o16[64];
  if (nf == 1 && !intra) {
    const int16_t dc = (int16_t)(b[0] >> 8);
    for (int p = 0; p < 64; ++p) o16[p] = dc;
  } else {
    idct_8x8(b);
    for (int p = 0; p < 64; ++p) o16[p] = (int16_t)b[p];
  }
  for (int k = 0; k < 8; ++k) {
    int w[4];
    for (int j = 0; j < 4; ++j)
      w[j] = (int)(uint16_t)o16[8 * k + 2 * j] |
             ((int)(uint16_t)o16[8 * k + 2 * j + 1] << 16);
    dst[k] = make_int4(w[0], w[1], w[2], w[3]);
  }
}

}  // namespace

extern "C" int esp_idct_T(const void* coeffs_T, const void* intra_bl,
                          const void* qs_bl, const void* intra_q,
                          const void* non_intra_q, const void* nfinal,
                          const void* scale, void* out, int N, int BL,
                          void* stream) {
  const int threads = 128;
  dim3 grid((BL + threads - 1) / threads, N);
  idct_T_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      (const int16_t*)coeffs_T, (const uint8_t*)intra_bl,
      (const int*)qs_bl, (const int*)intra_q, (const int*)non_intra_q,
      (const int*)nfinal, (const int*)scale, (int16_t*)out, BL);
  return (int)cudaGetLastError();
}

extern "C" int esp_idct_flat(const void* coeffs, const void* recs,
                             const void* nfinal, const void* intra_q,
                             const void* non_intra_q, const void* scale,
                             void* out, int N, int MB, void* stream) {
  const int threads = 128;
  dim3 grid((MB * 6 + threads - 1) / threads, N);
  idct_flat_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      (const int16_t*)coeffs, (const int*)recs, (const int*)nfinal,
      (const int*)intra_q, (const int*)non_intra_q, (const int*)scale,
      (int16_t*)out, MB);
  return (int)cudaGetLastError();
}
