// K5 -- second-order CRFB delta-sigma modulator (PDM), state carried.
//
// Replaces: espflix_tpu/ops/delta_sigma_pallas.py _kernel
// (modulate_pallas); computes what espflix_tpu.ops.delta_sigma.modulate
// computes.
//
// Per PCM sample s = 2 * pcm two modulator half-ticks run with the same
// s; each does i0 = (i0 + s) >> 1 and then 16 bit steps
//     pos = i2 >= 0; i1 += i0 -+ A1 - (i2 >> 7); i2 += i1 -+ A2;
//     bits = bits << 1 | pos
// and emits one 16-bit word (MSB first): word 2t is the first half-tick
// of sample t.  (i0, i1, i2) go out after the last half-tick.  int32
// adds wrap as in JAX: they are done in uint32 and cast back, while the
// shifts stay arithmetic on the signed values.
//
// What bounds it on an H100: latency.  Each lane is one dependent chain
// of 2 * 16 * S bit steps (53,248 at S = 1,664) of about four dependent
// integer ops each; 1,024 lanes move only ~3.4 MB in and ~13.6 MB out.
// The TPU kernel kept the three state vregs of 1,024 lanes in registers
// and walked the sample axis with a sequential grid.  Here one thread
// owns one lane and keeps (i0, i1, i2) in registers for the whole call,
// so the time is one lane's chain and stays flat in the lane count up
// to thousands of lanes (one warp per block, one block per 32 lanes).
// One thread per lane would read pcm and write words strided by the
// lane's row; instead the warp stages TILE-sample tiles through shared
// memory so that every global load and store is a coalesced row
// segment.  Shared rows are padded by one word so column access by the
// 32 threads hits 32 banks.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int A1 = 38973;   // int(0x7FFF * 1.18940)
constexpr int A2 = 69577;   // int(0x7FFF * 2.12340)
constexpr int LANES = 32;   // lanes per block (one warp)
constexpr int TILE = 32;    // samples per shared-memory tile

__device__ __forceinline__ int wadd(int a, int b) {
  return (int)((uint32_t)a + (uint32_t)b);
}

__device__ __forceinline__ int half_tick(int& i0, int& i1, int& i2, int s) {
  i0 = wadd(i0, s) >> 1;
  int bits = 0;
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    const bool pos = i2 >= 0;
    i1 = wadd(wadd(i1, i0), wadd(pos ? -A1 : A1, -(i2 >> 7)));
    i2 = wadd(wadd(i2, i1), pos ? -A2 : A2);
    bits = (bits << 1) | (pos ? 1 : 0);
  }
  return bits;
}

__global__ void __launch_bounds__(LANES)
pdm_kernel(const int16_t* __restrict__ pcm, const int* __restrict__ st_in,
           int* __restrict__ words, int* __restrict__ st_out, int N, int S) {
  __shared__ int s_in[LANES][TILE + 1];
  __shared__ int s_out[LANES][2 * TILE + 1];
  const int j = threadIdx.x;
  const int lane0 = blockIdx.x * LANES;
  const int lane = lane0 + j;
  const bool live = lane < N;
  int i0 = 0, i1 = 0, i2 = 0;
  if (live) {
    i0 = st_in[(size_t)lane * 3 + 0];
    i1 = st_in[(size_t)lane * 3 + 1];
    i2 = st_in[(size_t)lane * 3 + 2];
  }
  const int rows = min(LANES, N - lane0);
  for (int t0 = 0; t0 < S; t0 += TILE) {
    const int c = min(TILE, S - t0);
    // load: row r of the tile is lane0 + r's samples [t0, t0 + c)
    for (int r = 0; r < rows; ++r)
      if (j < c) s_in[r][j] = pcm[(size_t)(lane0 + r) * S + t0 + j];
    __syncwarp();
    if (live) {
      for (int t = 0; t < c; ++t) {
        const int s = s_in[j][t] * 2;
        s_out[j][2 * t] = half_tick(i0, i1, i2, s);
        s_out[j][2 * t + 1] = half_tick(i0, i1, i2, s);
      }
    }
    __syncwarp();
    // store: row r's words [2 t0, 2 t0 + 2c), two coalesced segments
    for (int r = 0; r < rows; ++r) {
      int* dst = words + (size_t)(lane0 + r) * 2 * S + 2 * t0;
      for (int k = j; k < 2 * c; k += LANES) dst[k] = s_out[r][k];
    }
    __syncwarp();
  }
  if (live) {
    st_out[(size_t)lane * 3 + 0] = i0;
    st_out[(size_t)lane * 3 + 1] = i1;
    st_out[(size_t)lane * 3 + 2] = i2;
  }
}

}  // namespace

extern "C" int esp_pdm(const void* pcm, const void* state_in, void* words,
                       void* state_out, int N, int S, void* stream) {
  if (N <= 0 || S <= 0) return (int)cudaGetLastError();
  const dim3 grid((N + LANES - 1) / LANES);
  pdm_kernel<<<grid, LANES, 0, (cudaStream_t)stream>>>(
      (const int16_t*)pcm, (const int*)state_in, (int*)words,
      (int*)state_out, N, S);
  return (int)cudaGetLastError();
}
