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
// of 2 * 16 * S bit steps (53,248 at S = 1,664); 1,024 lanes move only
// ~3.4 MB in and ~13.6 MB out.  More lanes or SMs change nothing: the
// only lever is the cycles a step.  So the step is rewritten, with the
// same bits, to make i2's chain three dependent integer operations:
//   - the sign as a mask, m = i2 >> 31 (-1 where i2 < 0), not a predicate:
//     (pos ? -A1 : A1) = -A1 + (m & 2 A1), and the same for A2;
//   - i1 substituted into i2, with c = i1 + i0 - A1 - A2 carried in place
//     of i1 (sums reorder freely mod 2^32):
//         g   = c - (i2 >> 7)
//         i2' = i2 + g + (m & (2 A1 + 2 A2))
//         c'  = g + (i0 - A1) + (m & 2 A1)
//     so i2 -> (shift) -> (sub, and) -> add3 -> i2', and c' is computed
//     beside it; i1 = c - i0 + A1 + A2 is rebuilt once at the end.  A new
//     half-tick's i0 moves c by i0' - i0, off the chain;
//   - the word is built off the chain from the sign masks, one OR a step
//     (as (neg << 1) - m the compiler made two 16-deep chains of IMADs at
//     the end of each sample, on the loop's path).
// The TPU kernel kept the three state vregs of 1,024 lanes in registers
// and walked the sample axis with a sequential grid.  Here one thread
// owns one lane and keeps its state in registers for the whole call (one
// warp per block, one block per 32 lanes).  One thread per lane would
// read pcm and write words strided by the lane's row; instead the warp
// stages TILE-sample tiles through shared memory so that every global
// load and store is a coalesced row segment, and the next tile's samples
// are loaded into registers while the current tile runs, so the load's
// latency is off the chain.  Those loads read clamped addresses with no
// condition and keep the samples as int16 up to the shared tile: a
// select or a sign extension after each load (a first version) made the
// warp wait for the 32 loads one after another, ~12 cycles a bit step.
// Shared rows are padded so that column access by the 32 threads hits 32
// banks.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int A1 = 38973;   // int(0x7FFF * 1.18940)
constexpr int A2 = 69577;   // int(0x7FFF * 2.12340)
constexpr int M1 = 2 * A1;              // added where i2 < 0, into i1
constexpr int M12 = 2 * A1 + 2 * A2;    // added where i2 < 0, into i2
constexpr int LANES = 32;   // lanes per block (one warp)
constexpr int TILE = 32;    // samples per shared-memory tile

__device__ __forceinline__ int wadd(int a, int b) {
  return (int)((uint32_t)a + (uint32_t)b);
}

__device__ __forceinline__ int wsub(int a, int b) {
  return (int)((uint32_t)a - (uint32_t)b);
}

// One half-tick on the state (i0, i2, c = i1 + i0 - A1 - A2); returns
// the 16-bit word.
__device__ __forceinline__ int half_tick(int& i0, int& i2, int& c, int s) {
  const int i0n = wadd(i0, s) >> 1;
  c = wadd(c, wsub(i0n, i0));
  i0 = i0n;
  const int k0 = wsub(i0, A1);
  uint32_t neg = 0;           // bit 15 - k: i2 < 0 before step k
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    const int m = i2 >> 31;
    const int g = wsub(c, i2 >> 7);
    i2 = wadd(wadd(i2, g), m & M12);
    c = wadd(wadd(g, k0), m & M1);
    neg |= (uint32_t)m & (0x8000u >> k);
  }
  return (int)(~neg & 0xFFFFu);
}

__global__ void __launch_bounds__(LANES)
pdm_kernel(const int16_t* __restrict__ pcm, const int* __restrict__ st_in,
           int* __restrict__ words, int* __restrict__ st_out, int N, int S) {
  __shared__ int16_t s_in[LANES][TILE + 2];   // rows of 17 words
  __shared__ int s_out[LANES][2 * TILE + 1];
  const int j = threadIdx.x;
  const int lane0 = blockIdx.x * LANES;
  const int lane = lane0 + j;
  const bool live = lane < N;
  const int rows = min(LANES, N - lane0);
  int i0 = 0, i1 = 0, i2 = 0;
  if (live) {
    i0 = st_in[(size_t)lane * 3 + 0];
    i1 = st_in[(size_t)lane * 3 + 1];
    i2 = st_in[(size_t)lane * 3 + 2];
  }
  int c = wsub(wadd(i1, i0), A1 + A2);

  // nxt[r]: sample t0 + j of row r of the tile at t0, in flight while
  // the tile before it runs; rows past N and samples past S read the
  // last ones (never used)
  int16_t nxt[LANES];
  auto fetch = [&](int t0) {
    const int16_t* src = pcm + (size_t)lane0 * S + t0 + min(j, S - t0 - 1);
#pragma unroll
    for (int r = 0; r < LANES; ++r) nxt[r] = src[(size_t)min(r, rows - 1) * S];
  };
  fetch(0);
  for (int t0 = 0; t0 < S; t0 += TILE) {
    const int cnt = min(TILE, S - t0);
#pragma unroll
    for (int r = 0; r < LANES; ++r) s_in[r][j] = nxt[r];
    __syncwarp();
    if (t0 + TILE < S) fetch(t0 + TILE);
    if (live) {
      int s = s_in[j][0];
      for (int t = 0; t < cnt; ++t) {
        const int s2 = s * 2;
        s = s_in[j][min(t + 1, TILE - 1)];   // the next sample, ahead
        s_out[j][2 * t] = half_tick(i0, i2, c, s2);
        s_out[j][2 * t + 1] = half_tick(i0, i2, c, s2);
      }
    }
    __syncwarp();
    // store: row r's words [2 t0, 2 t0 + 2 cnt), two coalesced segments
#pragma unroll 8
    for (int r = 0; r < LANES; ++r) {
      const int a = s_out[r][j], b = s_out[r][j + LANES];
      if (r < rows) {
        int* dst = words + (size_t)(lane0 + r) * 2 * S + 2 * t0;
        if (j < 2 * cnt) dst[j] = a;
        if (j + LANES < 2 * cnt) dst[j + LANES] = b;
      }
    }
    __syncwarp();
  }
  if (live) {
    st_out[(size_t)lane * 3 + 0] = i0;
    st_out[(size_t)lane * 3 + 1] = wadd(wsub(c, i0), A1 + A2);
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
