// Cycles of one K5 (csrc/pdm.cu) bit step, for variants of the step, and
// the latency of one dependent integer operation of a few kinds.  Built
// and run by tools/pdm_steps.py; not part of the kernel library.
//
// Every variant runs one warp (32 lanes, one per thread) over S samples
// drawn from a per-lane LCG (two half-ticks of 16 bit steps a sample, as
// K5), brackets the loop with clock64(), and writes its final state and a
// checksum of its words, so that the variants can be held equal to each
// other.  The chains run one dependent operation n times.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int A1 = 38973;
constexpr int A2 = 69577;
constexpr int M1 = 2 * A1;
constexpr int M12 = 2 * A1 + 2 * A2;

__device__ __forceinline__ int wadd(int a, int b) {
  return (int)((uint32_t)a + (uint32_t)b);
}
__device__ __forceinline__ int wsub(int a, int b) {
  return (int)((uint32_t)a - (uint32_t)b);
}

// K5's first form: the sign as a predicate, i1 then i2
struct Pred {
  int i0, i1, i2;
  __device__ void init(int a, int b, int c) { i0 = a; i1 = b; i2 = c; }
  __device__ void fini(int* o) { o[0] = i0; o[1] = i1; o[2] = i2; }
  __device__ __forceinline__ int half(int s) {
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
};

// the mask step with c = i1 + i0 - A1 - A2 carried in place of i1; the
// word from the masks by `Word`
template <int Word>
struct Mask {
  int i0, i2, c;
  __device__ void init(int a, int b, int d) {
    i0 = a; i2 = d; c = wsub(wadd(b, a), A1 + A2);
  }
  __device__ void fini(int* o) {
    o[0] = i0; o[1] = wadd(wsub(c, i0), A1 + A2); o[2] = i2;
  }
  __device__ __forceinline__ int half(int s) {
    const int i0n = wadd(i0, s) >> 1;
    c = wadd(c, wsub(i0n, i0));
    i0 = i0n;
    const int k0 = wsub(i0, A1);
    uint32_t neg = 0;
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      const int m = i2 >> 31;
      const int g = wsub(c, i2 >> 7);
      i2 = wadd(wadd(i2, g), m & M12);
      c = wadd(wadd(g, k0), m & M1);
      if (Word == 0)
        neg = (neg << 1) - (uint32_t)m;          // shift in the sign
      else
        neg |= (uint32_t)m & (0x8000u >> k);     // one LOP3 a step
    }
    return (int)(~neg & 0xFFFFu);
  }
};

// the sign as 0 / 1 times a constant (IMAD) in place of the mask's AND
struct Imad {
  int i0, i2, c;
  __device__ void init(int a, int b, int d) {
    i0 = a; i2 = d; c = wsub(wadd(b, a), A1 + A2);
  }
  __device__ void fini(int* o) {
    o[0] = i0; o[1] = wadd(wsub(c, i0), A1 + A2); o[2] = i2;
  }
  __device__ __forceinline__ int half(int s) {
    const int i0n = wadd(i0, s) >> 1;
    c = wadd(c, wsub(i0n, i0));
    i0 = i0n;
    const int k0 = wsub(i0, A1);
    uint32_t neg = 0;
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      const uint32_t u = (uint32_t)i2 >> 31;
      const int sh = i2 >> 7;
      i2 = (int)((uint32_t)wadd(wsub(i2, sh), c) + u * (uint32_t)M12);
      c = (int)((uint32_t)wadd(wsub(c, sh), k0) + u * (uint32_t)M1);
      neg |= u << (15 - k);
    }
    return (int)(~neg & 0xFFFFu);
  }
};

__device__ __forceinline__ int mad(int a, int b, int c) {
  int d;
  asm("mad.lo.s32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

// the mask step with the c update and the word as multiply-adds (the
// FMA pipe) in place of ANDs and ORs (the ALU pipe): m * -K = K & m
struct Fma {
  int i0, i2, c;
  __device__ void init(int a, int b, int d) {
    i0 = a; i2 = d; c = wsub(wadd(b, a), A1 + A2);
  }
  __device__ void fini(int* o) {
    o[0] = i0; o[1] = wadd(wsub(c, i0), A1 + A2); o[2] = i2;
  }
  __device__ __forceinline__ int half(int s) {
    const int i0n = wadd(i0, s) >> 1;
    c = wadd(c, wsub(i0n, i0));
    i0 = i0n;
    const int k0 = wsub(i0, A1);
    int neg = 0;
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      const int m = i2 >> 31;
      const int g = wsub(c, i2 >> 7);
      i2 = wadd(wadd(i2, g), m & M12);
      c = wadd(g, mad(m, -M1, k0));
      neg = mad(m, -(0x8000 >> k), neg);
    }
    return ~neg & 0xFFFF;
  }
};

template <class V>
__global__ void steps_kernel(const int* __restrict__ st, int S,
                             int* __restrict__ st_out,
                             unsigned* __restrict__ sums,
                             long long* __restrict__ cycles,
                             unsigned long long* __restrict__ ns) {
  const int j = threadIdx.x;
  V v;
  v.init(st[3 * j], st[3 * j + 1], st[3 * j + 2]);
  uint32_t x = 12345u + 7919u * (uint32_t)j;
  unsigned sum = 0;
  __syncwarp();
  unsigned long long g0;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g0));
  const long long t0 = clock64();
  for (int t = 0; t < S; ++t) {
    x = x * 1664525u + 1013904223u;
    const int s = ((int)(x >> 16) - 32768) * 2;
    sum += (unsigned)v.half(s);
    sum += 3u * (unsigned)v.half(s);
  }
  const long long t1 = clock64();
  unsigned long long g1;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g1));
  v.fini(st_out + 3 * j);
  sums[j] = sum;
  if (j == 0) {
    cycles[0] = t1 - t0;
    ns[0] = g1 - g0;
  }
}

// n dependent operations of one kind; a, b come from the caller so that
// nothing folds
template <int Op>
__global__ void chain_kernel(int n, int a, int b, int* __restrict__ out,
                             long long* __restrict__ cycles) {
  int x = a + (int)threadIdx.x;
  const long long t0 = clock64();
#pragma unroll 16
  for (int i = 0; i < n; ++i) {
    if (Op == 0) x = (x ^ a) + b;                      // LOP3, IADD3
    if (Op == 1) x = x ^ (x >> 7);                     // SHF, LOP3
    if (Op == 2) x = (x >> 3) + b;                     // one LEA.HI
    if (Op == 3) x = x * a + b;                        // IMAD
    if (Op == 4) x = (x >> (a & 31)) ^ (x << (b & 31));  // shifts by regs
  }
  const long long t1 = clock64();
  out[threadIdx.x] = x;
  if (threadIdx.x == 0) cycles[0] = t1 - t0;
}

template <class V>
int run_steps(const int* st, int S, int* st_out, unsigned* sums,
              long long* cycles, unsigned long long* ns) {
  steps_kernel<V><<<1, 32>>>(st, S, st_out, sums, cycles, ns);
  return (int)cudaGetLastError();
}

}  // namespace

// variant: 0 Pred, 1 Mask (neg accumulated), 2 Mask (word by LOP3), 3
// Imad, 4 Fma
extern "C" int pdm_steps(int variant, const void* st, int S, void* st_out,
                         void* sums, void* cycles, void* ns) {
  const int* a = (const int*)st;
  int* o = (int*)st_out;
  unsigned* u = (unsigned*)sums;
  long long* c = (long long*)cycles;
  unsigned long long* g = (unsigned long long*)ns;
  switch (variant) {
    case 0: return run_steps<Pred>(a, S, o, u, c, g);
    case 1: return run_steps<Mask<0>>(a, S, o, u, c, g);
    case 2: return run_steps<Mask<1>>(a, S, o, u, c, g);
    case 3: return run_steps<Imad>(a, S, o, u, c, g);
    case 4: return run_steps<Fma>(a, S, o, u, c, g);
  }
  return (int)cudaErrorInvalidValue;
}

// op: 0 xor then add, 1 shift then xor, 2 shift + add, 3 IMAD, 4 shifts
// by registers
extern "C" int op_chain(int op, int n, int a, int b, void* out,
                        void* cycles) {
  int* o = (int*)out;
  long long* c = (long long*)cycles;
  switch (op) {
    case 0: chain_kernel<0><<<1, 32>>>(n, a, b, o, c); break;
    case 1: chain_kernel<1><<<1, 32>>>(n, a, b, o, c); break;
    case 2: chain_kernel<2><<<1, 32>>>(n, a, b, o, c); break;
    case 3: chain_kernel<3><<<1, 32>>>(n, a, b, o, c); break;
    case 4: chain_kernel<4><<<1, 32>>>(n, a, b, o, c); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
