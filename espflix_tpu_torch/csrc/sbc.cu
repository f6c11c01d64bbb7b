// K6 -- batched SBC decode (8 subbands, 16 blocks, mono or 2-channel),
// synthesis history carried.
//
// Replaces: no Pallas kernel.  The JAX package leaves this stage to XLA:
// espflix_tpu/models/sbc.py:136 decode_frames_batched, with its
// _synthesis_conv (:62) and ops/sbc_ops.py.  This kernel computes exactly
// what the port's plain form models/sbc.decode_frames_batched_torch
// computes (a copy of that function):
//
//   per (lane, frame): the header checks (sync 0x9C, 16 blocks, 8
//   subbands, mode != 3, header channels == CH); the scale-factor
//   nibbles, channel-major from byte 4; bit_allocation_batched per
//   channel with the full bitpool (at most 48 trips of the do-while, then
//   the two correction passes); the unpack in (block, channel, subband)
//   order -- the widths repeat in every block, so a field's offset is
//   base + blk * blockbits + prefix(ch, sb), the plain form's cumsum --
//   with extract_bits' edge rules; iquant_exact's two-step division;
//   frame_bits = base + 16 * blockbits for every frame;
//
//   per (lane, channel): V = (SYN_8 . samples) >> 15 for every block; the
//   valid frames compacted to the front in order; the 10-tap PROTO_8 sum
//   over the history h0 (flipped) followed by the compacted blocks, >> 15
//   and a clip to +-0x7FFF, written back to the frames' own slots
//   (invalid and padding frames write 0); the history tail from the last
//   valid frame's blocks 6-15, flipped (h0 kept when no frame is valid).
//
// A frame is valid when its header is good, it lies below n_valid and
// its lane is active; an inactive lane therefore keeps hist, emits zero
// PCM and reports no error.  Channel 1 of hist passes through in a mono
// call.  Every product and sum wraps as int32: they are done in uint32
// and cast back; shifts stay arithmetic on the signed values.  No float.
//
// What bounds it on an H100: neither bytes nor operations.  A lane's
// call moves ~7 KB (words, hist in and out, pcm, flags) and does ~4k
// integer operations a (frame, channel), so 1,024 lanes x 13 frames sit
// a few microseconds from either bound (chip_smoke.py computes both);
// one launch of one block a lane runs in a single wave, so the kernel
// takes about one block's critical path.  The plain form costs ~1,000
// small launches.  Design: one block of 128 threads per lane, four
// phases split by __syncthreads, every one spread over many threads:
//   (1) warp 0, a lane a frame: the header, the allocation, the
//   in-block offsets, frame_bits and the error flag; the valid frames
//   ranked by one ballot per 32 frames, and each valid frame's fields
//   (width, scale factor, offset in the block) written to its rank's
//   slot.  The allocation's do-while is a binary search: after trip t it
//   has handed out C(t) = sum over subbands of min(need - bitslice, 15)
//   + 1 bits (0 while need <= bitslice), which grows with t, and it
//   stops at the first t with C(t) >= bitpool, so six steps find that
//   trip in place of up to 48.  Warps 1-3 meanwhile stage IQUANT's
//   reciprocals and the history, flipped, ahead of the V timeline.
//   (2) a thread per field column (valid frame, channel, subband): its
//   width, scale factor and reciprocal once, then the 16 blocks' fields,
//   extract_bits and IQUANT, whose divisions by 2^level - 1 are
//   multiplications by the Granlund-Montgomery reciprocals of
//   ops/sbc_ops.iquant_reciprocals (__umulhi and a shift, exact for the
//   numerators' 30 bits).
//   (3) a thread per (row, V lane j), SYN_8's row j in registers: V =
//   (SYN_8 . samples) >> 15 written straight to the row's compacted
//   slot of the timeline [history | valid blocks].
//   (4) a thread per output sample in the output's own order (coalesced
//   int16 stores), PROTO_8's row in registers: the 10 taps at fixed
//   offsets below the sample's block in the timeline; then the history.
// Shared memory holds the timeline [10 + F*16][CH][16], the samples
// [F*16][CH][8] and the per-frame fields (21 KB mono at F = 13;
// dynamic, sized from F, opted in above 48 KB; models/sbc.shared_bytes
// counts the same ints).

#include <cstdint>
#include <cuda_runtime.h>

#include "resources.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int BLOCKS = 16;     // SBC blocks a frame
constexpr int SB = 8;          // subbands
constexpr int HIST = 10;       // V-history depth (past blocks)
constexpr int MAX_TRIPS = 48;  // bit_allocation_batched's max_iters
constexpr int SEARCH_STEPS = 6;  // 2^6 >= MAX_TRIPS
constexpr int LEVELS = 17;     // IQUANT levels 0..16
constexpr size_t SMEM_DEFAULT = 48 * 1024;
static_assert(BLOCKS == 16, "q >> 4 / & 15 split the block timeline");
static_assert((1 << SEARCH_STEPS) >= MAX_TRIPS, "binary search too short");

__device__ __forceinline__ int wadd(int a, int b) {
  return (int)((uint32_t)a + (uint32_t)b);
}

__device__ __forceinline__ int wmul(int a, int b) {
  return (int)((uint32_t)a * (uint32_t)b);
}

// the bits the allocation has handed out once the bit slice is at `top`:
// a subband whose need is k above it holds k + 1 bits up to 16 (2 at k
// = 1, one more each slice after), none while k <= 0
__device__ __forceinline__ int handed(const int (&need)[SB], int top) {
  int c = 0;
#pragma unroll
  for (int s = 0; s < SB; ++s) {
    const int k = need[s] - top;
    c += k > 0 ? min(k, 15) + 1 : 0;
  }
  return c;
}

// sbc_ops.bit_allocation_batched for one (frame, channel).
__device__ __forceinline__ void allocate(const int (&sf)[SB], int bitpool,
                                         const int* __restrict__ off,
                                         int allocation, int (&bits)[SB]) {
  int need[SB];
  int maxneed = -(1 << 30);
#pragma unroll
  for (int s = 0; s < SB; ++s) {
    int loud = sf[s] - __ldg(off + s);
    loud = loud > 0 ? loud >> 1 : loud;
    need[s] = allocation == 1 ? sf[s] : (sf[s] == 0 ? -5 : loud);
    maxneed = max(maxneed, need[s]);
  }
  // trip t of the plain form's do-while leaves bitslice = maxneed - t
  // and stops at the first t with handed(maxneed - t) >= bitpool, or
  // after trip MAX_TRIPS - 1: the search keeps that t in [lo, hi]
  int lo = 0, hi = MAX_TRIPS - 1;
#pragma unroll
  for (int step = 0; step < SEARCH_STEPS; ++step) {
    const int mid = (lo + hi) >> 1;
    const bool enough = handed(need, maxneed - mid) >= bitpool;
    if (lo < hi) {
      hi = enough ? mid : hi;
      lo = enough ? lo : mid + 1;
    }
  }
  int bitslice = maxneed - lo;
  // bitcount before the last trip's slice, and with it
  int bitcount = handed(need, bitslice + 1);
  const int total = handed(need, bitslice);
  if (total == bitpool) {
    bitcount = total;
    bitslice -= 1;
  }
#pragma unroll
  for (int s = 0; s < SB; ++s)
    bits[s] = need[s] < bitslice + 2 ? 0 : min(need[s] - bitslice, 16);
  // first correction pass (sequential over subbands, carries bitcount)
#pragma unroll
  for (int s = 0; s < SB; ++s) {
    const int b = bits[s];
    const bool can = bitcount < bitpool;
    const bool inc1 = can && b >= 2 && b < 16;
    const bool set2 = can && !inc1 && need[s] == bitslice + 1 &&
                      bitpool > bitcount + 1;
    bits[s] = inc1 ? b + 1 : (set2 ? 2 : b);
    bitcount += inc1 ? 1 : (set2 ? 2 : 0);
  }
  // second correction pass
#pragma unroll
  for (int s = 0; s < SB; ++s) {
    const int inc = bitcount < bitpool && bits[s] < 16;
    bits[s] += inc;
    bitcount += inc;
  }
}

// sbc_ops.extract_bits for one field of `width` bits (1..16) at bit
// `off`: the first word past the buffer reads 0, the second word's index
// clamps to W - 1, and off % 32 == 0 takes nothing from the second word.
__device__ __forceinline__ int extract(const int* __restrict__ wf, int W,
                                       int off, int width) {
  const int wi = off >> 5;
  const uint32_t w0 = wi < W ? (uint32_t)__ldg(wf + wi) : 0u;
  const uint32_t w1 = (uint32_t)__ldg(wf + min(wi + 1, W - 1));
  const uint32_t win = __funnelshift_l(w1, w0, off & 31);
  return (int)(win >> (32 - width));
}

// sbc_ops.iquant_exact: ((raw<<1|1) << scale) // (2^level - 1) -
// (1<<scale) in two steps.  Every operand is non-negative (raw < 2^16,
// level <= 16, scale <= 15, so a < 2^30 and every quotient < 2^18), so
// the floor division is C's.  a / d is __umulhi(a << 2, m) >> sh with
// level's reciprocal (m, sh), exact for a < 2^30 (sbc_ops.
// iquant_reciprocals); the second step's numerator is below 2^18.
__device__ __forceinline__ int iquant(int raw, int level, int scale,
                                      uint2 recip) {
  const uint32_t s = ((uint32_t)raw << 1) | 1u;
  const uint32_t d = (uint32_t)max((1 << level) - 1, 1);  // clamp(min=1)
  const int s1 = min(scale, 13), s2 = scale - s1;
  const uint32_t a = s << s1;
  const uint32_t q1 = __umulhi(a << 2, recip.x) >> recip.y;
  const uint32_t r1 = (a - q1 * d) << s2;
  const uint32_t q = (q1 << s2) + (__umulhi(r1 << 2, recip.x) >> recip.y);
  return (int)q - (1 << scale);
}

// the dynamic shared memory of one block, in ints (models/sbc.
// shared_bytes counts the same)
template <int CH>
__host__ __device__ constexpr size_t shared_ints(int F) {
  return (size_t)(HIST + F * BLOCKS) * CH * 16 + (size_t)F * BLOCKS * CH * SB +
         2 * LEVELS + (size_t)F * CH * SB + 3 * (size_t)F + 2;
}

template <int CH>
__global__ void __launch_bounds__(THREADS)
sbc_kernel(const int* __restrict__ words, const int* __restrict__ hist,
           const bool* __restrict__ active, const int* __restrict__ n_valid,
           const int* __restrict__ syn, const int* __restrict__ proto,
           const int* __restrict__ off8, const int* __restrict__ recip,
           int16_t* __restrict__ pcm, int* __restrict__ hist_out,
           bool* __restrict__ error, int* __restrict__ frame_bits, int F,
           int W) {
  extern __shared__ int4 smem4[];
  int* sV = reinterpret_cast<int*>(smem4);   // [HIST + F*16][CH][16]
  int* sSmp = sV + (HIST + F * BLOCKS) * CH * 16;  // [F*16][CH][8]
  uint2* sRecip = reinterpret_cast<uint2*>(sSmp + F * BLOCKS * CH * SB);
  int* sField = reinterpret_cast<int*>(sRecip + LEVELS);  // [F][CH][8]
  int* sBlockBits = sField + F * CH * SB;    // [F] by rank
  int* sComp = sBlockBits + F;               // [F] rank -> frame
  int* sRank = sComp + F;                    // [F] frame -> rank or -1
  int* sCount = sRank + F;                   // valid frames

  const int n = blockIdx.x;
  const int tid = threadIdx.x;
  const int* wl = words + (size_t)n * F * W;
  const int* hl = hist + (size_t)n * 2 * HIST * 16;
  constexpr int BASE = (4 + CH * 4) * 8;     // header + scale-factor bits

  if (tid < 32) {
    // 1. a lane a frame: header, allocation, offsets, frame_bits, error;
    // the valid frames ranked in order, their fields at their rank
    const bool act = active[n];
    const int nval = n_valid[n];
    int count = 0;
    for (int f0 = 0; f0 < F; f0 += 32) {
      const int f = f0 + tid;
      const bool in = f < F;
      const uint32_t w0 = in ? (uint32_t)__ldg(wl + (size_t)f * W) : 0u;
      const int b0 = w0 >> 24, b1 = (w0 >> 16) & 0xFF;
      const int bitpool = (w0 >> 8) & 0xFF;
      const int mode = (b1 >> 2) & 3;
      const bool bad = b0 != 0x9C || ((b1 >> 4) & 3) != 3 ||
                       (b1 & 1) != 1 || mode == 3 ||
                       (mode == 0 ? 1 : 2) != CH;
      const bool in_n = f < nval;
      const bool valid = in && !bad && in_n && act;
      const unsigned m = __ballot_sync(0xffffffffu, valid);
      const int k = count + __popc(m & ((1u << tid) - 1u));
      count += __popc(m);
      if (!in) continue;
      sRank[f] = valid ? k : -1;
      error[(size_t)n * F + f] = bad && in_n && act;
      int acc = 0;
#pragma unroll 1
      for (int ch = 0; ch < CH; ++ch) {
        // the channel's 8 nibbles are word 1 + ch, MSB first
        const uint32_t wsf = (uint32_t)__ldg(wl + (size_t)f * W + 1 + ch);
        int sf[SB], bits[SB];
#pragma unroll
        for (int s = 0; s < SB; ++s) sf[s] = (wsf >> (28 - 4 * s)) & 0xF;
        allocate(sf, bitpool, off8 + ((b1 >> 6) & 3) * SB, (b1 >> 1) & 1,
                 bits);
#pragma unroll
        for (int s = 0; s < SB; ++s) {
          if (valid)
            sField[(k * CH + ch) * SB + s] = bits[s] | sf[s] << 5 | acc << 9;
          acc += bits[s];
        }
      }
      if (valid) {
        sBlockBits[k] = acc;
        sComp[k] = f;
      }
      frame_bits[(size_t)n * F + f] = BASE + BLOCKS * acc;
    }
    if (tid == 0) *sCount = count;
  } else {
    // IQUANT's reciprocals, and the history flipped ahead of the
    // timeline: slot HIST - 1 - j holds h0 row j
    for (int i = tid - 32; i < LEVELS; i += THREADS - 32)
      sRecip[i] =
          make_uint2((uint32_t)recip[2 * i], (uint32_t)recip[2 * i + 1]);
    for (int i = tid - 32; i < CH * HIST * 16; i += THREADS - 32) {
      const int ch = i / (HIST * 16), j = (i >> 4) % HIST, col = i & 15;
      sV[((HIST - 1 - j) * CH + ch) * 16 + col] = hl[i];
    }
  }
  __syncthreads();

  // 2. a thread per field column (rank k, channel ch, subband s): its
  // width, scale factor and reciprocal read once, then the field of
  // each of the 16 blocks, a block's bits apart -- extract_bits and
  // IQUANT -- into samples row q = (k * 16 + blk) * CH + ch
  const int nv = *sCount;
  const int rows = nv * BLOCKS * CH;
  for (int c = tid; c < nv * CH * SB; c += THREADS) {
    const int k = c / (CH * SB), ch = (c / SB) % CH, s = c % SB;
    const int fld = sField[c];
    const int width = fld & 31, scale = (fld >> 5) & 15;
    const int* wf = wl + (size_t)sComp[k] * W;
    const int bb = sBlockBits[k];
    const uint2 recip_w = sRecip[width];
    int* out = sSmp + (k * BLOCKS * CH + ch) * SB + s;
    int off = BASE + (fld >> 9);
#pragma unroll 4
    for (int blk = 0; blk < BLOCKS; ++blk, off += bb)
      out[blk * CH * SB] =
          width > 0 ? iquant(extract(wf, W, off, width), width, scale,
                             recip_w)
                    : 0;
  }
  __syncthreads();

  // 3. V = (SYN_8 . samples) >> 15, a thread per (row q, V lane j), into
  // the timeline's slot HIST * CH + q
  {
    const int j = tid & 15;
    int syn_j[SB];
#pragma unroll
    for (int s = 0; s < SB; ++s) syn_j[s] = __ldg(syn + j * SB + s);
    const int4* smp4 = reinterpret_cast<const int4*>(sSmp);
    for (int q = tid >> 4; q < rows; q += THREADS / 16) {
      const int4 a = smp4[2 * q], b = smp4[2 * q + 1];
      int acc = wmul(a.x, syn_j[0]);
      acc = wadd(acc, wmul(a.y, syn_j[1]));
      acc = wadd(acc, wmul(a.z, syn_j[2]));
      acc = wadd(acc, wmul(a.w, syn_j[3]));
      acc = wadd(acc, wmul(b.x, syn_j[4]));
      acc = wadd(acc, wmul(b.y, syn_j[5]));
      acc = wadd(acc, wmul(b.z, syn_j[6]));
      acc = wadd(acc, wmul(b.w, syn_j[7]));
      sV[(HIST * CH + q) * 16 + j] = acc >> 15;
    }
  }
  __syncthreads();

  // 4a. synthesis, a thread per output sample o = ((f * CH + ch) * 16 +
  // blk) * 8 + sb (the pcm layout): compacted block t = rank * 16 + blk
  // reads timeline slots HIST + t - d, d = 0..9, even d columns 0-7, odd
  // d columns 8-15
  constexpr int PER_FRAME = CH * BLOCKS * SB;
  const int sb = tid & 7;
  int taps[HIST];
#pragma unroll
  for (int d = 0; d < HIST; ++d) taps[d] = __ldg(proto + sb * HIST + d);
  int16_t* pl = pcm + (size_t)n * F * PER_FRAME;
  for (int o = tid; o < F * PER_FRAME; o += THREADS) {
    const int k = sRank[o / PER_FRAME];
    int out = 0;
    if (k >= 0) {
      const int ch = (o / (BLOCKS * SB)) % CH, blk = (o >> 3) & 15;
      const int* p = sV + ((HIST + k * BLOCKS + blk) * CH + ch) * 16 + sb;
      int acc = 0;
#pragma unroll
      for (int d = 0; d < HIST; ++d)
        acc = wadd(acc, wmul(p[(d & 1) * 8 - d * CH * 16], taps[d]));
      out = min(max(acc >> 15, -0x7FFF), 0x7FFF);
    }
    pl[o] = (int16_t)out;
  }

  // 4b. history: the last valid frame's blocks 15..6, else hist as given
  int* ho = hist_out + (size_t)n * 2 * HIST * 16;
  for (int i = tid; i < 2 * HIST * 16; i += THREADS) {
    const int ch = i / (HIST * 16), j = (i >> 4) % HIST, col = i & 15;
    ho[i] = ch < CH && nv > 0
                ? sV[((HIST + nv * BLOCKS - 1 - j) * CH + ch) * 16 + col]
                : hl[i];
  }
}

template <int CH>
int launch(const void* words, const void* hist, const void* active,
           const void* n_valid, const void* syn, const void* proto,
           const void* off8, const void* recip, void* pcm, void* hist_out,
           void* error, void* frame_bits, int N, int F, int W,
           cudaStream_t stream) {
  const size_t smem = sizeof(int) * shared_ints<CH>(F);
  if (smem > SMEM_DEFAULT) {
    const cudaError_t e = cudaFuncSetAttribute(
        sbc_kernel<CH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  sbc_kernel<CH><<<N, THREADS, smem, stream>>>(
      (const int*)words, (const int*)hist, (const bool*)active,
      (const int*)n_valid, (const int*)syn, (const int*)proto,
      (const int*)off8, (const int*)recip, (int16_t*)pcm, (int*)hist_out,
      (bool*)error, (int*)frame_bits, F, W);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int esp_sbc_decode(const void* words, const void* hist,
                              const void* active, const void* n_valid,
                              const void* syn, const void* proto,
                              const void* off8, const void* recip,
                              void* pcm, void* hist_out, void* error,
                              void* frame_bits, int N, int F, int W, int CH,
                              void* stream) {
  if (N <= 0 || F <= 0) return (int)cudaGetLastError();
  if ((CH != 1 && CH != 2) || W < CH + 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  return CH == 1 ? launch<1>(words, hist, active, n_valid, syn, proto, off8,
                             recip, pcm, hist_out, error, frame_bits, N, F,
                             W, s)
                 : launch<2>(words, hist, active, n_valid, syn, proto, off8,
                             recip, pcm, hist_out, error, frame_bits, N, F,
                             W, s);
}

// K6's registers, local and static shared bytes and largest block on
// the current device (resources.cuh).
extern "C" int esp_sbc_resources(int* out, const char** names, int cap) {
  const void* fns[] = {(const void*)sbc_kernel<1>,
                       (const void*)sbc_kernel<2>};
  const char* kernel_names[] = {"sbc_kernel<1>", "sbc_kernel<2>"};
  return kernel_resources(fns, kernel_names, 2, out, names, cap);
}
