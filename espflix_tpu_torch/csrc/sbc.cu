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
// a few microseconds from either bound (chip_smoke.py computes both).
// The plain form costs ~1,000 small launches; here one launch does all
// of it.  Design: one block of 128 threads per lane, the lane's V blocks
// [F][16][CH][16] int32 in shared memory (13 KB mono at F = 13; dynamic,
// sized from F, opted in above 48 KB), phases separated by
// __syncthreads: (1) header and allocation, a thread per (frame,
// channel); (2) per frame the in-block offsets, frame_bits, error and
// validity; (3) warp 0 ranks the valid frames with a ballot per 32
// frames, and every thread unpacks one (frame, block, channel) row --
// eight fields and IQUANT in registers -- and writes its 16 V values;
// (4) the synthesis, a thread per output sample in the output's own
// order (coalesced int16 stores), and the history.  SYN_8, PROTO_8 and
// OFFSET_8 come in as device pointers and are staged in shared memory.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;
constexpr int BLOCKS = 16;     // SBC blocks a frame
constexpr int SB = 8;          // subbands
constexpr int HIST = 10;       // V-history depth (past blocks)
constexpr int MAX_TRIPS = 48;  // bit_allocation_batched's max_iters
constexpr size_t SMEM_DEFAULT = 48 * 1024;
static_assert(BLOCKS == 16, "t >> 4 / t & 15 split the block timeline");

__device__ __forceinline__ int wadd(int a, int b) {
  return (int)((uint32_t)a + (uint32_t)b);
}

__device__ __forceinline__ int wmul(int a, int b) {
  return (int)((uint32_t)a * (uint32_t)b);
}

// sbc_ops.bit_allocation_batched for one (frame, channel).
__device__ void allocate(const int (&sf)[SB], int bitpool, const int* off,
                         int allocation, int (&bits)[SB]) {
  int need[SB];
  int maxneed = INT_MIN;
#pragma unroll
  for (int s = 0; s < SB; ++s) {
    int loud = sf[s] - off[s];
    loud = loud > 0 ? loud >> 1 : loud;
    need[s] = allocation == 1 ? sf[s] : (sf[s] == 0 ? -5 : loud);
    maxneed = max(maxneed, need[s]);
  }
  int bitslice = maxneed + 1, bitcount = 0, slicecount = 0;
  // the plain form's 48 masked trips: once done, a trip changes nothing
  for (int it = 0; it < MAX_TRIPS; ++it) {
    bitslice -= 1;
    bitcount += slicecount;
    slicecount = 0;
#pragma unroll
    for (int s = 0; s < SB; ++s) {
      slicecount += (need[s] > bitslice + 1 && need[s] < bitslice + 16);
      slicecount += need[s] == bitslice + 1 ? 2 : 0;
    }
    if (bitcount + slicecount >= bitpool) break;
  }
  if (bitcount + slicecount == bitpool) {
    bitcount += slicecount;
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

// sbc_ops.extract_bits for one field of `width` > 0 bits at bit `off`:
// the first word past the buffer reads 0, the second word's index clamps
// to W - 1, and off % 32 == 0 takes nothing from the second word.
__device__ __forceinline__ int extract(const int* __restrict__ wf, int W,
                                       int off, int width) {
  const int wi = off >> 5;
  const int o = off & 31;
  const uint32_t w0 = wi < W ? (uint32_t)__ldg(wf + wi) : 0u;
  const uint32_t w1 = (uint32_t)__ldg(wf + min(wi + 1, W - 1));
  const uint32_t win = (w0 << o) | (o == 0 ? 0u : w1 >> (32 - o));
  return (int)(win >> min(max(32 - width, 0), 31));
}

// sbc_ops.iquant_exact: ((raw<<1|1) << scale) // (2^level - 1) -
// (1<<scale) in two steps.  Every operand is non-negative (raw < 2^16,
// level <= 16, scale <= 15, so a < 2^30 and every quotient < 2^18), so
// C's truncating division here is the plain form's floor division.
__device__ __forceinline__ int iquant(int raw, int level, int scale) {
  const uint32_t s = ((uint32_t)raw << 1) | 1u;
  const uint32_t d = (uint32_t)max((1 << level) - 1, 1);  // clamp(min=1)
  const int s1 = min(scale, 13), s2 = scale - s1;
  const uint32_t a = s << s1;
  const uint32_t q1 = a / d;
  const uint32_t r1 = a - q1 * d;
  const uint32_t q = (q1 << s2) + (r1 << s2) / d;
  return (int)q - (1 << scale);
}

template <int CH>
__global__ void __launch_bounds__(THREADS)
sbc_kernel(const int* __restrict__ words, const int* __restrict__ hist,
           const bool* __restrict__ active, const int* __restrict__ n_valid,
           const int* __restrict__ syn, const int* __restrict__ proto,
           const int* __restrict__ off8, int16_t* __restrict__ pcm,
           int* __restrict__ hist_out, bool* __restrict__ error,
           int* __restrict__ frame_bits, int F, int W) {
  // layout: models/sbc.shared_bytes counts the same ints
  extern __shared__ int smem[];
  int* sV = smem;                            // [F][16][CH][16]
  int* sBits = sV + F * BLOCKS * CH * 16;    // [F][CH][8]
  int* sSf = sBits + F * CH * SB;            // [F][CH][8]
  int* sPre = sSf + F * CH * SB;             // [F][CH][8] offset in a block
  int* sBlockBits = sPre + F * CH * SB;      // [F]
  int* sValid = sBlockBits + F;              // [F]
  int* sRank = sValid + F;                   // [F] compacted index or -1
  int* sComp = sRank + F;                    // [F] compacted index -> frame
  int* sH0 = sComp + F;                      // [CH][10][16]
  int* sSyn = sH0 + CH * HIST * 16;          // [16][8]
  int* sProto = sSyn + 16 * SB;              // [8][10]
  int* sOff = sProto + SB * HIST;            // [4][8]
  int* sMisc = sOff + 4 * SB;                // valid count, last valid frame

  const int n = blockIdx.x;
  const int tid = threadIdx.x;
  const bool act = active[n];
  const int nval = n_valid[n];
  const int* wl = words + (size_t)n * F * W;
  const int* hl = hist + (size_t)n * 2 * HIST * 16;
  const int base = (4 + CH * 4) * 8;         // header + scale-factor bits

  for (int i = tid; i < 16 * SB; i += THREADS) sSyn[i] = syn[i];
  for (int i = tid; i < SB * HIST; i += THREADS) sProto[i] = proto[i];
  for (int i = tid; i < 4 * SB; i += THREADS) sOff[i] = off8[i];
  for (int i = tid; i < CH * HIST * 16; i += THREADS) sH0[i] = hl[i];
  __syncthreads();

  // 1. scale factors and allocation, a thread per (frame, channel); the
  // channel's 8 nibbles are word 1 + ch, MSB first (W >= CH + 1)
  for (int i = tid; i < F * CH; i += THREADS) {
    const int f = i / CH, ch = i % CH;
    const uint32_t w0 = (uint32_t)wl[f * W];
    const uint32_t wsf = (uint32_t)wl[f * W + 1 + ch];
    const int b1 = (w0 >> 16) & 0xFF;
    const int bitpool = (w0 >> 8) & 0xFF;
    int sf[SB], bits[SB];
#pragma unroll
    for (int s = 0; s < SB; ++s) sf[s] = (wsf >> (28 - 4 * s)) & 0xF;
    allocate(sf, bitpool, sOff + ((b1 >> 6) & 3) * SB, (b1 >> 1) & 1, bits);
#pragma unroll
    for (int s = 0; s < SB; ++s) {
      sBits[i * SB + s] = bits[s];
      sSf[i * SB + s] = sf[s];
    }
  }
  __syncthreads();

  // 2. per frame: field offsets within a block, frame_bits, error flag
  // and validity
  for (int f = tid; f < F; f += THREADS) {
    int acc = 0;
    for (int k = 0; k < CH * SB; ++k) {
      sPre[f * CH * SB + k] = acc;
      acc += sBits[f * CH * SB + k];
    }
    sBlockBits[f] = acc;
    frame_bits[(size_t)n * F + f] = base + BLOCKS * acc;
    const uint32_t w0 = (uint32_t)wl[f * W];
    const int b0 = w0 >> 24, b1 = (w0 >> 16) & 0xFF;
    const int mode = (b1 >> 2) & 3;
    const bool bad = b0 != 0x9C || ((b1 >> 4) & 3) != 3 || (b1 & 1) != 1 ||
                     mode == 3 || (mode == 0 ? 1 : 2) != CH;
    const bool in_n = f < nval;
    error[(size_t)n * F + f] = bad && in_n && act;
    sValid[f] = !bad && in_n && act;
  }
  __syncthreads();

  // 3a. warp 0: stable valid-first compaction, 32 frames a ballot
  if (tid < 32) {
    int count = 0;
    for (int f0 = 0; f0 < F; f0 += 32) {
      const int f = f0 + tid;
      const bool v = f < F && sValid[f];
      const unsigned m = __ballot_sync(0xffffffffu, v);
      const int k = count + __popc(m & ((1u << tid) - 1u));
      if (f < F) sRank[f] = v ? k : -1;
      if (v) sComp[k] = f;
      count += __popc(m);
    }
    __syncwarp();
    if (tid == 0) {
      sMisc[0] = count;
      sMisc[1] = count ? sComp[count - 1] : 0;
    }
  }
  // 3b. unpack + IQUANT + V, a thread per valid (frame, block, channel)
  // row r = (f * 16 + blk) * CH + ch
  for (int r = tid; r < F * BLOCKS * CH; r += THREADS) {
    const int f = r / (BLOCKS * CH);
    if (!sValid[f]) continue;
    const int blk = (r / CH) % BLOCKS, ch = r % CH;
    const int fc = (f * CH + ch) * SB;
    const int* wf = wl + f * W;
    const int off0 = base + blk * sBlockBits[f];
    int smp[SB];
#pragma unroll
    for (int s = 0; s < SB; ++s) {
      const int width = sBits[fc + s];
      smp[s] = width > 0 ? iquant(extract(wf, W, off0 + sPre[fc + s], width),
                                  width, sSf[fc + s])
                         : 0;
    }
    int* v = sV + r * 16;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      int acc = 0;
#pragma unroll
      for (int s = 0; s < SB; ++s)
        acc = wadd(acc, wmul(smp[s], sSyn[j * SB + s]));
      v[j] = acc >> 15;
    }
  }
  __syncthreads();

  // 4a. synthesis, a thread per output sample o = ((f * CH + ch) * 16 +
  // blk) * 8 + sb (the pcm layout); compacted block t = rank * 16 + blk
  // reads taps t - d, d = 0..9: even d columns 0-7, odd d columns 8-15,
  // h0[-(t - d) - 1] before the first compacted block
  const int nv = sMisc[0];
  constexpr int PER_FRAME = CH * BLOCKS * SB;
  int16_t* pl = pcm + (size_t)n * F * PER_FRAME;
  for (int o = tid; o < F * PER_FRAME; o += THREADS) {
    const int k = sRank[o / PER_FRAME];
    int out = 0;
    if (k >= 0) {
      const int ch = (o / (BLOCKS * SB)) % CH;
      const int blk = (o / SB) % BLOCKS, sb = o % SB;
      const int t = k * BLOCKS + blk;
      int acc = 0;
#pragma unroll
      for (int d = 0; d < HIST; ++d) {
        const int tt = t - d;
        const int col = (d & 1) * 8 + sb;
        const int v =
            tt >= 0
                ? sV[((sComp[tt >> 4] * BLOCKS + (tt & 15)) * CH + ch) * 16 +
                     col]
                : sH0[(ch * HIST + (-tt - 1)) * 16 + col];
        acc = wadd(acc, wmul(v, sProto[sb * HIST + d]));
      }
      out = min(max(acc >> 15, -0x7FFF), 0x7FFF);
    }
    pl[o] = (int16_t)out;
  }

  // 4b. history: the last valid frame's blocks 15..6, else hist as given
  const int lastf = sMisc[1];
  int* ho = hist_out + (size_t)n * 2 * HIST * 16;
  for (int i = tid; i < 2 * HIST * 16; i += THREADS) {
    const int ch = i / (HIST * 16), j = (i / 16) % HIST, col = i % 16;
    int v = hl[i];
    if (ch < CH && nv > 0)
      v = sV[((lastf * BLOCKS + (BLOCKS - 1 - j)) * CH + ch) * 16 + col];
    ho[i] = v;
  }
}

template <int CH>
int launch(const void* words, const void* hist, const void* active,
           const void* n_valid, const void* syn, const void* proto,
           const void* off8, void* pcm, void* hist_out, void* error,
           void* frame_bits, int N, int F, int W, cudaStream_t stream) {
  const size_t smem =
      sizeof(int) * ((size_t)F * BLOCKS * CH * 16 + 3 * (size_t)F * CH * SB +
                     4 * (size_t)F + CH * HIST * 16 + 16 * SB + SB * HIST +
                     4 * SB + 4);
  if (smem > SMEM_DEFAULT) {
    const cudaError_t e = cudaFuncSetAttribute(
        sbc_kernel<CH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  sbc_kernel<CH><<<N, THREADS, smem, stream>>>(
      (const int*)words, (const int*)hist, (const bool*)active,
      (const int*)n_valid, (const int*)syn, (const int*)proto,
      (const int*)off8, (int16_t*)pcm, (int*)hist_out, (bool*)error,
      (int*)frame_bits, F, W);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int esp_sbc_decode(const void* words, const void* hist,
                              const void* active, const void* n_valid,
                              const void* syn, const void* proto,
                              const void* off8, void* pcm, void* hist_out,
                              void* error, void* frame_bits, int N, int F,
                              int W, int CH, void* stream) {
  if (N <= 0 || F <= 0) return (int)cudaGetLastError();
  if ((CH != 1 && CH != 2) || W < CH + 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  return CH == 1 ? launch<1>(words, hist, active, n_valid, syn, proto, off8,
                             pcm, hist_out, error, frame_bits, N, F, W, s)
                 : launch<2>(words, hist, active, n_valid, syn, proto, off8,
                             pcm, hist_out, error, frame_bits, N, F, W, s);
}
