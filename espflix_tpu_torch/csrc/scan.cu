// K1 -- MPEG-1 slice scan straight into the dense decode buffers.
//
// Replaces: espflix_tpu/ops/vlc_scan_pallas.py _make_kernel -> kernel
// (the lockstep slice FSM, launched by run_scan_pallas_bucketed_dense)
// and absorbs the densify that followed it on the TPU
// (espflix_tpu/ops/scan_dense.py log_to_dense_rows + assemble_dense_T).
//
// What bounds the scan kernels on an H100: a serial dependency chain per
// scan row -- take a 32-bit window, one table load, about ten integer
// ops, the next bit position -- about 1k steps for an I-picture slice.
// The TPU ran the FSM lockstep over all rows with masks (no program
// counter per lane) and wrote an emission log that one-hot matmuls
// densified.  Here each scan row is one thread with its own program
// counter: it runs only its own state's code, stops at ST_DONE, and
// stores every emission straight into the output buffers, so neither the
// [T, rows] log nor the densify exists.  The design keeps every step's
// chain short:
//
//   * the bit reader (BitReader) holds 64 bits of the row in registers
//     and the next word in flight, so a step takes its window with
//     shifts; a word load is issued once per 32 bits consumed, a few
//     steps before it is needed;
//   * the VLC tables live in shared memory (57 KB of dynamic shared
//     memory a block): the unified LUT's two 131,072-entry DCT sections
//     become two-level tables (a 9-bit first level whose 16 long-code
//     slots point at 256-entry second levels; ops/vlc_scan.compact_lut
//     gathers it on the card from the wrapper's unified LUT, and CPU
//     tests expand it back to the unified LUT), so
//     a step's table load is a shared load, not an L2 trip into a 1 MB
//     table;
//   * a step makes its one table load before it branches on the FSM
//     state (see scan_row);
//   * stores are fire-and-forget: no emission reads device memory back
//     on the chain (K1's adds below read back only where a slot can be
//     emitted twice).
//
// What remains is the latency of one thread's step, a few hundred
// cycles of dependent instructions and branches that no other warp
// hides (~12k rows for the card's 528 warp schedulers), multiplied in a
// warp by the states its rows sit in.  Neither the table nor the word
// loads nor the stores set it any more (PERF.md).
//
// Semantics (pinned by tests/test_torch_scan.py against the JAX
// package): make_scan_step (vlc_scan.py:279-660) with single-slice
// rows; a row's budget is budget_long for rows < long_rows, else
// budget_short (already rounded to whole chunks); the densify rules of
// ops/scan_dense.py -- an emission outside the row's MB row is dropped
// and errors the lane, only the row that perm selects for its (lane,
// MB row) writes, emissions into one slot add up (int16-wrapping
// coefficients, int32 nfinal, byte-quarter sums for records, stored as
// lo16 | hi15 << 16).  See DenseSink for how K1 keeps those sums with
// no per-thread array.
//
// K1F (esp_scan_flat) -- the same FSM device code (scan_row) with the
// lane-minor stores of run_scan_pallas_bucketed / _sliced
// (vlc_scan_pallas.py:450-557, their _scatter): each emission is SET at
// coeffs[lane, mb*384 + blk*64 + pos], recs[lane, mb] and nfinal[lane,
// mb*6 + blk]; a lane errors when one of its rows ends in an FSM error
// or not in ST_DONE.  It replaces the same Pallas kernel (_make_kernel)
// and the [T, rows] log + put_along_axis that followed it.  No int32
// scratch: the three outputs are written directly (about 208 MB of
// int16 coefficients at 1,024 lanes of 352x192, which bounds it by
// bytes only if the FSM's chain did not).  Two rows that claim one
// slot race (the JAX scatter's order is unspecified there too).
//
// K1S (esp_scan_slices + esp_scan_seq) -- the device parser's
// sequential scan, split at slice starts.  It has no Pallas counterpart:
// the JAX package runs this scan in XLA (vlc_scan.run_scan, a while loop
// over make_scan_step with a [T, N] log and one bulk scatter after it).
// One thread per lane walking its picture's slices was a chain of ~8,600
// steps on 1,024 threads; but slices are independent decode units (a
// slice header resets qscale and the DC and motion predictors), so pass
// A (scan_slices_kernel) gives every (lane, slice) a thread and reports
// each slice's steps, how it ended and the MB range it emitted into, and
// pass B (scan_seq_kernel) rebuilds each lane's sequential budget and
// flags from those reports and re-runs in order only the lanes the split
// cannot reproduce (a slice cut or never entered, or two slices writing
// one MB).  Its chain is then the longest slice's, ~800 steps.

#include <cstdint>
#include <cuda_runtime.h>

#include "resources.cuh"

namespace {

enum {
  ST_DONE = 0, ST_SLICE_HDR = 1, ST_EXTRA = 2, ST_MBADDR = 3, ST_SKIP = 4,
  ST_MBTYPE = 5, ST_MVH = 6, ST_MVV = 7, ST_CBP = 8, ST_DC = 9,
  ST_COEF = 10
};
enum { K_INVALID = 0, K_COEFF = 1, K_EOB = 2, K_ESCAPE = 3 };
enum { MB_SKIP = 1, MB_INTER = 2, MB_INTRA = 3 };
enum { MBT_QUANT = 0x10, MBT_MOTION_F = 0x08, MBT_PATTERN = 0x02,
       MBT_INTRA = 0x01 };
enum { MB_STUFFING = 34, MB_ESCAPE = 35 };
// compact LUT section offsets (ops/vlc_scan.py COMPACT_BASES): the
// unified LUT's non-DCT sections as they are, then the two DCT first
// levels (512 entries each, indexed by the top 9 bits of the 17-bit
// peek), then the 256-entry second levels that flagged entries point at
enum {
  L_MBADDR = 0, L_MBTYPE_I = 2048, L_MBTYPE_P = 2112, L_CBP = 2176,
  L_MOTION = 2688, L_DC_LUM = 4736, L_DC_CHROM = 4992,
  L_DCT_FIRST = 5248, L_DCT_NEXT = 5248 + 512
};
constexpr int LUT_L2 = 1 << 30;        // first-level entry: go to level 2
constexpr int LUT_L2_OFFSET = 0xFFFFF; // ... at this offset
// ends of a slice in pass A (ops/vlc_scan.py END_*)
enum { END_CLEAN = 0, END_ERROR = 1, END_CUT = 2 };

// logical shift left with XLA semantics: 0 once the amount reaches 32
__device__ __forceinline__ uint32_t shl32(uint32_t w, int s) {
  return (s < 0 || s >= 32) ? 0u : (w << s);
}

// n bits of the window from bit `start` (MSB first); the right shift is
// clamped to 0..31 exactly as vlc_scan._bits_of (n == 0 gives junk the
// FSM never uses)
__device__ __forceinline__ int bits_of(uint32_t win, int start, int n) {
  int sh = 32 - n;
  sh = sh < 0 ? 0 : (sh > 31 ? 31 : sh);
  return (int)(shl32(win, start) >> sh);
}

// The 32-bit window at a bit position, from a 64-bit buffer in
// registers.  buf holds words wi and wi + 1, nxt word wi + 2 (its load
// is issued when the buffer moves on and waited for only at the next
// move).  Words past the row read `oob` (0 for a slice row's window, as
// the Pallas scan's masked reduce gives; 0xFFFFFFFF for a lane's words,
// as the XLA scan's gather fills).  A step consumes under 32 bits, so
// the window moves at most one word a step; a jump to a slice start
// reloads.  buf >> (32 - off) with off in 0..31 shifts a 64-bit value
// by 1..32, so the off == 0 case needs no special shift.
struct BitReader {
  const uint32_t* __restrict__ w;
  int W;
  uint32_t oob;
  int wi;
  uint64_t buf;
  uint32_t nxt;

  __device__ uint32_t ld(int i) const {
    return (i >= 0 && i < W) ? __ldg(w + i) : oob;
  }
  __device__ void seek(int i) {
    wi = i;
    buf = ((uint64_t)ld(i) << 32) | ld(i + 1);
    nxt = ld(i + 2);
  }
  __device__ __forceinline__ uint32_t peek(int bitpos) {
    const int i = bitpos >> 5;
    if (i != wi) {
      if (i == wi + 1) {
        buf = (buf << 32) | nxt;
        nxt = ld(i + 2);
        wi = i;
      } else {
        seek(i);
      }
    }
    return (uint32_t)(buf >> (32 - (bitpos & 31)));
  }
};

struct Entry { int kind, bits, run, val; };

__device__ __forceinline__ Entry unpack(int e) {
  Entry x;
  x.kind = (e >> 24) & 3;
  x.bits = (e >> 18) & 31;
  x.run = (e >> 12) & 63;
  x.val = ((e & 0xFFF) ^ 0x800) - 0x800;
  return x;
}

__device__ __forceinline__ int floor_log2(int x) {   // x >= 1
  return 31 - __clz(x);
}

// The compact LUT (n ints, n % 4 == 0) and the zigzag order (64 ints)
// into the block's dynamic shared memory, s[0, n) and s[n, n + 64).
// Every thread of the block takes part, so call it before any returns.
__device__ void load_tables(int* s, const int* __restrict__ lut, int n,
                            const int* __restrict__ zz) {
  const int4* src = reinterpret_cast<const int4*>(lut);
  int4* dst = reinterpret_cast<int4*>(s);
  for (int i = threadIdx.x; i < n / 4; i += blockDim.x)
    dst[i] = __ldg(src + i);
  for (int i = threadIdx.x; i < 64; i += blockDim.x) s[n + i] = __ldg(zz + i);
  __syncthreads();
}

// One scan row through the slice FSM (make_scan_step, vlc_scan.py:
// 279-660) for at most `budget` steps.  The row walks n_sl slices in
// order: slice k starts at bit starts[k] in MB row srows[k] (a slice
// row of K1 / K1F and a slice of K1S's pass A have one; a lane of K1S's
// pass B has its picture's, S_cols columns).  At the start code that
// ends slice k the FSM takes one step to enter slice k + 1 -- or
// ST_DONE after the last -- exactly as the lockstep step does
// (vlc_scan.py:412-435).  Every emission goes to the sink: rec(mi,
// record), nfin(mi, blk, n) at a block's EOB and coef(mi, blk, pos,
// level).  lut / zz are the shared-memory tables.  Returns the steps
// taken; `error` and `state` are the row's final FSM error flag and
// state.
//
// The step's one table load comes before the branch on the state: a
// warp's rows sit in different states and run the branches of the
// states present one after another, so a load inside each branch would
// cost its latency once per state present.  (A step with no branch at
// all -- every state's update computed and selected, as the lockstep
// form does -- measured slower on the card: it runs every state's
// instructions every step.)
template <class Sink>
__device__ int scan_row(const uint32_t* w, int Wp, uint32_t oob,
                        bool live_row, const int* starts, const int* srows,
                        int n_sl, int S_cols, int mbw, int mb_count,
                        bool is_p, int fp, int rs, int budget,
                        const int* lut, const int* zz, Sink& sink,
                        bool& error, int& state) {
  state = live_row ? ST_SLICE_HDR : ST_DONE;
  int bitpos = live_row ? starts[0] : 0;
  int mb_x = -1, mb_y = live_row ? srows[0] : 0;
  int qscale = 1, y_dc = 128, u_dc = 128, v_dc = 128, mv_h = 0, mv_v = 0;
  int mb_type = 0, cbp = 0, blk = 0, n = 0, pending = 0, inc_acc = 0;
  int first_mb = 1, slice_idx = 0;
  error = false;
  BitReader br{w, Wp, oob, 0, 0, 0};
  br.seek(bitpos >> 5);

  auto mb_index = [&](int x, int y) {
    int i = y * mbw + x;
    return i < 0 ? 0 : (i > mb_count - 1 ? mb_count - 1 : i);
  };
  auto advance = [&](int& x, int& y) {
    if (++x >= mbw) { x -= mbw; ++y; }
  };

  int t = 0;
  for (; t < budget && state != ST_DONE; ++t) {
    const uint32_t win = br.peek(bitpos);
    const int peek17 = (int)(win >> 15);
    const int mi = mb_index(mb_x, mb_y);
    // the step's one table load, its section chosen by the state
    int base = L_MBADDR, sh = 6;               // ST_MBADDR, ST_MV*
    if (state == ST_MBTYPE) { base = is_p ? L_MBTYPE_P : L_MBTYPE_I; sh = 11; }
    if (state == ST_CBP) { base = L_CBP; sh = 8; }
    if (state == ST_DC) { base = blk < 4 ? L_DC_LUM : L_DC_CHROM; sh = 9; }
    if (state == ST_MVH || state == ST_MVV) base = L_MOTION;
    if (state == ST_COEF) { base = n == 0 ? L_DCT_FIRST : L_DCT_NEXT; sh = 8; }
    int ent = lut[base + (peek17 >> sh)];
    if (state == ST_COEF && (ent & LUT_L2))     // a long DCT code
      ent = lut[(ent & LUT_L2_OFFSET) + (peek17 & 255)];
    const Entry e = unpack(ent);
    int consumed = 0;
    switch (state) {
    case ST_SLICE_HDR: {
      qscale = bits_of(win, 0, 5);
      y_dc = u_dc = v_dc = 128;
      mv_h = mv_v = 0;
      first_mb = 1;
      inc_acc = 0;
      consumed = 6;
      state = bits_of(win, 5, 1) == 1 ? ST_EXTRA : ST_MBADDR;
    } break;
    case ST_EXTRA: {
      consumed = 9;
      state = bits_of(win, 8, 1) == 1 ? ST_EXTRA : ST_MBADDR;
    } break;
    case ST_MBADDR: {
      if ((win >> 9) == 0) {      // a start code: the next slice, or done
        const int nsl = slice_idx + 1;
        const int k = nsl < S_cols - 1 ? nsl : S_cols - 1;
        slice_idx = nsl;
        mb_x = -1;
        mb_y = srows[k];
        if (nsl < n_sl) {
          state = ST_SLICE_HDR;
          bitpos = starts[k];       // consumed stays 0
        } else {
          state = ST_DONE;
        }
        break;
      }
      consumed = e.bits;
      if (e.kind == K_INVALID) { error = true; state = ST_DONE; break; }
      if (e.val == MB_ESCAPE) { inc_acc += 33; break; }
      if (e.val == MB_STUFFING) break;
      int inc = first_mb == 1 ? 1 : inc_acc + e.val;
      if (inc == 1) {
        advance(mb_x, mb_y);
        state = ST_MBTYPE;
      } else if (inc > 1) {
        y_dc = u_dc = v_dc = 128;
        mv_h = mv_v = 0;
        pending = inc - 1;
        state = ST_SKIP;
      }
      inc_acc = 0;
      first_mb = 0;
    } break;
    case ST_SKIP: {
      advance(mb_x, mb_y);
      sink.rec(mb_index(mb_x, mb_y), MB_SKIP);
      if (--pending == 0) {
        state = ST_MBTYPE;
        advance(mb_x, mb_y);
      }
    } break;
    case ST_MBTYPE: {
      const int mbt = e.val;
      const bool q_flag = (mbt & MBT_QUANT) != 0;
      consumed = e.bits + (q_flag ? 5 : 0);
      mb_type = mbt;
      if (e.kind == K_INVALID) { error = true; state = ST_DONE; break; }
      if (q_flag) qscale = bits_of(win, e.bits, 5);
      if (mbt & MBT_INTRA) {
        mv_h = mv_v = 0;
        cbp = 63;
        blk = 0;
        n = 0;
        state = ST_DC;
        sink.rec(mi, MB_INTRA | (qscale << 2));
      } else {
        y_dc = u_dc = v_dc = 128;
        if (mbt & MBT_MOTION_F) {
          state = ST_MVH;
        } else {
          mv_h = mv_v = 0;
          state = (mbt & MBT_PATTERN) ? ST_CBP : ST_MBADDR;
          sink.rec(mi, MB_INTER | (qscale << 2));
        }
      }
    } break;
    case ST_MVH:
    case ST_MVV: {
      const int code = e.val;
      const int scale = 1 << rs;
      const bool has_resid = code != 0 && scale != 1;
      const int resid = bits_of(win, e.bits, rs);
      const int mag = (abs(code) - 1) * scale + resid + 1;
      const int d = has_resid ? (code < 0 ? -mag : mag) : code;
      int mval = (state == ST_MVH ? mv_h : mv_v) + d;
      if (mval > scale * 16 - 1) mval -= scale * 32;
      if (mval < -(scale * 16)) mval += scale * 32;
      consumed = e.bits + (has_resid ? rs : 0);
      if (e.kind == K_INVALID) { error = true; state = ST_DONE; break; }
      if (state == ST_MVH) {
        mv_h = mval;
        state = ST_MVV;
      } else {
        mv_v = mval;
        state = (mb_type & MBT_PATTERN) ? ST_CBP : ST_MBADDR;
        const int hf = mv_h * (1 << fp), vf = mv_v * (1 << fp);
        sink.rec(mi, MB_INTER | (qscale << 2) | ((hf & 0xFFF) << 7) |
                         ((vf & 0xFFF) << 19));
      }
    } break;
    case ST_CBP: {
      consumed = e.bits;
      if (e.kind == K_INVALID) { error = true; state = ST_DONE; break; }
      cbp = e.val;
      blk = 5 - floor_log2(cbp > 1 ? cbp : 1);
      n = 0;
      state = ST_COEF;
    } break;
    case ST_DC: {
      const int dc_size = e.val;
      const int delta = bits_of(win, e.bits, dc_size);
      const bool top =
          (delta & (1 << (dc_size - 1 > 0 ? dc_size - 1 : 0))) != 0;
      const int neg = (int)(0xFFFFFFFFu << dc_size) | (delta + 1);
      const int pred = blk < 4 ? y_dc : (blk == 4 ? u_dc : v_dc);
      const int dc = dc_size == 0 ? pred : pred + (top ? delta : neg);
      consumed = e.bits + dc_size;
      if (e.kind == K_INVALID) { error = true; state = ST_DONE; break; }
      if (blk < 4) y_dc = dc; else if (blk == 4) u_dc = dc; else v_dc = dc;
      sink.coef(mi, blk, 0, dc);
      n = 1;
      state = ST_COEF;
    } break;
    case ST_COEF: {
      const int v8 = bits_of(win, e.bits, 8);
      const int v16lo = bits_of(win, e.bits + 8, 8);
      const bool esc = e.kind == K_ESCAPE;
      consumed = e.bits + (esc ? ((v8 == 0 || v8 == 128) ? 16 : 8) : 0);
      if (e.kind == K_INVALID) { error = true; state = ST_DONE; break; }
      if (e.kind == K_EOB) {
        sink.nfin(mi, blk, n);
        const int rem = cbp & ((0x20 >> blk) - 1);
        const int nb = rem > 0 ? 5 - floor_log2(rem) : 6;
        if (nb < 6) {
          blk = nb;
          n = 0;
          state = (mb_type & MBT_INTRA) ? ST_DC : ST_COEF;
        } else {
          state = ST_MBADDR;
        }
        break;
      }
      const int level =
          esc ? (v8 == 0 ? v16lo
                         : (v8 == 128 ? v16lo - 256
                                      : (v8 > 128 ? v8 - 256 : v8)))
              : e.val;
      const int nn = n + e.run;
      if (nn >= 64) { error = true; state = ST_DONE; break; }
      sink.coef(mi, blk, zz[nn < 0 ? 0 : nn], level);
      n = nn + 1;
    } break;
    default:
      break;
    }
    bitpos += consumed;
  }
  return t;
}

// K1's sink: the densify rules of ops/scan_dense.py.  An emission
// outside the row's MB row is dropped and errors the lane; only the
// row that perm selects for its (lane, MB row) writes; emissions into
// one slot add up.
//
// No per-thread array: within one row the MB index mi never decreases
// (every advance adds one to y * mbw + x; mb_index clamps only at the
// top, to mb_count - 1), and every slot is keyed by mi.  So a record's
// byte-quarter sums are complete when mi moves on: the current MB's
// four sums stay in registers and are stored once, packed, when mi
// changes or the row ends.  A (mi, blk) block is visited once per MB
// visit and its positions are distinct within a visit (zigzag of a
// rising run index), so a coefficient or an EOB count can land on a
// slot twice only when mi sits at the clamp, mb_count - 1: there the
// sink adds to what is in memory, elsewhere it stores (the buffers start
// at zero, so a store of one emission is that sum).
struct DenseSink {
  int16_t* coef_lane;
  int* nf_lane;
  int* rec_row;            // the lane's records of this MB row
  int BL, rb, mbw, last_mb;
  bool selected, dropped;
  int cur, q0, q1, q2, q3;

  __device__ int local_mb(int mi) {
    int l = mi - rb;
    if (l < 0 || l >= mbw) { dropped = true; return -1; }
    return l;
  }
  __device__ void flush() {
    if (cur < 0) return;
    const uint32_t rec = (uint32_t)q0 | ((uint32_t)q1 << 8) |
                         ((uint32_t)q2 << 16) | ((uint32_t)q3 << 24);
    rec_row[cur] = (int)((rec & 0xFFFFu) | (((rec >> 16) & 0x7FFFu) << 16));
  }
  __device__ void rec(int mi, int val) {
    int l = local_mb(mi);
    if (l < 0 || !selected) return;
    if (l != cur) {
      flush();
      cur = l;
      q0 = q1 = q2 = q3 = 0;
    }
    q0 += val & 0xFF;
    q1 += (val >> 8) & 0xFF;
    q2 += (val >> 16) & 0xFF;
    q3 += (val >> 24) & 0xFF;
  }
  __device__ void nfin(int mi, int b, int val) {
    if (local_mb(mi) < 0 || !selected) return;
    int* p = nf_lane + mi * 6 + b;
    if (mi == last_mb) *p += val; else *p = val;
  }
  __device__ void coef(int mi, int b, int pos, int val) {
    if (local_mb(mi) < 0 || !selected) return;
    int16_t* c = coef_lane + (size_t)pos * BL + mi * 6 + b;
    if (mi == last_mb) *c = (int16_t)((int)*c + (int)(int16_t)val);
    else *c = (int16_t)val;
  }
};

__global__ void scan_dense_kernel(
    const uint32_t* __restrict__ words, const int* __restrict__ start_bits,
    const int* __restrict__ rows, const int* __restrict__ alive,
    const int* __restrict__ pic_type, const int* __restrict__ full_pel,
    const int* __restrict__ r_size, const int* __restrict__ lane_of_row,
    const int* __restrict__ perm, const int* __restrict__ lut,
    const int* __restrict__ zz, int16_t* __restrict__ coeffs_T,
    int* __restrict__ recs, int* __restrict__ nfinal,
    uint8_t* __restrict__ err, int* __restrict__ iters, int NS, int Wp,
    int mbw, int mbh, int long_rows, int budget_long, int budget_short,
    int lut_n) {
  extern __shared__ int4 smem[];
  int* s_lut = reinterpret_cast<int*>(smem);
  load_tables(s_lut, lut, lut_n, zz);
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= NS) return;
  const int mb_count = mbw * mbh;
  const int BL = mb_count * 6;
  const bool live_row = alive[r] != 0;
  const int row = rows[r];
  const int lane = lane_of_row[r];

  DenseSink sink;
  sink.coef_lane = coeffs_T + (size_t)lane * 64 * BL;
  sink.nf_lane = nfinal + (size_t)lane * BL;
  sink.BL = BL;
  sink.rb = row * mbw;                        // first MB of the row
  sink.rec_row = recs + (size_t)lane * mb_count + sink.rb;
  sink.mbw = mbw;
  sink.last_mb = mb_count - 1;
  sink.selected = live_row && row >= 0 && row < mbh &&
                  perm[lane * mbh + row] == r;
  sink.dropped = false;
  sink.cur = -1;
  sink.q0 = sink.q1 = sink.q2 = sink.q3 = 0;

  bool error;
  int state;
  const int t = scan_row(words + (size_t)r * Wp, Wp, 0u, live_row,
                         start_bits + r, rows + r, 1, 1, mbw, mb_count,
                         pic_type[r] == 2, full_pel[r], r_size[r],
                         r < long_rows ? budget_long : budget_short, s_lut,
                         s_lut + lut_n, sink, error, state);
  sink.flush();
  if (error || sink.dropped || state != ST_DONE) err[lane] = 1;
  atomicMax(iters, t);
}

// K1F's sink: the single set-scatter of run_scan_pallas_bucketed
// (vlc_scan_pallas.py:539-552) written straight into the lane-minor
// buffers -- no densify, no drop, no duplicate-claim check; a later
// emission into a slot replaces an earlier one.
struct FlatSink {
  int16_t* coef_lane;
  int* rec_lane;
  int* nf_lane;

  __device__ void rec(int mi, int val) { rec_lane[mi] = val; }
  __device__ void nfin(int mi, int b, int val) { nf_lane[mi * 6 + b] = val; }
  __device__ void coef(int mi, int b, int pos, int val) {
    coef_lane[(size_t)mi * 384 + b * 64 + pos] = (int16_t)val;
  }
};

__global__ void scan_flat_kernel(
    const uint32_t* __restrict__ words, const int* __restrict__ start_bits,
    const int* __restrict__ rows, const int* __restrict__ alive,
    const int* __restrict__ pic_type, const int* __restrict__ full_pel,
    const int* __restrict__ r_size, const int* __restrict__ lane_of_row,
    const int* __restrict__ lut, const int* __restrict__ zz,
    int16_t* __restrict__ coeffs, int* __restrict__ recs,
    int* __restrict__ nfinal, uint8_t* __restrict__ err,
    int* __restrict__ iters, int NS, int Wp, int mbw, int mbh,
    int long_rows, int budget_long, int budget_short, int lut_n) {
  extern __shared__ int4 smem[];
  int* s_lut = reinterpret_cast<int*>(smem);
  load_tables(s_lut, lut, lut_n, zz);
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= NS) return;
  const int mb_count = mbw * mbh;
  const int lane = lane_of_row[r];
  FlatSink sink;
  sink.coef_lane = coeffs + (size_t)lane * mb_count * 384;
  sink.rec_lane = recs + (size_t)lane * mb_count;
  sink.nf_lane = nfinal + (size_t)lane * mb_count * 6;
  bool error;
  int state;
  const int t = scan_row(words + (size_t)r * Wp, Wp, 0u, alive[r] != 0,
                         start_bits + r, rows + r, 1, 1, mbw, mb_count,
                         pic_type[r] == 2, full_pel[r], r_size[r],
                         r < long_rows ? budget_long : budget_short, s_lut,
                         s_lut + lut_n, sink, error, state);
  if (error || state != ST_DONE) err[lane] = 1;
  atomicMax(iters, t);
}

// K1S pass A's sink: K1F's stores plus the range of MB indices the
// slice emitted into (mi never decreases within a slice, so the first
// and the last emission bound it).
struct SliceSink : FlatSink {
  int lo, hi;

  __device__ void see(int mi) {
    lo = mi < lo ? mi : lo;
    hi = mi > hi ? mi : hi;
  }
  __device__ void rec(int mi, int val) { see(mi); FlatSink::rec(mi, val); }
  __device__ void nfin(int mi, int b, int val) {
    see(mi);
    FlatSink::nfin(mi, b, val);
  }
  __device__ void coef(int mi, int b, int pos, int val) {
    see(mi);
    FlatSink::coef(mi, b, pos, val);
  }
};

// K1S pass A: one thread per (lane, slice) -- thread p takes slice k =
// p % S of lane p / S, so a warp holds neighbouring slices of a few
// lanes (their words share cache lines) -- runs the FSM over that one
// slice from its start bit, as the sequential scan enters it (a slice
// header resets everything the FSM carries between slices), with the
// picture's whole symbol budget, and stores its emissions speculatively
// with K1F's sink.  Per pair it reports the steps taken (the step that
// meets the ending start code included, as the sequential scan counts
// it), how the slice ended (clean at a start code, an FSM error, or
// still scanning at the budget) and the MB range it emitted into; dead
// pairs (k >= n_slices) report 0 steps, clean, and an empty range (lo =
// mb_count, hi = -1).  Every pair's four reports are written, so they
// need no zero fill.
//
// Why one speculative pass and not a counting pass plus a storing
// pass: the FSM chain is the kernel's whole cost, and a well-formed
// picture within its budget (what serving decodes) needs every slice
// run exactly once; a counting pass would run each chain twice.  The
// rare lanes whose speculative stores are wrong -- a slice that the
// sequential scan cuts or never enters, two slices on one MB -- are
// redone by pass B.  (Ordering the pairs longest slice first, as K1's
// rows are, measured slower on the card than this lane order, before
// the cost of the sort itself.)
__global__ void scan_slices_kernel(
    const uint32_t* __restrict__ words, const int* __restrict__ starts,
    const int* __restrict__ srows, const int* __restrict__ n_slices,
    const int* __restrict__ pic_type, const int* __restrict__ full_pel,
    const int* __restrict__ r_size, const int* __restrict__ lut,
    const int* __restrict__ zz, int16_t* __restrict__ coeffs,
    int* __restrict__ recs, int* __restrict__ nfinal,
    int* __restrict__ steps_out, int* __restrict__ end_out,
    int* __restrict__ lo_out, int* __restrict__ hi_out, int N, int W,
    int S, int mbw, int mbh, int budget, int lut_n) {
  extern __shared__ int4 smem[];
  int* s_lut = reinterpret_cast<int*>(smem);
  load_tables(s_lut, lut, lut_n, zz);
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= N * S) return;
  const int lane = p / S;
  const int k = p - lane * S;
  const int mb_count = mbw * mbh;
  SliceSink sink;
  sink.coef_lane = coeffs + (size_t)lane * mb_count * 384;
  sink.rec_lane = recs + (size_t)lane * mb_count;
  sink.nf_lane = nfinal + (size_t)lane * mb_count * 6;
  sink.lo = mb_count;
  sink.hi = -1;
  bool error;
  int state;
  const int t = scan_row(words + (size_t)lane * W, W, 0xFFFFFFFFu,
                         k < n_slices[lane], starts + p, srows + p, 1, 1,
                         mbw, mb_count, pic_type[lane] == 2, full_pel[lane],
                         r_size[lane], budget, s_lut, s_lut + lut_n, sink,
                         error, state);
  steps_out[p] = t;
  end_out[p] = error ? END_ERROR : (state != ST_DONE ? END_CUT : END_CLEAN);
  lo_out[p] = sink.lo;
  hi_out[p] = sink.hi;
}

// The sequential scan's outcome for one lane from its n slices scanned
// alone (pass A's reports) -- vlc_scan.resolve_slices, its plain form,
// which the CPU tests hold equal to the JAX scan.  With s_k a slice's
// steps and c_k the sum before it, the sequential scan enters slice k
// iff every slice before it ended clean and c_k < budget, and runs it to
// its end iff also c_k + s_k <= budget.  err: not every slice clean
// within the budget in all; steps: min(budget, c + s) through the first
// slice that did not end clean, else through the last; redo: a slice
// cut or never entered, or two slices that emitted into overlapping MB
// ranges.
__device__ void resolve_lane(const int* st, const int* en, const int* lo,
                             const int* hi, int n, int budget, bool& err,
                             bool& redo, int& steps) {
  int c = 0, through = 0;
  bool clean_before = true;
  redo = false;
  for (int k = 0; k < n; ++k) {
    if (clean_before) {
      through += st[k];
      redo = redo || c + st[k] > budget;
    } else {
      redo = true;
    }
    c += st[k];
    clean_before = clean_before && en[k] == END_CLEAN;
    if (lo[k] <= hi[k])
      for (int j = 0; j < k; ++j)
        redo = redo || (lo[j] <= hi[j] && lo[j] <= hi[k] && lo[k] <= hi[j]);
  }
  err = !(clean_before && c <= budget);
  steps = through < budget ? through : budget;
}

// K1S pass B: one block per lane.  Its first thread resolves the lane
// from pass A's reports (resolve_lane): the lane's error flag, its steps
// into iters, and whether pass A's speculative stores are its result.
// A lane they are not (redo[lane]) has its rows of the three outputs
// cleared by the block, then one thread walks its picture's slices in
// order -- the sequential scan vlc_scan.run_scan of the JAX package's
// device parser (vlc_scan.py:662-729, which XLA runs as one while loop
// over the lanes' lockstep FSM) -- with one symbol budget for the
// picture and K1F's sink.  A thread sets its lane's slots in step order,
// so a slot emitted twice keeps the later value -- the order the CPU
// scatter of the JAX scan follows (XLA leaves it unspecified).  Other
// lanes' blocks return after the resolution.
__global__ void scan_seq_kernel(
    const uint32_t* __restrict__ words, const int* __restrict__ starts,
    const int* __restrict__ srows, const int* __restrict__ n_slices,
    const int* __restrict__ pic_type, const int* __restrict__ full_pel,
    const int* __restrict__ r_size, const int* __restrict__ steps,
    const int* __restrict__ end, const int* __restrict__ lo,
    const int* __restrict__ hi, const int* __restrict__ lut,
    const int* __restrict__ zz, int16_t* __restrict__ coeffs,
    int* __restrict__ recs, int* __restrict__ nfinal,
    uint8_t* __restrict__ err, uint8_t* __restrict__ redo,
    int* __restrict__ iters, int N, int W, int S, int mbw, int mbh,
    int budget, int lut_n) {
  __shared__ int s_redo;
  const int lane = blockIdx.x;
  if (threadIdx.x == 0) {
    const size_t o = (size_t)lane * S;
    bool e, r;
    int t;
    resolve_lane(steps + o, end + o, lo + o, hi + o, n_slices[lane], budget,
                 e, r, t);
    err[lane] = e;
    redo[lane] = r;
    atomicMax(iters, t);
    s_redo = r;
  }
  __syncthreads();
  if (!s_redo) return;                      // uniform across the block
  const int mb_count = mbw * mbh;
  int4* c4 = reinterpret_cast<int4*>(coeffs + (size_t)lane * mb_count * 384);
  int* rl = recs + (size_t)lane * mb_count;
  int* nl = nfinal + (size_t)lane * mb_count * 6;
  const int4 zero = make_int4(0, 0, 0, 0);
  for (int i = threadIdx.x; i < mb_count * 48; i += blockDim.x) c4[i] = zero;
  for (int i = threadIdx.x; i < mb_count; i += blockDim.x) rl[i] = 0;
  for (int i = threadIdx.x; i < mb_count * 6; i += blockDim.x) nl[i] = 0;
  extern __shared__ int4 smem[];
  int* s_lut = reinterpret_cast<int*>(smem);
  load_tables(s_lut, lut, lut_n, zz);      // its barrier orders the clears
  if (threadIdx.x != 0) return;
  FlatSink sink;
  sink.coef_lane = coeffs + (size_t)lane * mb_count * 384;
  sink.rec_lane = rl;
  sink.nf_lane = nl;
  bool error;
  int state;
  scan_row(words + (size_t)lane * W, W, 0xFFFFFFFFu, n_slices[lane] > 0,
           starts + (size_t)lane * S, srows + (size_t)lane * S,
           n_slices[lane], S, mbw, mb_count, pic_type[lane] == 2,
           full_pel[lane], r_size[lane], budget, s_lut, s_lut + lut_n, sink,
           error, state);
}

// the dynamic shared memory of a scan kernel: the compact LUT + zigzag
template <class K>
cudaError_t set_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

size_t table_bytes(int lut_n) { return (size_t)(lut_n + 64) * sizeof(int); }

}  // namespace

// coeffs_T / recs / nfinal / err / iters arrive zeroed
extern "C" int esp_scan_dense(
    const void* words, const void* start_bits, const void* rows,
    const void* alive, const void* pic_type, const void* full_pel,
    const void* r_size, const void* lane_of_row, const void* perm,
    const void* lut, const void* zz, void* coeffs_T, void* recs,
    void* nfinal, void* err, void* iters, int NS, int Wp, int n_lanes,
    int mbw, int mbh, int long_rows, int budget_long, int budget_short,
    int lut_n, void* stream) {
  (void)n_lanes;
  const size_t smem = table_bytes(lut_n);
  cudaError_t e = set_smem(scan_dense_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  const int threads = 64;
  const int blocks = (NS + threads - 1) / threads;
  scan_dense_kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(
      (const uint32_t*)words, (const int*)start_bits, (const int*)rows,
      (const int*)alive, (const int*)pic_type, (const int*)full_pel,
      (const int*)r_size, (const int*)lane_of_row, (const int*)perm,
      (const int*)lut, (const int*)zz, (int16_t*)coeffs_T, (int*)recs,
      (int*)nfinal, (uint8_t*)err, (int*)iters, NS, Wp, mbw, mbh,
      long_rows, budget_long, budget_short, lut_n);
  return (int)cudaGetLastError();
}

// coeffs / recs / nfinal / err / iters arrive zeroed (the scatter
// buffer of the JAX launcher starts at 0)
extern "C" int esp_scan_flat(
    const void* words, const void* start_bits, const void* rows,
    const void* alive, const void* pic_type, const void* full_pel,
    const void* r_size, const void* lane_of_row, const void* lut,
    const void* zz, void* coeffs, void* recs, void* nfinal, void* err,
    void* iters, int NS, int Wp, int mbw, int mbh, int long_rows,
    int budget_long, int budget_short, int lut_n, void* stream) {
  const size_t smem = table_bytes(lut_n);
  cudaError_t e = set_smem(scan_flat_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  const int threads = 64;
  const int blocks = (NS + threads - 1) / threads;
  scan_flat_kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(
      (const uint32_t*)words, (const int*)start_bits, (const int*)rows,
      (const int*)alive, (const int*)pic_type, (const int*)full_pel,
      (const int*)r_size, (const int*)lane_of_row, (const int*)lut,
      (const int*)zz, (int16_t*)coeffs, (int*)recs, (int*)nfinal,
      (uint8_t*)err, (int*)iters, NS, Wp, mbw, mbh, long_rows, budget_long,
      budget_short, lut_n);
  return (int)cudaGetLastError();
}

// K1S pass A.  coeffs / recs / nfinal arrive zeroed (the scatter buffer
// of the JAX scan starts at 0); steps / end / lo / hi [N, S] are written
// for every pair
extern "C" int esp_scan_slices(
    const void* words, const void* slice_starts, const void* slice_rows,
    const void* n_slices, const void* pic_type, const void* full_pel,
    const void* r_size, const void* lut, const void* zz, void* coeffs,
    void* recs, void* nfinal, void* steps, void* end, void* lo, void* hi,
    int N, int W, int S, int mbw, int mbh, int budget, int lut_n,
    void* stream) {
  const size_t smem = table_bytes(lut_n);
  cudaError_t e = set_smem(scan_slices_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  const int threads = 64;
  const int blocks = (N * S + threads - 1) / threads;
  scan_slices_kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(
      (const uint32_t*)words, (const int*)slice_starts,
      (const int*)slice_rows, (const int*)n_slices, (const int*)pic_type,
      (const int*)full_pel, (const int*)r_size, (const int*)lut,
      (const int*)zz, (int16_t*)coeffs, (int*)recs, (int*)nfinal,
      (int*)steps, (int*)end, (int*)lo, (int*)hi, N, W, S, mbw, mbh, budget,
      lut_n);
  return (int)cudaGetLastError();
}

// K1S pass B over pass A's buffers and reports; err / redo (bool [N])
// are written for every lane, iters arrives zeroed
extern "C" int esp_scan_seq(
    const void* words, const void* slice_starts, const void* slice_rows,
    const void* n_slices, const void* pic_type, const void* full_pel,
    const void* r_size, const void* steps, const void* end, const void* lo,
    const void* hi, const void* lut, const void* zz, void* coeffs,
    void* recs, void* nfinal, void* err, void* redo, void* iters, int N,
    int W, int S, int mbw, int mbh, int budget, int lut_n, void* stream) {
  const size_t smem = table_bytes(lut_n);
  cudaError_t e = set_smem(scan_seq_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  scan_seq_kernel<<<N, 256, smem, (cudaStream_t)stream>>>(
      (const uint32_t*)words, (const int*)slice_starts,
      (const int*)slice_rows, (const int*)n_slices, (const int*)pic_type,
      (const int*)full_pel, (const int*)r_size, (const int*)steps,
      (const int*)end, (const int*)lo, (const int*)hi, (const int*)lut,
      (const int*)zz, (int16_t*)coeffs, (int*)recs, (int*)nfinal,
      (uint8_t*)err, (uint8_t*)redo, (int*)iters, N, W, S, mbw, mbh, budget,
      lut_n);
  return (int)cudaGetLastError();
}

// The four scan kernels' registers, local and static shared bytes and
// largest block on the current device (resources.cuh).
extern "C" int esp_scan_resources(int* out, const char** names, int cap) {
  const void* fns[] = {(const void*)scan_dense_kernel,
                       (const void*)scan_flat_kernel,
                       (const void*)scan_slices_kernel,
                       (const void*)scan_seq_kernel};
  const char* kernel_names[] = {"scan_dense_kernel", "scan_flat_kernel",
                                "scan_slices_kernel", "scan_seq_kernel"};
  return kernel_resources(fns, kernel_names, 4, out, names, cap);
}
