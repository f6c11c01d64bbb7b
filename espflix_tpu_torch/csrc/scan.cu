// K1 -- MPEG-1 slice scan straight into the dense decode buffers.
//
// Replaces: espflix_tpu/ops/vlc_scan_pallas.py _make_kernel -> kernel
// (the lockstep slice FSM, launched by run_scan_pallas_bucketed_dense)
// and absorbs the densify that followed it on the TPU
// (espflix_tpu/ops/scan_dense.py log_to_dense_rows + assemble_dense_T).
//
// What bounds it on an H100: a serial dependency chain per slice --
// peek a 32-bit window, one LUT load, a few integer ops, the next
// bitpos -- about 1k steps for an I-picture slice.  The TPU ran the FSM
// lockstep over all rows with masks (no program counter per lane) and
// wrote an emission log that one-hot matmuls densified.  Here each scan
// row is one thread with its own program counter: it runs only its own
// state's code, stops at ST_DONE, and stores every emission straight
// into coeffs_T / nfinal (and per-MB record sums kept in local memory),
// so neither the [T, rows] log nor the densify exists.  At 1024 lanes
// x 12 slices that is ~12k threads: latency-bound, not bandwidth-bound;
// the VLC LUTs (~1 MB) stay resident in L2.
//
// Semantics (pinned by tests/test_torch_scan.py against the JAX
// package): make_scan_step (vlc_scan.py:279-660) with single-slice
// rows; a row's budget is budget_long for rows < long_rows, else
// budget_short (already rounded to whole chunks); the densify rules of
// ops/scan_dense.py -- an emission outside the row's MB row is dropped
// and errors the lane, only the row that perm selects for its (lane,
// MB row) writes, emissions into one slot add up (int16-wrapping
// coefficients, int32 nfinal, byte-quarter sums for records, stored as
// lo16 | hi15 << 16).

#include <cstdint>
#include <cuda_runtime.h>

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
// unified LUT section offsets (ops/vlc_scan.py LUT_BASES)
enum {
  L_MBADDR = 0, L_MBTYPE_I = 2048, L_MBTYPE_P = 2112, L_CBP = 2176,
  L_MOTION = 2688, L_DC_LUM = 4736, L_DC_CHROM = 4992,
  L_DCT_FIRST = 5248, L_DCT_NEXT = 5248 + 131072
};
constexpr int MAX_MBW = 64;   // ops/vlc_scan.py MAX_MB_WIDTH

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

// 32 bits from bitpos; words past the row window read 0, and off == 0
// is special-cased because a shift by 32 is undefined
__device__ __forceinline__ uint32_t peek(const uint32_t* w, int W,
                                         int bitpos) {
  int wi = bitpos >> 5;
  int off = bitpos & 31;
  uint32_t w0 = (wi >= 0 && wi < W) ? w[wi] : 0u;
  uint32_t w1 = (wi + 1 >= 0 && wi + 1 < W) ? w[wi + 1] : 0u;
  return (w0 << off) | (off == 0 ? 0u : (w1 >> (32 - off)));
}

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

__global__ void scan_dense_kernel(
    const uint32_t* __restrict__ words, const int* __restrict__ start_bits,
    const int* __restrict__ rows, const int* __restrict__ alive,
    const int* __restrict__ pic_type, const int* __restrict__ full_pel,
    const int* __restrict__ r_size, const int* __restrict__ lane_of_row,
    const int* __restrict__ perm, const int* __restrict__ lut,
    const int* __restrict__ zz, int16_t* __restrict__ coeffs_T,
    int* __restrict__ recs, int* __restrict__ nfinal,
    uint8_t* __restrict__ err, int* __restrict__ iters, int NS, int Wp,
    int mbw, int mbh, int long_rows, int budget_long, int budget_short) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= NS) return;
  const uint32_t* w = words + (size_t)r * Wp;
  const int mb_count = mbw * mbh;
  const int BL = mb_count * 6;
  const bool live_row = alive[r] != 0;
  const int row = rows[r];
  const int lane = lane_of_row[r];
  const int rb = row * mbw;                   // first MB of the row
  const bool selected = live_row && row >= 0 && row < mbh &&
                        perm[lane * mbh + row] == r;
  const int budget = r < long_rows ? budget_long : budget_short;
  const bool is_p = pic_type[r] == 2;
  const int fp = full_pel[r];
  const int rs = r_size[r];

  int state = live_row ? ST_SLICE_HDR : ST_DONE;
  int bitpos = live_row ? start_bits[r] : 0;
  int mb_x = -1, mb_y = live_row ? row : 0;
  int qscale = 1, y_dc = 128, u_dc = 128, v_dc = 128, mv_h = 0, mv_v = 0;
  int mb_type = 0, cbp = 0, blk = 0, n = 0, pending = 0, inc_acc = 0;
  int first_mb = 1;
  bool error = false, dropped = false;
  int q[4 * MAX_MBW];                         // record byte-quarter sums
  if (selected)
    for (int i = 0; i < 4 * mbw; ++i) q[i] = 0;

  int16_t* coef_lane = coeffs_T + (size_t)lane * 64 * BL;
  int* nf_lane = nfinal + (size_t)lane * BL;

  auto mb_index = [&](int x, int y) {
    int i = y * mbw + x;
    return i < 0 ? 0 : (i > mb_count - 1 ? mb_count - 1 : i);
  };
  // local MB of an emission, or -1 (dropped: errors the lane)
  auto local_mb = [&](int mi) {
    int l = mi - rb;
    if (l < 0 || l >= mbw) { dropped = true; return -1; }
    return l;
  };
  auto emit_rec = [&](int mi, int val) {
    int l = local_mb(mi);
    if (l < 0 || !selected) return;
    for (int k = 0; k < 4; ++k) q[l * 4 + k] += (val >> (8 * k)) & 0xFF;
  };
  auto emit_nfin = [&](int mi, int b, int val) {
    if (local_mb(mi) < 0 || !selected) return;
    nf_lane[mi * 6 + b] += val;
  };
  auto emit_coef = [&](int mi, int b, int pos, int val) {
    if (local_mb(mi) < 0 || !selected) return;
    int16_t* c = coef_lane + (size_t)pos * BL + mi * 6 + b;
    *c = (int16_t)((int)*c + (int)(int16_t)val);
  };
  auto advance = [&](int& x, int& y) {
    if (++x >= mbw) { x -= mbw; ++y; }
  };

  int t = 0;
  for (; t < budget && state != ST_DONE; ++t) {
    const uint32_t win = peek(w, Wp, bitpos);
    const int peek17 = (int)(win >> 15);
    const int mi = mb_index(mb_x, mb_y);
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
      if ((win >> 9) == 0) {      // next start code: single-slice row ends
        state = ST_DONE;
        mb_x = -1;
        break;
      }
      Entry e = unpack(lut[L_MBADDR + (peek17 >> 6)]);
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
      emit_rec(mb_index(mb_x, mb_y), MB_SKIP);
      if (--pending == 0) {
        state = ST_MBTYPE;
        advance(mb_x, mb_y);
      }
    } break;
    case ST_MBTYPE: {
      Entry e = unpack(lut[(is_p ? L_MBTYPE_P : L_MBTYPE_I) + (peek17 >> 11)]);
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
        emit_rec(mi, MB_INTRA | (qscale << 2));
      } else {
        y_dc = u_dc = v_dc = 128;
        if (mbt & MBT_MOTION_F) {
          state = ST_MVH;
        } else {
          mv_h = mv_v = 0;
          state = (mbt & MBT_PATTERN) ? ST_CBP : ST_MBADDR;
          emit_rec(mi, MB_INTER | (qscale << 2));
        }
      }
    } break;
    case ST_MVH:
    case ST_MVV: {
      Entry e = unpack(lut[L_MOTION + (peek17 >> 6)]);
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
        emit_rec(mi, MB_INTER | (qscale << 2) | ((hf & 0xFFF) << 7) |
                         ((vf & 0xFFF) << 19));
      }
    } break;
    case ST_CBP: {
      Entry e = unpack(lut[L_CBP + (peek17 >> 8)]);
      consumed = e.bits;
      if (e.kind == K_INVALID) { error = true; state = ST_DONE; break; }
      cbp = e.val;
      blk = 5 - floor_log2(cbp > 1 ? cbp : 1);
      n = 0;
      state = ST_COEF;
    } break;
    case ST_DC: {
      Entry e = unpack(lut[(blk < 4 ? L_DC_LUM : L_DC_CHROM) + (peek17 >> 9)]);
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
      emit_coef(mi, blk, 0, dc);
      n = 1;
      state = ST_COEF;
    } break;
    case ST_COEF: {
      Entry e = unpack(lut[(n == 0 ? L_DCT_FIRST : L_DCT_NEXT) + peek17]);
      const int v8 = bits_of(win, e.bits, 8);
      const int v16lo = bits_of(win, e.bits + 8, 8);
      const bool esc = e.kind == K_ESCAPE;
      consumed = e.bits + (esc ? ((v8 == 0 || v8 == 128) ? 16 : 8) : 0);
      if (e.kind == K_INVALID) { error = true; state = ST_DONE; break; }
      if (e.kind == K_EOB) {
        emit_nfin(mi, blk, n);
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
      emit_coef(mi, blk, zz[nn < 0 ? 0 : nn], level);
      n = nn + 1;
    } break;
    default:
      break;
    }
    bitpos += consumed;
  }

  if (selected) {
    int* rec_row = recs + (size_t)lane * mb_count + rb;
    for (int l = 0; l < mbw; ++l) {
      const uint32_t rec = (uint32_t)q[l * 4] | ((uint32_t)q[l * 4 + 1] << 8) |
                           ((uint32_t)q[l * 4 + 2] << 16) |
                           ((uint32_t)q[l * 4 + 3] << 24);
      rec_row[l] = (int)((rec & 0xFFFFu) | (((rec >> 16) & 0x7FFFu) << 16));
    }
  }
  if (error || dropped || state != ST_DONE) err[lane] = 1;
  atomicMax(iters, t);
}

}  // namespace

extern "C" int esp_scan_dense(
    const void* words, const void* start_bits, const void* rows,
    const void* alive, const void* pic_type, const void* full_pel,
    const void* r_size, const void* lane_of_row, const void* perm,
    const void* lut, const void* zz, void* coeffs_T, void* recs,
    void* nfinal, void* err, void* iters, int NS, int Wp, int n_lanes,
    int mbw, int mbh, int long_rows, int budget_long, int budget_short,
    void* stream) {
  (void)n_lanes;
  const int threads = 64;
  const int blocks = (NS + threads - 1) / threads;
  scan_dense_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)words, (const int*)start_bits, (const int*)rows,
      (const int*)alive, (const int*)pic_type, (const int*)full_pel,
      (const int*)r_size, (const int*)lane_of_row, (const int*)perm,
      (const int*)lut, (const int*)zz, (int16_t*)coeffs_T, (int*)recs,
      (int*)nfinal, (uint8_t*)err, (int*)iters, NS, Wp, mbw, mbh,
      long_rows, budget_long, budget_short);
  return (int)cudaGetLastError();
}
