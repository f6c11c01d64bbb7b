"""MPEG-1 slice scan: slice-row packing, the slice FSM, kernel K1.

Each scan row is ONE slice of one lane's picture, its words rebased to
the slice start (``pack_slice_rows``, copied from
espflix_tpu.ops.vlc_scan_pallas and pinned equal by the host tests).
The FSM is ``make_scan_step`` of espflix_tpu.ops.vlc_scan (vlc_scan.py:
279-660): one syntax element per row per step out of a 32-bit window.

Two forms of ``run_scan_bucketed_dense`` (the port of
vlc_scan_pallas.run_scan_pallas_bucketed_dense with transposed=True):

  * ``run_scan_bucketed_dense_torch``: every row steps in lockstep with
    masks, logs one (index, value) emission per row per step, and the
    log is densified afterwards (ops/scan_dense.densify_log);
  * K1 (csrc/scan.cu): one CUDA thread per scan row runs the same FSM
    serially and stores straight into the dense buffers.

``run_scan_bucketed`` is the lane-minor output mode (the port of
run_scan_pallas_bucketed and, with one budget, run_scan_pallas_sliced):
the same FSM, each emission SET into [N, MB*384] coefficients, [N, MB]
records and [N, MB*6] EOB counts -- plainly by the lockstep form
(``run_scan_bucketed_torch``), or by K1F (csrc/scan.cu) on a card.

All forms decode every VLC table from the unified LUT of the JAX package
(``_mega_lut_np``); the JAX step decodes the same codes with compare
cascades, and the parity tests pin the two equal.  Row budgets count
FSM steps: rows ``< long_rows`` get ``steps_long`` and the rest
``steps_short``, each rounded up to a multiple of the chunk as the
Pallas launch does; a row not in ST_DONE when its budget runs out
errors its lane.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from espflix_tpu_torch.core import vlc_tables as V
from espflix_tpu_torch.ops.intwrap import wrap16, wrap32

# FSM states
ST_DONE = 0
ST_SLICE_HDR = 1
ST_EXTRA = 2
ST_MBADDR = 3
ST_SKIP = 4
ST_MBTYPE = 5
ST_MVH = 6
ST_MVV = 7
ST_CBP = 8
ST_DC = 9
ST_COEF = 10
NUM_STATES = 11

# unified LUT entry: kind(2b @24) | bits(5b @18) | run(6b @12) | val12(@0)
K_INVALID, K_COEFF, K_EOB, K_ESCAPE = 0, 1, 2, 3

# MB kinds in the output record
MB_STALE, MB_SKIP, MB_INTER, MB_INTRA = 0, 1, 2, 3

# LUT section offsets hard-coded in csrc/scan.cu (checked at launch)
LUT_BASES = dict(MBADDR=0, MBTYPE_I=2048, MBTYPE_P=2112, CBP=2176,
                 MOTION=2688, DC_LUM=4736, DC_CHROM=4992,
                 DCT_FIRST=5248, DCT_NEXT=5248 + 131072)
MAX_MB_WIDTH = 64       # csrc/scan.cu keeps per-MB record sums local

launches = 0            # K1 launches (counted by the CUDA path only)
launches_flat = 0       # K1F launches (counted by the CUDA path only)


def _hdr_to_unified(lut: np.ndarray) -> np.ndarray:
    """Convert a (len<<16|val16) header LUT to the unified DCT packing,
    kind=K_COEFF, value in the 12-bit signed field."""
    out = np.zeros_like(lut)
    valid = lut != 0
    length = (lut >> 16) & 0xFF
    val = lut & 0xFFFF
    val = np.where(val >= 0x8000, val - 0x10000, val)
    assert ((val >= -2048) & (val < 2048) | ~valid).all()
    out = np.where(valid,
                   (K_COEFF << 24) | (length << 18) | (val & 0xFFF),
                   0).astype(np.int32)
    return out


@functools.cache
def _mega_lut_np():
    parts = [
        ("MBADDR", _hdr_to_unified(V.LUT_MB_ADDR), 11),
        ("MBTYPE_I", _hdr_to_unified(V.LUT_MB_TYPE_I), 6),
        ("MBTYPE_P", _hdr_to_unified(V.LUT_MB_TYPE_P), 6),
        ("CBP", _hdr_to_unified(V.LUT_CBP), 9),
        ("MOTION", _hdr_to_unified(V.LUT_MOTION), 11),
        ("DC_LUM", _hdr_to_unified(V.LUT_DC_LUM), 8),
        ("DC_CHROM", _hdr_to_unified(V.LUT_DC_CHROM), 8),
        ("DCT_FIRST", V.LUT_DCT_FIRST, 17),
        ("DCT_NEXT", V.LUT_DCT_NEXT, 17),
    ]
    bases = {}
    bits = {}
    offset = 0
    arrs = []
    for name, arr, b in parts:
        bases[name] = offset
        bits[name] = b
        arrs.append(arr.astype(np.int32))
        offset += len(arr)
    return np.concatenate(arrs), bases, bits


@functools.cache
def _next_block_lut_np():
    """rem(6-bit cbp mask of remaining blocks) -> index of next coded
    block (highest set bit; block i has bit 0x20>>i); 6 if none."""
    out = np.full(64, 6, np.int32)
    for rem in range(1, 64):
        out[rem] = 5 - rem.bit_length() + 1
    return out


ZZ_NP = V.ZIG_ZAG.astype(np.int32)


# ---------------------------------------------------------------------------
# host-side slice-row packing and device-side row windows
# ---------------------------------------------------------------------------

def pack_slice_rows(batch: dict, words_window: int | None = None,
                    sort_rows: bool = False,
                    device_windows: bool = False):
    """Host-side: expand a make_picture_batch dict into per-SLICE scan
    rows with words rebased to each slice's word offset.

    Returns dict(words [NS, Wp] uint32, start_bits/rows/alive [NS],
    pic_type/full_pel/r_size [NS]) with NS = N * S, plus out_groups=S.
    Rows whose slice span exceeds words_window are marked dead and the
    lane flagged.  sort_rows=True orders rows by descending slice span
    (the long-budget bucket takes the first rows); lane_of_row [NS]
    routes each row to its lane.  device_windows=True ships per-lane
    words + per-row bases instead of the [NS, Wp] windows
    (gather_scan_rows builds them on the device)."""
    words = np.asarray(batch["words"])
    starts = np.asarray(batch["slice_starts"])
    rows = np.asarray(batch["slice_rows"])
    n_slices = np.asarray(batch["n_slices"])
    n_words = np.asarray(batch.get(
        "n_words", np.full(len(words), words.shape[1], np.int32)))
    N, W = words.shape
    S = starts.shape[1]
    NS = N * S

    # per (lane, slice): base word, end bit, span
    sidx = np.arange(S)[None, :]
    live = sidx < n_slices[:, None]                       # [N, S]
    base = (starts >> 5) * live                           # [N, S]
    nxt = np.concatenate([starts[:, 1:],
                          np.zeros((N, 1), np.int32)], axis=1)
    last = sidx == (n_slices[:, None] - 1)
    end_bit = np.where(last, n_words[:, None] * 32, nxt)
    span = np.where(live, -(-(end_bit - base * 32) // 32) + 2, 0)
    span = np.minimum(span, W - base)

    if words_window is None:
        # auto-size to the longest slice span, bucketed to multiples of
        # 128 words so callers see few distinct shapes
        words_window = min(-(-max(int(span.max()), 1) // 128) * 128, W)
    Wp = min(words_window, W)

    overflow = (span > Wp).any(axis=1)
    ok = live & ~overflow[:, None]                        # [N, S]

    base_c = np.clip(base, 0, W - Wp)
    start_bits = np.where(ok, starts - (base_c << 5), 0) \
        .astype(np.int32).reshape(NS)
    d = dict(start_bits=start_bits,
             rows=np.where(ok, rows, 0).astype(np.int32).reshape(NS),
             alive=ok.astype(np.int32).reshape(NS),
             pic_type=np.repeat(np.asarray(batch["pic_type"]), S),
             full_pel=np.repeat(np.asarray(batch["full_pel"]), S),
             r_size=np.repeat(np.asarray(batch["r_size"]), S),
             out_groups=S, overflow=overflow,
             lane_of_row=np.repeat(np.arange(N, dtype=np.int32), S))
    d["span"] = (span.reshape(NS) * d["alive"]).astype(np.int32)
    lane_r = d["lane_of_row"]
    base_r = base_c.astype(np.intp).reshape(NS)
    if sort_rows:
        order = np.argsort(-d["span"], kind="stable")
        for k in ("start_bits", "rows", "alive", "pic_type",
                  "full_pel", "r_size", "lane_of_row", "span"):
            d[k] = np.ascontiguousarray(d[k][order])
        lane_r = d["lane_of_row"]
        base_r = base_r[order]

    if device_windows:
        # Wm covers every live row's span (+2 margin words past
        # end_bit); reads past Wm are don't-care words the FSM never
        # consumes (its own EOS pad stops it)
        Wm = min(W, -(-max(int(n_words.max()) + 2, Wp) // 128) * 128)
        lw = np.ascontiguousarray(words[:, :Wm])
        if np.shares_memory(lw, words):
            lw = lw.copy()
        d["lane_words"] = lw
        d["row_base"] = base_r.astype(np.int32)
        d["win"] = Wp + (-Wp) % 8
        return d

    # one contiguous row copy per (lane, slice) via a sliding view;
    # windows near the payload end clamp left (span <= Wp was checked)
    from numpy.lib.stride_tricks import sliding_window_view
    view = sliding_window_view(words, Wp, axis=1)        # [N, W-Wp+1, Wp]
    out = view[lane_r, base_r]
    if Wp % 8:
        out = np.pad(out, ((0, 0), (0, 8 - Wp % 8)))
    d["words"] = out
    return d


def gather_scan_rows(lane_words, base, lane_of_row, win: int):
    """Device-side scan-row windowing: the [NS, win] per-slice word
    windows with ONE gather from the per-lane words [N, Wm].  Overruns
    past a lane's words read the next lane's payload (or clamp at the
    very end): don't-care words beyond a row's span + EOS pad."""
    N, Wm = lane_words.shape
    flat = lane_words.reshape(-1)
    idx = (lane_of_row.long() * Wm + base.long())[:, None] \
        + torch.arange(win, device=lane_words.device)[None, :]
    return flat[idx.clamp(0, N * Wm - 1)]


# ---------------------------------------------------------------------------
# plain form: lockstep FSM over all rows
# ---------------------------------------------------------------------------

_STATE_VARS = ("state", "bitpos", "mb_x", "mb_y", "qscale", "y_dc",
               "u_dc", "v_dc", "mv_h", "mv_v", "mb_type", "cbp", "blk",
               "n", "pending_skip", "inc_acc", "first_mb", "error")


def initial_state(start_bits, rows, alive, pic_type, full_pel, r_size):
    """Per-row FSM state for single-slice scan rows (int32 [R] each;
    `error` bool).  Dead rows (alive == 0) start in ST_DONE."""
    z = torch.zeros_like(start_bits, dtype=torch.int32)
    live = alive != 0
    return dict(
        state=torch.where(live, ST_SLICE_HDR, ST_DONE).to(torch.int32),
        bitpos=torch.where(live, start_bits, 0).to(torch.int32),
        pic_type=pic_type.to(torch.int32),
        full_pel=full_pel.to(torch.int32),
        r_size=r_size.to(torch.int32),
        mb_x=z - 1,
        mb_y=torch.where(live, rows, 0).to(torch.int32),
        qscale=z + 1,
        y_dc=z + 128, u_dc=z + 128, v_dc=z + 128,
        mv_h=z, mv_v=z, mb_type=z, cbp=z, blk=z, n=z,
        pending_skip=z, inc_acc=z, first_mb=z + 1,
        error=torch.zeros_like(live),
    )


def _peek_window(words64, bitpos):
    """32 bits starting at bitpos (MSB-aligned) as int64 in [0, 2^32).
    words64: int64[R, W] holding unsigned words.  Words past the row
    window read 0; off == 0 never shifts by 32."""
    R, W = words64.shape
    wi = (bitpos >> 5).long()[:, None]
    off = (bitpos & 31).long()
    pair = torch.cat([wi, wi + 1], dim=1)
    got = torch.gather(words64, 1, pair.clamp(0, W - 1))
    got = torch.where((pair >= 0) & (pair < W), got, 0)
    hi = (got[:, 0] << off) & 0xFFFFFFFF
    lo = torch.where(off == 0, 0, got[:, 1] >> (32 - off))
    return hi | lo


def _bits_of(win, start, n):
    """n bits of the 32-bit window from bit `start` (MSB first), int32.
    n == 0 gives junk exactly as the JAX helper does (shift clamped to
    31); a start past bit 31 reads 0 (logical shift semantics)."""
    start = torch.as_tensor(start, device=win.device).long()
    sh = (32 - torch.as_tensor(n, device=win.device).long()).clamp(0, 31)
    shifted = torch.where(start >= 32, 0,
                          (win << start.clamp(0, 31)) & 0xFFFFFFFF)
    return wrap32(shifted >> sh)


def _lut_fields(e):
    """unified entry -> (kind, bits, run, val) int32."""
    val = ((e & 0xFFF) ^ 0x800) - 0x800
    return (e >> 24) & 3, (e >> 18) & 31, (e >> 12) & 63, val


def _clz_log2(x):
    """31 - clz(max(x, 1)) for the 6-bit block masks (0 <= x < 64), in
    integer compares (a float log2 is not exact on every device)."""
    out = torch.zeros_like(x)
    for k in range(1, 6):
        out += (x >= (1 << k)).to(out.dtype)
    return out


def scan_step(st, words64, lut, zz, *, mb_width: int, mb_count: int,
              live):
    """One FSM step for every row where `live`; returns (new state,
    emission index int32[R] (TRASH when none), emission value)."""
    B = LUT_BASES
    MB6 = mb_count * 6
    TRASH = mb_count + MB6 + mb_count * 384
    state = st["state"]
    win = _peek_window(words64, st["bitpos"])
    peek17 = (win >> 15).to(torch.int32)
    peek23_zero = (win >> 9) == 0
    lut_at = lambda base, idx: lut[(base + idx).long()]  # noqa: E731

    new = dict(st)
    consumed = torch.zeros_like(state)
    error = st["error"].clone()
    e_idx = torch.full_like(state, TRASH)
    e_val = torch.zeros_like(state)

    def on(s):
        return live & (state == s)

    def put(key, mask, value):
        new[key] = torch.where(mask, value, new[key])

    def advance(x, y):
        nx = x + 1
        wrap = nx >= mb_width
        return torch.where(wrap, nx - mb_width, nx), \
            torch.where(wrap, y + 1, y)

    def mb_index(x, y):
        return (y * mb_width + x).clamp(0, mb_count - 1)

    mi = mb_index(st["mb_x"], st["mb_y"])

    # ---- ST_SLICE_HDR ----------------------------------------------------
    m = on(ST_SLICE_HDR)
    put("qscale", m, _bits_of(win, 0, 5))
    extra = _bits_of(win, 5, 1)
    for k, v in (("y_dc", 128), ("u_dc", 128), ("v_dc", 128),
                 ("mv_h", 0), ("mv_v", 0), ("first_mb", 1),
                 ("inc_acc", 0)):
        put(k, m, torch.full_like(state, v))
    consumed = torch.where(m, 6, consumed)
    put("state", m, torch.where(extra == 1, ST_EXTRA, ST_MBADDR)
        .to(torch.int32))

    # ---- ST_EXTRA --------------------------------------------------------
    m = on(ST_EXTRA)
    nxt = _bits_of(win, 8, 1)
    consumed = torch.where(m, 9, consumed)
    put("state", m, torch.where(nxt == 1, ST_EXTRA, ST_MBADDR)
        .to(torch.int32))

    # ---- ST_MBADDR: single-slice rows end at the next start code --------
    m = on(ST_MBADDR)
    done_slice = m & peek23_zero
    put("state", done_slice, torch.full_like(state, ST_DONE))
    put("mb_x", done_slice, torch.full_like(state, -1))
    m_addr = m & ~peek23_zero
    kind, bits, _run, val = _lut_fields(lut_at(B["MBADDR"], peek17 >> 6))
    bad = m_addr & (kind == K_INVALID)
    is_stuff = val == V.MB_STUFFING
    is_esc = val == V.MB_ESCAPE
    consumed = torch.where(m_addr, bits, consumed)
    put("inc_acc", m_addr & is_esc, st["inc_acc"] + 33)
    got = m_addr & ~is_stuff & ~is_esc & (kind != K_INVALID)
    inc = torch.where(st["first_mb"] == 1, 1, st["inc_acc"] + val)
    ax, ay = advance(st["mb_x"], st["mb_y"])
    one = got & (inc == 1)
    multi = got & (inc > 1)
    put("mb_x", one, ax)
    put("mb_y", one, ay)
    put("state", one, torch.full_like(state, ST_MBTYPE))
    for k, v in (("y_dc", 128), ("u_dc", 128), ("v_dc", 128),
                 ("mv_h", 0), ("mv_v", 0)):
        put(k, multi, torch.full_like(state, v))
    put("pending_skip", multi, inc - 1)
    put("state", multi, torch.full_like(state, ST_SKIP))
    put("inc_acc", got, torch.zeros_like(state))
    put("first_mb", got, torch.zeros_like(state))
    error = error | bad
    put("state", bad, torch.full_like(state, ST_DONE))

    # ---- ST_SKIP: one skipped-MB record per step, no bits ---------------
    m = on(ST_SKIP)
    left = st["pending_skip"] - 1
    put("pending_skip", m, left)
    ax2, ay2 = advance(ax, ay)
    last = m & (left == 0)
    put("mb_x", m, torch.where(left == 0, ax2, ax))
    put("mb_y", m, torch.where(left == 0, ay2, ay))
    put("state", last, torch.full_like(state, ST_MBTYPE))
    e_idx = torch.where(m, mb_index(ax, ay), e_idx)
    e_val = torch.where(m, MB_SKIP, e_val)

    # ---- ST_MBTYPE -------------------------------------------------------
    m = on(ST_MBTYPE)
    tbase = torch.where(st["pic_type"] == 2, B["MBTYPE_P"], B["MBTYPE_I"])
    kind, bits, _run, mbt = _lut_fields(lut_at(tbase, peek17 >> 11))
    ok = m & (kind != K_INVALID)
    q_flag = (mbt & V.MBT_QUANT) != 0
    consumed = torch.where(m, bits + torch.where(q_flag, 5, 0), consumed)
    qs = torch.where(ok & q_flag, _bits_of(win, bits, 5), st["qscale"])
    put("qscale", m, qs)
    put("mb_type", m, mbt)
    intra = (mbt & V.MBT_INTRA) != 0
    motion = (mbt & V.MBT_MOTION_F) != 0
    pattern = (mbt & V.MBT_PATTERN) != 0
    mm = ok & intra
    for k, v in (("mv_h", 0), ("mv_v", 0), ("cbp", 63), ("blk", 0),
                 ("n", 0), ("state", ST_DC)):
        put(k, mm, torch.full_like(state, v))
    mni = ok & ~intra
    for k in ("y_dc", "u_dc", "v_dc"):
        put(k, mni, torch.full_like(state, 128))
    put("state", mni & motion, torch.full_like(state, ST_MVH))
    no_mv = mni & ~motion
    put("mv_h", no_mv, torch.zeros_like(state))
    put("mv_v", no_mv, torch.zeros_like(state))
    put("state", no_mv, torch.where(pattern, ST_CBP, ST_MBADDR)
        .to(torch.int32))
    emit = mm | no_mv
    e_idx = torch.where(emit, mi, e_idx)
    kind_mb = torch.where(intra, MB_INTRA, MB_INTER).to(torch.int32)
    e_val = torch.where(emit, kind_mb | (qs << 2), e_val)
    bad = m & (kind == K_INVALID)
    error = error | bad
    put("state", bad, torch.full_like(state, ST_DONE))

    # ---- ST_MVH / ST_MVV -------------------------------------------------
    kind, bits, _run, code = _lut_fields(lut_at(B["MOTION"], peek17 >> 6))
    r_size = st["r_size"]
    scale = torch.ones_like(r_size) << r_size
    has_resid = (code != 0) & (scale != 1)
    resid = _bits_of(win, bits, r_size)
    mag = (code.abs() - 1) * scale + resid + 1
    d = torch.where(has_resid, torch.where(code < 0, -mag, mag), code)
    mot_consumed = bits + torch.where(has_resid, r_size, 0)
    bad_code = kind == K_INVALID
    mvals = {}
    for stv, key in ((ST_MVH, "mv_h"), (ST_MVV, "mv_v")):
        m = on(stv)
        mval = st[key] + d
        mval = torch.where(mval > (scale << 4) - 1, mval - (scale << 5),
                           mval)
        mval = torch.where(mval < -(scale << 4), mval + (scale << 5),
                           mval)
        mvals[key] = mval
        consumed = torch.where(m, mot_consumed, consumed)
        put(key, m & ~bad_code, mval)
        error = error | (m & bad_code)
        put("state", m & bad_code, torch.full_like(state, ST_DONE))
    put("state", on(ST_MVH) & ~bad_code, torch.full_like(state, ST_MVV))
    mvv_done = on(ST_MVV) & ~bad_code
    pattern = (st["mb_type"] & V.MBT_PATTERN) != 0
    put("state", mvv_done, torch.where(pattern, ST_CBP, ST_MBADDR)
        .to(torch.int32))
    fp = torch.ones_like(r_size) << st["full_pel"]
    rec = (MB_INTER | (st["qscale"] << 2)
           | (((st["mv_h"] * fp) & 0xFFF) << 7)
           | (((mvals["mv_v"] * fp) & 0xFFF) << 19))
    e_idx = torch.where(mvv_done, mi, e_idx)
    e_val = torch.where(mvv_done, rec, e_val)

    # ---- ST_CBP ----------------------------------------------------------
    m = on(ST_CBP)
    kind, bits, _run, cbp = _lut_fields(lut_at(B["CBP"], peek17 >> 8))
    ok = m & (kind != K_INVALID)
    consumed = torch.where(m, bits, consumed)
    put("cbp", ok, cbp)
    put("blk", ok, 5 - _clz_log2(cbp))
    put("n", ok, torch.zeros_like(state))
    put("state", ok, torch.full_like(state, ST_COEF))
    bad = m & (kind == K_INVALID)
    error = error | bad
    put("state", bad, torch.full_like(state, ST_DONE))

    # ---- ST_DC -----------------------------------------------------------
    m = on(ST_DC)
    blk = st["blk"]
    dbase = torch.where(blk < 4, B["DC_LUM"], B["DC_CHROM"])
    kind, bits, _run, dc_size = _lut_fields(lut_at(dbase, peek17 >> 9))
    delta = _bits_of(win, bits, dc_size)
    one_i = torch.ones_like(dc_size)
    top = (delta & (one_i << (dc_size - 1).clamp(min=0))) != 0
    neg = (-one_i << dc_size) | (delta + 1)
    pred = torch.where(blk < 4, st["y_dc"],
                       torch.where(blk == 4, st["u_dc"], st["v_dc"]))
    dc = torch.where(dc_size == 0, pred,
                     pred + torch.where(top, delta, neg))
    consumed = torch.where(m, bits + dc_size, consumed)
    upd = m & (kind != K_INVALID)
    put("y_dc", upd & (blk < 4), dc)
    put("u_dc", upd & (blk == 4), dc)
    put("v_dc", upd & (blk == 5), dc)
    e_idx = torch.where(upd, mb_count + MB6 + mi * 384 + blk * 64, e_idx)
    e_val = torch.where(upd, dc, e_val)
    put("n", upd, torch.ones_like(state))
    put("state", upd, torch.full_like(state, ST_COEF))
    bad = m & (kind == K_INVALID)
    error = error | bad
    put("state", bad, torch.full_like(state, ST_DONE))

    # ---- ST_COEF ---------------------------------------------------------
    m = on(ST_COEF)
    n = st["n"]
    cbase = torch.where(n == 0, B["DCT_FIRST"], B["DCT_NEXT"])
    kind, bits, run, lev = _lut_fields(lut_at(cbase, peek17))
    bad = m & (kind == K_INVALID)
    is_eob = kind == K_EOB
    is_esc = kind == K_ESCAPE
    v8 = _bits_of(win, bits, 8)
    v16lo = _bits_of(win, bits + 8, 8)
    esc_level = torch.where(v8 == 0, v16lo, torch.where(
        v8 == 128, v16lo - 256, torch.where(v8 > 128, v8 - 256, v8)))
    esc_extra = torch.where((v8 == 0) | (v8 == 128), 16, 8)
    level = torch.where(is_esc, esc_level, lev)
    nn = n + run
    good = m & (kind != K_INVALID)
    oob = good & ~is_eob & (nn >= 64)
    zz_pos = zz[nn.clamp(0, 63).long()]
    consumed = torch.where(m, bits + torch.where(is_esc, esc_extra, 0),
                           consumed)
    emit = good & ~is_eob & ~oob
    e_idx = torch.where(emit, mb_count + MB6 + mi * 384 + blk * 64
                        + zz_pos, e_idx)
    e_val = torch.where(emit, level, e_val)
    put("n", emit, nn + 1)
    meob = good & is_eob
    e_idx = torch.where(meob, mb_count + mi * 6 + blk, e_idx)
    e_val = torch.where(meob, n, e_val)
    rem = st["cbp"] & ((torch.full_like(blk, 0x20) >> blk) - 1)
    nb = torch.where(rem > 0, 5 - _clz_log2(rem), 6)
    more = meob & (nb < 6)
    intra = (st["mb_type"] & V.MBT_INTRA) != 0
    put("blk", more, nb)
    put("n", more, torch.zeros_like(state))
    put("state", more, torch.where(intra, ST_DC, ST_COEF)
        .to(torch.int32))
    put("state", meob & (nb >= 6), torch.full_like(state, ST_MBADDR))
    error = error | bad | oob
    put("state", bad | oob, torch.full_like(state, ST_DONE))

    new["bitpos"] = st["bitpos"] + torch.where(live, consumed, 0)
    new = {k: v.to(torch.int32) for k, v in new.items()}
    new["error"] = error
    return new, e_idx.to(torch.int32), e_val.to(torch.int32)


def _budget(steps: int, chunk: int) -> int:
    """The Pallas launch runs whole chunks of min(chunk, steps) steps."""
    c = min(chunk, steps)
    return -(-steps // c) * c


def _check_rows(words, start_bits, rows, alive, pic_type, full_pel,
                r_size, lane_of_row, perm, n_lanes, mb_height,
                long_rows):
    NS = words.shape[0]
    assert 0 < long_rows < NS, (long_rows, NS)
    for t in (start_bits, rows, alive, pic_type, full_pel, r_size,
              lane_of_row):
        assert t.shape == (NS,), t.shape
    assert perm.shape == (n_lanes * mb_height,), perm.shape


def run_scan_bucketed_dense_torch(
        words, start_bits, rows, alive, pic_type, full_pel, r_size,
        lane_of_row, perm, *, mb_width: int, mb_height: int,
        n_lanes: int, long_rows: int, steps_long: int, steps_short: int,
        chunk: int = 128, lut, zigzag):
    """Plain form of K1: lockstep FSM + log densify.  Same returns as
    run_scan_bucketed_dense."""
    _check_rows(words, start_bits, rows, alive, pic_type, full_pel,
                r_size, lane_of_row, perm, n_lanes, mb_height, long_rows)
    from espflix_tpu_torch.ops.scan_dense import densify_log
    NS = words.shape[0]
    dev = words.device
    mb_count = mb_width * mb_height
    bl, bs = _budget(steps_long, chunk), _budget(steps_short, chunk)
    budget = torch.where(torch.arange(NS, device=dev) < long_rows, bl, bs)
    words64 = words.long() & 0xFFFFFFFF
    st = initial_state(start_bits, rows, alive, pic_type, full_pel,
                       r_size)
    steps = torch.zeros(NS, dtype=torch.int32, device=dev)
    li, lv = [], []
    for t in range(max(bl, bs)):
        live = (st["state"] != ST_DONE) & (budget > t)
        if not bool(live.any()):
            break
        steps += live.to(torch.int32)
        st, i1, v1 = scan_step(st, words64, lut, zigzag,
                               mb_width=mb_width, mb_count=mb_count,
                               live=live)
        li.append(i1)
        lv.append(v1)
    trash = mb_count * (1 + 6 + 384)
    if li:
        log_idx, log_val = torch.stack(li), torch.stack(lv)
    else:
        log_idx = torch.full((1, NS), trash, dtype=torch.int32,
                             device=dev)
        log_val = torch.zeros((1, NS), dtype=torch.int32, device=dev)
    coeffs_T, recs, nfinal, dropped = densify_log(
        log_idx, log_val, rows, lane_of_row, perm, n_lanes=n_lanes,
        mb_width=mb_width, mb_height=mb_height)
    bad = st["error"] | (st["state"] != ST_DONE) | dropped
    err = torch.zeros(n_lanes, dtype=torch.int32, device=dev)
    err.index_put_((lane_of_row.long(),), bad.to(torch.int32),
                   accumulate=True)
    err = err > 0
    iters = steps.max().to(torch.int32)
    return coeffs_T, recs, nfinal, err, iters


def run_scan_bucketed_dense(
        words, start_bits, rows, alive, pic_type, full_pel, r_size,
        lane_of_row, perm, *, mb_width: int, mb_height: int,
        n_lanes: int, long_rows: int, steps_long: int, steps_short: int,
        chunk: int = 128, lut, zigzag):
    """Two-budget slice scan into dense buffers.

    words int32[NS, Wp] (big-endian 32-bit words as int32 bit
    patterns, one rebased window per scan row); start_bits / rows /
    alive / pic_type / full_pel / r_size / lane_of_row int32[NS] from
    pack_slice_rows(sort_rows=True); perm int32[n_lanes*mb_height] from
    scan_dense.row_perm; lut the unified LUT (_mega_lut_np), zigzag
    ZZ_NP, both int32 on the same device.

    Returns (coeffs_T int16[N, 64, MB*6], recs int32[N, MB], nfinal
    int32[N, MB*6], err bool[N], iters int32 scalar) -- the outputs of
    run_scan_pallas_bucketed_dense(transposed=True).  CPU tensors take
    the plain form; CUDA tensors launch K1 (csrc/scan.cu)."""
    global launches
    args = (words, start_bits, rows, alive, pic_type, full_pel, r_size,
            lane_of_row, perm)
    kw = dict(mb_width=mb_width, mb_height=mb_height, n_lanes=n_lanes,
              long_rows=long_rows, steps_long=steps_long,
              steps_short=steps_short, chunk=chunk, lut=lut,
              zigzag=zigzag)
    if words.device.type == "cpu":
        return run_scan_bucketed_dense_torch(*args, **kw)
    if words.device.type != "cuda":
        raise ValueError(f"unsupported device {words.device}")
    from espflix_tpu_torch import build

    _check_rows(words, start_bits, rows, alive, pic_type, full_pel,
                r_size, lane_of_row, perm, n_lanes, mb_height, long_rows)
    _, bases, _ = _mega_lut_np()
    if bases != LUT_BASES:
        raise RuntimeError(f"LUT layout changed: {bases}")
    if mb_width > MAX_MB_WIDTH:
        raise ValueError(f"mb_width {mb_width} > {MAX_MB_WIDTH}")
    dev = words.device
    for t in args + (lut, zigzag):
        build.check(t, dev, torch.int32)
    NS, Wp = words.shape
    mb_count = mb_width * mb_height
    BL = mb_count * 6
    coeffs_T = torch.zeros((n_lanes, 64, BL), dtype=torch.int16,
                           device=dev)
    recs = torch.zeros((n_lanes, mb_count), dtype=torch.int32, device=dev)
    nfinal = torch.zeros((n_lanes, BL), dtype=torch.int32, device=dev)
    err = torch.zeros(n_lanes, dtype=torch.bool, device=dev)
    iters = torch.zeros((), dtype=torch.int32, device=dev)
    build.launch(
        "esp_scan_dense", words, start_bits, rows, alive, pic_type,
        full_pel, r_size, lane_of_row, perm, lut, zigzag, coeffs_T, recs,
        nfinal, err, iters, NS, Wp, n_lanes, mb_width, mb_height,
        long_rows, _budget(steps_long, chunk), _budget(steps_short, chunk))
    launches += 1
    return coeffs_T, recs, nfinal, err, iters


# ---------------------------------------------------------------------------
# lane-minor output mode (K1F): run_scan_pallas_bucketed / _sliced
# ---------------------------------------------------------------------------

def _check_flat_rows(words, start_bits, rows, alive, pic_type, full_pel,
                     r_size, lane_of_row, long_rows):
    NS = words.shape[0]
    assert 0 < long_rows <= NS, (long_rows, NS)
    for t in (start_bits, rows, alive, pic_type, full_pel, r_size,
              lane_of_row):
        assert t.shape == (NS,), t.shape


def run_scan_bucketed_torch(
        words, start_bits, rows, alive, pic_type, full_pel, r_size,
        lane_of_row, *, mb_width: int, mb_height: int, n_lanes: int,
        long_rows: int, steps_long: int, steps_short: int,
        chunk: int = 128, lut, zigzag):
    """Plain form of K1F: the lockstep FSM, each step's emissions set
    into one [n_lanes, C1] buffer laid out [recs | nfinal | coeffs |
    trash] as the JAX launcher's scatter buffer.  Same returns as
    run_scan_bucketed."""
    _check_flat_rows(words, start_bits, rows, alive, pic_type, full_pel,
                     r_size, lane_of_row, long_rows)
    NS = words.shape[0]
    dev = words.device
    mb_count = mb_width * mb_height
    MB6 = mb_count * 6
    C1 = mb_count * (1 + 6 + 384) + 1
    bl, bs = _budget(steps_long, chunk), _budget(steps_short, chunk)
    budget = torch.where(torch.arange(NS, device=dev) < long_rows, bl, bs)
    words64 = words.long() & 0xFFFFFFFF
    st = initial_state(start_bits, rows, alive, pic_type, full_pel,
                       r_size)
    steps = torch.zeros(NS, dtype=torch.int32, device=dev)
    buf = torch.zeros(n_lanes * C1, dtype=torch.int32, device=dev)
    base = lane_of_row.long() * C1
    for t in range(max(bl, bs)):
        live = (st["state"] != ST_DONE) & (budget > t)
        if not bool(live.any()):
            break
        steps += live.to(torch.int32)
        st, i1, v1 = scan_step(st, words64, lut, zigzag,
                               mb_width=mb_width, mb_count=mb_count,
                               live=live)
        # a later step replaces an earlier one; rows without an emission
        # write 0 into their lane's trash slot
        buf[base + i1.long()] = v1
    buf = buf.reshape(n_lanes, C1)
    bad = st["error"] | (st["state"] != ST_DONE)
    err = torch.zeros(n_lanes, dtype=torch.int32, device=dev)
    err.index_put_((lane_of_row.long(),), bad.to(torch.int32),
                   accumulate=True)
    return (wrap16(buf[:, mb_count + MB6:C1 - 1]),
            buf[:, :mb_count].contiguous(),
            buf[:, mb_count:mb_count + MB6].contiguous(), err > 0,
            steps.max().to(torch.int32))


def run_scan_bucketed(
        words, start_bits, rows, alive, pic_type, full_pel, r_size,
        lane_of_row, *, mb_width: int, mb_height: int, n_lanes: int,
        long_rows: int, steps_long: int, steps_short: int,
        chunk: int = 128, lut, zigzag):
    """Two-budget slice scan into lane-minor buffers: the port of
    vlc_scan_pallas.run_scan_pallas_bucketed (vlc_scan_pallas.py:
    495-557) and, with long_rows = NS over unsorted rows (uniform
    budget, chunk 256), of run_scan_pallas_sliced (:450-488).

    Inputs as run_scan_bucketed_dense without perm; rows < long_rows
    get steps_long, the rest steps_short, each rounded up to whole
    chunks of min(chunk, steps).  Returns (coeffs int16[N, MB*384],
    recs int32[N, MB], nfinal int32[N, MB*6], err bool[N], iters int32
    scalar).  No duplicate slice claim is flagged: two rows that emit
    into one slot leave one of the two values.  CPU tensors take the
    plain form; CUDA tensors launch K1F (csrc/scan.cu)."""
    global launches_flat
    args = (words, start_bits, rows, alive, pic_type, full_pel, r_size,
            lane_of_row)
    kw = dict(mb_width=mb_width, mb_height=mb_height, n_lanes=n_lanes,
              long_rows=long_rows, steps_long=steps_long,
              steps_short=steps_short, chunk=chunk, lut=lut,
              zigzag=zigzag)
    if words.device.type == "cpu":
        return run_scan_bucketed_torch(*args, **kw)
    if words.device.type != "cuda":
        raise ValueError(f"unsupported device {words.device}")
    from espflix_tpu_torch import build

    _check_flat_rows(*args, long_rows)
    _, bases, _ = _mega_lut_np()
    if bases != LUT_BASES:
        raise RuntimeError(f"LUT layout changed: {bases}")
    dev = words.device
    for t in args + (lut, zigzag):
        build.check(t, dev, torch.int32)
    NS, Wp = words.shape
    mb_count = mb_width * mb_height
    coeffs = torch.zeros((n_lanes, mb_count * 384), dtype=torch.int16,
                         device=dev)
    recs = torch.zeros((n_lanes, mb_count), dtype=torch.int32, device=dev)
    nfinal = torch.zeros((n_lanes, mb_count * 6), dtype=torch.int32,
                         device=dev)
    err = torch.zeros(n_lanes, dtype=torch.bool, device=dev)
    iters = torch.zeros((), dtype=torch.int32, device=dev)
    build.launch(
        "esp_scan_flat", *args, lut, zigzag, coeffs, recs, nfinal, err,
        iters, NS, Wp, mb_width, mb_height, long_rows,
        _budget(steps_long, chunk), _budget(steps_short, chunk))
    launches_flat += 1
    return coeffs, recs, nfinal, err, iters
