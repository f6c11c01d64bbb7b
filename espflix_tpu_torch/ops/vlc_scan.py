"""MPEG-1 slice scan: slice-row packing, the slice FSM, kernel K1.

Each scan row is ONE slice of one lane's picture, its words rebased to
the slice start (``pack_slice_rows``, ops/host_pack.py, re-exported
here).
The FSM is ``make_scan_step`` of espflix_tpu.ops.vlc_scan (vlc_scan.py:
279-660): one syntax element per row per step out of a 32-bit window.

Two forms of ``run_scan_bucketed_dense`` (the port of
vlc_scan_pallas.run_scan_pallas_bucketed_dense with transposed=True):

  * ``run_scan_bucketed_dense_torch``: every row steps in lockstep with
    masks, logs one (index, value) emission per row per step, and the
    log is densified afterwards (ops/scan_dense.log_to_dense_rows and
    assemble_dense_T, as in the JAX package);
  * K1 (csrc/scan.cu): one CUDA thread per scan row runs the same FSM
    serially and stores straight into the dense buffers.

``run_scan_bucketed`` is the lane-minor output mode (the port of
run_scan_pallas_bucketed and, with one budget, run_scan_pallas_sliced):
the same FSM, each emission SET into [N, MB*384] coefficients, [N, MB]
records and [N, MB*6] EOB counts -- plainly by the lockstep form
(``run_scan_bucketed_torch``), or by K1F (csrc/scan.cu) on a card.

``run_scan`` is the device parser's sequential scan (one picture per
lane, slice after slice): plainly the lockstep FSM over the lanes
(``run_scan_torch``), on a card K1S -- the same scan split at slice
starts: a pass with a thread per slice (``scan_slices_cuda``), then a
pass that resolves each lane from its slices' step counts (the plain
form of that is ``resolve_slices``) and scans again, in order, the
lanes the split cannot reproduce (``finish_slices_cuda``).

All forms decode every VLC table from the unified LUT of the JAX package
(``_mega_lut_np``); the JAX step decodes the same codes with compare
cascades, and the parity tests pin the two equal.  The kernels read a
compact form of the LUT their wrapper is given from shared memory
(``compact_lut``).  Row
budgets count FSM steps: rows ``< long_rows`` get ``steps_long`` and the rest
``steps_short``, each rounded up to a multiple of the chunk as the
Pallas launch does; a row not in ST_DONE when its budget runs out
errors its lane.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from espflix_tpu_torch.core import vlc_tables as V
from espflix_tpu_torch.ops.host_pack import pack_slice_rows  # noqa: F401
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
# the widest picture csrc/compose.cu takes (it sizes per-MB-row arrays
# by it); the scan kernels have no such limit
MAX_MB_WIDTH = 64

# the compact LUT of csrc/scan.cu: the unified LUT's non-DCT sections as
# they are, then each DCT section's first level (indexed by the top
# DCT_L1_BITS of the 17-bit peek), then the second levels; a first-level
# entry with LUT_L2 set holds the offset of its 256-entry second level
DCT_L1_BITS = 9
COMPACT_BASES = dict(DCT_FIRST=5248, DCT_NEXT=5248 + (1 << DCT_L1_BITS))
LUT_L2 = 1 << 30

# how a slice ended in K1S's per-slice pass (csrc/scan.cu END_*)
END_CLEAN, END_ERROR, END_CUT = 0, 1, 2

launches = 0            # K1 launches (counted by the CUDA path only)
launches_flat = 0       # K1F launches (counted by the CUDA path only)
launches_seq = 0        # K1S launches, two a run_scan call (CUDA path only)


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
def _compact_layout():
    """Where each slot of the compact LUT comes from: (src int64[C], fixed
    int32[C]) with compact[i] = lut[src[i]] where src[i] >= 0, else
    fixed[i] (a first-level slot's LUT_L2 | offset of its second level,
    or padding).  The layout is the MPEG-1 tables': a first-level slot
    whose 256 DCT codes in the unified LUT (_mega_lut_np) all decode
    alike takes the first of them, each of the 16 other slots of a DCT
    section points at a copy of its 256 entries.  C is a multiple of 4
    (the kernels copy the table in 16-byte words)."""
    lut, bases, bits = _mega_lut_np()
    assert not (lut & LUT_L2).any()
    n_head = bases["DCT_FIRST"]
    assert n_head == COMPACT_BASES["DCT_FIRST"]
    lo_bits = bits["DCT_FIRST"] - DCT_L1_BITS
    head = np.arange(n_head)
    firsts, seconds = [], []
    offset = n_head + 2 * (1 << DCT_L1_BITS)
    for name in ("DCT_FIRST", "DCT_NEXT"):
        rows = bases[name] + (np.arange(1 << DCT_L1_BITS) << lo_bits)
        sec = lut[bases[name]:bases[name] + (1 << bits[name])]
        sec = sec.reshape(1 << DCT_L1_BITS, 1 << lo_bits)
        first = rows.copy()
        for i in np.flatnonzero((sec != sec[:, :1]).any(axis=1)):
            first[i] = -(LUT_L2 | offset)
            seconds.append(rows[i] + np.arange(1 << lo_bits))
            offset += 1 << lo_bits
        firsts.append(first)
    src = np.concatenate([head] + firsts + seconds)
    src = np.pad(src, (0, -len(src) % 4), constant_values=-1)
    fixed = np.where(src < -1, -src, 0).astype(np.int32)
    return np.where(src < 0, -1, src), fixed


@functools.cache
def compact_lut_np() -> np.ndarray:
    """The unified LUT (_mega_lut_np) in the two-level form the scan
    kernels keep in shared memory: 14,464 int32 (57 KB) against
    267,392."""
    src, fixed = _compact_layout()
    return np.where(src >= 0, _mega_lut_np()[0][np.maximum(src, 0)], fixed)


@functools.cache
def _layout_on(device: torch.device):
    """_compact_layout on `device`, uploaded once."""
    return tuple(torch.from_numpy(a).to(device) for a in _compact_layout())


# compact_lut's results, by (device, data_ptr, version) of the unified
# LUT they came from; an entry holds that tensor, so its storage (and
# data_ptr) stays its own while the entry lives
_compact_cache: dict = {}


def compact_lut(lut: torch.Tensor) -> torch.Tensor:
    """The compact LUT of the scan kernels, gathered on lut's device from
    the unified LUT `lut` by _compact_layout (no host sync); kept while
    `lut` is not changed in place.  Exact for any unified LUT whose DCT
    sections vary within a first-level slot only where the MPEG-1
    tables' do (compact_lut(lut) expands back to lut: the CPU tests)."""
    key = (lut.device, lut.data_ptr(), lut._version)
    hit = _compact_cache.get(key)
    if hit is None:
        src, fixed = _layout_on(lut.device)
        out = torch.where(src >= 0, lut[src.clamp(min=0)], fixed)
        if len(_compact_cache) >= 8:
            _compact_cache.clear()
        hit = _compact_cache[key] = (lut, out.contiguous())
    return hit[1]


def _kernel_tables(lut, zigzag, device):
    """Check the wrappers' lut (the unified LUT) and zigzag; return the
    compact form of `lut` (compact_lut) that the kernels read."""
    from espflix_tpu_torch import build

    full, bases, _ = _mega_lut_np()
    if bases != LUT_BASES:
        raise RuntimeError(f"LUT layout changed: {bases}")
    build.check(lut, device, torch.int32, full.shape)
    build.check(zigzag, device, torch.int32, (64,))
    return compact_lut(lut)


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
# device-side row windows (the host-side packing is ops/host_pack.py)
# ---------------------------------------------------------------------------

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


def initial_state_seq(slice_starts, slice_rows, n_slices, pic_type,
                      full_pel, r_size):
    """Per-lane FSM state of a whole picture for the sequential scan:
    the port of espflix_tpu.ops.vlc_scan.initial_state (vlc_scan.py:
    732-757).  slice_starts / slice_rows int32[N, S]; n_slices,
    pic_type, full_pel, r_size int32[N].  Lanes with no slice start in
    ST_DONE."""
    alive = n_slices > 0
    z = torch.zeros_like(n_slices, dtype=torch.int32)
    st = initial_state(slice_starts[:, 0], slice_rows[:, 0],
                       alive.to(torch.int32), pic_type, full_pel, r_size)
    st.update(slice_idx=z, slice_starts=slice_starts.to(torch.int32),
              slice_rows=slice_rows.to(torch.int32),
              n_slices=n_slices.to(torch.int32))
    return st


def _peek_window(words64, bitpos, past_word: int = 0):
    """32 bits starting at bitpos (MSB-aligned) as int64 in [0, 2^32).
    words64: int64[R, W] holding unsigned words.  Words past the window
    read `past_word` (0 for slice rows, as the Pallas scan's masked
    reduce gives; 0xFFFFFFFF for a lane's words, as the XLA scan's
    gather fills); off == 0 never shifts by 32."""
    R, W = words64.shape
    wi = (bitpos >> 5).long()[:, None]
    off = (bitpos & 31).long()
    pair = torch.cat([wi, wi + 1], dim=1)
    got = torch.gather(words64, 1, pair.clamp(0, W - 1))
    got = torch.where((pair >= 0) & (pair < W), got, past_word)
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
              live, past_word: int = 0):
    """One FSM step for every row where `live`; returns (new state,
    emission index int32[R] (TRASH when none), emission value).  A
    state with slice lists (initial_state_seq) walks them: the start
    code that ends a slice enters the next one (vlc_scan.py:412-435);
    a single-slice row (initial_state) ends there."""
    B = LUT_BASES
    MB6 = mb_count * 6
    TRASH = mb_count + MB6 + mb_count * 384
    state = st["state"]
    win = _peek_window(words64, st["bitpos"], past_word)
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

    # blocks of states no live row is in are skipped (one check a step)
    present = set(torch.unique(state[live]).tolist())
    ax, ay = advance(st["mb_x"], st["mb_y"])
    blk = st["blk"]
    jump = None

    # ---- ST_SLICE_HDR ----------------------------------------------------
    if ST_SLICE_HDR in present:
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
    if ST_EXTRA in present:
        m = on(ST_EXTRA)
        nxt = _bits_of(win, 8, 1)
        consumed = torch.where(m, 9, consumed)
        put("state", m, torch.where(nxt == 1, ST_EXTRA, ST_MBADDR)
            .to(torch.int32))

    # ---- ST_MBADDR: a start code enters the next slice or ends ---------
    if ST_MBADDR in present:
        m = on(ST_MBADDR)
        done_slice = m & peek23_zero
        put("mb_x", done_slice, torch.full_like(state, -1))
        if "n_slices" in st:
            nsl = st["slice_idx"] + 1
            more = nsl < st["n_slices"]
            k = nsl.clamp(0, st["slice_starts"].shape[1] - 1).long()[:, None]
            nsl_start = torch.gather(st["slice_starts"], 1, k)[:, 0]
            put("slice_idx", done_slice, nsl)
            put("mb_y", done_slice, torch.gather(st["slice_rows"], 1, k)[:, 0])
            put("state", done_slice, torch.where(more, ST_SLICE_HDR, ST_DONE)
                .to(torch.int32))
            jump = done_slice & more
        else:
            put("state", done_slice, torch.full_like(state, ST_DONE))
        m_addr = m & ~peek23_zero
        kind, bits, _run, val = _lut_fields(lut_at(B["MBADDR"], peek17 >> 6))
        bad = m_addr & (kind == K_INVALID)
        is_stuff = val == V.MB_STUFFING
        is_esc = val == V.MB_ESCAPE
        consumed = torch.where(m_addr, bits, consumed)
        put("inc_acc", m_addr & is_esc, st["inc_acc"] + 33)
        got = m_addr & ~is_stuff & ~is_esc & (kind != K_INVALID)
        inc = torch.where(st["first_mb"] == 1, 1, st["inc_acc"] + val)
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
    if ST_SKIP in present:
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
    if ST_MBTYPE in present:
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
    if ST_MVH in present or ST_MVV in present:
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
    if ST_CBP in present:
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
    if ST_DC in present:
        m = on(ST_DC)
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
    if ST_COEF in present:
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
    if jump is not None:
        new["bitpos"] = torch.where(jump, nsl_start, new["bitpos"])
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
    from espflix_tpu_torch.ops import scan_dense as SD
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
    coef_rows, aux_rows, dropped = SD.log_to_dense_rows(
        log_idx, log_val, rows * mb_width, mb_width=mb_width,
        mb_count=mb_count, transposed=True)
    coeffs_T, recs, nfinal = SD.assemble_dense_T(
        coef_rows, aux_rows, perm, n_lanes=n_lanes, mb_width=mb_width,
        mb_height=mb_height)
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
    dev = words.device
    for t in args:
        build.check(t, dev, torch.int32)
    clut = _kernel_tables(lut, zigzag, dev)
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
        full_pel, r_size, lane_of_row, perm, clut, zigzag, coeffs_T, recs,
        nfinal, err, iters, NS, Wp, n_lanes, mb_width, mb_height,
        long_rows, _budget(steps_long, chunk), _budget(steps_short, chunk),
        clut.numel())
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
    dev = words.device
    for t in args:
        build.check(t, dev, torch.int32)
    clut = _kernel_tables(lut, zigzag, dev)
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
        "esp_scan_flat", *args, clut, zigzag, coeffs, recs, nfinal, err,
        iters, NS, Wp, mb_width, mb_height, long_rows,
        _budget(steps_long, chunk), _budget(steps_short, chunk),
        clut.numel())
    launches_flat += 1
    return coeffs, recs, nfinal, err, iters


# ---------------------------------------------------------------------------
# sequential scan (K1S): the device parser's run_scan
# ---------------------------------------------------------------------------

PAST_WORD = 0xFFFFFFFF   # the XLA gather's fill for words past a lane's


def _check_seq(words, slice_starts, slice_rows, n_slices, pic_type,
               full_pel, r_size):
    N, S = slice_starts.shape
    assert words.shape[0] == N and slice_rows.shape == (N, S)
    for t in (n_slices, pic_type, full_pel, r_size):
        assert t.shape == (N,), t.shape


def _emission_mb(idx, mb_count: int):
    """The MB index of an emission into the [recs | nfinal | coeffs |
    trash] buffer, -1 for the trash slot."""
    MB7 = mb_count * 7
    return torch.where(
        idx < mb_count, idx, torch.where(
            idx < MB7, (idx - mb_count) // 6, torch.where(
                idx < MB7 + mb_count * 384, (idx - MB7) // 384, -1)))


def _scan_lanes_torch(words, slice_starts, slice_rows, n_slices, pic_type,
                      full_pel, r_size, *, mb_width: int, mb_height: int,
                      budget: int, lut, zigzag, track_mbs: bool = False,
                      groups: int = 1):
    """The lockstep FSM over the rows, every row walking its slices for
    at most `budget` steps, each step's emissions set into one
    [N / groups, C1] buffer laid out [recs | nfinal | coeffs | trash] as
    the JAX scan's bulk scatter, consecutive `groups` rows into one
    buffer row (its out_groups).  Returns (coeffs, recs, nfinal, final
    state, steps int32[N], lo, hi int32[N]): lo / hi the lowest and
    highest MB index each row emitted into (mb_count / -1 without
    emissions), tracked only when track_mbs."""
    N = words.shape[0]
    dev = words.device
    mb_count = mb_width * mb_height
    MB6 = mb_count * 6
    C1 = mb_count * (1 + 6 + 384) + 1
    words64 = words.long() & 0xFFFFFFFF
    st = initial_state_seq(slice_starts, slice_rows, n_slices, pic_type,
                           full_pel, r_size)
    steps = torch.zeros(N, dtype=torch.int32, device=dev)
    lo = torch.full((N,), mb_count, dtype=torch.int32, device=dev)
    hi = torch.full((N,), -1, dtype=torch.int32, device=dev)
    buf = torch.zeros(N // groups * C1, dtype=torch.int32, device=dev)
    base = torch.arange(N, device=dev) // groups * C1
    for _ in range(budget):
        live = st["state"] != ST_DONE
        if not bool(live.any()):
            break
        steps += live.to(torch.int32)
        st, i1, v1 = scan_step(st, words64, lut, zigzag,
                               mb_width=mb_width, mb_count=mb_count,
                               live=live, past_word=PAST_WORD)
        buf[base + i1.long()] = v1
        if track_mbs:
            mi = _emission_mb(i1, mb_count)
            lo = torch.where(mi >= 0, torch.minimum(lo, mi), lo)
            hi = torch.maximum(hi, mi)
    buf = buf.reshape(N // groups, C1)
    return (wrap16(buf[:, mb_count + MB6:C1 - 1]),
            buf[:, :mb_count].contiguous(),
            buf[:, mb_count:mb_count + MB6].contiguous(), st, steps, lo, hi)


def run_scan_torch(words, slice_starts, slice_rows, n_slices, pic_type,
                   full_pel, r_size, *, mb_width: int, mb_height: int,
                   max_steps: int, max_symbols: int = 20000, lut, zigzag):
    """Plain form of K1S: the lockstep FSM over the lanes, every lane
    walking its slices, each step's emissions set into one buffer as the
    JAX scan's bulk scatter.  Same returns as run_scan."""
    _check_seq(words, slice_starts, slice_rows, n_slices, pic_type,
               full_pel, r_size)
    coeffs, recs, nfinal, st, steps, _lo, _hi = _scan_lanes_torch(
        words, slice_starts, slice_rows, n_slices, pic_type, full_pel,
        r_size, mb_width=mb_width, mb_height=mb_height,
        budget=min(max_steps, max_symbols), lut=lut, zigzag=zigzag)
    err = st["error"] | (st["state"] != ST_DONE)
    return coeffs, recs, nfinal, err, steps.max().to(torch.int32)


def scan_slices_torch(words, slice_starts, slice_rows, n_slices, pic_type,
                      full_pel, r_size, *, mb_width: int, mb_height: int,
                      budget: int, lut, zigzag):
    """Plain form of K1S's per-slice pass: each (lane, slice) scanned
    alone from its start bit for at most `budget` steps, as the lockstep
    scan of a one-slice picture, its emissions stored into its lane's
    buffers.  Returns (coeffs int16[N, MB*384], recs int32[N, MB],
    nfinal int32[N, MB*6], steps, end, lo, hi int32[N, S]) as
    csrc/scan.cu scan_slices_kernel gives them (dead pairs,
    k >= n_slices: 0 steps, END_CLEAN, lo = mb_count, hi = -1).  Where
    two slices emit into one slot (corrupt input only) the slot keeps
    one of the two values: which, neither form defines."""
    _check_seq(words, slice_starts, slice_rows, n_slices, pic_type,
               full_pel, r_size)
    N, S = slice_starts.shape
    k = torch.arange(S, device=words.device)
    live = (k[None, :] < n_slices[:, None]).reshape(-1).to(torch.int32)

    def rep(t):
        return t.repeat_interleave(S, dim=0)

    coeffs, recs, nfinal, st, steps, lo, hi = _scan_lanes_torch(
        rep(words), slice_starts.reshape(-1, 1), slice_rows.reshape(-1, 1),
        live, rep(pic_type), rep(full_pel), rep(r_size), mb_width=mb_width,
        mb_height=mb_height, budget=budget, lut=lut, zigzag=zigzag,
        track_mbs=True, groups=S)
    end = torch.where(st["error"], END_ERROR,
                      torch.where(st["state"] != ST_DONE, END_CUT, END_CLEAN))
    return (coeffs, recs, nfinal) + tuple(
        t.to(torch.int32).reshape(N, S) for t in (steps, end, lo, hi))


def resolve_slices(steps, end, lo, hi, n_slices, budget: int):
    """The sequential scan's outcome from its slices scanned alone (the
    per-slice pass: scan_slices_cuda on a card, scan_slices_torch
    plainly): the plain form of the resolution in K1S's second pass
    (csrc/scan.cu resolve_lane).  steps / end / lo / hi int32[N, S] per
    (lane, slice); n_slices int32[N]; budget the picture's symbol
    budget.

    With s_k the steps of slice k and c_k the sum over the slices before
    it, the sequential scan enters slice k iff every slice before it
    ended clean and c_k < budget, and runs it to its end iff also c_k +
    s_k <= budget.  A lane is in error unless all its slices end clean
    within the budget in all; it took min(budget, c + s) steps through
    its first slice that did not end clean, else through its last.
    Returns (err bool[N], lane steps int32[N], redo bool[N]): redo marks
    the lanes whose slices' own emissions are not the sequential scan's
    -- a slice it cuts or never enters, or two slices that both run and
    emit into overlapping MB ranges (only corrupt input does); they are
    scanned again in order."""
    N, S = steps.shape
    dev = steps.device
    live = torch.arange(S, device=dev)[None, :] < n_slices[:, None]
    s = torch.where(live, steps, 0).long()
    clean = ((end == END_CLEAN) | ~live).to(torch.int32)
    clean_through = torch.cummin(clean, dim=1).values.bool()
    clean_before = torch.cat([torch.ones_like(clean_through[:, :1]),
                              clean_through[:, :-1]], dim=1)
    c = torch.cumsum(s, dim=1) - s
    runs_out = clean_before & (c + s <= budget)
    err = ~(clean_through[:, -1] & (s.sum(dim=1) <= budget))
    lane_steps = (s * clean_before).sum(dim=1).clamp(max=budget)
    ran = live & (lo <= hi)
    overlap = (ran[:, :, None] & ran[:, None, :]
               & (lo[:, :, None] <= hi[:, None, :])
               & (lo[:, None, :] <= hi[:, :, None])
               & ~torch.eye(S, dtype=torch.bool, device=dev))
    redo = (live & ~runs_out).any(dim=1) | overlap.flatten(1).any(dim=1)
    return err, lane_steps.to(torch.int32), redo


def _seq_launch_args(words, slice_starts, slice_rows, n_slices, pic_type,
                     full_pel, r_size, lut, zigzag):
    args = (words, slice_starts, slice_rows, n_slices, pic_type, full_pel,
            r_size)
    if words.device.type != "cuda":
        raise ValueError(f"unsupported device {words.device}")
    from espflix_tpu_torch import build

    _check_seq(*args)
    for t in args:
        build.check(t, words.device, torch.int32)
    return args, _kernel_tables(lut, zigzag, words.device)


def scan_slices_cuda(words, slice_starts, slice_rows, n_slices, pic_type,
                     full_pel, r_size, *, mb_width: int, mb_height: int,
                     budget: int, lut, zigzag):
    """K1S's first pass on a card (csrc/scan.cu scan_slices_kernel):
    every (lane, slice) in its own thread, its emissions stored into the
    lanes' lane-minor buffers.  Inputs as run_scan.  Returns (coeffs
    int16[N, MB*384], recs int32[N, MB], nfinal int32[N, MB*6], steps,
    end, lo, hi int32[N, S]); the buffers hold the sequential scan's
    result on every lane that resolve_slices does not mark for redo."""
    global launches_seq
    from espflix_tpu_torch import build

    args, clut = _seq_launch_args(words, slice_starts, slice_rows, n_slices,
                                  pic_type, full_pel, r_size, lut, zigzag)
    dev = words.device
    N, W = words.shape
    S = slice_starts.shape[1]
    mb_count = mb_width * mb_height
    coeffs = torch.zeros((N, mb_count * 384), dtype=torch.int16, device=dev)
    recs = torch.zeros((N, mb_count), dtype=torch.int32, device=dev)
    nfinal = torch.zeros((N, mb_count * 6), dtype=torch.int32, device=dev)
    steps, end, lo, hi = (torch.empty((N, S), dtype=torch.int32, device=dev)
                          for _ in range(4))
    build.launch("esp_scan_slices", *args, clut, zigzag, coeffs, recs,
                 nfinal, steps, end, lo, hi, N, W, S, mb_width, mb_height,
                 budget, clut.numel())
    launches_seq += 1
    return coeffs, recs, nfinal, steps, end, lo, hi


def finish_slices_cuda(words, slice_starts, slice_rows, n_slices, pic_type,
                       full_pel, r_size, coeffs, recs, nfinal, steps, end,
                       lo, hi, *, mb_width: int, mb_height: int, budget: int,
                       lut, zigzag):
    """K1S's second pass on a card (csrc/scan.cu scan_seq_kernel) over
    scan_slices_cuda's buffers and reports: each lane resolved as
    resolve_slices does, the lanes marked for redo cleared and scanned
    again in order, in place.  Returns (coeffs, recs, nfinal, err
    bool[N], iters int32 scalar, redo bool[N])."""
    global launches_seq
    from espflix_tpu_torch import build

    args, clut = _seq_launch_args(words, slice_starts, slice_rows, n_slices,
                                  pic_type, full_pel, r_size, lut, zigzag)
    dev = words.device
    N, W = words.shape
    S = slice_starts.shape[1]
    mb_count = mb_width * mb_height
    build.check(coeffs, dev, torch.int16, (N, mb_count * 384))
    build.check(recs, dev, torch.int32, (N, mb_count))
    build.check(nfinal, dev, torch.int32, (N, mb_count * 6))
    for t in (steps, end, lo, hi):
        build.check(t, dev, torch.int32, (N, S))
    err = torch.empty(N, dtype=torch.bool, device=dev)
    redo = torch.empty(N, dtype=torch.bool, device=dev)
    iters = torch.zeros((), dtype=torch.int32, device=dev)
    build.launch("esp_scan_seq", *args, steps, end, lo, hi, clut, zigzag,
                 coeffs, recs, nfinal, err, redo, iters, N, W, S, mb_width,
                 mb_height, budget, clut.numel())
    launches_seq += 1
    return coeffs, recs, nfinal, err, iters, redo


def run_scan(words, slice_starts, slice_rows, n_slices, pic_type, full_pel,
             r_size, *, mb_width: int, mb_height: int, max_steps: int,
             max_symbols: int = 20000, lut, zigzag):
    """One picture per lane through the slice FSM, slice after slice:
    the port of espflix_tpu.ops.vlc_scan.run_scan with initial_state
    (vlc_scan.py:662-757), the scan of the JAX package's device parser.

    words int32[N, W] (a lane's big-endian words as int32 bit patterns;
    words past W read 0xFFFFFFFF); slice_starts / slice_rows int32[N, S];
    n_slices / pic_type / full_pel / r_size int32[N]; lut / zigzag as
    run_scan_bucketed_dense.  The symbol budget is min(max_steps,
    max_symbols) steps per picture.

    Returns (coeffs int16[N, MB*384], recs int32[N, MB], nfinal
    int32[N, MB*6], err bool[N], iters int32 scalar): err is the JAX
    decode's `st["error"] | (st["state"] != ST_DONE)` (an FSM error, or
    a lane still scanning at the budget), iters the most steps any lane
    took.  CPU tensors take the plain form (run_scan_torch).  CUDA
    tensors launch K1S, the same scan split at slice starts: the
    per-slice pass (scan_slices_cuda, one thread per slice), then the
    second pass (finish_slices_cuda: each lane resolved from its slices'
    step counts as resolve_slices does, and the lanes whose slices'
    emissions are not the sequential scan's re-run in order, one thread
    a lane, over cleared rows).  No host sync between launch and
    return."""
    args = (words, slice_starts, slice_rows, n_slices, pic_type, full_pel,
            r_size)
    if words.device.type == "cpu":
        return run_scan_torch(*args, mb_width=mb_width, mb_height=mb_height,
                              max_steps=max_steps, max_symbols=max_symbols,
                              lut=lut, zigzag=zigzag)
    kw = dict(mb_width=mb_width, mb_height=mb_height,
              budget=min(max_steps, max_symbols), lut=lut, zigzag=zigzag)
    parts = scan_slices_cuda(*args, **kw)
    return finish_slices_cuda(*args, *parts, **kw)[:5]
