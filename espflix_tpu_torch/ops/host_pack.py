"""Host-side slice-row packing, without torch.

``pack_slice_rows`` (copied from espflix_tpu.ops.vlc_scan_pallas),
``row_perm`` and ``pack_slice_rows_sharded`` (from
espflix_tpu.ops.scan_dense) turn a make_picture_batch dict into the
scan rows the slice scans read, all numpy; tests/test_torch_host.py pins
them to their originals.  ops/vlc_scan.py and ops/scan_dense.py
re-export them; the host worker pool (runtime/hostpool.py) imports them
from here so that its workers never import torch.
"""

from __future__ import annotations

import numpy as np


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


def row_perm(lane_of_row: np.ndarray, rows: np.ndarray,
             alive: np.ndarray, n_lanes: int, mb_height: int):
    """Host-side: (lane, mb_row) -> scan-row index permutation.

    Returns (perm int32[n_lanes*mb_height], dup bool[n_lanes]): perm
    maps each lane's MB row to the scan row that decodes it, or to
    NS when no scan row covers it.  dup flags lanes where two alive scan
    rows claim the same MB row (outside the supported profile; the lane
    errors).
    """
    NS = len(lane_of_row)
    perm = np.full(n_lanes * mb_height, NS, np.int32)
    dup = np.zeros(n_lanes, bool)
    r = np.asarray(rows)
    l = np.asarray(lane_of_row)
    a = np.asarray(alive).astype(bool)
    ok = a & (r >= 0) & (r < mb_height)
    slots = l[ok].astype(np.int64) * mb_height + r[ok]
    idxs = np.nonzero(ok)[0].astype(np.int32)
    # first claim wins; any further claim on a slot flags its lane
    uniq, first, counts = np.unique(slots, return_index=True,
                                    return_counts=True)
    perm[uniq] = idxs[first]
    if (counts > 1).any():
        dup[(uniq[counts > 1] // mb_height).astype(np.int64)] = True
    return perm, dup


def pack_slice_rows_sharded(batch: dict, n_shards: int, mb_height: int,
                            device_windows: bool = False):
    """Host-side packing for the mesh's slice-scan decoders: the port of
    espflix_tpu.ops.scan_dense.pack_slice_rows_sharded (scan_dense.py:
    76-136).

    Splits the lane axis into n_shards contiguous groups, span-sorts
    each group's slice rows on its own (every shard's rows are
    self-contained: local lane_of_row and row permutation) and
    concatenates along axis 0.  device_windows=True ships per-lane words
    ('lane_words', shard-local 'row_base', one 'win' for all shards).

    Returns (sl dict of the concatenated row arrays plus 'perm',
    'overflow' bool[N] and 'ns_local' rows per shard (+ 'win'), dup
    bool[N])."""
    N = len(batch["active"])
    assert N % n_shards == 0
    ln = N // n_shards
    parts = []
    perms = []
    dups = []
    keys = (("lane_words", "row_base") if device_windows
            else ("words",)) + (
        "start_bits", "rows", "alive", "pic_type",
        "full_pel", "r_size", "lane_of_row")
    for s in range(n_shards):
        sub = {}
        for k, v in batch.items():
            if isinstance(v, np.ndarray) and v.ndim >= 1 and \
                    len(v) == N:
                sub[k] = v[s * ln:(s + 1) * ln]
            else:
                sub[k] = v
        sl = pack_slice_rows(sub, sort_rows=True,
                                device_windows=device_windows)
        perm, dup = row_perm(sl["lane_of_row"], sl["rows"],
                             sl["alive"], ln, mb_height)
        parts.append(sl)
        perms.append(perm)
        dups.append(dup)
    wk = "lane_words" if device_windows else "words"
    Wp = max(p[wk].shape[1] for p in parts)
    for p in parts:
        w = p[wk]
        if w.shape[1] < Wp:
            p[wk] = np.pad(w, ((0, 0), (0, Wp - w.shape[1])))
    out = {k: np.concatenate([p[k] for p in parts]) for k in keys}
    out["perm"] = np.concatenate(perms)
    out["overflow"] = np.concatenate([p["overflow"] for p in parts])
    if device_windows:
        out["win"] = max(p["win"] for p in parts)
    out["ns_local"] = parts[0]["start_bits"].shape[0]
    return out, np.concatenate(dups)
