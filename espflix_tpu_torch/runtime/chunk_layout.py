"""The full chain's chunk layout: which inputs a tick gives the chain,
in what order, and how K ticks become one chunk.

Every path that builds a full-chain chunk assembles it here:
Fleet.run_chunk_full (one device or a 'streams' mesh),
Fleet.run_chunk_full_pooled, the HostPool workers (each ships its
lanes' tick_inputs; ``join_workers`` and ``regroup_workers`` make them
the fleet's), runtime/workload.bench_chunk and tools/perf_host.py.
runtime/chain.py re-exports the key tuples.

A tick's inputs (``tick_inputs``) are the span-sorted slice rows of
ops/host_pack.pack_slice_rows and their row permutation, the picture
batch's quantiser matrices and active flags, the OutputStage's
tick_state and the tick's SBC arrays.  Two window modes, as
runtime/chain.FullChain reads them: device windows (per-lane
"lane_words" and per-row "row_base"; the chain gathers the [NS, win]
row windows on the device, win > 0) and host windows ("words", the row
windows built on the host, win = 0).  ``stack_chunk`` zero-pads each
tick's word array and SBC words to the chunk's widest and stacks the
ticks.

numpy only: the HostPool workers import this module and never torch.
"""

from __future__ import annotations

import numpy as np

# per-tick xs keys (stacked [K, ...] by the caller)
DECODE_KEYS = ("words", "start_bits", "rows", "alive", "pic_type",
               "full_pel", "r_size", "lane_of_row", "perm",
               "intra_q", "non_intra_q", "active")
# device-window mode (win > 0): per-LANE words + per-row bases replace
# the pre-built [NS, win] row windows (gather_scan_rows on the device)
DECODE_KEYS_DW = ("lane_words", "row_base") + DECODE_KEYS[1:]
OUTPUT_KEYS = ("osd", "blend", "progress", "parity", "aud_words",
               "aud_act", "aud_nval", "beep_left", "starved")
SCROLL_KEYS = ("hscroll",)

# the per-row arrays of the device-window rows, which regroup_workers
# moves into the global buckets
POOL_ROW_KEYS = DECODE_KEYS_DW[1:9]
# the OutputStage's tick_state the chain reads (hscroll where given)
STATE_KEYS = ("osd", "blend", "progress", "parity", "hscroll",
              "beep_left")
# one tick's SBC arrays: host_gather.gather_audio_arrays' first four
AUDIO_KEYS = ("aud_words", "aud_act", "aud_nval", "starved")
# zero-padded on their last axis to the chunk's widest
_PADDED = ("lane_words", "words", "aud_words")


def tick_inputs(sl: dict, perm, b: dict, snap: dict, audio) -> dict:
    """One tick's chain inputs in the chain's key order: the slice rows
    `sl` (device windows when it holds "lane_words", then with their
    "win"; else host windows), their row permutation `perm`, the picture
    batch `b`'s intra_q, non_intra_q and active, the OutputStage's
    tick_state `snap` (hscroll only where it holds one) and the tick's
    SBC arrays `audio` (words, active, n_valid, starved)."""
    dw = "lane_words" in sl
    rows = DECODE_KEYS_DW[:9] if dw else DECODE_KEYS[:8]
    x = {k: sl[k] for k in rows}
    if dw:
        x["win"] = sl["win"]
    x["perm"] = perm
    for k in DECODE_KEYS[9:]:
        x[k] = b[k]
    for k in STATE_KEYS:
        if k in snap:
            x[k] = snap[k]
    x.update(zip(AUDIO_KEYS, audio))
    return x


def _padded(k: str, arrs: list) -> list:
    """The arrays `arrs` of key k; the word arrays ("lane_words",
    "words", "aud_words") zero-padded on their last axis to the
    widest."""
    if k not in _PADDED:
        return arrs
    width = max(a.shape[-1] for a in arrs)
    return [a if a.shape[-1] == width else
            np.pad(a, [(0, 0)] * (a.ndim - 1) + [(0, width - a.shape[-1])])
            for a in arrs]


def stack_chunk(xs_t: list) -> tuple[dict, int]:
    """(stacked, win): the ticks `xs_t` of tick_inputs as one chunk of
    [K, ...] arrays in their key order, the word array ("lane_words" or
    "words") and "aud_words" zero-padded to the chunk's widest; win is
    the ticks' largest row window (0 with host windows), taken off the
    keys."""
    win = max(x.get("win", 0) for x in xs_t)
    return {k: np.stack(_padded(k, [x[k] for x in xs_t]))
            for k in xs_t[0] if k != "win"}, win


def join_workers(parts: list) -> dict:
    """One tick's tick_inputs from each of a HostPool's workers (their
    lane ranges in order, no OutputStage state) as one: every array
    concatenated on its first axis, the word arrays zero-padded to the
    widest, win the largest.  Rows, lane_of_row and perm stay per
    worker until regroup_workers."""
    x = {k: np.concatenate(_padded(k, [p[k] for p in parts]))
         for k in parts[0] if k != "win"}
    x["win"] = max(p["win"] for p in parts)
    return x


def regroup_workers(x: dict, W: int, ln: int, mb_h: int) -> dict:
    """One tick of a HostPool's W concatenated shard blobs (ln lanes
    each, rows span-sorted per worker, lane_of_row and perm per worker)
    with its rows moved into the fleet-wide long and short buckets:
    each worker's alive I rows, which its span sort put first, go
    ahead of every other row, in a few big copies and no per-row
    permute; lane_of_row and perm become global.  Returns a new dict:
    `x` with POOL_ROW_KEYS and perm replaced."""
    NSl = ln * mb_h
    NS = W * NSl
    out = dict(x)
    # globalise per-worker row and lane indices
    out["lane_of_row"] = (
        x["lane_of_row"].reshape(W, NSl)
        + (np.arange(W, dtype=np.int32) * ln)[:, None]).reshape(-1)
    perm = x["perm"].astype(np.int64).reshape(W, -1)
    dead = perm >= NSl
    perm = perm + (np.arange(W, dtype=np.int64) * NSl)[:, None]
    perm[dead] = NS
    # bucket boundary per worker = its alive I rows
    pt = x["pic_type"].reshape(W, NSl)
    al = x["alive"].reshape(W, NSl)
    n_long = ((pt == 1) & (al != 0)).sum(axis=1)
    sel_long = np.zeros(NS, bool)
    for k in range(W):
        sel_long[k * NSl:k * NSl + n_long[k]] = True
    order = np.concatenate([np.nonzero(sel_long)[0],
                            np.nonzero(~sel_long)[0]])
    inv = np.empty(NS + 1, np.int64)
    inv[order] = np.arange(NS)
    inv[NS] = NS
    for k in POOL_ROW_KEYS:
        out[k] = np.ascontiguousarray(out[k][order])
    out["perm"] = inv[perm.reshape(-1)].astype(np.int32)
    return out
