"""The full chain's chunk layout (runtime/chunk_layout.py) on the CPU.

  * stack_chunk, in device windows and in host windows: ticks of
    unequal word and SBC widths are zero-padded to the chunk's widest
    and stacked in the chain's key order, win the ticks' largest;
  * regroup_workers on two worker shards, an idle lane in each, each
    packed as a HostPool worker packs and joined as the pool joins
    them: every alive I row comes ahead of every other row, lane_of_row
    is global, and through perm each (lane, MB row) reaches the row
    words, start bit and rows of the single-process packing of the same
    pictures, or no row where that packing has none;
  * the program's assembly of a small device-fed chunk of the
    benchmark's ntsc.chain cell equals espbench.entries.chain.build_xs,
    key for key and byte for byte.
"""

import numpy as np
import pytest

from espflix_tpu_torch.models import mpeg1 as M
from espflix_tpu_torch.models import sbc as dsbc
from espflix_tpu_torch.ops import scan_dense as SD
from espflix_tpu_torch.ops import vlc_scan as VS
from espflix_tpu_torch.runtime import chunk_layout as CL
from espflix_tpu_torch.runtime.workload import bench_pictures

LANES = 8
W = 2                   # worker shards
TICK = 1                # a tick with I and P pictures in each shard

KEY_ORDER = ("start_bits", "rows", "alive", "pic_type", "full_pel",
             "r_size", "lane_of_row", "perm", "intra_q", "non_intra_q",
             "active", "osd", "blend", "progress", "parity", "hscroll",
             "beep_left", "aud_words", "aud_act", "aud_nval", "starved")


@pytest.fixture(scope="module")
def pictures():
    ticks, wpl = bench_pictures(LANES, n_pictures=4, distinct=4)
    return ticks, wpl


def _pack(pics, wpl, dw):
    mbh = next(p for p in pics if p).seq.mb_height
    b = M.make_picture_batch(pics, words_per_lane=wpl, max_slices=mbh)
    sl = VS.pack_slice_rows(b, sort_rows=True, device_windows=dw)
    perm, dup = SD.row_perm(sl["lane_of_row"], sl["rows"], sl["alive"],
                            len(pics), mbh)
    assert not dup.any() and not sl["overflow"].any()
    return sl, perm, b


def _audio(rng, n, width):
    return (rng.integers(0, 2 ** 32, (n, 2, width), dtype=np.uint32),
            rng.random(n) < 0.5, rng.integers(0, 3, n).astype(np.int32),
            rng.random(n) < 0.5)


def _snap(rng, n):
    return dict(osd=rng.integers(0, 256, (n, 16, 80), dtype=np.uint8),
                **{k: rng.integers(0, 9, n).astype(np.int32)
                   for k in ("blend", "progress", "parity", "hscroll",
                             "beep_left")})


@pytest.mark.parametrize("dw", [True, False], ids=["device", "host"])
def test_stack_chunk_pads_and_stacks_in_key_order(pictures, dw):
    ticks, wpl = pictures
    rng = np.random.default_rng(5)
    # tick 3 holds no I picture: narrower words than tick 1's
    xs_t = [CL.tick_inputs(*_pack(ticks[k], wpl, dw), _snap(rng, LANES),
                           _audio(rng, LANES, width))
            for k, width in ((TICK, 7), (3, 12))]
    wkey = "lane_words" if dw else "words"
    widths = [x[wkey].shape[1] for x in xs_t]
    assert widths[0] != widths[1]
    stacked, win = CL.stack_chunk(xs_t)
    lead = ("lane_words", "row_base") if dw else ("words",)
    assert tuple(stacked) == lead + KEY_ORDER
    assert win == (max(x["win"] for x in xs_t) if dw else 0) \
        and (win > 0) == dw
    for key, width in ((wkey, max(widths)), ("aud_words", 12)):
        a = stacked[key]
        assert a.shape == (2,) + xs_t[0][key].shape[:-1] + (width,)
        for t, x in enumerate(xs_t):
            w = x[key].shape[-1]
            assert a.dtype == x[key].dtype
            assert np.array_equal(a[t, ..., :w], x[key])
            assert not a[t, ..., w:].any()
    for key in stacked:
        if key not in (wkey, "aud_words"):
            assert np.array_equal(stacked[key],
                                  np.stack([x[key] for x in xs_t])), key


def test_regroup_workers_matches_the_single_process_pack(pictures):
    ticks, wpl = pictures
    pics = list(ticks[TICK])
    mbh = pics[0].seq.mb_height
    pics[2] = pics[6] = None        # an idle lane a shard: dead MB rows
    ln = LANES // W
    rng = np.random.default_rng(6)
    audio = _audio(rng, LANES, 4)
    parts = [CL.tick_inputs(*_pack(pics[k * ln:(k + 1) * ln], wpl, True),
                            {}, [a[k * ln:(k + 1) * ln] for a in audio])
             for k in range(W)]
    n_i = [sum(p is not None and p.pic_type == 1
               for p in pics[k * ln:(k + 1) * ln]) for k in range(W)]
    assert min(n_i) >= 1 and max(n_i) < ln
    g = CL.join_workers(parts)
    r = CL.regroup_workers(g, W, ln, mbh)
    one, perm1, _b = _pack(pics, wpl, True)
    NS = LANES * mbh
    # every alive I row ahead of every other row
    is_i = (r["pic_type"] == 1) & (r["alive"] != 0)
    n_long = int(is_i.sum())
    assert n_long == sum(n_i) * mbh and is_i[:n_long].all()
    # lane_of_row global; the rows a permutation of the global pack's
    assert np.array_equal(np.sort(r["lane_of_row"]),
                          np.sort(one["lane_of_row"]))
    for k in CL.POOL_ROW_KEYS:
        assert r[k].shape == one[k].shape, k
    assert r["perm"].shape == perm1.shape
    assert np.array_equal(r["lane_words"][:, :one["lane_words"].shape[1]],
                          one["lane_words"][:, :r["lane_words"].shape[1]])

    def window(x, row, w):
        lane_words = np.pad(x["lane_words"], ((0, 0), (0, w)))
        base = x["row_base"][row]
        return lane_words[x["lane_of_row"][row], base:base + w]

    w = min(g["win"], one["win"])
    assert (perm1 == NS).sum() == 2 * mbh
    for slot in range(NS):
        a, b = r["perm"][slot], perm1[slot]
        assert (a == NS) == (b == NS), slot
        if b == NS:
            continue
        assert r["lane_of_row"][a] == one["lane_of_row"][b] == slot // mbh
        for k in ("start_bits", "rows", "alive", "pic_type", "full_pel",
                  "r_size"):
            assert r[k][a] == one[k][b], (slot, k)
        assert np.array_equal(window(r, a, w), window(one, b, w)), slot
    # the per-lane arrays pass through in lane order
    for k in ("intra_q", "non_intra_q", "active") + CL.AUDIO_KEYS:
        assert np.array_equal(r[k], np.concatenate([p[k] for p in parts]))


def test_device_fed_chunk_equals_the_benchmarks_build_xs():
    from espbench import workload
    from espbench.entries.chain import build_xs
    from espbench.tests.tiny import tiny_cell
    cell = tiny_cell("ntsc.chain")
    t = workload.device_fed(29, cell.cfg, cell.mix)
    mbh = (cell.cfg["video"]["height"] + 15) >> 4
    want, want_win, want_long = build_xs(t, mbh)

    pics = [M.parse_es(s.es)[1] for s in t.streams]
    wpl = max(max((len(p.payload) + 3) // 4 + 4 for p in ps) for ps in pics)
    F = len(t.streams[0].audio[0])
    xs_t, need_long = [], 8
    for k in range(t.K):
        pk = t.picture(k)
        sl, perm, b = _pack([pics[s][j] for s, j in zip(t.stream_of, pk)],
                            wpl, True)
        need_long = max(need_long, int(((b["pic_type"] == 1)
                                        & b["active"]).sum()) * mbh)
        words = np.stack([dsbc.frames_to_words(np.frombuffer(
            b"".join(t.streams[s].audio[j]), np.uint8).reshape(1, F, -1))[0]
            for s, j in zip(t.stream_of, pk)])
        snap = dict(osd=t.osd[k], blend=t.blend[k], progress=t.progress[k],
                    parity=t.parity[k], beep_left=t.beep_left[k])
        xs_t.append(CL.tick_inputs(
            sl, perm, b, snap, (words, np.ones(t.lanes, bool),
                                np.full(t.lanes, F, np.int32),
                                t.starved[k])))
    got, win = CL.stack_chunk(xs_t)
    assert (win, need_long) == (want_win, want_long) and win > 0
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert got[k].shape == want[k].shape, k
        assert got[k].tobytes() == want[k].tobytes(), k
