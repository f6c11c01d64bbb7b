"""The trick cell's content, schedule and check on the CPU.

- content/trick.make_title: the trick streams open on a sequence header
  and an I picture, every GOP is three pictures (I P P) and closed, and
  video.idx holds, for each stream, its first and last PTS and the
  nearest sequence point to each bin, as a scan of the stream finds
  them;
- content/trick.draw_lanes at the cell's size: the groups' sizes, the
  tapped lanes in each, and the seeks a tick and the share of lane-ticks
  in trick play the schedule implies;
- the cell at a tiny size: a run reads correct with keys sent, plays
  reopened and every count 0; its control, and a program that drops the
  keys, read false.
"""

import copy

import numpy as np
import pytest
import torch

from espbench.content import trick as content
from espbench.content.sbc_encode import random_frame
from espbench.manifest import Benchmark
from espbench.reference import trick as RT

PER = 3000


@pytest.fixture(scope="module")
def title():
    arng = np.random.default_rng(5)
    audio = [(random_frame(arng, mode=0, bitpool=28), k * 240)
             for k in range(3 * 4 * PER // 240)]
    return content.make_title(np.random.default_rng(6),
                              np.random.default_rng(7), audio, n_gops=3,
                              gop=4, repeat=15, trick_unique=2)


def _picture_types(es: bytes) -> list:
    out, i = [], es.find(b"\x00\x00\x01\x00")
    while i >= 0:
        out.append((es[i + 5] >> 3) & 7)
        i = es.find(b"\x00\x00\x01\x00", i + 4)
    return out


def test_trick_streams_are_closed_gop3_from_a_sequence_header(title):
    files, (_m, fwd, rwd) = title
    for es in (fwd, rwd):
        assert es.startswith(b"\x00\x00\x01\xb3")
        assert _picture_types(es) == [1, 2, 2] * 2
        # each GOP its own sequence header, closed (closed_gop bit)
        assert es.count(b"\x00\x00\x01\xb3") == 2
        i = es.find(b"\x00\x00\x01\xb8")
        assert es[i + 7] & 0x40
    for name in ("video_fwd.ts", "video_rwd.ts"):
        points, last = RT.sequence_points(files[name])
        assert len(points) == 12 // 3 and min(points) == 0
        assert sorted(points.values()) == [0, 9000, 18000, 27000]
        assert last == 11 * PER


def test_index_agrees_with_a_scan_of_each_stream(title):
    files, _es = title
    idx = RT.Index(files["video.idx"])
    base = 0
    for speed, name, speed_rec in ((0, "video.ts", 1),
                                   (1, "video_fwd.ts", 15),
                                   (-1, "video_rwd.ts", 15)):
        points, last = RT.sequence_points(files[name])
        first, last_rec, bin_size, trick_speed, n = idx.rec[speed]
        assert (first, last_rec, bin_size, trick_speed) == \
            (0, last, 7500, speed_rec)
        assert n == last // bin_size + 1
        pts = np.array(sorted(points.values()))
        pkt = {v: k for k, v in points.items()}
        samples = np.frombuffer(files["video.idx"], "<u4",
                                n, RT.HDR_SIZE + 4 * base)
        for b, q in enumerate(samples):
            near = pts[np.abs(pts - b * bin_size).argmin()]
            assert q == pkt[int(near)]
        base += n


def test_schedule_shares_at_the_cells_size():
    bench = Benchmark()
    mix = bench.cell("ntsc.trick").mix
    lanes = content.draw_lanes(2**31 + 11, mix)
    trick, skip = lanes["trick"], lanes["skip"]
    assert len(trick) == 256 and len(skip) == 102
    assert not set(trick) & set(skip)
    tap = set(lanes["checked"].tolist())
    assert len(tap) == 16
    assert len(tap & set(trick)) >= 4 and len(tap & set(skip)) >= 4
    assert len(tap - set(trick) - set(skip)) >= 4
    K = mix["ticks_per_chunk"]
    cycle_ticks = 2 * (mix["ff_ticks"] + mix["play_ticks"])
    seeks = 4 * len(trick) / cycle_ticks + len(skip) / \
        mix["skip_every_ticks"]
    assert 3.5 <= seeks <= 4.0
    share = len(trick) * 2 * mix["ff_ticks"] / cycle_ticks / mix["lanes"]
    assert 0.19 <= share <= 0.20
    assert lanes["trick_phase"].max() < cycle_ticks // K


def tiny_trick_cell():
    """ntsc.trick at 6 lanes (2 in trick play, 2 skipping), 2 titles of
    45 GOPs of 4 (3 encoded GOPs) with trick streams of 12 pictures,
    chunks of 2 ticks, one SBC frame a tick; a cycle of 6 chunks."""
    cell = Benchmark().cell("ntsc.trick")
    cell.cfg = copy.deepcopy(cell.cfg)
    cell.cfg["video"]["gop"] = 4
    cell.cfg["trick"]["unique_gops"] = 2
    cell.cfg["frames_per_tick"] = 1
    cell.mix = dict(cell.mix, lanes=6, titles=2, gops=45, unique_gops=3,
                    start_gops=2, hops=4, trick_lanes=2, skip_lanes=2,
                    check_per_group=[1, 1, 1], ticks_per_chunk=2,
                    ff_ticks=4, play_ticks=2, skip_every_ticks=6,
                    warm_chunks=1)
    return cell


def _tiny_run(chunks: int, control: bool = False) -> dict:
    """Set-up (one warm chunk), `chunks` - 1 more chunks, release and the
    check, as espbench.run does, on the CPU; a fixed number of chunks in
    place of a window's seconds.  Returns {check: value}."""
    cell = tiny_trick_cell()
    run = cell.entry.Cell(cell.cfg, cell.mix, 2**31 + 7, torch.device("cpu"),
                          False)
    for _ in range(chunks - 2):
        run._run()
    run.last = run._run()[0]
    run.release()
    if control:
        run.substitute_control()
    return {k: v for k, (v, _lim) in run.check().items()}


def test_a_tiny_run_is_correct_through_keys_and_reopens(monkeypatch):
    sent = []
    from espflix_tpu_torch.runtime.scheduler import Fleet
    apply = Fleet.apply_keys

    def spy(self, keys):
        sent.append(dict(keys))
        return apply(self, keys)
    monkeypatch.setattr(Fleet, "apply_keys", spy)
    checks = _tiny_run(7)
    assert not any(checks.values()), checks
    assert len(sent) == 7 and sum(map(len, sent)) >= 6
    assert set(checks) >= {"pts", "landing", "ends", "keys", "trick_sbc",
                           "planes", "pdm"}


def test_control_fails():
    checks = _tiny_run(2, control=True)
    assert checks["planes"] > 0 and checks["field_sum"] > 0


def test_dropped_keys_are_not_correct(monkeypatch):
    from espflix_tpu_torch.runtime.scheduler import Fleet
    monkeypatch.setattr(Fleet, "apply_keys", lambda self, keys: None)
    checks = _tiny_run(2)
    assert checks["landing"] + checks["pts"] > 0
