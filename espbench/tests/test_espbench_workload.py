"""The traffic generator: the same seed gives the same inputs, another
seed other content of the same sizes."""

import numpy as np

from espbench import workload
from espbench.reference import media
from espbench.tests.tiny import tiny_cell


def _gen(seed):
    cell = tiny_cell()
    return workload.device_fed(seed, cell.cfg, cell.mix)


def _fields(t):
    return dict(es=[s.es for s in t.streams],
                audio=[b"".join(b"".join(a) for a in s.audio)
                       for s in t.streams],
                **{k: getattr(t, k) for k in (
                    "stream_of", "phase", "osd", "blend", "progress",
                    "parity", "beep_left", "starved", "checked")})


def test_same_seed_same_inputs():
    a, b = _fields(_gen(2**31 + 11)), _fields(_gen(2**31 + 11))
    for k in a:
        assert np.array_equal(np.asarray(a[k], dtype=object),
                              np.asarray(b[k], dtype=object)), k


def test_other_seed_other_content_same_sizes():
    a, b = _gen(5), _gen(6)
    assert [s.es for s in a.streams] != [s.es for s in b.streams]
    assert not np.array_equal(a.osd, b.osd)
    assert a.osd.shape == b.osd.shape and a.K == b.K
    assert len(a.streams) == len(b.streams)
    assert [len(s.audio) for s in a.streams] == \
        [len(s.audio) for s in b.streams]


def test_large_and_negative_seeds():
    for seed in (2**31 + 3, 2**40, -1):
        t = _gen(seed)
        assert t.lanes == 3 and t.K == 2


def test_lane_schedule():
    t = _gen(9)
    assert np.array_equal(t.picture(0), t.phase % t.K)
    assert np.array_equal(t.picture(1), (t.phase + 1) % t.K)
    assert set(t.checked) <= set(range(t.lanes))
    assert list(t.checked) == sorted(t.checked)


def _service(seed, root):
    cell = tiny_cell("ntsc.served")
    t = workload.sessions(seed, cell.cfg, cell.mix, str(root))
    files = {p.relative_to(root): p.read_bytes()
             for p in sorted(root.rglob("*")) if p.is_file()}
    return t, files


def test_sessions_same_seed_same_service(tmp_path):
    a, fa = _service(2**31 + 5, tmp_path / "a")
    b, fb = _service(2**31 + 5, tmp_path / "b")
    assert fa == fb and a.es == b.es and a.audio == b.audio
    for k in ("first_title", "first_gop", "next_titles", "checked"):
        assert np.array_equal(getattr(a, k), getattr(b, k))
    c, fc = _service(2**31 + 6, tmp_path / "c")
    assert c.es != a.es and fc != fa
    assert set(fc) == set(fa) and len(c.audio) == len(a.audio)


def test_a_long_title_plays_its_gops_over_and_over():
    """A title that repeats its encoded GOPs: the served stream decodes,
    picture for picture, as those GOPs played over and over, with a
    random-access point and continuing timestamps at every GOP, and its
    audio is the period's frames over and over."""
    from espbench.content import indexer, ts_demux
    from espbench.content.sbc_encode import random_frame
    rng = workload.rng_for(3, 1)
    frames = [(random_frame(rng, mode=0, bitpool=28), k * 240)
              for k in range(100)]
    video, *_rest, es = indexer.make_title(
        workload.rng_for(3, 2), n_gops=2, gop=4, audio_frames=frames,
        repeat=3, width=48, height=32)
    dm = ts_demux.demux_ts(video)
    period = media.decode_stream(es)[0]
    served = media.decode_stream(dm.video)[0]
    assert len(period) == 8 and len(served) == 24
    for j, pic in enumerate(served):
        assert all(np.array_equal(a, b) for a, b in zip(pic, period[j % 8]))
    assert [pts for _ofs, pts in dm.video_pts_marks] == \
        [k * 3000 for k in range(24)]
    audio = b"".join(c.data for c in dm.audio)
    assert audio == b"".join(f for f, _pts in frames) * 3
    seqs, first, last = indexer.scan_sequence_points(video)
    assert [p for p, _k in seqs] == [g * 4 * 3000 for g in range(6)]
    assert (first, last) == (0, 23 * 3000)
