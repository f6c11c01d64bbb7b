"""The yardstick's arithmetic on synthetic numbers: streams, the 95th
percentile over all ticks, idle share and gaps, the byte roofline on a
hand-counted tick."""

import statistics
import types

import numpy as np
import pytest

from espbench import roofline, stats
from espbench.manifest import Benchmark


def test_streams():
    # 8,192 lanes x 12 ticks in 4 s at 30 ticks/s
    assert stats.streams(8192 * 12, 4.0, 30) == pytest.approx(819.2)


def test_p95_over_all_ticks_not_chunk_medians():
    ticks = list(range(1, 101))           # 100 ticks, 1..100 ms
    assert stats.percentile(ticks, 95) == pytest.approx(
        np.percentile(ticks, 95))
    chunks = [statistics.median(ticks[i:i + 4]) for i in range(0, 100, 4)]
    assert stats.percentile(ticks, 95) != stats.percentile(chunks, 95)
    assert stats.percentile([7.0], 95) == 7.0


def test_spread_is_iqr_over_median():
    v = [1.0, 2.0, 3.0, 4.0, 5.0, 6.0]
    q1, med, q3 = statistics.quantiles(v, n=4)
    assert stats.spread(v) == pytest.approx((q3 - q1) / med)


def test_union_idle_share_and_gaps():
    window = (0.0, 10.0)
    busy = [(1.0, 3.0), (2.0, 4.0), (6.0, 7.0), (9.5, 12.0)]
    assert stats.merge(busy) == [(1.0, 4.0), (6.0, 7.0), (9.5, 12.0)]
    assert stats.busy_s(busy, window) == pytest.approx(4.5)
    assert stats.idle_pct(busy, window) == pytest.approx(55.0)
    gaps = stats.gaps(busy, window)
    assert gaps == [(7.0, 9.5), (4.0, 6.0), (0.0, 1.0)]
    spans = [(3.5, 9.9, "espbench.enqueue"), (6.5, 9.0, "espbench.sync")]
    assert stats.label(gaps[0], spans) == "espbench.sync"
    assert stats.label(gaps[2], spans) == "none"


def test_roofline_bytes_of_a_hand_counted_tick():
    # one picture: 100 coded bytes, 3 coded blocks, 2 predicted and 1
    # copied macroblock, 4 macroblocks in all
    st = dict(bytes=100, blocks=3, pred=2, copy=1)
    scan = 100 + 3 * 128 + 4 * 8
    idct = 2 * 3 * 128
    compose = 3 * 384 + 3 * 128 + 4 * 384
    assert roofline.picture_bytes(st, 4) == scan + idct + compose
    cfg = {"frames_per_tick": 2, "audio": {"channels": 1},
           "standard": "ntsc"}
    samples = 2 * 128
    composite = 4 * 384 + 16 * 80 + 12 + 4
    sbc = 2 * 64 + 2 * samples
    pdm = 2 * samples + 4 * samples
    assert roofline.output_bytes(cfg, 4, 64) == composite + sbc + pdm
    assert roofline.tap_bytes(cfg) == 2 * 262 * 912


def test_roofline_of_a_chunk_and_its_reader():
    cfg = {"frames_per_tick": 1, "audio": {"channels": 1},
           "standard": "pal", "video": {"width": 32, "height": 16}}
    st = dict(bytes=10, blocks=1, pred=0, copy=0)
    ref = [(None, [st, st]), (None, [st, st])]
    t = types.SimpleNamespace(
        K=2, lanes=3, stream_of=np.array([0, 1, 0]),
        checked=np.array([1]),
        streams=[types.SimpleNamespace(audio=[[b"x" * 64]])])
    pic = roofline.picture_bytes(st, 2)
    want = 3 * 2 * pic + 2 * 3 * roofline.output_bytes(cfg, 2, 64) \
        + 2 * 1 * roofline.tap_bytes(cfg)
    assert roofline.chunk_bytes(ref, t, cfg) == want
    reader = Benchmark().reader("kernels_roofline")
    prof = types.SimpleNamespace(
        stretch=(0.0, 1.0),
        device=[(0.0, 0.25, "k1", "kernel"), (0.5, 0.75, "k2", "kernel"),
                (0.8, 0.9, "Memcpy", "gpu_memcpy")])
    n = int(3.35e12 * 0.1)             # 0.1 s at the peak
    assert reader.read({"profile": prof, "bytes": n}) == \
        pytest.approx(100 * 0.1 / 0.5)
    assert reader.read({"profile": prof}) is None
    idle = Benchmark().reader("device_idle_pct.chain")
    assert idle.read({"profile": prof}) == pytest.approx(40.0)
