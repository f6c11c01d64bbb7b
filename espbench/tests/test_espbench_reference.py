"""The reference against the port's plain forms at a tiny size.  The
test imports both; the reference imports nothing of the program."""

import numpy as np
import pytest
import torch

from espbench import workload
from espbench.reference import audio as RA
from espbench.reference import composite as RC
from espbench.reference import media
from espbench.tests.tiny import run_tiny, tiny_cell


def test_decoder_copy_decodes_as_the_ports_plain_decoder():
    from espflix_tpu_torch.core.refdec import Mpeg1Decoder
    cell = tiny_cell()
    t = workload.device_fed(21, cell.cfg, cell.mix)
    for s in t.streams:
        pics, stats = media.decode_stream(s.es)
        port = Mpeg1Decoder().decode_es(s.es)
        assert len(pics) == len(port) == len(stats) == t.K
        for (y, u, v), f in zip(pics, port):
            assert np.array_equal(y, f.y) and np.array_equal(u, f.u) \
                and np.array_equal(v, f.v)
        assert stats[0]["type"] == 1 and stats[0]["intra"] == 12 * 22
        assert stats[0]["blocks"] == 6 * 12 * 22
        assert all(st["bytes"] > 0 for st in stats)


def test_composite_copy_is_the_ports_plain_form():
    from espflix_tpu_torch.ops import composite as CO
    rng = np.random.default_rng(3)
    n = 3
    y = torch.from_numpy(rng.integers(0, 249, (n, 192, 352), np.uint8))
    u = torch.from_numpy(rng.integers(0, 256, (n, 96, 176), np.uint8))
    v = torch.from_numpy(rng.integers(0, 256, (n, 96, 176), np.uint8))
    osd = torch.from_numpy(rng.integers(0, 256, (n, 16, 80), np.uint8))
    par = torch.tensor([0, 1, 1], dtype=torch.int32)
    blend = torch.tensor([0, 17, 255], dtype=torch.int32)
    prog = torch.tensor([0, 100, 240], dtype=torch.int32)
    for pal in (False, True):
        ff, fs = RC.field_pair(y, u, v, par, osd, blend, prog, pal=pal)
        port = CO.synthesize_field_pair(y, u, v, par, osd, blend, prog,
                                        pal=pal)
        assert torch.equal(ff, port)
        tmpl, dither = CO.packed_tensors(pal, torch.device("cpu"))
        _a, _s, chk = CO.synthesize_field_pair_parts(
            y, u, v, par, osd, blend, prog, pal=pal, tmpl=tmpl,
            dither=dither)
        assert torch.equal(fs, chk)
        wrapped = (ff.to(torch.int64).sum(dim=(1, 2, 3)) + 2**31) % 2**32 \
            - 2**31
        assert torch.equal(fs.to(torch.int64), wrapped)


def test_audio_copy_is_the_ports_plain_form():
    from espflix_tpu_torch.audio.sbc import SbcDecoder
    from espflix_tpu_torch.ops import delta_sigma as DS
    from espflix_tpu_torch.runtime.chain import audio_out, beep_wave
    cell = tiny_cell()
    t = workload.device_fed(4, cell.cfg, cell.mix)
    frames = [f for a in t.streams[0].audio for f in a]
    pcm, _dec = RA.decode_frames(frames)
    port = SbcDecoder()
    assert np.array_equal(pcm, np.concatenate(
        [port.decode_frame(f)[0] for f in frames]))
    rng = np.random.default_rng(5)
    n, S = 4, 256
    p = rng.integers(-2**15, 2**15, (n, S)).astype(np.int16)
    st = rng.integers(-2**20, 2**20, (n, 3)).astype(np.int32)
    beep = np.array([0, 1, 2, 0], np.int32)
    act = np.array([True, True, False, False])
    starved = np.array([False, True, False, False])
    words, st2 = RA.audio_out(p, st, beep, act, starved)
    pw, ps = audio_out(torch.from_numpy(p), torch.from_numpy(st),
                       torch.from_numpy(beep), torch.from_numpy(act),
                       torch.from_numpy(starved),
                       torch.from_numpy(beep_wave(S)))
    assert np.array_equal(words, pw.numpy())
    assert np.array_equal(st2, ps.numpy())
    w1, s1 = RA.modulate(p, st)
    w2, s2 = DS.modulate_torch(torch.from_numpy(p), torch.from_numpy(st),
                               n_samples=S)
    assert np.array_equal(w1, w2.numpy()) and np.array_equal(s1, s2.numpy())


CHECKS = {"ntsc.chain": {"planes", "field_sum", "fields", "flags", "pdm",
                         "pdm_sum", "pdm_carry"},
          "ntsc.served": {"pts", "planes", "field_sum", "fields",
                          "audio_frames", "pdm", "pdm_sum", "pdm_carry",
                          "flags"}}
METRICS = {"ntsc.chain": {"chain_streams", "setup_s"},
           "ntsc.served": {"served_streams", "served_tick_ms_p95",
                           "setup_s"}}


@pytest.mark.parametrize("name", sorted(CHECKS))
def test_a_sound_run_is_correct(name):
    res = run_tiny(tiny_cell(name))
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert set(res["checks"]) == CHECKS[name]
    assert all(c["limit"] == 0 for c in res["checks"].values())
    assert list(res)[-1] == "checks"
    assert set(res["metrics"]) == METRICS[name]


def test_served_lanes_move_to_their_next_titles(monkeypatch):
    from espbench.entries import served
    seen = {}
    orig = served.Cell.release

    def release(self):
        seen["plays"] = [list(p) for p in self.plays]
        orig(self)
    cell = tiny_cell("ntsc.served")
    # a title of one GOP of 2 pictures ends with the first chunk
    cell.cfg["video"]["gop"] = 2
    cell.mix.update(gops=1, unique_gops=1, start_gops=1)
    monkeypatch.setattr(cell.entry.Cell, "release", release)
    res = run_tiny(cell, seconds=30.0)
    assert res["correct"], res["checks"]
    assert any(len(p) > 1 for p in seen["plays"])


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(CHECKS))
def test_a_small_cell_on_the_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import time

    from espbench import run as R
    res = R.run_cell(tiny_cell(name), 13, 0.5, False,
                     torch.device("cuda", 0), t0=time.perf_counter(),
                     log=lambda *a: None)
    assert res["correct"], res["checks"]
    assert res["device"]["platform"] == "gpu"
