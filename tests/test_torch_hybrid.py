"""The hybrid parser: the port's native tokenizer (tools/oracle.py) and
decode_picture_batch_hybrid against the JAX package's, and
Fleet(parser="hybrid") against the JAX fleet.

  * the port writes oracle/vlc_luts.h from its own vlc_tables copy: the
    text equals oracle/gen_luts.py's output byte for byte;
  * tokenize_batch_compact / tokenize_batch_native: every array equals
    the JAX package's on lanes of I and P pictures and an empty lane;
  * decode_picture_batch_hybrid (packed emissions scattered on the
    device, or the dense buffer; then K2F and K3F's plain forms): YUV
    and error flags equal the JAX hybrid decode over three pictures;
  * Fleet(parser="hybrid", device="cpu"): two ticks and a two-tick
    run_chunk (which goes tick by tick) with a corrupt picture, every
    TickResult field, the carries, sessions and events equal the JAX
    Fleet(parser="hybrid") on the same native-feed sessions;
  * without the tokenizer library the fleet falls back to "device";
  * on a card (gpu-marked): the hybrid decode through K2F and K3F equals
    its plain forms on the CPU, and a hybrid fleet's ticks equal the
    device parser's on the same streams.

Exact equality throughout.
"""

import subprocess
import sys

import numpy as np
import pytest
import torch

from espflix_tpu_torch.models import mpeg1 as TM
from espflix_tpu_torch.runtime import scheduler as TSCH
from espflix_tpu_torch.tools import mpeg1_encode as TE
from espflix_tpu_torch.tools import oracle as TO

try:
    from espflix_tpu.models import mpeg1 as JM
    from espflix_tpu.tools import oracle as JO
    from tests import torch_fleet as TF
except ImportError:     # the card's machine has no jax: gpu tests only
    JM = JO = TF = None

torch.set_num_threads(1)



@pytest.fixture(scope="module")
def tokenizer():
    """Both packages' tokenizer libraries, built at first use (not at
    collection)."""
    if not (TO.available() and JO.available()):
        pytest.skip("tokenizer library not buildable")


def test_luts_header_matches_gen_luts():
    ref = subprocess.run([sys.executable, str(TO.ORACLE / "gen_luts.py")],
                         capture_output=True, check=True).stdout
    assert TO.luts_header().encode() == ref
    assert TO.library_path().parent.parent == TO.BUILD_ROOT


@pytest.fixture(scope="module")
def pictures():
    """Three lanes of three pictures (I then I or P) at 96x64, and a
    fourth lane that is idle at the second picture."""
    streams = [TE.encode_es(TE.random_script(
        np.random.default_rng(s), n_pictures=3, width=96, height=64))
        for s in (11, 12, 13)]
    parsed = [TM.parse_es(s) for s in streams]
    seq = parsed[0][0]
    ticks = []
    for k in range(3):
        pics = [p[k] for _, p in parsed] + [parsed[0][1][k] if k != 1
                                            else None]
        ticks.append(pics)
    assert {p.pic_type for t in ticks for p in t if p} == {1, 2}
    return seq, ticks


def _qs(pics):
    return (np.stack([p.seq.intra_q if p else np.zeros(64, np.int32)
                      for p in pics]),
            np.stack([p.seq.non_intra_q if p else np.zeros(64, np.int32)
                      for p in pics]))


@pytest.mark.usefixtures("tokenizer")
@pytest.mark.parametrize("fn", ["tokenize_batch_compact",
                                "tokenize_batch_native"])
def test_tokenizer_matches_jax(pictures, fn):
    seq, ticks = pictures
    for pics in ticks:
        a = getattr(JM, fn)(pics, seq.mb_width, seq.mb_height)
        b = getattr(TM, fn)(pics, seq.mb_width, seq.mb_height)
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert x.dtype == y.dtype and np.array_equal(x, y)
        assert not b[-1].any() and b[-2].sum() == sum(p is not None
                                                      for p in pics)


@pytest.mark.usefixtures("tokenizer")
@pytest.mark.parametrize("compact", [True, False])
def test_hybrid_decode_matches_jax(pictures, compact):
    seq, ticks = pictures
    N = len(ticks[0])
    W, H = seq.mb_width * 16, seq.mb_height * 16
    jf = JM.init_frame_state(N, W, H)
    tf = TM.init_frame_state(N, W, H, "cpu")
    for pics in ticks:
        iq, nq = _qs(pics)
        jf, jp, ji = JM.decode_picture_batch_hybrid(
            pics, iq, nq, jf, mb_width=seq.mb_width,
            mb_height=seq.mb_height, compact=compact)
        tf, tp, ti = TM.decode_picture_batch_hybrid(
            pics, iq, nq, tf, mb_width=seq.mb_width,
            mb_height=seq.mb_height, compact=compact)
        for k in "yuv":
            assert np.array_equal(np.asarray(jp[k]), tp[k].numpy()), k
        for k in ("error", "ok", "iters"):
            assert np.array_equal(np.asarray(ji[k]), ti[k].numpy()), k
    for k in ("y", "u", "v", "parity"):
        assert np.array_equal(np.asarray(jf[k]), tf[k].numpy()), k


def test_unpack_emissions_trash_slot():
    """Entries past a lane's count land past the buffer, a real slot
    gets its sign-extended 12-bit level."""
    emit = torch.tensor([[(5 << 12) | 0xFFF, (7 << 12) | 0x7FF, 3 << 12],
                         [(0 << 12) | 0x800, (9 << 12) | 1, (2 << 12) | 4]],
                        dtype=torch.int32)
    out = TM.unpack_emissions(emit, torch.tensor([2, 1], dtype=torch.int32),
                              1)
    want = torch.zeros((2, 384), dtype=torch.int16)
    want[0, 5], want[0, 7], want[1, 0] = -1, 2047, -2048
    assert torch.equal(out, want)


@pytest.fixture(scope="module")
def hybrid_fleets(tmp_path_factory):
    url = TF.make_service(tmp_path_factory, "svc_hybrid")
    return TF.run_both(url, TF.ticks_then_chunk, n=4, lanes=(0, 1, 3),
                       corrupt_lane=1, seed=9, parser="hybrid")


@pytest.mark.usefixtures("tokenizer")
@pytest.mark.parametrize("key", TF.RESULT_KEYS if TF else ())
def test_hybrid_fleet_results_match(hybrid_fleets, key):
    jf, jr, tf, tr = hybrid_fleets
    assert jf.parser == tf.parser == "hybrid"
    TF.assert_results_equal(jr, tr, key)


@pytest.mark.usefixtures("tokenizer")
def test_hybrid_fleet_carries_match(hybrid_fleets):
    """Frames, parity, SBC history, sessions and events; the corrupt
    picture errors lane 1 once, and the sessions ran on native feeds."""
    jf, _jr, tf, tr = hybrid_fleets
    TF.assert_carries_equal(jf, tf)
    errs = np.stack([r.errors for r in tr])
    assert errs[:, 1].sum() == 1 and not errs[:, [0, 2, 3]].any()
    assert type(tf.sessions[0].feed).__name__ == "NativeStreamFeed"


def test_hybrid_falls_back_to_device(monkeypatch):
    """Without the tokenizer library Fleet(parser="hybrid") runs the
    device parser, as the JAX Fleet does (scheduler.py:160-163)."""
    monkeypatch.setattr(TO, "available", lambda: False)
    fleet = TSCH.Fleet(1, parser="hybrid", device="cpu")
    assert fleet.parser == "device"
    with pytest.raises(ValueError):
        TSCH.Fleet(1, parser="slice", device="cpu")


@pytest.mark.gpu
def test_hybrid_decode_on_card(pictures):
    """decode_picture_batch_hybrid on CUDA frames (the emission scatter,
    K2F, K3F) equals the same decode on the CPU (plain forms)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    if not TO.available():
        pytest.skip("tokenizer library not buildable")
    seq, ticks = pictures
    N = len(ticks[0])
    W, H = seq.mb_width * 16, seq.mb_height * 16
    frames = [TM.init_frame_state(N, W, H, d) for d in ("cpu", "cuda")]
    for pics in ticks:
        iq, nq = _qs(pics)
        outs = []
        for i, fr in enumerate(frames):
            frames[i], p, info = TM.decode_picture_batch_hybrid(
                pics, iq, nq, fr, mb_width=seq.mb_width,
                mb_height=seq.mb_height)
            outs.append([p[k].cpu() for k in "yuv"] + [info["error"].cpu()])
        for a, b in zip(*outs):
            assert torch.equal(a, b)
    for k in ("y", "u", "v", "parity"):
        assert torch.equal(frames[0][k], frames[1][k].cpu()), k


@pytest.mark.gpu
def test_hybrid_fleet_matches_device_parser_on_card(tmp_path):
    """Fleet(parser="hybrid") on the card presents the device parser's
    planes and flags, tick for tick, on the same clean streams."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    if not TO.available():
        pytest.skip("tokenizer library not buildable")
    from espflix_tpu_torch.tools import serve_scenario as TSS
    TSS.generate_service(str(tmp_path), ["a", "b"], seed=7, n_gops=1)
    url = "file://" + str(tmp_path)
    runs = []
    for parser in ("hybrid", "device"):
        fleet = TSS.build_fleet(url, 8, 2, device="cuda", parser=parser)
        assert fleet.parser == parser
        runs.append([fleet.tick(decode_audio=False) for _ in range(6)])
    for a, b in zip(*runs):
        assert np.array_equal(a.video_lanes, b.video_lanes)
        assert np.array_equal(a.errors, b.errors) and not a.errors.any()
        for k in "yuv":
            assert np.array_equal(getattr(a, k), getattr(b, k)), k
    assert sum(int(r.video_lanes.sum()) for r in runs[0]) == 8 * 6
