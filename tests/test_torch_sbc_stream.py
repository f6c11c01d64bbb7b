"""models/sbc.decode_stream_batched: the port against the JAX package and
against the port's own C oracle binding (tools/oracle.SbcOracle).

Per-lane lists of SBC frames of unequal length, mono (modes 0) and
two-channel (modes 1 and 2, one lane each), decode from a fresh state
through one decode_frames_batched call (K6's plain form here): every
lane's PCM equals the JAX function's and, frame by frame, the golden
decoder's.  Exact throughout.  The `gpu` test runs K6 through the same
function at 1,024 lanes and holds it to the oracle.
"""

import numpy as np
import pytest
import torch

from espflix_tpu_torch.models import sbc as TS
from espflix_tpu_torch.tools import oracle
from espflix_tpu_torch.tools.sbc_encode import make_frame

try:
    from espflix_tpu.models import sbc as JS
except ImportError:     # the card's machine has no jax: gpu tests only
    JS = None

torch.set_num_threads(1)


def _lanes(seed, counts, channels):
    """One list of frames a lane, counts[i] frames in lane i; stereo
    lanes alternate modes 1 and 2 (one frame length for the call)."""
    rng = np.random.default_rng(seed)
    lanes = []
    for i, n in enumerate(counts):
        mode = 0 if channels == 1 else 1 + i % 2
        lanes.append([make_frame(rng.integers(0, 16, (channels, 8)),
                                 rng=rng, mode=mode,
                                 bitpool=28 if channels == 1 else 40,
                                 allocation=int(rng.random() < 0.5))
                      for _ in range(n)])
    lens = {len(f) for fr in lanes for f in fr}
    assert len(lens) == 1
    return lanes, lens.pop()


def _oracle(frames):
    dec = oracle.SbcOracle()
    out = []
    for f in frames:
        pcm, n = dec.decode_frame(f)
        assert n == len(f)
        out.append(pcm)
    return np.concatenate(out)


CASES = {"mono": (1, [9, 4, 1, 7]), "stereo": (2, [5, 2, 5])}


@pytest.fixture(scope="module", params=list(CASES))
def decoded(request):
    channels, counts = CASES[request.param]
    lanes, flen = _lanes(len(request.param), counts, channels)
    port = TS.decode_stream_batched(lanes, frame_len=flen,
                                    channels=channels, device="cpu")
    return lanes, flen, channels, port


def test_stream_matches_jax(decoded):
    lanes, flen, channels, port = decoded
    ref = JS.decode_stream_batched(lanes, frame_len=flen, channels=channels)
    assert len(port) == len(ref) == len(lanes)
    for i, (a, b) in enumerate(zip(port, ref)):
        assert a.dtype == b.dtype == np.int16 and np.array_equal(a, b), i
        assert len(a) == len(lanes[i]) * channels * TS.PCM_PER_FRAME


def test_stream_matches_oracle(decoded):
    lanes, _flen, _channels, port = decoded
    for i, frames in enumerate(lanes):
        assert np.array_equal(port[i], _oracle(frames)), i


def test_stream_rejects_a_frame_of_another_length():
    lanes, flen = _lanes(3, [2, 2], 1)
    lanes[1][1] = lanes[1][1][:-1]
    with pytest.raises(ValueError, match="lane 1 frame 1"):
        TS.decode_stream_batched(lanes, frame_len=flen, device="cpu")


@pytest.mark.gpu
def test_stream_on_card_matches_oracle():
    """K6 through decode_stream_batched at 1,024 lanes of mono frames,
    8-13 frames a lane: every lane equals the oracle frame by frame, in
    one K6 launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    distinct, flen = _lanes(5, list(range(8, 14)), 1)
    lanes = [distinct[i % len(distinct)] for i in range(1024)]
    before = TS.launches
    port = TS.decode_stream_batched(lanes, frame_len=flen, device="cuda")
    assert TS.launches == before + 1
    want = [_oracle(fr) for fr in distinct]
    for i, pcm in enumerate(port):
        assert np.array_equal(pcm, want[i % len(distinct)]), i
