"""The full-canvas composite functions: the port against the JAX package
and against the port's own C oracle binding (tools/oracle.composite_field).

ops/composite.synthesize_field_pair, synthesize_field,
synthesize_field_scrolled and synthesize_active are K4's pair (its plain
form here) laid into the line templates by field_canvas.  On the same
numpy inputs they equal espflix_tpu.ops.composite's functions byte for
byte, NTSC and PAL, on lanes of every OSD blend class (always shown,
hidden, a fade, full) and both parities, with slides both ways and none;
synthesize_field equals the golden composite_field lane by lane.  The
`gpu` test holds the four on the card to their plain forms.
"""

import numpy as np
import pytest
import torch

from espflix_tpu_torch.ops import composite as TCO
from espflix_tpu_torch.tools import oracle

try:
    import jax.numpy as jnp
    from espflix_tpu.ops import composite as JCO
except ImportError:     # the card's machine has no jax: gpu tests only
    jnp = JCO = None

torch.set_num_threads(1)

# always shown, hidden, a fade, full; then a fade near its end
BLENDS = [-1, 0, 17, 200, 1]


def _inputs(seed, N=len(BLENDS)):
    rng = np.random.default_rng(seed)
    y = rng.integers(0, 256, (N, 192, 352), dtype=np.uint8)
    u = rng.integers(0, 256, (N, 96, 176), dtype=np.uint8)
    v = rng.integers(0, 256, (N, 96, 176), dtype=np.uint8)
    par = (np.arange(N) % 2).astype(np.int32)
    osd = rng.integers(0, 256, (N, 16, 80), dtype=np.uint8)
    blend = np.resize(np.array(BLENDS, np.int32), N)
    prog = np.resize(np.array([0, 240, 77, 1, 160], np.int32), N)
    return y, u, v, par, osd, blend, prog


def _second(seed, N=len(BLENDS)):
    rng = np.random.default_rng(seed + 100)
    return (rng.integers(0, 256, (N, 192, 352), dtype=np.uint8),
            rng.integers(0, 256, (N, 96, 176), dtype=np.uint8),
            rng.integers(0, 256, (N, 96, 176), dtype=np.uint8),
            np.resize(np.array([0, 8, -344, 175, -1], np.int32), N))


def _t(arrays, dev="cpu"):
    return [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
            for a in arrays]


def _j(arrays):
    return [jnp.asarray(a) for a in arrays]


STANDARDS = [False, True]


@pytest.mark.parametrize("pal", STANDARDS, ids=["ntsc", "pal"])
def test_field_pair_and_field_match_jax(pal):
    """The pair, and synthesize_field as the pair's field 0 (which the
    JAX package pins equal to its synthesize_field)."""
    inp = _inputs(1)
    pair = TCO.synthesize_field_pair(*_t(inp), pal=pal).numpy()
    exp = np.asarray(JCO.synthesize_field_pair(*_j(inp), pal=pal))
    assert pair.dtype == exp.dtype == np.uint8 and pair.shape == exp.shape
    assert np.array_equal(pair, exp)
    field = TCO.synthesize_field(*_t(inp), pal=pal).numpy()
    assert np.array_equal(field, exp[:, 0])


@pytest.mark.parametrize("pal", STANDARDS, ids=["ntsc", "pal"])
def test_field_scrolled_matches_jax(pal):
    inp = _inputs(2)
    y2, u2, v2, hs = _second(2)
    args = inp[:3] + (y2, u2, v2, hs) + inp[3:]
    got = TCO.synthesize_field_scrolled(*_t(args), pal=pal).numpy()
    exp = np.asarray(JCO.synthesize_field_scrolled(*_j(args), pal=pal))
    assert got.dtype == exp.dtype and np.array_equal(got, exp)


@pytest.mark.parametrize("pal", STANDARDS, ids=["ntsc", "pal"])
def test_active_matches_jax(pal):
    y, u, v, par, *_ = _inputs(3)
    got = TCO.synthesize_active(*_t((y, u, v, par)), pal=pal).numpy()
    exp = np.asarray(JCO.synthesize_active(*_j((y, u, v, par)), pal=pal))
    assert got.dtype == exp.dtype and got.shape == exp.shape == (5, 192, 704)
    assert np.array_equal(got, exp)


@pytest.mark.parametrize("pal", STANDARDS, ids=["ntsc", "pal"])
def test_field_matches_oracle(pal):
    inp = _inputs(4)
    got = TCO.synthesize_field(*_t(inp), pal=pal).numpy()
    y, u, v, par, osd, blend, prog = inp
    for i in range(len(y)):
        want = oracle.composite_field(y[i], u[i], v[i], par[i], pal,
                                      osd[i], blend[i], prog[i])
        assert np.array_equal(got[i], want), i


@pytest.mark.gpu
@pytest.mark.parametrize("pal", STANDARDS, ids=["ntsc", "pal"])
def test_full_canvases_on_card_match_plain(pal):
    """The four functions through K4 at 1,024 lanes (the blend classes
    tiled, a slide on most lanes) equal their plain forms on every 7th
    lane."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    N = 1024
    inp = _inputs(5, N)
    y2, u2, v2, _hs = _second(5, N)
    hs = np.random.default_rng(6).integers(-352, 353, N).astype(np.int32)
    scrolled = inp[:3] + (y2, u2, v2, hs) + inp[3:]
    lanes = slice(0, N, 7)      # both parities, every blend class
    for fn, args in ((TCO.synthesize_field_pair, inp),
                     (TCO.synthesize_field, inp),
                     (TCO.synthesize_field_scrolled, scrolled),
                     (TCO.synthesize_active, inp[:4])):
        before = TCO.launches
        got = fn(*_t(args, "cuda"), pal=pal).cpu()
        assert TCO.launches == before + 1, fn.__name__
        want = fn(*_t([a[lanes] for a in args]), pal=pal)
        assert torch.equal(got[lanes], want), fn.__name__
