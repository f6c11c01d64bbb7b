"""Composite field pair, parts form: the port (K4's plain form) vs JAX.

Same numpy inputs go through composite_pallas.synthesize_field_pair_parts
(interpret mode) and the port's synthesize_field_pair_parts, for NTSC
and PAL: act, strip and chk (incl. the template base) exactly.  The
canvas routine (field_canvas, the chain's taps) must reproduce the XLA
chain's full uint8 field pair (composite.synthesize_field_pair) and the
Pallas module's tap helpers (assemble_canvas_packed + unpack_fields).
The flip animation's wraparound blit apply_hscroll must equal
composite.apply_hscroll at the edge scrolls and at random ones.
"""

import numpy as np
import pytest
import torch

from espflix_tpu_torch.ops import composite as TCO

try:
    import jax.numpy as jnp
    from espflix_tpu.ops import composite as JCO
    from espflix_tpu.ops import composite_pallas as JCP
except ImportError:     # the card's machine has no jax: gpu tests only
    jnp = JCO = JCP = None

torch.set_num_threads(1)


def _inputs(seed, N=3):
    rng = np.random.default_rng(seed)
    y = rng.integers(0, 256, (N, 192, 352), dtype=np.uint8)
    u = rng.integers(0, 256, (N, 96, 176), dtype=np.uint8)
    v = rng.integers(0, 256, (N, 96, 176), dtype=np.uint8)
    par = rng.integers(0, 2, N).astype(np.int32)
    osd = rng.integers(0, 256, (N, 16, 80), dtype=np.uint8)
    # hidden, always-on, mid-fade and full overlays
    blend = np.array([0, -1, 17, 200][:N] + [5] * max(0, N - 4), np.int32)
    prog = rng.integers(0, 352, N).astype(np.int32)
    return y, u, v, par, osd, blend, prog


CASES = [(pal, seed) for pal in (False, True) for seed in (1, 2)]


@pytest.fixture(scope="module")
def refs():
    out = {}
    for pal, seed in CASES:
        inp = _inputs(seed)
        j = JCP.synthesize_field_pair_parts(
            *[jnp.asarray(a) for a in inp], pal=pal, interpret=True)
        tmpl, dith, _g = TCO._packed_consts(pal)
        t = TCO.synthesize_field_pair_parts(
            *[torch.from_numpy(a) for a in inp], pal=pal,
            tmpl=torch.from_numpy(tmpl),
            dither=torch.from_numpy(np.ascontiguousarray(dith)))
        out[(pal, seed)] = (inp, [np.asarray(a) for a in j],
                            [a.numpy() for a in t])
    return out


@pytest.mark.parametrize("pal,seed", CASES)
@pytest.mark.parametrize("i,name", list(enumerate(("act", "strip", "chk"))))
def test_parts_match_pallas_kernel(refs, pal, seed, i, name):
    _inp, j, t = refs[(pal, seed)]
    assert t[i].dtype == j[i].dtype and t[i].shape == j[i].shape, name
    assert np.array_equal(t[i], j[i]), name


@pytest.mark.parametrize("pal", [False, True])
def test_tap_canvas_matches_xla_field_pair(refs, pal):
    inp, _j, t = refs[(pal, 1)]
    tmpl = torch.from_numpy(TCO._packed_consts(pal)[0])
    fields = TCO.field_canvas(
        torch.from_numpy(t[0]), torch.from_numpy(t[1]), pal=pal,
        tmpl=tmpl).numpy()
    exp = np.asarray(JCO.synthesize_field_pair(
        *[jnp.asarray(a) for a in inp], pal=pal))
    assert fields.dtype == np.uint8 and np.array_equal(fields, exp)
    # chk is the canvas byte sum of both fields
    assert np.array_equal(
        t[2], fields.astype(np.int64).sum(axis=(1, 2, 3)).astype(np.int32))


@pytest.mark.parametrize("pal", [False, True])
def test_assemble_and_unpack_match_jax(refs, pal):
    _inp, j, _t = refs[(pal, 2)]
    tmpl = TCO._packed_consts(pal)[0]
    jc = np.asarray(JCP.unpack_fields(JCP.assemble_canvas_packed(
        jnp.asarray(j[0]), jnp.asarray(j[1]), pal=pal)))
    tc = TCO.field_canvas(
        torch.from_numpy(np.array(j[0])), torch.from_numpy(np.array(j[1])),
        pal=pal, tmpl=torch.from_numpy(tmpl)).numpy()
    assert np.array_equal(tc, jc)


HSCROLL_CASES = {
    "zero_and_small": [0, 1, -1, 2, -2, 175],
    "half_and_edges": [-175, 351, -351, 352, -352, 0],
    "random1": 1,
    "random2": 2,
}


@pytest.mark.parametrize("case", list(HSCROLL_CASES))
def test_apply_hscroll_matches_jax(case):
    hs = HSCROLL_CASES[case]
    rng = np.random.default_rng(len(case))
    if isinstance(hs, int):
        hs = np.random.default_rng(hs).integers(-352, 353, 6)
    hs = np.asarray(hs, np.int32)
    planes = [rng.integers(0, 256, (6,) + shp, dtype=np.uint8)
              for shp in ((192, 352), (96, 176), (96, 176)) * 2]
    j = JCO.apply_hscroll(*[jnp.asarray(a) for a in planes],
                          jnp.asarray(hs))
    t = TCO.apply_hscroll(*[torch.from_numpy(a) for a in planes],
                          torch.from_numpy(hs))
    for a, b in zip(t, j):
        a, b = a.numpy(), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.array_equal(a, b)
    # hscroll 0 shows the primary frame, +-352 the secondary one
    for lane, h in enumerate(hs):
        if h == 0:
            assert np.array_equal(t[0][lane].numpy(), planes[0][lane])
        if abs(h) == 352:
            assert np.array_equal(t[0][lane].numpy(), planes[3][lane])


def test_ease_table_matches_jax():
    assert np.array_equal(TCO.EASE, JCO.EASE)
    assert TCO.EASE.dtype == JCO.EASE.dtype


@pytest.mark.gpu
@pytest.mark.parametrize("pal,seed", CASES)
def test_kernel_matches_plain_on_card(pal, seed):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    tmpl, dith, _g = TCO._packed_consts(pal)
    args = [torch.from_numpy(a) for a in _inputs(seed)]
    consts = dict(tmpl=torch.from_numpy(tmpl),
                  dither=torch.from_numpy(np.ascontiguousarray(dith)))
    got = TCO.synthesize_field_pair_parts(
        *[a.cuda() for a in args], pal=pal,
        **{k: v.cuda() for k, v in consts.items()})
    ref = TCO.synthesize_field_pair_parts(*args, pal=pal, **consts)
    for a, b in zip(got, ref):
        assert torch.equal(a.cpu(), b)
