"""K3P on the shared edge cases (tools/predict_cases.py): its plain forms
vs the JAX package on the CPU, and the kernel vs the plain forms on the
card.

Each case -- a plane one MB wide, a small one and the bench's 352x192,
luma (S = 16) and chroma (S = 8), 7 lanes, vectors at and one past
every edge with every half-pel phase, windows whose rule-B taps cross
each of the four edges -- goes through:

  * mocomp.predict_plane_mxu (rule A: clamped window origin, zero past
    the plane) against predict_plane_torch, exactly;
  * mocomp.predict_plane_rows (rule B: every tap clamped into the
    plane) against predict_plane_rows_torch on bands at the first MB
    row, in the middle, at the last MB row and over the whole plane,
    exactly;
  * on the card (`gpu`): K3P (predict_plane, predict_chroma_pair -- both
    chroma planes in one launch -- and predict_plane_rows) against those
    plain forms, and its wrapper's refusal of a reference that is not
    4-byte aligned.
"""

import numpy as np
import pytest
import torch

from espflix_tpu_torch.ops import mocomp as TMC
from espflix_tpu_torch.tools.predict_cases import (SHAPES, bands,
                                                   edge_crossings,
                                                   predict_case)

try:
    import jax.numpy as jnp
    from espflix_tpu.ops import mocomp as JMC
except ImportError:     # the card's machine has no jax: gpu tests only
    jnp = JMC = None

torch.set_num_threads(1)

IDS = [f"{w}x{h}" for w, h in SHAPES]
# the JAX references on the CPU: the small plane (bands of every kind
# and every edge crossed), and the one-MB-wide one for rule A
CPU_SHAPES = SHAPES[:2]


def _case(S, shape):
    return predict_case(300 + S + SHAPES.index(shape), S, *shape)


def _t(a, device="cpu"):
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


@pytest.mark.parametrize("S", [16, 8])
def test_cases_cover_the_edges(S):
    """Every edge is crossed under rule B and every half-pel phase
    stays inside somewhere; the lane count is not a multiple of 4."""
    c = _case(S, SHAPES[1])
    counts = edge_crossings(c)
    assert all(counts[k] > 0 for k in counts), counts
    assert c["ref"].shape[0] % 4 != 0
    assert {r for r, _ in bands(4)} == {0, 2, 3}


@pytest.mark.parametrize("S", [16, 8])
@pytest.mark.parametrize("shape", CPU_SHAPES, ids=IDS[:2])
def test_rule_a_matches_predict_plane_mxu(S, shape):
    c = _case(S, shape)
    j = np.asarray(JMC.predict_plane_mxu(
        *(jnp.asarray(c[k]) for k in ("ref", "mv_h", "mv_v")), S))
    t = TMC.predict_plane_torch(*(_t(c[k]) for k in ("ref", "mv_h",
                                                      "mv_v")), S)
    assert np.array_equal(t.numpy(), j)


@pytest.mark.parametrize("S", [16, 8])
def test_rule_b_matches_predict_plane_rows(S):
    c = _case(S, SHAPES[1])
    for row0, rows in bands(c["mb_height"]):
        mh = c["mv_h"][:, row0:row0 + rows]
        mv = c["mv_v"][:, row0:row0 + rows]
        j = np.asarray(JMC.predict_plane_rows(
            jnp.asarray(c["ref"]), jnp.asarray(mh), jnp.asarray(mv), S,
            row0))
        t = TMC.predict_plane_rows_torch(_t(c["ref"]), _t(mh), _t(mv), S,
                                         row0)
        assert np.array_equal(t.numpy(), j), (row0, rows)


def test_cpu_call_launches_nothing():
    c = _case(8, SHAPES[1])
    before = TMC.launches_predict
    args = [_t(c[k]) for k in ("ref", "mv_h", "mv_v")]
    assert torch.equal(TMC.predict_plane(*args, 8),
                       TMC.predict_plane_torch(*args, 8))
    assert torch.equal(TMC.predict_plane_rows(*args, 8),
                       TMC.predict_plane_rows_torch(*args, 8))
    pair = TMC.predict_chroma_pair(args[0], args[0].flip(2), *args[1:])
    want = TMC.predict_chroma_pair_torch(args[0], args[0].flip(2),
                                         *args[1:])
    assert all(torch.equal(a, b) for a, b in zip(pair, want))
    assert TMC.launches_predict == before


@pytest.mark.gpu
@pytest.mark.parametrize("S", [16, 8])
@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_predict_kernel_matches_plain_on_card(S, shape):
    """K3P against its plain forms on the card: rule A over the whole
    plane (and both chroma planes in predict_chroma_pair), rule B on
    every band; one launch a plane."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    c = _case(S, shape)
    ref, mh, mv = (_t(c[k]) for k in ("ref", "mv_h", "mv_v"))
    ref_k, mh_k, mv_k = (t.cuda() for t in (ref, mh, mv))
    before = TMC.launches_predict
    got = TMC.predict_plane(ref_k, mh_k, mv_k, S)
    assert TMC.launches_predict == before + 1
    assert torch.equal(got.cpu(), TMC.predict_plane_torch(ref, mh, mv, S))
    if S == 8:
        ref2 = torch.flip(ref, dims=(2,)).contiguous()
        before = TMC.launches_predict
        pu, pv = TMC.predict_chroma_pair(ref_k, ref2.cuda(), mh_k, mv_k)
        assert TMC.launches_predict == before + 1
        assert torch.equal(pu.cpu(), TMC.predict_plane_torch(ref, mh, mv, 8))
        assert torch.equal(pv.cpu(),
                           TMC.predict_plane_torch(ref2, mh, mv, 8))
    for row0, rows in bands(c["mb_height"]):
        b = (slice(None), slice(row0, row0 + rows))
        mhb, mvb = mh[b].contiguous(), mv[b].contiguous()
        got = TMC.predict_plane_rows(ref_k, mhb.cuda(), mvb.cuda(), S, row0)
        want = TMC.predict_plane_rows_torch(ref, mhb, mvb, S, row0)
        assert torch.equal(got.cpu(), want), (row0, rows)


@pytest.mark.gpu
def test_predict_kernel_refuses_misaligned_reference_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    c = _case(16, SHAPES[1])
    N, H, W = c["ref"].shape
    flat = torch.zeros(N * H * W + 1, dtype=torch.uint8, device="cuda")
    ref = flat[1:].view(N, H, W)
    mh, mv = _t(c["mv_h"], "cuda"), _t(c["mv_v"], "cuda")
    with pytest.raises(ValueError):
        TMC.predict_plane(ref, mh, mv, 16)
