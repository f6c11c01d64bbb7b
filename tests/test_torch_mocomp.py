"""Prediction + compose + put: the port (K3's plain form) vs the JAX package.

The port predicts with the main path's edge rule (window origin
clip(xh >> 1, 0, W - S), zero past the plane) and fuses compose and the
parity put.  References, same numpy inputs:

  * mocomp.predict_plane_mxu (the CPU default of dense_compose) and the
    TPU default kernels predict_plane_phase2p / predict_chroma_pair_
    packedp(accum=True), in interpret mode, including out-of-frame and
    edge half-pel motion vectors;
  * every other mocomp_pallas variant that computes predict_plane, and
    the fused compose_plane_pallas / compose_plane_pallas2, on in-frame
    vectors (extra references for the one Hopper kernel, K3);
  * models/mpeg1.dense_compose on the coeffs_T path: STALE / SKIP /
    INTER / INTRA mixes, inactive lanes and random parities, comparing
    the new frames, the parity and the presented planes.

The lane-minor entry (K3F's plain form, predict_compose_put_flat, fed
[N, MB*6, 64] residuals) against models/mpeg1.dense_compose's lane-minor
branch (XLA, through the port's dense_compose_flat) with out-of-frame
and edge half-pel vectors, and against compose_plane_pallas /
compose_plane_pallas2 (interpret mode) per plane, all four MB kinds and
inactive lanes.
"""

import numpy as np
import pytest
import torch

from espflix_tpu.core import vlc_tables as V
from espflix_tpu_torch.models import mpeg1 as TM
from espflix_tpu_torch.ops import mocomp as TMC

try:
    import jax.numpy as jnp
    from espflix_tpu.models import mpeg1 as JM
    from espflix_tpu.ops import mocomp as JMC
    from espflix_tpu.ops import mocomp_pallas as JMP
except ImportError:     # the card's machine has no jax: gpu tests only
    jnp = JM = JMC = JMP = None

torch.set_num_threads(1)


def _mvs(rng, N, mbh, mbw, S, out_of_frame):
    """Half-pel MVs; out_of_frame adds vectors past every edge and
    half-pel vectors that reach the last row / column."""
    lim = 2 * S * (mbw if out_of_frame else 1)
    mh = rng.integers(-lim, lim + 1, (N, mbh, mbw))
    mv = rng.integers(-lim, lim + 1, (N, mbh, mbw))
    if out_of_frame:
        mh[:, :, -1] = rng.choice([1, 3, 2 * S + 1], (N, mbh))
        mv[:, -1, :] = rng.choice([1, 3, 2 * S + 1], (N, mbw))
        mh[:, :, 0] = rng.choice([-1, -3, -4 * S - 1], (N, mbh))
        mv[:, 0, :] = rng.choice([-1, -3, -4 * S - 1], (N, mbw))
    else:
        # stay inside: origin + window + the half-pel tap in the plane
        cs = np.arange(mbw)[None, None, :] * 2 * S
        rs = np.arange(mbh)[None, :, None] * 2 * S
        mh = np.clip(mh, -cs, 2 * S * (mbw - 1) - cs - 1)
        mv = np.clip(mv, -rs, 2 * S * (mbh - 1) - rs - 1)
    return mh.astype(np.int32), mv.astype(np.int32)


def _plane(rng, N, H, W):
    return rng.integers(0, 249, (N, H, W), dtype=np.uint8)


def _port_predict(ref, mh, mv, S):
    return TMC.predict_plane_torch(torch.from_numpy(ref),
                                   torch.from_numpy(mh),
                                   torch.from_numpy(mv), S).numpy()


@pytest.mark.parametrize("S", [16, 8])
@pytest.mark.parametrize("oof", [False, True])
def test_predict_matches_mxu(S, oof):
    rng = np.random.default_rng(10 + S + oof)
    N, mbh, mbw = 3, 4, 6
    ref = _plane(rng, N, mbh * S, mbw * S)
    mh, mv = _mvs(rng, N, mbh, mbw, S, oof)
    j = np.asarray(JMC.predict_plane_mxu(jnp.asarray(ref), jnp.asarray(mh),
                                         jnp.asarray(mv), S))
    assert np.array_equal(_port_predict(ref, mh, mv, S), j)


@pytest.mark.parametrize("oof", [False, True])
def test_luma_matches_phase2p_kernel(oof):
    rng = np.random.default_rng(20 + oof)
    N, mbh, mbw = 2, 12, 22
    ref = _plane(rng, N, 192, 352)
    mh, mv = _mvs(rng, N, mbh, mbw, 16, oof)
    j = np.asarray(JMP.predict_plane_phase2p(
        jnp.asarray(ref), jnp.asarray(mh), jnp.asarray(mv), 16,
        interpret=True))
    assert np.array_equal(_port_predict(ref, mh, mv, 16), j)


@pytest.mark.parametrize("oof", [False, True])
def test_chroma_matches_packedp_kernel(oof):
    rng = np.random.default_rng(30 + oof)
    N, mbh, mbw = 2, 12, 22
    ru, rv = _plane(rng, N, 96, 176), _plane(rng, N, 96, 176)
    mh, mv = _mvs(rng, N, mbh, mbw, 16, oof)
    ju, jv = JMP.predict_chroma_pair_packedp(
        jnp.asarray(ru), jnp.asarray(rv), jnp.asarray(mh >> 1),
        jnp.asarray(mv >> 1), interpret=True, accum=True)
    assert np.array_equal(_port_predict(ru, mh >> 1, mv >> 1, 8),
                          np.asarray(ju))
    assert np.array_equal(_port_predict(rv, mh >> 1, mv >> 1, 8),
                          np.asarray(jv))


LUMA_VARIANTS = ["predict_plane_pallas", "predict_plane_phase",
                 "predict_plane_phase2", "predict_plane_phase4",
                 "predict_plane_packed"]


@pytest.mark.parametrize("name", LUMA_VARIANTS)
@pytest.mark.parametrize("S", [16, 8])
def test_predict_plane_variants_in_frame(name, S):
    if name in ("predict_plane_phase2", "predict_plane_phase4") and S != 16:
        pytest.skip(f"{name} is the luma-only kernel")
    rng = np.random.default_rng(40 + S)
    N, mbh, mbw = 2, 4, 6
    ref = _plane(rng, N, mbh * S, mbw * S)
    mh, mv = _mvs(rng, N, mbh, mbw, S, False)
    j = np.asarray(getattr(JMP, name)(
        jnp.asarray(ref), jnp.asarray(mh), jnp.asarray(mv), S,
        interpret=True))
    assert np.array_equal(_port_predict(ref, mh, mv, S), j)


@pytest.mark.parametrize("name", ["predict_chroma_pair_phase",
                                  "predict_chroma_pair_packed"])
def test_chroma_pair_variants_in_frame(name):
    rng = np.random.default_rng(50)
    N, mbh, mbw = 2, 4, 6
    ru, rv = _plane(rng, N, 32, 48), _plane(rng, N, 32, 48)
    mh, mv = _mvs(rng, N, mbh, mbw, 8, False)
    ju, jv = getattr(JMP, name)(jnp.asarray(ru), jnp.asarray(rv),
                                jnp.asarray(mh), jnp.asarray(mv),
                                interpret=True)
    assert np.array_equal(_port_predict(ru, mh, mv, 8), np.asarray(ju))
    assert np.array_equal(_port_predict(rv, mh, mv, 8), np.asarray(jv))


def _recs(rng, N, mbh, mbw, oof):
    kind = rng.integers(0, 4, (N, mbh, mbw))
    qs = rng.integers(1, 32, (N, mbh, mbw))
    mh, mv = _mvs(rng, N, mbh, mbw, 16, oof)
    mh = np.where(kind == 2, mh, 0)
    mv = np.where(kind == 2, mv, 0)
    rec = kind | (qs << 2) | ((mh & 0xFFF) << 7) | ((mv & 0xFFF) << 19)
    rec = np.where(kind == 0, 0, rec)
    return rec.reshape(N, mbh * mbw).astype(np.int32)


@pytest.mark.parametrize("name", ["compose_plane_pallas",
                                  "compose_plane_pallas2"])
@pytest.mark.parametrize("S", [16, 8])
def test_fused_compose_variants_in_frame(name, S):
    """The JAX fused compose kernels vs the port's compose, per plane."""
    rng = np.random.default_rng(60 + S)
    N, mbh, mbw = 3, 4, 6
    H, W = mbh * S, mbw * S
    recs = _recs(rng, N, mbh, mbw, False)
    res = rng.integers(-300, 300, (N, 64, mbh * mbw * 6)).astype(np.int16)
    active = np.array([True, False, True])
    planes = {k: rng.integers(0, 249, (N, 2) + (
        (mbh * 16, mbw * 16) if k == "y" else (mbh * 8, mbw * 8)),
        dtype=np.uint8) for k in "yuv"}
    parity = np.array([0, 1, 1], np.int32)
    fr = {k: torch.from_numpy(v.copy()) for k, v in planes.items()}
    fr["parity"] = torch.from_numpy(parity)
    pres = TMC.predict_compose_put(
        torch.from_numpy(res), torch.from_numpy(recs),
        torch.from_numpy(active), fr, mb_width=mbw, mb_height=mbh)
    key = "y" if S == 16 else "u"
    ry, ru, _rv = (r.numpy() for r in TMC.residual_planes(
        torch.from_numpy(res), mbw, mbh))
    resid = ry if S == 16 else ru
    kind, mh, mv = (a.numpy() for a in TMC.mb_fields(
        torch.from_numpy(recs), mbw, mbh))
    if S == 8:
        mh, mv = mh >> 1, mv >> 1
    lanes = np.arange(N)
    cur = planes[key][lanes, parity]
    ref = planes[key][lanes, 1 - parity]
    assert cur.shape == (N, H, W)
    j = np.asarray(getattr(JMP, name)(
        jnp.asarray(ref), jnp.asarray(cur), jnp.asarray(resid),
        jnp.asarray(kind), jnp.asarray(mh), jnp.asarray(mv),
        jnp.asarray(active), S, interpret=True))
    assert np.array_equal(pres[key].numpy(), j)


def _dense_inputs(seed, oof, N=4, mbh=4, mbw=6):
    rng = np.random.default_rng(seed)
    recs = _recs(rng, N, mbh, mbw, oof)
    BL = mbh * mbw * 6
    nf = rng.choice([0, 1, 3, 64], (N, BL)).astype(np.int32)
    coeffs = rng.integers(-30, 31, (N, 64, BL)).astype(np.int16)
    coeffs[:, 0, :] = rng.integers(0, 256, (N, BL))
    coeffs = np.where(nf[:, None, :] > 0, coeffs, 0).astype(np.int16)
    iq = np.tile(V.DEFAULT_INTRA_Q, (N, 1)).astype(np.int32)
    nq = np.tile(V.DEFAULT_NON_INTRA_Q, (N, 1)).astype(np.int32)
    active = np.array([True, False, True, True])[:N]
    frames = {k: rng.integers(0, 249, (N, 2) + (
        (mbh * 16, mbw * 16) if k == "y" else (mbh * 8, mbw * 8)),
        dtype=np.uint8) for k in "yuv"}
    frames["parity"] = rng.integers(0, 2, N).astype(np.int32)
    return coeffs, recs, nf, iq, nq, active, frames, mbw, mbh


@pytest.mark.parametrize("seed", [1, 2])
@pytest.mark.parametrize("oof", [False, True])
def test_dense_compose_matches_jax(seed, oof):
    coeffs, recs, nf, iq, nq, active, frames, mbw, mbh = \
        _dense_inputs(seed, oof)
    jf, jp = JM.dense_compose(
        None, jnp.asarray(recs), jnp.asarray(nf), jnp.asarray(iq),
        jnp.asarray(nq), jnp.asarray(active),
        {k: jnp.asarray(v) for k, v in frames.items()},
        mb_width=mbw, mb_height=mbh, coeffs_T=jnp.asarray(coeffs))
    tfr = {k: torch.from_numpy(v.copy()) for k, v in frames.items()}
    tf, tp = TM.dense_compose(
        torch.from_numpy(coeffs), torch.from_numpy(recs),
        torch.from_numpy(nf), torch.from_numpy(iq), torch.from_numpy(nq),
        torch.from_numpy(active), tfr, mb_width=mbw, mb_height=mbh)
    for k in ("y", "u", "v", "parity"):
        a, b = tf[k].numpy(), np.asarray(jf[k])
        assert a.dtype == b.dtype and np.array_equal(a, b), k
    for k in "yuv":
        assert np.array_equal(tp[k].numpy(), np.asarray(jp[k])), k
    kinds = recs & 3
    assert set(np.unique(kinds)) == {0, 1, 2, 3}


# ---- lane-minor entry (K3F) ---------------------------------------------

def _flat_planes_np(res, mbw, mbh):
    """The JAX package's lane-minor residual-plane assembly
    (mpeg1.py:595-609) in numpy: res [N, MB*6, 64] -> y, u, v planes."""
    N = res.shape[0]
    W = mbw * 16
    r = res.reshape(N, mbh, mbw, 6, 64)
    ry = np.stack([r[:, :, :, 2 * a:2 * a + 2, 8 * k:8 * k + 8]
                   .reshape(N, mbh, W) for a in range(2) for k in range(8)],
                  axis=2).reshape(N, mbh * 16, W)
    ru, rv = (np.stack([r[:, :, :, b, 8 * k:8 * k + 8].reshape(
        N, mbh, W // 2) for k in range(8)], axis=2).reshape(
            N, mbh * 8, W // 2) for b in (4, 5))
    return ry, ru, rv


@pytest.mark.parametrize("name", ["compose_plane_pallas",
                                  "compose_plane_pallas2"])
@pytest.mark.parametrize("S", [16, 8])
def test_flat_compose_matches_fused_kernels(name, S):
    """predict_compose_put_flat vs the JAX fused compose kernels, per
    plane, on in-frame vectors (the references' window roll is checked
    inside the plane; out-of-frame vectors are held against the XLA
    lane-minor branch below)."""
    rng = np.random.default_rng(80 + S)
    N, mbh, mbw = 3, 4, 6
    recs = _recs(rng, N, mbh, mbw, False)
    res = rng.integers(-300, 300, (N, mbh * mbw * 6, 64)).astype(np.int16)
    active = np.array([True, False, True])
    planes = {k: rng.integers(0, 249, (N, 2) + (
        (mbh * 16, mbw * 16) if k == "y" else (mbh * 8, mbw * 8)),
        dtype=np.uint8) for k in "yuv"}
    parity = np.array([1, 0, 0], np.int32)
    fr = {k: torch.from_numpy(v.copy()) for k, v in planes.items()}
    fr["parity"] = torch.from_numpy(parity)
    pres = TMC.predict_compose_put_flat(
        torch.from_numpy(res), torch.from_numpy(recs),
        torch.from_numpy(active), fr, mb_width=mbw, mb_height=mbh)
    ry, ru, _rv = _flat_planes_np(res, mbw, mbh)
    key, resid = ("y", ry) if S == 16 else ("u", ru)
    kind = (recs & 3).reshape(N, mbh, mbw)
    _k, mh, mv = (a.numpy() for a in TMC.mb_fields(
        torch.from_numpy(recs), mbw, mbh))
    if S == 8:
        mh, mv = mh >> 1, mv >> 1
    lanes = np.arange(N)
    j = np.asarray(getattr(JMP, name)(
        jnp.asarray(planes[key][lanes, 1 - parity]),
        jnp.asarray(planes[key][lanes, parity]), jnp.asarray(resid),
        jnp.asarray(kind), jnp.asarray(mh), jnp.asarray(mv),
        jnp.asarray(active), S, interpret=True))
    assert np.array_equal(pres[key].numpy(), j)
    assert np.array_equal(fr[key][lanes, parity].numpy(), j)
    assert set(np.unique(kind)) == {0, 1, 2, 3}


@pytest.mark.parametrize("seed", [3, 4])
@pytest.mark.parametrize("oof", [False, True])
def test_flat_dense_compose_matches_jax(seed, oof):
    """dense_compose_flat (K2F + K3F plain forms) vs the lane-minor
    branch of the JAX dense_compose (coeffs_T=None, XLA)."""
    coeffs_T, recs, nf, iq, nq, active, frames, mbw, mbh = \
        _dense_inputs(seed, oof)
    N = recs.shape[0]
    coeffs = np.ascontiguousarray(coeffs_T.transpose(0, 2, 1)).reshape(N, -1)
    jf, jp = JM.dense_compose(
        jnp.asarray(coeffs), jnp.asarray(recs), jnp.asarray(nf),
        jnp.asarray(iq), jnp.asarray(nq), jnp.asarray(active),
        {k: jnp.asarray(v) for k, v in frames.items()},
        mb_width=mbw, mb_height=mbh)
    tfr = {k: torch.from_numpy(v.copy()) for k, v in frames.items()}
    tf, tp = TM.dense_compose_flat(
        torch.from_numpy(coeffs), torch.from_numpy(recs),
        torch.from_numpy(nf), torch.from_numpy(iq), torch.from_numpy(nq),
        torch.from_numpy(active), tfr, mb_width=mbw, mb_height=mbh)
    for k in ("y", "u", "v", "parity"):
        a, b = tf[k].numpy(), np.asarray(jf[k])
        assert a.dtype == b.dtype and np.array_equal(a, b), k
    for k in "yuv":
        assert np.array_equal(tp[k].numpy(), np.asarray(jp[k])), k
    assert not active.all()


def test_flat_residual_planes_match_jax_assembly():
    rng = np.random.default_rng(90)
    res = rng.integers(-999, 999, (2, 4 * 6 * 6, 64)).astype(np.int16)
    got = TMC.residual_planes_flat(torch.from_numpy(res), 6, 4)
    for a, b in zip(got, _flat_planes_np(res, 6, 4)):
        assert np.array_equal(a.numpy(), b)


@pytest.mark.gpu
@pytest.mark.parametrize("oof", [False, True])
def test_flat_kernel_matches_plain_on_card(oof):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(75 + oof)
    N, mbh, mbw = 4, 12, 22
    recs = _recs(rng, N, mbh, mbw, oof)
    res = rng.integers(-300, 300, (N, mbh * mbw * 6, 64)).astype(np.int16)
    active = np.array([True, False, True, True])
    frames = {k: rng.integers(0, 256, (N, 2) + (
        (192, 352) if k == "y" else (96, 176)), dtype=np.uint8)
        for k in "yuv"}
    frames["parity"] = np.array([1, 1, 0, 0], np.int32)
    outs = []
    for dev in ("cpu", "cuda"):
        fr = {k: torch.from_numpy(v.copy()).to(dev)
              for k, v in frames.items()}
        p = TMC.predict_compose_put_flat(
            torch.from_numpy(res).to(dev), torch.from_numpy(recs).to(dev),
            torch.from_numpy(active).to(dev), fr, mb_width=mbw,
            mb_height=mbh)
        outs.append([t.cpu() for t in (p["y"], p["u"], p["v"], fr["y"],
                                       fr["u"], fr["v"])])
    for a, b in zip(*outs):
        assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("oof", [False, True])
def test_kernel_matches_plain_on_card(oof):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(70 + oof)
    N, mbh, mbw = 4, 12, 22
    recs = _recs(rng, N, mbh, mbw, oof)
    res = rng.integers(-300, 300, (N, 64, mbh * mbw * 6)).astype(np.int16)
    active = np.array([True, False, True, True])
    frames = {k: rng.integers(0, 256, (N, 2) + (
        (192, 352) if k == "y" else (96, 176)), dtype=np.uint8)
        for k in "yuv"}
    frames["parity"] = np.array([0, 1, 1, 0], np.int32)
    outs = []
    for dev in ("cpu", "cuda"):
        fr = {k: torch.from_numpy(v.copy()).to(dev)
              for k, v in frames.items()}
        p = TMC.predict_compose_put(
            torch.from_numpy(res).to(dev), torch.from_numpy(recs).to(dev),
            torch.from_numpy(active).to(dev), fr, mb_width=mbw,
            mb_height=mbh)
        outs.append([t.cpu() for t in (p["y"], p["u"], p["v"], fr["y"],
                                       fr["u"], fr["v"])])
    for a, b in zip(*outs):
        assert torch.equal(a, b)


# ---- predict-only entries (K3P) ------------------------------------------

def _predict(ref, mh, mv, S):
    return TMC.predict_plane(torch.from_numpy(ref), torch.from_numpy(mh),
                             torch.from_numpy(mv), S).numpy()


@pytest.mark.parametrize("S", [16, 8])
@pytest.mark.parametrize("oof", [False, True])
def test_predict_plane_matches_pallas_kernel(S, oof):
    """K3P's plain form (rule A) vs the Pallas _kernel of
    predict_plane_pallas, in interpret mode, out-of-frame vectors
    included."""
    rng = np.random.default_rng(100 + S + oof)
    N, mbh, mbw = 2, 4, 6
    ref = _plane(rng, N, mbh * S, mbw * S)
    mh, mv = _mvs(rng, N, mbh, mbw, S, oof)
    j = np.asarray(JMP.predict_plane_pallas(
        jnp.asarray(ref), jnp.asarray(mh), jnp.asarray(mv), S,
        interpret=True))
    assert np.array_equal(_predict(ref, mh, mv, S), j)


@pytest.mark.parametrize("name", LUMA_VARIANTS[1:])
@pytest.mark.parametrize("oof", [False, True])
def test_predict_plane_matches_luma_variants(name, oof):
    """K3P's plain form vs _phase_kernel, _phase2_kernel, _phase4_kernel
    and _packed_kernel at the luma scale (interpret mode)."""
    rng = np.random.default_rng(110 + oof + 2 * LUMA_VARIANTS.index(name))
    N, mbh, mbw = 2, 4, 6
    ref = _plane(rng, N, mbh * 16, mbw * 16)
    mh, mv = _mvs(rng, N, mbh, mbw, 16, oof)
    j = np.asarray(getattr(JMP, name)(
        jnp.asarray(ref), jnp.asarray(mh), jnp.asarray(mv), 16,
        interpret=True))
    assert np.array_equal(_predict(ref, mh, mv, 16), j)


@pytest.mark.parametrize("name", ["predict_chroma_pair_phase",
                                  "predict_chroma_pair_packed"])
@pytest.mark.parametrize("oof", [False, True])
def test_predict_chroma_pair_matches_dual_kernels(name, oof):
    """predict_chroma_pair vs the dual-plane forms of _phase_kernel and
    _packed_kernel."""
    rng = np.random.default_rng(120 + oof)
    N, mbh, mbw = 2, 4, 6
    ru, rv = _plane(rng, N, 32, 48), _plane(rng, N, 32, 48)
    mh, mv = _mvs(rng, N, mbh, mbw, 8, oof)
    ju, jv = getattr(JMP, name)(jnp.asarray(ru), jnp.asarray(rv),
                                jnp.asarray(mh), jnp.asarray(mv),
                                interpret=True)
    pu, pv = TMC.predict_chroma_pair(*(torch.from_numpy(a)
                                       for a in (ru, rv, mh, mv)))
    assert np.array_equal(pu.numpy(), np.asarray(ju))
    assert np.array_equal(pv.numpy(), np.asarray(jv))


@pytest.mark.parametrize("S", [16, 8])
@pytest.mark.parametrize("band", [(0, 2), (1, 2), (3, 1), (0, 4)])
def test_predict_plane_rows_matches_jax(S, band):
    """K3P's band form (rule B) vs mocomp.predict_plane_rows at several
    bands of a 4-MB-row plane, vectors past every edge included."""
    row0, n_rows = band
    rng = np.random.default_rng(130 + S + row0 * 4 + n_rows)
    N, mbh, mbw = 2, 4, 6
    ref = _plane(rng, N, mbh * S, mbw * S)
    mh, mv = _mvs(rng, N, mbh, mbw, S, True)
    mh, mv = mh[:, row0:row0 + n_rows], mv[:, row0:row0 + n_rows]
    j = np.asarray(JMC.predict_plane_rows(
        jnp.asarray(ref), jnp.asarray(mh), jnp.asarray(mv), S, row0))
    t = TMC.predict_plane_rows(torch.from_numpy(ref), torch.from_numpy(mh),
                               torch.from_numpy(mv), S, row0).numpy()
    assert t.shape == (N, n_rows * S, mbw * S)
    assert np.array_equal(t, j)


def test_edge_rules_differ_at_the_edge():
    """The reference's two edge rules: rule A (predict_plane_pallas,
    predict_plane_mxu) and rule B (mocomp.predict_plane) agree on
    in-frame windows and differ when a half-pel window touches the
    right or bottom edge or reaches past the plane.  The port keeps
    each with its own caller."""
    rng = np.random.default_rng(140)
    N, mbh, mbw, S = 1, 2, 3, 16
    ref = _plane(rng, N, mbh * S, mbw * S)
    mh = np.zeros((N, mbh, mbw), np.int32)
    mv = np.zeros((N, mbh, mbw), np.int32)
    mh[0, 0, 2] = 1            # half-pel right of the last MB column
    mv[0, 1, 0] = 1            # half-pel below the last MB row
    mh[0, 1, 1] = -2 * S - 4   # window past the left edge
    args = [jnp.asarray(a) for a in (ref, mh, mv)]
    rule_a = np.asarray(JMP.predict_plane_pallas(*args, S, interpret=True))
    rule_b = np.asarray(JMC.predict_plane(*args, S))
    assert np.array_equal(_predict(ref, mh, mv, S), rule_a)
    assert np.array_equal(TMC.predict_plane_rows(
        *(torch.from_numpy(a) for a in (ref, mh, mv)), S).numpy(), rule_b)
    diff = rule_a != rule_b
    assert diff[0, :S, 2 * S:].any() and diff[0, S:, :S].any() \
        and diff[0, S:, S:2 * S].any()
    # MB (0, 0) and (0, 1) stay inside the plane: both rules agree
    assert not diff[0, :S, :2 * S].any()
    # at the edge rule A reads zero past the plane, rule B the last pixel
    assert rule_a[0, S - 1, 3 * S - 1] == (int(ref[0, S - 1, 3 * S - 1])
                                          + 1) >> 1
    assert rule_b[0, S - 1, 3 * S - 1] == ref[0, S - 1, 3 * S - 1]


@pytest.mark.gpu
@pytest.mark.parametrize("clip_taps", [False, True])
def test_predict_kernel_matches_plain_on_card(clip_taps):
    """K3P against its plain form on the card: rule A over whole planes,
    rule B over a band, luma and chroma, vectors past every edge."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(150 + clip_taps)
    N, mbh, mbw = 4, 12, 22
    for S in (16, 8):
        ref = torch.from_numpy(_plane(rng, N, mbh * S, mbw * S))
        mh, mv = (torch.from_numpy(a) for a in _mvs(rng, N, mbh, mbw, S,
                                                   True))
        if clip_taps:
            band = (slice(None), slice(3, 9))
            want = TMC.predict_plane_rows_torch(ref, mh[band], mv[band], S,
                                                3)
            got = TMC.predict_plane_rows(ref.cuda(), mh[band].cuda(),
                                         mv[band].cuda(), S, 3)
        else:
            want = TMC.predict_plane_torch(ref, mh, mv, S)
            got = TMC.predict_plane(ref.cuda(), mh.cuda(), mv.cuda(), S)
        assert torch.equal(got.cpu(), want)
