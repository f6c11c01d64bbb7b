"""Dequant + IDCT: the port (K2's plain form) vs the JAX package.

Same inputs, made from a numpy seed, go through
idct.block_residuals_T (XLA), idct_pallas.block_residuals_T_pallas
(interpret mode) and the lane-minor idct_pallas.block_residuals_pallas,
and through the port's block_residuals_T.  Exact equality: nfinal 0, 1
and more, intra and non-intra blocks, and levels at the +-2048 clip
extremes.  The lane-minor entry block_residuals_flat (K2F's plain
form), with each block's intra flag and qscale taken from its MB
record, equals idct.block_residuals_flat (XLA, cast to int16 as the
lane-minor dense phase does) and idct_pallas.block_residuals_pallas.
"""

import numpy as np
import pytest
import torch

from espflix_tpu.core import vlc_tables as V
from espflix_tpu_torch.ops import idct as TI

try:
    import jax.numpy as jnp
    from espflix_tpu.ops import idct as JI
    from espflix_tpu.ops import idct_pallas as JIP
except ImportError:     # the card's machine has no jax: gpu tests only
    jnp = JI = JIP = None

torch.set_num_threads(1)


def _inputs(seed, N=3, BL=132 * 2):
    rng = np.random.default_rng(seed)
    lev = np.zeros((N, 64, BL), np.int16)
    nf = rng.choice([0, 1, 2, 5, 64], size=(N, BL)).astype(np.int32)
    kind = rng.integers(0, 4, (N, BL))
    for n in range(N):
        for b in range(BL):
            k = int(nf[n, b])
            if k == 0:
                continue
            pos = rng.choice(64, size=min(k, 64), replace=False)
            if kind[n, b] == 0:              # ordinary levels
                v = rng.integers(-40, 41, len(pos))
            elif kind[n, b] == 1:            # escape-range levels
                v = rng.integers(-255, 256, len(pos))
            elif kind[n, b] == 2:            # clip extremes
                v = rng.choice([-2048, -2047, 2047, 2048, -1, 1],
                               len(pos))
            else:                            # int16 extremes
                v = rng.choice([-32768, 32767, -3000, 3000], len(pos))
            lev[n, pos, b] = v
    intra = rng.random((N, BL)) < 0.5
    # intra DC: absolute dc value at position 0
    lev[:, 0, :] = np.where(intra & (nf > 0),
                            rng.integers(0, 256, (N, BL)), lev[:, 0, :])
    qs = rng.integers(1, 32, (N, BL)).astype(np.int32)
    iq = np.stack([V.DEFAULT_INTRA_Q,
                   rng.integers(1, 256, 64),
                   rng.integers(1, 256, 64)])[:N].astype(np.int32)
    nq = np.stack([V.DEFAULT_NON_INTRA_Q,
                   rng.integers(1, 256, 64),
                   rng.integers(1, 256, 64)])[:N].astype(np.int32)
    return lev, intra, qs, iq, nq, nf


SEEDS = [1, 2, 3]


@pytest.fixture(scope="module")
def refs():
    out = {}
    for seed in SEEDS:
        lev, intra, qs, iq, nq, nf = _inputs(seed)
        qmat_T = np.where(intra[:, None, :], iq[:, :, None], nq[:, :, None])
        xla = np.asarray(JI.block_residuals_T(
            jnp.asarray(lev.astype(np.int32)), jnp.asarray(intra),
            jnp.asarray(qs), jnp.asarray(qmat_T), jnp.asarray(nf))
            .astype(jnp.int16))
        pal = np.asarray(JIP.block_residuals_T_pallas(
            jnp.asarray(lev), jnp.asarray(intra), jnp.asarray(qs),
            jnp.asarray(iq), jnp.asarray(nq), jnp.asarray(nf),
            interpret=True))
        port = TI.block_residuals_T(
            torch.from_numpy(lev), torch.from_numpy(intra),
            torch.from_numpy(qs), torch.from_numpy(iq), torch.from_numpy(nq),
            torch.from_numpy(nf)).numpy()
        out[seed] = (lev, intra, qs, iq, nq, nf, xla, pal, port)
    return out


@pytest.mark.parametrize("seed", SEEDS)
def test_matches_xla_block_residuals_T(refs, seed):
    *_, xla, _pal, port = refs[seed]
    assert port.dtype == np.int16 and port.shape == xla.shape
    assert np.array_equal(port, xla)


@pytest.mark.parametrize("seed", SEEDS)
def test_matches_pallas_kernel_T(refs, seed):
    *_, pal, port = refs[seed]
    assert np.array_equal(port, pal)


def test_matches_lane_minor_pallas_kernel(refs):
    """idct_pallas._kernel (block_residuals_pallas) computes the same
    function in the lane-minor [N, MB, 6, 64] layout."""
    lev, intra, qs, iq, nq, nf, _x, _p, port = refs[SEEDS[0]]
    N, _, BL = lev.shape
    MB = BL // 6
    lm = lev.transpose(0, 2, 1).reshape(N, MB, 6, 64).astype(np.int32)
    ib = intra.reshape(N, MB, 6)
    qmat = np.where(ib[..., None], iq[:, None, None, :], nq[:, None, None, :])
    out = np.asarray(JIP.block_residuals_pallas(
        jnp.asarray(lm), jnp.asarray(ib), jnp.asarray(qs.reshape(N, MB, 6)),
        jnp.asarray(qmat), jnp.asarray(nf.reshape(N, MB, 6)),
        interpret=True)).reshape(N, MB * 6, 64).transpose(0, 2, 1)
    assert np.array_equal(out.astype(np.int16), port)


def test_cases_cover_shortcut_and_zero_blocks(refs):
    lev, intra, qs, iq, nq, nf, *_ = refs[SEEDS[0]]
    assert ((nf == 1) & ~intra).any() and ((nf == 1) & intra).any()
    assert (nf == 0).any() and (np.abs(lev) >= 2048).any()


@pytest.mark.gpu
@pytest.mark.parametrize("seed", SEEDS)
def test_kernel_matches_plain_on_card(seed):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    args = [torch.from_numpy(a) for a in _inputs(seed)]
    got = TI.block_residuals_T(*[a.cuda() for a in args])
    assert torch.equal(got.cpu(), TI.block_residuals_T(*args))


# ---- lane-minor entry (K2F) ---------------------------------------------

def _flat_inputs(seed):
    """_inputs with one intra flag and qscale per MB, as MB records:
    (coeffs int16[N, MB*384], recs, nfinal, iq, nq, intra / qscale per
    block)."""
    lev, intra, qs, iq, nq, nf = _inputs(seed)
    N, _, BL = lev.shape
    MB = BL // 6
    rng = np.random.default_rng(100 + seed)
    intra_mb = intra[:, ::6]
    kind = np.where(intra_mb, 3, rng.integers(1, 3, (N, MB)))
    mv = rng.integers(0, 1 << 24, (N, MB)) << 7
    recs = (kind | (qs[:, ::6] << 2) | mv).astype(np.int32)
    coeffs = lev.transpose(0, 2, 1).reshape(N, MB * 384)
    return (np.ascontiguousarray(coeffs), recs, nf, iq, nq,
            np.repeat(intra_mb, 6, axis=1), np.repeat(qs[:, ::6], 6, axis=1))


def _port_flat(coeffs, recs, nf, iq, nq, device="cpu"):
    return TI.block_residuals_flat(*[torch.from_numpy(a).to(device) for a in
                                     (coeffs, recs, nf, iq, nq)]).cpu()


@pytest.fixture(scope="module")
def flat_refs():
    out = {}
    for seed in SEEDS:
        coeffs, recs, nf, iq, nq, intra, qs = _flat_inputs(seed)
        N, BL = nf.shape
        MB = BL // 6
        lv = coeffs.reshape(N, MB, 6, 64).astype(np.int32)
        ib, qb = intra.reshape(N, MB, 6), qs.reshape(N, MB, 6)
        qmat = np.where(ib[..., None], iq[:, None, None, :],
                        nq[:, None, None, :])
        args = [jnp.asarray(a) for a in (lv, ib, qb, qmat,
                                         nf.reshape(N, MB, 6))]
        xla = np.asarray(JI.block_residuals_flat(*args)
                         .astype(jnp.int16)).reshape(N, BL, 64)
        pal = np.asarray(JIP.block_residuals_pallas(*args, interpret=True)
                         ).reshape(N, BL, 64).astype(np.int16)
        port = _port_flat(coeffs, recs, nf, iq, nq).numpy()
        out[seed] = (xla, pal, port, intra, nf)
    return out


@pytest.mark.parametrize("seed", SEEDS)
def test_flat_matches_xla_block_residuals_flat(flat_refs, seed):
    xla, _pal, port, _i, _n = flat_refs[seed]
    assert port.dtype == np.int16 and port.shape == xla.shape
    assert np.array_equal(port, xla)


@pytest.mark.parametrize("seed", SEEDS)
def test_flat_matches_lane_minor_pallas_kernel(flat_refs, seed):
    _xla, pal, port, intra, nf = flat_refs[seed]
    assert np.array_equal(port, pal)
    assert ((nf == 1) & ~intra).any() and (nf == 0).any() and intra.any()


@pytest.mark.gpu
@pytest.mark.parametrize("seed", SEEDS)
def test_flat_kernel_matches_plain_on_card(seed):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    args = _flat_inputs(seed)[:5]
    assert torch.equal(_port_flat(*args, device="cuda"), _port_flat(*args))
