"""Dequant + IDCT: the port (K2's plain form) vs the JAX package.

Same inputs, made from a numpy seed, go through
idct.block_residuals_T (XLA), idct_pallas.block_residuals_T_pallas
(interpret mode) and the lane-minor idct_pallas.block_residuals_pallas,
and through the port's block_residuals_T.  Exact equality: nfinal 0, 1
and more, intra and non-intra blocks, and levels at the +-2048 clip
extremes.
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
