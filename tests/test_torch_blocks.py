"""The JAX package's building blocks in the port: exact, with dtypes.

The same seeded numpy inputs go through the JAX functions and the
port's plain torch functions of the same names and signatures:
ops/idct.{dequant_levels, dequant_levels_T, idct_8x8, idct_8x8_T,
idct_8x8_flat, block_residuals}, ops/sbc_ops.synthesis_step (with
operands wide enough that the int32 products and sums wrap) and
ops/scan_dense.{log_to_dense_rows (both orientations), assemble_dense,
assemble_dense_T} on logs that emit into the window, outside it, at
negative and trash indices, and into doubled slots whose sums wrap.
On a card the same blocks run on CUDA tensors and K2 is held against
block_residuals.
"""

import numpy as np
import pytest
import torch

from espflix_tpu_torch.core import vlc_tables as V
from espflix_tpu_torch.ops import idct as TI
from espflix_tpu_torch.ops import sbc_ops as TS
from espflix_tpu_torch.ops import scan_dense as TD

try:
    import jax.numpy as jnp
    from espflix_tpu.ops import idct as JI
    from espflix_tpu.ops import sbc_ops as JS
    from espflix_tpu.ops import scan_dense as JD
except ImportError:     # the card's machine has no jax: gpu tests only
    jnp = JI = JS = JD = None

torch.set_num_threads(1)


def _same(j, t):
    """A JAX result equals a torch result: dtype, shape and values."""
    if isinstance(j, (tuple, list)):
        assert len(j) == len(t)
        for a, b in zip(j, t):
            _same(a, b)
        return
    a = np.asarray(j)
    b = t.cpu().numpy()
    assert a.dtype == b.dtype and a.shape == b.shape, \
        (a.dtype, b.dtype, a.shape, b.shape)
    assert np.array_equal(a, b)


def _run(jfn, tfn, args, **kw):
    got = tfn(*[torch.from_numpy(np.ascontiguousarray(a)) for a in args],
              **kw)
    _same(jfn(*[jnp.asarray(a) for a in args], **kw), got)
    return got


def _levels(seed, N=2, B=30):
    """(levels int32[N, B, 64], intra, qscale, qmat, nfinal): coded
    positions per nfinal, ordinary, escape-range and clip-extreme
    levels, intra DC absolute."""
    rng = np.random.default_rng(seed)
    nf = rng.choice([0, 1, 2, 5, 64], size=(N, B)).astype(np.int32)
    lev = np.zeros((N, B, 64), np.int32)
    for n in range(N):
        for b in range(B):
            k = int(nf[n, b])
            pos = rng.choice(64, size=k, replace=False)
            cat = rng.integers(0, 3, k)
            lev[n, b, pos] = np.where(
                cat == 0, rng.integers(-40, 41, k), np.where(
                    cat == 1, rng.integers(-255, 256, k),
                    rng.choice([-2048, 2047, 2048, -1, 1], k)))
    intra = rng.random((N, B)) < 0.5
    lev[:, :, 0] = np.where(intra & (nf > 0), rng.integers(0, 256, (N, B)),
                            lev[:, :, 0])
    qs = rng.integers(1, 32, (N, B)).astype(np.int32)
    qmat = np.where(intra[..., None], np.asarray(V.DEFAULT_INTRA_Q,
                                                 np.int32).reshape(64),
                    rng.integers(1, 256, (N, B, 64))).astype(np.int32)
    return lev, intra, qs, qmat, nf


@pytest.mark.parametrize("seed", [0, 1])
def test_dequant_and_idct_blocks_match_jax(seed):
    lev, intra, qs, qmat, nf = _levels(seed)
    b = _run(JI.dequant_levels, TI.dequant_levels, (lev, intra, qs, qmat))
    assert (b != 0).any()
    b_np = b.numpy()
    _run(JI.idct_8x8, TI.idct_8x8, (b_np.reshape(*b_np.shape[:-1], 8, 8),))
    _run(JI.idct_8x8_flat, TI.idct_8x8_flat, (b_np,))
    rng = np.random.default_rng(10 + seed)
    wide = rng.integers(-(1 << 16), 1 << 16, (3, 5, 64)).astype(np.int32)
    _run(JI.idct_8x8_flat, TI.idct_8x8_flat, (wide,))
    _run(JI.idct_8x8, TI.idct_8x8, (wide.reshape(3, 5, 8, 8),))
    # the [N, 64, B] orientation
    lev_T = lev.transpose(0, 2, 1)
    b_T = _run(JI.dequant_levels_T, TI.dequant_levels_T,
               (lev_T, intra, qs, qmat.transpose(0, 2, 1)))
    assert np.array_equal(b_T.numpy(), b_np.transpose(0, 2, 1))
    _run(JI.dequant_levels_T, TI.dequant_levels_T,
         (lev_T, intra, qs, qmat[:, :1].transpose(0, 2, 1)))
    _run(JI.idct_8x8_T, TI.idct_8x8_T, (b_T.numpy(),))
    _run(JI.idct_8x8_T, TI.idct_8x8_T, (wide.transpose(0, 2, 1),))
    r = _run(JI.block_residuals, TI.block_residuals,
             (lev, intra, qs, qmat, nf))
    assert r.shape == (2, 30, 8, 8) and (r != 0).any()
    # the shortcut and the zero block are both exercised
    assert ((nf == 1) & ~intra).any() and (nf == 0).any()


def test_synthesis_step_matches_jax_and_wraps():
    rng = np.random.default_rng(3)
    for lo, hi in ((-(1 << 15), 1 << 15), (-(1 << 30), 1 << 30)):
        hist = rng.integers(lo, hi, (3, 2, 10, 16)).astype(np.int32)
        src = rng.integers(lo, hi, (3, 2, 8)).astype(np.int32)
        _run(JS.synthesis_step, TS.synthesis_step, (hist, src))
    # a chain of blocks carries the history
    hist = np.zeros((4, 10, 16), np.int32)
    th = torch.from_numpy(hist)
    for k in range(12):
        src = rng.integers(-(1 << 17), 1 << 17, (4, 8)).astype(np.int32)
        hist, pcm = JS.synthesis_step(jnp.asarray(hist), jnp.asarray(src))
        th, tpcm = TS.synthesis_step(th, torch.from_numpy(src))
        _same((hist, pcm), (th, tpcm))
    assert (np.asarray(pcm) != 0).any()


MBW, MBH = 3, 2
MBC = MBW * MBH
TRASH = MBC * (1 + 6 + 384)


def _log(seed, R=5, T=40):
    """[T, R] emission logs for rows whose MB rows alternate: indices
    inside each row's window (records, nfinal, coefficients), and in
    all but the last row anywhere from negative to past trash;
    values spanning int16 and beyond, and doubled slots: a coefficient
    pair whose sum wraps int16, a nfinal pair, and a record pair whose
    byte quarters carry."""
    rng = np.random.default_rng(seed)
    rows = np.arange(R) % MBH
    rb = (rows * MBW).astype(np.int32)
    li = np.empty((T, R), np.int64)
    for r in range(R):
        mb = rb[r] + rng.integers(0, MBW, T)
        # the last row stays inside its window (and past trash)
        kind = rng.integers(0, 10, T)
        if r == R - 1:
            kind = np.where(kind == 8, 9, kind)
        li[:, r] = np.select(
            [kind < 2, kind < 4, kind < 8, kind == 8],
            [mb, MBC + mb * 6 + rng.integers(0, 6, T),
             MBC * 7 + mb * 384 + rng.integers(0, 384, T),
             rng.integers(-5, TRASH + 8, T)],
            TRASH)
    lv = rng.integers(-(1 << 15), 1 << 15, (T, R))
    lv[:3, 0] = rng.integers(1 << 20, 1 << 30, 3)       # wide values
    # doubled slots in row 1 (MB row 1: MBs 3..5)
    coef = MBC * 7 + 4 * 384 + 70
    li[0:2, 1] = coef
    lv[0:2, 1] = 30000
    li[2:4, 1] = MBC + 5 * 6 + 2
    lv[2:4, 1] = (300, 2047)
    li[4:6, 1] = 3
    lv[4:6, 1] = (0x7FFFFFFF, 0x01818181)
    return li.astype(np.int32), lv.astype(np.int32), rb


@pytest.mark.parametrize("transposed", [False, True])
def test_log_to_dense_rows_matches_jax(transposed):
    for seed in (0, 1):
        li, lv, rb = _log(seed)
        kw = dict(mb_width=MBW, mb_count=MBC, transposed=transposed)
        coef, aux, dropped = _run(JD.log_to_dense_rows, TD.log_to_dense_rows,
                                  (li, lv, rb), **kw)
        assert dropped.any() and not dropped.all()
        if seed == 0:
            # the doubled coefficient wraps: 30000 + 30000 as int16
            c = coef[1].reshape(-1) if not transposed else \
                coef[1].transpose(0, 1).reshape(-1)
            assert int(c[1 * 384 + 70]) == 60000 - 65536
            assert int(aux[1, 2, 2]) == 300 + 2048      # 2047 as bf16


def test_assemble_dense_matches_jax():
    li, lv, rb = _log(2, R=6)
    rows = np.arange(6) % MBH
    n_lanes = 4
    rng = np.random.default_rng(4)
    # each (lane, MB row) picks a scan row of its MB row, or none (NS)
    perm = np.where(rng.random(n_lanes * MBH) < 0.8,
                    rng.integers(0, 3, n_lanes * MBH) * MBH
                    + np.tile(np.arange(MBH), n_lanes), 6).astype(np.int32)
    assert (rows[perm[perm < 6]] == np.tile(np.arange(MBH), n_lanes)[
        perm < 6]).all() and (perm == 6).any()
    kw = dict(n_lanes=n_lanes, mb_width=MBW, mb_height=MBH)
    for transposed, jfn, tfn in (
            (False, JD.assemble_dense, TD.assemble_dense),
            (True, JD.assemble_dense_T, TD.assemble_dense_T)):
        coef, aux, _d = (t.numpy() for t in TD.log_to_dense_rows(
            *(torch.from_numpy(a) for a in (li, lv, rb)), mb_width=MBW,
            mb_count=MBC, transposed=transposed))
        out = _run(jfn, tfn, (coef, aux, perm), **kw)
        assert (out[0] != 0).any() and (out[2] != 0).any()


@pytest.mark.gpu
def test_blocks_on_card_match_cpu():
    """The blocks on CUDA tensors equal their CPU results, and K2
    (block_residuals_T on the card) equals block_residuals."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")

    def both(fn, *args, **kw):
        cpu = fn(*[torch.from_numpy(np.ascontiguousarray(a)) for a in args],
                 **kw)
        card = fn(*[torch.from_numpy(np.ascontiguousarray(a)).cuda()
                    for a in args], **kw)
        for a, b in zip(cpu if isinstance(cpu, tuple) else (cpu,),
                        card if isinstance(card, tuple) else (card,)):
            assert torch.equal(a, b.cpu())
        return cpu

    lev, intra, qs, qmat, nf = _levels(0)
    b = both(TI.dequant_levels, lev, intra, qs, qmat).numpy()
    both(TI.idct_8x8_flat, b)
    both(TI.idct_8x8_T, b.transpose(0, 2, 1))
    res = both(TI.block_residuals, lev, intra, qs, qmat, nf)
    rng = np.random.default_rng(3)
    both(TS.synthesis_step,
         rng.integers(-(1 << 30), 1 << 30, (64, 2, 10, 16)).astype(np.int32),
         rng.integers(-(1 << 30), 1 << 30, (64, 2, 8)).astype(np.int32))
    for transposed in (False, True):
        li, lv, rb = _log(0)
        both(TD.log_to_dense_rows, li, lv, rb, mb_width=MBW, mb_count=MBC,
             transposed=transposed)
    # K2 on the blocks' inputs: one quant matrix per lane, per-block
    # intra flags and qscales
    iq = np.broadcast_to(np.asarray(V.DEFAULT_INTRA_Q, np.int32)
                         .reshape(64), (2, 64))
    nq = np.full((2, 64), 16, np.int32)
    qmat = np.where(intra[..., None], iq[:, None], nq[:, None])
    want = TI.block_residuals(*[torch.from_numpy(np.ascontiguousarray(a))
                                for a in (lev, intra, qs, qmat, nf)])
    k2 = TI.block_residuals_T(*[torch.from_numpy(np.ascontiguousarray(a))
                                .cuda() for a in (
        lev.transpose(0, 2, 1).astype(np.int16), intra, qs, iq, nq, nf)])
    assert torch.equal(k2.cpu().transpose(1, 2).reshape(want.shape),
                       want.to(torch.int16))
    assert res.shape == want.shape
