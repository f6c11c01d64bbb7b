"""One case generator for the dense phase: K2F (idct.block_residuals_flat),
K3 / K3F (mocomp.predict_compose_put{,_flat}), K23
(mocomp.idct_compose_put), their plain forms and the JAX package's
dense_compose.

dense_case(seed, mb_width, mb_height, n_lanes) draws, from a numpy seed:

  * MB records whose vectors point past every edge, place the window at
    and just past each edge, or stay small -- every half-pel phase of
    luma and chroma (mv & 1, (mv >> 1) & 1) -- with the lanes in four
    roles by lane % 4: 0 a STALE / SKIP / INTER / INTRA mix, 1 the same
    mix on an inactive lane, 2 all STALE, 3 predicted only (SKIP and
    INTER); every MB carries random vector bits, INTRA and STALE ones
    too, which the kernels must ignore;
  * lane-minor levels int16[N, MB*384] (and the same levels transposed,
    [N, 64, MB*6]) with nfinal 0, 1, 2, 5 and 64, ordinary, escape,
    clip-extreme and int16-extreme values, intra DCs at position 0, and
    per-lane quantiser matrices;
  * residuals int16[N, MB*6, 64] (and transposed) for composing
    directly, a tenth of them over the whole int16 range (the int16
    wrap of pred + res);
  * both frame slots at 0..255 and a random parity.

With mb_width 1 and mb_height 3 a lane has 18 blocks, not a multiple of
K2F's four blocks a warp.  tests/test_torch_dense.py draws its cases
here and chip_smoke.py its edge case on the card.
"""

import numpy as np

from espflix_tpu_torch.core import vlc_tables as V

# (mb_width, mb_height) of the tests' cases: one MB column (and a ragged
# 18-block lane), the bench's width, MAX_MB_WIDTH
SHAPES = ((1, 3), (22, 3), (64, 2))
ROLES = ("mixed", "inactive", "stale", "predicted")
VARIANTS = ("mixed", "intra", "stray")


def edge_vectors(rng, shape, mb_axis, size):
    """Half-pel vectors int32[shape] along one axis of a plane `size`
    pixels wide (luma scale), for MBs at index mb_axis: a third uniform
    past every edge, a third placing the window origin at -2..0 or at
    size - 16 .. size - 14 with a random half-pel phase, a third small."""
    base = np.broadcast_to(mb_axis * 32, shape)
    uniform = rng.integers(-2 * size - 40, 2 * size + 41, shape)
    origin = rng.choice([-2, -1, 0, size - 16, size - 15, size - 14], shape)
    at_edge = 2 * origin + rng.integers(0, 2, shape) - base
    small = rng.integers(-3, 4, shape)
    pick = rng.integers(0, 3, shape)
    mv = np.choose(pick, [uniform, at_edge, small])
    return np.clip(mv, -2048, 2047).astype(np.int32)


def _records(rng, N, mbh, mbw, variant):
    shape = (N, mbh, mbw)
    role = np.arange(N)[:, None, None] % 4
    kind = np.where(role == 2, 0, rng.integers(0, 4, shape))
    kind = np.where(role == 3, rng.integers(1, 3, shape), kind)
    if variant == "intra":
        kind = np.where(role == 2, 0, 3)
    qs = rng.integers(1, 32, shape)
    mh = edge_vectors(rng, shape, np.arange(mbw)[None, None, :], 16 * mbw)
    mv = edge_vectors(rng, shape, np.arange(mbh)[None, :, None], 16 * mbh)
    rec = kind | (qs << 2) | ((mh & 0xFFF) << 7) | ((mv & 0xFFF) << 19)
    return rec.reshape(N, mbh * mbw).astype(np.int32)


def _levels(rng, intra_bl, nf):
    """int16[N, BL, 64] levels: nf[n, b] nonzero positions of one value
    class a block, intra DCs (0..255) at position 0."""
    N, BL = nf.shape
    cls = rng.integers(0, 4, (N, BL, 1))
    vals = np.choose(cls, [
        rng.integers(-40, 41, (N, BL, 64)),                   # ordinary
        rng.integers(-255, 256, (N, BL, 64)),                 # escapes
        rng.choice([-2048, -2047, 2047, 2048, -1, 1], (N, BL, 64)),
        rng.choice([-32768, 32767, -3000, 3000], (N, BL, 64))])
    rank = rng.random((N, BL, 64)).argsort(axis=2).argsort(axis=2)
    lev = np.where(rank < nf[..., None], vals, 0)
    lev[..., 0] = np.where(intra_bl & (nf > 0),
                           rng.integers(0, 256, (N, BL)), lev[..., 0])
    return lev.astype(np.int16)


def dense_case(seed: int, mb_width: int, mb_height: int,
               n_lanes: int = 4, variant: str = "mixed") -> dict:
    """A dense-phase case as numpy arrays (see the module docstring):
    recs, coeffs / coeffs_T, nfinal, iq, nq, res / res_T, active,
    frames (y, u, v, parity), mb_width, mb_height.  variant (VARIANTS):
    "mixed" the lane roles above (a P tick); "intra" every MB of lanes
    0, 1 and 3 INTRA (an I tick); "stray" levels past each block's
    nfinal nonzero too -- an uncoded block full of them, a non-intra DC
    shortcut with nonzero AC: the first must read 0, the second its DC
    alone."""
    if variant not in VARIANTS:
        raise ValueError(f"variant {variant!r}")
    rng = np.random.default_rng(seed)
    N, mbw, mbh = n_lanes, mb_width, mb_height
    MB, H, W = mbw * mbh, 16 * mbh, 16 * mbw
    BL = MB * 6
    recs = _records(rng, N, mbh, mbw, variant)
    intra_bl = np.repeat((recs & 3) == 3, 6, axis=1)
    nf = rng.choice([0, 1, 2, 5, 64], (N, BL)).astype(np.int32)
    lev = _levels(rng, intra_bl, nf)
    if variant == "stray":
        stray = rng.integers(-300, 301, lev.shape).astype(np.int16)
        lev = np.where(lev == 0, stray, lev)
    iq = np.stack([V.DEFAULT_INTRA_Q if n % 2 == 0 else
                   rng.integers(1, 256, 64) for n in range(N)])
    nq = np.stack([V.DEFAULT_NON_INTRA_Q if n % 2 == 0 else
                   rng.integers(1, 256, 64) for n in range(N)])
    res = rng.integers(-300, 301, (N, BL, 64))
    wide = rng.random((N, BL, 64)) < 0.1
    res = np.where(wide, rng.integers(-32768, 32768, (N, BL, 64)), res)
    res = res.astype(np.int16)
    frames = {k: rng.integers(0, 256, (N, 2) + ((H, W) if k == "y" else
                                                (H // 2, W // 2)),
                              dtype=np.uint8) for k in "yuv"}
    frames["parity"] = rng.integers(0, 2, N).astype(np.int32)
    return dict(
        mb_width=mbw, mb_height=mbh, recs=recs,
        coeffs=np.ascontiguousarray(lev.reshape(N, BL * 64)),
        coeffs_T=np.ascontiguousarray(lev.transpose(0, 2, 1)),
        nfinal=nf, iq=iq.astype(np.int32), nq=nq.astype(np.int32),
        res=res, res_T=np.ascontiguousarray(res.transpose(0, 2, 1)),
        active=np.arange(N) % 4 != 1, frames=frames)
