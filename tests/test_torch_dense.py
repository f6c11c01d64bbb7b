"""The dense phase on the shared edge cases (tools/dense_cases.py):
K2F's, K3's and K3F's plain forms vs the JAX package on the CPU, and
the kernels (K23 among them) vs those plain forms on the card.

Each case -- mb_width 1 (18 blocks a lane), 22 and 64 (MAX_MB_WIDTH),
vectors at and past every edge with every half-pel phase, STALE / SKIP
/ INTER / INTRA mixes, an inactive and an all-STALE lane, int16-extreme
levels and residuals -- goes through:

  * models/mpeg1.dense_compose on the coeffs_T path and on the
    lane-minor path (XLA, predict_plane_mxu's edge rule) against the
    port's dense_compose (K2 + K3 plain forms) and dense_compose_flat
    (K2F + K3F plain forms): new frames, parity and presented planes;
  * idct.block_residuals_flat (XLA) and idct_pallas.block_residuals_
    pallas (interpret mode) against block_residuals_flat_torch;
  * mocomp_pallas.predict_plane_phase2p and predict_chroma_pair_
    packedp(accum=True), the TPU path's K3 kernels, in interpret mode
    (they take planes up to 383 pixels wide: mb_width 1 and 22) against
    the port's prediction with the case's vectors;
  * the coeffs_T path on the case's variants -- an I tick, stray levels
    past nfinal, an odd lane count -- against the JAX package too;
  * on the card (`gpu`): K2, K2F, K3 and K3F against their plain forms
    on the case's levels and residuals, and the dense phase through the
    kernels against the plain dense phase; K23 (dense_compose's one
    pass) on every shape and variant, on levels at every copy width's
    alignment, and launched by a chain tick in place of K2 and K3.
"""

import numpy as np
import pytest
import torch

from espflix_tpu_torch.models import mpeg1 as TM
from espflix_tpu_torch.ops import idct as TI
from espflix_tpu_torch.ops import mocomp as TMC
from espflix_tpu_torch.tools.dense_cases import SHAPES, VARIANTS, dense_case

try:
    import jax.numpy as jnp
    from espflix_tpu.models import mpeg1 as JM
    from espflix_tpu.ops import idct as JI
    from espflix_tpu.ops import idct_pallas as JIP
    from espflix_tpu.ops import mocomp_pallas as JMP
except ImportError:     # the card's machine has no jax: gpu tests only
    jnp = JM = JI = JIP = JMP = None

torch.set_num_threads(1)

IDS = [f"{w}x{h}" for w, h in SHAPES]


def _case(shape, variant="mixed", n_lanes=4):
    return dense_case(200 + SHAPES.index(shape), *shape, n_lanes=n_lanes,
                      variant=variant)


# K23's cases: each variant on 4 lanes, and the mixed one on 5 (an odd
# lane count)
FUSED = [(v, 4) for v in VARIANTS] + [("mixed", 5)]
FUSED_IDS = [f"{v}-{n}lanes" for v, n in FUSED]


def _t(a, device="cpu"):
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def _frames(c, device="cpu"):
    return {k: _t(v.copy(), device) for k, v in c["frames"].items()}


def _dense_args(c, key, device="cpu"):
    return [_t(c[k], device) for k in (key, "recs", "nfinal", "iq", "nq",
                                       "active")]


def test_cases_cover_the_edges():
    """The generator's promises, on the bench-width case."""
    c = _case(SHAPES[1])
    mbw, mbh = c["mb_width"], c["mb_height"]
    N = c["recs"].shape[0]
    kind, mh, mv = (a.numpy() for a in TMC.mb_fields(_t(c["recs"]), mbw,
                                                     mbh))
    assert set(np.unique(kind[0])) == {0, 1, 2, 3}
    assert (kind[2] == 0).all() and not c["active"][1]
    assert set(np.unique(kind[3])) == {1, 2}
    for m, pos, n_mb in ((mh, np.arange(mbw)[None, None, :], mbw),
                         (mv, np.arange(mbh)[None, :, None], mbh)):
        origin = (pos * 32 + m) >> 1
        assert (origin < 0).any() and (origin > 16 * n_mb - 16).any()
        assert (origin == 0).any() and (origin == 16 * n_mb - 16).any()
        assert set(np.unique(m & 3)) == {0, 1, 2, 3}   # luma, chroma phase
    assert (np.abs(c["res"]) > 30000).any()
    assert (c["nfinal"] == 1).any() and (c["nfinal"] == 0).any()
    assert N == 4


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_dense_compose_matches_jax(shape):
    """K2 + K3 plain forms vs dense_compose's coeffs_T path (XLA)."""
    c = _case(shape)
    mbw, mbh = shape
    coeffs_T, recs, nf, iq, nq, active = (c[k] for k in (
        "coeffs_T", "recs", "nfinal", "iq", "nq", "active"))
    jf, jp = JM.dense_compose(
        None, jnp.asarray(recs), jnp.asarray(nf), jnp.asarray(iq),
        jnp.asarray(nq), jnp.asarray(active),
        {k: jnp.asarray(v) for k, v in c["frames"].items()},
        mb_width=mbw, mb_height=mbh, coeffs_T=jnp.asarray(coeffs_T))
    tf, tp = TM.dense_compose(*_dense_args(c, "coeffs_T"), _frames(c),
                              mb_width=mbw, mb_height=mbh)
    for k in ("y", "u", "v", "parity"):
        assert np.array_equal(tf[k].numpy(), np.asarray(jf[k])), k
    for k in "yuv":
        assert np.array_equal(tp[k].numpy(), np.asarray(jp[k])), k


@pytest.mark.parametrize("variant,n_lanes", FUSED[1:], ids=FUSED_IDS[1:])
def test_dense_compose_variants_match_jax(variant, n_lanes):
    """dense_compose's plain path (K2 + K3 plain forms, what K23 is held
    to on the card) vs the JAX coeffs_T path on K23's other cases at the
    bench's width: an I tick, stray levels past nfinal, 5 lanes."""
    shape = SHAPES[1]
    c = _case(shape, variant, n_lanes)
    mbw, mbh = shape
    jf, jp = JM.dense_compose(
        None, *[jnp.asarray(c[k]) for k in ("recs", "nfinal", "iq", "nq",
                                           "active")],
        {k: jnp.asarray(v) for k, v in c["frames"].items()},
        mb_width=mbw, mb_height=mbh, coeffs_T=jnp.asarray(c["coeffs_T"]))
    tf, tp = TM.dense_compose(*_dense_args(c, "coeffs_T"), _frames(c),
                              mb_width=mbw, mb_height=mbh)
    for k in ("y", "u", "v", "parity"):
        assert np.array_equal(tf[k].numpy(), np.asarray(jf[k])), k
    for k in "yuv":
        assert np.array_equal(tp[k].numpy(), np.asarray(jp[k])), k


def test_variants_hold_what_they_promise():
    """The I tick is INTRA on lanes 0, 1 and 3; stray levels fill
    uncoded blocks and sit beside the DC of non-intra DC shortcuts."""
    mbw, mbh = SHAPES[1]
    c = _case(SHAPES[1], "intra")
    kind = c["recs"] & 3
    assert (kind[[0, 1, 3]] == 3).all() and (kind[2] == 0).all()
    s = _case(SHAPES[1], "stray")
    lev = s["coeffs"].reshape(4, -1, 64)
    nf = s["nfinal"]
    intra = np.repeat((s["recs"] & 3) == 3, 6, axis=1)
    assert (lev[nf == 0] != 0).any(axis=1).all()
    assert (lev[(nf == 1) & ~intra][:, 1:] != 0).any()


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_flat_dense_compose_matches_jax(shape):
    """K2F + K3F plain forms vs dense_compose's lane-minor path (XLA)."""
    c = _case(shape)
    mbw, mbh = shape
    jf, jp = JM.dense_compose(
        *[jnp.asarray(c[k]) for k in ("coeffs", "recs", "nfinal", "iq",
                                      "nq", "active")],
        {k: jnp.asarray(v) for k, v in c["frames"].items()},
        mb_width=mbw, mb_height=mbh)
    tf, tp = TM.dense_compose_flat(*_dense_args(c, "coeffs"), _frames(c),
                                   mb_width=mbw, mb_height=mbh)
    for k in ("y", "u", "v", "parity"):
        assert np.array_equal(tf[k].numpy(), np.asarray(jf[k])), k
    for k in "yuv":
        assert np.array_equal(tp[k].numpy(), np.asarray(jp[k])), k


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_flat_residuals_match_jax(shape):
    """block_residuals_flat_torch vs idct.block_residuals_flat (XLA) and
    the Pallas block_residuals_pallas (interpret mode)."""
    c = _case(shape)
    recs, nf, iq, nq = c["recs"], c["nfinal"], c["iq"], c["nq"]
    N, BL = nf.shape
    MB = BL // 6
    port = TI.block_residuals_flat_torch(
        *[_t(a) for a in (c["coeffs"], recs, nf, iq, nq)]).numpy()
    intra = np.broadcast_to(((recs & 3) == 3)[:, :, None], (N, MB, 6))
    qs = np.broadcast_to(((recs >> 2) & 31)[:, :, None], (N, MB, 6))
    qmat = np.where(intra[..., None], iq[:, None, None, :],
                    nq[:, None, None, :])
    args = [jnp.asarray(a) for a in (
        c["coeffs"].reshape(N, MB, 6, 64).astype(np.int32), intra, qs,
        qmat, nf.reshape(N, MB, 6))]
    xla = np.asarray(JI.block_residuals_flat(*args).astype(jnp.int16))
    pal = np.asarray(JIP.block_residuals_pallas(*args, interpret=True))
    assert np.array_equal(port, xla.reshape(N, BL, 64))
    assert np.array_equal(port, pal.reshape(N, BL, 64).astype(np.int16))
    assert (np.abs(port.astype(np.int32)) > 2000).any()


@pytest.mark.parametrize("shape", SHAPES[:2], ids=IDS[:2])
def test_prediction_matches_tpu_kernels(shape):
    """The prediction K3 composes, on the case's vectors, vs the TPU
    path's kernels predict_plane_phase2p (luma) and predict_chroma_pair_
    packedp (u + v, accum=True) in interpret mode."""
    c = _case(shape)
    mbw, mbh = shape
    _kind, mh, mv = (a.numpy() for a in TMC.mb_fields(_t(c["recs"]), mbw,
                                                      mbh))
    lanes = np.arange(mh.shape[0])
    ref = {k: c["frames"][k][lanes, 1 - c["frames"]["parity"]]
           for k in "yuv"}
    jy = JMP.predict_plane_phase2p(jnp.asarray(ref["y"]), jnp.asarray(mh),
                                   jnp.asarray(mv), 16, interpret=True)
    ju, jv = JMP.predict_chroma_pair_packedp(
        jnp.asarray(ref["u"]), jnp.asarray(ref["v"]),
        jnp.asarray(mh >> 1), jnp.asarray(mv >> 1), interpret=True,
        accum=True)
    for k, j, S, m in (("y", jy, 16, 0), ("u", ju, 8, 1), ("v", jv, 8, 1)):
        port = TMC.predict_plane_torch(_t(ref[k]), _t(mh >> m),
                                       _t(mv >> m), S)
        assert np.array_equal(port.numpy(), np.asarray(j)), k


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"


@pytest.mark.gpu
@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_idct_T_kernel_matches_plain_on_card(shape):
    """K2 alone on the case's transposed levels: BL 18, 396 and 768 take
    its 4-, 8- and 16-byte vectors, BL 18 and 396 a ragged last tile."""
    dev = _card()
    c = _case(shape)
    intra = np.repeat((c["recs"] & 3) == 3, 6, axis=1)
    qs = np.repeat((c["recs"] >> 2) & 31, 6, axis=1).astype(np.int32)
    args = [c["coeffs_T"], intra, qs, c["iq"], c["nq"], c["nfinal"]]
    got = TI.block_residuals_T(*[_t(a, dev) for a in args])
    assert torch.equal(got.cpu(), TI.block_residuals_T_torch(
        *[_t(a) for a in args]))


@pytest.mark.gpu
@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_flat_idct_kernel_matches_plain_on_card(shape):
    dev = _card()
    c = _case(shape)
    args = [c[k] for k in ("coeffs", "recs", "nfinal", "iq", "nq")]
    got = TI.block_residuals_flat(*[_t(a, dev) for a in args])
    assert torch.equal(got.cpu(), TI.block_residuals_flat_torch(
        *[_t(a) for a in args]))


@pytest.mark.gpu
@pytest.mark.parametrize("flat", [False, True], ids=["K3", "K3F"])
@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_compose_kernels_match_plain_on_card(shape, flat):
    dev = _card()
    c = _case(shape)
    mbw, mbh = shape
    fn = TMC.predict_compose_put_flat if flat else TMC.predict_compose_put
    res = c["res"] if flat else c["res_T"]
    outs = []
    for d in ("cpu", dev):
        fr = _frames(c, d)
        p = fn(_t(res, d), _t(c["recs"], d), _t(c["active"], d), fr,
               mb_width=mbw, mb_height=mbh)
        outs.append([p[k].cpu() for k in "yuv"] +
                    [fr[k].cpu() for k in "yuv"])
    for a, b in zip(*outs):
        assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("flat", [False, True], ids=["K2+K3", "K2F+K3F"])
@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_dense_phase_kernels_match_plain_on_card(shape, flat):
    dev = _card()
    c = _case(shape)
    mbw, mbh = shape
    fn = TM.dense_compose_flat if flat else TM.dense_compose
    key = "coeffs" if flat else "coeffs_T"
    outs = []
    for d in ("cpu", dev):
        fr, pres = fn(*_dense_args(c, key, d), _frames(c, d),
                      mb_width=mbw, mb_height=mbh)
        outs.append([t.cpu() for t in (*fr.values(), *pres.values())])
    for a, b in zip(*outs):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_compose_kernels_refuse_misaligned_frames_on_card():
    """K3, K3F and K23 move 16-byte vectors: a frames tensor that starts
    off a 16-byte boundary is refused before the launch."""
    dev = _card()
    c = _case(SHAPES[0])
    mbw, mbh = SHAPES[0]
    fr = _frames(c, dev)
    y = fr["y"]
    buf = torch.empty(y.numel() + 1, dtype=torch.uint8, device=dev)
    fr["y"] = buf[1:].view(y.shape)
    fr["y"].copy_(y)
    for fn, res in ((TMC.predict_compose_put, c["res_T"]),
                    (TMC.predict_compose_put_flat, c["res"])):
        with pytest.raises(ValueError, match="16-byte"):
            fn(_t(res, dev), _t(c["recs"], dev), _t(c["active"], dev), fr,
               mb_width=mbw, mb_height=mbh)
    with pytest.raises(ValueError, match="16-byte"):
        TMC.idct_compose_put(*_dense_args(c, "coeffs_T", dev), fr,
                             mb_width=mbw, mb_height=mbh)


def _dense_on(c, device, coeffs_T=None):
    """dense_compose on `device`: frames (both slots, parity) and the
    presented planes, on the CPU."""
    mbw, mbh = c["mb_width"], c["mb_height"]
    args = _dense_args(c, "coeffs_T", device)
    if coeffs_T is not None:
        args[0] = coeffs_T
    fr, pres = TM.dense_compose(*args, _frames(c, device), mb_width=mbw,
                                mb_height=mbh)
    return {**{k: fr[k].cpu() for k in ("y", "u", "v", "parity")},
            **{f"presented_{k}": pres[k].cpu() for k in "yuv"}}


@pytest.mark.gpu
@pytest.mark.parametrize("variant,n_lanes", FUSED, ids=FUSED_IDS)
@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_fused_kernel_matches_plain_on_card(shape, variant, n_lanes):
    """K23 (dense_compose on the card) against K2's plain form then K3's:
    both frame slots, parity and the presented planes.  The cases hold
    intra DCs, +-2048 clips and int16-wrapping residuals, vectors at and
    past all four edges in every half-pel phase, STALE MBs, an inactive
    and an all-STALE lane; mb_width 1, 22 and 64 take K23's 2-, 4- and
    8-int16 copies."""
    dev = _card()
    c = _case(shape, variant, n_lanes)
    before = (TMC.launches_fused, TI.launches, TMC.launches)
    got = _dense_on(c, dev)
    assert (TMC.launches_fused, TI.launches, TMC.launches) == (
        before[0] + 1, before[1], before[2])
    want = _dense_on(c, "cpu")
    for k, v in want.items():
        assert torch.equal(got[k], v), k


@pytest.mark.gpu
@pytest.mark.parametrize("offset", [1, 2], ids=["V1", "V2"])
def test_fused_kernel_takes_misaligned_levels_on_card(offset):
    """Levels that start `offset` int16 past a 16-byte boundary take
    K23's 1- and 2-int16 copies at the bench's width (whose rows allow
    4): equal to the plain path."""
    dev = _card()
    c = _case(SHAPES[1], "stray")
    ct = _t(c["coeffs_T"], dev)
    buf = torch.empty(ct.numel() + 8, dtype=torch.int16, device=dev)
    view = buf[offset:offset + ct.numel()].view(ct.shape)
    view.copy_(ct)
    assert view.data_ptr() % 16 == 2 * offset
    got = _dense_on(c, dev, view)
    want = _dense_on(c, "cpu")
    for k, v in want.items():
        assert torch.equal(got[k], v), k


@pytest.mark.gpu
def test_chain_tick_launches_fused_kernel_on_card():
    """A chain tick on the card decodes through K23 alone: its counter
    moves, K2's and K3's do not."""
    dev = _card()
    from espflix_tpu_torch.models import sbc as dsbc
    from espflix_tpu_torch.ops import delta_sigma as DS
    from espflix_tpu_torch.runtime import chain as CH
    from espflix_tpu_torch.runtime.workload import bench_chunk
    xs_np, kw, _ = bench_chunk(8)
    xs = CH.xs_to_torch({k: v[:1] for k, v in xs_np.items()}, dev)
    N, mbw, mbh = 8, kw["mb_width"], kw["mb_height"]
    frames = TM.init_frame_state(N, mbw * 16, mbh * 16, dev)
    tap = torch.zeros(1, dtype=torch.int32, device=dev)
    before = (TMC.launches_fused, TI.launches, TMC.launches)
    _fr, _sb, _ds, outs = CH.run_full_chunk(
        xs, frames, dsbc.init_state(N, dev), DS.init_state(N, dev), tap,
        None, **dict(kw, tap=1, return_planes=True))
    torch.cuda.synchronize()
    assert not outs["err"].any()
    assert (TMC.launches_fused, TI.launches, TMC.launches) == (
        before[0] + 1, before[1], before[2])
