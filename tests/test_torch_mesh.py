"""The mesh's decoders: the port's parallel/mesh.py vs the JAX package.

The JAX side runs on the conftest's 8 virtual CPU devices (Pallas in
interpret mode); the port's mesh is [cpu] * 8 in one process, so every
shard runs the plain forms.  Same numpy inputs, exact equality:

  * make_sharded_decoder (the device parser per shard) on a (8,)
    'streams' mesh, three pictures with the frames carried, and
    gather_metrics (the recipe of test_mesh.py:24-72);
  * make_sharded_pallas_decoder (K1, K2, K3P, torch compose per shard)
    on rows from pack_slice_rows_sharded, two realistic pictures
    (test_mesh.py:140-192), and the packer itself;
  * make_space_sharded_dense on a (2, 4) mesh, one MB row per shard,
    the reference planes gathered along 'space' (test_mesh.py:75-137);
  * shard / unshard round trips over both meshes.
"""

import numpy as np
import pytest
import torch

from espflix_tpu_torch.models import mpeg1 as TM
from espflix_tpu_torch.ops import scan_dense as TSD
from espflix_tpu_torch.ops import vlc_scan as TVS
from espflix_tpu_torch.parallel import mesh as TPM
from espflix_tpu_torch.tools import mpeg1_encode as TE
from espflix_tpu_torch.tools.content import realistic_gop_script

import jax
import jax.numpy as jnp
from espflix_tpu.models import mpeg1 as JM
from espflix_tpu.ops import scan_dense as JSD
from espflix_tpu.ops import vlc_scan as JVS
from espflix_tpu.parallel import mesh as JPM

torch.set_num_threads(1)

CPU8 = [torch.device("cpu")] * 8


def _need8():
    if len(jax.devices()) < 8:
        pytest.skip("needs the conftest's 8 virtual devices")


def _frames_np(rng, N, mbw, mbh):
    fr = {k: rng.integers(0, 249, (N, 2) + (
        (mbh * 16, mbw * 16) if k == "y" else (mbh * 8, mbw * 8)),
        dtype=np.uint8) for k in "yuv"}
    fr["parity"] = rng.integers(0, 2, N).astype(np.int32)
    return fr


def _assert_tree_equal(mesh, port, jax_tree, spec=TPM.LANES):
    for k, v in jax_tree.items():
        a = TPM.unshard(mesh, port[k], spec).numpy()
        b = np.asarray(v)
        assert a.dtype == b.dtype and np.array_equal(a, b), k


def test_shard_unshard_round_trip():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.integers(0, 99, (8, 6, 4)))
    m1 = TPM.make_mesh(devices=CPU8)
    m2 = TPM.make_space_mesh(2, 4, devices=CPU8)
    assert m1.shape == {"streams": 8} and m2.shape == {"streams": 2,
                                                         "space": 4}
    for mesh, spec in ((m1, TPM.LANES), (m1, TPM.AXIS1[:1]),
                       (m2, ("streams", None, "space")),
                       (m2, ("streams",)), (m2, ("space", "streams"))):
        parts = TPM.shard(mesh, x, spec)
        assert len(parts) == mesh.size
        assert torch.equal(TPM.unshard(mesh, parts, spec), x)
    parts = TPM.shard(m2, x, ("streams", None, "space"))
    assert parts[5].shape == (4, 6, 1)
    assert torch.equal(parts[5], x[4:8, :, 1:2])

def test_make_mesh_needs_cards(monkeypatch):
    # the default mesh spans the visible cards and raises without one
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError):
        TPM.make_mesh()


def test_sharded_decoder_matches_jax():
    _need8()
    rng = np.random.default_rng(5)
    es = TE.encode_es(TE.random_script(rng, n_pictures=2, max_coeffs=4,
                                       width=96, height=64))
    pics = TM.parse_es(es)[1]
    mbw, mbh = pics[0].seq.mb_width, pics[0].seq.mb_height
    wpl = max((len(p.payload) + 3) // 4 + 4 for p in pics)
    N = 16
    jmesh = JPM.make_mesh()
    tmesh = TPM.make_mesh(devices=CPU8)
    jdec = JPM.make_sharded_decoder(jmesh, mb_width=mbw, mb_height=mbh,
                                    max_steps=wpl * 32)
    tdec = TPM.make_sharded_decoder(tmesh, mb_width=mbw, mb_height=mbh,
                                    max_steps=wpl * 32)
    fr = _frames_np(np.random.default_rng(6), N, mbw, mbh)
    jf = JPM.shard_lane_tree(jmesh, {k: jnp.asarray(v)
                                     for k, v in fr.items()})
    tf = TPM.shard_lane_tree(tmesh, fr)
    for t, pic in enumerate(pics):
        sel = [None if (t == 1 and i % 5 == 0) else pic for i in range(N)]
        b = TM.make_picture_batch(sel, words_per_lane=wpl, max_slices=mbh)
        jf, jp, ji = jdec(*JPM.shard_lane_tree(jmesh, tuple(
            jnp.asarray(b[k]) for k in TM.PICTURE_KEYS)), jf)
        tf, tp, ti = tdec(*(b[k] for k in TM.PICTURE_KEYS), tf)
        _assert_tree_equal(tmesh, tf, jf)
        _assert_tree_equal(tmesh, tp, jp)
        _assert_tree_equal(tmesh, ti, ji)
        assert len(tp["y"]) == 8 and tp["y"][0].shape[0] == 2
    je, jit = JPM.gather_metrics(jmesh, ji["error"], ji["iters"])
    te, tit = TPM.gather_metrics(tmesh, ti["error"], ti["iters"])
    assert int(te) == int(je) == 0 and int(tit) == int(jit) > 0


def test_pack_slice_rows_sharded_matches_jax():
    rng = np.random.default_rng(7)
    pics = TM.parse_es(TE.encode_es(realistic_gop_script(
        rng, n_pictures=2)))[1]
    b = TM.make_picture_batch([pics[0], None, pics[1], pics[0]] * 2,
                              max_slices=12)
    b["n_slices"][3] = 0
    for dw in (False, True):
        jsl, jdup = JSD.pack_slice_rows_sharded(b, 4, 12, device_windows=dw)
        tsl, tdup = TSD.pack_slice_rows_sharded(b, 4, 12, device_windows=dw)
        assert np.array_equal(jdup, tdup) and jsl.keys() == tsl.keys()
        for k in jsl:
            assert np.array_equal(np.asarray(jsl[k]), np.asarray(tsl[k])), k


def test_sharded_pallas_decoder_matches_jax():
    _need8()
    rng = np.random.default_rng(1000)
    pics = TM.parse_es(TE.encode_es(realistic_gop_script(
        rng, n_pictures=3)))[1]
    mbw, mbh = pics[0].seq.mb_width, pics[0].seq.mb_height
    wpl = max((len(p.payload) + 3) // 4 + 4 for p in pics)
    N = 16
    jmesh = JPM.make_mesh()
    tmesh = TPM.make_mesh(devices=CPU8)
    ln = N // 8
    kw = dict(mb_width=mbw, mb_height=mbh,
              long_rows=max(8, min(2 * ln, ln * mbh // 2)),
              steps_long=1024, steps_short=1024)
    jdec = JPM.make_sharded_pallas_decoder(jmesh, interpret=True, **kw)
    tdec = TPM.make_sharded_pallas_decoder(tmesh, **kw)
    fr = _frames_np(np.random.default_rng(8), N, mbw, mbh)
    jf = JPM.shard_lane_tree(jmesh, {k: jnp.asarray(v)
                                     for k, v in fr.items()})
    tf = TPM.shard_lane_tree(tmesh, fr)
    keys = TM.SCAN_KEYS + ("perm",)
    for t, pic in enumerate(pics[:2]):
        sel = [pic if i % 3 else None for i in range(N)]
        b = TM.make_picture_batch(sel, words_per_lane=wpl, max_slices=mbh)
        sl, dup = TSD.pack_slice_rows_sharded(b, 8, mbh)
        assert not dup.any() and not sl["overflow"].any()
        args = [sl[k] for k in keys] + [
            b[k] for k in ("intra_q", "non_intra_q", "active")]
        jf, jp, ji = jdec(*JPM.shard_lane_tree(
            jmesh, tuple(jnp.asarray(a) for a in args)), jf)
        tf, tp, ti = tdec(*args, tf)
        _assert_tree_equal(tmesh, tf, jf)
        _assert_tree_equal(tmesh, tp, jp)
        _assert_tree_equal(tmesh, ti, ji)
    assert not TPM.unshard(tmesh, ti["error"], TPM.LANES).any()


def test_space_sharded_dense_matches_jax():
    """(streams=2, space=4): each shard holds one MB row of two lanes and
    predicts it from the gathered reference planes (rule B)."""
    _need8()
    rng = np.random.default_rng(21)
    W, H = 96, 64
    lanes = 2
    es = TE.encode_es(TE.random_script(rng, n_pictures=3, max_coeffs=6,
                                       width=W, height=H))
    pics = TM.parse_es(es)[1]
    mbw, mbh = pics[0].seq.mb_width, pics[0].seq.mb_height
    wpl = max((len(p.payload) + 3) // 4 + 4 for p in pics)
    jmesh = JPM.make_space_mesh(2, 4)
    tmesh = TPM.make_space_mesh(2, 4, devices=CPU8)
    jdense = JPM.make_space_sharded_dense(jmesh, mb_width=mbw,
                                          mb_height=mbh)
    tdense = TPM.make_space_sharded_dense(tmesh, mb_width=mbw,
                                          mb_height=mbh)
    fr = _frames_np(np.random.default_rng(22), lanes, mbw, mbh)
    jf = {k: jnp.asarray(v) for k, v in fr.items()}
    tf = fr
    fspec = TPM.frames_specs()
    for p in pics:
        b = TM.make_picture_batch([p] * lanes, words_per_lane=wpl,
                                  max_slices=mbh)
        st0 = JVS.initial_state(lanes, *(jnp.asarray(b[k])
                                         for k in TM.PICTURE_KEYS[1:7]))
        coeffs, recs, nfinal, st, _ = JVS.run_scan(
            jnp.asarray(b["words"]), st0, mbw, mbw * mbh, 4096)
        assert not np.asarray(st["error"]).any()
        c3 = np.asarray(coeffs).reshape(lanes, mbh, mbw * 384)
        r3 = np.asarray(recs).reshape(lanes, mbh, mbw)
        n3 = np.asarray(nfinal).reshape(lanes, mbh, mbw * 6)
        lane_args = [b[k] for k in ("intra_q", "non_intra_q", "active")]
        jf, jp = jdense(*(jnp.asarray(a) for a in [c3, r3, n3]
                          + lane_args), jf)
        tf, tp = tdense(c3, r3, n3, *lane_args, tf)
        for k in "yuv":
            assert np.array_equal(TPM.unshard(tmesh, tp[k],
                                              TPM.PRESENTED).numpy(),
                                  np.asarray(jp[k])), k
        for k in ("y", "u", "v", "parity"):
            assert np.array_equal(TPM.unshard(tmesh, tf[k],
                                              fspec[k]).numpy(),
                                  np.asarray(jf[k])), k
        assert tp["y"][1].shape == (1, 16, W)
