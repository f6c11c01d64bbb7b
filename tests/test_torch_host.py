"""Host helpers copied into the PyTorch port equal the JAX package's.

The port (espflix_tpu_torch) never imports jax, so the numpy host code
of jax-importing modules is copied; these tests pin every copy to its
original: ES segmentation and batch assembly, slice-row packing, the
row permutation, the scanner LUTs and constants, the composite
templates and dither, the beep wave, SBC word packing, and the state
conversion between the two packages.
"""

import numpy as np
import pytest
import torch

from espflix_tpu.models import mpeg1 as JM
from espflix_tpu.models import sbc as JSBC
from espflix_tpu.ops import composite as JCO
from espflix_tpu.ops import composite_pallas as JCP
from espflix_tpu.ops import scan_dense as JSD
from espflix_tpu.ops import vlc_scan as JVS
from espflix_tpu.ops import vlc_scan_pallas as JVP
from espflix_tpu.runtime import chain as JCH
from espflix_tpu.runtime import output as JOUT
from espflix_tpu.tools import mpeg1_encode as E
from espflix_tpu.tools.content import realistic_gop_script
from espflix_tpu.tools.sbc_encode import random_frame
from espflix_tpu_torch.models import mpeg1 as TM
from espflix_tpu_torch.models import sbc as TSBC
from espflix_tpu_torch.ops import composite as TCO
from espflix_tpu_torch.ops import scan_dense as TSD
from espflix_tpu_torch.ops import vlc_scan as TVS
from espflix_tpu_torch.runtime import chain as TCH

torch.set_num_threads(1)


def _streams():
    rng = np.random.default_rng(3)
    out = [E.encode_es(E.random_script(rng, n_pictures=2, max_coeffs=10,
                                       width=96, height=64))]
    out.append(E.encode_es(realistic_gop_script(
        np.random.default_rng(1000), n_pictures=3)))
    return out


STREAMS = _streams()


def _eq_dict(a: dict, b: dict):
    assert a.keys() == b.keys()
    for k in a:
        x, y = a[k], b[k]
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype and np.array_equal(x, y), k
        else:
            assert x == y, k


@pytest.mark.parametrize("si", range(len(STREAMS)))
def test_find_start_codes_and_parse_es(si):
    es = STREAMS[si]
    assert TM.find_start_codes(es) == JM.find_start_codes(es)
    js, jp = JM.parse_es(es)
    ts, tp = TM.parse_es(es)
    assert (ts.width, ts.height) == (js.width, js.height)
    assert np.array_equal(ts.intra_q, js.intra_q)
    assert np.array_equal(ts.non_intra_q, js.non_intra_q)
    assert len(tp) == len(jp)
    for a, b in zip(tp, jp):
        assert (a.pic_type, a.full_pel, a.r_size, a.payload,
                a.slice_offsets, a.slice_rows, a.pts) == \
            (b.pic_type, b.full_pel, b.r_size, b.payload,
             b.slice_offsets, b.slice_rows, b.pts)


@pytest.mark.parametrize("si", range(len(STREAMS)))
def test_make_picture_batch(si):
    jp = JM.parse_es(STREAMS[si])[1]
    tp = TM.parse_es(STREAMS[si])[1]
    sel = [0, None, 1, 0]
    wpl = max((len(p.payload) + 3) // 4 + 8 for p in jp)
    mbh = jp[0].seq.mb_height
    jb = JM.make_picture_batch([jp[i] if i is not None else None
                                for i in sel], words_per_lane=wpl,
                               max_slices=mbh)
    tb = TM.make_picture_batch([tp[i] if i is not None else None
                                for i in sel], words_per_lane=wpl,
                               max_slices=mbh)
    _eq_dict(tb, jb)


def test_make_picture_batch_all_idle():
    jb = JM.make_picture_batch([None] * 3, words_per_lane=16,
                               geometry=(6, 4))
    tb = TM.make_picture_batch([None] * 3, words_per_lane=16,
                               geometry=(6, 4))
    _eq_dict(tb, jb)


def test_init_frame_state_matches():
    j = JM.init_frame_state(3, 96, 64)
    t = TM.init_frame_state(3, 96, 64, "cpu")
    for k in j:
        a = np.asarray(j[k])
        b = t[k].numpy()
        assert a.shape == b.shape and a.dtype == b.dtype, k
        assert np.array_equal(a, b)


def _batch(si, n=6):
    pics = JM.parse_es(STREAMS[si])[1]
    wpl = max((len(p.payload) + 3) // 4 + 4 for p in pics)
    return JM.make_picture_batch([pics[i % len(pics)] for i in range(n)],
                                 words_per_lane=wpl,
                                 max_slices=pics[0].seq.mb_height)


@pytest.mark.parametrize("si", range(len(STREAMS)))
@pytest.mark.parametrize("sort_rows", [False, True])
@pytest.mark.parametrize("device_windows", [False, True])
def test_pack_slice_rows(si, sort_rows, device_windows):
    b = _batch(si)
    j = JVP.pack_slice_rows(b, sort_rows=sort_rows,
                            device_windows=device_windows)
    t = TVS.pack_slice_rows(b, sort_rows=sort_rows,
                            device_windows=device_windows)
    _eq_dict(t, j)


def test_pack_slice_rows_overflow():
    b = _batch(0, n=4)
    _eq_dict(TVS.pack_slice_rows(b, words_window=8),
             JVP.pack_slice_rows(b, words_window=8))


@pytest.mark.parametrize("si", range(len(STREAMS)))
def test_row_perm(si):
    b = _batch(si)
    sl = JVP.pack_slice_rows(b, sort_rows=True)
    mbh = int(b["mb_height"])
    args = (sl["lane_of_row"], sl["rows"], sl["alive"], 6, mbh)
    for x, y in zip(TSD.row_perm(*args), JSD.row_perm(*args)):
        assert x.dtype == y.dtype and np.array_equal(x, y)


def test_row_perm_duplicate_claims():
    lane_of_row = np.array([0, 0, 1, 1, 0], np.int32)
    rows = np.array([2, 2, 0, 5, 1], np.int32)   # lane 0 row 2 twice
    alive = np.array([1, 1, 1, 1, 1], np.int32)
    for x, y in zip(TSD.row_perm(lane_of_row, rows, alive, 2, 4),
                    JSD.row_perm(lane_of_row, rows, alive, 2, 4)):
        assert np.array_equal(x, y)


@pytest.mark.parametrize("win", [32, 100])
def test_gather_scan_rows(win):
    b = _batch(1)
    d = JVP.pack_slice_rows(b, sort_rows=True, device_windows=True)
    j = np.asarray(JVP.gather_scan_rows(d["lane_words"], d["row_base"],
                                        d["lane_of_row"], win))
    t = TVS.gather_scan_rows(
        torch.from_numpy(d["lane_words"].view(np.int32)),
        torch.from_numpy(d["row_base"]), torch.from_numpy(d["lane_of_row"]),
        win)
    assert np.array_equal(t.numpy().view(np.uint32), j)


def test_scanner_luts_and_constants():
    tl, tb, tbits = TVS._mega_lut_np()
    jl, jb, jbits = JVS._mega_lut_np()
    assert np.array_equal(tl, jl) and tl.dtype == jl.dtype
    assert tb == jb and tbits == jbits and tb == TVS.LUT_BASES
    assert np.array_equal(TVS._next_block_lut_np(),
                          JVS._next_block_lut_np())
    assert np.array_equal(TVS.ZZ_NP, JVS.ZZ_NP)
    names = [n for n in dir(JVS) if n.startswith(("ST_", "MB_", "K_"))]
    assert len(names) >= 19
    for n in names:
        assert getattr(TVS, n) == getattr(JVS, n), n
    assert TVS.NUM_STATES == JVS.NUM_STATES


@pytest.mark.parametrize("pal", [False, True])
def test_composite_constants(pal):
    assert np.array_equal(TCO._dither_planes(192, 352),
                          JCO._dither_planes(192, 352))
    assert np.array_equal(TCO._line_templates(pal),
                          JCO._line_templates(pal))
    assert np.array_equal(TCO._templates_cached(pal),
                          JCO._templates_cached(pal))
    tt, td, _ = TCO._packed_consts(pal)
    jt, jd, _ = JCP._packed_consts(pal)
    assert np.array_equal(tt, jt) and tt.dtype == jt.dtype
    assert np.array_equal(td, jd) and td.dtype == jd.dtype
    assert TCO._parts_consts(pal)[0] == JCP._parts_consts(pal)[0]
    assert (TCO.OSD_W, TCO.OSD_H, TCO.OSD_PROGRESS_W) == \
        (JCO.OSD_W, JCO.OSD_H, JCO.OSD_PROGRESS_W)


@pytest.mark.parametrize("n", [1, 1664, 3328])
def test_beep_wave(n):
    assert np.array_equal(TCH._SIN32, JOUT._SIN32)
    a, b = TCH.beep_wave(n), JCH.beep_wave(n)
    assert a.dtype == b.dtype and np.array_equal(a, b)


def test_frames_to_words():
    rng = np.random.default_rng(1)
    fr = np.stack([np.frombuffer(random_frame(rng, mode=0, bitpool=28),
                                 np.uint8) for _ in range(5)])[None]
    a, b = TSBC.frames_to_words(fr), JSBC.frames_to_words(fr)
    assert a.dtype == b.dtype and np.array_equal(a, b)


def test_keys_match():
    assert TCH.DECODE_KEYS == JCH.DECODE_KEYS
    assert TCH.DECODE_KEYS_DW == JCH.DECODE_KEYS_DW
    assert TCH.OUTPUT_KEYS == JCH.OUTPUT_KEYS


def test_state_roundtrip():
    rng = np.random.default_rng(2)
    frames = dict(y=rng.integers(0, 256, (2, 2, 8, 8), dtype=np.uint8),
                  u=rng.integers(0, 256, (2, 2, 4, 4), dtype=np.uint8),
                  v=rng.integers(0, 256, (2, 2, 4, 4), dtype=np.uint8),
                  parity=np.array([0, 1], np.int32))
    sbc = rng.integers(-9, 9, (2, 2, 10, 16)).astype(np.int32)
    ds = rng.integers(-9, 9, (2, 3)).astype(np.int32)
    fr_t, sbc_t, ds_t = TCH.state_from_numpy(frames, sbc, ds, "cpu")
    assert fr_t["y"].dtype == torch.uint8
    assert fr_t["parity"].dtype == torch.int32
    assert sbc_t.dtype == torch.int32 and ds_t.dtype == torch.int32
    fr2, sbc2, ds2 = TCH.state_to_numpy(fr_t, sbc_t, ds_t)
    for k in frames:
        assert fr2[k].dtype == frames[k].dtype
        assert np.array_equal(fr2[k], frames[k])
    assert np.array_equal(sbc2, sbc) and np.array_equal(ds2, ds)
