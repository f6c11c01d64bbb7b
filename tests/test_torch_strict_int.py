"""The port's strict_int on torch tensors, and its refdec copy.

utils/strict_int.py keeps the JAX package's helpers with a torch branch
in place of the lazy jax.numpy one: on int32 tensors each helper equals
the original on the same numpy arrays (negative operands, int8 edges,
every DC size, random dequant inputs), and on plain ints and numpy
arrays the port's helpers are the original's.  core/refdec.py, the
scalar MPEG-1 decoder on the port's strict_int, decodes an encoded
random stream to the same frames as the original.
"""

import numpy as np
import pytest
import torch

from espflix_tpu.utils import strict_int as JSI
from espflix_tpu_torch.utils import strict_int as TSI


def _rand(seed, n=2048):
    rng = np.random.default_rng(seed)
    levels = np.concatenate([rng.integers(-255, 256, n - 8),
                             [-256, -255, -1, 0, 1, 127, 128, 255]])
    return (levels.astype(np.int32),
            rng.integers(0, 2, n).astype(bool),
            rng.integers(1, 32, n).astype(np.int32),
            rng.integers(1, 128, n).astype(np.int32))


def _args(seed):
    """name -> (numpy args) of each element-wise helper."""
    lv, intra, qs, q = _rand(seed)
    a = np.concatenate([np.arange(-600, 600, 7),
                        [-2 ** 31 + 16, -129, -128, -127, 127, 128,
                         2 ** 31 - 1]]).astype(np.int32)
    ds = np.repeat(np.arange(9, dtype=np.int32), 40)
    de = (np.arange(ds.size, dtype=np.int32) * 37) % (1 << np.maximum(ds, 1))
    return {
        "div_trunc": (a, 16),
        "div_trunc_7": (a, 7),
        "as_int8": (np.arange(-300, 600, dtype=np.int32),),
        "as_uint8": (a,),
        "asr": (a, 3),
        "sign_nonzero": (a,),
        "clamp": (a, -100, 200),
        "pin_248": (a,),
        "dc_delta": (np.full(ds.size, 128, np.int32), ds, de.astype(np.int32)),
        "dequant_array": (lv, intra, qs, q),
    }


ARGS = _args(1)


@pytest.mark.parametrize("name", list(ARGS))
def test_helper_on_tensors_matches_numpy(name):
    args = ARGS[name]
    fn = name.removesuffix("_7")
    want = getattr(JSI, fn)(*args)
    got = getattr(TSI, fn)(*[torch.from_numpy(x) if isinstance(x, np.ndarray)
                             else x for x in args])
    assert isinstance(got, torch.Tensor)
    assert np.array_equal(got.numpy(), np.asarray(want)), name


@pytest.mark.parametrize("name", list(ARGS))
def test_helper_on_numpy_and_ints_is_the_original(name):
    args = ARGS[name]
    fn = name.removesuffix("_7")
    got = getattr(TSI, fn)(*args)
    want = getattr(JSI, fn)(*args)
    assert np.asarray(got).dtype == np.asarray(want).dtype
    assert np.array_equal(got, want)
    # the scalar path on the first element of each array
    scalars = [int(x.flat[0]) if isinstance(x, np.ndarray) else x
               for x in args]
    if fn == "dequant_array":
        scalars[1] = bool(scalars[1])
    assert getattr(TSI, fn)(*scalars) == getattr(JSI, fn)(*scalars)


def test_refdec_copy_decodes_the_same_frames():
    from espflix_tpu.core import refdec as JR
    from espflix_tpu.tools import mpeg1_encode as E
    from espflix_tpu_torch.core import refdec as TR

    rng = np.random.default_rng(6)
    es = E.encode_es(E.random_script(rng, n_pictures=4, max_coeffs=12,
                                     width=64, height=48))
    fj = JR.Mpeg1Decoder().decode_es(es)
    ft = TR.Mpeg1Decoder().decode_es(es)
    assert len(fj) == len(ft) == 4
    for a, b in zip(fj, ft):
        for k in "yuv":
            assert np.array_equal(getattr(a, k), getattr(b, k))
    blk = rng.integers(-2048, 2048, (8, 8)).astype(np.int32)
    assert np.array_equal(JR.idct_ref(blk), TR.idct_ref(blk))
