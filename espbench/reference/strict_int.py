"""C-truncating integer semantics, usable from numpy and PyTorch alike.

A frozen copy of espflix_tpu_torch/utils/strict_int.py (the port of
espflix_tpu/utils/strict_int.py): the same helpers, with a
torch branch in place of the original's lazy jax.numpy one (tensors
take torch, everything else numpy).  tests/test_torch_strict_int.py
holds them equal to the original on numpy.

The reference decoder relies on C integer behavior in several bit-exact
spots (see src/player.cpp):

  * ``v = (v*quantizer_scale*q[zz]) / 16`` truncates toward zero
    (player.cpp:1113), while Python/numpy ``//`` floors;
  * ``(int8_t)run_value`` reinterprets the low byte as signed
    (player.cpp:1090);
  * ``>>`` on negative ints is an arithmetic shift (player.cpp:987-994);
  * ``(-1 << dc_size) | (delta + 1)`` DC-delta trick (player.cpp:1057).

Every helper here works element-wise on plain ints, numpy arrays and
integer torch tensors, always in int32 unless stated otherwise.
"""

from __future__ import annotations


def _np_of(x):
    """Pick numpy-or-torch namespace matching x (torch for tensors)."""
    if type(x).__module__.startswith("torch"):
        import torch

        return torch
    import numpy as np

    return np


def _as_i32(b, xp):
    """A boolean array or tensor as int32."""
    if xp.__name__ == "torch":
        return b.to(xp.int32)
    return b.astype("int32")


def div_trunc(a, b):
    """C-style integer division: truncates toward zero. b must be > 0."""
    if isinstance(a, int) and isinstance(b, int):
        q = abs(a) // b
        return -q if a < 0 else q
    xp = _np_of(a)
    q = xp.abs(a) // b
    return xp.where(a < 0, -q, q)


def as_int8(x):
    """Reinterpret the low 8 bits of x as a signed byte (C (int8_t) cast)."""
    if isinstance(x, int):
        v = x & 0xFF
        return v - 256 if v >= 128 else v
    xp = _np_of(x)
    v = x & 0xFF
    return xp.where(v >= 128, v - 256, v)


def as_uint8(x):
    """C (uint8_t) cast: low 8 bits, non-negative."""
    return x & 0xFF


def asr(x, n):
    """Arithmetic shift right (C >> on signed), any backend.

    numpy/torch >> on signed ints is already arithmetic; this exists to make
    call sites explicit about depending on sign-extension.
    """
    return x >> n


def sign_nonzero(x):
    """+1 if x > 0 else -1 if x < 0 else 0 -- used by oddification."""
    if isinstance(x, int):
        return (x > 0) - (x < 0)
    xp = _np_of(x)
    return _as_i32(x > 0, xp) - _as_i32(x < 0, xp)


def clamp(x, lo, hi):
    if isinstance(x, int):
        return lo if x < lo else (hi if x > hi else x)
    xp = _np_of(x)
    return xp.clip(x, lo, hi)


def pin_248(x):
    """The reference's PIN saturation: clamp to [0, 248].

    Output luma/chroma are pinned to 248 (not 255) so the blitter's +3
    ordered dither cannot overflow a byte (player.cpp:183-236).
    """
    return clamp(x, 0, 248)


def dc_delta(prev, dc_size, delta):
    """Intra DC predictor update (player.cpp:1053-1057 semantics).

    delta has dc_size bits. If the top bit is set the delta is positive;
    otherwise the differential is ((-1 << dc_size) | (delta + 1)), a
    negative number (two's complement trick for the MPEG-1 sign-magnitude
    DC differential).
    """
    if isinstance(prev, int):
        if dc_size == 0:
            return prev
        if delta & (1 << (dc_size - 1)):
            return prev + delta
        return prev + ((-1 << dc_size) | (delta + 1))
    xp = _np_of(prev)
    pos = (delta & (1 << (dc_size - 1))) != 0
    neg_val = ((-1) << dc_size) | (delta + 1)
    out = xp.where(pos, prev + delta, prev + neg_val)
    return xp.where(dc_size == 0, prev, out)


def dequant_array(level, intra, quantizer_scale, q_zz, xp=None):
    """MPEG-1 coefficient reconstruction, exact reference semantics.

    player.cpp:1110-1121::

        v <<= 1;
        if (!intra) v += (v < 0 ? -1 : 1);
        v = (v*quantizer_scale*q[zz]) / 16;     // trunc toward 0
        if ((v & 1) == 0) v -= v > 0 ? 1 : -1;  // oddification
        clamp to [-2048, 2047]

    Note the oddification tests ``v & 1`` which for negative v in two's
    complement is 1 exactly when v is odd, so the test is "is v even".

    All args are broadcastable int32 arrays (or plain ints). intra: boolean
    (or 0/1); quantizer_scale: per-position scale; q_zz: quant matrix entry
    at the zigzag position.
    """
    if isinstance(level, int):
        v = level * 2
        if not intra:
            v += sign_nonzero(v)
        v = div_trunc(v * quantizer_scale * q_zz, 16)
        if (v & 1) == 0 and level != 0:
            v -= 1 if v > 0 else -1   # truncated-to-0 -> +1, as the ref
        return clamp(v, -2048, 2047)
    if xp is None:
        xp = _np_of(level)
    v = level * 2
    v = xp.where(intra, v, v + sign_nonzero(v))
    v = div_trunc(v * quantizer_scale * q_zz, 16)
    even = (v & 1) == 0
    # reference oddification is `v -= v>0 ? 1 : -1` which maps a
    # truncated-to-zero v to +1 (player.cpp:1114-1115).  That applies to
    # CODED coefficients only: level == 0 means "absent" (the reference
    # never dequants uncoded positions) and stays 0.
    v = xp.where(even & (level != 0), v - xp.where(v > 0, 1, -1), v)
    return clamp(v, -2048, 2047)
