"""ctypes bindings to the native C++ oracle (oracle/*.cpp).

The port of espflix_tpu.tools.oracle: the golden decoders that define
bit-exact correctness -- ``decode_mpeg1`` (YUV), ``composite_field``
(DAC bytes), ``pdm_modulate`` (PDM words) and ``SbcOracle`` (PCM) --
and the two tokenizer entry points of the "hybrid" parser, with the
same signatures and returns as the JAX module's.  The JAX package
builds oracle/liboracle.so with oracle/Makefile, whose vlc_luts.h comes
from oracle/gen_luts.py, which imports the JAX package's tables.  The
port runs neither: ``build()`` writes vlc_luts.h from its own
core/vlc_tables.py copy (``luts_header()``, byte for byte gen_luts.py's
output; a test pins that), copies oracle/*.cpp beside it into
``<repo>/build/oracle-<hash>/`` (keyed by a hash of the sources, the
header and the flags) and compiles them there with g++, one process a
source, at first use (utils/hostbuild.py).
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import numpy as np

from espflix_tpu_torch.core import vlc_tables as V
from espflix_tpu_torch.utils import hostbuild

ORACLE = Path(__file__).resolve().parent.parent.parent / "oracle"
BUILD_ROOT = hostbuild.BUILD_ROOT
# oracle/Makefile's flags
CXXFLAGS = ("-O2", "-fPIC", "-Wall", "-Wextra", "-fno-strict-aliasing",
            "-fwrapv")
# (name, table, C element type), in gen_luts.py's order
_TABLES = (("LUT_MB_ADDR", V.LUT_MB_ADDR, "int32_t"),
           ("LUT_MB_TYPE_I", V.LUT_MB_TYPE_I, "int32_t"),
           ("LUT_MB_TYPE_P", V.LUT_MB_TYPE_P, "int32_t"),
           ("LUT_CBP", V.LUT_CBP, "int32_t"),
           ("LUT_MOTION", V.LUT_MOTION, "int32_t"),
           ("LUT_DC_LUM", V.LUT_DC_LUM, "int32_t"),
           ("LUT_DC_CHROM", V.LUT_DC_CHROM, "int32_t"),
           ("LUT_DCT_FIRST", V.LUT_DCT_FIRST, "int32_t"),
           ("LUT_DCT_NEXT", V.LUT_DCT_NEXT, "int32_t"),
           ("ZIG_ZAG", V.ZIG_ZAG, "uint8_t"),
           ("SCALE_DCT_Q", V.SCALE_DCT_Q, "uint8_t"),
           ("DEFAULT_INTRA_Q", V.DEFAULT_INTRA_Q, "uint8_t"))

SEQ_HEADER = b"\x00\x00\x01\xb3"

_lib = None


def luts_header() -> str:
    """vlc_luts.h: the constant tables as C arrays, twelve values a
    line (the text oracle/gen_luts.py prints)."""
    out = ["// GENERATED by oracle/gen_luts.py -- do not edit.",
           "#pragma once", "#include <stdint.h>"]
    for name, arr, dtype in _TABLES:
        out.append(f"static const {dtype} {name}[{len(arr)}] = {{")
        vals = [str(int(v)) for v in arr]
        for k in range(0, len(vals), 12):
            out.append("  " + ",".join(vals[k:k + 12]) + ",")
        out.append("};")
    return "\n".join(out) + "\n"


def sources() -> list[Path]:
    return sorted(ORACLE.glob("*.cpp"))


def library_path() -> Path:
    return hostbuild.library_path("oracle", "liboracle.so", sources(),
                                  CXXFLAGS, {"vlc_luts.h": luts_header()})


def build() -> Path:
    """Compile oracle/*.cpp with the port's vlc_luts.h unless the
    library for these sources exists; returns its path."""
    return hostbuild.shared_library("oracle", "liboracle.so", sources(),
                                    CXXFLAGS,
                                    {"vlc_luts.h": luts_header()})


def lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        L = ctypes.CDLL(str(build()))
        c = ctypes
        L.mpeg1_tokenize_picture.restype = c.c_int
        L.mpeg1_tokenize_picture.argtypes = [
            c.c_char_p, c.c_long, c.c_void_p, c.c_void_p, c.c_int,
            c.c_int, c.c_int, c.c_int, c.c_int, c.c_int,
            c.c_void_p, c.c_void_p, c.c_void_p]
        L.mpeg1_tokenize_picture_compact.restype = c.c_int
        L.mpeg1_tokenize_picture_compact.argtypes = [
            c.c_char_p, c.c_long, c.c_void_p, c.c_void_p, c.c_int,
            c.c_int, c.c_int, c.c_int, c.c_int, c.c_int,
            c.c_void_p, c.c_int, c.c_void_p, c.c_void_p]
        L.mpeg1_oracle_decode.restype = c.c_int
        L.mpeg1_oracle_decode.argtypes = [
            c.c_char_p, c.c_long, c.c_void_p, c.c_void_p, c.c_void_p,
            c.c_void_p, c.c_int, c.POINTER(c.c_int), c.POINTER(c.c_int)]
        L.composite_geometry.restype = c.c_int
        L.composite_geometry.argtypes = [
            c.c_int, c.POINTER(c.c_int), c.POINTER(c.c_int)]
        L.composite_field.restype = None
        L.composite_field.argtypes = [c.c_void_p] * 3 + [c.c_int] * 2 + [
            c.c_void_p] + [c.c_int] * 2 + [c.c_void_p]
        L.pdm_modulate.restype = None
        L.pdm_modulate.argtypes = [c.c_void_p, c.c_long, c.c_void_p,
                                   c.c_void_p]
        L.sbc_oracle_new.restype = c.c_void_p
        L.sbc_oracle_new.argtypes = []
        L.sbc_oracle_free.restype = None
        L.sbc_oracle_free.argtypes = [c.c_void_p]
        L.sbc_oracle_decode.restype = c.c_int
        L.sbc_oracle_decode.argtypes = [
            c.c_void_p, c.c_char_p, c.c_long, c.c_void_p,
            c.POINTER(c.c_int)]
        _lib = L
    return _lib


def available() -> bool:
    try:
        lib()
        return True
    except Exception:
        return False


def composite_field(y, u, v, frame_parity=0, pal=False, osd=None,
                    blend=0, progress=0):
    """Golden composite field: uint8[line_count, line_width] from one
    frame's planes (y uint8[192, 352], u / v uint8[96, 176]) and an
    optional OSD uint8[16, 80]."""
    L = lib()
    lc, lw = ctypes.c_int(0), ctypes.c_int(0)
    L.composite_geometry(1 if pal else 0, ctypes.byref(lc),
                         ctypes.byref(lw))
    out = np.zeros((lc.value, lw.value), np.uint8)
    y = np.ascontiguousarray(y, np.uint8)
    u = np.ascontiguousarray(u, np.uint8)
    v = np.ascontiguousarray(v, np.uint8)
    if y.shape != (192, 352) or u.shape != (96, 176) or v.shape != u.shape:
        raise ValueError(f"planes {y.shape} {u.shape} {v.shape}")
    osd_p = None
    if osd is not None:
        osd = np.ascontiguousarray(osd, np.uint8)
        if osd.shape != (16, 80):
            raise ValueError(f"osd {osd.shape}")
        osd_p = osd.ctypes.data
    L.composite_field(y.ctypes.data, u.ctypes.data, v.ctypes.data,
                      int(frame_parity), 1 if pal else 0, osd_p,
                      int(blend), int(progress), out.ctypes.data)
    return out


def pdm_modulate(pcm, state=None):
    """Golden PDM: (uint16[2 * n] words, state int32[3]) for int16[n]
    PCM, from the modulator state int32[3] (zeros when None)."""
    L = lib()
    pcm = np.ascontiguousarray(pcm, np.int16)
    st = np.zeros(3, np.int32) if state is None \
        else np.ascontiguousarray(state, np.int32).copy()
    if pcm.ndim != 1 or st.shape != (3,):
        raise ValueError(f"pcm {pcm.shape}, state {st.shape}")
    out = np.zeros(2 * len(pcm), np.uint16)
    L.pdm_modulate(pcm.ctypes.data, len(pcm), st.ctypes.data,
                   out.ctypes.data)
    return out, st


class SbcOracle:
    """Stateful native SBC decoder (oracle/sbc_oracle.cpp)."""

    def __init__(self):
        self._L = lib()
        self._ctx = self._L.sbc_oracle_new()

    def __del__(self):
        ctx, self._ctx = getattr(self, "_ctx", None), None
        if ctx:
            self._L.sbc_oracle_free(ctx)

    def decode_frame(self, frame: bytes):
        """Returns (pcm int16 array, frame_len) or None on a bad
        header."""
        pcm = np.zeros(2 * 16 * 8, np.int16)
        n = ctypes.c_int(0)
        r = self._L.sbc_oracle_decode(self._ctx, frame, len(frame),
                                      pcm.ctypes.data, ctypes.byref(n))
        if r < 0:
            return None
        return pcm[:n.value].copy(), r


def decode_mpeg1(es: bytes, max_frames: int = 64,
                 width: int = 352, height: int = 192):
    """Decode an MPEG-1 video ES; returns (frames, pts) where frames is
    a list of (y, u, v) uint8 arrays and pts int64[n].  Raises
    ValueError on a parse error or where a sequence header gives other
    dimensions than width x height."""
    L = lib()
    # the decoder copies each picture at the stream's own size: a
    # larger one would overrun these buffers
    at = es.find(SEQ_HEADER)
    while at >= 0:
        h = es[at + 4:at + 7].ljust(3, b"\0")
        dims = ((h[0] << 4) | (h[1] >> 4), ((h[1] & 15) << 8) | h[2])
        if dims != (width, height):
            raise ValueError(f"stream is {dims}, not {width}x{height}")
        at = es.find(SEQ_HEADER, at + 4)
    y = np.zeros((max_frames, height, width), np.uint8)
    u = np.zeros((max_frames, height // 2, width // 2), np.uint8)
    v = np.zeros((max_frames, height // 2, width // 2), np.uint8)
    pts = np.zeros(max_frames, np.int64)
    w, h = ctypes.c_int(0), ctypes.c_int(0)
    n = L.mpeg1_oracle_decode(es, len(es), y.ctypes.data, u.ctypes.data,
                              v.ctypes.data, pts.ctypes.data, max_frames,
                              ctypes.byref(w), ctypes.byref(h))
    if n < 0:
        raise ValueError(f"oracle parse error {-n}")
    if (w.value, h.value) != (width, height):
        raise ValueError(f"stream is {w.value}x{h.value}, not "
                         f"{width}x{height}")
    return [(y[i], u[i], v[i]) for i in range(n)], pts[:n]
