"""ctypes binding to the native MPEG-1 slice tokenizer (oracle/*.cpp).

The port of the parts of espflix_tpu.tools.oracle that the "hybrid"
parser needs: the library, its two tokenizer entry points and
``available()``.  The JAX package builds oracle/liboracle.so with
oracle/Makefile, whose vlc_luts.h comes from oracle/gen_luts.py, which
imports the JAX package's tables.  The port runs neither: ``build()``
writes vlc_luts.h from its own core/vlc_tables.py copy
(``luts_header()``, byte for byte gen_luts.py's output; a test pins
that), copies oracle/*.cpp beside it into
``<repo>/build/oracle-<hash>/`` (keyed by a hash of the sources, the
header and the flags) and compiles them there with g++, one process a
source, at first use.
"""

from __future__ import annotations

import ctypes
import hashlib
import shutil
import subprocess
import tempfile
from pathlib import Path

from espflix_tpu_torch.core import vlc_tables as V

ORACLE = Path(__file__).resolve().parent.parent.parent / "oracle"
BUILD_ROOT = Path(__file__).resolve().parent.parent.parent / "build"
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
    h = hashlib.sha256(" ".join(CXXFLAGS).encode())
    h.update(luts_header().encode())
    for p in sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_ROOT / f"oracle-{h.hexdigest()[:16]}" / "liboracle.so"


def build() -> Path:
    """Compile oracle/*.cpp with the port's vlc_luts.h unless the
    library for these sources exists; returns its path."""
    out = library_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++) on PATH")
    work = Path(tempfile.mkdtemp(dir=out.parent))
    try:
        (work / "vlc_luts.h").write_text(luts_header())
        jobs = []
        for src in sources():
            shutil.copy(src, work / src.name)
            cmd = [cxx, *CXXFLAGS, "-c", src.name, "-o", f"{src.stem}.o"]
            jobs.append((cmd, subprocess.Popen(
                cmd, cwd=work, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True)))
        failed = [f"{' '.join(cmd)}\n{proc.communicate()[1]}"
                  for cmd, proc in jobs if proc.wait() != 0]
        if failed:
            raise RuntimeError("g++ failed:\n" + "\n".join(failed))
        subprocess.run([cxx, "-shared", "-o", "lib.so",
                        *sorted(p.name for p in work.glob("*.o"))],
                       cwd=work, check=True, capture_output=True)
        (work / "lib.so").replace(out)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return out


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
        _lib = L
    return _lib


def available() -> bool:
    try:
        lib()
        return True
    except Exception:
        return False
