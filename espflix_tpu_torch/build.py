"""Build and bind the CUDA kernels of csrc/.

Each ``csrc/*.cu`` compiles with its own nvcc process for sm_90a, all
started together, and the objects link into ONE shared library with a
plain C interface, loaded with ctypes.  The build runs at first use
into ``<repo>/build/kernels-<hash>/`` keyed by a hash of the sources
and flags, so a fresh checkout builds once and a later process reuses
the library.  Every C entry point takes device pointers, plain
ints and the CUDA stream, launches on that stream, allocates nothing,
does not synchronise, and returns cudaGetLastError(); ``launch`` raises
when that is not cudaSuccess.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent.parent / "build"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ARCH_FLAGS + ("-std=c++17", "-O3", "-Xcompiler", "-fPIC")

# C signatures: "p" a device pointer, "i" an int; every entry point
# ends with the stream (a pointer) and returns int (cudaError_t)
SIGNATURES = {
    "esp_scan_dense": "p" * 16 + "i" * 8,
    "esp_scan_flat": "p" * 15 + "i" * 7,
    "esp_idct_T": "p" * 8 + "i" * 2,
    "esp_idct_flat": "p" * 7 + "i" * 2,
    "esp_compose_put": "p" * 10 + "i" * 3,
    "esp_compose_put_flat": "p" * 10 + "i" * 3,
    "esp_composite_parts": "p" * 12 + "i" * 7,
    "esp_pdm": "p" * 4 + "i" * 2,
}

_lib = None
build_seconds: float | None = None      # wall time of this process's build


def _nvcc() -> str:
    p = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(p):
        raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin)")
    return p


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_ROOT / f"kernels-{_digest()}" / "libespflix_kernels.so"


def build() -> Path:
    """Compile csrc/ unless the library for these sources exists: one
    nvcc per source, all at once, then one link."""
    global build_seconds
    out = library_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    nvcc = _nvcc()
    work = Path(tempfile.mkdtemp(dir=out.parent))
    try:
        jobs = []
        for src in (p for p in sources() if p.suffix == ".cu"):
            cmd = [nvcc, *NVCC_FLAGS, "-c", "-o",
                   str(work / f"{src.stem}.o"), str(src)]
            jobs.append((cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)))
        failed = []
        for cmd, proc in jobs:
            _stdout, stderr = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"{' '.join(cmd)}\n{stderr}")
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        lib = work / "lib.so"
        cmd = [nvcc, *ARCH_FLAGS, "-shared", "-o", str(lib),
               *[str(obj) for obj in sorted(work.glob("*.o"))]]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{proc.stderr}")
        os.replace(lib, out)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    build_seconds = time.perf_counter() - t0
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, sig in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = [ctypes.c_void_p if c == "p" else ctypes.c_int
                           for c in sig] + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def check(t: torch.Tensor, device: torch.device, dtype: torch.dtype,
          shape: tuple | None = None):
    """Raise unless t is a contiguous `dtype` tensor on `device`."""
    if t.device != device:
        raise ValueError(f"tensor on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"tensor of {t.dtype}, expected {dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError("tensor is not contiguous")


def launch(name: str, *args):
    """Call C entry `name` with tensors as device pointers and ints as
    ints, on the current stream; raise on a launch error."""
    lib = library()
    sig = SIGNATURES[name]
    if len(args) != len(sig):
        raise TypeError(f"{name}: {len(args)} args, expected {len(sig)}")
    conv = []
    for c, a in zip(sig, args):
        if c == "p":
            if not isinstance(a, torch.Tensor) or not a.is_cuda:
                raise TypeError(f"{name}: expected a CUDA tensor")
            conv.append(a.data_ptr())
        else:
            conv.append(int(a))
    stream = torch.cuda.current_stream().cuda_stream
    rc = getattr(lib, name)(*conv, stream)
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc}")
