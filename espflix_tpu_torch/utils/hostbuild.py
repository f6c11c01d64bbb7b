"""g++ builds of the port's host libraries, at first use.

``shared_library`` compiles C++ sources, one g++ process a source, and
links them into one shared library at ``<repo>/build/<name>-<hash>/``,
keyed by a hash of the flags, of the files generated beside the sources
and of the sources; a later process reuses the library.  The build runs
in a directory of its own and the library moves into place at the end,
so processes that build at once each leave a whole library.  A failed
compile raises RuntimeError with g++'s messages.
"""

from __future__ import annotations

import hashlib
import shutil
import subprocess
import tempfile
from pathlib import Path

BUILD_ROOT = Path(__file__).resolve().parent.parent.parent / "build"


def library_path(name: str, lib_name: str, sources, flags,
                 generated=None) -> Path:
    """Where ``shared_library`` puts the library of these inputs.
    `generated` maps a file name to the text written beside the
    sources (a header they include)."""
    h = hashlib.sha256(" ".join(flags).encode())
    for fname, text in sorted((generated or {}).items()):
        h.update(fname.encode())
        h.update(text.encode())
    for p in sources:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_ROOT / f"{name}-{h.hexdigest()[:16]}" / lib_name


def shared_library(name: str, lib_name: str, sources, flags,
                   generated=None) -> Path:
    """Compile `sources` (paths) with `flags` and link them with the same
    flags, unless the library of these inputs exists; returns its
    path."""
    out = library_path(name, lib_name, sources, flags, generated)
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++) on PATH")
    work = Path(tempfile.mkdtemp(dir=out.parent))
    try:
        for fname, text in (generated or {}).items():
            (work / fname).write_text(text)
        jobs = []
        for src in sources:
            shutil.copy(src, work / src.name)
            cmd = [cxx, *flags, "-c", src.name, "-o", f"{src.stem}.o"]
            jobs.append((cmd, subprocess.Popen(
                cmd, cwd=work, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True)))
        failed = [f"{' '.join(cmd)}\n{proc.communicate()[1]}"
                  for cmd, proc in jobs if proc.wait() != 0]
        if failed:
            raise RuntimeError("g++ failed:\n" + "\n".join(failed))
        subprocess.run([cxx, *flags, "-shared", "-o", "lib.so",
                        *sorted(p.name for p in work.glob("*.o"))],
                       cwd=work, check=True, capture_output=True)
        (work / "lib.so").replace(out)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return out
