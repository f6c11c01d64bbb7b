"""What the benchmark may import and where a run may write.

No module under espbench/ imports JAX or the JAX package (top-level
names compared whole: espflix_tpu_torch is not espflix_tpu); nothing
under espbench/reference/ imports the program; no source names a fixed
/tmp path or /dev/shm; a run writes only into its TMPDIR (and the
checkout's build/), and leaves nothing there."""

import ast
import os
import time
from pathlib import Path

import torch

from espbench import run as R
from espbench.manifest import HERE
from espbench.tests.tiny import tiny_cell

SOURCES = sorted(HERE.rglob("*.py"))


def _imports(path: Path) -> set:
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def test_no_jax_and_no_jax_package_anywhere():
    for p in SOURCES:
        bad = _imports(p) & {"jax", "jaxlib", "flax", "espflix_tpu"}
        assert not bad, (p, bad)


def test_reference_imports_nothing_of_the_program():
    for p in sorted((HERE / "reference").rglob("*.py")):
        assert "espflix_tpu_torch" not in _imports(p), p


def test_forbidden_modules_compares_whole_names(monkeypatch):
    import sys
    before = R.forbidden_modules()
    monkeypatch.setitem(sys.modules, "espflix_tpu_torch_probe", object())
    monkeypatch.setitem(sys.modules, "jaxtyping_probe", object())
    assert R.forbidden_modules() == before
    monkeypatch.setitem(sys.modules, "espflix_tpu.core", object())
    assert "espflix_tpu" in R.forbidden_modules()


def test_no_fixed_temporary_paths_in_sources():
    for p in SOURCES:
        if p.name.startswith("test_"):
            continue
        text = p.read_text()
        assert "/dev/shm" not in text and "'/tmp" not in text \
            and '"/tmp' not in text, p


def test_a_run_writes_only_into_its_tmpdir(tmp_path, monkeypatch):
    tmp = tmp_path / "tmp"
    tmp.mkdir()
    monkeypatch.setenv("TMPDIR", str(tmp))
    import tempfile
    monkeypatch.setattr(tempfile, "tempdir", None)
    shm = set(os.listdir("/dev/shm")) if os.path.isdir("/dev/shm") else set()
    since = time.time()
    res = R.run_cell(tiny_cell(), 11, 0.05, False, torch.device("cpu"),
                     t0=time.perf_counter(), log=lambda *a: None)
    assert res["correct"]
    assert list(tmp.iterdir()) == []
    if os.path.isdir("/dev/shm"):
        new = {f for f in set(os.listdir("/dev/shm")) - shm
               if os.path.getmtime(os.path.join("/dev/shm", f)) >= since}
        assert not new
    for p in HERE.rglob("*"):
        if p.is_file() and "__pycache__" not in p.parts:
            assert p.stat().st_mtime < since, p
