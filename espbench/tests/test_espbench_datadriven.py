"""A configuration, a traffic mix and a per-layer metric added as new
files and new BENCHMARK.json entries, in a copy of the benchmark: the
harness finds and runs them, and no file that was there changes."""

import hashlib
import json
import shutil
import time
import types

import pytest
import torch

from espbench import run as R
from espbench.manifest import ROOT, Benchmark


def _digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted((root / "espbench").rglob("*"))
            if p.is_file() and "__pycache__" not in p.parts}


@pytest.fixture
def copy(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "espbench", tmp_path / "espbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    return tmp_path


def test_new_config_mix_and_metric_are_found_and_run(copy):
    before = _digests(copy)
    bench = copy / "espbench"
    cfg = json.loads((bench / "configs" / "espflix-ntsc.json").read_text())
    cfg.update(name="espflix-ntsc-gop2", video=dict(cfg["video"], gop=2),
               frames_per_tick=1)
    (bench / "configs" / "espflix-ntsc-gop2.json").write_text(json.dumps(cfg))
    mix = json.loads((bench / "traffic" / "device_fed.json").read_text())
    mix.update(lanes=3, distinct=2, pictures=2, check_lanes=2)
    (bench / "traffic" / "device_fed_tiny.json").write_text(json.dumps(mix))
    (bench / "metrics" / "lane_ticks_traced.py").write_text(
        'LAYER = "chain"\nUNIT = "ticks"\nSOURCE = "program_counter"\n'
        'MOVES = "chain_streams"\n\n\ndef read(ctx):\n'
        '    return ctx.get("ticks") or None\n')
    spec = json.loads((copy / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "espflix-ntsc-gop2",
                            "source": "https://github.com/rossumur/espflix",
                            "file": "espbench/configs/espflix-ntsc-gop2.json",
                            "reduced": ["frames_per_tick"], "why": "a test"})
    spec["workloads"].append({"name": "tiny.chain",
                              "config": "espflix-ntsc-gop2",
                              "traffic": "device_fed_tiny", "chips": 1,
                              "why": "a test"})
    for m in spec["end_to_end"]:
        if m["name"] == "chain_streams":
            m["workloads"].append("tiny.chain")
    spec["per_layer"].append({"name": "lane_ticks_traced", "unit": "ticks",
                              "better": "higher",
                              "source": "program_counter", "layer": "chain",
                              "moves": "chain_streams",
                              "workloads": ["tiny.chain"]})
    (copy / "BENCHMARK.json").write_text(json.dumps(spec))
    after = _digests(copy)
    assert {k: after[k] for k in before} == before

    cell = Benchmark(copy).cell("tiny.chain")
    assert cell.cfg["name"] == "espflix-ntsc-gop2"
    assert cell.mix["lanes"] == 3
    names = [m["name"] for m, _r in cell.per_layer]
    assert "lane_ticks_traced" in names
    reader = dict((m["name"], r) for m, r in cell.per_layer)
    assert reader["lane_ticks_traced"].read({"ticks": 36}) == 36
    prof = types.SimpleNamespace(stretch=(0.0, 2.0),
                                 device=[(0.5, 1.5, "k", "kernel")])
    idle = Benchmark(copy).reader("device_idle_pct.chain")
    assert idle.read({"profile": prof}) == 50.0
    res = R.run_cell(cell, 3, 0.05, False, torch.device("cpu"),
                     t0=time.perf_counter(), log=lambda *a: None)
    assert res["correct"], res["checks"]
    assert set(res["metrics"]) == {"chain_streams", "setup_s"}
