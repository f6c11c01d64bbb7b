"""BENCHMARK.json and the files it names, found by name.

- a configuration: the `file` of its entry in `configs`;
- a traffic mix: espbench/traffic/<traffic>.json, which names its
  entry;
- an entry (the path the window drives): espbench/entries/<entry>.py;
- a per-layer metric: espbench/metrics/<name>.py, a reader with LAYER,
  UNIT, SOURCE, MOVES and read(ctx).

Adding any of them takes new files and new entries in BENCHMARK.json,
and no edit of a file that is there.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclass
class Cell:
    name: str
    chips: int
    cfg: dict
    mix: dict
    entry: object            # the entry module
    end_to_end: list         # BENCHMARK.json metric entries it reports
    per_layer: list          # (metric entry, reader module)


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


class Benchmark:
    def __init__(self, root: Path = ROOT):
        self.root = Path(root)
        self.spec = json.loads((self.root / "BENCHMARK.json").read_text())
        self.bench = self.root / self.spec["paths"][0]

    def config(self, name: str) -> dict:
        for c in self.spec["configs"]:
            if c["name"] == name:
                return json.loads((self.root / c["file"]).read_text())
        raise KeyError(f"no configuration {name!r}")

    def mix(self, traffic: str) -> dict:
        return json.loads(
            (self.bench / "traffic" / f"{traffic}.json").read_text())

    def entry(self, name: str):
        return load_module(self.bench / "entries" / f"{name}.py",
                           f"espbench_entry_{name}")

    def reader(self, metric: str):
        return load_module(self.bench / "metrics" / f"{metric}.py",
                           "espbench_metric_" + metric.replace(".", "_"))

    def cell(self, name: str) -> Cell:
        for w in self.spec["workloads"]:
            if w["name"] == name:
                break
        else:
            raise KeyError(f"no workload {name!r}")
        mix = self.mix(w["traffic"])
        return Cell(
            name=name, chips=w["chips"], cfg=self.config(w["config"]),
            mix=mix, entry=self.entry(mix["entry"]),
            end_to_end=[m for m in self.spec["end_to_end"]
                        if reports(m, name)],
            per_layer=[(m, self.reader(m["name"]))
                       for m in self.spec["per_layer"] if reports(m, name)])
