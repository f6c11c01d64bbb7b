"""BENCHMARK.json against the benchmark's contract, and every file it
names present and consistent."""

import json
import re

import pytest

from espbench.manifest import ROOT, Benchmark

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())


def test_top_level_keys_and_paths():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["espbench"]
    assert 1 <= SPEC["run_seconds"] <= 51
    for word in SPEC["command"]:
        assert 1 <= len(word) <= 200 and not word.startswith("/")
        assert ".." not in word


def test_run_seconds_fits_a_check_of_24_cells():
    runs = 2 + 14 * 24
    assert runs * (SPEC["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_units_and_entry_keys():
    names = set()
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("espbench/")
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["name"] not in names
        names.add(m["name"])
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in SPEC["end_to_end"])


def test_four_chip_cells_at_most_a_quarter():
    four = sum(w["chips"] == 4 for w in SPEC["workloads"])
    assert four <= max(1, len(SPEC["workloads"]) // 4)


def test_every_moves_names_an_end_to_end_metric_each_cell_reports():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    cells = [w["name"] for w in SPEC["workloads"]]
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e
        target = e2e[m["moves"]]
        for cell in m.get("workloads", cells):
            assert cell in cells
            assert "workloads" not in target or cell in target["workloads"]


@pytest.mark.parametrize("w", [w["name"] for w in SPEC["workloads"]])
def test_cell_resolves_and_reports_enough(w):
    cell = Benchmark().cell(w)
    names = [m["name"] for m in cell.end_to_end]
    assert "setup_s" in names and len(names) >= 2
    assert cell.per_layer
    assert callable(cell.entry.Cell)
    assert callable(cell.entry.Cell.substitute_control)


@pytest.mark.parametrize("m", [m["name"] for m in SPEC["per_layer"]])
def test_reader_declares_what_the_manifest_says(m):
    entry = next(x for x in SPEC["per_layer"] if x["name"] == m)
    reader = Benchmark().reader(m)
    assert (reader.LAYER, reader.UNIT, reader.SOURCE, reader.MOVES) == (
        entry["layer"], entry["unit"], entry["source"], entry["moves"])


@pytest.mark.parametrize("c", SPEC["configs"], ids=lambda c: c["name"])
def test_configuration_file(c):
    cfg = json.loads((ROOT / c["file"]).read_text())
    assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
    assert cfg["frames_per_tick"] == -(-48000 // (128 * cfg["tick_hz"]))
    used = {w["config"] for w in SPEC["workloads"]}
    assert c["name"] in used
