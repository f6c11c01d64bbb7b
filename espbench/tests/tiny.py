"""Small cells for the CPU tests: a real cell's configuration and mix at
3 lanes, on the program's plain forms.  A device-fed cell gets GOPs of
2 and one SBC frame a tick; a served cell 2 titles of 4 GOPs of 4 (2
encoded GOPs played twice), started in their first 2 GOPs, and chunks
of 2 ticks."""

from __future__ import annotations

import copy
import time

import torch

from espbench import run as R
from espbench.manifest import Benchmark

SMALL = {"device_fed": (dict(gop=2), dict(frames_per_tick=1),
                        dict(lanes=3, distinct=2, pictures=2,
                             check_lanes=2)),
         "sessions": (dict(gop=4), {},
                      dict(lanes=3, titles=2, gops=4, unique_gops=2,
                           start_gops=2, check_lanes=2,
                           ticks_per_chunk=2, warm_chunks=1))}


def tiny_cell(name: str = "ntsc.chain", root=None):
    cell = (Benchmark(root) if root else Benchmark()).cell(name)
    video, top, mix = SMALL[cell.mix["kind"]]
    cell.cfg = copy.deepcopy(cell.cfg)
    cell.cfg["video"].update(video)
    cell.cfg.update(top)
    cell.mix = dict(cell.mix, **mix)
    return cell


def run_tiny(cell, seed: int = 2**31 + 7, seconds: float = 0.05,
             control: bool = False) -> dict:
    """One run of the cell on the CPU: set-up, a short window, the
    check (the harness's look for a card skipped); with `control`, the
    cell's control in the program's place."""
    return R.run_cell(cell, seed, seconds, False, torch.device("cpu"),
                      t0=time.perf_counter(), log=lambda *a: None,
                      control=control)
