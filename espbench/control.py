"""Run a cell's control: a run of the cell in which the reference, in
the precision below the configuration's, takes the program's place in
what the check reads (see the entry's `substitute_control`), held to the
run's own comparison.  Its `correct` has to come out false.

    python3 -m espbench.control --workload <cell> --seed <n> [--seed ...]
        [--seconds <s>]

One result line a seed on standard output, as `espbench.run` prints
it; the numbers compared, each beside its limit, on standard error.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, action="append", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    import torch

    from espbench import run as R
    from espbench.manifest import Benchmark
    cell = Benchmark().cell(args.workload)
    if not torch.cuda.is_available():
        print("espbench: the control runs the program on a CUDA card",
              file=sys.stderr)
        return 2
    for seed in args.seed:
        res = R.run_cell(cell, seed, args.seconds, False,
                         torch.device("cuda", 0), t0=time.perf_counter(),
                         control=True)
        for name, c in res["checks"].items():
            print(f"control {name}: {c['value']} (limit {c['limit']})",
                  file=sys.stderr)
        print(json.dumps({"workload": args.workload, "seed": seed, **res}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
