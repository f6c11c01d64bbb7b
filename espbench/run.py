"""Run one cell of the benchmark once and print its result line.

    python3 -m espbench.run --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

From the root of a checkout.  Set-up (inputs from the seed, the
program's build and warm-up) counts as `setup_s`, from process start to
the first timed tick; then the cell's entry drives the program for
`--seconds` and the window's end-to-end metrics are taken by the host
clock (`--trace 0`), or a profiler reads the per-layer metrics over a
steady stretch of it (`--trace 1`).  After the window the peak device
memory is read, the program's state freed, and the reference checks
what the window produced.  The numbers compared go to standard error,
each beside its limit, and the last line of standard output is the
result:

    {"correct": ..., "attempted": ..., "failed": ..., "metrics": {...},
     "device": {...}, ["breakdown": {...},] "checks": {...}}

Without as many CUDA cards as the cell asks for, or with JAX or the JAX
package loaded once the window has closed, it prints no result and
exits with 2.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "espflix_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX
    package's (compared whole: espflix_tpu_torch is not espflix_tpu)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def card_name(device) -> str:
    import torch
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return "cpu"


def run_cell(cell, seed: int, seconds: float, trace: bool, device,
             t0: float = T0, log=None, control: bool = False) -> dict:
    """Set-up, window, check: the result dict (no printing).  With
    `control`, the cell's control takes the program's place in what the
    check reads (the entry's `substitute_control`)."""
    import torch

    from espbench import stats
    from espbench.trace import Profile

    log = log or (lambda *a: print(*a, file=sys.stderr, flush=True))
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.set_device(device)
        torch.cuda.reset_peak_memory_stats(device)
    run = cell.entry.Cell(cell.cfg, cell.mix, seed, device, trace)
    if cuda:
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - t0
    prof = Profile() if trace else None
    res = run.window(seconds, prof)
    if cuda:
        torch.cuda.synchronize(device)
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    found = forbidden_modules()
    if found:
        raise SystemExit(f"espbench: loaded after the window: {found}")
    run.release()
    if control:
        run.substitute_control()
    t_check = time.perf_counter()
    checks = run.check()
    log(f"espbench: {cell.name} seed {seed}: window {res['window_s']:.3f} s"
        f", set-up {setup_s:.3f} s, check {time.perf_counter() - t_check:.3f}"
        " s")
    metrics = {}
    dev = {"platform": "gpu" if cuda else device.type,
           "kind": card_name(device),
           "count": cell.chips if cuda else 1,
           "memory_peak_bytes": int(peak)}
    out = {"attempted": res["attempted"], "failed": res["failed"]}
    if trace:
        stretch = prof.stretch
        dint = [d[:2] for d in prof.device]
        dev["busy_s"] = stats.busy_s(dint, stretch)
        dev["window_s"] = stretch[1] - stretch[0]
        ctx = dict(res, profile=prof, ticks=prof.ticks)
        for m, reader in cell.per_layer:
            v = reader.read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        out["breakdown"] = breakdown(prof)
        if "stages" in res:
            out["stages"] = res["stages"]
    else:
        for m in cell.end_to_end:
            v = setup_s if m["name"] == "setup_s" else res["e2e"][m["name"]]
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    correct = all(v <= lim for v, lim in checks.values())
    return {"correct": correct, **out, "metrics": metrics, "device": dev,
            "checks": {k: {"value": v, "limit": lim}
                       for k, (v, lim) in checks.items()}}


def breakdown(prof) -> dict:
    """The ten device operations that took most time in the stretch, and
    its ten longest idle gaps, each named by the host span open then."""
    from espbench import stats
    tot = {}
    for s, e, name, _cat in prof.device:
        tot[name] = tot.get(name, 0.0) + (e - s)
    ops = sorted(tot.items(), key=lambda kv: -kv[1])[:10]
    gaps = stats.gaps([d[:2] for d in prof.device], prof.stretch)[:10]
    return {"device_ops": [[n, s] for n, s in ops],
            "idle_gaps": [[stats.label(g, prof.spans), g[1] - g[0]]
                          for g in gaps]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from espbench.manifest import Benchmark
    bench = Benchmark()
    cell = bench.cell(args.workload)
    root = bench.root
    # every cache inside the checkout, at fixed paths
    os.environ.setdefault("TRITON_CACHE_DIR",
                          str(root / "build" / "triton-cache"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          str(root / "build" / "torch-extensions"))
    import torch
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < cell.chips:
        print(f"espbench: {args.workload} needs {cell.chips} CUDA "
              f"card(s); found {found}", file=sys.stderr)
        return 2
    try:
        result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                          torch.device("cuda", 0))
    except SystemExit as e:
        print(e, file=sys.stderr)
        return 2
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
