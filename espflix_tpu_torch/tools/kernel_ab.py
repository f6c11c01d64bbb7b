"""Time one checkout's kernels on the bench's I-heavy tick, for comparing
two commits on one card.

    python3 espflix_tpu_torch/tools/kernel_ab.py [--tree CHECKOUT] [--label X]

imports espflix_tpu_torch from CHECKOUT (default: the checkout that holds
this file), builds its kernels, and times, at chip_smoke.py's phase-3
inputs (1,024 lanes of 352x192): K1 (run_scan_bucketed_dense), K1F
(run_scan_bucketed) and K1S (run_scan); SBC (models/sbc
.decode_frames_batched on the tick's 13 audio frames a lane: K6 where
the checkout has it, else the plain form) and K5 (ops/delta_sigma
.modulate on that PCM from a seeded random state); with K2
(block_residuals_T) beside them as a control whose code the other work
does not touch.  Each gets the median of --reps runs by two rulers:
`call_ms`, the call's latency, the host's enqueue included (chip_smoke
.py's `ms`), and `device_ms`, the device's work alone (the card sleeps
while the host enqueues), and a checksum of its outputs.  Prints one
JSON line with the label, the card's name and power limit, and those
numbers.  Run it for the two checkouts in the order A, B, B, A in one
session on the card.  Needs a CUDA card.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
from pathlib import Path

BUSY_CYCLES = 20_000_000    # as chip_smoke.py: ~10 ms at 1,980 MHz


def time_ms(fn, reps: int, busy: bool) -> float:
    import torch
    fn()
    ts = []
    for _ in range(reps):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        if busy:
            torch.cuda._sleep(BUSY_CYCLES)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        ts.append(a.elapsed_time(b))
    return statistics.median(ts)


def checksum(outs) -> int:
    return sum(int(t.long().sum()) for t in outs)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", default=str(Path(__file__).resolve()
                                          .parents[2]))
    ap.add_argument("--label", default=None)
    ap.add_argument("--lanes", type=int, default=1024)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    sys.path[0] = tree          # the checkout's package, not this one's

    import torch
    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab: no CUDA device")
    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)

    from espflix_tpu_torch import build
    from espflix_tpu_torch.core import sbc_tables as ST
    from espflix_tpu_torch.models import mpeg1 as M
    from espflix_tpu_torch.models import sbc as dsbc
    from espflix_tpu_torch.ops import delta_sigma as DS
    from espflix_tpu_torch.ops import idct as IDCT
    from espflix_tpu_torch.ops import vlc_scan as VS
    from espflix_tpu_torch.runtime import chain as CH
    from espflix_tpu_torch.runtime.scheduler import bucket_policy
    from espflix_tpu_torch.runtime.workload import (bench_chunk,
                                                    bench_pictures)
    if not VS.__file__.startswith(tree):
        raise SystemExit(f"kernel_ab: imported {VS.__file__}, not {tree}")
    build.library()

    xs_np, kw = bench_chunk(args.lanes)
    bench_ticks, wpl = bench_pictures(args.lanes)
    n_i = ((xs_np["pic_type"] == 1) & (xs_np["alive"] == 1)).sum(axis=1)
    k_i = int(n_i.argmax())
    x = {k: v[k_i] for k, v in CH.xs_to_torch(xs_np, dev).items()}
    mbw, mbh, N = kw["mb_width"], kw["mb_height"], args.lanes
    chain = CH.FullChain(pal=False, n_aud_frames=kw["n_aud_frames"],
                         device=dev)
    tables = dict(lut=chain.scan_lut, zigzag=chain.zigzag)

    k1_args = [x[k] for k in CH.DECODE_KEYS[:9]]
    k1_kw = dict({k: kw[k] for k in ("mb_width", "mb_height", "n_lanes",
                                     "long_rows", "steps_long",
                                     "steps_short", "chunk")}, **tables)
    k1f_args = [x[k] for k in M.SCAN_KEYS]
    need = int(((x["pic_type"] == 1) & (x["alive"] == 1)).sum())
    long_rows, s_long, s_short = bucket_policy(
        max(need, 8), k1f_args[0].shape[0], steps_long=2048,
        steps_short=512)
    k1f_kw = dict(mb_width=mbw, mb_height=mbh, n_lanes=N,
                  long_rows=long_rows, steps_long=s_long,
                  steps_short=s_short, chunk=128, **tables)
    b = M.make_picture_batch(bench_ticks[k_i], words_per_lane=wpl,
                             max_slices=mbh)
    k1s_args = list(M.xs_to_torch({k: b[k] for k in M.PICTURE_KEYS[:7]},
                                  dev).values())
    k1s_kw = dict(mb_width=mbw, mb_height=mbh, max_steps=12000, **tables)

    coeffs_T, recs, nfinal = VS.run_scan_bucketed_dense(*k1_args,
                                                        **k1_kw)[:3]
    intra_bl = ((recs & 3) == VS.MB_INTRA).repeat_interleave(6, dim=1)
    qs_bl = ((recs >> 2) & 31).repeat_interleave(6, dim=1)
    k2_args = (coeffs_T, intra_bl, qs_bl, x["intra_q"], x["non_intra_q"],
               nfinal, chain.scale_dct)

    F = kw["n_aud_frames"]
    sbc_args = (x["aud_words"], dsbc.init_state(N, dev))
    sbc_kw = dict(active=x["aud_act"], n_valid=x["aud_nval"], n_frames=F,
                  channels=1, **{k: torch.as_tensor(t, dtype=torch.int32,
                                                    device=dev)
                                 for k, t in (("syn", ST.SYN_8),
                                              ("proto", ST.PROTO_8))})
    pcm = dsbc.decode_frames_batched(*sbc_args, **sbc_kw)[0]
    pcm = pcm[:, :F * 128].contiguous()
    g = torch.Generator(device="cpu").manual_seed(5)
    ds_state = torch.randint(-2_000_000, 2_000_000, (N, 3), generator=g,
                             dtype=torch.int32).to(dev)

    runs = {
        "K1": lambda: VS.run_scan_bucketed_dense(*k1_args, **k1_kw),
        "K1F": lambda: VS.run_scan_bucketed(*k1f_args, **k1f_kw),
        "K1S": lambda: VS.run_scan(*k1s_args, **k1s_kw),
        "K2": lambda: (IDCT.block_residuals_T(*k2_args),),
        "SBC": lambda: dsbc.decode_frames_batched(*sbc_args, **sbc_kw),
        "K5": lambda: DS.modulate(pcm, ds_state, n_samples=F * 128),
    }
    out = {}
    for name, fn in runs.items():
        out[name] = dict(call_ms=time_ms(fn, args.reps, busy=False),
                         device_ms=time_ms(fn, args.reps, busy=True),
                         checksum=checksum(fn()))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    print(json.dumps({"label": args.label or tree, "card":
                      smi.stdout.strip().splitlines()[0], "lanes": N,
                      "reps": args.reps, "kernels": out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
