"""Host-tick microbenchmark: the per-tick HOST cost of feeding
Fleet.run_chunk_full at N lanes on this machine's cores.

The port of espflix_tpu.tools.perf_host.  Measures the host section of
one full-chain tick (the work between chain calls in
runtime/scheduler.run_chunk_full), part by part:

  gather      -- session pump + native packed pop straight into the
                 batch layout (_gather_batch_packed), or the classic
                 _gather_pictures + make_picture_batch where no lane is
                 on the packed path
  pack        -- pack_slice_rows (+ row_perm) in device windows
  audio       -- _gather_audio_arrays (SBC ring pops -> word arrays)
  stack       -- the tick's chain inputs stacked as a chunk
                 (runtime/chunk_layout.py; no upload)

then runs --chunks chunks of 4 ticks through run_chunk_full itself on
--device (the card by default) and reports the fleet's timers a tick
(gather_packed, gather, batch_assemble, chain_enqueue -- the host's
enqueue of the chain, not its device time --, host_sync, and the spans
nested in them: gather.pop, gather.read, gather.feed, upload, readback;
runtime/telemetry.py) and the wall time the top-level ones leave
untimed.  Prints one JSON line.

Usage:  python -m espflix_tpu_torch.tools.perf_host --lanes 1024 --ticks 8
        ... --device cpu --lanes 4 --ticks 2 --chunks 1
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--lanes", type=int, default=1024)
    ap.add_argument("--ticks", type=int, default=8)
    ap.add_argument("--chunks", type=int, default=2,
                    help="chunks of 4 ticks through run_chunk_full after "
                    "the host-section ticks (0: none)")
    ap.add_argument("--titles", type=int, default=4)
    ap.add_argument("--gops", type=int, default=6)
    ap.add_argument("--device", default="cuda",
                    help="torch device of the fleet (cuda or cpu)")
    ap.add_argument("--service", default=None)
    args = ap.parse_args(argv)

    from espflix_tpu_torch.models import mpeg1 as M
    from espflix_tpu_torch.ops.host_pack import pack_slice_rows, row_perm
    from espflix_tpu_torch.runtime import chunk_layout as CL
    from espflix_tpu_torch.tools.serve_scenario import (build_fleet,
                                                        generate_service)

    tmp = None
    if args.service:
        root = args.service
    else:
        tmp = tempfile.TemporaryDirectory()
        root = tmp.name
        generate_service(root, [f"t{i}" for i in range(args.titles)],
                         seed=11, n_gops=args.gops, gop=12)
    fleet = build_fleet("file://" + root, args.lanes, args.titles,
                        words_per_lane=8192, stage="full",
                        device=args.device)

    t_gather, t_pack, t_audio, t_stack = [], [], [], []
    used_packed = 0
    for _ in range(args.ticks):
        t0 = time.perf_counter()
        g = fleet._gather_batch_packed()
        if g is not None:
            b, pts, pre = g
            used_packed += 1
        else:
            pics, pts, pre = fleet._gather_pictures()
            b = M.make_picture_batch(
                pics, words_per_lane=fleet.words_per_lane,
                max_slices=fleet.mb_h, geometry=(fleet.mb_w, fleet.mb_h))
        t1 = time.perf_counter()
        sl = pack_slice_rows(b, sort_rows=True, device_windows=True)
        perm, _dup = row_perm(sl["lane_of_row"], sl["rows"], sl["alive"],
                              fleet.n, fleet.mb_h)
        t2 = time.perf_counter()
        aud = fleet._gather_audio_arrays(fleet.audio_F)
        t3 = time.perf_counter()
        # the per-chunk xs assembly cost, at K = 1 (worst case), without
        # the OutputStage's state
        CL.stack_chunk([CL.tick_inputs(sl, perm, b, {}, aud[:4])])
        t4 = time.perf_counter()
        t_gather.append(t1 - t0)
        t_pack.append(t2 - t1)
        t_audio.append(t3 - t2)
        t_stack.append(t4 - t3)

    def ms(v):
        return float(np.median(v)) * 1000

    out = {
        "lanes": args.lanes,
        "ticks": args.ticks,
        "device": str(fleet.device),
        "packed_ticks": used_packed,
        "gather_ms": ms(t_gather),
        "pack_ms": ms(t_pack),
        "audio_ms": ms(t_audio),
        "stack_ms": ms(t_stack),
        "host_tick_ms": ms(t_gather) + ms(t_pack) + ms(t_audio)
        + ms(t_stack),
        "nproc": os.cpu_count(),
    }
    if args.chunks:
        from espflix_tpu_torch.runtime import telemetry
        # the same fleet through run_chunk_full: its timers a tick
        fleet.run_chunk_full(4)                 # warm-up chunk
        fleet.timers.acc.clear()
        fleet.timers.n.clear()
        t0 = time.perf_counter()
        for _ in range(args.chunks):
            fleet.run_chunk_full(4)
        if fleet.device.type == "cuda":
            import torch
            torch.cuda.synchronize(fleet.device)
        n_t = 4 * args.chunks
        wall = (time.perf_counter() - t0) * 1000 / n_t
        timers = {k: v * 1000 / n_t for k, v in fleet.timers.acc.items()}
        out["chain_ticks"] = n_t
        out["tick_wall_ms"] = wall
        out["timers_ms"] = timers
        out["untimed_ms"] = wall - sum(telemetry.top_level(timers)
                                       .values())
    print(json.dumps(out))
    if tmp is not None:
        tmp.cleanup()
    return out


if __name__ == "__main__":
    main()
