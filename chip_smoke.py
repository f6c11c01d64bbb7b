#!/usr/bin/env python3
"""Drive the PyTorch port's chain and serving paths once on one CUDA card.

    python3 chip_smoke.py        # 1024-lane chain, 256-lane serving
    python3 chip_smoke.py --lanes 64 --ticks 3 --reps 1
                                 # quick check (64 serving lanes)

Phases (any failure raises, so the exit code is non-zero and no result
line is printed):

1. device: requires torch.cuda; prints torch / CUDA / nvcc versions and
   the card's name and power limit (nvidia-smi);
2. build: compiles espflix_tpu_torch/csrc/*.cu for sm_90a (build/), one
   nvcc per source, all at once, and the sessions' native TS demuxer;
3. kernels: each of the eight entry points -- K1-K5 and the lane-minor
   K1F, K2F, K3F -- against its plain PyTorch version on the card at
   the main path's shapes (the bench tick's 1,024 lanes at 352x192),
   exact equality, CUDA-event medians, and the bound of its work;
4. the chain: run_full_chunk over the bench workload
   (bench.py --stage full inputs), once with host row windows (win=0)
   and once with device windows (win>0), then a scrolled run (a third
   of the lanes mid-slide): no lane errors, every kernel's launch
   counter rose during each run, and every out and carry equal to the
   same ticks run through the plain forms on the card;
5. serving A: serve_scenario's full stage over the local HTTP Range
   server (min(256, --lanes) lanes, 16 ticks in chunks of 4, 2 titles
   of 4 GOPs, two injected faults, a snapshot at tick 8 restored into a
   second fleet that runs 4 ticks): every lane decodes, the faults are
   contained and resynced, every kernel launched, the taps match their
   checksums;
6. serving B: the same lanes, service and HTTP server, 8 ticks, once
   with the kernels and once through the plain forms: every TickResult
   and carry identical;
7. decode-only serving: serve_scenario --stage decode over the same
   HTTP service at the same lanes, 16 ticks pipelined (tick_submit /
   tick_collect) and 16 chunked (run_chunk, K = 4), two injected faults
   each: every lane decodes, the faults are resynced, and K1, K2, K3,
   K1F, K2F and K3F all launched; then 4 ticks per dispatch, and 4 of
   a one-lane fleet (the small-fleet branch), through the kernels and
   through the plain forms: every TickResult field and carry identical;
8. the total seconds, the card's name and power limit, one JSON line
   with the kernels' numbers (launches: serving A's for K1-K5, the
   decode-only serving's for K1F-K3F), and the final {"ok": true, ...}
   line.

Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import statistics
import subprocess
import sys
import tempfile
import time


# chain ticks compared with the plain path on the card: the plain PDM
# and the plain scan take seconds a tick at 1,024 lanes
PLAIN_TICKS = 6
# an H100 SXM's HBM3 rate (NVIDIA's data sheet), for the bytes bound
HBM_BPS = 3.35e12
# latency of one dependent 32-bit integer operation, in SM clock
# cycles (an assumption of the K5 bound; see PERF.md)
INT_DEP_CYCLES = 4


def log(*a):
    print(*a, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int):
    """Median CUDA-event time of fn() over reps runs, after one warm
    run."""
    import torch
    fn()
    ts = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        ts.append(a.elapsed_time(b))
    return statistics.median(ts)


def max_abs_err(a, b) -> int:
    import torch
    if a.shape != b.shape or a.dtype != b.dtype:
        raise AssertionError(f"{a.shape}/{a.dtype} vs {b.shape}/{b.dtype}")
    if a.dtype == torch.bool:
        return int((a != b).sum())
    return int((a.long() - b.long()).abs().max()) if a.numel() else 0


def require_equal(name, pairs):
    """Max |kernel - plain| over the pairs; raises unless it is 0."""
    worst = 0
    for i, (a, b) in enumerate(pairs):
        e = max_abs_err(a, b)
        worst = max(worst, e)
        if e:
            where = (a != b).nonzero()[:4].tolist()
            raise AssertionError(
                f"{name}: output {i} kernel != plain (max |err| {e}, "
                f"{int((a != b).sum())} elements, first at {where})")
    return worst


@contextlib.contextmanager
def plain_forms():
    """Route the eight kernel wrappers to their plain PyTorch versions
    (for the on-card comparison runs)."""
    from espflix_tpu_torch.ops import composite as CO
    from espflix_tpu_torch.ops import delta_sigma as DS
    from espflix_tpu_torch.ops import idct as IDCT
    from espflix_tpu_torch.ops import mocomp as MC
    from espflix_tpu_torch.ops import vlc_scan as VS
    swaps = [(VS, "run_scan_bucketed_dense",
              VS.run_scan_bucketed_dense_torch),
             (IDCT, "block_residuals_T", IDCT.block_residuals_T_torch),
             (MC, "predict_compose_put", MC.predict_compose_put_torch),
             (CO, "synthesize_field_pair_parts",
              CO.synthesize_field_pair_parts_torch),
             (DS, "modulate", DS.modulate_torch),
             (VS, "run_scan_bucketed", VS.run_scan_bucketed_torch),
             (IDCT, "block_residuals_flat", IDCT.block_residuals_flat_torch),
             (MC, "predict_compose_put_flat",
              MC.predict_compose_put_flat_torch)]
    saved = [(m, n, getattr(m, n)) for m, n, _ in swaps]
    try:
        for m, n, f in swaps:
            setattr(m, n, f)
        yield
    finally:
        for m, n, f in saved:
            setattr(m, n, f)


class StageTimer:
    """CUDA-event spans per chain stage, summed per tick."""

    def __init__(self):
        self.spans = []

    @contextlib.contextmanager
    def __call__(self, name):
        import torch
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        yield
        b.record()
        self.spans.append((name, a, b))

    def totals(self):
        out = {}
        for name, a, b in self.spans:
            out[name] = out.get(name, 0.0) + a.elapsed_time(b)
        return out


def wrap32_int(v) -> int:
    return (int(v) + (1 << 31)) % (1 << 32) - (1 << 31)


def tap_sums_match(rs, tap_lanes):
    """Raise unless every tapped lane's fields and PDM words sum to its
    field_sum and pdm_sum in every TickResult."""
    for t, r in enumerate(rs):
        for k, lane in enumerate(tap_lanes):
            fs = wrap32_int(r.tap_fields[k].sum(dtype="int64"))
            ps = wrap32_int(r.tap_pdm[k].sum(dtype="int64"))
            if fs != int(r.field_sum[lane]) or ps != int(r.pdm_sum[lane]):
                raise AssertionError(f"tick {t} lane {lane}: tap sums "
                                     "!= field_sum / pdm_sum")


def record_results(fleet, method: str = "run_chunk_full") -> list:
    """Collect every TickResult that fleet.<method> returns (a list, or
    one TickResult for tick_collect)."""
    rs = []
    run = getattr(fleet, method)

    def recorded(*a, **kw):
        out = run(*a, **kw)
        rs.extend(out if isinstance(out, list) else [out])
        return out
    setattr(fleet, method, recorded)
    return rs


def kernel_counters() -> dict:
    """Kernel name -> (wrapper module, its launch-count attribute)."""
    from espflix_tpu_torch.ops import composite as CO
    from espflix_tpu_torch.ops import delta_sigma as DS
    from espflix_tpu_torch.ops import idct as IDCT
    from espflix_tpu_torch.ops import mocomp as MC
    from espflix_tpu_torch.ops import vlc_scan as VS
    return {"K1_slice_scan_dense": (VS, "launches"),
            "K2_dequant_idct": (IDCT, "launches"),
            "K3_predict_compose_put": (MC, "launches"),
            "K4_composite_field_pair": (CO, "launches"),
            "K5_pdm": (DS, "launches"),
            "K1F_slice_scan_flat": (VS, "launches_flat"),
            "K2F_dequant_idct_flat": (IDCT, "launches_flat"),
            "K3F_predict_compose_put_flat": (MC, "launches_flat")}


CHAIN_KERNELS = ("K1_slice_scan_dense", "K2_dequant_idct",
                 "K3_predict_compose_put", "K4_composite_field_pair",
                 "K5_pdm")
DECODE_KERNELS = ("K1_slice_scan_dense", "K2_dequant_idct",
                  "K3_predict_compose_put", "K1F_slice_scan_flat",
                  "K2F_dequant_idct_flat", "K3F_predict_compose_put_flat")
FLAT_KERNELS = DECODE_KERNELS[3:]


def reset_counts():
    for m, attr in kernel_counters().values():
        setattr(m, attr, 0)


def read_counts(label, names) -> dict:
    """The launch counts of `names` since reset_counts(); raises unless
    each of them launched."""
    counters = kernel_counters()
    counts = {n: getattr(*counters[n]) for n in names}
    for name, c in counts.items():
        if c < 1:
            raise AssertionError(f"{label}: {name} never launched")
    return counts


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def compose_bytes(res, recs, active, frames, presented) -> int:
    """K3 / K3F: residuals, records, flags and both frame slots read; the
    parity slot and the presented planes written."""
    planes = [presented[k] for k in "yuv"]
    return (nbytes(res, recs, active, frames["parity"],
                   *[frames[k] for k in "yuv"]) + 2 * nbytes(*planes))


def max_sm_clock_hz() -> float:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True, timeout=60)
    return float(out.stdout.strip().splitlines()[0]) * 1e6


def bound(moved_bytes: int, chain_ms: float = 0.0):
    """(bound_ms, bound_by): the least time of the work -- the bytes it
    must move (each input read once, each output written once) at
    HBM_BPS, or, where larger, a dependent-operation chain's time."""
    ms = moved_bytes / HBM_BPS * 1e3
    return (chain_ms, "operations") if chain_ms > ms else (ms, "bytes")


@contextlib.contextmanager
def http_service(seed: int = 0):
    """The serving phases' service (2 titles of 4 GOPs) behind the local
    HTTP Range server; yields its URL."""
    from espflix_tpu_torch import build
    from espflix_tpu_torch.tools import serve_scenario as SS

    build.BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build.BUILD_ROOT) as root:
        t0 = time.perf_counter()
        SS.generate_service(root, ["title00", "title01"], seed=seed,
                            n_gops=4)
        log(f"[serve] service of 2 titles x 4 GOPs generated in "
            f"{time.perf_counter() - t0:.1f} s")
        url, shutdown = SS.start_http_service(root)
        try:
            yield url
        finally:
            shutdown()


def serve_phase_a(dev, url: str, lanes: int, ticks: int, smi: str,
                  seed: int = 0):
    """serve_scenario's full stage over HTTP with faults and a snapshot
    restored into a second fleet; returns the launch counts."""
    import torch
    from espflix_tpu_torch.tools import serve_scenario as SS

    fleet = SS.build_fleet(url, lanes, 2, stage="full", device=dev)
    rs = record_results(fleet)
    torch.cuda.synchronize()
    reset_counts()
    stats, snap = SS.run_scenario(fleet, ticks, seed=seed, faults=2,
                                  snapshot_at=ticks // 2, dispatch="full")
    counts = read_counts("serving A", CHAIN_KERNELS)
    fleet2 = SS.build_fleet(url, lanes, 2, stage="full", device=dev)
    restored = fleet2.restore(snap)
    rstats, _ = SS.run_scenario(fleet2, 4, seed=seed + 1, faults=0,
                                dispatch="full")
    tap_sums_match(rs, (0,))
    if int(stats.frames_per_lane.min()) < 1:
        raise AssertionError("serving A: a lane decoded no frame")
    if rstats.frames <= 0 or restored < 1:
        raise AssertionError(f"serving A: restore ({restored} lanes) "
                             "decoded nothing")
    if stats.errors < 1 or stats.resyncs < 1:
        raise AssertionError("serving A: the injected faults were not "
                             f"caught ({stats.errors} errors, "
                             f"{stats.resyncs} resyncs)")
    tm = fleet.timers.acc
    host_ms = 1000 * (tm.get("gather", 0) + tm.get("batch_assemble", 0))
    dev_ms = 1000 * (tm.get("device_chain", 0) + tm.get("host_sync", 0))
    log(f"[serve A] {lanes} lanes x {ticks} ticks over HTTP: "
        f"{1000 * stats.wall_s / ticks:.1f} ms/tick wall, host "
        f"(gather, assemble) {host_ms / ticks:.1f} ms/tick, device chain "
        f"(launch + sync) {dev_ms / ticks:.1f} ms/tick; frames "
        f"{stats.frames}, min/lane {int(stats.frames_per_lane.min())}, "
        f"errors {stats.errors}, resyncs {stats.resyncs}, actions "
        f"{stats.actions}, restored {restored} lanes -> {rstats.frames} "
        f"frames in 4 ticks; launches {counts} | {smi}")
    return counts


def serve_phase_b(dev, url: str, lanes: int, ticks: int = 8,
                  seed: int = 0):
    """Serving A's lanes, service and transport for `ticks` ticks with
    the kernels and through the plain forms: every TickResult field and
    carry identical."""
    import numpy as np
    import torch
    from espflix_tpu_torch.tools import serve_scenario as SS

    tap_lanes = (0, lanes // 2 + 1)
    runs = []
    for plain in (False, True):
        fleet = SS.build_fleet(url, lanes, 2, stage="full", device=dev)
        rs = record_results(fleet)
        with plain_forms() if plain else contextlib.nullcontext():
            SS.run_scenario(fleet, ticks, seed=seed, faults=1,
                            tap_lanes=tap_lanes, dispatch="full")
        torch.cuda.synchronize()
        runs.append((fleet, rs))
    (fk, rk), (fp, rp) = runs
    if len(rk) != ticks or len(rp) != ticks:
        raise AssertionError(f"serving B: expected {ticks} TickResults")
    n_cmp = 0
    for t, (a, b) in enumerate(zip(rk, rp)):
        for key in ("video_lanes", "pts", "errors", "audio_lanes",
                    "audio_starved", "audio_errors", "field_sum",
                    "pdm_sum", "tap_fields", "tap_pdm"):
            if not np.array_equal(getattr(a, key), getattr(b, key)):
                raise AssertionError(f"serving B tick {t}: {key} "
                                     "kernel != plain")
            n_cmp += 1
        require_equal(f"serving B tick {t} planes",
                      [(a.y, b.y), (a.u, b.u), (a.v, b.v)])
        n_cmp += 3
    require_equal("serving B carries",
                  [(fk.frames[k], fp.frames[k])
                   for k in ("y", "u", "v", "parity")]
                  + [(fk.sbc_state, fp.sbc_state),
                     (fk.output.pdm_state, fp.output.pdm_state)])
    tap_sums_match(rk, tap_lanes)
    frames = sum(int(r.video_lanes.sum()) for r in rk)
    errors = sum(int(r.errors.sum()) for r in rk)
    log(f"[serve B] {lanes} lanes x {ticks} ticks over HTTP (serving A's "
        f"service): kernel path == plain path ({n_cmp} TickResult fields "
        f"+ 6 carries; {frames} frames, {errors} lane errors, taps "
        f"{tap_lanes})")


def flat_kernels(x, chain, rand_frames, reps: int, mbw: int,
                 mbh: int) -> list:
    """K1F, K2F and K3F against their plain versions on the bench tick
    `x` (run_chunk's scan configuration: two buckets of 2,048 / 512
    steps in chunks of 128, long_rows from bucket_policy); returns
    their kernel entries."""
    import torch
    from espflix_tpu_torch.models import mpeg1 as M
    from espflix_tpu_torch.ops import idct as IDCT
    from espflix_tpu_torch.ops import mocomp as MC
    from espflix_tpu_torch.ops import vlc_scan as VS
    from espflix_tpu_torch.runtime.scheduler import bucket_policy

    out = []
    N = x["active"].shape[0]
    args = [x[k] for k in M.SCAN_KEYS]
    need = int(((x["pic_type"] == 1) & (x["alive"] == 1)).sum())
    long_rows, s_long, s_short = bucket_policy(
        max(need, 8), args[0].shape[0], steps_long=2048, steps_short=512)
    skw = dict(mb_width=mbw, mb_height=mbh, n_lanes=N, long_rows=long_rows,
               steps_long=s_long, steps_short=s_short, chunk=128,
               lut=chain.scan_lut, zigzag=chain.zigzag)
    got = VS.run_scan_bucketed(*args, **skw)
    ref = VS.run_scan_bucketed_torch(*args, **skw)
    err = require_equal("K1F scan", zip(got, ref))
    if got[3].any():
        raise AssertionError("K1F: lane errors on well-formed content")
    out.append(dict(
        name="K1F_slice_scan_flat", route="cuda",
        source="espflix_tpu_torch/csrc/scan.cu",
        replaces="espflix_tpu/ops/vlc_scan_pallas.py:55",
        max_abs_err=err, library_ms=None,
        ms=time_ms(lambda: VS.run_scan_bucketed(*args, **skw), reps),
        plain_ms=time_ms(lambda: VS.run_scan_bucketed_torch(*args, **skw),
                         max(1, reps // 2))))
    out[-1]["bound_ms"], out[-1]["bound_by"] = bound(nbytes(
        *args, chain.scan_lut, chain.zigzag, *got))
    log(f"[kernel] {out[-1]} (long_rows {long_rows}, steps "
        f"{s_long}/{s_short})")

    coeffs, recs, nfinal = got[:3]
    idct_args = (coeffs, recs, nfinal, x["intra_q"], x["non_intra_q"],
                 chain.scale_dct)
    res_k = IDCT.block_residuals_flat(*idct_args)
    res_p = IDCT.block_residuals_flat_torch(*idct_args)
    out.append(dict(
        name="K2F_dequant_idct_flat", route="cuda",
        source="espflix_tpu_torch/csrc/idct.cu",
        replaces="espflix_tpu/ops/idct_pallas.py:86",
        max_abs_err=require_equal("K2F idct", [(res_k, res_p)]),
        library_ms=None,
        ms=time_ms(lambda: IDCT.block_residuals_flat(*idct_args), reps),
        plain_ms=time_ms(lambda: IDCT.block_residuals_flat_torch(
            *idct_args), reps)))
    out[-1]["bound_ms"], out[-1]["bound_by"] = bound(nbytes(*idct_args,
                                                            res_k))
    log(f"[kernel] {out[-1]}")

    fr_k = rand_frames()
    fr_p = {k: v.clone() for k, v in fr_k.items()}
    active = x["active"].clone()
    active[5::13] = False                      # some inactive lanes
    mc_kw = dict(mb_width=mbw, mb_height=mbh)
    pk = MC.predict_compose_put_flat(res_k, recs, active, fr_k, **mc_kw)
    pp = MC.predict_compose_put_flat_torch(res_k, recs, active, fr_p,
                                           **mc_kw)
    err = require_equal("K3F compose", [(pk[k], pp[k]) for k in "yuv"]
                        + [(fr_k[k], fr_p[k]) for k in "yuv"])
    out.append(dict(
        name="K3F_predict_compose_put_flat", route="cuda",
        source="espflix_tpu_torch/csrc/compose.cu",
        replaces="espflix_tpu/ops/mocomp_pallas.py:92,161",
        max_abs_err=err, library_ms=None,
        ms=time_ms(lambda: MC.predict_compose_put_flat(
            res_k, recs, active, fr_k, **mc_kw), reps),
        plain_ms=time_ms(lambda: MC.predict_compose_put_flat_torch(
            res_k, recs, active, fr_p, **mc_kw), reps)))
    out[-1]["bound_ms"], out[-1]["bound_by"] = bound(
        compose_bytes(res_k, recs, active, fr_k, pk))
    log(f"[kernel] {out[-1]}")
    torch.cuda.synchronize()
    return out


def decode_serving(dev, url: str, lanes: int, smi: str, ticks: int = 16,
                   seed: int = 0) -> dict:
    """serve_scenario --stage decode over HTTP, `ticks` ticks pipelined
    (tick_submit / tick_collect) and chunked (run_chunk, K = 4), two
    injected faults each: every lane decodes, the faults are caught and
    resynced, and every decode kernel launched.  Returns the counts."""
    import torch
    from espflix_tpu_torch.tools import serve_scenario as SS

    torch.cuda.synchronize()
    reset_counts()
    for dispatch in ("pipelined", "chunk"):
        fleet = SS.build_fleet(url, lanes, 2, device=dev)
        stats, _ = SS.run_scenario(fleet, ticks, seed=seed, faults=2,
                                   dispatch=dispatch)
        torch.cuda.synchronize()
        if int(stats.frames_per_lane.min()) < 1:
            raise AssertionError(f"decode {dispatch}: a lane decoded no "
                                 "frame")
        if stats.errors < 1 or stats.resyncs < 1:
            raise AssertionError(
                f"decode {dispatch}: the injected faults were not caught "
                f"({stats.errors} errors, {stats.resyncs} resyncs)")
        tm = fleet.timers.acc
        split = {k: round(1000 * v / ticks, 2) for k, v in tm.items()}
        host = 1000 * stats.wall_s / ticks - sum(split.values())
        log(f"[decode {dispatch}] {lanes} lanes x {ticks} ticks over HTTP: "
            f"{1000 * stats.wall_s / ticks:.1f} ms/tick wall; timers "
            f"ms/tick {split}; untimed host (gather, control) "
            f"{host:.1f} ms/tick; frames {stats.frames}, min/lane "
            f"{int(stats.frames_per_lane.min())}, audio lane-ticks "
            f"{stats.audio_lanes}, errors {stats.errors}, resyncs "
            f"{stats.resyncs}, actions {stats.actions} | {smi}")
    counts = read_counts("decode serving", DECODE_KERNELS)
    log(f"[decode serving] launches {counts}")
    return counts


def decode_parity(dev, url: str, lanes: int, ticks: int = 4,
                  seed: int = 0):
    """The same lanes for `ticks` ticks per dispatch through the kernels
    and through the plain forms, plus a one-lane fleet (the small-fleet
    branch): every TickResult field and carry identical."""
    import numpy as np
    import torch
    from espflix_tpu_torch.tools import serve_scenario as SS

    keys = ("video_lanes", "pts", "errors", "audio_lanes", "pcm",
            "pcm_samples", "audio_starved", "audio_errors")
    for label, n, dispatch, method in (
            ("pipelined", lanes, "pipelined", "tick_collect"),
            ("chunk", lanes, "chunk", "run_chunk"),
            ("one-lane tick", 1, "pipelined", "tick_collect")):
        runs = []
        for plain in (False, True):
            fleet = SS.build_fleet(url, n, 2, device=dev)
            rs = record_results(fleet, method)
            reset_counts()
            with plain_forms() if plain else contextlib.nullcontext():
                SS.run_scenario(fleet, ticks, seed=seed, faults=1,
                                dispatch=dispatch)
            torch.cuda.synchronize()
            counts = {k: getattr(*c) for k, c in kernel_counters().items()}
            runs.append((fleet, rs, counts))
        (fk, rk, ck), (fp, rp, cp) = runs
        if len(rk) != ticks or len(rp) != ticks:
            raise AssertionError(f"decode {label}: expected {ticks} results")
        for t, (a, b) in enumerate(zip(rk, rp)):
            for key in keys:
                if not np.array_equal(getattr(a, key), getattr(b, key)):
                    raise AssertionError(f"decode {label} tick {t}: {key} "
                                         "kernel != plain")
            require_equal(f"decode {label} tick {t} planes",
                          [(a.y, b.y), (a.u, b.u), (a.v, b.v)])
        require_equal(f"decode {label} carries",
                      [(fk.frames[k], fp.frames[k])
                       for k in ("y", "u", "v", "parity")]
                      + [(fk.sbc_state, fp.sbc_state)])
        if any(cp.values()):
            raise AssertionError(f"decode {label}: the plain run launched "
                                 f"kernels {cp}")
        if n == 1 and min(ck[k] for k in FLAT_KERNELS) < 1:
            raise AssertionError(f"decode {label}: the small-fleet branch "
                                 f"did not launch K1F-K3F ({ck})")
        log(f"[decode {label}] {n} lanes x {ticks} ticks over HTTP: kernel "
            f"path == plain path ({len(keys) + 3} TickResult fields x "
            f"{ticks} + 4 carries; kernel launches {ck})")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--lanes", type=int, default=1024)
    ap.add_argument("--ticks", type=int, default=12,
                    help="ticks of the 12-picture GOP chunk to run")
    ap.add_argument("--reps", type=int, default=5,
                    help="timed repetitions per kernel")
    args = ap.parse_args()
    t_start = time.perf_counter()

    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda."
                         "is_available() is false)")

    # ---- 1. device ------------------------------------------------------
    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    nvcc = subprocess.run(["bash", "-c", "nvcc --version 2>/dev/null || "
                           "/usr/local/cuda/bin/nvcc --version"],
                          capture_output=True, text=True).stdout
    smi = nvidia_smi_line()
    sm_clock_hz = max_sm_clock_hz()
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    log(f"[device] nvcc: {nvcc.strip().splitlines()[-1] if nvcc else '?'}")
    log(f"[device] {torch.cuda.get_device_name(0)} | nvidia-smi: {smi}")

    import numpy as np

    from espflix_tpu_torch import build
    from espflix_tpu_torch.models import mpeg1 as M
    from espflix_tpu_torch.models import sbc as dsbc
    from espflix_tpu_torch.ops import composite as CO
    from espflix_tpu_torch.ops import delta_sigma as DS
    from espflix_tpu_torch.ops import idct as IDCT
    from espflix_tpu_torch.ops import mocomp as MC
    from espflix_tpu_torch.ops import vlc_scan as VS
    from espflix_tpu_torch.ops.intwrap import wrap32
    from espflix_tpu_torch.runtime import chain as CH
    from espflix_tpu_torch.runtime import session as SE
    from espflix_tpu_torch.runtime.workload import bench_chunk

    # ---- 2. build -------------------------------------------------------
    t0 = time.perf_counter()
    build.library()
    log(f"[build] {build.library_path()} in "
        f"{time.perf_counter() - t0:.1f} s (nvcc "
        f"{'%.1f s' % build.build_seconds if build.build_seconds else 'cached'}"
        f", {len([p for p in build.sources() if p.suffix == '.cu'])} "
        "sources in parallel)")
    # the sessions' TS demuxer (native/ts_demux.cpp) builds at its first
    # use; build it here so that the timed serving phase does not
    t0 = time.perf_counter()
    demux = "ready" if SE.native_demux_available() else \
        "unavailable: numpy walker"
    log(f"[build] native TS demuxer {demux} in "
        f"{time.perf_counter() - t0:.1f} s")

    # ---- workload --------------------------------------------------------
    t0 = time.perf_counter()
    xs_np, kw = bench_chunk(args.lanes)
    xs_np_w, kw_w = bench_chunk(args.lanes, win=True)
    xs_np = {k: v[:args.ticks] for k, v in xs_np.items()}
    xs_np_w = {k: v[:args.ticks] for k, v in xs_np_w.items()}
    log(f"[workload] {args.lanes} lanes x {args.ticks} ticks, "
        f"NS={xs_np['rows'].shape[1]} rows, word window "
        f"{xs_np['words'].shape[2]} (device win {kw_w['win']}), host "
        f"build {time.perf_counter() - t0:.1f} s")
    xs = CH.xs_to_torch(xs_np, dev)
    xs_w = CH.xs_to_torch(xs_np_w, dev)
    N = args.lanes
    mbw, mbh = kw["mb_width"], kw["mb_height"]
    chain = CH.FullChain(pal=False, n_aud_frames=kw["n_aud_frames"],
                         device=dev)
    ckw = {k: kw[k] for k in ("mb_width", "mb_height", "n_lanes",
                              "long_rows", "steps_long", "steps_short",
                              "chunk")}

    # ---- 3. kernels against their plain versions -----------------------
    kernels = []
    # K1 on the tick with the most I pictures (longest scan)
    n_i = ((xs_np["pic_type"] == 1) & (xs_np["alive"] == 1)).sum(axis=1)
    k_i = int(n_i.argmax())
    x = {k: v[k_i] for k, v in xs.items()}
    scan_args = [x[k] for k in CH.DECODE_KEYS[:9]]
    scan_kw = dict(ckw, lut=chain.scan_lut, zigzag=chain.zigzag)
    got = VS.run_scan_bucketed_dense(*scan_args, **scan_kw)
    ref = VS.run_scan_bucketed_dense_torch(*scan_args, **scan_kw)
    err = require_equal("K1 scan", zip(got, ref))
    if got[3].any():
        raise AssertionError("K1: lane errors on well-formed content")
    kernels.append(dict(
        name="K1_slice_scan_dense", route="cuda",
        source="espflix_tpu_torch/csrc/scan.cu",
        replaces="espflix_tpu/ops/vlc_scan_pallas.py:55",
        max_abs_err=err, library_ms=None,
        ms=time_ms(lambda: VS.run_scan_bucketed_dense(*scan_args,
                                                     **scan_kw), args.reps),
        plain_ms=time_ms(lambda: VS.run_scan_bucketed_dense_torch(
            *scan_args, **scan_kw), max(1, args.reps // 2))))
    kernels[-1]["bound_ms"], kernels[-1]["bound_by"] = bound(nbytes(
        *scan_args, chain.scan_lut, chain.zigzag, *got))
    log(f"[kernel] {kernels[-1]}")

    coeffs_T, recs, nfinal = got[:3]
    intra_bl = ((recs & 3) == VS.MB_INTRA).repeat_interleave(6, dim=1)
    qs_bl = ((recs >> 2) & 31).repeat_interleave(6, dim=1)
    idct_args = (coeffs_T, intra_bl, qs_bl, x["intra_q"],
                 x["non_intra_q"], nfinal, chain.scale_dct)
    res_k = IDCT.block_residuals_T(*idct_args)
    res_p = IDCT.block_residuals_T_torch(*idct_args)
    kernels.append(dict(
        name="K2_dequant_idct", route="cuda",
        source="espflix_tpu_torch/csrc/idct.cu",
        replaces="espflix_tpu/ops/idct_pallas.py:171",
        max_abs_err=require_equal("K2 idct", [(res_k, res_p)]),
        library_ms=None,
        ms=time_ms(lambda: IDCT.block_residuals_T(*idct_args), args.reps),
        plain_ms=time_ms(lambda: IDCT.block_residuals_T_torch(*idct_args),
                         args.reps)))
    kernels[-1]["bound_ms"], kernels[-1]["bound_by"] = bound(nbytes(
        *idct_args, res_k))
    log(f"[kernel] {kernels[-1]}")

    # K3 on a P-heavy tick with random reference planes and parities
    g = torch.Generator(device="cpu").manual_seed(5)

    def rand_frames():
        fr = M.init_frame_state(N, mbw * 16, mbh * 16, dev)
        for k in "yuv":
            fr[k] = torch.randint(0, 249, fr[k].shape, generator=g,
                                  dtype=torch.uint8).to(dev)
        fr["parity"] = torch.randint(0, 2, (N,), generator=g,
                                     dtype=torch.int32).to(dev)
        return fr

    fr_k = rand_frames()
    fr_p = {k: v.clone() for k, v in fr_k.items()}
    active = x["active"].clone()
    active[::17] = False                       # some inactive lanes
    mc_kw = dict(mb_width=mbw, mb_height=mbh)
    pk = MC.predict_compose_put(res_k, recs, active, fr_k, **mc_kw)
    pp = MC.predict_compose_put_torch(res_k, recs, active, fr_p, **mc_kw)
    err = require_equal("K3 compose", [(pk[k], pp[k]) for k in "yuv"]
                        + [(fr_k[k], fr_p[k]) for k in "yuv"])
    kernels.append(dict(
        name="K3_predict_compose_put", route="cuda",
        source="espflix_tpu_torch/csrc/compose.cu",
        replaces="espflix_tpu/ops/mocomp_pallas.py:975,1084",
        max_abs_err=err, library_ms=None,
        ms=time_ms(lambda: MC.predict_compose_put(res_k, recs, active,
                                                  fr_k, **mc_kw), args.reps),
        plain_ms=time_ms(lambda: MC.predict_compose_put_torch(
            res_k, recs, active, fr_p, **mc_kw), args.reps)))
    kernels[-1]["bound_ms"], kernels[-1]["bound_by"] = bound(
        compose_bytes(res_k, recs, active, fr_k, pk))
    log(f"[kernel] {kernels[-1]}")

    comp_args = (pk["y"], pk["u"], pk["v"], x["parity"], x["osd"],
                 x["blend"], x["progress"])
    comp_kw = dict(pal=False, tmpl=chain.templates, dither=chain.dither)
    ck = CO.synthesize_field_pair_parts(*comp_args, **comp_kw)
    cp = CO.synthesize_field_pair_parts_torch(*comp_args, **comp_kw)
    err = require_equal("K4 composite", zip(ck, cp))
    pal_t = CH.FullChain(pal=True, n_aud_frames=1, device=dev)
    pal_kw = dict(pal=True, tmpl=pal_t.templates, dither=pal_t.dither)
    err = max(err, require_equal("K4 composite PAL", zip(
        CO.synthesize_field_pair_parts(*comp_args, **pal_kw),
        CO.synthesize_field_pair_parts_torch(*comp_args, **pal_kw))))
    kernels.append(dict(
        name="K4_composite_field_pair", route="cuda",
        source="espflix_tpu_torch/csrc/composite.cu",
        replaces="espflix_tpu/ops/composite_pallas.py:67",
        max_abs_err=err, library_ms=None,
        ms=time_ms(lambda: CO.synthesize_field_pair_parts(
            *comp_args, **comp_kw), args.reps),
        plain_ms=time_ms(lambda: CO.synthesize_field_pair_parts_torch(
            *comp_args, **comp_kw), args.reps)))
    kernels[-1]["bound_ms"], kernels[-1]["bound_by"] = bound(nbytes(
        *comp_args, chain.templates, chain.dither, *ck))
    log(f"[kernel] {kernels[-1]}")

    # K5 on the tick's decoded SBC PCM (1,664 samples a lane) from a
    # random carried state, and on full-scale square waves
    S = kw["n_aud_frames"] * 128
    pcm, _h, _e, _b = dsbc.decode_frames_batched(
        x["aud_words"], dsbc.init_state(N, dev), active=x["aud_act"],
        n_valid=x["aud_nval"], n_frames=kw["n_aud_frames"], channels=1,
        syn=chain.sbc_syn, proto=chain.sbc_proto)
    pcm = pcm[:, :S].contiguous()
    st = torch.randint(-2_000_000, 2_000_000, (N, 3), generator=g,
                       dtype=torch.int32).to(dev)
    period = 2 << (torch.arange(N, device=dev) % 8)[:, None]
    square = torch.where(
        (torch.arange(S, device=dev)[None, :] // period) % 2 == 1,
        32767, -32767).to(torch.int16)
    err = 0
    for label, p_in in (("decoded PCM", pcm), ("square waves", square)):
        err = max(err, require_equal(
            f"K5 pdm ({label})",
            zip(DS.modulate(p_in, st, n_samples=S),
                DS.modulate_torch(p_in, st, n_samples=S))))
    kernels.append(dict(
        name="K5_pdm", route="cuda",
        source="espflix_tpu_torch/csrc/pdm.cu",
        replaces="espflix_tpu/ops/delta_sigma_pallas.py:61",
        max_abs_err=err, library_ms=None,
        ms=time_ms(lambda: DS.modulate(pcm, st, n_samples=S), args.reps),
        plain_ms=None))
    # the plain PDM takes seconds: one run, already warm from the check
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    DS.modulate_torch(pcm, st, n_samples=S)
    b.record()
    torch.cuda.synchronize()
    kernels[-1]["plain_ms"] = a.elapsed_time(b)
    # each lane is one chain of 2 * 16 * S bit steps, each three
    # dependent integer operations (shift, add into i1, add into i2)
    steps = 2 * 16 * S
    kernels[-1]["bound_ms"], kernels[-1]["bound_by"] = bound(
        nbytes(pcm, st, *DS.modulate(pcm, st, n_samples=S)),
        steps * 3 * INT_DEP_CYCLES / sm_clock_hz * 1e3)
    log(f"[kernel] {kernels[-1]} (chain of {steps} steps at "
        f"{sm_clock_hz / 1e6:.0f} MHz)")

    kernels += flat_kernels(x, chain, rand_frames, args.reps, mbw, mbh)

    # ---- 4. the chain ----------------------------------------------------
    def fresh_state():
        return (M.init_frame_state(N, mbw * 16, mbh * 16, dev),
                dsbc.init_state(N, dev), DS.init_state(N, dev))

    def compare_plain(label, xs_t, kwx, ticks, slide=None):
        """The first `ticks` ticks through the kernels and through the
        plain forms, every out and carry equal."""
        sub = {k: v[:ticks] for k, v in xs_t.items()}
        run_kw = dict(kwx, tap=1, return_planes=True)
        res = []
        for plain in (False, True):
            fr, sb, ds = fresh_state()
            with plain_forms() if plain else contextlib.nullcontext():
                res.append(CH.run_full_chunk(sub, fr, sb, ds, tap_idx,
                                             slide, **run_kw))
        torch.cuda.synchronize()
        (fr, sb, ds, outs), (fr2, sb2, ds2, outs2) = res
        pairs = [(outs[k], outs2[k]) for k in outs]
        pairs += [(fr[k], fr2[k]) for k in ("y", "u", "v", "parity")]
        pairs += [(sb, sb2), (ds, ds2)]
        require_equal(f"chain {label}", pairs)
        log(f"[chain {label}] kernel path == plain path on the card over "
            f"{ticks} of {args.ticks} ticks ({len(pairs)} tensors)")

    tap_idx = torch.tensor([N // 3], dtype=torch.int32, device=dev)
    plain_ticks = min(PLAIN_TICKS, args.ticks)
    if plain_ticks < args.ticks:
        log(f"[chain] the plain-path comparisons run {plain_ticks} of the "
            f"{args.ticks} ticks (all {N} lanes) to bound the run's time")
    chain_counts = {}
    for label, xs_t, kwx in (("win=0", xs, kw), ("win>0", xs_w, kw_w)):
        run_kw = dict(kwx, tap=1, return_planes=True)
        timer = StageTimer()
        fr, sb, ds = fresh_state()
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        fr, sb, ds, outs = CH.run_full_chunk(xs_t, fr, sb, ds, tap_idx,
                                             None, timer=timer, **run_kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        chain_counts[label] = counts = read_counts(f"chain {label}",
                                                   CHAIN_KERNELS)
        if outs["err"].any():
            raise AssertionError(f"{label}: lane errors "
                                 f"{int(outs['err'].sum())}")
        # self-consistency: the tapped lane's canvas bytes are its
        # field_sum, its PDM words its pdm_sum
        t = int(tap_idx[0])
        fs = outs["tap_fields"].long().sum(dim=(1, 2, 3, 4))
        if not torch.equal(wrap32(fs), outs["field_sum"][:, t]):
            raise AssertionError(f"{label}: tap canvas != field_sum")
        ps = wrap32(outs["tap_pdm"].long().sum(dim=(1, 2)))
        if not torch.equal(ps, outs["pdm_sum"][:, t]):
            raise AssertionError(f"{label}: tap pdm != pdm_sum")
        stages = {k: round(v / args.ticks, 3)
                  for k, v in timer.totals().items()}
        log(f"[chain {label}] {args.ticks} ticks x {N} lanes: "
            f"{1000 * wall / args.ticks:.1f} ms/tick (host clock), "
            f"stages ms/tick {stages}, launches {counts} | {smi}")
        compare_plain(label, xs_t, kwx, plain_ticks)

    # scrolled: a third of the lanes mid-slide at random scrolls
    K_s = min(3, args.ticks)
    rng = np.random.default_rng(3)
    hs = rng.integers(-352, 353, (K_s, N)).astype(np.int32)
    hs[:, rng.random(N) >= 1 / 3] = 0
    xs_s = {k: v[:K_s] for k, v in xs.items()}
    xs_s["hscroll"] = torch.from_numpy(hs).to(dev)
    slide = tuple(torch.randint(0, 256, (N,) + tuple(fr_k[k].shape[2:]),
                                generator=g, dtype=torch.uint8).to(dev)
                  for k in "yuv")
    kw_s = dict(kw, scrolled=True)
    fr, sb, ds = fresh_state()
    reset_counts()
    CH.run_full_chunk(xs_s, fr, sb, ds, tap_idx, slide, tap=1, **kw_s)
    torch.cuda.synchronize()
    chain_counts["scrolled"] = read_counts("chain scrolled", CHAIN_KERNELS)
    log(f"[chain scrolled] {K_s} ticks, {int((hs != 0).any(0).sum())} of "
        f"{N} lanes mid-slide, launches {chain_counts['scrolled']}")
    compare_plain("scrolled", xs_s, kw_s, K_s, slide=slide)

    # ---- 5, 6. serving: one service behind the local HTTP server -------
    serve_lanes = min(256, args.lanes)
    with http_service() as url:
        # A: faults, snapshot/restore
        serve_counts = serve_phase_a(dev, url, serve_lanes, 16, smi)
        # B: kernel path == plain path at A's lanes
        serve_phase_b(dev, url, serve_lanes)
        # 7. decode-only serving, then kernel path == plain path
        decode_counts = decode_serving(dev, url, serve_lanes, smi)
        decode_parity(dev, url, serve_lanes)

    for k in kernels:
        k["launches"] = serve_counts.get(k["name"],
                                        decode_counts.get(k["name"]))

    # ---- 8. results ------------------------------------------------------
    log(f"[total] {time.perf_counter() - t_start:.1f} s")
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
