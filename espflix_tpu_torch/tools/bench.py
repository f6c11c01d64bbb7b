"""Benchmark: concurrent real-time 352x192 MPEG-1 streams per card.

The port of the JAX package's root bench.py to one CUDA card: the same
flags (but --scatter and --idct, the TPU selector variants), the same
content, the same timing and the same metric line, plus the backend,
the card's name and its power limit.  Realistic ~1.5 Mb/s GOP content
(I+P, half-pel vectors, `--distinct` streams tiled over the lanes, each
lane at a random GOP position) decodes `--pictures` ticks a chunk, and
the line reports how many 30 fps streams one card sustains.

Stages (--stage):
  full (default): decode + both composite fields + 13 SBC frames + PDM
      per lane and tick;
  decode: video decode only.

Routes (--pipeline):
  pallas (auto): full -- runtime/chain.run_full_chunk (K1, K23, K4,
      K6, K5); decode -- ops/vlc_scan.run_scan_bucketed_dense +
      models/mpeg1.dense_compose (K1, K23);
  device: models/mpeg1.decode_picture_impl a picture (K1S, K2F, K3F),
      then for the full stage the output tick (synthesize_field_pair,
      K6, K5);
  hybrid: models/mpeg1.decode_picture_batch_hybrid (the host tokenizer,
      K2F, K3F), decode only (as in JAX).

Timing: the host clock around each chunk, which ends in one
synchronize, after one warm chunk.  A failure raises: no route falls
back to another, and without a card the bench refuses to run unless
--device cpu is given (the plain forms, for tests).  The realtime probe
(--realtime, the full stage on a card) finds the most lanes whose tick
p50 fits 33.3 ms, capped at 8,192 lanes as in JAX.

Prints one JSON line:
  {"metric": ..., "value": ..., "unit": ..., "vs_baseline": ..., ...}

    python -m espflix_tpu_torch.tools.bench [--lanes 1024] [--stage full]
        [--pipeline auto|pallas|device|hybrid] [--scrolled]
        [--no-realtime] [--verbose] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from espflix_tpu_torch.models import mpeg1 as M
from espflix_tpu_torch.models import sbc as dsbc
from espflix_tpu_torch.ops import composite as CO
from espflix_tpu_torch.ops import delta_sigma as DS
from espflix_tpu_torch.ops import vlc_scan as VS
from espflix_tpu_torch.ops.intwrap import wrap32
from espflix_tpu_torch.runtime import chain as CH
from espflix_tpu_torch.runtime.workload import (F_AUDIO, bench_chunk,
                                                bench_pictures)
from espflix_tpu_torch.tools.sbc_encode import random_frame

DEADLINE_S = 1.0 / 30.0       # one display frame
RT_QUANTUM = 32               # probe lanes in steps of 32 ...
RT_FLOOR = 128                # ... from 128 ...
RT_CAP = 8192                 # ... to 8,192 (bench.py:584)
RT_TRIES = 6

# the kernels (or the host tokenizer) each route runs: scan, IDCT,
# prediction + compose (the JAX line's scatter / idct / mocomp keys)
ROUTE_KERNELS = {"pallas": ("K1", "K2", "K3"),
                 "device": ("K1S", "K2F", "K3F"),
                 "hybrid": ("host", "K2F", "K3F")}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--lanes", type=int, default=0,
                    help="lanes (default 1024 on a card, 8 on the CPU)")
    ap.add_argument("--pictures", type=int, default=12)
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--distinct", type=int, default=8,
                    help="distinct content streams tiled across lanes")
    ap.add_argument("--pipeline",
                    choices=["auto", "hybrid", "device", "pallas"],
                    default="auto")
    ap.add_argument("--stage", choices=["full", "decode"], default="full")
    ap.add_argument("--phase", choices=["mixed", "aligned"],
                    default="mixed")
    ap.add_argument("--standard", choices=["ntsc", "pal"], default="ntsc")
    ap.add_argument("--scrolled", action="store_true",
                    help="the full chain's buffer-flip hscroll path")
    ap.add_argument("--realtime", action=argparse.BooleanOptionalAction,
                    default=os.environ.get(
                        "ESPFLIX_BENCH_REALTIME", "1") != "0",
                    help="also find the most lanes whose tick p50 fits "
                    "33.3 ms (full stage, on a card)")
    ap.add_argument("--verbose", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels; the default) or cpu (the "
                    "plain forms, for tests)")
    return ap.parse_args(argv)


def chunk_checksum(outs) -> torch.Tensor:
    """bench.py's checksum of a run_full_chunk(return_planes=False)
    chunk: ysum + field_sum + pdm_sum + err, summed over ticks and lanes
    with int32 wraparound (int32 scalar tensor)."""
    return wrap32(outs["ysum"].sum(dtype=torch.int64)
                  + outs["field_sum"].sum(dtype=torch.int64)
                  + outs["pdm_sum"].sum(dtype=torch.int64)
                  + outs["err"].sum(dtype=torch.int64))


def sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Route:
    """One route at one lane count.  init() -> state; chunk(state) ->
    (state, chk), the GOP's ticks with chk an int32 scalar tensor (the
    route's checksum, summed over its ticks); warm(state) -> state runs
    before timing (one chunk, or the hybrid's one picture), after which
    the state restarts unless `restart` is False."""

    def __init__(self, init, chunk, n_pictures: int, device, warm=None,
                 restart: bool = True):
        self.init, self.chunk, self.n_pictures = init, chunk, n_pictures
        self.device = device
        self.warm = warm or (lambda st: self.chunk(st)[0])
        self.restart = restart

    def run(self, reps: int):
        """(pictures decoded, chunk seconds, chunk checksums)."""
        state = self.warm(self.init())
        sync(self.device)
        if self.restart:
            state = self.init()
        ts, chks = [], []
        for _ in range(reps):
            t0 = time.perf_counter()
            state, chk = self.chunk(state)
            sync(self.device)
            ts.append(time.perf_counter() - t0)
            chks.append(int(chk))
        return reps * self.n_pictures, ts, chks


def chain_chunk(xs, frames, sbc_state, ds_state, slide, kw):
    """One full-chain chunk (runtime/chain.run_full_chunk, no taps, no
    planes back): (frames, sbc_state, ds_state, checksum)."""
    tap_idx = torch.zeros(1, dtype=torch.int32, device=frames["y"].device)
    frames, sbc_state, ds_state, outs = CH.run_full_chunk(
        xs, frames, sbc_state, ds_state, tap_idx, slide, tap=0,
        return_planes=False, **kw)
    return frames, sbc_state, ds_state, chunk_checksum(outs)


def build_chain(args, lanes: int, device) -> Route:
    """--stage full, pallas: the chain the Fleet serves with, over
    bench_chunk's inputs (bench.py:268-376)."""
    xs_np, kw, slide = bench_chunk(
        lanes, n_pictures=args.pictures, distinct=args.distinct,
        phase=args.phase, pal=args.standard == "pal",
        scrolled=args.scrolled)
    xs = CH.xs_to_torch(xs_np, device)
    if slide is not None:
        slide = tuple(torch.from_numpy(p).to(device) for p in slide)
    mbw, mbh = kw["mb_width"], kw["mb_height"]

    def init():
        return (M.init_frame_state(lanes, mbw * 16, mbh * 16, device),
                dsbc.init_state(lanes, device), DS.init_state(lanes, device))

    def chunk(state):
        *state, chk = chain_chunk(xs, *state, slide, kw)
        return tuple(state), chk
    return Route(init, chunk, args.pictures, device)


def build_decode(args, lanes: int, device) -> Route:
    """--stage decode, pallas: per tick the slice scan into dense
    buffers and the dense phase (bench.py:378-471, --scatter matmul);
    the checksum is y + the lanes' error flags, summed over ticks."""
    xs_np, kw, _ = bench_chunk(lanes, n_pictures=args.pictures,
                               distinct=args.distinct, phase=args.phase)
    xs = CH.xs_to_torch({k: xs_np[k] for k in CH.DECODE_KEYS}, device)
    tables = M.decode_tables(device)
    mbw, mbh = kw["mb_width"], kw["mb_height"]
    scan_kw = {k: kw[k] for k in ("mb_width", "mb_height", "n_lanes",
                                  "long_rows", "steps_long", "steps_short",
                                  "chunk")}

    def init():
        return M.init_frame_state(lanes, mbw * 16, mbh * 16, device)

    def chunk(frames):
        chk = torch.zeros((), dtype=torch.int64, device=device)
        for k in range(args.pictures):
            x = {key: v[k] for key, v in xs.items()}
            coeffs_T, recs, nfinal, err, _it = VS.run_scan_bucketed_dense(
                *[x[key] for key in CH.DECODE_KEYS[:9]], **scan_kw,
                lut=tables["lut"], zigzag=tables["zigzag"])
            frames, p = M.dense_compose(
                coeffs_T, recs, nfinal, x["intra_q"], x["non_intra_q"],
                x["active"], frames, mb_width=mbw, mb_height=mbh,
                scale_dct=tables["scale_dct"])
            chk = chk + p["y"].sum(dtype=torch.int64) + err.sum()
        return frames, wrap32(chk)
    return Route(init, chunk, args.pictures, device)


def output_inputs(lanes: int, device) -> dict:
    """The device route's per-lane output state (bench.py:157-185): 13
    SBC frames, OSD, blend, progress and field parity, fixed over the
    ticks."""
    arng = np.random.default_rng(17)
    frames_a = np.stack(
        [np.frombuffer(random_frame(arng, mode=0, bitpool=28), np.uint8)
         for _ in range(F_AUDIO)])
    words = dsbc.frames_to_words(np.ascontiguousarray(
        np.broadcast_to(frames_a, (lanes, F_AUDIO, 64)))).view(np.int32)
    orng = np.random.default_rng(23)
    out = dict(
        aud_words=words,
        osd=orng.integers(0, 256, (lanes, 16, 80), dtype=np.uint8),
        blend=orng.integers(0, 256, lanes, dtype=np.int32),
        progress=orng.integers(0, 352, lanes, dtype=np.int32),
        parity=orng.integers(0, 2, lanes, dtype=np.int32))
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in out.items()}


def output_tick(p, o: dict, sbc_state, ds_state, pal: bool):
    """Both composite fields, 13 SBC frames and their PDM for every lane
    (bench.py:187-200): (sbc_state, ds_state, checksum int64)."""
    ff = CO.synthesize_field_pair(p["y"], p["u"], p["v"], o["parity"],
                                  o["osd"], o["blend"], o["progress"],
                                  pal=pal)
    pcm, sbc_state, _err, _ = dsbc.decode_frames_batched(
        o["aud_words"], sbc_state, n_frames=F_AUDIO)
    pdm, ds_state = DS.modulate(pcm, ds_state, n_samples=F_AUDIO * 128)
    return sbc_state, ds_state, \
        ff.sum(dtype=torch.int64) + pdm.sum(dtype=torch.int64)


def build_device(args, lanes: int, device) -> Route:
    """The device parser a picture (bench.py:205-266): the sequential
    scan and the lane-minor dense phase, then the output tick when the
    stage is full; the checksum is y + the error flags (+ the output
    tick's fields and PDM words), summed over ticks."""
    ticks, wpl = bench_pictures(lanes, n_pictures=args.pictures,
                                distinct=args.distinct, phase=args.phase)
    mbw, mbh = ticks[0][0].seq.mb_width, ticks[0][0].seq.mb_height
    bats = [M.xs_to_torch({k: v for k, v in M.make_picture_batch(
        sel, words_per_lane=wpl, max_slices=mbh).items()
        if k in M.PICTURE_KEYS}, device) for sel in ticks]
    tables = M.decode_tables(device)
    full = args.stage == "full"
    out = output_inputs(lanes, device) if full else None
    pal = args.standard == "pal"

    def init():
        return (M.init_frame_state(lanes, mbw * 16, mbh * 16, device),
                dsbc.init_state(lanes, device) if full else None,
                DS.init_state(lanes, device) if full else None)

    def chunk(state):
        frames, sbc_state, ds_state = state
        chk = torch.zeros((), dtype=torch.int64, device=device)
        for b in bats:
            frames, p, info = M.decode_picture_impl(
                *[b[k] for k in M.PICTURE_KEYS], frames, mb_width=mbw,
                mb_height=mbh, max_steps=min(wpl * 32, 12000),
                tables=tables)
            chk = chk + p["y"].sum(dtype=torch.int64) + info["error"].sum()
            if full:
                sbc_state, ds_state, ochk = output_tick(
                    p, out, sbc_state, ds_state, pal)
                chk = chk + ochk
        return (frames, sbc_state, ds_state), wrap32(chk)
    return Route(init, chunk, args.pictures, device)


def build_hybrid(args, lanes: int, device) -> Route:
    """The native tokenizer on the host feeding the lane-minor dense
    phase (bench.py:473-496), decode only; one warm picture, then the
    chunks continue from its frames.  The checksum is y + the error
    flags, summed over ticks."""
    ticks, _wpl = bench_pictures(lanes, n_pictures=args.pictures,
                                 distinct=args.distinct, phase=args.phase)
    mbw, mbh = ticks[0][0].seq.mb_width, ticks[0][0].seq.mb_height
    iqs = [np.stack([p.seq.intra_q for p in sel]).astype(np.int32)
           for sel in ticks]
    nqs = [np.stack([p.seq.non_intra_q for p in sel]).astype(np.int32)
           for sel in ticks]
    tables = M.decode_tables(device)

    def init():
        return M.init_frame_state(lanes, mbw * 16, mbh * 16, device)

    def decode(frames, k):
        return M.decode_picture_batch_hybrid(
            ticks[k], iqs[k], nqs[k], frames, mb_width=mbw, mb_height=mbh,
            tables=tables)

    def chunk(frames):
        chk = torch.zeros((), dtype=torch.int64, device=device)
        for k in range(len(ticks)):
            frames, p, info = decode(frames, k)
            chk = chk + p["y"].sum(dtype=torch.int64) + info["error"].sum()
        return frames, wrap32(chk)
    return Route(init, chunk, args.pictures, device,
                 warm=lambda frames: decode(frames, 0)[0], restart=False)


def make_builders(args, lanes: int, device) -> dict:
    """Route name -> fn() -> Route at `lanes` (the realtime probe builds
    them again at other lane counts)."""
    pallas = build_chain if args.stage == "full" else build_decode
    return dict(pallas=lambda: pallas(args, lanes, device),
                device=lambda: build_device(args, lanes, device),
                hybrid=lambda: build_hybrid(args, lanes, device))


def realtime_probe(tick_times, lanes: int, tick1: float,
                   measured: list, reps: int, log=lambda *a: None):
    """The deadline-true operating point (bench.py:559-610): the most
    lanes whose tick p50 fits DEADLINE_S.  tick_times(n, reps) -> the
    seconds a tick of each of `reps` chunks at n lanes; tick1 the
    headline's seconds a tick at `lanes`, measured its per-chunk tick
    times.  Fits tick(N) = a + b*N through tick1 and a run at half the
    lanes, tries the predicted N (a 32-lane quantum, 128 to 8,192), and
    refits on each measured point to jump down, six tries at most.
    Returns (realtime_lanes, tick_p50_ms, tick_p99_ms) as the JSON keys
    and `capped`: the model's lanes exceeded the 8,192 cap and the cap
    passed, so realtime_lanes is a lower bound."""
    n2 = max(RT_FLOOR, (lanes // 2) // RT_FLOOR * RT_FLOOR)
    tick2 = min(tick_times(n2, 2))
    b = (tick1 - tick2) / max(lanes - n2, 1)
    a = tick1 - b * lanes
    model = int((DEADLINE_S - a) / b) if b > 0 else lanes
    cand = min(max(model // RT_QUANTUM * RT_QUANTUM, RT_FLOOR), RT_CAP)
    rt_lanes, p50, p99 = None, None, None
    for _try in range(RT_TRIES):
        tcks = sorted(measured if cand == lanes
                      else tick_times(cand, max(reps, 8)))
        q50 = tcks[len(tcks) // 2]
        q99 = tcks[min(len(tcks) - 1, int(len(tcks) * 0.99))]
        log(f"realtime probe N={cand}: p50 {q50 * 1000:.1f}ms "
            f"p99 {q99 * 1000:.1f}ms")
        if q50 <= DEADLINE_S or cand <= RT_FLOOR:
            rt_lanes, p50, p99 = cand, q50, q99
            break
        # refit on the measured point and jump to the new candidate
        nxt = int((DEADLINE_S - (q50 - b * cand)) / b) if b > 0 \
            else cand - RT_QUANTUM
        cand = max(min(nxt // RT_QUANTUM * RT_QUANTUM, cand - RT_QUANTUM),
                   RT_FLOOR)
    capped = rt_lanes == RT_CAP and model > RT_CAP
    if capped:
        log(f"realtime_lanes is a lower bound: the linear model "
            f"(a={a * 1e3:.3f} ms, b={b * 1e6:.3f} us/lane) predicts "
            f"{model} lanes, above the {RT_CAP} cap")
    return {"realtime_lanes": rt_lanes,
            "tick_p50_ms": round(p50 * 1000, 2) if p50 else None,
            "tick_p99_ms": round(p99 * 1000, 2) if p99 else None}, capped


def card_facts(device: torch.device):
    """(name, power limit in W) of the card, as nvidia-smi reports them
    (torch's name when nvidia-smi is absent); ("cpu", None) on the
    CPU."""
    if device.type != "cuda":
        return "cpu", None
    idx = device.index if device.index is not None else \
        torch.cuda.current_device()
    try:
        r = subprocess.run(
            ["nvidia-smi", f"--id={idx}", "--query-gpu=name,power.limit",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=60, check=True)
        name, limit = (f.strip() for f in
                       r.stdout.strip().splitlines()[0].split(","))
        return name, float(limit)
    except (OSError, subprocess.SubprocessError, ValueError):
        return torch.cuda.get_device_name(device), None


def main(argv=None):
    args = parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("bench: no CUDA device (pass --device cpu for "
                             "the plain forms)")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(device)
    lanes = args.lanes or (1024 if device.type == "cuda" else 8)

    def log(*a):
        if args.verbose:
            print(*a, file=sys.stderr, flush=True)

    pipeline = "pallas" if args.pipeline == "auto" else args.pipeline
    log(f"device={device} lanes={lanes} pipeline={pipeline} "
        f"stage={args.stage}")
    t0 = time.perf_counter()
    route = make_builders(args, lanes, device)[pipeline]()
    log(f"inputs built in {time.perf_counter() - t0:.1f} s")
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    n, ts, chks = route.run(args.reps)
    dt = sum(ts)
    streams_per_card = lanes * n / dt / 30.0
    per_chunk = [lanes * (n / len(ts)) / t / 30.0 for t in ts]
    value_std = float(np.std(per_chunk)) if len(ts) > 1 else 0.0
    log(f"{n} pictures x {lanes} lanes in {dt:.2f}s -> "
        f"{lanes * n / dt:.0f} fps, {streams_per_card:.1f} rt streams/card "
        f"(stage={args.stage} phase={args.phase}); chunk checksums {chks}")
    if device.type == "cuda":
        peak = torch.cuda.max_memory_allocated(device)
        print(f"bench: peak device memory {peak / 2**30:.2f} GiB at "
              f"{lanes} lanes ({peak / lanes / 2**20:.2f} MiB a lane; "
              f"{RT_CAP} lanes would take ~{peak / lanes * RT_CAP / 2**30:.1f}"
              f" GiB)", file=sys.stderr, flush=True)
    del route

    realtime = {}
    if args.realtime and args.stage == "full" and device.type == "cuda":
        k = args.pictures

        def tick_times(n_lanes, reps):
            route = make_builders(args, n_lanes, device)[pipeline]()
            return [t / k for t in route.run(reps)[1]]
        realtime, _capped = realtime_probe(
            tick_times, lanes, dt / n, [t / k for t in ts], args.reps, log)

    name, limit = card_facts(device)
    scatter, idct, mocomp = ROUTE_KERNELS[pipeline]
    print(json.dumps({
        "metric": "realtime_352x192_mpeg1_streams_per_chip",
        "value": round(streams_per_card, 2),
        "unit": "30fps streams/chip",
        "vs_baseline": round(streams_per_card / 1.0, 2),
        "value_std": round(value_std, 2),
        "lanes": lanes,
        "tick_ms": round(dt / n * 1000, 2),
        "stage": args.stage,
        "phase": args.phase,
        "standard": args.standard,
        "pipeline": pipeline,
        "scatter": scatter,
        "mocomp": mocomp,
        "idct": idct,
        "fallback_reason": None,
        **realtime,
        "backend": device.type,
        "device": name,
        "power_limit_w": limit,
    }), flush=True)


if __name__ == "__main__":
    main()
