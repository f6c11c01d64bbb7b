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
   prints the registers, local (stack) bytes and static shared bytes
   (cudaFuncGetAttributes) of each scan kernel, of K3 / K3F
   (compose_put_kernel<false / true>), of K23 at each copy width
   (idct_compose_put_kernel<V>), of K2 at each vector width
   (idct_T_kernel<V>), of K2F (idct_flat_kernel), of K3P
   (predict_kernel<S, rule>), of K4 (composite_parts_kernel) and of K6
   (sbc_kernel<CH>); the native library (native/: the TS demuxer and the
   session feed; the run fails without it) and the hybrid parser's
   tokenizer (oracle/*.cpp with the port's vlc_luts.h, g++, into
   build/oracle-<hash>/);
3. kernels: each of the twelve entry points -- K1-K5, the lane-minor
   K1F, K2F, K3F, the predict-only K3P (rule A over whole planes, rule
   B over a band), the sequential scan K1S, the SBC decode K6 and K23,
   the main path's K2 + K3 in one pass --
   against its plain PyTorch version on the card at the main path's
   shapes (the bench tick's 1,024 lanes at 352x192 and 13 SBC frames a
   lane; K6 also on varied mono and stereo audio: random bitpools
   padded to one length, error frames, bitpool 250, n_valid 0 and
   partial, idle lanes, a random carried history, two calls), exact
   equality, CUDA-event medians,
   the call's latency (`ms`) and the device's time alone
   (`device_ms`), the plain form's time on its checked run (`plain_ms`),
   and the bound of its work (for the scans the larger
   of bytes and the longest row's or slice's FSM chain; for K2, K2F, K3
   and K3F the bytes the tick's data needs -- their MB kinds, coded
   blocks and active lanes; for K23 the same less the residuals --
   and for K3P the reference windows its MBs
   read, with the bytes of every input and output beside it as
   `yardstick_ms`); K1S's two
   passes alone (the second's resolution against its plain form,
   resolve_slices) and a second K1S call with corrupt slices, idle
   lanes and a budget that cuts lanes inside a later slice, which
   reports the lanes of its in-order pass; K5's cycles a bit step;
   K23 checked against K2 then K3 on the card on both ticks' levels
   and timed beside them (`split_ms`, `split_device_ms`);
   K2, K2F, K3, K3F and K23 also checked and timed on the tick with the
   fewest I pictures (`<key>_p`), and checked on the tests' shared edge
   case (espflix_tpu_torch/tools/dense_cases.py, 256 lanes: vectors at
   and past every edge in every half-pel phase, all MB kinds, int16
   extremes); K4 also on the tests' composite edge case
   (espflix_tpu_torch/tools/composite_cases.py, every blend class,
   progress at the bar's ends, luma across the dither mask, every
   chroma value) at the chain's lanes and three fewer, NTSC and PAL;
   K3P also on the tests' K3P edge case
   (espflix_tpu_torch/tools/predict_cases.py: windows at and one past
   every edge, every half-pel phase, rule B across each edge) at three
   lanes fewer, rule A over whole planes and rule B on bands at the
   first, a middle and the last MB row and over the whole plane;
4. the chain: run_full_chunk over the bench workload
   (bench.py --stage full inputs), once with host row windows (win=0)
   and once with device windows (win>0), then a scrolled run (a third
   of the lanes mid-slide): no lane errors, every kernel's launch
   counter rose during each run (K23's, and neither K2's nor K3's),
   and every out and carry equal to the
   same ticks run through the plain forms on the card;
4o. the per-field output path: runtime/output.OutputStage.synthesize
   on phase 4's presented planes (1,024 lanes), 6 fields through the
   kernels and 6 through the plain forms in lockstep from the same
   state, NTSC and PAL -- OSD on a third of the lanes (every blend
   class, a fade that runs out, progress at the bar's ends), a quarter
   of the lanes sliding from the last planes (start_slide(prev=None))
   after field 1, half from each side -- then OutputStage.modulate, 3
   calls of 256 samples and one of 333, beeps and starved lanes: every
   field, PDM word and carry equal, K4 and K5 launched; ms a field and
   a call (CUDA events and host clock);
O. the validation path against the C oracle (tools/oracle.py), at the
   chain's lanes and 352x192: models/mpeg1.decode_es_batched over the
   lanes tiled from 8 realistic_gop_script streams of 6-12 pictures
   (shorter lanes starve), sequential (K1S's two passes, K2F, K3F) and
   slice_parallel=True (K1S's per-slice pass alone: one K1S launch a
   picture), every lane's frames equal to oracle.decode_mpeg1, the 8
   streams slice-parallel through the plain forms equal too; the
   per-slice pass against scan_slices_torch on the run's pictures 0 (I)
   and 1 (P) and timed against K1S's two passes; ms a picture (host
   clock) and the device's share (CUDA-event spans of each picture's
   decode_picture_impl); ops/composite.synthesize_field_pair and
   synthesize_field_scrolled (K4 + field_canvas) on the decoded planes,
   NTSC and PAL, OSD on every lane: equal to the plain forms on every
   lane and to oracle.composite_field on 64 lanes (blend -1, 0, a fade,
   full at both parities), ms of the pair, its canvas alone and a
   scrolled field; models/sbc.decode_stream_batched (K6) on mono frame
   lists of 8-15 frames equal to SbcOracle on every lane, and
   ops/delta_sigma.modulate_spec (K5), two calls of 256 samples with the
   state carried, equal to oracle.pdm_modulate on every lane;
B. the port's bench (espflix_tpu_torch/tools/bench.py): each route in
   process at 16 lanes x 2 pictures -- pallas full (the chain), the
   same scrolled, pallas decode (K1, K23), device full (K1S, K2F, K3F,
   then K4, K6, K5) and hybrid decode (the host tokenizer, K2F, K3F) --
   one chunk on the card with every kernel of the route launched and its
   checksum equal to the same builder's chunk through the plain forms
   on the CPU; then `python -m espflix_tpu_torch.tools.bench` in
   subprocesses: the defaults (1,024 lanes, full, NTSC, mixed, pallas,
   2 reps, the realtime probe), --scrolled, --pipeline device and
   --pipeline hybrid --stage decode (the last three without the
   probe), each exiting 0 with backend cuda and the route asked for;
   their metric lines and stderr (the probe's candidates, the peak
   device memory) are printed;
S. the port's stage timer (espflix_tpu_torch/tools/perf_stages.py):
   every stage once at 64 lanes on the card (K2, K23, K3F, K3P, K4, K5
   and K6 launched) equal to the same stage through the plain forms on
   the card; then `python -m espflix_tpu_torch.tools.perf_stages
   --lanes 1024 --iters 8 --reps 3 --json` over every stage, its times
   printed a stage a line;
5. serving A: serve_scenario's full stage over the local HTTP Range
   server (min(256, --lanes) lanes, 16 ticks in chunks of 4, 2 titles
   of 4 GOPs, two injected faults, a snapshot at tick 8 restored into a
   second fleet that runs 4 ticks): every lane decodes, the faults are
   contained and resynced, every kernel launched, the taps match their
   checksums, the host split (gather_packed, gather, batch_assemble,
   device chain, untimed) per tick.  Every serving fleet of phases 5-8
   runs its sessions on the native session feed (fleet-wide batched
   and packed pops); a session on the Python feed fails the run;
6. serving B: the same lanes, service and HTTP server, 8 ticks, once
   with the kernels and once through the plain forms: every TickResult
   and carry identical;
5p. pooled serving: Fleet.run_chunk_full_pooled with W = min(8,
   cores) host worker processes (runtime/hostpool.py) against
   in-process run_chunk_full at serving A's lanes over the same HTTP
   service, 8 ticks in chunks of 4 after a warm-up chunk: flags, pts,
   checksums, taps and audio flags equal; then the pool alone at 4x
   the lanes (1,024) over file:// for 16 ticks, timed (ms/tick wall,
   the fleet's timers, the untimed rest); while each pool runs,
   nvidia-smi lists no worker and at most one context, and every worker
   reports CUDA_VISIBLE_DEVICES="" and no torch import; the workers'
   start time and peak RSS, and what a worker importing torch would
   cost, are printed;
5e. egress: serve_scenario's full stage with --egress 16
   --egress-depth 16 at serving A's lanes over the same service, 16
   ticks: every full tick pushed, consumed + dropped == pushed with no
   drop, the delivered field bytes of the tap geometry, and the pump's
   checksum equal to the taps' field_sum + pdm_sum (mod 2^31) of the
   same run's TickResults; the line rate against 16 lanes x 14.32 MB/s
   and the underruns are printed;
7. decode-only serving: serve_scenario --stage decode over the same
   HTTP service at the same lanes, 16 ticks pipelined (tick_submit /
   tick_collect) and 16 chunked (run_chunk, K = 4), two injected faults
   each: every lane decodes, the faults are resynced, and K1, K23,
   K1F, K2F, K3F and K6 all launched; then 4 ticks per dispatch, and 4 of
   a one-lane fleet (the small-fleet branch), through the kernels and
   through the plain forms: every TickResult field and carry identical;
   then the hybrid parser (the native tokenizer on the host, K2F and
   K3F on the card) against the device parser at the same lanes, 8
   ticks pipelined without faults: YUV planes, flags and pts equal,
   each with its ms/tick;
8. the mesh: a 4-shard 'streams' mesh (one card per shard when four
   are visible, else cuda:0 four times) over the same HTTP service and
   lanes -- the pallas parser (K1, K2, K3P per shard) and the device
   parser (K1S per shard), 8 ticks pipelined and 8 in chunks of 4,
   each equal in every TickResult field to the unsharded fleet; then
   3 ticks a parser in which every K3P call, and K1S's first call and
   each one with a lane in error, is held against its plain form on
   the call's own inputs (a shard's lanes, the serving word window);
   run_chunk_full under the mesh (8 ticks in chunks of 4, one tap
   lane) equal to the unsharded full fleet; the 'space' split
   (make_space_sharded_dense, a 2 x 2 mesh: K2F and K3P rule B) equal
   to the unsharded band form through the plain forms on a P picture,
   with the share of its MBs whose rule-B taps cross an edge (K3P's
   byte path); K3P and K1S launched;
8r. the geometry router: a one-lane 352x192 fleet playing a 352x240
   title parks it (LANE_GEOMETRY), FleetRouter.route() re-homes it, and
   the re-homed fleet decodes 6 ticks (K1F, K2F, K3F at mb_height 15)
   with at least 3 frames, no error, and planes, pts and flags equal to
   the same ticks through the plain forms; then python -m
   espflix_tpu_torch.tools.play --field on the card for 8 frames into
   a temporary directory: 8 y/u/v/field PGM files each;
9. the total seconds, the card's name and power limit, one JSON line
   with the kernels' numbers (launches: serving A's for K1, K23 and
   K4-K6, the mesh phase's for K2, none for K3, the
   decode-only serving's for K1F-K3F, the mesh phase's for K3P and
   K1S; phase O's launches and times under "phase_o" of K1S, K2F, K3F,
   K4, K5 and K6), and the final {"ok": true, ...} line.

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
# and the plain scan take ~12-16 s a tick at 1,024 lanes
PLAIN_TICKS = 3
# an H100 SXM's HBM3 rate (NVIDIA's data sheet), for the bytes bound
HBM_BPS = 3.35e12
# latency of one dependent 32-bit integer operation, in SM clock
# cycles (an assumption of the K5 and scan bounds; see PERF.md)
INT_DEP_CYCLES = 4
# 32-bit integer operations an SM issues a clock (an H100 SM's four
# partitions of 16 INT32 lanes), for K6's operations bound
INT32_OPS_PER_SM_CLOCK = 64
# K6's operations a valid (frame, channel), a lower bound: the
# filterbank's multiply-adds (V: 16 blocks x 16 x 8; synthesis: 128
# samples x 10 taps) and 8 a field for the unpack (128 fields); the
# allocation loop and IQUANT's divisions are not counted
SBC_OPS_PER_FRAME_CH = 16 * 16 * 8 + 128 * 10 + 128 * 8
# one step of the scan kernels' FSM chain: a shared-memory table load
# (SMEM_LOAD_CYCLES, an assumption) and about ten dependent integer ops
SMEM_LOAD_CYCLES = 30
SCAN_STEP_CYCLES = SMEM_LOAD_CYCLES + 10 * INT_DEP_CYCLES
# SM clock cycles the card sleeps before a timed run (~10 ms at 1,980
# MHz, longer than any wrapper's host work)
BUSY_CYCLES = 20_000_000


def log(*a):
    print(*a, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int, busy: bool = False):
    """Median CUDA-event time of fn() over reps runs, after one warm
    run: the call's latency, the host's enqueue included.  busy: the
    card sleeps (torch.cuda._sleep, BUSY_CYCLES) while the host enqueues
    each run, so the events bracket the device's work alone (it differs
    where the host's part is the longer one)."""
    import torch
    fn()
    ts = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        if busy:
            torch.cuda._sleep(BUSY_CYCLES)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        ts.append(a.elapsed_time(b))
    return statistics.median(ts)


def timed(fn, reps: int) -> dict:
    """A kernel entry's times of fn(): ms, the call's latency, and
    device_ms, the device's work alone (time_ms)."""
    return dict(ms=time_ms(fn, reps), device_ms=time_ms(fn, reps, busy=True))


def run_timed(fn):
    """fn() once: its result and its CUDA-event time in ms.  For the
    plain forms that take seconds, whose one run is both the check and
    the time."""
    import torch
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    out = fn()
    b.record()
    torch.cuda.synchronize()
    return out, a.elapsed_time(b)


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
    """Route the kernel wrappers to their plain PyTorch versions (for
    the on-card comparison runs)."""
    from espflix_tpu_torch.models import sbc as dsbc
    from espflix_tpu_torch.ops import composite as CO
    from espflix_tpu_torch.ops import delta_sigma as DS
    from espflix_tpu_torch.ops import idct as IDCT
    from espflix_tpu_torch.ops import mocomp as MC
    from espflix_tpu_torch.ops import vlc_scan as VS
    swaps = [(VS, "run_scan_bucketed_dense",
              VS.run_scan_bucketed_dense_torch),
             (IDCT, "block_residuals_T", IDCT.block_residuals_T_torch),
             (MC, "predict_compose_put", MC.predict_compose_put_torch),
             (MC, "idct_compose_put", MC.idct_compose_put_torch),
             (CO, "synthesize_field_pair_parts",
              CO.synthesize_field_pair_parts_torch),
             (DS, "modulate", DS.modulate_torch),
             (VS, "run_scan_bucketed", VS.run_scan_bucketed_torch),
             (IDCT, "block_residuals_flat", IDCT.block_residuals_flat_torch),
             (MC, "predict_compose_put_flat",
              MC.predict_compose_put_flat_torch),
             (MC, "predict_plane_rows", MC.predict_plane_rows_torch),
             (MC, "predict_plane", MC.predict_plane_torch),
             (MC, "predict_chroma_pair", MC.predict_chroma_pair_torch),
             (dsbc, "decode_frames_batched",
              dsbc.decode_frames_batched_torch),
             (VS, "run_scan", VS.run_scan_torch),
             (VS, "scan_slices_cuda", VS.scan_slices_torch)]
    saved = [(m, n, getattr(m, n)) for m, n, _ in swaps]
    try:
        for m, n, f in swaps:
            setattr(m, n, f)
        yield
    finally:
        for m, n, f in saved:
            setattr(m, n, f)


@contextlib.contextmanager
def checked_calls(seen: dict):
    """Hold the path's own calls of K3P (every one) and K1S (the first,
    and each one with a lane in error) against their plain forms on the
    same inputs.  The kernel launch is the path's; the plain forms
    launch none.  seen[name] counts the calls, the checked calls and the
    checked calls with a lane in error."""
    from espflix_tpu_torch.ops import mocomp as MC
    from espflix_tpu_torch.ops import vlc_scan as VS
    swaps = [(MC, "predict_plane", MC.predict_plane_torch, "K3P_predict"),
             (MC, "predict_chroma_pair", MC.predict_chroma_pair_torch,
              "K3P_predict"),
             (MC, "predict_plane_rows", MC.predict_plane_rows_torch,
              "K3P_predict"),
             (VS, "run_scan", VS.run_scan_torch, "K1S_slice_scan_seq")]

    def checked(kernel, plain, name):
        def call(*a, **kw):
            out = kernel(*a, **kw)
            s = seen.setdefault(name, dict(calls=0, checked=0, errored=0))
            s["calls"] += 1
            bad = name == "K1S_slice_scan_seq" and bool(out[3].any())
            if name == "K3P_predict" or not s["checked"] or bad:
                ref = plain(*a, **kw)
                pairs = list(zip(out, ref)) if isinstance(out, tuple) \
                    else [(out, ref)]
                require_equal(f"{name}, mesh path call {s['calls']}", pairs)
                s["checked"] += 1
                s["errored"] += bad
            return out
        return call

    saved = [(m, n, getattr(m, n)) for m, n, _, _ in swaps]
    try:
        for m, n, plain, name in swaps:
            setattr(m, n, checked(getattr(m, n), plain, name))
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


def build_native_fleet(*a, **kw):
    """serve_scenario.build_fleet, raising unless every session it
    attached feeds through the native session feed (a broken or missing
    native library fails the run instead of serving on the Python
    feed)."""
    from espflix_tpu_torch.tools import serve_scenario as SS
    fleet = SS.build_fleet(*a, **kw)
    require_native_feeds("build_fleet", fleet)
    return fleet


def require_native_feeds(label, fleet):
    from espflix_tpu_torch.streaming import native_feed as NF
    bad = [i for i, s in enumerate(fleet.sessions)
           if s is not None and not isinstance(s.feed, NF.NativeStreamFeed)]
    if bad:
        raise AssertionError(f"{label}: lanes {bad[:8]} feed through "
                             f"{type(fleet.sessions[bad[0]].feed).__name__}, "
                             "not the native session feed")


def kernel_counters() -> dict:
    """Kernel name -> (wrapper module, its launch-count attribute)."""
    from espflix_tpu_torch.models import sbc as dsbc
    from espflix_tpu_torch.ops import composite as CO
    from espflix_tpu_torch.ops import delta_sigma as DS
    from espflix_tpu_torch.ops import idct as IDCT
    from espflix_tpu_torch.ops import mocomp as MC
    from espflix_tpu_torch.ops import vlc_scan as VS
    return {"K1_slice_scan_dense": (VS, "launches"),
            "K2_dequant_idct": (IDCT, "launches"),
            "K3_predict_compose_put": (MC, "launches"),
            "K23_idct_compose_put": (MC, "launches_fused"),
            "K4_composite_field_pair": (CO, "launches"),
            "K5_pdm": (DS, "launches"),
            "K1F_slice_scan_flat": (VS, "launches_flat"),
            "K2F_dequant_idct_flat": (IDCT, "launches_flat"),
            "K3F_predict_compose_put_flat": (MC, "launches_flat"),
            "K3P_predict": (MC, "launches_predict"),
            "K1S_slice_scan_seq": (VS, "launches_seq"),
            "K6_sbc_decode": (dsbc, "launches")}


CHAIN_KERNELS = ("K1_slice_scan_dense", "K23_idct_compose_put",
                 "K4_composite_field_pair", "K6_sbc_decode", "K5_pdm")
# the pair K23 replaces on the chain and the coeffs_T decode: K2 runs on
# the mesh's pallas parser, K3 only in phase 3's checks
SPLIT_KERNELS = ("K2_dequant_idct", "K3_predict_compose_put")
FLAT_KERNELS = ("K1F_slice_scan_flat", "K2F_dequant_idct_flat",
                "K3F_predict_compose_put_flat")
DECODE_KERNELS = ("K1_slice_scan_dense", "K23_idct_compose_put") + \
    FLAT_KERNELS + (
                      "K6_sbc_decode",)
MESH_PALLAS_KERNELS = ("K1_slice_scan_dense", "K2_dequant_idct",
                       "K3P_predict")
MESH_DEVICE_KERNELS = ("K1S_slice_scan_seq", "K2F_dequant_idct_flat",
                       "K3F_predict_compose_put_flat")


def reset_counts():
    for m, attr in kernel_counters().values():
        setattr(m, attr, 0)


def require_unlaunched(label, names):
    """Raise if any of `names` launched since reset_counts()."""
    counters = kernel_counters()
    ran = {n: getattr(*counters[n]) for n in names}
    if any(ran.values()):
        raise AssertionError(f"{label}: {ran} launched")


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


def ref_window_bytes(mvx, mvy, pred, S: int, W: int, H: int) -> int:
    """The reference bytes of one plane that the predicted MBs `pred`
    (bool[N, mbh, mbw]) read under rule A, each byte once: the union of
    their windows -- origin clip(xh >> 1, 0, W - S), S + 1 taps along a
    half-pel axis, taps past the plane read 0 -- counted on a 2-D
    difference array per lane."""
    import torch
    n, r, c = pred.nonzero(as_tuple=True)
    xh = c * 2 * S + mvx[n, r, c]
    yh = r * 2 * S + mvy[n, r, c]
    x0 = (xh >> 1).clamp(0, W - S)
    y0 = (yh >> 1).clamp(0, H - S)
    x1 = (x0 + S + (xh & 1)).clamp(max=W)
    y1 = (y0 + S + (yh & 1)).clamp(max=H)
    diff = torch.zeros(pred.shape[0], H + 1, W + 1, dtype=torch.int32,
                       device=pred.device)
    one = torch.ones_like(n, dtype=torch.int32)
    for ys, xs, sign in ((y0, x0, 1), (y0, x1, -1), (y1, x0, -1),
                         (y1, x1, 1)):
        diff.index_put_((n, ys, xs), sign * one, accumulate=True)
    cover = diff.cumsum(1, dtype=torch.int32).cumsum(2, dtype=torch.int32)
    return int((cover > 0).sum())


def compose_needed_bytes(recs, active, mbw: int, mbh: int) -> int:
    """K3 / K3F: the bytes this tick's data needs (the yardstick
    compose_bytes counts every input and output whole).  A STALE MB, and
    every MB of an inactive lane, reads cur and writes the presented
    plane; an INTRA MB reads its residuals (2 B a pixel) and writes cur
    and the presented plane; a predicted one (SKIP, INTER) also reads
    its reference window, each reference byte counted once.  Plus the
    records of the active lanes, the flags and the parities."""
    import torch
    from espflix_tpu_torch.ops import vlc_scan as VS

    N, px = recs.shape[0], 384                 # pixels an MB, y + u + v
    live = active.bool()[:, None]
    kind = torch.where(live, recs & 3, VS.MB_STALE)
    stale = int((kind == VS.MB_STALE).sum())
    pred = (kind == VS.MB_SKIP) | (kind == VS.MB_INTER)
    coded = kind.numel() - stale
    moved = (stale * 2 * px + coded * 4 * px + int(live.sum()) * mbw * mbh
             * 4 + N * (active.element_size() + 4))
    pred = pred.view(N, mbh, mbw)
    mvx = ((((recs >> 7) & 0xFFF) ^ 0x800) - 0x800).view(N, mbh, mbw)
    mvy = ((((recs >> 19) & 0xFFF) ^ 0x800) - 0x800).view(N, mbh, mbw)
    W, H = 16 * mbw, 16 * mbh
    return (moved + ref_window_bytes(mvx, mvy, pred, 16, W, H)
            + 2 * ref_window_bytes(mvx >> 1, mvy >> 1, pred, 8, W // 2,
                                   H // 2))


def idct_needed_bytes(nfinal, intra_bl, flag_bytes: int) -> int:
    """K2 / K2F: the bytes this tick's data needs.  Every block's nfinal
    is read and its 64 residuals written; a coded block reads its 64
    levels (the DC shortcut, nfinal 1 and not intra, its DC alone); each
    lane with a coded block reads its two quantiser matrices; the scale
    table; and `flag_bytes`, the intra flags and qscales the caller's
    layout reads for the coded blocks."""
    coded = nfinal > 0
    dc = (nfinal == 1) & ~intra_bl.bool()
    return (nfinal.numel() * (4 + 128) + int((coded & ~dc).sum()) * 128
            + int(dc.sum()) * 2 + int(coded.any(dim=1).sum()) * 512 + 256
            + flag_bytes)


def fused_needed_bytes(nfinal, intra_bl, recs, active, mbw: int,
                       mbh: int) -> int:
    """K23: the bytes this tick's data needs -- K2's less the residuals
    it writes, and K3's less the residuals it reads (2 B a pixel of each
    MB that is not STALE); the intra flags and qscales come with the
    records."""
    import torch
    from espflix_tpu_torch.ops import vlc_scan as VS
    kind = torch.where(active.bool()[:, None], recs & 3, VS.MB_STALE)
    coded = int((kind != VS.MB_STALE).sum())
    return (idct_needed_bytes(nfinal, intra_bl, 0) - nfinal.numel() * 128
            + compose_needed_bytes(recs, active, mbw, mbh) - coded * 2 * 384)


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


def scan_chain_ms(steps: int, clock_hz: float) -> float:
    """The least time of a scan row's FSM chain of `steps` steps at
    SCAN_STEP_CYCLES a step and the SM clock."""
    return steps * SCAN_STEP_CYCLES / clock_hz * 1e3


@contextlib.contextmanager
def http_service(seed: int = 0):
    """The serving phases' service (2 titles of 4 GOPs) behind the local
    HTTP Range server; yields its URL and its directory."""
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
            yield url, root
        finally:
            shutdown()


def serve_phase_a(dev, url: str, lanes: int, ticks: int, smi: str,
                  seed: int = 0):
    """serve_scenario's full stage over HTTP with faults and a snapshot
    restored into a second fleet; returns the launch counts."""
    import torch
    from espflix_tpu_torch.runtime import telemetry
    from espflix_tpu_torch.tools import serve_scenario as SS

    fleet = build_native_fleet(url, lanes, 2, stage="full", device=dev)
    rs = record_results(fleet)
    torch.cuda.synchronize()
    reset_counts()
    stats, snap = SS.run_scenario(fleet, ticks, seed=seed, faults=2,
                                  snapshot_at=ticks // 2, dispatch="full")
    counts = read_counts("serving A", CHAIN_KERNELS)
    require_native_feeds("serving A after its run", fleet)
    fleet2 = build_native_fleet(url, lanes, 2, stage="full", device=dev)
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
    host_ms = 1000 * (tm.get("gather_packed", 0) + tm.get("gather", 0)
                      + tm.get("batch_assemble", 0))
    dev_ms = 1000 * (tm.get("chain_enqueue", 0) + tm.get("host_sync", 0))
    split = {k: round(1000 * v / ticks, 2)
             for k, v in telemetry.top_level(tm).items()}
    log(f"[serve A] {lanes} lanes x {ticks} ticks over HTTP on the native "
        f"feed: {1000 * stats.wall_s / ticks:.1f} ms/tick wall, host "
        f"(gather_packed, gather, assemble) {host_ms / ticks:.1f} ms/tick, "
        f"device chain (launch + sync) {dev_ms / ticks:.1f} ms/tick, "
        f"untimed {1000 * stats.wall_s / ticks - sum(split.values()):.1f} "
        f"ms/tick; timers ms/tick {split}; frames "
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
        fleet = build_native_fleet(url, lanes, 2, stage="full", device=dev)
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


def sbc_varied(seed: int, N: int, F: int, channels: int, dev):
    """Varied SBC input for K6, on the card: frames drawn from a pool of
    random frames (bitpools 2-63, SNR or loudness allocation, padded to
    one length; a few of the other channel count), every sampling
    frequency, ~3% broken sync words and ~3% bitpool 250 (the unpack runs
    past the buffer), n_valid full / partial / 0, ~1/16 idle lanes and a
    random history.  Returns (words, hist, active, n_valid)."""
    import numpy as np
    import torch
    from espflix_tpu_torch.models import sbc as dsbc
    from espflix_tpu_torch.tools.sbc_encode import random_frame

    rng = np.random.default_rng(seed)
    mode = 0 if channels == 1 else 2
    pool = [random_frame(rng, mode=mode, bitpool=int(rng.integers(2, 64)),
                         allocation=int(rng.random() < 0.3))
            for _ in range(60)]
    pool += [random_frame(rng, mode=2 - mode, bitpool=8) for _ in range(4)]
    bank = np.zeros((len(pool), max(len(f) for f in pool)), np.uint8)
    for i, f in enumerate(pool):
        bank[i, :len(f)] = np.frombuffer(f, np.uint8)
    fr = bank[rng.integers(0, len(pool), (N, F))]
    fr[:, :, 1] = (fr[:, :, 1] & 0x3F) | \
        (rng.integers(0, 4, (N, F)) << 6).astype(np.uint8)
    fr[rng.random((N, F)) < 0.03, 0] = 0
    fr[rng.random((N, F)) < 0.03, 2] = 250
    n_valid = rng.integers(0, F + 1, N).astype(np.int32)
    n_valid[::7] = F
    n_valid[3::11] = 0
    active = rng.random(N) >= 1 / 16
    hist = rng.integers(-30000, 30000, (N, 2, 10, 16)).astype(np.int32)
    words = dsbc.frames_to_words(fr).view(np.int32)
    return tuple(torch.from_numpy(a).to(dev)
                 for a in (words, hist, active, n_valid))


def sbc_kernel(x, F: int, dev, reps: int, clock_hz: float):
    """K6 against its plain form on the bench tick's audio (x: 13 mono
    frames a lane, the chain's call) and on sbc_varied's mono and stereo
    audio over two calls with the history carried; returns (K6's kernel
    entry, the tick's PCM)."""
    import torch
    from espflix_tpu_torch.models import sbc as dsbc

    N = x["aud_words"].shape[0]
    args = (x["aud_words"], dsbc.init_state(N, dev))
    kw = dict(active=x["aud_act"], n_valid=x["aud_nval"], n_frames=F,
              channels=1)
    got = dsbc.decode_frames_batched(*args, **kw)
    err = require_equal("K6 sbc (bench tick)", zip(
        got, dsbc.decode_frames_batched_torch(*args, **kw)))
    if got[2].any():
        raise AssertionError("K6: error frames in the bench tick's audio")
    checked = 0
    for channels in (1, 2):
        w, h_k, act, nv = sbc_varied(40 + channels, N, F, channels, dev)
        h_p = h_k
        for call in range(2):
            wc = w if call == 0 else w.roll(1, dims=1).contiguous()
            vk = dsbc.decode_frames_batched(wc, h_k, act, nv, n_frames=F,
                                            channels=channels)
            vp = dsbc.decode_frames_batched_torch(wc, h_p, act, nv,
                                                  n_frames=F,
                                                  channels=channels)
            err = max(err, require_equal(
                f"K6 sbc (varied, {channels} ch, call {call})", zip(vk, vp)))
            if not vk[2].any() or not (vk[0] != 0).any():
                raise AssertionError("K6 varied: no error frame or no PCM")
            h_k, h_p = vk[1], vp[1]
            checked += int(vk[2].sum())
    entry = dict(
        name="K6_sbc_decode", route="cuda",
        source="espflix_tpu_torch/csrc/sbc.cu",
        replaces="espflix_tpu/models/sbc.py:136 (XLA decode_frames_batched;"
                 " no Pallas kernel)",
        max_abs_err=err, library_ms=None,
        **timed(lambda: dsbc.decode_frames_batched(*args, **kw), reps),
        plain_ms=time_ms(lambda: dsbc.decode_frames_batched_torch(
            *args, **kw), reps))
    # operations: this call's valid (frame, channel) pairs -- in n_valid,
    # on an active lane, not in error -- at SBC_OPS_PER_FRAME_CH each
    in_n = torch.arange(F, device=dev)[None, :] < x["aud_nval"][:, None]
    n_valid_fc = int((in_n & x["aud_act"][:, None]).sum()) - \
        int(got[2].sum())
    rate = (torch.cuda.get_device_properties(dev).multi_processor_count
            * INT32_OPS_PER_SM_CLOCK * clock_hz)
    entry["bound_ms"], entry["bound_by"] = bound(
        nbytes(*args, kw["active"], kw["n_valid"], *got),
        n_valid_fc * SBC_OPS_PER_FRAME_CH / rate * 1e3)
    log(f"[kernel] {entry} ({n_valid_fc} valid frames; varied mono and "
        f"stereo audio exact over two calls, {checked} error frames)")
    return entry, got[0]


def compose_check(label, fn, plain, res, recs, active, rand_frames,
                  mbw: int, mbh: int, reps: int):
    """K3 or K3F (fn) against its plain form on fresh random frames --
    the presented planes and both frame slots -- then timed (the plain
    form on its one checked run).  Returns the kernel's presented planes
    and its numbers (max_abs_err, ms, device_ms, plain_ms, bound_ms,
    bound_by)."""
    fr_k = rand_frames()
    fr_p = {k: v.clone() for k, v in fr_k.items()}
    kw = dict(mb_width=mbw, mb_height=mbh)
    pk = fn(res, recs, active, fr_k, **kw)
    pp, plain_ms = run_timed(lambda: plain(res, recs, active, fr_p, **kw))
    err = require_equal(label, [(pk[k], pp[k]) for k in "yuv"]
                        + [(fr_k[k], fr_p[k]) for k in "yuv"])
    stats = dict(max_abs_err=err,
                 **timed(lambda: fn(res, recs, active, fr_k, **kw), reps),
                 plain_ms=plain_ms)
    stats["bound_ms"], stats["bound_by"] = bound(
        compose_needed_bytes(recs, active, mbw, mbh))
    stats["yardstick_ms"] = bound(
        compose_bytes(res, recs, active, fr_k, pk))[0]
    return pk, stats


def idct_T_check(label, coeffs_T, recs, nfinal, xt, chain, reps: int):
    """K2 against its plain form on K1's output of tick `xt`, then
    timed (the plain form on its one checked run).  Returns the kernel's
    residuals and its numbers (max_abs_err, ms, device_ms, plain_ms,
    bound_ms, bound_by, yardstick_ms)."""
    from espflix_tpu_torch.ops import idct as IDCT

    intra_bl, qs_bl = IDCT.block_flags(recs)
    idct_args = (coeffs_T, intra_bl, qs_bl, xt["intra_q"],
                 xt["non_intra_q"], nfinal, chain.scale_dct)
    res_k = IDCT.block_residuals_T(*idct_args)
    res_p, plain_ms = run_timed(
        lambda: IDCT.block_residuals_T_torch(*idct_args))
    stats = dict(
        max_abs_err=require_equal(f"K2 idct ({label} tick)",
                                  [(res_k, res_p)]),
        **timed(lambda: IDCT.block_residuals_T(*idct_args), reps),
        plain_ms=plain_ms)
    stats["bound_ms"], stats["bound_by"] = bound(
        idct_needed_bytes(nfinal, intra_bl, int((nfinal > 0).sum()) * 5))
    stats["yardstick_ms"] = bound(nbytes(*idct_args, res_k))[0]
    return res_k, stats


def p_tick_keys(stats: dict) -> dict:
    """A kernel's numbers on the P-heavy tick, as `<key>_p` entries."""
    return {f"{k}_p": stats[k] for k in ("ms", "device_ms", "plain_ms",
                                         "split_ms", "split_device_ms",
                                         "bound_ms", "yardstick_ms")
            if k in stats}


def fused_check(label, coeffs_T, recs, nfinal, xt, active, rand_frames,
                chain, mbw: int, mbh: int, reps: int) -> dict:
    """K23 against K2 then K3 on the card (the split pair, each held to
    its plain form) on fresh random frames -- the presented planes and
    both frame slots -- then both timed.  Returns K23's numbers
    (max_abs_err, ms, device_ms, split_ms, split_device_ms, bound_ms,
    bound_by, yardstick_ms)."""
    from espflix_tpu_torch.ops import idct as IDCT
    from espflix_tpu_torch.ops import mocomp as MC

    kw = dict(mb_width=mbw, mb_height=mbh)
    intra_bl, qs_bl = IDCT.block_flags(recs)
    k2_args = (coeffs_T, intra_bl, qs_bl, xt["intra_q"], xt["non_intra_q"],
               nfinal, chain.scale_dct)
    k23_args = (coeffs_T, recs, nfinal, xt["intra_q"], xt["non_intra_q"],
                active)

    def split(fr):
        return MC.predict_compose_put(IDCT.block_residuals_T(*k2_args),
                                      recs, active, fr, **kw)

    def fused(fr):
        return MC.idct_compose_put(*k23_args, fr, scale_dct=chain.scale_dct,
                                   **kw)

    fr_f = rand_frames()
    fr_s = {k: v.clone() for k, v in fr_f.items()}
    pf, ps = fused(fr_f), split(fr_s)
    stats = dict(max_abs_err=require_equal(
        f"K23 ({label} tick) vs K2 + K3", [(pf[k], ps[k]) for k in "yuv"]
        + [(fr_f[k], fr_s[k]) for k in "yuv"]),
        **timed(lambda: fused(fr_f), reps))
    pair = timed(lambda: split(fr_s), reps)
    stats["split_ms"], stats["split_device_ms"] = pair["ms"], \
        pair["device_ms"]
    stats["bound_ms"], stats["bound_by"] = bound(fused_needed_bytes(
        nfinal, intra_bl, recs, active, mbw, mbh))
    stats["yardstick_ms"] = bound(
        nbytes(*k23_args, fr_f["parity"], *[fr_f[k] for k in "yuv"])
        + 2 * nbytes(*[pf[k] for k in "yuv"]))[0]
    return stats


def dense_edge_case(dev, mbw: int, mbh: int, lanes: int = 256) -> dict:
    """K2F, K2, K3, K3F and K23 against their plain forms on the tests' shared
    edge case (tools/dense_cases.py) at the bench's picture size:
    vectors at and past every edge with every half-pel phase, STALE /
    SKIP / INTER / INTRA mixes, inactive and all-STALE lanes,
    int16-extreme levels and residuals.  Returns each one's max |err|."""
    import numpy as np
    import torch
    from espflix_tpu_torch.ops import idct as IDCT
    from espflix_tpu_torch.ops import mocomp as MC
    from espflix_tpu_torch.tools.dense_cases import dense_case

    c = dense_case(17, mbw, mbh, lanes)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    args = [t(c[k]) for k in ("coeffs", "recs", "nfinal", "iq", "nq")]
    errs = {"K2F": require_equal("K2F idct, edge case", [(
        IDCT.block_residuals_flat(*args),
        IDCT.block_residuals_flat_torch(*args))])}
    recs, active = t(c["recs"]), t(c["active"])
    t_args = (t(c["coeffs_T"]), *IDCT.block_flags(recs), *args[3:],
              args[2])
    errs["K2"] = require_equal("K2 idct, edge case", [(
        IDCT.block_residuals_T(*t_args),
        IDCT.block_residuals_T_torch(*t_args))])
    k23_args = (t(c["coeffs_T"]), recs, args[2], *args[3:], active)
    fr_k = {k: t(v) for k, v in c["frames"].items()}
    fr_p = {k: v.clone() for k, v in fr_k.items()}
    kw = dict(mb_width=mbw, mb_height=mbh)
    pk = MC.idct_compose_put(*k23_args, fr_k, **kw)
    pp = MC.idct_compose_put_torch(*k23_args, fr_p, **kw)
    errs["K23"] = require_equal(
        "K23 idct + compose, edge case", [(pk[k], pp[k]) for k in "yuv"]
        + [(fr_k[k], fr_p[k]) for k in "yuv"])
    for name, fn, plain, key in (
            ("K3", MC.predict_compose_put, MC.predict_compose_put_torch,
             "res_T"),
            ("K3F", MC.predict_compose_put_flat,
             MC.predict_compose_put_flat_torch, "res")):
        fr_k = {k: t(v) for k, v in c["frames"].items()}
        fr_p = {k: v.clone() for k, v in fr_k.items()}
        kw = dict(mb_width=mbw, mb_height=mbh)
        pk = fn(t(c[key]), recs, active, fr_k, **kw)
        pp = plain(t(c[key]), recs, active, fr_p, **kw)
        errs[name] = require_equal(
            f"{name} compose, edge case", [(pk[k], pp[k]) for k in "yuv"]
            + [(fr_k[k], fr_p[k]) for k in "yuv"])
    torch.cuda.synchronize()
    log(f"[kernel] edge case ({lanes} lanes, {mbw}x{mbh} MBs): max |err| "
        f"{errs}")
    return errs


def rule_b_edge_mbs(mv_h, mv_v, S: int):
    """bool[N, mbh, mbw]: the MBs whose rule-B taps cross an edge of the
    plane, which K3P predicts byte by byte (predict_cases.crossings)."""
    import torch
    from espflix_tpu_torch.tools.predict_cases import crossings
    mbh, mbw = mv_h.shape[1:]
    m = crossings(dict(mv_h=mv_h.cpu().numpy(), mv_v=mv_v.cpu().numpy(),
                       mb_size=S, mb_width=mbw, mb_height=mbh))["edge"]
    return torch.from_numpy(m)


def predict_edge_case(dev, mbw: int, mbh: int, lanes: int) -> int:
    """K3P against its plain forms on the tests' shared edge case
    (tools/predict_cases.py) at the bench's picture size: luma and
    chroma, rule A over the whole plane and rule B on each of the
    case's bands.  Returns the max |err|."""
    import torch
    from espflix_tpu_torch.ops import mocomp as MC
    from espflix_tpu_torch.tools.predict_cases import bands, predict_case

    err = 0
    for S in (16, 8):
        c = predict_case(400 + S, S, mbw, mbh, lanes)
        ref, mh, mv = (torch.from_numpy(c[k]).to(dev)
                       for k in ("ref", "mv_h", "mv_v"))
        err = max(err, require_equal(f"K3P rule A, edge case, S={S}", [(
            MC.predict_plane(ref, mh, mv, S),
            MC.predict_plane_torch(ref, mh, mv, S))]))
        if S == 8:
            # the one-launch u + v form, v from another case's plane
            ref_v = torch.from_numpy(
                predict_case(500, S, mbw, mbh, lanes)["ref"]).to(dev)
            err = max(err, require_equal(
                "K3P chroma pair, edge case",
                zip(MC.predict_chroma_pair(ref, ref_v, mh, mv),
                    MC.predict_chroma_pair_torch(ref, ref_v, mh, mv))))
        for row0, rows in bands(mbh):
            mhb, mvb = (t[:, row0:row0 + rows].contiguous() for t in (mh, mv))
            err = max(err, require_equal(
                f"K3P rule B, edge case, S={S}, MB rows {row0}+{rows}", [(
                    MC.predict_plane_rows(ref, mhb, mvb, S, row0),
                    MC.predict_plane_rows_torch(ref, mhb, mvb, S, row0))]))
    torch.cuda.synchronize()
    log(f"[kernel] K3P edge case ({lanes} lanes, {mbw}x{mbh} MBs, S 16 "
        f"and 8, the chroma pair, bands {bands(mbh)}): max |err| {err}")
    return err


def composite_edge_case(dev, lanes: int) -> int:
    """K4 against its plain form on the tests' shared edge case
    (tools/composite_cases.py: every blend class, progress at the bar's
    ends, both parities, luma across the dither mask, every chroma
    value) at `lanes` lanes and at lanes - 3 (not a multiple of the
    kernel's eight lanes a block), NTSC and PAL.  Returns the max
    |err|."""
    import numpy as np
    import torch
    from espflix_tpu_torch.ops import composite as CO
    from espflix_tpu_torch.tools.composite_cases import ARGS, composite_case

    c = composite_case(23, lanes)
    err = 0
    for n in (lanes, lanes - 3):
        a = [torch.from_numpy(np.ascontiguousarray(c[k][:n])).to(dev)
             for k in ARGS]
        for pal in (False, True):
            tmpl, dith, _g = CO._packed_consts(pal)
            kw = dict(pal=pal, tmpl=torch.from_numpy(tmpl).to(dev),
                      dither=torch.from_numpy(
                          np.ascontiguousarray(dith)).to(dev))
            err = max(err, require_equal(
                f"K4 composite, edge case ({n} lanes, "
                f"{'PAL' if pal else 'NTSC'})",
                zip(CO.synthesize_field_pair_parts(*a, **kw),
                    CO.synthesize_field_pair_parts_torch(*a, **kw))))
    torch.cuda.synchronize()
    log(f"[kernel] K4 edge case ({lanes} and {lanes - 3} lanes, NTSC and "
        f"PAL): max |err| {err}")
    return err


def flat_kernels(x, x_p, chain, rand_frames, reps: int, mbw: int,
                 mbh: int, clock_hz: float) -> list:
    """K1F, K2F and K3F against their plain versions on the bench tick
    `x` (run_chunk's scan configuration: two buckets of 2,048 / 512
    steps in chunks of 128, long_rows from bucket_policy); K2F and K3F
    also on K1F's output of the P-heavy tick `x_p` (its numbers as
    `<key>_p`).  Returns their kernel entries."""
    import torch
    from espflix_tpu_torch.models import mpeg1 as M
    from espflix_tpu_torch.ops import idct as IDCT
    from espflix_tpu_torch.ops import mocomp as MC
    from espflix_tpu_torch.ops import vlc_scan as VS
    from espflix_tpu_torch.runtime.scheduler import bucket_policy

    def scan_config(xt):
        args = [xt[k] for k in M.SCAN_KEYS]
        need = int(((xt["pic_type"] == 1) & (xt["alive"] == 1)).sum())
        long_rows, s_long, s_short = bucket_policy(
            max(need, 8), args[0].shape[0], steps_long=2048,
            steps_short=512)
        return args, dict(mb_width=mbw, mb_height=mbh, n_lanes=N,
                          long_rows=long_rows, steps_long=s_long,
                          steps_short=s_short, chunk=128,
                          lut=chain.scan_lut, zigzag=chain.zigzag)

    out = []
    N = x["active"].shape[0]
    args, skw = scan_config(x)
    got = VS.run_scan_bucketed(*args, **skw)
    ref, plain_ms = run_timed(lambda: VS.run_scan_bucketed_torch(*args,
                                                                 **skw))
    err = require_equal("K1F scan", zip(got, ref))
    if got[3].any():
        raise AssertionError("K1F: lane errors on well-formed content")
    out.append(dict(
        name="K1F_slice_scan_flat", route="cuda",
        source="espflix_tpu_torch/csrc/scan.cu",
        replaces="espflix_tpu/ops/vlc_scan_pallas.py:55",
        max_abs_err=err, library_ms=None,
        **timed(lambda: VS.run_scan_bucketed(*args, **skw), reps),
        plain_ms=plain_ms))
    out[-1]["bound_ms"], out[-1]["bound_by"] = bound(nbytes(
        *args, VS.compact_lut(chain.scan_lut), chain.zigzag, *got),
        scan_chain_ms(int(got[4]), clock_hz))
    log(f"[kernel] {out[-1]} (long_rows {skw['long_rows']}, steps "
        f"{skw['steps_long']}/{skw['steps_short']}; chain: the longest "
        f"row's {int(got[4])} steps x {SCAN_STEP_CYCLES} cycles)")

    # K2F and K3F on K1F's output of the I-heavy tick, then the P-heavy
    stats = {}
    for label, xt in (("I", x), ("P", x_p)):
        if xt is not x:
            p_args, p_kw = scan_config(xt)
            got = VS.run_scan_bucketed(*p_args, **p_kw)
        coeffs, recs, nfinal = got[:3]
        idct_args = (coeffs, recs, nfinal, xt["intra_q"],
                     xt["non_intra_q"], chain.scale_dct)
        res_k = IDCT.block_residuals_flat(*idct_args)
        res_p = IDCT.block_residuals_flat_torch(*idct_args)
        k2f = dict(
            max_abs_err=require_equal(f"K2F idct ({label} tick)",
                                      [(res_k, res_p)]),
            **timed(lambda: IDCT.block_residuals_flat(*idct_args), reps),
            plain_ms=time_ms(lambda: IDCT.block_residuals_flat_torch(
                *idct_args), reps))
        coded_mbs = int((nfinal > 0).reshape(N, -1, 6).any(-1).sum())
        k2f["bound_ms"], k2f["bound_by"] = bound(idct_needed_bytes(
            nfinal, ((recs & 3) == VS.MB_INTRA).repeat_interleave(6, 1),
            coded_mbs * 4))
        k2f["yardstick_ms"] = bound(nbytes(*idct_args, res_k))[0]
        active = xt["active"].clone()
        active[5::13] = False                  # some inactive lanes
        _pk, k3f = compose_check(
            f"K3F compose ({label} tick)", MC.predict_compose_put_flat,
            MC.predict_compose_put_flat_torch, res_k, recs, active,
            rand_frames, mbw, mbh, reps)
        stats[label] = (k2f, k3f)
    for i, (name, source, replaces) in enumerate((
            ("K2F_dequant_idct_flat", "idct.cu",
             "espflix_tpu/ops/idct_pallas.py:86"),
            ("K3F_predict_compose_put_flat", "compose.cu",
             "espflix_tpu/ops/mocomp_pallas.py:92,161"))):
        on_i, on_p = stats["I"][i], stats["P"][i]
        out.append(dict(
            name=name, route="cuda",
            source=f"espflix_tpu_torch/csrc/{source}", replaces=replaces,
            library_ms=None, **on_i, **p_tick_keys(on_p)))
        out[-1]["max_abs_err"] = max(on_i["max_abs_err"],
                                     on_p["max_abs_err"])
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
    from espflix_tpu_torch.runtime import telemetry
    from espflix_tpu_torch.tools import serve_scenario as SS

    torch.cuda.synchronize()
    reset_counts()
    for dispatch in ("pipelined", "chunk"):
        fleet = build_native_fleet(url, lanes, 2, device=dev)
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
        tm = telemetry.top_level(fleet.timers.acc)
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
            fleet = build_native_fleet(url, n, 2, device=dev)
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


def compute_app_pids() -> list[str]:
    """The pids nvidia-smi lists as holding a CUDA context."""
    r = subprocess.run(["nvidia-smi", "--query-compute-apps=pid",
                        "--format=csv,noheader"], capture_output=True,
                       text=True)
    if r.returncode != 0:
        raise AssertionError(f"nvidia-smi --query-compute-apps: "
                             f"{r.stderr.strip()}")
    return r.stdout.split()


def torch_worker_cost() -> dict:
    """What a worker that imported torch would cost: a fresh interpreter
    under CUDA_VISIBLE_DEVICES="" that loads the pool's module (as a
    worker does) and then imports torch: the import's seconds and the
    resident set (KiB, runtime/hostpool._rss_kib) before and after."""
    import os
    from pathlib import Path
    code = ("import json, time; "
            "from espflix_tpu_torch.runtime.hostpool import _rss_kib; "
            "before = _rss_kib(); t0 = time.perf_counter(); import torch; "
            "print(json.dumps(dict(import_torch_s=time.perf_counter() - t0,"
            " before=before, after=_rss_kib())))")
    root = str(Path(__file__).resolve().parent)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=root, env=dict(
                           os.environ, CUDA_VISIBLE_DEVICES="",
                           PYTHONPATH=root))
    if r.returncode != 0:
        raise AssertionError(f"torch_worker_cost: {r.stderr[-500:]}")
    return json.loads(r.stdout.strip().splitlines()[-1])


def output_setup(st, N: int):
    """Per-lane OSD of phase 4o: a third of the lanes show it -- every
    blend class (-1, a fade that runs out mid-run, 1..31, >= 32) and
    progress from the bar's empty end to its full one."""
    from espflix_tpu_torch.video.render import FFWD, PLAY
    for lane in range(0, N, 3):
        k = lane // 3
        total = 90000 * 100
        pts = [0, total, 90000 * (k % 100)][k % 3]
        st.update_progress(lane, pts, total, FFWD if k % 2 else PLAY)
        st.show_progress(lane, t=(-1, 3, 1 + k % 31, 32 + k % 200)[k % 4])


def per_field_times(dev, yuv, pal: bool, sliders, reps: int) -> dict:
    """ms of OutputStage.synthesize at the planes' lanes: a field with no
    lane sliding (steady) and one with `sliders` re-armed at the slide's
    first step before every call (scrolled), CUDA events and host clock;
    and the parts alone on the same inputs: K4's pair, the scroll blit,
    field 0's canvas, the state uploads; with the bytes bound of a field
    (planes, OSD, state read once, the field written once)."""
    import numpy as np
    import torch
    from espflix_tpu_torch.ops import composite as CO
    from espflix_tpu_torch.runtime import output as OUT

    y, u, v = yuv
    N = y.shape[0]
    st = OUT.OutputStage(N, pal=pal, device=dev)
    output_setup(st, N)
    st.synthesize(y, u, v)                   # the slides' planes

    def host_ms(fn):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / reps

    steady = lambda: st.synthesize(y, u, v)  # noqa: E731
    r = dict(steady_ms=time_ms(steady, reps), host_steady_ms=host_ms(steady))
    sl = np.asarray(sliders)
    for j, lane in enumerate(sliders):
        st.start_slide(lane, 2 if j % 2 else 3)
    idx0, hs0 = st.animate_index[sl].copy(), st.hscroll[sl].copy()

    def scrolled():
        st.animate_index[sl], st.hscroll[sl] = idx0, hs0
        return st.synthesize(y, u, v)
    r.update(scrolled_ms=time_ms(scrolled, reps),
             host_scrolled_ms=host_ms(scrolled))
    field = scrolled()
    tmpl, dither = CO.packed_tensors(pal, st.device)
    state = lambda: (  # noqa: E731
        st._tensor((st.frame_counter & 1).astype(np.int32), torch.int32),
        st._tensor(st.osd, torch.uint8), st._tensor(st.blend, torch.int32),
        st._tensor(st.progress, torch.int32),
        st._tensor(st.hscroll, torch.int32))
    par, osd, blend, prog, hs = state()
    k4 = lambda: CO.synthesize_field_pair_parts(  # noqa: E731
        y, u, v, par, osd, blend, prog, pal=pal, tmpl=tmpl, dither=dither)
    act, strip, _chk = k4()
    r.update(part_k4_pair_ms=time_ms(k4, reps),
             part_scroll_blit_ms=time_ms(lambda: CO.apply_hscroll(
                 y, u, v, *st._slide_on_device(), hs), reps),
             part_canvas_ms=time_ms(lambda: CO.field_canvas(
                 act[:, :1], strip, pal=pal, tmpl=tmpl), reps),
             part_uploads_ms=time_ms(state, reps))
    moved = (y.numel() + u.numel() + v.numel() + field.numel()
             + st.osd.nbytes + 4 * 4 * N)
    r["bound_ms"], r["bound_by"] = bound(moved)
    return r


def per_field_phase(dev, planes, smi: str, reps: int, fields: int = 6):
    """Phase 4o: OutputStage.synthesize / modulate at the planes' lanes,
    through the kernels and through the plain forms in lockstep from the
    same state, NTSC and PAL: every field, PDM word and carry equal, K4
    and K5 launched; then ms a field and a call.  Returns the entries'
    extra numbers for the kernels line."""
    import numpy as np
    import torch
    from espflix_tpu_torch.ops import delta_sigma as DS
    from espflix_tpu_torch.runtime.output import OutputStage

    N = planes[0][0].shape[0]
    lanes = torch.arange(N)
    sliders = [int(i) for i in lanes[lanes % 4 == 1]]
    out = {}
    for pal in (False, True):
        std = "PAL" if pal else "NTSC"
        stages = [OutputStage(N, pal=pal, device=dev) for _ in range(2)]
        for st in stages:
            output_setup(st, N)
        torch.cuda.synchronize()
        reset_counts()
        n_cmp = 0
        for k in range(fields):
            if k == 2:
                # a quarter of the lanes slide from the last planes, half
                # from each side: fields 2.. take the scrolled branch
                for st in stages:
                    for j, lane in enumerate(sliders):
                        st.start_slide(lane, 2 if j % 2 else 3)
            y, u, v = planes[k % len(planes)]
            got = stages[0].synthesize(y, u, v)
            with plain_forms():
                ref = stages[1].synthesize(y, u, v)
            require_equal(f"per-field {std} field {k}", [(got, ref)])
            n_cmp += 1
            for key in ("blend", "frame_counter", "hscroll",
                        "animate_index"):
                if not np.array_equal(getattr(stages[0], key),
                                      getattr(stages[1], key)):
                    raise AssertionError(f"per-field {std}: {key} differs")
        counts = read_counts(f"per-field {std}", ("K4_composite_field_pair",))
        if not (stages[0].hscroll != 0).any():
            raise AssertionError("per-field: no lane slides")
        faded = int(((stages[0].blend == 0)
                     & (np.arange(N) % 3 == 0)).sum())
        out[std] = dict(per_field_times(dev, planes[0], pal, sliders, reps),
                        launches=counts["K4_composite_field_pair"])
        log(f"[per-field {std}] {N} lanes x {fields} fields: kernel path "
            f"== plain path ({n_cmp} fields of {tuple(got.shape)} uint8; "
            f"{len(sliders)} lanes slid, {faded} OSD lanes faded out); "
            f"K4 launches {counts}; a field, ms (CUDA events; host clock "
            f"host_*; the parts alone part_*): {out[std]} | {smi}")
    del got, ref

    # modulate: 3 calls of 256 samples, one of an odd count; beeps on
    # some lanes, starved lanes on others
    g = torch.Generator(device="cpu").manual_seed(11)
    stages = [OutputStage(N, device=dev) for _ in range(2)]
    for st in stages:
        for lane in range(0, N, 5):
            st.beep(lane)
    torch.cuda.synchronize()
    reset_counts()
    for k, T in enumerate((256, 256, 256, 333)):
        pcm = torch.randint(-32768, 32768, (N, T), generator=g,
                            dtype=torch.int32).to(torch.int16).to(dev)
        starved = (torch.arange(N) % 7 == k).numpy()
        got = stages[0].modulate(pcm, starved)
        with plain_forms():
            ref = stages[1].modulate(pcm, starved)
        require_equal(f"modulate call {k} (T={T})",
                      [(got, ref), (stages[0].pdm_state,
                                    stages[1].pdm_state)])
        if not np.array_equal(stages[0].beep_frames, stages[1].beep_frames):
            raise AssertionError("modulate: beep_frames differ")
    counts = read_counts("modulate", ("K5_pdm",))
    st = stages[0]
    pcm = pcm[:, :256].contiguous()
    t0 = time.perf_counter()
    for _ in range(reps):
        st.modulate(pcm)
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / reps
    ev_ms = time_ms(lambda: st.modulate(pcm), reps)
    k5_ms = time_ms(lambda: DS.modulate(pcm, st.pdm_state, n_samples=256),
                    reps)
    out["modulate"] = dict(ms=ev_ms, host_ms=host_ms, part_k5_ms=k5_ms,
                           launches=counts["K5_pdm"])
    log(f"[modulate] {N} lanes: 3 calls of 256 samples and one of 333, "
        f"beeps on {len(range(0, N, 5))} lanes, starved lanes: kernel path "
        f"== plain path (words, state, beep counters); K5 launches {counts}; "
        f"a call of 256 samples {ev_ms:.3f} ms (CUDA events), "
        f"{host_ms:.3f} ms (host clock), K5 alone {k5_ms:.3f} ms | {smi}")
    return out


def frames_equal(got, want) -> bool:
    """Two lists of (y, u, v) numpy frames, byte for byte."""
    import numpy as np
    return len(got) == len(want) and all(
        np.array_equal(a, b) for g, w in zip(got, want) for a, b in zip(g, w))


@contextlib.contextmanager
def picture_spans(spans: list):
    """CUDA-event spans around every models/mpeg1.decode_picture_impl
    call (the device's part of a decode_es_batched picture)."""
    import torch
    from espflix_tpu_torch.models import mpeg1 as M
    inner = M.decode_picture_impl

    def spanned(*a, **kw):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        out = inner(*a, **kw)
        ev[1].record()
        spans.append(ev)
        return out
    M.decode_picture_impl = spanned
    try:
        yield
    finally:
        M.decode_picture_impl = inner


def oracle_decode(dev, smi: str, reps: int, lanes: int) -> dict:
    """Phase O, decode: decode_es_batched at 352x192 on `lanes` lanes
    tiled from 8 realistic_gop_script streams of 6-12 pictures, once
    sequential (K1S's two passes) and once slice-parallel (its per-slice
    pass alone), each lane equal to oracle.decode_mpeg1 of its stream;
    the slice-parallel decode of the 8 streams through the plain forms
    equal; the per-slice pass against scan_slices_torch and timed against
    K1S's two passes on the run's first two pictures.  Returns the
    numbers and each lane's first two frames (y, u, v, y2, u2, v2)."""
    import numpy as np
    import torch
    from espflix_tpu_torch.models import mpeg1 as M
    from espflix_tpu_torch.ops import vlc_scan as VS
    from espflix_tpu_torch.tools import mpeg1_encode as ENC
    from espflix_tpu_torch.tools import oracle as ORC
    from espflix_tpu_torch.tools.content import realistic_gop_script

    distinct = [ENC.encode_es(realistic_gop_script(
        np.random.default_rng(4000 + i), n_pictures=6 + i * 6 // 7))
        for i in range(8)]
    want = [ORC.decode_mpeg1(es)[0] for es in distinct]
    lens = [len(w) for w in want]
    if lens != [6 + i * 6 // 7 for i in range(8)]:
        raise AssertionError(f"oracle frame counts {lens}")
    streams = [distinct[i % 8] for i in range(lanes)]
    npics = max(lens)
    out = {}
    planes = None
    for sp in (False, True):
        mode = "slice_parallel" if sp else "sequential"
        spans = []
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        with picture_spans(spans):
            got = M.decode_es_batched(streams, slice_parallel=sp, device=dev)
        wall = (time.perf_counter() - t0) * 1e3
        counts = read_counts(f"oracle decode {mode}", (
            "K1S_slice_scan_seq", "K2F_dequant_idct_flat",
            "K3F_predict_compose_put_flat"))
        # the slice-parallel run launches K1S's per-slice pass alone: one
        # launch a picture, where the sequential scan takes two
        expect = dict(K1S_slice_scan_seq=npics * (1 if sp else 2),
                      K2F_dequant_idct_flat=npics,
                      K3F_predict_compose_put_flat=npics)
        if counts != expect:
            raise AssertionError(f"oracle decode {mode}: launches {counts}, "
                                 f"expected {expect}")
        bad = [i for i in range(lanes)
               if not frames_equal(got[i], want[i % 8])]
        if bad:
            raise AssertionError(f"oracle decode {mode}: lanes {bad[:8]} "
                                 "!= oracle.decode_mpeg1")
        device_ms = sum(a.elapsed_time(b) for a, b in spans)
        out[mode] = dict(launches=counts, picture_ms=wall / npics,
                         device_share=device_ms / wall)
        log(f"[oracle decode {mode}] {lanes} lanes x {npics} pictures "
            f"(8 streams of {lens} pictures): every lane == "
            f"oracle.decode_mpeg1 ({sum(len(g) for g in got)} frames); "
            f"launches {counts}; {wall / npics:.1f} ms a picture (host "
            f"clock), of it the device span {device_ms / npics:.2f} ms "
            f"(share {device_ms / wall:.3f}) | {smi}")
        if planes is None:
            # each lane's first two frames, for the canvases
            planes = [np.stack([g[f][c] for g in got])
                      for f in (0, 1) for c in range(3)]
        del got
    with plain_forms():
        plain = M.decode_es_batched(distinct, slice_parallel=True, device=dev)
    bad = [i for i in range(8) if not frames_equal(plain[i], want[i])]
    if bad:
        raise AssertionError(f"oracle decode plain forms: lanes {bad}")
    log(f"[oracle decode plain] the 8 streams slice-parallel through the "
        f"plain forms on the card == oracle.decode_mpeg1")

    # the per-slice pass and the two passes on the run's pictures 0 (I)
    # and 1 (P), at the run's word window and budget
    parsed = [M.parse_es(es)[1] for es in distinct]
    pics = [p for ps in parsed for p in ps]
    wpl = max((len(p.payload) + 3) // 4 + 4 for p in pics)
    S = max(len(p.slice_offsets) for p in pics)
    tables = M.decode_tables(dev)
    kw = dict(mb_width=22, mb_height=12, lut=tables["lut"],
              zigzag=tables["zigzag"])
    for k in (0, 1):
        b = M.make_picture_batch([parsed[i % 8][k] for i in range(lanes)],
                                 words_per_lane=wpl, max_slices=S)
        x = list(M.xs_to_torch({key: b[key] for key in M.PICTURE_KEYS[:7]},
                               dev).values())
        budget = wpl * 32
        per_slice = lambda: VS.scan_slices_cuda(  # noqa: E731
            *x, budget=budget, **kw)
        got = per_slice()
        ref, plain_ms = run_timed(lambda: VS.scan_slices_torch(
            *x, budget=budget, **kw))
        err = require_equal(f"K1S per-slice pass, picture {k}",
                            zip(got, ref))
        tag = "" if k == 0 else "_p"
        out["per_slice" + tag] = dict(
            **timed(per_slice, reps), plain_ms=plain_ms, max_abs_err=err,
            steps=int(got[3].max()))
        out["two_passes" + tag] = timed(lambda: VS.run_scan(
            *x, max_steps=budget, max_symbols=budget, **kw), reps)
        log(f"[oracle K1S] picture {k} at {lanes} lanes x {S} slices: "
            f"per-slice pass (steps / end / lo / hi and buffers) == "
            f"scan_slices_torch; per-slice pass {out['per_slice' + tag]}, "
            f"both passes {out['two_passes' + tag]} ms | {smi}")
    return out, planes


def oracle_fields(dev, smi: str, reps: int, lanes: int, planes) -> dict:
    """Phase O, canvases: synthesize_field_pair and
    synthesize_field_scrolled on decoded planes at `lanes` lanes, NTSC
    and PAL, OSD on every lane (always shown, hidden, fades, full; both
    parities): every lane equal to the plain forms, 64 lanes (each blend
    class at each parity) equal to oracle.composite_field; ms of the
    pair, of its canvas alone and of a scrolled field."""
    import numpy as np
    import torch
    from espflix_tpu_torch.ops import composite as CO
    from espflix_tpu_torch.tools import oracle as ORC

    N = lanes
    rng = np.random.default_rng(21)
    y, u, v, y2, u2, v2 = (torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                           for a in planes)
    classes = np.array([-1, 0, 17, 200], np.int32)
    blend = rng.integers(-1, 64, N).astype(np.int32)
    n_orc = min(64, N)
    blend[:n_orc] = classes[(np.arange(n_orc) // 2) % 4]
    parity = (np.arange(N) % 2).astype(np.int32)
    osd = rng.integers(0, 256, (N, 16, 80), dtype=np.uint8)
    prog = rng.integers(0, 241, N).astype(np.int32)
    hs = rng.integers(-352, 353, N).astype(np.int32)
    hs[::5] = 0
    state = [torch.from_numpy(a).to(dev) for a in (parity, osd, blend, prog)]
    hs_t = torch.from_numpy(hs).to(dev)
    host = [t[:n_orc].cpu().numpy() for t in (y, u, v)]
    scrolled = [t[:n_orc].cpu().numpy()
                for t in CO.apply_hscroll(y, u, v, y2, u2, v2, hs_t)]
    out = {}
    for pal in (False, True):
        std = "PAL" if pal else "NTSC"
        torch.cuda.synchronize()
        reset_counts()
        pair = CO.synthesize_field_pair(y, u, v, *state, pal=pal)
        sc = CO.synthesize_field_scrolled(y, u, v, y2, u2, v2, hs_t, *state,
                                          pal=pal)
        counts = read_counts(f"oracle fields {std}",
                             ("K4_composite_field_pair",))
        with plain_forms():
            plain = (CO.synthesize_field_pair(y, u, v, *state, pal=pal),
                     CO.synthesize_field_scrolled(y, u, v, y2, u2, v2, hs_t,
                                                  *state, pal=pal))
        for name, a, b in (("field pair", pair, plain[0]),
                           ("scrolled field", sc, plain[1])):
            if not torch.equal(a, b):
                lanes_off = (a != b).flatten(1).any(dim=1).nonzero()[:8]
                raise AssertionError(f"{name} {std}: kernel != plain on "
                                     f"lanes {lanes_off.flatten().tolist()}")
        del plain
        pair_h = pair[:n_orc].cpu().numpy()
        sc_h = sc[:n_orc].cpu().numpy()
        for i in range(n_orc):
            a = (osd[i], blend[i], prog[i])
            for f in (0, 1):
                w = ORC.composite_field(*(p[i] for p in host),
                                        (parity[i] + f) & 1, pal, *a)
                if not np.array_equal(pair_h[i, f], w):
                    raise AssertionError(f"field pair {std}: lane {i} "
                                         f"field {f} != composite_field")
            w = ORC.composite_field(*(p[i] for p in scrolled), parity[i],
                                    pal, *a)
            if not np.array_equal(sc_h[i], w):
                raise AssertionError(f"scrolled field {std}: lane {i} != "
                                     "composite_field")
        tmpl, dither = CO.packed_tensors(pal, y.device)
        act, strip, _chk = CO.synthesize_field_pair_parts(
            y, u, v, *state, pal=pal, tmpl=tmpl, dither=dither)
        out[std] = dict(
            launches=counts["K4_composite_field_pair"],
            pair_ms=time_ms(lambda: CO.synthesize_field_pair(
                y, u, v, *state, pal=pal), reps),
            pair_canvas_ms=time_ms(lambda: CO.field_canvas(
                act, strip, pal=pal, tmpl=tmpl), reps),
            scrolled_field_ms=time_ms(lambda: CO.synthesize_field_scrolled(
                y, u, v, y2, u2, v2, hs_t, *state, pal=pal), reps))
        out[std]["pair_bound_ms"], _by = bound(nbytes(y, u, v, *state,
                                                      pair))
        log(f"[oracle fields {std}] {N} lanes: the pair "
            f"{tuple(pair.shape)} and a scrolled field ({int((hs != 0).sum())}"
            f" lanes sliding) == plain forms on every lane and == "
            f"oracle.composite_field on lanes 0-{n_orc - 1} (blend -1 / 0 "
            f"/ 17 / 200 at both parities); K4 launches {counts}; ms "
            f"{out[std]} | {smi}")
    return out


def oracle_audio(dev, smi: str, reps: int, lanes: int) -> dict:
    """Phase O, audio: decode_stream_batched (K6) on `lanes` lanes of mono
    SBC frames (8 frame lists of 8-15 frames, tiled), each lane equal to
    SbcOracle frame by frame; modulate_spec (K5) on the decoded PCM, two
    calls of 256 samples with the state carried, each lane equal to
    oracle.pdm_modulate with its state carried."""
    import numpy as np
    import torch
    from espflix_tpu_torch.models import sbc as dsbc
    from espflix_tpu_torch.ops import delta_sigma as DS
    from espflix_tpu_torch.tools import oracle as ORC
    from espflix_tpu_torch.tools.sbc_encode import make_frame

    rng = np.random.default_rng(31)
    lists = [[make_frame(rng.integers(0, 16, (1, 8)), rng=rng, bitpool=28,
                         allocation=int(rng.random() < 0.5))
              for _ in range(8 + i)] for i in range(8)]
    want = []
    for frames in lists:
        dec = ORC.SbcOracle()
        want.append(np.concatenate([dec.decode_frame(f)[0] for f in frames]))
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    pcm = dsbc.decode_stream_batched([lists[i % 8] for i in range(lanes)],
                                     device=dev)
    sbc_wall = (time.perf_counter() - t0) * 1e3
    counts = read_counts("oracle sbc", ("K6_sbc_decode",))
    bad = [i for i in range(lanes) if not np.array_equal(pcm[i],
                                                         want[i % 8])]
    if bad:
        raise AssertionError(f"decode_stream_batched: lanes {bad[:8]} != "
                             "SbcOracle")
    T = 256
    x = torch.from_numpy(np.stack([p[:2 * T] for p in pcm])).to(dev)
    reset_counts()
    state = DS.init_state(lanes, dev)
    words = []
    for k in range(2):
        w, state = DS.modulate_spec(x[:, k * T:(k + 1) * T].contiguous(),
                                    state, n_samples=T)
        words.append(w)
    counts.update(read_counts("oracle pdm", ("K5_pdm",)))
    words = torch.cat(words, dim=1).cpu().numpy()
    state = state.cpu().numpy()
    xh = x.cpu().numpy()
    for i in range(lanes):
        st = np.zeros(3, np.int32)
        for k in range(2):
            w, st = ORC.pdm_modulate(xh[i, k * T:(k + 1) * T], st)
            if not np.array_equal(words[i, k * 2 * T:(k + 1) * 2 * T], w):
                raise AssertionError(f"modulate_spec: lane {i} call {k} != "
                                     "pdm_modulate")
        if not np.array_equal(state[i], st):
            raise AssertionError(f"modulate_spec: lane {i} state != "
                                 "pdm_modulate's")
    xc = x[:, :T].contiguous()
    st0 = DS.init_state(lanes, dev)
    out = dict(launches=counts, sbc_stream_ms=sbc_wall,
               modulate_spec_ms=time_ms(lambda: DS.modulate_spec(
                   xc, st0, n_samples=T), reps))
    log(f"[oracle audio] {lanes} lanes: decode_stream_batched (8 lists of "
        f"8-15 mono frames) == SbcOracle on every lane ({sbc_wall:.1f} ms "
        f"host clock); modulate_spec, 2 calls of {T} samples with the state "
        f"carried == pdm_modulate on every lane ({out['modulate_spec_ms']:.3f}"
        f" ms a call); launches {counts} | {smi}")
    return out


def egress_phase(dev, url: str, lanes: int, smi: str, ticks: int = 16,
                 tapped: int = 16, depth: int = 16, seed: int = 0):
    """Phase 5e: serve_scenario --stage full --egress `tapped` at
    `lanes` lanes over the HTTP service, `ticks` ticks, a ring of
    `depth` ticks (no tick can drop): every full tick pushed and
    delivered, the field bytes of the tap geometry, and the pump's
    checksum the sum of the taps' field_sum + pdm_sum of the same run's
    TickResults."""
    import torch
    from espflix_tpu_torch.runtime.egress import EgressPump
    from espflix_tpu_torch.tools import serve_scenario as SS
    from espflix_tpu_torch.video.tables import Geometry

    fleet = build_native_fleet(url, lanes, 2, stage="full", device=dev)
    rs = record_results(fleet)
    tap_lanes = tuple(range(min(tapped, lanes)))
    pump = EgressPump(tick_interval=1.0 / 29.97, depth=depth)
    torch.cuda.synchronize()
    reset_counts()
    pump.start()
    try:
        stats, _ = SS.run_scenario(fleet, ticks, seed=seed,
                                   dispatch="full", tap_lanes=tap_lanes,
                                   egress=pump)
    finally:
        est = pump.finish()
    eg = SS.egress_summary(est, len(tap_lanes))
    counts = read_counts("egress", CHAIN_KERNELS)
    g = Geometry(fleet.pal)
    per_tick = len(tap_lanes) * 2 * g.line_count * g.line_width
    want = sum(int(r.field_sum[lane]) + int(r.pdm_sum[lane])
               for r in rs for lane in tap_lanes) & 0x7FFFFFFF
    tap_sums_match(rs, tap_lanes)
    problems = []
    if eg["pushed_ticks"] != stats.full_ticks or stats.full_ticks != ticks:
        problems.append(f"pushed {eg['pushed_ticks']} of {stats.full_ticks}"
                        f" full ticks ({ticks} run)")
    if eg["consumed_ticks"] + eg["dropped_ticks"] != eg["pushed_ticks"] \
            or eg["dropped_ticks"]:
        problems.append("consumed + dropped != pushed, or a drop")
    if eg["delivered_field_bytes"] != eg["consumed_ticks"] * per_tick:
        problems.append(f"{eg['delivered_field_bytes']} field bytes, not "
                        f"{eg['consumed_ticks']} x {per_tick}")
    if eg["checksum"] != want:
        problems.append(f"checksum {eg['checksum']} != taps' sums {want}")
    if problems:
        raise AssertionError("egress: " + "; ".join(problems))
    target = len(tap_lanes) * 2 * g.line_count * g.line_width * 29.97 / 1e6
    log(f"[egress] {lanes} lanes x {ticks} ticks over HTTP, {len(tap_lanes)} "
        f"tapped, ring depth {depth}: {json.dumps(eg)}; line rate "
        f"{eg['line_rate_MBps']} MB/s against {target:.1f} MB/s "
        f"({len(tap_lanes)} lanes x {target / len(tap_lanes):.2f} MB/s), "
        f"{eg['underrun_ticks']} underruns; serving "
        f"{1000 * stats.wall_s / ticks:.1f} ms/tick wall; launches {counts} "
        f"| {smi}")
    return eg


def router_phase(dev, smi: str, ticks: int = 6):
    """A 352x192 fleet with one 352x240 title: the lane parks
    (LANE_GEOMETRY), FleetRouter re-homes it, and the re-homed fleet
    (mb_height 15) decodes `ticks` ticks through K1F, K2F and K3F with
    the same planes, pts and flags as the same ticks through the plain
    forms.  Returns the kernel run's launch counts."""
    import numpy as np
    import torch
    from espflix_tpu_torch import build
    from espflix_tpu_torch.runtime.events import Ev
    from espflix_tpu_torch.runtime.player import PlayerSession
    from espflix_tpu_torch.runtime.router import FleetRouter
    from espflix_tpu_torch.runtime.scheduler import Fleet
    from espflix_tpu_torch.tools.indexer import make_service

    build.BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build.BUILD_ROOT) as svc:
        make_service(svc, ["tall"], seed=13, n_gops=2, gop=4, width=352,
                     height=240)
        runs = []
        for plain in (False, True):
            s = PlayerSession("file://" + svc)
            if not s.init_service():
                raise AssertionError("router: service unreachable")
            s.nav(0)
            s.play_pause()
            fleet = Fleet(1, words_per_lane=8192, device=dev)
            fleet.attach(0, s)
            r = fleet.tick(decode_audio=False)
            names = [e.ev for e in fleet.events.dump(10 ** 6)]
            if not r.errors[0] or Ev.LANE_GEOMETRY not in names \
                    or s.park_geometry != (352, 240):
                raise AssertionError("router: the 352x240 lane did not park")
            router = FleetRouter(fleet, lanes_per_fleet=1, fleet_kwargs=dict(
                words_per_lane=8192, device=dev))
            if router.route() != 1 or fleet.sessions[0] is not None:
                raise AssertionError("router: route() did not move the lane")
            tall = router.fleets[(352, 240)]
            torch.cuda.synchronize()
            reset_counts()
            with plain_forms() if plain else contextlib.nullcontext():
                rs = [tall.tick(decode_audio=False) for _ in range(ticks)]
            torch.cuda.synchronize()
            counts = {k: getattr(*c) for k, c in kernel_counters().items()}
            runs.append((rs, counts, tall))
    (rk, ck, tk), (rp, cp, _tp) = runs
    if any(cp.values()):
        raise AssertionError(f"router: the plain run launched kernels {cp}")
    if min(ck[k] for k in FLAT_KERNELS) < 1:
        raise AssertionError(f"router: K1F-K3F not all launched ({ck})")
    frames = 0
    for t, (a, b) in enumerate(zip(rk, rp)):
        for key in ("video_lanes", "pts", "errors"):
            if not np.array_equal(getattr(a, key), getattr(b, key)):
                raise AssertionError(f"router tick {t}: {key} kernel != plain")
        if a.errors[0]:
            raise AssertionError(f"router tick {t}: lane error")
        frames += int(a.video_lanes[0])
        require_equal(f"router tick {t} planes",
                      [(torch.from_numpy(a.y), torch.from_numpy(b.y)),
                       (torch.from_numpy(a.u), torch.from_numpy(b.u)),
                       (torch.from_numpy(a.v), torch.from_numpy(b.v))])
    if frames < 3:
        raise AssertionError(f"router: {frames} frames in {ticks} ticks")
    flat = {k: ck[k] for k in FLAT_KERNELS}
    log(f"[router] 352x240 lane parked, re-homed (mb {tk.mb_w}x{tk.mb_h}), "
        f"{frames} frames in {ticks} ticks, kernel path == plain path "
        f"(planes {tuple(rk[0].y.shape)}, pts, flags); launches {flat} | "
        f"{smi}")
    return flat


def play_phase(smi: str, frames: int = 8):
    """python -m espflix_tpu_torch.tools.play --field on the card for
    `frames` frames into a temporary directory: y/u/v planes and a field
    for each frame."""
    import os
    from pathlib import Path
    from espflix_tpu_torch import build

    root = str(Path(__file__).resolve().parent)
    env = dict(os.environ, PYTHONPATH=root)
    build.BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build.BUILD_ROOT) as tmp:
        svc, out = os.path.join(tmp, "svc"), os.path.join(tmp, "out")
        t0 = time.perf_counter()
        for argv in (["--make-service", svc],
                     ["--root", "file://" + svc, "--frames", str(frames),
                      "--field", "--out", out]):
            r = subprocess.run([sys.executable, "-m",
                                "espflix_tpu_torch.tools.play", *argv],
                               capture_output=True, text=True, cwd=root,
                               env=env, timeout=600)
            if r.returncode != 0:
                raise AssertionError(f"play {argv[0]}: {r.stderr[-1500:]}")
        names = sorted(os.listdir(out))
        want = sorted([f"frame{n:03d}_{p}.pgm" for n in range(frames)
                       for p in "yuv"] + [f"field{n:03d}.pgm"
                                          for n in range(frames)])
        if names != want:
            raise AssertionError(f"play: wrote {names[:6]}..., not "
                                 f"{len(want)} y/u/v/field files")
        size = os.path.getsize(os.path.join(out, "field000.pgm"))
    log(f"[play] python -m espflix_tpu_torch.tools.play --field on the card: "
        f"{frames} frames -> {len(names)} PGM files (a field {size} B) in "
        f"{time.perf_counter() - t0:.1f} s ({r.stdout.strip()}) | {smi}")


def run_tool(module: str, argv: list, timeout: int = 900):
    """python -m <module> <argv> from the checkout's root: (its last
    stdout line as JSON, its stderr lines, seconds); raises on a non-zero
    exit."""
    import os
    from pathlib import Path
    root = str(Path(__file__).resolve().parent)
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", module, *argv],
                       capture_output=True, text=True, cwd=root,
                       env=dict(os.environ, PYTHONPATH=root),
                       timeout=timeout)
    if r.returncode != 0:
        raise AssertionError(f"{module} {argv}: exit {r.returncode}: "
                             f"{r.stderr[-2000:]}")
    return (json.loads(r.stdout.strip().splitlines()[-1]),
            r.stderr.strip().splitlines(), time.perf_counter() - t0)


# phase B's bench runs: label, arguments, the route the line must name
BENCH_RUNS = (("defaults", [], "pallas"),
              ("scrolled", ["--scrolled", "--no-realtime"], "pallas"),
              ("device", ["--pipeline", "device", "--no-realtime"],
               "device"),
              ("hybrid", ["--pipeline", "hybrid", "--stage", "decode",
                          "--no-realtime"], "hybrid"))
# the kernels each in-process route must launch
ROUTE_CHECKS = (
    ("pallas full", ["--pipeline", "pallas"], CHAIN_KERNELS),
    ("pallas full scrolled", ["--pipeline", "pallas", "--scrolled"],
     CHAIN_KERNELS),
    ("pallas decode", ["--pipeline", "pallas", "--stage", "decode"],
     ("K1_slice_scan_dense", "K23_idct_compose_put")),
    ("device full", ["--pipeline", "device"],
     ("K1S_slice_scan_seq", "K2F_dequant_idct_flat",
      "K3F_predict_compose_put_flat", "K4_composite_field_pair",
      "K6_sbc_decode", "K5_pdm")),
    ("hybrid decode", ["--pipeline", "hybrid", "--stage", "decode"],
     ("K2F_dequant_idct_flat", "K3F_predict_compose_put_flat")))


def bench_phase(dev, smi: str, lanes: int = 16) -> dict:
    """B: the port's bench (espflix_tpu_torch/tools/bench.py).  First
    each route in-process at `lanes` lanes x 2 pictures: one chunk on
    the card, every kernel of the route launched, its checksum equal to
    the same builder's chunk on the CPU (the plain forms).  Then the
    bench as a user runs it, in subprocesses (BENCH_RUNS): exit 0, the
    line's backend cuda and its pipeline the route asked for.  Returns
    {label: the bench's last line}."""
    import torch
    from espflix_tpu_torch.tools import bench as TB
    for label, argv, names in ROUTE_CHECKS:
        args = TB.parse_args(["--pictures", "2", *argv])
        got = []
        for device in (dev, torch.device("cpu")):
            route = TB.make_builders(args, lanes, device)[args.pipeline]()
            if device.type == "cuda":
                torch.cuda.synchronize()
                reset_counts()
            t0 = time.perf_counter()
            _state, chk = route.chunk(route.init())
            got.append(int(chk))
            if device.type == "cuda":
                counts = read_counts(f"bench {label}", names)
            else:
                plain_s = time.perf_counter() - t0
        if got[0] != got[1]:
            raise AssertionError(f"bench {label}: card checksum {got[0]} "
                                 f"!= plain {got[1]}")
        log(f"[bench {label}] {lanes} lanes x 2 pictures: card checksum == "
            f"plain ({got[0]}; plain on the CPU {plain_s:.1f} s), "
            f"launches {counts}")
    lines = {}
    for label, argv, pipeline in BENCH_RUNS:
        line, err, secs = run_tool("espflix_tpu_torch.tools.bench",
                                   ["--verbose", *argv], timeout=600)
        got = (line.get("backend"), line.get("pipeline"))
        if got != ("cuda", pipeline):
            raise AssertionError(f"bench {label}: backend, pipeline {got} "
                                 f"(want cuda, {pipeline})")
        for e in err:
            log(f"[bench {label}] stderr: {e}")
        log(f"[bench {label}] {secs:.1f} s: {json.dumps(line)} | {smi}")
        lines[label] = line
    return lines


def stages_phase(dev, smi: str, lanes: int = 64) -> dict:
    """S: the port's stage timer (espflix_tpu_torch/tools/perf_stages.py).
    Every stage once at `lanes` lanes on the card (every kernel it
    stands for launched) and through the plain forms on the card: equal
    checksums.  Then the timer as a user runs it, in a subprocess, at
    1,024 lanes over every stage.  Returns its JSON line."""
    from espflix_tpu_torch.tools import perf_stages as TP
    d = TP.build_inputs(lanes, device=dev)
    stages = TP.make_stages(d)
    reset_counts()
    card = {name: int(fn(d, 0)) for name, fn in stages.items()}
    counts = read_counts("perf_stages", (
        "K2_dequant_idct", "K23_idct_compose_put",
        "K3F_predict_compose_put_flat", "K3P_predict",
        "K4_composite_field_pair", "K5_pdm", "K6_sbc_decode"))
    with plain_forms():
        plain = {name: int(fn(d, 0)) for name, fn in stages.items()}
    bad = [n for n in stages if card[n] != plain[n]]
    if bad:
        raise AssertionError(f"perf_stages: card != plain for {bad}")
    log(f"[stages] {len(stages)} stages at {lanes} lanes: card checksums "
        f"== plain forms on the card; launches {counts}")
    line, _err, secs = run_tool("espflix_tpu_torch.tools.perf_stages",
                                ["--lanes", "1024", "--iters", "8",
                                 "--reps", "3", "--json"])
    if set(line["stages"]) != set(stages) or line["backend"] != "cuda":
        raise AssertionError(f"perf_stages: {sorted(line['stages'])} on "
                             f"{line['backend']}")
    for name, st in line["stages"].items():
        log(f"[stages] {name:>24}: {st['ms_min']:8.3f} ms min "
            f"{st['ms_med']:8.3f} med  ({TP.STAGE_KERNELS[name]})")
    log(f"[stages] perf_stages --lanes 1024 in {secs:.1f} s: "
        f"{json.dumps(line)} | {smi}")
    return line


def pooled_phase(dev, url: str, file_url: str, lanes: int, smi: str,
                 big_lanes: int = 1024, ticks: int = 8,
                 big_ticks: int = 16) -> dict:
    """Phase 5p: Fleet.run_chunk_full_pooled with W = min(8, cores)
    host workers (runtime/hostpool.py) against in-process run_chunk_full
    on the same card and HTTP service, `ticks` ticks in chunks of 4:
    flags, pts, checksums, taps and audio flags equal; then the pool
    alone at `big_lanes` lanes for `big_ticks` ticks over file://
    (no HTTP server in this process), timed.  While each pool runs,
    nvidia-smi must list the contexts it listed before the pool started
    (this process's; nvidia-smi may name it in another pid namespace)
    and no worker's pid, and every worker must report
    CUDA_VISIBLE_DEVICES="" and no torch.  The pooled fleet's event log
    (the workers' admission and audio events, the parent's error and
    resync events) must equal the in-process fleet's.  Returns the
    256-lane pooled run's launch counts."""
    import os
    import numpy as np
    import torch
    from espflix_tpu_torch.runtime import telemetry
    from espflix_tpu_torch.runtime.hostpool import HostPool
    from espflix_tpu_torch.runtime.scheduler import Fleet

    cores = os.cpu_count() or 1
    W = min(8, cores)
    while lanes % W or big_lanes % W:
        W -= 1
    log(f"[pooled] W = {W} host workers (os.cpu_count() = {cores})")
    tap = (0, lanes // 2 + 1)
    keys = ("video_lanes", "pts", "errors", "audio_lanes", "audio_starved",
            "audio_errors", "field_sum", "pdm_sum", "tap_fields", "tap_pdm")

    def check_workers(label, pool):
        info = pool.info()
        pids = compute_app_pids()
        bad = [w for w in info if w["torch"] or w["cuda_visible"] != ""]
        if bad:
            raise AssertionError(f"{label}: workers {bad} imported torch or "
                                 "see a card")
        if sorted(pids) != sorted(pids_before) or \
                {str(w["pid"]) for w in info} & set(pids):
            raise AssertionError(f"{label}: CUDA contexts held by {pids}, "
                                 f"{pids_before} before the pool (this "
                                 f"process {os.getpid()}, workers "
                                 f"{[w['pid'] for w in info]})")
        return info, pids

    def events_of(fleet):
        return [(e.ev.name, e.lane, e.value)
                for e in fleet.events.dump(10 ** 6)]

    def run_pool(label, n, url_, n_ticks, tap_lanes):
        fleet = Fleet(n, words_per_lane=8192, parser="pallas",
                      output=True, device=dev)
        with HostPool(n, W, 8192, fleet.mb_w, fleet.mb_h) as pool:
            t0 = time.perf_counter()
            if not all(pool.attach_many(range(n), url_)):
                raise AssertionError(f"{label}: a lane's bootstrap failed")
            for i in range(n):
                pool.call(i, "nav", i % 2)
                pool.call(i, "play_pause")
            attach_s = time.perf_counter() - t0
            fleet.run_chunk_full_pooled(pool, 4, tap_lanes=tap_lanes)
            torch.cuda.synchronize()
            fleet.timers.acc.clear()
            reset_counts()
            worker_us = fleet.counters["pool.worker_us"]
            rs = []
            t0 = time.perf_counter()
            for _ in range(n_ticks // 4):
                rs += fleet.run_chunk_full_pooled(pool, 4,
                                                  tap_lanes=tap_lanes)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = read_counts(label, CHAIN_KERNELS)
            info, pids = check_workers(label, pool)
            start_s = pool.start_s
        # the slowest worker's own gather, the wait for every reply and
        # the join of the shards
        pt = {k: round(1000 * fleet.timers.acc[k] / n_ticks, 2)
              for k in ("pool_gather.wait", "pool_gather.join")}
        pt["worker"] = round(
            (fleet.counters["pool.worker_us"] - worker_us) / 1e3 / n_ticks, 2)
        split = {k: round(1000 * v / n_ticks, 2) for k, v in
                 telemetry.top_level(fleet.timers.acc).items()}
        frames = sum(int(r.video_lanes.sum()) for r in rs)
        errors = sum(int(r.errors.sum()) for r in rs)
        if frames < n or errors:
            raise AssertionError(f"{label}: {frames} frames, {errors} "
                                 "lane errors")
        tap_sums_match(rs, tap_lanes)
        rss = [w.get("vmhwm_kib", w.get("vmrss_kib")) for w in info]
        log(f"[{label}] {n} lanes x {n_ticks} ticks (after a 4-tick "
            f"warm-up), W = {W}: {1000 * wall / n_ticks:.2f} ms/tick wall "
            f"(33.3 ms is one tick at 30 fps); timers ms/tick {split}; "
            f"untimed {1000 * wall / n_ticks - sum(split.values()):.2f} "
            f"ms/tick; pool ms/tick {pt}; frames "
            f"{frames}; workers up in {start_s:.2f} s, "
            f"attach {attach_s:.1f} s, worker RSS (peak, else now) "
            f"{rss} KiB ({info[0]}), "
            f"torch in no worker, CUDA_VISIBLE_DEVICES=''; nvidia-smi "
            f"compute-app pids {pids}, as before the pool (this process "
            f"{os.getpid()} here); "
            f"launches {counts} | {smi}")
        return rs, counts, events_of(fleet)

    # the in-process reference at the same lanes, same service
    ref_fleet = build_native_fleet(url, lanes, 2, stage="full", device=dev)
    ref_fleet.run_chunk_full(4, tap_lanes=tap)
    torch.cuda.synchronize()
    pids_before = compute_app_pids()
    if len(pids_before) != 1:
        raise AssertionError(f"pooled: {pids_before} hold CUDA contexts "
                             "before the pool starts; expected this "
                             "process alone")
    ref_fleet.timers.acc.clear()
    t0 = time.perf_counter()
    ref = []
    for _ in range(ticks // 4):
        ref += ref_fleet.run_chunk_full(4, tap_lanes=tap)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    split = {k: round(1000 * v / ticks, 2) for k, v in
             telemetry.top_level(ref_fleet.timers.acc).items()}
    log(f"[pooled] in-process run_chunk_full {lanes} lanes x {ticks} ticks "
        f"(after a 4-tick warm-up) over HTTP: {1000 * wall / ticks:.2f} "
        f"ms/tick wall; timers ms/tick {split}; untimed "
        f"{1000 * wall / ticks - sum(split.values()):.2f} ms/tick | {smi}")
    got, counts, ev_got = run_pool(f"pooled {lanes}", lanes, url, ticks,
                                   tap)
    if len(got) != len(ref):
        raise AssertionError("pooled: tick counts differ")
    for t, (a, b) in enumerate(zip(ref, got)):
        for key in keys:
            if not np.array_equal(np.asarray(getattr(a, key)),
                                  np.asarray(getattr(b, key))):
                raise AssertionError(f"pooled tick {t}: {key} pooled != "
                                     "in-process")
    ev_ref = events_of(ref_fleet)
    if ev_got != ev_ref:
        raise AssertionError(f"pooled: events {ev_got[:8]} != in-process "
                             f"{ev_ref[:8]}")
    log(f"[pooled] {lanes} lanes x {ticks} ticks: pooled == in-process "
        f"({len(keys)} TickResult fields x {ticks}, taps {tap}; "
        f"{len(ev_ref)} events)")
    run_pool(f"pooled {big_lanes}", big_lanes, file_url, big_ticks, (0,))
    log(f"[pooled] a worker importing torch would cost "
        f"{torch_worker_cost()} (fresh interpreter, CUDA_VISIBLE_DEVICES='')")
    return counts


def hybrid_phase(dev, url: str, lanes: int, smi: str, ticks: int = 8,
                 seed: int = 0):
    """Phase 7h: the decode-only Fleet(parser="hybrid") -- the native
    tokenizer on the host, K2F and K3F on the card -- against
    Fleet(parser="device") on the same streams and scenario (no faults:
    a corrupt picture's partial decode is each parser's own), `ticks`
    ticks pipelined: YUV planes and error flags equal; K2F and K3F
    launched."""
    import numpy as np
    import torch
    from espflix_tpu_torch.tools import oracle
    from espflix_tpu_torch.tools import serve_scenario as SS

    if not oracle.available():
        raise AssertionError("hybrid: the tokenizer library did not build")
    runs = []
    for parser in ("hybrid", "device"):
        fleet = build_native_fleet(url, lanes, 2, device=dev, parser=parser)
        if fleet.parser != parser:
            raise AssertionError(f"hybrid: the fleet runs {fleet.parser}")
        rs = record_results(fleet, "tick_collect")
        torch.cuda.synchronize()
        reset_counts()
        stats, _ = SS.run_scenario(fleet, ticks, seed=seed, faults=0,
                                   dispatch="pipelined")
        torch.cuda.synchronize()
        counts = read_counts(f"hybrid ({parser})", FLAT_KERNELS[1:])
        tm = {k: round(1000 * v / ticks, 2)
              for k, v in fleet.timers.acc.items()}
        log(f"[hybrid] {parser} parser, {lanes} lanes x {ticks} ticks "
            f"pipelined over HTTP: {1000 * stats.wall_s / ticks:.1f} "
            f"ms/tick wall; timers ms/tick {tm} (the hybrid's "
            f"device_decode holds the host tokenizer); frames "
            f"{stats.frames}, errors {stats.errors}; launches {counts} "
            f"| {smi}")
        runs.append(rs)
    rh, rd = runs
    if len(rh) != ticks or len(rd) != ticks:
        raise AssertionError(f"hybrid: expected {ticks} TickResults")
    for t, (a, b) in enumerate(zip(rh, rd)):
        for key in ("video_lanes", "pts", "errors"):
            if not np.array_equal(getattr(a, key), getattr(b, key)):
                raise AssertionError(f"hybrid tick {t}: {key} hybrid != "
                                     "device parser")
        require_equal(f"hybrid tick {t} planes",
                      [(a.y, b.y), (a.u, b.u), (a.v, b.v)])
    if sum(int(r.video_lanes.sum()) for r in rh) < lanes:
        raise AssertionError("hybrid: too few frames decoded")
    log(f"[hybrid] {lanes} lanes x {ticks} ticks: hybrid == device parser "
        "(YUV planes, flags and pts of every tick)")


def predict_seq_kernels(x_p, x_i_pics, wpl: int, chain, rand_frames,
                        reps: int, mbw: int, mbh: int, dev,
                        clock_hz: float) -> list:
    """K3P and K1S against their plain versions at the bench tick's
    1,024 lanes: K3P over the y, u and v planes (predict_plane for y,
    predict_chroma_pair for u and v: two launches, as the mesh's decoder
    makes them) with the vectors of the P-heavy tick
    `x_p` and with random vectors past every edge, rule A over whole
    planes and rule B over a band of MB rows 3-8; K1S over the pictures
    of the I-heavy tick `x_i_pics`, then over the same pictures with
    faults (seq_faulted).  Returns their kernel entries."""
    import torch
    from espflix_tpu_torch.models import mpeg1 as M
    from espflix_tpu_torch.ops import mocomp as MC
    from espflix_tpu_torch.ops import vlc_scan as VS
    from espflix_tpu_torch.runtime import chain as CH

    out = []
    N = x_p["active"].shape[0]
    ckw = dict(mb_width=mbw, mb_height=mbh, n_lanes=N,
               long_rows=min(2 * N, N * mbh // 2), steps_long=1024,
               steps_short=384, chunk=128, lut=chain.scan_lut,
               zigzag=chain.zigzag)
    recs = VS.run_scan_bucketed_dense(
        *[x_p[k] for k in CH.DECODE_KEYS[:9]], **ckw)[1]
    _kind, mv_h, mv_v = MC.mb_fields(recs, mbw, mbh)
    fr = rand_frames()
    lanes = torch.arange(N, device=dev)
    refs = [fr[k][lanes, 1 - fr["parity"].long()].contiguous()
            for k in "yuv"]
    sizes = (16, 8, 8)

    def scaled(mh, mv):
        return [(mh, mv), (mh >> 1, mv >> 1), (mh >> 1, mv >> 1)]

    def run(plane, pair, mvs):
        return [plane(refs[0], *mvs[0], 16), *pair(*refs[1:], *mvs[1])]

    def run_band(fn, mvs, row0=3, rows=6):
        return [fn(r, mh[:, row0:row0 + rows].contiguous(),
                   mv[:, row0:row0 + rows].contiguous(), S, row0)
                for r, (mh, mv), S in zip(refs, mvs, sizes)]

    mvs = scaled(mv_h, mv_v)
    g = torch.Generator(device="cpu").manual_seed(11)
    rnd = scaled(*(torch.randint(-48, 49, mv_h.shape, generator=g,
                                 dtype=torch.int32).to(dev)
                   for _ in range(2)))
    kernel = (MC.predict_plane, MC.predict_chroma_pair)
    plain = (MC.predict_plane_torch, MC.predict_chroma_pair_torch)
    preds = run(*kernel, mvs)
    err = require_equal("K3P rule A", zip(preds, run(*plain, mvs)))
    err = max(err, require_equal(
        "K3P rule A, vectors past the edges",
        zip(run(*kernel, rnd), run(*plain, rnd))))
    err = max(err, require_equal(
        "K3P rule B, band of MB rows 3-8",
        zip(run_band(MC.predict_plane_rows, rnd),
            run_band(MC.predict_plane_rows_torch, rnd))))
    err = max(err, predict_edge_case(dev, mbw, mbh, N - 3))
    out.append(dict(
        name="K3P_predict", route="cuda",
        source="espflix_tpu_torch/csrc/compose.cu",
        replaces="espflix_tpu/ops/mocomp_pallas.py:47,350,501,613,747",
        max_abs_err=err, library_ms=None,
        **timed(lambda: run(*kernel, mvs), reps),
        plain_ms=time_ms(lambda: run(*plain, mvs), reps)))
    # bound: the reference bytes every MB's window reads (rule A, each
    # byte once), the predictions and the vectors the call reads (u and
    # v share one chroma pair)
    every = torch.ones_like(mv_h, dtype=torch.bool)
    W, H = 16 * mbw, 16 * mbh
    vectors = [*mvs[0], *mvs[1]]
    out[-1]["bound_ms"], out[-1]["bound_by"] = bound(
        ref_window_bytes(mv_h, mv_v, every, 16, W, H)
        + 2 * ref_window_bytes(mv_h >> 1, mv_v >> 1, every, 8, W // 2,
                               H // 2) + nbytes(*vectors, *preds))
    out[-1]["yardstick_ms"] = bound(nbytes(*refs, *vectors, *preds))[0]
    band_edge = [float(rule_b_edge_mbs(mh, mv, S)[:, 3:9].float().mean())
                 for (mh, mv), S in zip(rnd, sizes)]
    log(f"[kernel] {out[-1]} (y, then u and v in one launch; the rule-B "
        f"band's MBs on the byte path, y / u / v: {band_edge})")

    b = M.make_picture_batch(x_i_pics, words_per_lane=wpl, max_slices=mbh)
    xs = list(M.xs_to_torch({k: b[k] for k in M.PICTURE_KEYS[:7]},
                            dev).values())
    skw = dict(mb_width=mbw, mb_height=mbh, max_steps=12000,
               lut=chain.scan_lut, zigzag=chain.zigzag)
    got = VS.run_scan(*xs, **skw)
    ref, plain_ms = run_timed(lambda: VS.run_scan_torch(*xs, **skw))
    err = require_equal("K1S scan", zip(got, ref))
    if got[3].any():
        raise AssertionError("K1S: lane errors on well-formed content")
    # the two passes alone; the first's reports give the chain bound's
    # longest slice, and the second's resolution equals its plain form
    akw = dict(mb_width=mbw, mb_height=mbh, budget=12000,
               lut=chain.scan_lut, zigzag=chain.zigzag)
    parts = VS.scan_slices_cuda(*xs, **akw)
    longest = int(parts[3].max())
    fin = VS.finish_slices_cuda(*xs, *parts, **akw)
    plain_res = VS.resolve_slices(*parts[3:], xs[3], 12000)
    require_equal("K1S resolution", [(fin[3], plain_res[0]),
                                     (fin[4], plain_res[1].max()),
                                     (fin[5], plain_res[2])])
    # where the first pass's time goes: its longest slice alone (one
    # thread), that slice's lane alone (one warp), all lanes
    lane = int(parts[3].max(dim=1).values.argmax())
    k = int(parts[3][lane].argmax())
    one_lane = [t[lane:lane + 1].clone() for t in xs]
    one_slice = [t.clone() for t in one_lane]
    one_slice[1][0, 0], one_slice[2][0, 0] = xs[1][lane, k], xs[2][lane, k]
    one_slice[3][0] = 1
    split_ms = {k: time_ms(fn, reps, busy=True) for k, fn in dict(
        pass_a=lambda: VS.scan_slices_cuda(*xs, **akw),
        pass_a_its_lane=lambda: VS.scan_slices_cuda(*one_lane, **akw),
        pass_a_longest_slice=lambda: VS.scan_slices_cuda(*one_slice, **akw),
        pass_b=lambda: VS.finish_slices_cuda(*xs, *parts, **akw)).items()}
    out.append(dict(
        name="K1S_slice_scan_seq", route="cuda",
        source="espflix_tpu_torch/csrc/scan.cu",
        replaces="espflix_tpu/ops/vlc_scan.py:662 (XLA run_scan; no "
                 "Pallas kernel)",
        max_abs_err=err, library_ms=None,
        **timed(lambda: VS.run_scan(*xs, **skw), reps),
        plain_ms=plain_ms))
    out[-1]["bound_ms"], out[-1]["bound_by"] = bound(nbytes(
        *xs, VS.compact_lut(chain.scan_lut), chain.zigzag, *got),
        scan_chain_ms(longest, clock_hz))
    log(f"[kernel] {out[-1]} ({int(got[4])} steps, words/lane "
        f"{xs[0].shape[1]}, {int(b['n_slices'].sum())} slices; chain: the "
        f"longest slice's {longest} steps x {SCAN_STEP_CYCLES} cycles; "
        f"device ms of the parts {split_ms})")
    out[-1]["max_abs_err"] = max(err, seq_faulted(b, dev, chain, reps, mbw,
                                                  mbh))
    torch.cuda.synchronize()
    return out


def seq_faulted(b: dict, dev, chain, reps: int, mbw: int, mbh: int,
                budget: int = 3000) -> int:
    """K1S at 1,024 lanes on the I-heavy tick's pictures `b` with faults:
    slice 5 of every 16th lane corrupt (its later slices never run), every
    64th lane idle, and a budget that cuts the longer pictures inside a
    later slice; held equal to run_scan_torch.  Logs the lanes in error,
    the lanes cut inside slice 1 or later, and the lanes the in-order
    pass (pass B) took.  Returns the max |err|."""
    import numpy as np
    import torch
    from espflix_tpu_torch.models import mpeg1 as M
    from espflix_tpu_torch.ops import vlc_scan as VS
    from espflix_tpu_torch.tools.serve_scenario import corrupt_slice

    bf = {k: np.copy(v) if isinstance(v, np.ndarray) else v
          for k, v in b.items()}
    corrupt = [i for i in range(3, len(bf["words"]), 16)
               if bf["n_slices"][i] > 6]
    for i in corrupt:
        corrupt_slice(bf, i, 5)
    bf["n_slices"][7::64] = 0
    xs = list(M.xs_to_torch({k: bf[k] for k in M.PICTURE_KEYS[:7]},
                            dev).values())
    skw = dict(mb_width=mbw, mb_height=mbh, max_steps=budget,
               lut=chain.scan_lut, zigzag=chain.zigzag)
    got = VS.run_scan(*xs, **skw)
    ref, plain_ms = run_timed(lambda: VS.run_scan_torch(*xs, **skw))
    err = require_equal("K1S scan with faults", zip(got, ref))
    akw = dict(mb_width=mbw, mb_height=mbh, budget=budget,
               lut=chain.scan_lut, zigzag=chain.zigzag)
    parts = VS.scan_slices_cuda(*xs, **akw)
    steps, end, lo, hi = parts[3:]
    redo = VS.finish_slices_cuda(*xs, *parts, **akw)[5]
    require_equal("K1S resolution with faults", [
        (redo, VS.resolve_slices(steps, end, lo, hi, xs[3], budget)[2])])
    live = torch.arange(steps.shape[1], device=dev)[None, :] < xs[3][:, None]
    s = torch.where(live, steps, 0).long()
    c = torch.cumsum(s, dim=1) - s
    clean = torch.cummin(((end == VS.END_CLEAN) | ~live).int(), dim=1).values
    entered = torch.cat([torch.ones_like(clean[:, :1]), clean[:, :-1]],
                        dim=1).bool() & (c < budget)
    cut_later = (entered & (c + s > budget))[:, 1:].any(dim=1)
    n_redo, n_cut, n_err = (int(t.sum()) for t in (redo, cut_later, got[3]))
    if not (n_redo and n_cut and n_err) or got[3][7::64].any():
        raise AssertionError(
            f"K1S with faults: {n_err} lanes in error, {n_cut} cut inside "
            f"a later slice, {n_redo} through pass B, idle lanes "
            f"{got[3][7::64].tolist()}")
    log(f"[kernel] K1S with faults ({len(bf['words'])} lanes, budget "
        f"{budget}): kernel == plain; {len(corrupt)} lanes with a corrupt "
        f"slice 5, {len(bf['words'][7::64])} idle, {n_cut} cut inside slice "
        f"1 or later; {n_err} lanes in error, {n_redo} through pass B; "
        f"ms {time_ms(lambda: VS.run_scan(*xs, **skw), reps):.3f}, plain "
        f"{plain_ms:.1f}")
    return err


def mesh_devices(n: int):
    """n devices for an n-shard mesh: one card each when n cards are
    visible, else cuda:0 n times; and how, in words."""
    import torch
    k = torch.cuda.device_count()
    if k >= n:
        return ([torch.device("cuda", i) for i in range(n)],
                f"{n} cards, one shard each")
    return ([torch.device("cuda", 0)] * n,
            f"cuda:0 {n} times ({k} card visible)")


def sync_all():
    """Wait for every visible card (a mesh may span several)."""
    import torch
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


def require_same_results(label, rk, rp, keys):
    """Raise unless two runs' TickResults agree in `keys`."""
    import numpy as np
    import torch
    if len(rk) != len(rp) or not rk:
        raise AssertionError(f"{label}: {len(rk)} vs {len(rp)} results")
    for t, (a, b) in enumerate(zip(rk, rp)):
        for key in keys:
            x, y = getattr(a, key), getattr(b, key)
            if isinstance(x, torch.Tensor):
                require_equal(f"{label} tick {t} {key}", [(x, y)])
            elif not np.array_equal(x, y):
                raise AssertionError(f"{label} tick {t}: {key} differs")
    return len(rk) * len(keys)


def mesh_phase(dev, url: str, lanes: int, smi: str, ticks: int = 8,
               seed: int = 0) -> dict:
    """Phase 8: the fleet under a 4-shard 'streams' mesh against the
    unsharded fleet on the same service, then the 'space' split.
    Returns the launch counts of the mesh runs."""
    import numpy as np
    import torch
    from espflix_tpu_torch.models import mpeg1 as M
    from espflix_tpu_torch.ops import mocomp as MC
    from espflix_tpu_torch.ops import vlc_scan as VS
    from espflix_tpu_torch.parallel import mesh as PM
    from espflix_tpu_torch.tools import mpeg1_encode as E
    from espflix_tpu_torch.tools import serve_scenario as SS
    from espflix_tpu_torch.tools.content import realistic_gop_script

    devices, how = mesh_devices(4)
    mesh = PM.make_mesh(4, devices=devices)
    log(f"[mesh] 4-shard 'streams' mesh on {how}; {lanes} lanes over "
        f"HTTP, {ticks} ticks a run")
    counts = {}

    def joined(fleet, x):
        return PM.unshard(fleet.mesh, x, PM.LANES) \
            if isinstance(x, PM.Sharded) else x

    keys = ("video_lanes", "pts", "errors", "audio_lanes", "pcm",
            "pcm_samples", "audio_starved", "audio_errors", "y", "u", "v")
    for parser, kernels in (("pallas", MESH_PALLAS_KERNELS),
                            ("device", MESH_DEVICE_KERNELS)):
        for dispatch, method in (("pipelined", "tick_collect"),
                                 ("chunk", "run_chunk")):
            # under a mesh the device parser's run_chunk decodes tick by
            # tick, as the JAX fleet's does, so a fault's resync lands a
            # tick before the unsharded chunk's: that pair runs clean
            faults = 0 if (parser, dispatch) == ("device", "chunk") else 1
            runs = []
            for m in (None, mesh):
                fleet = build_native_fleet(url, lanes, 2, device=dev,
                                       parser=parser, mesh=m)
                rs = record_results(fleet, method)
                sync_all()
                reset_counts()
                stats, _ = SS.run_scenario(fleet, ticks, seed=seed,
                                           faults=faults, dispatch=dispatch)
                sync_all()
                if m is not None:
                    c = read_counts(f"mesh {parser} {dispatch}", kernels)
                    for k, v in c.items():
                        counts[k] = counts.get(k, 0) + v
                runs.append((fleet, rs, stats))
            (fu, ru, su), (fm, rm, sm) = runs
            n_cmp = require_same_results(f"mesh {parser} {dispatch}", rm,
                                         ru, keys)
            require_equal(f"mesh {parser} {dispatch} carries",
                          [(joined(fm, fm.frames[k]), fu.frames[k])
                           for k in ("y", "u", "v", "parity")]
                          + [(fm.sbc_state, fu.sbc_state)])
            log(f"[mesh {parser} {dispatch}] {lanes} lanes x {ticks} "
                f"ticks: mesh == unsharded ({n_cmp} TickResult fields + 5 "
                f"carries); ms/tick mesh "
                f"{1000 * sm.wall_s / ticks:.1f}, unsharded "
                f"{1000 * su.wall_s / ticks:.1f}; frames {sm.frames}, "
                f"errors {sm.errors}, resyncs {sm.resyncs} | {smi}")

    # the mesh path's own K3P and K1S calls against their plain forms
    # (the fault lands on tick 2)
    for parser, name in (("pallas", "K3P_predict"),
                         ("device", "K1S_slice_scan_seq")):
        fleet = build_native_fleet(url, lanes, 2, device=dev, parser=parser,
                               mesh=mesh)
        seen = {}
        t0 = time.perf_counter()
        with checked_calls(seen):
            stats, _ = SS.run_scenario(fleet, 3, seed=seed, faults=1,
                                       dispatch="pipelined")
        sync_all()
        s = seen.get(name, {})
        if not s.get("checked"):
            raise AssertionError(f"mesh {parser}: no {name} call checked")
        log(f"[mesh {parser} checked] {lanes} lanes x 3 ticks: {name} == "
            f"plain form in {s['checked']} of its {s['calls']} calls on "
            f"the mesh path ({s['errored']} of them with a lane in error; "
            f"the run's errors {stats.errors}), "
            f"{time.perf_counter() - t0:.1f} s with the checks")

    # run_chunk_full under the mesh, one tapped lane
    tap = (lanes // 2 + 1,)
    runs = []
    for m in (None, mesh):
        fleet = build_native_fleet(url, lanes, 2, stage="full", device=dev,
                               mesh=m)
        rs = record_results(fleet)
        sync_all()
        reset_counts()
        stats, _ = SS.run_scenario(fleet, ticks, seed=seed, faults=1,
                                   tap_lanes=tap, dispatch="full")
        sync_all()
        if m is not None:
            full_counts = read_counts("mesh full chain", CHAIN_KERNELS)
        runs.append((fleet, rs, stats))
    (fu, ru, su), (fm, rm, sm) = runs
    n_cmp = require_same_results(
        "mesh full chain", rm, ru,
        ("video_lanes", "pts", "errors", "audio_lanes", "audio_starved",
         "audio_errors", "field_sum", "pdm_sum", "tap_fields", "tap_pdm",
         "y", "u", "v"))
    require_equal("mesh full chain carries",
                  [(joined(fm, fm.frames[k]), fu.frames[k])
                   for k in ("y", "u", "v", "parity")]
                  + [(joined(fm, fm.sbc_state), fu.sbc_state),
                     (joined(fm, fm.output.pdm_state), fu.output.pdm_state)])
    tap_sums_match(rm, tap)
    log(f"[mesh full chain] {lanes} lanes x {ticks} ticks in chunks of 4, "
        f"tap {tap}: mesh == unsharded ({n_cmp} TickResult fields + 6 "
        f"carries); ms/tick mesh {1000 * sm.wall_s / ticks:.1f}, "
        f"unsharded {1000 * su.wall_s / ticks:.1f}; launches "
        f"{full_counts} | {smi}")

    # the 'space' split on a P picture decoded after its I picture
    smesh = PM.make_space_mesh(2, 2, devices=devices)
    streams = [M.parse_es(E.encode_es(realistic_gop_script(
        np.random.default_rng(2000 + s), n_pictures=2)))[1]
        for s in range(8)]
    mbw, mbh = streams[0][0].seq.mb_width, streams[0][0].seq.mb_height
    tables = M.decode_tables(dev)
    frames = M.init_frame_state(lanes, mbw * 16, mbh * 16, dev)
    for k in range(2):
        b = M.make_picture_batch([streams[i % 8][k] for i in range(lanes)],
                                 max_slices=mbh)
        x = M.xs_to_torch({key: b[key] for key in M.PICTURE_KEYS}, dev)
        if k == 0:
            frames, _p, info = M.decode_picture_batch(
                *x.values(), frames, mb_width=mbw, mb_height=mbh,
                max_steps=12000, tables=tables)
    if set(b["pic_type"]) != {2} or info["error"].any():
        raise AssertionError("space split: expected clean I then P pictures")
    coeffs, recs, nfinal, err, _it = VS.run_scan(
        *[x[key] for key in M.PICTURE_KEYS[:7]], mb_width=mbw,
        mb_height=mbh, max_steps=12000, lut=tables["lut"],
        zigzag=tables["zigzag"])
    lane_args = [x[key] for key in ("intra_q", "non_intra_q", "active")]
    fr_a = {key: v.clone() for key, v in frames.items()}
    fr_c = {key: v.clone() for key, v in frames.items()}
    idx = torch.arange(lanes, device=dev)
    refs = [fr_a[key][idx, 1 - fr_a["parity"].long()] for key in "yuv"]
    with plain_forms():
        fr_a, pres_a = M.dense_compose_unfused(
            coeffs, recs, nfinal, *lane_args, fr_a, mb_width=mbw,
            mb_height=mbh, transposed=False, ref_planes=refs,
            scale_dct=tables["scale_dct"])
    _fr, pres_c = M.dense_compose_flat(
        coeffs, recs, nfinal, *lane_args, fr_c, mb_width=mbw,
        mb_height=mbh, scale_dct=tables["scale_dct"])
    dense = PM.make_space_sharded_dense(smesh, mb_width=mbw, mb_height=mbh)
    fr_b = {key: v.clone() for key, v in frames.items()}
    sync_all()
    reset_counts()
    t0 = time.perf_counter()
    fr_b, pres_b = dense(coeffs.reshape(lanes, mbh, mbw * 384),
                         recs.reshape(lanes, mbh, mbw),
                         nfinal.reshape(lanes, mbh, mbw * 6), *lane_args,
                         fr_b)
    sync_all()
    space_ms = 1000 * (time.perf_counter() - t0)
    space_counts = read_counts("space split", ("K3P_predict",
                                               "K2F_dequant_idct_flat"))
    fspec = PM.frames_specs()
    require_equal("space split", [
        (PM.unshard(smesh, pres_b[key], PM.PRESENTED), pres_a[key])
        for key in "yuv"] + [
        (PM.unshard(smesh, fr_b[key], fspec[key]), fr_a[key])
        for key in ("y", "u", "v", "parity")])
    rule_diff = sum(int((pres_c[key] != pres_a[key]).sum()) for key in "yuv")
    _kind, mv_h, mv_v = MC.mb_fields(recs, mbw, mbh)
    edge_share = [float(rule_b_edge_mbs(mh, mv, S).float().mean())
                  for mh, mv, S in ((mv_h, mv_v, 16),
                                    (mv_h >> 1, mv_v >> 1, 8))]
    log(f"[mesh space] 2 x 2 (streams, space) mesh, {lanes} lanes of a P "
        f"picture: sharded (K2F, K3P rule B) == the unsharded band form "
        f"through the plain forms in presented planes and frames; "
        f"{space_ms:.1f} ms for the call; launches "
        f"{space_counts}; rule A (the fleet's dense_compose_flat) differs "
        f"from rule B in {rule_diff} presented pixels of this picture; "
        f"K3P's byte path takes {edge_share} of its MBs (luma, chroma)")
    return counts


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
    from espflix_tpu_torch.streaming import native_feed as NF
    from espflix_tpu_torch.tools import oracle as ORC
    from espflix_tpu_torch.runtime.workload import (bench_chunk,
                                                    bench_pictures)

    # ---- 2. build -------------------------------------------------------
    t0 = time.perf_counter()
    build.library()
    log(f"[build] {build.library_path()} in "
        f"{time.perf_counter() - t0:.1f} s (nvcc "
        f"{'%.1f s' % build.build_seconds if build.build_seconds else 'cached'}"
        f", {len([p for p in build.sources() if p.suffix == '.cu'])} "
        "sources in parallel)")
    for entry in build.RESOURCES:
        log(f"[resources] {entry} (cudaFuncGetAttributes): "
            f"{build.resources(entry)}")
    # the sessions' TS demuxer (native/ts_demux.cpp) builds at its first
    # use; build it here so that the timed serving phase does not
    t0 = time.perf_counter()
    if not (SE.native_demux_available() and NF.available()):
        raise AssertionError("the native library (native/) did not build: "
                             "no native TS demuxer or session feed")
    log(f"[build] native TS demuxer and session feed ready in "
        f"{time.perf_counter() - t0:.1f} s")
    # the hybrid parser's tokenizer (oracle/*.cpp with the port's
    # vlc_luts.h, built into build/oracle-<hash>/)
    t0 = time.perf_counter()
    if not ORC.available():
        raise AssertionError("the tokenizer library did not build")
    log(f"[build] tokenizer {ORC.library_path()} in "
        f"{time.perf_counter() - t0:.1f} s")

    # ---- workload --------------------------------------------------------
    t0 = time.perf_counter()
    xs_np, kw, _ = bench_chunk(args.lanes)
    bench_ticks, wpl = bench_pictures(args.lanes)
    xs_np_w, kw_w, _ = bench_chunk(args.lanes, win=True)
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
    ref, plain_ms = run_timed(lambda: VS.run_scan_bucketed_dense_torch(
        *scan_args, **scan_kw))
    err = require_equal("K1 scan", zip(got, ref))
    if got[3].any():
        raise AssertionError("K1: lane errors on well-formed content")
    kernels.append(dict(
        name="K1_slice_scan_dense", route="cuda",
        source="espflix_tpu_torch/csrc/scan.cu",
        replaces="espflix_tpu/ops/vlc_scan_pallas.py:55",
        max_abs_err=err, library_ms=None,
        **timed(lambda: VS.run_scan_bucketed_dense(*scan_args, **scan_kw),
                args.reps),
        plain_ms=plain_ms))
    kernels[-1]["bound_ms"], kernels[-1]["bound_by"] = bound(nbytes(
        *scan_args, VS.compact_lut(chain.scan_lut), chain.zigzag, *got),
        scan_chain_ms(int(got[4]), sm_clock_hz))
    log(f"[kernel] {kernels[-1]} (chain: the longest row's {int(got[4])} "
        f"steps x {SCAN_STEP_CYCLES} cycles)")

    coeffs_T, recs, nfinal = got[:3]
    res_k, k2_i = idct_T_check("I", coeffs_T, recs, nfinal, x, chain,
                               args.reps)

    # K3 on K2's output of the I-heavy tick, then of the P-heavy one,
    # with random reference planes and parities
    g = torch.Generator(device="cpu").manual_seed(5)

    def rand_frames():
        fr = M.init_frame_state(N, mbw * 16, mbh * 16, dev)
        for k in "yuv":
            fr[k] = torch.randint(0, 249, fr[k].shape, generator=g,
                                  dtype=torch.uint8).to(dev)
        fr["parity"] = torch.randint(0, 2, (N,), generator=g,
                                     dtype=torch.int32).to(dev)
        return fr

    k_p = int(n_i.argmin())
    x_p = {k: v[k_p] for k, v in xs.items()}
    active = x["active"].clone()
    active[::17] = False                       # some inactive lanes
    pk, k3_i = compose_check("K3 compose (I tick)", MC.predict_compose_put,
                             MC.predict_compose_put_torch, res_k, recs,
                             active, rand_frames, mbw, mbh, args.reps)
    coeffs_p, recs_p, nfinal_p = VS.run_scan_bucketed_dense(
        *[x_p[k] for k in CH.DECODE_KEYS[:9]], **scan_kw)[:3]
    res_k_p, k2_p = idct_T_check("P", coeffs_p, recs_p, nfinal_p, x_p,
                                 chain, args.reps)
    kernels.append(dict(
        name="K2_dequant_idct", route="cuda",
        source="espflix_tpu_torch/csrc/idct.cu",
        replaces="espflix_tpu/ops/idct_pallas.py:171", library_ms=None,
        **k2_i, **p_tick_keys(k2_p)))
    kernels[-1]["max_abs_err"] = max(k2_i["max_abs_err"],
                                     k2_p["max_abs_err"])
    log(f"[kernel] {kernels[-1]}")
    active_p = x_p["active"].clone()
    active_p[::17] = False
    _pk, k3_p = compose_check("K3 compose (P tick)", MC.predict_compose_put,
                              MC.predict_compose_put_torch, res_k_p, recs_p,
                              active_p, rand_frames, mbw, mbh, args.reps)
    kernels.append(dict(
        name="K3_predict_compose_put", route="cuda",
        source="espflix_tpu_torch/csrc/compose.cu",
        replaces="espflix_tpu/ops/mocomp_pallas.py:975,1084",
        library_ms=None, **k3_i, **p_tick_keys(k3_p)))
    kernels[-1]["max_abs_err"] = max(k3_i["max_abs_err"],
                                     k3_p["max_abs_err"])
    log(f"[kernel] {kernels[-1]}")
    # K23 (the chain's K2 + K3 in one pass) against the split pair, on
    # both ticks' levels
    k23_i, k23_p = (fused_check(label, *lev, xt, act, rand_frames, chain,
                                mbw, mbh, args.reps)
                    for label, lev, xt, act in (
                        ("I", (coeffs_T, recs, nfinal), x, active),
                        ("P", (coeffs_p, recs_p, nfinal_p), x_p, active_p)))
    kernels.append(dict(
        name="K23_idct_compose_put", route="cuda",
        source="espflix_tpu_torch/csrc/compose.cu",
        replaces="espflix_tpu/ops/idct_pallas.py:171 + "
        "espflix_tpu/ops/mocomp_pallas.py:975,1084",
        library_ms=None, **k23_i, **p_tick_keys(k23_p)))
    kernels[-1]["max_abs_err"] = max(k23_i["max_abs_err"],
                                     k23_p["max_abs_err"])
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
        **timed(lambda: CO.synthesize_field_pair_parts(
            *comp_args, **comp_kw), args.reps),
        plain_ms=time_ms(lambda: CO.synthesize_field_pair_parts_torch(
            *comp_args, **comp_kw), args.reps)))
    kernels[-1]["bound_ms"], kernels[-1]["bound_by"] = bound(nbytes(
        *comp_args, chain.templates, chain.dither, *ck))
    log(f"[kernel] {kernels[-1]}")
    kernels[-1]["max_abs_err"] = max(
        kernels[-1]["max_abs_err"], composite_edge_case(dev, N))

    # K6 on the tick's 13 SBC frames a lane, then on varied audio
    entry, pcm = sbc_kernel(x, kw["n_aud_frames"], dev, args.reps,
                            sm_clock_hz)
    kernels.append(entry)

    # K5 on the tick's decoded SBC PCM (1,664 samples a lane) from a
    # random carried state, and on full-scale square waves
    S = kw["n_aud_frames"] * 128
    pcm = pcm[:, :S].contiguous()
    st = torch.randint(-2_000_000, 2_000_000, (N, 3), generator=g,
                       dtype=torch.int32).to(dev)
    period = 2 << (torch.arange(N, device=dev) % 8)[:, None]
    square = torch.where(
        (torch.arange(S, device=dev)[None, :] // period) % 2 == 1,
        32767, -32767).to(torch.int16)
    err, pdm_plain_ms = 0, []
    for label, p_in in (("decoded PCM", pcm), ("square waves", square)):
        ref, ms = run_timed(lambda: DS.modulate_torch(p_in, st, n_samples=S))
        pdm_plain_ms.append(ms)
        err = max(err, require_equal(
            f"K5 pdm ({label})",
            zip(DS.modulate(p_in, st, n_samples=S), ref)))
    kernels.append(dict(
        name="K5_pdm", route="cuda",
        source="espflix_tpu_torch/csrc/pdm.cu",
        replaces="espflix_tpu/ops/delta_sigma_pallas.py:61",
        max_abs_err=err, library_ms=None,
        **timed(lambda: DS.modulate(pcm, st, n_samples=S), args.reps),
        plain_ms=pdm_plain_ms[0]))
    # each lane is one chain of 2 * 16 * S bit steps, each three
    # dependent integer operations (shift, and / sub, add into i2)
    steps = 2 * 16 * S
    kernels[-1]["bound_ms"], kernels[-1]["bound_by"] = bound(
        nbytes(pcm, st, *DS.modulate(pcm, st, n_samples=S)),
        steps * 3 * INT_DEP_CYCLES / sm_clock_hz * 1e3)
    kernels[-1]["cycles_per_step"] = \
        kernels[-1]["device_ms"] * 1e-3 * sm_clock_hz / steps
    log(f"[kernel] {kernels[-1]} (chain of {steps} steps at "
        f"{sm_clock_hz / 1e6:.0f} MHz)")

    kernels += flat_kernels(x, x_p, chain, rand_frames, args.reps, mbw,
                            mbh, sm_clock_hz)
    edge = dense_edge_case(dev, mbw, mbh)
    for e in kernels:
        short = e["name"].split("_")[0]
        if short in edge:
            e["max_abs_err"] = max(e["max_abs_err"], edge[short])
    kernels += predict_seq_kernels(
        x_p, bench_ticks[k_i], wpl, chain, rand_frames, args.reps, mbw, mbh,
        dev, sm_clock_hz)

    log(f"[time] phases 1-3 done at {time.perf_counter() - t_start:.1f} s")

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
        require_unlaunched(f"chain {label}", SPLIT_KERNELS)
        if label == "win=0":
            # the presented planes of each tick, for phase 4o
            presented = [tuple(outs[k][t] for k in "yuv")
                         for t in range(outs["y"].shape[0])]
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
    slide = tuple(torch.randint(0, 256, (N,) + tuple(pk[k].shape[1:]),
                                generator=g, dtype=torch.uint8).to(dev)
                  for k in "yuv")
    kw_s = dict(kw, scrolled=True)
    fr, sb, ds = fresh_state()
    reset_counts()
    CH.run_full_chunk(xs_s, fr, sb, ds, tap_idx, slide, tap=1, **kw_s)
    torch.cuda.synchronize()
    chain_counts["scrolled"] = read_counts("chain scrolled", CHAIN_KERNELS)
    require_unlaunched("chain scrolled", SPLIT_KERNELS)
    log(f"[chain scrolled] {K_s} ticks, {int((hs != 0).any(0).sum())} of "
        f"{N} lanes mid-slide, launches {chain_counts['scrolled']}")
    compare_plain("scrolled", xs_s, kw_s, K_s, slide=slide)

    log(f"[time] phase 4 done at {time.perf_counter() - t_start:.1f} s")

    # ---- 4o. the per-field output path ------------------------------------
    per_field = per_field_phase(dev, presented, smi, args.reps)
    del presented
    for k in kernels:
        if k["name"] == "K4_composite_field_pair":
            k["per_field"] = {s: per_field[s] for s in ("NTSC", "PAL")}
        elif k["name"] == "K5_pdm":
            k["per_call"] = per_field["modulate"]
    log(f"[time] phase 4o done at {time.perf_counter() - t_start:.1f} s")

    # ---- O. the validation path against the C oracle -----------------
    t0 = time.perf_counter()
    o_decode, o_planes = oracle_decode(dev, smi, args.reps, N)
    o_fields = oracle_fields(dev, smi, args.reps, N, o_planes)
    del o_planes
    o_audio = oracle_audio(dev, smi, args.reps, N)
    modes = ("sequential", "slice_parallel")
    phase_o = {
        "K1S_slice_scan_seq": dict(
            launches={m: o_decode[m]["launches"]["K1S_slice_scan_seq"]
                      for m in modes},
            **{k: o_decode[k] for k in ("per_slice", "two_passes",
                                        "per_slice_p", "two_passes_p")}),
        "K4_composite_field_pair": o_fields,
        "K5_pdm": dict(launches=o_audio["launches"]["K5_pdm"],
                       modulate_spec_ms=o_audio["modulate_spec_ms"]),
        "K6_sbc_decode": dict(launches=o_audio["launches"]["K6_sbc_decode"],
                              stream_ms=o_audio["sbc_stream_ms"])}
    for name in ("K2F_dequant_idct_flat", "K3F_predict_compose_put_flat"):
        phase_o[name] = dict(launches={m: o_decode[m]["launches"][name]
                                       for m in modes})
    phase_o["K1S_slice_scan_seq"].update(
        {m: {k: o_decode[m][k] for k in ("picture_ms", "device_share")}
         for m in modes})
    for k in kernels:
        if k["name"] in phase_o:
            k["phase_o"] = phase_o[k["name"]]
    log(f"[time] phase O done at {time.perf_counter() - t_start:.1f} s "
        f"({time.perf_counter() - t0:.1f} s)")

    # ---- B, S. the port's bench and stage timer ------------------------
    t0 = time.perf_counter()
    bench_phase(dev, smi)
    log(f"[time] phase B done at {time.perf_counter() - t_start:.1f} s "
        f"({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    stages_phase(dev, smi)
    log(f"[time] phase S done at {time.perf_counter() - t_start:.1f} s "
        f"({time.perf_counter() - t0:.1f} s)")

    # ---- 5, 6. serving: one service behind the local HTTP server -------
    serve_lanes = min(256, args.lanes)
    with http_service() as (url, root):
        # A: faults, snapshot/restore
        serve_counts = serve_phase_a(dev, url, serve_lanes, 16, smi)
        # B: kernel path == plain path at A's lanes
        serve_phase_b(dev, url, serve_lanes)
        log(f"[time] phases 5-6 done at {time.perf_counter() - t_start:.1f} s")
        # 5e. paced egress of 16 tapped lanes
        egress_phase(dev, url, serve_lanes, smi)
        log(f"[time] phase 5e done at {time.perf_counter() - t_start:.1f} s")
        # 5p. the host worker pool: pooled == in-process, then 4x lanes
        pooled_phase(dev, url, "file://" + root, serve_lanes, smi,
                     big_lanes=4 * serve_lanes)
        log(f"[time] phase 5p done at {time.perf_counter() - t_start:.1f} s")
        # 7. decode-only serving, then kernel path == plain path, then
        # the hybrid parser against the device parser
        decode_counts = decode_serving(dev, url, serve_lanes, smi)
        decode_parity(dev, url, serve_lanes)
        hybrid_phase(dev, url, serve_lanes, smi)
        log(f"[time] phase 7 done at {time.perf_counter() - t_start:.1f} s")
        # 8. the mesh
        mesh_counts = mesh_phase(dev, url, serve_lanes, smi)
    log(f"[time] phase 8 done at {time.perf_counter() - t_start:.1f} s")
    # 8r. the geometry router at 352x240, then the play tool
    router_phase(dev, smi)
    play_phase(smi)
    log(f"[time] router and play done at "
        f"{time.perf_counter() - t_start:.1f} s")

    for k in kernels:
        k["launches"] = serve_counts.get(
            k["name"], decode_counts.get(k["name"],
                                         mesh_counts.get(k["name"])))
        # K3 has no path of its own since K23 took its place
        if not k["launches"] and k["name"] != "K3_predict_compose_put":
            raise AssertionError(f"{k['name']}: no launch on its path")

    # ---- 9. results ------------------------------------------------------
    log(f"[total] {time.perf_counter() - t_start:.1f} s")
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
