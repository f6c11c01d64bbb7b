"""Serving integration scenario on the port (--stage decode and full).

The port of espflix_tpu.tools.serve_scenario: a fleet of PlayerSessions
over HTTP-range streaming (or file://) against a generated service --
play, pause, 15x fast-forward and rewind with index seeks, +/-30 s
skips, menu -> re-nav, continuous re-navigation of finished lanes, two
injected corrupt pictures that must be contained and resynced, and a
fleet snapshot at half-time restored into a second fleet -- on
`--device` (the card by default).

  * --stage decode (the default): the decode-only fleet, dispatched
    pipelined (Fleet.tick_submit / tick_collect, the default) or in
    chunks of K = 4 ticks (--dispatch chunk, Fleet.run_chunk), on the
    slice-scan parser (build_fleet(parser="device") gives the
    sequential scan, the JAX tool's default for this stage; both
    present the same frames on clean streams);
  * --stage full: every chunk of K = 4 ticks through
    Fleet.run_chunk_full (decode, composite fields, SBC and PDM);
  * --stage full --workers W: the sessions on W host worker processes
    (runtime/hostpool.HostPool), every chunk through
    Fleet.run_chunk_full_pooled (run_pooled: the JAX tool's
    serve_scenario.py:325-420).

    python3 -m espflix_tpu_torch.tools.serve_scenario --stage decode \\
        --lanes 256 --ticks 16 [--dispatch chunk]
    python3 -m espflix_tpu_torch.tools.serve_scenario --stage full \\
        --lanes 256 --ticks 16 [--workers 8] [--egress 16 --egress-depth 16]
    ... --device cpu --transport file     # on the CPU, no HTTP server

  * --stage full --egress K: the first K lanes are tapped and every
    full tick's DAC fields and PDM words go through one paced
    runtime/egress.EgressPump (one tick's signal per 1/29.97 s); the
    summary gets its "egress" block (delivered bytes, underruns, drops,
    line rate, the delivery checksum).

Prints one JSON line with the JAX tool's keys (serve_scenario.py:496-
528; run_pooled's at :397-410).
"""

from __future__ import annotations

import argparse
import http.server
import json
import os
import shutil
import sys
import tempfile
import threading
import time
from dataclasses import dataclass, field

import numpy as np

from espflix_tpu_torch.core.bitio import BitWriter
from espflix_tpu_torch.runtime.egress import EgressPump
from espflix_tpu_torch.runtime.events import Ev
from espflix_tpu_torch.tools.indexer import make_service
from espflix_tpu_torch.models import mpeg1 as M
from espflix_tpu_torch.runtime.player import PlayerSession, State
from espflix_tpu_torch.runtime.scheduler import Fleet


class RangeHandler(http.server.SimpleHTTPRequestHandler):
    """Range-capable static file handler (S3/CloudFront stand-in)."""

    root = "."

    def translate_path(self, path):
        path = path.split("?", 1)[0].split("#", 1)[0].lstrip("/")
        return os.path.join(self.root, path)

    def do_GET(self):
        path = self.translate_path(self.path)
        try:
            with open(path, "rb") as f:
                data = f.read()
        except OSError:
            self.send_error(404)
            return
        h = self.headers.get("Range")
        if h and h.startswith("bytes="):
            lo, _, hi = h[6:].partition("-")
            lo = int(lo)
            hi = int(hi) + 1 if hi else len(data)
            body = data[lo:hi]
            self.send_response(206)
            self.send_header("Content-Range",
                             f"bytes {lo}-{hi - 1}/{len(data)}")
        else:
            body = data
            self.send_response(200)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, *a):
        pass


def start_http_service(root: str):
    """Serve `root` on an ephemeral localhost port; returns (url,
    shutdown_fn)."""
    handler = type("H", (RangeHandler,), {"root": root})
    httpd = http.server.ThreadingHTTPServer(("127.0.0.1", 0), handler)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"

    def shutdown():
        httpd.shutdown()
        httpd.server_close()
        t.join(timeout=10)
    return url, shutdown


def corrupt_picture():
    """A 352x192 I-picture whose first MB hits an invalid MB-type code
    (the JAX tool's construction)."""
    w = BitWriter()
    w.start_code(0xB3)
    w.put(352, 12); w.put(192, 12); w.put(1, 4); w.put(5, 4)
    w.put(2928, 18); w.put(1, 1); w.put(20, 10)
    w.put(0, 1); w.put(0, 1); w.put(0, 1)
    w.start_code(0x00)
    w.put(0, 10); w.put(1, 3); w.put(0xFFFF, 16); w.put(0, 1)
    w.start_code(0x01)
    w.put(8, 5); w.put(0, 1)
    w.put_str("1")
    w.put(0, 23)
    w.put(0xFFFF, 16)
    w.align()
    w.start_code(0xB7)
    return M.parse_es(w.tobytes())[1][0]


# a slice body that errors at its first macroblock: quantiser 8, no
# extra information, address increment 1, then a zero macroblock type
# code (invalid in I and P pictures)
BAD_SLICE = 0x42000000


def corrupt_slice(batch: dict, lane: int, k: int):
    """Overwrite 32 bits of `lane`'s words at the start of its slice k
    with BAD_SLICE, in a make_picture_batch dict (in place): the
    picture's scan errors in that slice."""
    bit = int(batch["slice_starts"][lane, k])
    w = batch["words"]
    i, off = bit >> 5, bit & 31
    pair = (int(w[lane, i]) << 32) | int(w[lane, i + 1])
    shift = 32 - off
    pair = (pair & ~(0xFFFFFFFF << shift)) | (BAD_SLICE << shift)
    w[lane, i], w[lane, i + 1] = pair >> 32, pair & 0xFFFFFFFF


@dataclass
class ScenarioStats:
    frames: int = 0
    audio_lanes: int = 0
    errors: int = 0
    resyncs: int = 0
    actions: dict = field(default_factory=dict)
    wall_s: float = 0.0
    ticks: int = 0
    lanes: int = 0
    frames_per_lane: np.ndarray | None = None  # int64[N]
    full_ticks: int = 0        # ticks that ran the output stage
    tap_field_bytes: int = 0   # DAC bytes delivered for tapped lanes

    def streams_per_chip(self) -> float:
        if self.wall_s <= 0:
            return 0.0
        return self.frames / self.wall_s / 30.0


def generate_service(root: str, titles: list[str], *, seed: int = 0,
                     n_gops: int = 4, gop: int = 6):
    """Full A/V service: video GOPs + a 48 kHz mono SBC track (SBC
    128-sample frames, one per 240 PTS ticks at 90 kHz)."""
    from espflix_tpu_torch.tools.sbc_encode import random_frame
    rng = np.random.default_rng(seed)
    n_frames = n_gops * gop * 90000 // 30 // 240 + 8
    audio = [(random_frame(rng, mode=0, bitpool=28), k * 240)
             for k in range(n_frames)]
    make_service(root, titles, seed=seed, n_gops=n_gops, gop=gop,
                 audio_frames=audio)


def build_fleet(url: str, lanes: int, titles: int,
                words_per_lane: int = 8192, stage: str = "decode",
                device="cuda", parser: str = "pallas",
                mesh=None) -> Fleet:
    """A fleet of `lanes` sessions on `device` (or on `mesh`, a
    parallel/mesh.Mesh), lane i playing title i % titles: decode-only
    for stage "decode" on `parser`, with the output stage and the full
    chain for "full"."""
    fleet = Fleet(lanes, words_per_lane=words_per_lane,
                  output=stage == "full", device=device, parser=parser,
                  mesh=mesh)
    for i in range(lanes):
        s = PlayerSession(url)
        if not s.init_service():
            raise RuntimeError("service bootstrap failed")
        s.nav(i % titles)
        s.play_pause()
        fleet.attach(i, s)
    return fleet


def run_scenario(fleet: Fleet, ticks: int, *, seed: int = 0,
                 action_every: int = 4, faults: int = 2,
                 decode_audio: bool = True,
                 snapshot_at: int | None = None, churn: bool = True,
                 dispatch: str = "pipelined", tap_lanes=(0,), egress=None):
    """Drive the fleet through `ticks` ticks with scripted per-lane
    control actions and injected faults (serve_scenario.py:173-324).

    dispatch: "pipelined" (tick_submit / tick_collect, planes left on
    the device; an action every `action_every` ticks), "chunk"
    (run_chunk) or "full" (run_chunk_full, tapping `tap_lanes`) in
    chunks of K = action_every ticks with actions, faults and snapshots
    at chunk boundaries.  egress: an EgressPump that every tick with
    taps pushes its tap_fields and tap_pdm to.  churn re-navigates any
    lane whose title finished (State.DONE), so batch occupancy never
    decays.  Returns
    (stats, snapshot) where snapshot is the fleet snapshot taken at
    `snapshot_at` (or None)."""
    rng = np.random.default_rng(seed)
    n = fleet.n
    stats = ScenarioStats(lanes=n)
    snap = None

    # schedule fault injections: (tick, lane)
    fault_plan = {}
    for _ in range(faults):
        fault_plan[int(rng.integers(2, max(3, ticks // 2)))] = \
            int(rng.integers(0, n))
    bad_pic = corrupt_picture()

    def inject(lane):
        s = fleet.sessions[lane]
        if s is None or getattr(s, "_tampered", False):
            return
        orig = s.next_picture

        def tampered():
            p = orig()
            if p is not None and not getattr(s, "_fired", False):
                s._fired = True
                bad_pic.pts = p.pts
                return bad_pic
            return p
        s.next_picture = tampered
        s._tampered = True

    def act():
        # a slice of lanes takes a random control action
        k = max(1, n // 8)
        for lane in rng.choice(n, size=k, replace=False):
            s = fleet.sessions[int(lane)]
            if s is None:
                continue
            a = rng.integers(0, 6)
            name = ("play_pause", "ff", "rwd", "skip_fwd", "skip_back",
                    "menu_nav")[a]
            stats.actions[name] = stats.actions.get(name, 0) + 1
            if a == 0:
                s.play_pause()
            elif a == 1 and s.state == State.PLAYING:
                s.fast_forward()
            elif a == 2 and s.state == State.PLAYING:
                s.rewind()
            elif a == 3 and s.state == State.PLAYING:
                s.skip(30)
            elif a == 4 and s.state == State.PLAYING:
                s.skip(-30)
            elif a == 5:
                if s.state == State.NAV:
                    s.nav(int(rng.integers(0, max(1, len(s.manifest)))))
                    s.play_pause()
                else:
                    s.menu()

    def reap_done():
        for s in fleet.sessions:
            if s is None or s.state != State.DONE:
                continue
            s.menu()
            s.nav(int(rng.integers(0, max(1, len(s.manifest)))))
            s.play_pause()
            stats.actions["lane_restart"] = \
                stats.actions.get("lane_restart", 0) + 1

    stats.frames_per_lane = np.zeros(n, np.int64)

    def account(r):
        stats.frames += int(r.video_lanes.sum())
        stats.frames_per_lane += r.video_lanes.astype(np.int64)
        stats.audio_lanes += int(r.audio_lanes.sum())
        stats.errors += int(r.errors.sum())
        if r.field_sum is not None:
            stats.full_ticks += 1
        if r.tap_fields is not None:
            stats.tap_field_bytes += int(np.asarray(r.tap_fields).size)
            if egress is not None:
                # the tapped lanes' DAC fields + PDM words to the paced
                # line-rate consumer (runtime/egress.py)
                egress.push(r.tap_fields, r.tap_pdm)

    t0 = time.time()
    if dispatch == "pipelined":
        pend = None
        for t in range(ticks):
            if churn:
                reap_done()
            if t in fault_plan:
                inject(fault_plan[t])
            if action_every and t and t % action_every == 0:
                act()
            if snapshot_at is not None and t == snapshot_at:
                snap = fleet.snapshot()
            nxt = fleet.tick_submit(decode_audio)
            if pend is not None:
                # serving shape: planes stay on the device; only the
                # control words reach the host
                account(fleet.tick_collect(pend, fetch_frames=False))
            pend = nxt
        if pend is not None:
            account(fleet.tick_collect(pend, fetch_frames=False))
    else:
        # chunked dispatch: K ticks per device call; control actions,
        # faults and snapshots apply at chunk boundaries (worst-case
        # action latency = K ticks)
        K = max(1, action_every)
        t = 0
        while t < ticks:
            if churn:
                reap_done()
            for ft in list(fault_plan):
                if t <= ft < t + K:
                    inject(fault_plan.pop(ft))
            if t:
                act()
            if snapshot_at is not None and t <= snapshot_at < t + K:
                snap = fleet.snapshot()
            k = min(K, ticks - t)
            if dispatch == "full":
                rs = fleet.run_chunk_full(k, tap_lanes=tap_lanes)
            else:
                rs = fleet.run_chunk(k, decode_audio, fetch_frames=False)
            for r in rs:
                account(r)
            t += k
    stats.wall_s = time.time() - t0
    stats.ticks = ticks
    names = [e.ev for e in fleet.events.dump(10 ** 6)]
    stats.resyncs = names.count(Ev.LANE_RESYNC)
    return stats, snap


def run_pooled(args, url: str):
    """--workers mode (serve_scenario.py:325-420): the sessions sharded
    across host worker processes feeding the full chain on --device
    (Fleet.run_chunk_full_pooled), in chunks of K = 4 ticks with control
    churn between chunks -- finished lanes re-navigated, one +30 s skip
    a chunk.  Prints and returns the JSON line."""
    from espflix_tpu_torch.runtime.hostpool import HostPool

    rng = np.random.default_rng(args.seed)
    fleet = Fleet(args.lanes, words_per_lane=8192, parser="pallas",
                  output=True, device=args.device)
    with HostPool(args.lanes, args.workers, 8192, fleet.mb_w,
                  fleet.mb_h) as pool:
        if not all(pool.attach_many(range(args.lanes), url)):
            raise RuntimeError("service bootstrap failed")
        for i in range(args.lanes):
            pool.call(i, "nav", i % args.titles)
            pool.call(i, "play_pause")
        K = 4
        stats = ScenarioStats(lanes=args.lanes)
        stats.frames_per_lane = np.zeros(args.lanes, np.int64)
        t0 = time.time()
        t = 0
        while t < args.ticks:
            for lane, state in enumerate(pool.states()):
                if state == "DONE":
                    pool.call(lane, "menu")
                    pool.call(lane, "nav", int(rng.integers(0, args.titles)))
                    pool.call(lane, "play_pause")
                    stats.actions["lane_restart"] = \
                        stats.actions.get("lane_restart", 0) + 1
            if t:
                lane = int(rng.integers(0, args.lanes))
                pool.call(lane, "skip", 30)
                stats.actions["skip_fwd"] = \
                    stats.actions.get("skip_fwd", 0) + 1
            k = min(K, args.ticks - t)
            for r in fleet.run_chunk_full_pooled(pool, k, tap_lanes=(0,)):
                stats.frames += int(r.video_lanes.sum())
                stats.frames_per_lane += r.video_lanes.astype(np.int64)
                stats.audio_lanes += int(r.audio_lanes.sum())
                stats.errors += int(r.errors.sum())
                stats.full_ticks += 1
                if r.tap_fields is not None:
                    stats.tap_field_bytes += int(np.asarray(
                        r.tap_fields).size)
            t += k
        stats.wall_s = time.time() - t0
    stats.ticks = args.ticks
    out = {
        "lanes": args.lanes, "ticks": stats.ticks,
        "stage": "full", "dispatch": "full-pooled",
        "workers": args.workers,
        "full_ticks": stats.full_ticks,
        "tap_field_bytes": stats.tap_field_bytes,
        "min_lane_frames": int(stats.frames_per_lane.min()),
        "frames": stats.frames,
        "audio_lane_ticks": stats.audio_lanes,
        "errors": stats.errors,
        "actions": stats.actions,
        "wall_s": round(stats.wall_s, 2),
        "wall_per_tick_ms": round(
            stats.wall_s / max(stats.ticks, 1) * 1000, 1),
        "frames_per_s": round(stats.frames / max(stats.wall_s, 1e-9), 1),
    }
    print(json.dumps(out))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--lanes", type=int, default=64)
    ap.add_argument("--ticks", type=int, default=90)
    ap.add_argument("--titles", type=int, default=4)
    ap.add_argument("--gops", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--no-audio", action="store_true")
    ap.add_argument("--service", default=None,
                    help="existing service dir (default: generate)")
    ap.add_argument("--transport", choices=["http", "file"],
                    default="http",
                    help="file skips the local HTTP server")
    ap.add_argument("--stage", choices=["decode", "full"],
                    default="decode",
                    help="decode = the decode-only fleet on the slice-"
                         "scan parser; full = decode + composite fields "
                         "+ SBC + PDM (runtime/chain.py), "
                         "chunk-dispatched")
    ap.add_argument("--dispatch", choices=["pipelined", "chunk", "full"],
                    default=None,
                    help="device dispatch (default: pipelined for "
                         "--stage decode, full-chain chunks for "
                         "--stage full)")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the fleet (cuda or cpu)")
    ap.add_argument("--workers", type=int, default=0,
                    help="shard the session control plane across N host "
                         "worker processes (runtime/hostpool.py; "
                         "requires --stage full)")
    ap.add_argument("--egress", type=int, default=0,
                    help="tap N lanes and drain their full DAC fields + "
                         "PDM through a paced line-rate consumer "
                         "(runtime/egress.py; requires --stage full)")
    ap.add_argument("--egress-depth", type=int, default=8,
                    help="egress ring depth in ticks")
    args = ap.parse_args(argv)
    if args.workers and args.stage != "full":
        raise ValueError("--workers requires --stage full")
    if args.egress and args.stage != "full":
        raise ValueError("--egress requires --stage full")
    dispatch = args.dispatch or (
        "full" if args.stage == "full" else "pipelined")

    root = args.service
    generated = root is None
    if generated:
        root = tempfile.mkdtemp(prefix="espflix_svc_")
        titles = [f"title{i:02d}" for i in range(args.titles)]
        print(f"generating service ({args.titles} titles) -> {root}",
              file=sys.stderr)
        generate_service(root, titles, seed=args.seed, n_gops=args.gops)
    if args.transport == "http":
        url, shutdown = start_http_service(root)
    else:
        url, shutdown = "file://" + root, (lambda: None)
    print(f"service at {url}", file=sys.stderr)

    run_kw = dict(decode_audio=not args.no_audio, dispatch=dispatch)
    try:
        if args.workers:
            return run_pooled(args, url)
        fleet = build_fleet(url, args.lanes, args.titles, stage=args.stage,
                            device=args.device)
        pump = None
        tap_lanes = (0,)
        if args.egress:
            tap_lanes = tuple(range(min(args.egress, args.lanes)))
            pump = EgressPump(tick_interval=1.0 / 29.97,
                              depth=args.egress_depth)
            pump.start()
        stats, snap = run_scenario(fleet, args.ticks, seed=args.seed,
                                   snapshot_at=args.ticks // 2,
                                   tap_lanes=tap_lanes, egress=pump,
                                   **run_kw)
        est = pump.finish() if pump is not None else None
        # snapshot/restore into a second fleet: every playing lane
        # resumes at its saved position
        restored = 0
        restored_ok = False
        if snap is not None:
            fleet2 = build_fleet(url, args.lanes, args.titles,
                                 stage=args.stage, device=args.device)
            restored = fleet2.restore(snap)
            rstats, _ = run_scenario(fleet2, max(4, args.ticks // 8),
                                     seed=args.seed + 1, faults=0,
                                     **run_kw)
            restored_ok = rstats.frames > 0
    finally:
        shutdown()
        if generated:
            shutil.rmtree(root, ignore_errors=True)

    out = {
        "lanes": args.lanes,
        "ticks": stats.ticks,
        "stage": args.stage,
        "dispatch": dispatch,
        "full_ticks": stats.full_ticks,
        "tap_field_bytes": stats.tap_field_bytes,
        "min_lane_frames": int(stats.frames_per_lane.min()),
        "frames": stats.frames,
        "audio_lane_ticks": stats.audio_lanes,
        "errors": stats.errors,
        "resyncs": stats.resyncs,
        "actions": stats.actions,
        "snapshot_restored": restored,
        "restored_decodes": restored_ok,
        "wall_s": round(stats.wall_s, 2),
        "frames_per_s": round(stats.frames / max(stats.wall_s, 1e-9), 1),
        "rt_streams_per_chip": round(stats.streams_per_chip(), 1),
    }
    if est is not None:
        out["egress"] = egress_summary(est, len(tap_lanes))
    print(json.dumps(out))
    return out


def egress_summary(est, tapped: int) -> dict:
    """The summary's "egress" block (the JAX tool's keys) from an
    EgressPump's final EgressStats."""
    return {
        "tapped_lanes": tapped,
        "pushed_ticks": est.pushed_ticks,
        "consumed_ticks": est.consumed_ticks,
        "underrun_ticks": est.underrun_ticks,
        "dropped_ticks": est.dropped_ticks,
        "delivered_field_bytes": est.delivered_field_bytes,
        "delivered_pdm_words": est.delivered_pdm_words,
        "line_rate_MBps": round(est.line_rate_bytes_per_s() / 1e6, 2),
        "checksum": est.checksum,
    }


if __name__ == "__main__":
    main()
