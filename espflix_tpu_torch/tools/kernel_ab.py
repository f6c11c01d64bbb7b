"""Time one checkout's kernels on the bench's ticks, for comparing two
commits on one card.

    python3 espflix_tpu_torch/tools/kernel_ab.py [--tree CHECKOUT] [--label X]
                                                 [--only K3P_A,SBC,...]
    python3 espflix_tpu_torch/tools/kernel_ab.py --serve 256 [--tree ...]
                                                 [--stage full]

imports espflix_tpu_torch from CHECKOUT (default: the checkout that holds
this file), builds its kernels, and times, at chip_smoke.py's phase-3
inputs (1,024 lanes of 352x192): K1 (run_scan_bucketed_dense), K1F
(run_scan_bucketed) and K1S (run_scan) on the I-heavy tick; SBC
(models/sbc.decode_frames_batched on the tick's 13 audio frames a lane:
K6 where the checkout has it, else the plain form) and K5
(ops/delta_sigma.modulate on that PCM from a seeded random state); the
dense phase on the I-heavy tick (`_I`) and on the P-heavy one (`_P`,
chip_smoke.py's k_p): K2 (block_residuals_T) on K1's scan, K3
(predict_compose_put) on K2's output, K2F (block_residuals_flat) on
K1F's output in chip_smoke's flat_kernels configuration, K3F
(predict_compose_put_flat) on K2F's output, K3 and K3F onto seeded
random frames restored before every run; the pair K2 then K3 in one
run (`K2K3`) and, where the checkout has it, K23 (idct_compose_put, the
pair in one pass) on K1's levels onto the same restored frames (its
checksum is K3's); and K4
(composite.synthesize_field_pair_parts, NTSC and PAL) on K3's
presented planes of the I-heavy tick, as chip_smoke.py's phase 3 feeds
it, and the per-field output path on the same planes
(runtime/output.OutputStage.synthesize, a steady field with no OSD:
`FIELD_NTSC`, `FIELD_PAL`); K3P (mocomp.predict_plane for y,
predict_chroma_pair for u and v)
with the P-heavy tick's vectors onto seeded random reference planes
(`K3P_A`, rule A, as chip_smoke.py times it) and
mocomp.predict_plane_rows on chip_smoke.py's band, MB rows 3-8 with
seeded random vectors past the edges (`K3P_B`, rule B), and `K3P_A`'s
calls on its first 64 lanes, a shard of chip_smoke.py's mesh phase
(`K3P_S`).  K1 and K3F are the controls where a change
touches other kernels.  --only times the named kernels alone and
skips the ptxas report.
Each gets the median of --reps runs by two rulers: `call_ms`, the
call's latency, the host's enqueue included (chip_smoke.py's `ms`), and
`device_ms`, the device's work alone (the card sleeps while the host
enqueues), and a checksum of its outputs (for K3 / K3F the presented
planes and the frames).  It also compiles the checkout's
csrc/compose.cu, idct.cu, composite.cu and sbc.cu with `nvcc -Xptxas
-v` and reports each dense-phase kernel's, K3P's, K4's and K6's
registers, stack frame, spill and static shared bytes.  Prints one
JSON line with the label, the card's name and power limit, and those
numbers.

With --serve LANES it times decode-only serving instead, as chip_smoke.py's
decode phase runs it: a service of 2 titles x 4 GOPs behind the local HTTP
Range server, one warm-up run of 4 ticks, then --ticks ticks pipelined and
--ticks chunked (K = 4) with two injected faults each, and reports each
dispatch's wall ms a tick, its Fleet timers and the untimed host rest.
With --stage full it times full-stage serving as chip_smoke.py's serving
A runs it (Fleet.run_chunk_full in chunks of 4, two injected faults)
instead, and names the session feed the lanes ran on.

Run it for the two checkouts in the order A, B, B, A in one session on
the card.  Needs a CUDA card.
"""

import argparse
import json
import os
import re
import statistics
import subprocess
import sys
import shutil
import tempfile
from pathlib import Path

BUSY_CYCLES = 20_000_000    # as chip_smoke.py: ~10 ms at 1,980 MHz


# the kernels of compose.cu / idct.cu / composite.cu / sbc.cu that the
# ptxas report names, keyed by a part of their mangled names (a
# checkout's K2 is either a plain kernel or a template on its vector
# width, of which the bench takes 8; its K3P a template on the edge rule
# alone or on the MB size too)
PTXAS_SOURCES = ("compose.cu", "idct.cu", "composite.cu", "sbc.cu")
PTXAS_KERNELS = {"idct_compose_put_kernelILi4E": "idct_compose_put_kernel<4>",
                 "idct_compose_put_kernelILi8E": "idct_compose_put_kernel<8>",
                 "compose_put_kernelILb0": "compose_put_kernel<false>",
                 "compose_put_kernelILb1": "compose_put_kernel<true>",
                 "predict_kernelILb0": "predict_kernel<false>",
                 "predict_kernelILb1": "predict_kernel<true>",
                 "predict_kernelILi16ELb0": "predict_kernel<16, false>",
                 "predict_kernelILi8ELb0": "predict_kernel<8, false>",
                 "predict_kernelILi16ELb1": "predict_kernel<16, true>",
                 "predict_kernelILi8ELb1": "predict_kernel<8, true>",
                 "idct_flat_kernel": "idct_flat_kernel",
                 "idct_T_kernelE": "idct_T_kernel",
                 "idct_T_kernelILi8E": "idct_T_kernel<8>",
                 "composite_parts_kernel": "composite_parts_kernel",
                 "sbc_kernelILi1": "sbc_kernel<1>",
                 "sbc_kernelILi2": "sbc_kernel<2>"}


def time_ms(fn, reps: int, busy: bool, setup=None) -> float:
    """Median CUDA-event time of fn() over reps runs after a warm one;
    setup() (a restore of fn's in-place operands) runs before each run,
    outside the timed span."""
    import torch
    if setup:
        setup()
    fn()
    ts = []
    for _ in range(reps):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        if setup:
            setup()
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


def ptxas_report(tree: str) -> dict:
    """Registers, stack frame, spill stores / loads and static shared
    bytes of each PTXAS_KERNELS kernel of the checkout's PTXAS_SOURCES,
    as `nvcc -Xptxas -v` prints them (the checkout's flags)."""
    from espflix_tpu_torch import build
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for src in PTXAS_SOURCES:
            proc = subprocess.run(
                [build._nvcc(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-c",
                 "-o", os.path.join(tmp, "k.o"),
                 os.path.join(tree, "espflix_tpu_torch", "csrc", src)],
                capture_output=True, text=True, check=True)
            name = None
            for line in proc.stderr.splitlines():
                m = re.search(r"Compiling entry function '(\w+)'", line)
                if m:
                    name = next((v for k, v in PTXAS_KERNELS.items()
                                 if k in m.group(1)), None)
                    continue
                if name is None:
                    continue
                rep = out.setdefault(name, {})
                for key, pat in (
                        ("stack_bytes", r"(\d+) bytes stack frame"),
                        ("spill_stores", r"(\d+) bytes spill stores"),
                        ("spill_loads", r"(\d+) bytes spill loads"),
                        ("registers", r"Used (\d+) registers"),
                        ("smem_bytes", r"(\d+) bytes smem")):
                    m = re.search(pat, line)
                    if m:
                        rep[key] = int(m.group(1))
    return out


def serve(dev, lanes: int, ticks: int, stage: str = "decode") -> dict:
    """Serving of the imported checkout at `lanes` lanes: wall, Fleet
    timers and untimed host ms a tick for the pipelined and the chunked
    dispatch of the decode-only fleet, or (stage "full") for
    run_chunk_full in chunks of 4."""
    import torch
    from espflix_tpu_torch import build
    from espflix_tpu_torch.tools import serve_scenario as SS

    try:
        from espflix_tpu_torch.runtime.telemetry import top_level
    except ImportError:         # a tree without nested spans
        top_level = dict
    build.library()
    build.BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    root = tempfile.mkdtemp(dir=build.BUILD_ROOT)
    out = {}
    try:
        SS.generate_service(root, ["title00", "title01"], seed=0, n_gops=4)
        url, shutdown = SS.start_http_service(root)
        try:
            dispatches = ("full",) if stage == "full" else ("pipelined",
                                                            "chunk")
            SS.run_scenario(SS.build_fleet(url, lanes, 2, device=dev,
                                           stage=stage), 4,
                            seed=0, faults=0, dispatch=dispatches[0])
            for dispatch in dispatches:
                fleet = SS.build_fleet(url, lanes, 2, device=dev,
                                       stage=stage)
                stats, _ = SS.run_scenario(fleet, ticks, seed=0, faults=2,
                                           dispatch=dispatch)
                torch.cuda.synchronize()
                timers = {k: 1000 * v / ticks
                          for k, v in fleet.timers.acc.items()}
                wall = 1000 * stats.wall_s / ticks
                out[dispatch] = dict(
                    wall_ms=wall, timers_ms=timers,
                    untimed_ms=wall - sum(top_level(timers).values()),
                    frames=stats.frames, errors=stats.errors,
                    feed=type(fleet.sessions[0].feed).__name__)
        finally:
            shutdown()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return out


def card() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    return smi.stdout.strip().splitlines()[0]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", default=str(Path(__file__).resolve()
                                          .parents[2]))
    ap.add_argument("--label", default=None)
    ap.add_argument("--lanes", type=int, default=1024)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--serve", type=int, default=0, metavar="LANES",
                    help="time decode-only serving at LANES lanes instead")
    ap.add_argument("--ticks", type=int, default=16)
    ap.add_argument("--stage", choices=("decode", "full"), default="decode",
                    help="with --serve: the decode-only fleet or the full "
                    "chain (run_chunk_full)")
    ap.add_argument("--only", default="",
                    help="comma-separated kernels to time (default: all)")
    args = ap.parse_args()
    only = set(filter(None, args.only.split(",")))
    tree = os.path.abspath(args.tree)
    sys.path[0] = tree          # the checkout's package, not this one's

    import torch
    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab: no CUDA device")
    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)

    import espflix_tpu_torch
    if not espflix_tpu_torch.__file__.startswith(tree):
        raise SystemExit(f"kernel_ab: imported {espflix_tpu_torch.__file__}"
                         f", not {tree}")
    if args.serve:
        print(json.dumps({"label": args.label or tree, "card": card(),
                          "lanes": args.serve, "ticks": args.ticks,
                          "stage": args.stage,
                          "serve": serve(dev, args.serve, args.ticks,
                                         args.stage)}),
              flush=True)
        return 0

    from espflix_tpu_torch import build
    from espflix_tpu_torch.core import sbc_tables as ST
    from espflix_tpu_torch.models import mpeg1 as M
    from espflix_tpu_torch.models import sbc as dsbc
    from espflix_tpu_torch.ops import composite as CO
    from espflix_tpu_torch.ops import delta_sigma as DS
    from espflix_tpu_torch.ops import idct as IDCT
    from espflix_tpu_torch.ops import mocomp as MC
    from espflix_tpu_torch.ops import vlc_scan as VS
    from espflix_tpu_torch.runtime import chain as CH
    from espflix_tpu_torch.runtime.output import OutputStage
    from espflix_tpu_torch.runtime.scheduler import bucket_policy
    from espflix_tpu_torch.runtime.workload import (bench_chunk,
                                                    bench_pictures)
    build.library()

    xs_np, kw, _ = bench_chunk(args.lanes)
    bench_ticks, wpl = bench_pictures(args.lanes)
    n_i = ((xs_np["pic_type"] == 1) & (xs_np["alive"] == 1)).sum(axis=1)
    k_i = int(n_i.argmax())
    xs_t = CH.xs_to_torch(xs_np, dev)
    x = {k: v[k_i] for k, v in xs_t.items()}
    mbw, mbh, N = kw["mb_width"], kw["mb_height"], args.lanes
    chain = CH.FullChain(pal=False, n_aud_frames=kw["n_aud_frames"],
                         device=dev)
    tables = dict(lut=chain.scan_lut, zigzag=chain.zigzag)

    k1_args = [x[k] for k in CH.DECODE_KEYS[:9]]
    k1_kw = dict({k: kw[k] for k in ("mb_width", "mb_height", "n_lanes",
                                     "long_rows", "steps_long",
                                     "steps_short", "chunk")}, **tables)

    def flat_scan_kw(xt, f_args):
        """chip_smoke.py flat_kernels' K1F configuration for tick xt."""
        need = int(((xt["pic_type"] == 1) & (xt["alive"] == 1)).sum())
        long_rows, s_long, s_short = bucket_policy(
            max(need, 8), f_args[0].shape[0], steps_long=2048,
            steps_short=512)
        return dict(mb_width=mbw, mb_height=mbh, n_lanes=N,
                    long_rows=long_rows, steps_long=s_long,
                    steps_short=s_short, chunk=128, **tables)

    k1f_args = [x[k] for k in M.SCAN_KEYS]
    k1f_kw = flat_scan_kw(x, k1f_args)
    b = M.make_picture_batch(bench_ticks[k_i], words_per_lane=wpl,
                             max_slices=mbh)
    k1s_args = list(M.xs_to_torch({k: b[k] for k in M.PICTURE_KEYS[:7]},
                                  dev).values())
    k1s_kw = dict(mb_width=mbw, mb_height=mbh, max_steps=12000, **tables)

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
        "SBC": lambda: dsbc.decode_frames_batched(*sbc_args, **sbc_kw),
        "K5": lambda: DS.modulate(pcm, ds_state, n_samples=F * 128),
    }
    setups = {}
    # the dense phase on the I-heavy and the P-heavy tick
    g = torch.Generator(device="cpu").manual_seed(7)
    for label, k in (("I", k_i), ("P", int(n_i.argmin()))):
        xt = {key: v[k] for key, v in xs_t.items()}
        coeffs_T, recs, nfinal = VS.run_scan_bucketed_dense(
            *[xt[key] for key in CH.DECODE_KEYS[:9]], **k1_kw)[:3]
        k2_args = (coeffs_T,
                   ((recs & 3) == VS.MB_INTRA).repeat_interleave(6, 1),
                   ((recs >> 2) & 31).repeat_interleave(6, 1),
                   xt["intra_q"], xt["non_intra_q"], nfinal,
                   chain.scale_dct)
        res_T = IDCT.block_residuals_T(*k2_args)
        runs[f"K2_{label}"] = lambda a=k2_args: (
            IDCT.block_residuals_T(*a),)
        f_args = [xt[key] for key in M.SCAN_KEYS]
        coeffs, recs_f, nfinal_f = VS.run_scan_bucketed(
            *f_args, **flat_scan_kw(xt, f_args))[:3]
        idct_args = (coeffs, recs_f, nfinal_f, xt["intra_q"],
                     xt["non_intra_q"], chain.scale_dct)
        res_f = IDCT.block_residuals_flat(*idct_args)
        frames0 = M.init_frame_state(N, mbw * 16, mbh * 16, dev)
        for key in "yuv":
            frames0[key] = torch.randint(0, 256, frames0[key].shape,
                                         generator=g,
                                         dtype=torch.uint8).to(dev)
        frames0["parity"] = torch.randint(0, 2, (N,), generator=g,
                                          dtype=torch.int32).to(dev)
        fr = {key: v.clone() for key, v in frames0.items()}

        def restore(fr=fr, frames0=frames0):
            for key, v in frames0.items():
                fr[key].copy_(v)

        def compose(fn, res, recs, active=xt["active"], fr=fr):
            pres = fn(res, recs, active, fr, mb_width=mbw, mb_height=mbh)
            return [pres[key] for key in "yuv"] + [fr[key] for key in "yuv"]

        runs[f"K2F_{label}"] = lambda a=idct_args: (
            IDCT.block_residuals_flat(*a),)
        for name, fn, res, r in (
                (f"K3_{label}", MC.predict_compose_put, res_T, recs),
                (f"K3F_{label}", MC.predict_compose_put_flat, res_f,
                 recs_f)):
            runs[name] = lambda fn=fn, res=res, r=r, cp=compose: cp(
                fn, res, r)
            setups[name] = restore
        runs[f"K2K3_{label}"] = lambda a=k2_args, r=recs, cp=compose: cp(
            MC.predict_compose_put, IDCT.block_residuals_T(*a), r)
        setups[f"K2K3_{label}"] = restore
        if hasattr(MC, "idct_compose_put"):     # a checkout with K23
            def fused(a=(coeffs_T, recs, nfinal, xt["intra_q"],
                         xt["non_intra_q"], xt["active"]), fr=fr):
                pres = MC.idct_compose_put(*a, fr, mb_width=mbw,
                                           mb_height=mbh,
                                           scale_dct=chain.scale_dct)
                return [pres[key] for key in "yuv"] + \
                    [fr[key] for key in "yuv"]
            runs[f"K23_{label}"] = fused
            setups[f"K23_{label}"] = restore
        if label == "P":
            recs_p, frames_p = recs, frames0
        if label == "I":
            # K4 on K3's presented planes of this tick, as chip_smoke.py
            restore()
            pres = compose(MC.predict_compose_put, res_T, recs)[:3]
            comp_args = (*pres, xt["parity"], xt["osd"], xt["blend"],
                         xt["progress"])
            for std, pal in (("NTSC", False), ("PAL", True)):
                consts = CH.FullChain(pal=pal, n_aud_frames=1, device=dev)
                runs[f"K4_{std}"] = lambda c=consts, pal=pal: \
                    CO.synthesize_field_pair_parts(
                        *comp_args, pal=pal, tmpl=c.templates,
                        dither=c.dither)
                stage = OutputStage(N, pal=pal, device=dev)
                runs[f"FIELD_{std}"] = lambda st=stage, p=pres: (
                    st.synthesize(*p),)
    # K3P: y + u + v with the P-heavy tick's vectors (rule A), and the
    # band of MB rows 3-8 with random vectors past the edges (rule B)
    lanes = torch.arange(N, device=dev)
    refs = [frames_p[key][lanes, 1 - frames_p["parity"].long()].contiguous()
            for key in "yuv"]
    _kind, mv_h, mv_v = MC.mb_fields(recs_p, mbw, mbh)
    g = torch.Generator(device="cpu").manual_seed(11)
    rnd = [torch.randint(-48, 49, mv_h.shape, generator=g,
                         dtype=torch.int32).to(dev) for _ in range(2)]

    def scaled(mh, mv):
        return [(mh, mv), (mh >> 1, mv >> 1), (mh >> 1, mv >> 1)]

    mvs_p, mvs_r = scaled(mv_h, mv_v), scaled(*rnd)
    band = [(mh[:, 3:9].contiguous(), mv[:, 3:9].contiguous())
            for mh, mv in mvs_r]
    runs["K3P_A"] = lambda: [MC.predict_plane(refs[0], *mvs_p[0], 16),
                             *MC.predict_chroma_pair(*refs[1:], *mvs_p[1])]
    runs["K3P_B"] = lambda: [MC.predict_plane_rows(r, mh, mv, S, 3)
                             for r, (mh, mv), S in zip(refs, band,
                                                       (16, 8, 8))]
    # one shard's calls in chip_smoke.py's mesh phase: 256 serving lanes
    # on 4 shards
    shard = [t[:64].contiguous() for t in refs]
    mvs_s = [tuple(m[:64].contiguous() for m in pair) for pair in mvs_p]
    runs["K3P_S"] = lambda: [MC.predict_plane(shard[0], *mvs_s[0], 16),
                             *MC.predict_chroma_pair(*shard[1:], *mvs_s[1])]
    out = {}
    for name, fn in runs.items():
        if only and name not in only:
            continue
        setup = setups.get(name)
        out[name] = dict(call_ms=time_ms(fn, args.reps, False, setup),
                         device_ms=time_ms(fn, args.reps, True, setup))
        if setup:
            setup()
        out[name]["checksum"] = checksum(fn())
    print(json.dumps({"label": args.label or tree, "card": card(),
                      "lanes": N, "reps": args.reps, "kernels": out,
                      "ptxas": {} if only else ptxas_report(tree)}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
