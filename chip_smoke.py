#!/usr/bin/env python3
"""Drive the PyTorch port's per-tick chain once on one CUDA card.

    python3 chip_smoke.py                 # 1024 lanes, 12 ticks
    python3 chip_smoke.py --lanes 64 --ticks 3 --reps 1   # quick check

Phases (any failure raises, so the exit code is non-zero and no result
line is printed):

1. device: requires torch.cuda; prints torch / CUDA / nvcc versions and
   the card's name and power limit (nvidia-smi);
2. build: compiles espflix_tpu_torch/csrc/*.cu for sm_90a (build/);
3. kernels: each of K1-K4 against its plain PyTorch version on the card
   at the main path's shapes, exact equality, CUDA-event medians;
4. the slice: run_full_chunk over the bench workload
   (bench.py --stage full inputs), once with host row windows (win=0)
   and once with device windows (win>0): no lane errors, every kernel's
   launch counter rose during the chain, and every out and carry equal
   to the same chunk run through the plain forms on the card;
5. the card's name and power limit, one JSON line with the kernels'
   numbers, and the final {"ok": true, ...} line.

Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import statistics
import subprocess
import sys
import time


def log(*a):
    print(*a, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int):
    """Median CUDA-event time of fn() over reps runs (after one warm)."""
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
    """Route the chain's four kernel wrappers to their plain PyTorch
    versions (for the on-card comparison run)."""
    from espflix_tpu_torch.ops import composite as CO
    from espflix_tpu_torch.ops import idct as IDCT
    from espflix_tpu_torch.ops import mocomp as MC
    from espflix_tpu_torch.ops import vlc_scan as VS
    swaps = [(VS, "run_scan_bucketed_dense",
              VS.run_scan_bucketed_dense_torch),
             (IDCT, "block_residuals_T", IDCT.block_residuals_T_torch),
             (MC, "predict_compose_put", MC.predict_compose_put_torch),
             (CO, "synthesize_field_pair_parts",
              CO.synthesize_field_pair_parts_torch)]
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--lanes", type=int, default=1024)
    ap.add_argument("--ticks", type=int, default=12,
                    help="ticks of the 12-picture GOP chunk to run")
    ap.add_argument("--reps", type=int, default=5,
                    help="timed repetitions per kernel")
    args = ap.parse_args()

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
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    log(f"[device] nvcc: {nvcc.strip().splitlines()[-1] if nvcc else '?'}")
    log(f"[device] {torch.cuda.get_device_name(0)} | nvidia-smi: {smi}")

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
    from espflix_tpu_torch.runtime.workload import bench_chunk

    # ---- 2. build -------------------------------------------------------
    t0 = time.perf_counter()
    build.library()
    log(f"[build] {build.library_path()} in "
        f"{time.perf_counter() - t0:.1f} s (nvcc "
        f"{'%.1f s' % build.build_seconds if build.build_seconds else 'cached'})")

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
                         channels=1, device=dev)
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
        max_abs_err=err,
        ms=time_ms(lambda: VS.run_scan_bucketed_dense(*scan_args,
                                                     **scan_kw), args.reps),
        plain_ms=time_ms(lambda: VS.run_scan_bucketed_dense_torch(
            *scan_args, **scan_kw), max(1, args.reps // 2))))
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
        ms=time_ms(lambda: IDCT.block_residuals_T(*idct_args), args.reps),
        plain_ms=time_ms(lambda: IDCT.block_residuals_T_torch(*idct_args),
                         args.reps)))
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
        max_abs_err=err,
        ms=time_ms(lambda: MC.predict_compose_put(res_k, recs, active,
                                                  fr_k, **mc_kw), args.reps),
        plain_ms=time_ms(lambda: MC.predict_compose_put_torch(
            res_k, recs, active, fr_p, **mc_kw), args.reps)))
    log(f"[kernel] {kernels[-1]}")

    comp_args = (pk["y"], pk["u"], pk["v"], x["parity"], x["osd"],
                 x["blend"], x["progress"])
    comp_kw = dict(pal=False, tmpl=chain.templates, dither=chain.dither)
    ck = CO.synthesize_field_pair_parts(*comp_args, **comp_kw)
    cp = CO.synthesize_field_pair_parts_torch(*comp_args, **comp_kw)
    err = require_equal("K4 composite", zip(ck, cp))
    pal_t = CH.FullChain(pal=True, n_aud_frames=1, channels=1, device=dev)
    pal_kw = dict(pal=True, tmpl=pal_t.templates, dither=pal_t.dither)
    err = max(err, require_equal("K4 composite PAL", zip(
        CO.synthesize_field_pair_parts(*comp_args, **pal_kw),
        CO.synthesize_field_pair_parts_torch(*comp_args, **pal_kw))))
    kernels.append(dict(
        name="K4_composite_field_pair", route="cuda",
        source="espflix_tpu_torch/csrc/composite.cu",
        replaces="espflix_tpu/ops/composite_pallas.py:67",
        max_abs_err=err,
        ms=time_ms(lambda: CO.synthesize_field_pair_parts(
            *comp_args, **comp_kw), args.reps),
        plain_ms=time_ms(lambda: CO.synthesize_field_pair_parts_torch(
            *comp_args, **comp_kw), args.reps)))
    log(f"[kernel] {kernels[-1]}")

    # ---- 4. the slice ----------------------------------------------------
    mods = {"K1_slice_scan_dense": VS, "K2_dequant_idct": IDCT,
            "K3_predict_compose_put": MC, "K4_composite_field_pair": CO}

    def fresh_state():
        return (M.init_frame_state(N, mbw * 16, mbh * 16, dev),
                dsbc.init_state(N, dev), DS.init_state(N, dev))

    tap_idx = torch.tensor([N // 3], dtype=torch.int32, device=dev)
    launches = {}
    for label, xs_t, kwx in (("win=0", xs, kw), ("win>0", xs_w, kw_w)):
        run_kw = dict(kwx, tap=1, return_planes=True)
        for m in mods.values():
            m.launches = 0
        timer = StageTimer()
        fr, sb, ds = fresh_state()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fr, sb, ds, outs = CH.run_full_chunk(xs_t, fr, sb, ds, tap_idx,
                                             None, timer=timer, **run_kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {name: m.launches for name, m in mods.items()}
        for name, c in counts.items():
            if c < 1:
                raise AssertionError(f"{label}: {name} never launched")
        if label == "win=0":
            launches = counts
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

        fr2, sb2, ds2 = fresh_state()
        with plain_forms():
            fr2, sb2, ds2, outs2 = CH.run_full_chunk(
                xs_t, fr2, sb2, ds2, tap_idx, None, **run_kw)
        torch.cuda.synchronize()
        pairs = [(outs[k], outs2[k]) for k in outs]
        pairs += [(fr[k], fr2[k]) for k in ("y", "u", "v", "parity")]
        pairs += [(sb, sb2), (ds, ds2)]
        require_equal(f"chain {label}", pairs)
        log(f"[chain {label}] kernel path == plain path on the card "
            f"({len(pairs)} tensors)")

    for k in kernels:
        k["launches"] = launches[k["name"]]

    # ---- 5. results ------------------------------------------------------
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
