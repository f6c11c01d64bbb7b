"""Per-stage device times of the full-tick pipeline on one CUDA card.

The port of espflix_tpu/tools/perf_stages.py: each stage of the
decode -> composite -> PDM tick runs in isolation on random inputs at
the production geometry (352x192, mbw=22, mbh=12) -- dequant+IDCT,
residual plane assembly, prediction, the compose split three ways,
the fused compose, the whole dense phase, the composite field pair,
SBC decode, PDM and the emission-log densify.  The VLC scan is
content-dependent and is timed by tools/bench.py.

Every JAX stage name is kept.  Where the JAX package has several TPU
variants of one function, each variant's name times the port's one
kernel for that function (STAGE_KERNELS says what each name runs), and
each stage computes the JAX stage's function: the same inputs (the same
numpy draws in the same order), the same salt and the same
int32-wrapping checksum.

Method: per stage one warm call, then `iters` calls with salts mixed
into a large operand, bracketed by CUDA events and ended by one
synchronize, `reps` times; ms_min / ms_med are per call.  A stage that
fails raises: nothing is skipped.  Without a card the tool refuses to
run unless --device cpu is given (the plain forms, for tests).

Usage:
    python -m espflix_tpu_torch.tools.perf_stages --lanes 1024 --iters 8 \\
        --reps 3 [--stages idct_pallasT,compose_fused2,...] [--json] \\
        [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from espflix_tpu_torch.core.vlc_tables import DEFAULT_INTRA_Q
from espflix_tpu_torch.models import mpeg1 as M
from espflix_tpu_torch.models import sbc as dsbc
from espflix_tpu_torch.ops import composite as CO
from espflix_tpu_torch.ops import delta_sigma as DS
from espflix_tpu_torch.ops import idct as IDCT
from espflix_tpu_torch.ops import mocomp as MC
from espflix_tpu_torch.ops import scan_dense as SD
from espflix_tpu_torch.ops import vlc_scan
from espflix_tpu_torch.ops.intwrap import wrap32
from espflix_tpu_torch.tools.sbc_encode import random_frame

_K3P = "K3P: ops/mocomp.predict_plane (luma), predict_chroma_pair (u + v)"
# what each of the JAX package's stage names times in the port
STAGE_KERNELS = {
    "idct_pallasT": "K2: ops/idct.block_residuals_T",
    "idct_jnp": "K2: ops/idct.block_residuals_T",
    "assemble": "torch ops: the residual reshape / transpose chain",
    "mocomp": _K3P,
    "mocomp_phase": _K3P,
    "mocomp_phase_luma": _K3P,
    "mocomp_phase2_luma": _K3P,
    "mocomp_phase2p_luma": _K3P,
    "mocomp_chroma_packedp": _K3P,
    "mocomp_chroma_packedpa": _K3P,
    "mocomp_phase4_luma": _K3P,
    "mocomp_packed": _K3P,
    "mocomp_packed_luma": _K3P,
    "mocomp_chroma_packed": _K3P,
    "mocomp_chroma_packed4": _K3P,
    "mocomp_hybrid": _K3P,
    "densify": "torch ops: ops/scan_dense.log_to_dense_rows",
    "mocomp_luma": _K3P,
    "compose_select": "torch ops: the MB-kind selects and pin",
    "parity_put": "torch ops: the parity-slot put",
    "presented_where": "torch ops: the presented-plane select",
    "compose_fused2": "K3F: ops/mocomp.predict_compose_put_flat (with "
    "the two frame-slot writes that stand for its operands)",
    "dense_all": "K23: models/mpeg1.dense_compose",
    "fieldpair": "K4: ops/composite.synthesize_field_pair_parts",
    "fieldpair_full": "K4 + field_canvas: ops/composite."
    "synthesize_field_pair",
    "sbc": "K6: models/sbc.decode_frames_batched",
    "pdm": "K5: ops/delta_sigma.modulate",
    "pdm_spec": "K5: ops/delta_sigma.modulate_spec",
}


def build_inputs(n: int, mbw: int = 22, mbh: int = 12, seed: int = 11,
                 device="cuda") -> dict:
    """The JAX tool's inputs (perf_stages.py:38-123): the same numpy
    draws in the same order, as tensors on `device` (uint32 words as
    int32 bit patterns).  "F" (13 SBC frames) and "geom" (mbw, mbh) are
    plain values."""
    rng = np.random.default_rng(seed)
    mbc = mbw * mbh
    BL = mbc * 6
    H, W = mbh * 16, mbw * 16
    d = {}
    d["coeffs_T"] = rng.integers(-64, 64, (n, 64, BL)).astype(np.int16)
    intra = rng.random((n, mbc)) < 0.4
    kind = np.where(intra, vlc_scan.MB_INTRA,
                    rng.choice([vlc_scan.MB_STALE, vlc_scan.MB_SKIP,
                                vlc_scan.MB_INTER], (n, mbc)))
    d["kind"] = kind.reshape(n, mbh, mbw).astype(np.int32)
    d["intra_bl"] = np.repeat(intra, 6, axis=1)
    d["qs_bl"] = np.repeat(rng.integers(1, 32, (n, mbc)), 6,
                           axis=1).astype(np.int32)
    d["iq"] = np.broadcast_to(np.asarray(DEFAULT_INTRA_Q).reshape(64),
                              (n, 64)).astype(np.int32)
    d["nq"] = np.full((n, 64), 16, np.int32)
    d["nfinal"] = rng.integers(0, 64, (n, BL)).astype(np.int32)
    d["res_T"] = rng.integers(-255, 256, (n, 64, BL)).astype(np.int16)
    for p, (h, w) in (("y", (H, W)), ("u", (H // 2, W // 2)),
                      ("v", (H // 2, W // 2))):
        d["ref_" + p] = rng.integers(0, 249, (n, h, w), dtype=np.uint8)
        d["cur_" + p] = rng.integers(0, 249, (n, h, w), dtype=np.uint8)
        d["pred_" + p] = rng.integers(0, 249, (n, h, w), dtype=np.uint8)
        d["res_" + p] = rng.integers(-255, 256, (n, h, w)).astype(np.int16)
    d["mv_h"] = rng.integers(-30, 31, (n, mbh, mbw)).astype(np.int32)
    d["mv_v"] = rng.integers(-30, 31, (n, mbh, mbw)).astype(np.int32)
    d["active"] = np.ones(n, bool)
    d["parity"] = rng.integers(0, 2, n).astype(np.int32)
    frames = dict(
        y=rng.integers(0, 249, (n, 2, H, W), dtype=np.uint8),
        u=rng.integers(0, 249, (n, 2, H // 2, W // 2), dtype=np.uint8),
        v=rng.integers(0, 249, (n, 2, H // 2, W // 2), dtype=np.uint8))
    # output-stage inputs (the bench's nonzero state)
    d["osd"] = rng.integers(0, 256, (n, 16, 80), dtype=np.uint8)
    d["blend"] = rng.integers(0, 256, n).astype(np.int32)
    d["progress"] = rng.integers(0, W, n).astype(np.int32)
    F = 13
    fr = np.stack([np.frombuffer(random_frame(rng, mode=0, bitpool=28),
                                 np.uint8) for _ in range(F)])
    d["aud_words"] = dsbc.frames_to_words(np.ascontiguousarray(
        np.broadcast_to(fr, (n, F, 64)))).view(np.int32)
    d["pcm"] = rng.integers(-32768, 32768, (n, F * 128)).astype(np.int16)
    # emission logs at the bench's bucket shapes: the long bucket 2N
    # rows x 1024 steps, the short one the rest x 384; indices span the
    # flat index space, trash included
    trash = mbc + mbc * 6 + mbc * 384
    for nm, R, T in (("long", 2 * n, 1024),
                     ("short", n * mbh - 2 * n, 384)):
        d[f"li_{nm}"] = rng.integers(0, trash + 8, (T, R)).astype(np.int32)
        d[f"lv_{nm}"] = rng.integers(-2048, 2048, (T, R)).astype(np.int32)
        d[f"rb_{nm}"] = (rng.integers(0, mbh, R) * mbw).astype(np.int32)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)
    out = {k: t(v) for k, v in d.items()}
    out["frames"] = {k: t(v) for k, v in frames.items()}
    out["frames"]["parity"] = out["parity"]
    out["sbc_hist"] = dsbc.init_state(n, device)
    out["ds_state"] = DS.init_state(n, device)
    out["F"] = F
    out["geom"] = (mbw, mbh)
    return out


def residual_blocks_flat(ry, ru, rv, mb_width: int, mb_height: int):
    """Raster residual planes -> lane-minor residual blocks int16[N,
    MB*6, 64], the inverse of ops/mocomp.residual_planes_flat."""
    N = ry.shape[0]
    y = ry.reshape(N, mb_height, 2, 8, mb_width, 2, 8) \
        .permute(0, 1, 4, 2, 5, 3, 6).reshape(N, mb_height, mb_width, 4,
                                               64)
    uv = [c.reshape(N, mb_height, 8, mb_width, 8).permute(0, 1, 3, 2, 4)
          .reshape(N, mb_height, mb_width, 1, 64) for c in (ru, rv)]
    return torch.cat([y, *uv], dim=3).reshape(N, -1, 64).contiguous()


def make_stages(d: dict) -> dict:
    """{name: fn(d, salt) -> int32 checksum (0-d tensor)} per JAX stage
    name.  salt is a Python int; each fn mixes it into a large operand
    as the JAX stage does.  Kernels launch where d's tensors lie (the
    plain forms on the CPU)."""
    mbw, mbh = d["geom"]
    N = int(d["active"].shape[0])
    F = int(d["F"])
    H, W = mbh * 16, mbw * 16
    dev = d["active"].device
    scale_dct = IDCT.scale_dct_q(dev)
    tmpl, dither = CO.packed_tensors(False, dev)
    sums = torch.int64

    def s8(salt):                      # uint8 salt
        return salt & 0x3F

    def s16(salt):                     # small int16 salt
        return salt & 0x7

    def isum(x):
        return x.sum(dtype=sums)

    def idct(dd, salt):
        r = IDCT.block_residuals_T(
            dd["coeffs_T"] ^ s16(salt), dd["intra_bl"], dd["qs_bl"],
            dd["iq"], dd["nq"], dd["nfinal"], scale_dct=scale_dct)
        return wrap32(isum(r))

    def assemble(dd, salt):
        # the rT reshape / transpose chain (models/mpeg1 dense_compose)
        rT = (dd["res_T"] ^ s16(salt)).reshape(N, 8, 8, mbh, mbw, 6)
        ry = rT[..., :4].reshape(N, 8, 8, mbh, mbw, 2, 2) \
            .permute(0, 3, 5, 1, 4, 6, 2).reshape(N, H, W)
        ru = rT[..., 4].permute(0, 3, 1, 4, 2).reshape(N, H // 2, W // 2)
        rv = rT[..., 5].permute(0, 3, 1, 4, 2).reshape(N, H // 2, W // 2)
        return wrap32(isum(ry) + isum(ru) + isum(rv))

    def luma(dd, salt):
        return isum(MC.predict_plane(dd["ref_y"] ^ s8(salt), dd["mv_h"],
                                     dd["mv_v"], 16))

    def chroma(dd, salt, salt_v=False):
        ref_v = dd["ref_v"] ^ s8(salt) if salt_v else dd["ref_v"]
        pu, pv = MC.predict_chroma_pair(dd["ref_u"] ^ s8(salt), ref_v,
                                        dd["mv_h"] >> 1, dd["mv_v"] >> 1)
        return isum(pu) + isum(pv)

    def mocomp(dd, salt):
        # every plane salted (the JAX stage's three separate calls)
        return wrap32(luma(dd, salt) + chroma(dd, salt, salt_v=True))

    def mocomp_all(dd, salt):
        return wrap32(luma(dd, salt) + chroma(dd, salt))

    def mocomp_luma(dd, salt):
        return wrap32(luma(dd, salt))

    def mocomp_chroma(dd, salt):
        return wrap32(chroma(dd, salt))

    # -- the compose stage, split three ways ---------------------------
    def compose_one(cur, pred, resid, kind_mb, reps):
        # twin of models/mpeg1.dense_compose compose()
        def up(m):
            return m.repeat_interleave(reps, 1).repeat_interleave(reps, 2)
        stale = up(kind_mb == vlc_scan.MB_STALE)
        intra = up(kind_mb == vlc_scan.MB_INTRA)
        p = pred.to(torch.int16)
        out = torch.where(intra, resid, p + resid).clamp(0, 248)
        return torch.where(stale, cur, out.to(torch.uint8))

    def compose_select(dd, salt):
        acc = 0
        for p, reps in (("y", 16), ("u", 8), ("v", 8)):
            acc = acc + isum(compose_one(
                dd["cur_" + p], dd["pred_" + p] ^ s8(salt), dd["res_" + p],
                dd["kind"], reps))
        return wrap32(acc)

    lanes = torch.arange(N, device=dev)

    def parity_put(dd, salt):
        acc = 0
        live = dd["active"][:, None, None]
        for p in "yuv":
            upd = torch.where(live, dd["pred_" + p] ^ s8(salt),
                              dd["cur_" + p])
            planes = dd["frames"][p].clone()
            planes[lanes, dd["parity"].long()] = upd
            acc = acc + isum(planes[:, 0, 0, 0])
        return wrap32(acc)

    def presented_where(dd, salt):
        acc = 0
        live = dd["active"][:, None, None]
        for p in "yuv":
            acc = acc + isum(torch.where(live, dd["pred_" + p] ^ s8(salt),
                                         dd["cur_" + p]))
        return wrap32(acc)

    # K3F's operands: the residual planes as lane-minor blocks, the MB
    # kinds and vectors as records; each call puts cur into the slot it
    # writes (parity 0) and the salted reference into the other
    recs = (d["kind"].reshape(N, -1) | (d["qs_bl"][:, ::6] << 2)
            | ((d["mv_h"].reshape(N, -1) & 0xFFF) << 7)
            | ((d["mv_v"].reshape(N, -1) & 0xFFF) << 19))
    res_flat = residual_blocks_flat(d["res_y"], d["res_u"], d["res_v"],
                                    mbw, mbh)
    slots = {p: torch.empty((N, 2) + tuple(d["cur_" + p].shape[1:]),
                            dtype=torch.uint8, device=dev) for p in "yuv"}
    slots["parity"] = torch.zeros(N, dtype=torch.int32, device=dev)

    def compose_fused2(dd, salt):
        for p in "yuv":
            slots[p][:, 0].copy_(dd["cur_" + p])
            torch.bitwise_xor(dd["ref_" + p], s8(salt), out=slots[p][:, 1])
        pres = MC.predict_compose_put_flat(res_flat, recs, dd["active"],
                                           slots, mb_width=mbw,
                                           mb_height=mbh)
        return wrap32(isum(pres["y"]) + isum(pres["u"]) + isum(pres["v"]))

    def dense_all(dd, salt):
        fr = dd["frames"]
        frames = dict(y=fr["y"] ^ s8(salt), u=fr["u"].clone(),
                      v=fr["v"].clone(), parity=fr["parity"])
        _f, pres = M.dense_compose(
            dd["coeffs_T"], recs, dd["nfinal"], dd["iq"], dd["nq"],
            dd["active"], frames, mb_width=mbw, mb_height=mbh,
            scale_dct=scale_dct)
        return wrap32(isum(pres["y"]) + isum(pres["u"]) + isum(pres["v"]))

    def fieldpair(dd, salt):
        # the production parts form (the chain's): active pairs, the
        # shared OSD strip and the in-kernel checksum
        act, strip, chk = CO.synthesize_field_pair_parts(
            dd["cur_y"] ^ s8(salt), dd["cur_u"], dd["cur_v"], dd["parity"],
            dd["osd"], dd["blend"], dd["progress"], pal=False, tmpl=tmpl,
            dither=dither)
        return wrap32(isum(chk) + act[0, 0, 0, 0].long()
                      + strip[0, 0, 0].long())

    def fieldpair_full(dd, salt):
        # full-canvas assembly included
        fp = CO.synthesize_field_pair(
            dd["cur_y"] ^ s8(salt), dd["cur_u"], dd["cur_v"], dd["parity"],
            dd["osd"], dd["blend"], dd["progress"], pal=False)
        return wrap32(isum(fp))

    def sbc(dd, salt):
        pcm, _hist, _err, _ = dsbc.decode_frames_batched(
            dd["aud_words"], dd["sbc_hist"] + (salt & 1), n_frames=F)
        return wrap32(isum(pcm))

    def densify(dd, salt):
        # both buckets' log -> dense windows
        acc = 0
        for nm in ("long", "short"):
            c, a, drop = SD.log_to_dense_rows(
                dd[f"li_{nm}"] ^ (salt & 7), dd[f"lv_{nm}"] ^ salt,
                dd[f"rb_{nm}"], mb_width=mbw, mb_count=mbw * mbh,
                transposed=True)
            acc = acc + isum(c) + isum(a) + isum(drop)
        return wrap32(acc)

    def pdm_with(modulate):
        def stage(dd, salt):
            out, st = modulate(dd["pcm"] ^ s16(salt), dd["ds_state"],
                               n_samples=F * 128)
            return wrap32(isum(out) + isum(st))
        return stage

    stages = dict(idct_pallasT=idct, idct_jnp=idct, assemble=assemble,
                  mocomp=mocomp, mocomp_phase=mocomp_all,
                  mocomp_phase_luma=mocomp_luma,
                  mocomp_phase2_luma=mocomp_luma,
                  mocomp_phase2p_luma=mocomp_luma,
                  mocomp_chroma_packedp=mocomp_chroma,
                  mocomp_chroma_packedpa=mocomp_chroma,
                  mocomp_phase4_luma=mocomp_luma,
                  mocomp_packed=mocomp_all,
                  mocomp_packed_luma=mocomp_luma,
                  mocomp_chroma_packed=mocomp_chroma,
                  mocomp_chroma_packed4=mocomp_chroma,
                  mocomp_hybrid=mocomp_all,
                  densify=densify,
                  mocomp_luma=mocomp_luma,
                  compose_select=compose_select, parity_put=parity_put,
                  presented_where=presented_where,
                  compose_fused2=compose_fused2, dense_all=dense_all,
                  fieldpair=fieldpair, fieldpair_full=fieldpair_full,
                  sbc=sbc, pdm=pdm_with(DS.modulate),
                  pdm_spec=pdm_with(DS.modulate_spec))
    assert stages.keys() == STAGE_KERNELS.keys()
    return stages


def time_stage(fn, d: dict, iters: int, reps: int) -> dict:
    """One warm call, then per rep `iters` salted calls between two
    CUDA events (the host clock on the CPU) and one synchronize.
    Returns ms_min / ms_med per call."""
    cuda = d["active"].device.type == "cuda"
    int(fn(d, 0))                             # warm (and sync)
    ts = []
    for r in range(reps):
        if cuda:
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            a.record()
        t0 = time.perf_counter()
        acc = 0
        for i in range(iters):
            acc = acc + fn(d, 1 + r * iters + i)
        if cuda:
            b.record()
            torch.cuda.synchronize()
            ms = a.elapsed_time(b)
        else:
            ms = (time.perf_counter() - t0) * 1e3
        ts.append(ms / iters)
    ts.sort()
    return dict(ms_min=round(ts[0], 3), ms_med=round(ts[len(ts) // 2], 3))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--lanes", type=int, default=1024)
    ap.add_argument("--iters", type=int, default=8)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--stages", type=str, default="")
    ap.add_argument("--json", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels; the default) or cpu (the "
                    "plain forms, for tests)")
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("perf_stages: no CUDA device (pass --device cpu "
                         "for the plain forms)")
    d = build_inputs(args.lanes, device=device)
    stages = make_stages(d)
    names = [s for s in args.stages.split(",") if s] or list(stages)
    out = {}
    for name in names:
        out[name] = time_stage(stages[name], d, args.iters, args.reps)
        print(f"{name:>24}: {out[name]['ms_min']:8.3f} ms/iter (min) "
              f"{out[name]['ms_med']:8.3f} (med)  [{STAGE_KERNELS[name]}]",
              flush=True)
    if args.json:
        print(json.dumps(dict(lanes=args.lanes, iters=args.iters,
                              backend=device.type,
                              device=torch.cuda.get_device_name(device)
                              if device.type == "cuda" else "cpu",
                              stages=out)))


if __name__ == "__main__":
    main()
