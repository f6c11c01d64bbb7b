"""The full per-tick device chain: decode -> composite -> SBC -> PDM.

The port of espflix_tpu.runtime.chain (_chunk_scan / run_full_chunk,
chain.py:68-217).  Each of the K ticks of a chunk runs, in order:

    slice scan into dense buffers (K1) -> dequant+IDCT (K2) ->
    prediction + compose + parity put (K3) -> [flip-animation scroll]
    -> both composite fields, parts form (K4) -> SBC decode ->
    beep/starve/silence selects -> delta-sigma PDM (K5) -> per-lane
    checksums (+ taps)

Frame planes, SBC history and modulator state carry from tick to tick;
the K ticks are a Python loop over the tick body.  Kernels run when the
tensors are on a CUDA device and their plain PyTorch versions when they
are on the CPU.  ``FullChain`` holds the constant tables as buffers
(runtime/scheduler.Fleet keeps one for its lifetime);
``run_full_chunk`` is the JAX entry point's signature over a new one.

Frames are updated in place (see models/mpeg1.dense_compose); the
presented planes of each tick are new tensors.  ``make_sharded_full_chunk``
runs the tick body per shard of a 'streams' mesh (parallel/mesh.py).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from espflix_tpu_torch.models import mpeg1 as M
from espflix_tpu_torch.models.mpeg1 import xs_to_torch  # noqa: F401
from espflix_tpu_torch.models import sbc as dsbc
from espflix_tpu_torch.ops import composite as CO
from espflix_tpu_torch.ops import delta_sigma as DS
from espflix_tpu_torch.ops import idct as IDCT
from espflix_tpu_torch.ops.intwrap import wrap32
from espflix_tpu_torch.ops import vlc_scan as VS
from espflix_tpu_torch.runtime import telemetry
# the per-tick xs keys (runtime/chunk_layout.py)
from espflix_tpu_torch.runtime.chunk_layout import (  # noqa: F401
    DECODE_KEYS, DECODE_KEYS_DW, OUTPUT_KEYS, SCROLL_KEYS)
from espflix_tpu_torch.runtime.output import _SIN32


def beep_wave(n_samples: int) -> np.ndarray:
    """The key-feedback sine at >>2 amplitude (espflix.ino:109-120)."""
    return (_SIN32[np.arange(n_samples) & 31] >> 2).astype(np.int16)


def state_from_numpy(frames: dict, sbc_state, ds_state, device):
    """The JAX package's carries (numpy) -> the port's tensors: frames
    y/u/v uint8[N, 2, H, W] + parity int32[N], SBC history
    int32[N, 2, 10, 16], PDM state int32[N, 3].  A decode-only fleet
    has no PDM state: ds_state None gives None."""
    def t(a, dtype):
        return torch.from_numpy(np.array(a, dtype=dtype)).to(device)
    fr = {k: t(frames[k], np.uint8) for k in "yuv"}
    fr["parity"] = t(frames["parity"], np.int32)
    return (fr, t(sbc_state, np.int32),
            None if ds_state is None else t(ds_state, np.int32))


def state_to_numpy(frames: dict, sbc_state, ds_state):
    """Inverse of state_from_numpy."""
    fr = {k: frames[k].cpu().numpy() for k in ("y", "u", "v", "parity")}
    return (fr, sbc_state.cpu().numpy(),
            None if ds_state is None else ds_state.cpu().numpy())


def audio_out(pcm, ds_state, beep_left, aud_act, starved, wave):
    """Beep / starve / silence selects around the PDM (chain.py:129-137):
    beeping lanes play `wave` for beep_left*128 samples, starved or idle
    lanes emit 0xAAAA words and keep their modulator state.  The PDM is
    DS.modulate (K5 on CUDA tensors).  Returns (pdm int32[N, 2S],
    ds_state)."""
    S = wave.shape[0]
    pcm = pcm[:, :S]
    t = torch.arange(S, device=pcm.device)[None, :]
    beeping = t < (beep_left * 128)[:, None]
    pcm = torch.where(beeping, wave[None, :], pcm)
    pdm, ds2 = DS.modulate(pcm, ds_state, n_samples=S)
    silent = starved | ~(aud_act | (beep_left > 0))
    pdm = torch.where(silent[:, None], DS.SILENCE_WORD, pdm)
    return pdm, torch.where(silent[:, None], ds_state, ds2)


class FullChain(nn.Module):
    """K full decode -> signal ticks per call, with the chain's constant
    tables as buffers on one device.  The SBC channel count is a call
    argument (a fleet discovers it from its streams)."""

    def __init__(self, *, pal: bool, n_aud_frames: int, device):
        super().__init__()
        self.pal = pal
        self.n_aud_frames = n_aud_frames
        tmpl, dither, _g = CO._packed_consts(pal)
        lut, _bases, _bits = VS._mega_lut_np()

        def buf(name, a, dtype):
            self.register_buffer(
                name, torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                                      device=device), persistent=False)

        buf("scan_lut", lut, torch.int32)
        buf("zigzag", VS.ZZ_NP, torch.int32)
        buf("scale_dct", IDCT.scale_dct_q("cpu"), torch.int32)
        buf("templates", tmpl, torch.int16)
        buf("dither", dither, torch.int16)
        # long enough for two channels; a call uses its first S samples
        buf("beep", beep_wave(n_aud_frames * 128 * 2), torch.int16)

    def tick(self, x: dict, frames: dict, sbc_state, ds_state, tap_idx,
             *, mb_width: int, mb_height: int, n_lanes: int,
             long_rows: int, steps_long: int, steps_short: int, tap: int,
             return_planes: bool, win: int, chunk: int, channels: int,
             slide=None, timer=None, lane0: int | None = None):
        """One tick: returns (sbc_state, ds_state, out); frames are
        updated in place.  slide: (y, u, v) outgoing-frame planes when
        the tick is scrolled (x["hscroll"] per lane), else None.
        timer(stage) is a context manager factory around each stage
        (telemetry.STAGES), or None: a caller's (chip_smoke.py, the
        bench's stage timers) or, from forward while a profiler records
        and no caller gives one, telemetry.ChainSpans.stage.  lane0:
        this shard's first global lane under a mesh -- tap_idx is then
        global and the taps come back masked (int32 fields, zero for
        tapped lanes of other shards) for the caller to sum over the
        shards (chain.py:160-178); None: tap_idx indexes these lanes."""
        from contextlib import nullcontext
        stage = timer or (lambda _name: nullcontext())
        F = self.n_aud_frames
        S = F * 128 * max(channels, 1)

        with stage("scan"):
            if win:
                words = VS.gather_scan_rows(x["lane_words"], x["row_base"],
                                            x["lane_of_row"], win)
            else:
                words = x["words"]
            coeffs_T, recs, nfinal, err, _it = VS.run_scan_bucketed_dense(
                words, *[x[k] for k in DECODE_KEYS[1:9]],
                mb_width=mb_width, mb_height=mb_height, n_lanes=n_lanes,
                long_rows=long_rows, steps_long=steps_long,
                steps_short=steps_short, chunk=chunk, lut=self.scan_lut,
                zigzag=self.zigzag)
        with stage("idct+compose"):
            frames, p = M.dense_compose(
                coeffs_T, recs, nfinal, x["intra_q"], x["non_intra_q"],
                x["active"], frames, mb_width=mb_width,
                mb_height=mb_height, scale_dct=self.scale_dct)
        with stage("composite"):
            if slide is not None:
                ye, ue, ve = CO.apply_hscroll(p["y"], p["u"], p["v"],
                                              *slide, x["hscroll"])
            else:
                ye, ue, ve = p["y"], p["u"], p["v"]
            f_act, f_strip, f_sum = CO.synthesize_field_pair_parts(
                ye, ue, ve, x["parity"], x["osd"], x["blend"],
                x["progress"], pal=self.pal, tmpl=self.templates,
                dither=self.dither)
        with stage("sbc"):
            pcm, sbc_state, aerr, _ = dsbc.decode_frames_batched(
                x["aud_words"], sbc_state, active=x["aud_act"],
                n_valid=x["aud_nval"], n_frames=F, channels=channels)
        with stage("pdm"):
            pdm, ds_state = audio_out(pcm, ds_state, x["beep_left"],
                                      x["aud_act"], x["starved"],
                                      self.beep[:S])

        out = dict(
            err=err,
            audio_err=aerr.any(dim=1),
            field_sum=f_sum,
            pdm_sum=wrap32(pdm.sum(dim=1)),
        )
        if return_planes:
            out.update(y=p["y"], u=p["u"], v=p["v"])
        else:
            out["ysum"] = wrap32(p["y"].sum(dim=(1, 2), dtype=torch.int64))
        if tap:
            ti = tap_idx[:tap].long()
            if lane0 is not None:
                ti = ti - lane0
                inside = (ti >= 0) & (ti < n_lanes)
                ti = ti.clamp(0, n_lanes - 1)
            out["tap_fields"] = CO.field_canvas(
                f_act[ti], f_strip[ti], pal=self.pal, tmpl=self.templates)
            out["tap_pdm"] = pdm[ti]
            if lane0 is not None:
                out["tap_fields"] = torch.where(
                    inside[:, None, None, None],
                    out["tap_fields"].to(torch.int32), 0)
                out["tap_pdm"] = torch.where(inside[:, None],
                                             out["tap_pdm"], 0)
        return sbc_state, ds_state, out

    def forward(self, xs: dict, frames: dict, sbc_state, ds_state,
                tap_idx, *, mb_width: int, mb_height: int, n_lanes: int,
                long_rows: int, steps_long: int, steps_short: int,
                tap: int, channels: int = 1, return_planes: bool = True,
                win: int = 0, chunk: int = 128, scrolled: bool = False,
                slide=None, timer=None):
        """K ticks (see run_full_chunk); slide is used when scrolled.
        While a profiler records and `timer` is None, the stages get the
        chain's own spans and the call appends a "chain" record
        (runtime/telemetry.ChainSpans)."""
        K = next(iter(xs.values())).shape[0]
        spans = None
        if timer is None and telemetry.tracing():
            spans = telemetry.ChainSpans(self.scan_lut.device)
            timer = spans.stage
        outs = []
        for k in range(K):
            x = {key: v[k] for key, v in xs.items()}
            sbc_state, ds_state, out = self.tick(
                x, frames, sbc_state, ds_state, tap_idx,
                mb_width=mb_width, mb_height=mb_height, n_lanes=n_lanes,
                long_rows=long_rows, steps_long=steps_long,
                steps_short=steps_short, tap=tap,
                return_planes=return_planes, win=win, chunk=chunk,
                channels=channels, slide=slide if scrolled else None,
                timer=timer)
            outs.append(out)
        stacked = {key: torch.stack([o[key] for o in outs])
                   for key in outs[0]}
        if spans is not None:
            spans.close(K)
        return frames, sbc_state, ds_state, stacked


def run_full_chunk(xs, frames, sbc_state, ds_state, tap_idx, slide,
                   *, mb_width: int, mb_height: int, n_lanes: int,
                   long_rows: int, steps_long: int, steps_short: int,
                   n_aud_frames: int, channels: int, pal: bool,
                   scrolled: bool, tap: int, interpret: bool = False,
                   return_planes: bool = True, win: int = 0,
                   chunk: int = 128, timer=None):
    """K full decode -> signal ticks (espflix_tpu.runtime.chain
    .run_full_chunk's signature and outs, plus `timer`, FullChain.tick's
    optional stage-timer factory).

    xs: dict of [K, ...] tensors (DECODE_KEYS or DECODE_KEYS_DW with
    win > 0, plus OUTPUT_KEYS, plus SCROLL_KEYS when scrolled;
    xs_to_torch converts host arrays).  tap_idx: int32[max(tap, 1)]
    lanes whose full signal is returned.  slide: (y, u, v) uint8[N, H, W]
    outgoing-frame planes the scrolled ticks wrap against (unused
    unless scrolled).  `interpret` has no effect: the device of the
    tensors picks kernels or plain forms.

    Returns (frames, sbc_state, ds_state, outs) with outs per tick:
    err / audio_err bool[K, N], field_sum / pdm_sum int32[K, N], y/u/v
    uint8[K, N, H, W] when return_planes (else ysum int32[K, N]; the
    presented planes, never the scrolled ones), tap_fields uint8[K, tap,
    2, L, W] and tap_pdm int32[K, tap, 2S] when tap > 0.  frames are
    updated in place and returned."""
    del interpret
    chain = FullChain(pal=pal, n_aud_frames=n_aud_frames,
                      device=frames["y"].device)
    return chain(xs, frames, sbc_state, ds_state, tap_idx,
                 mb_width=mb_width, mb_height=mb_height, n_lanes=n_lanes,
                 long_rows=long_rows, steps_long=steps_long,
                 steps_short=steps_short, tap=tap, channels=channels,
                 return_planes=return_planes, win=win, chunk=chunk,
                 scrolled=scrolled, slide=slide, timer=timer)


_CHAINS: dict = {}


def _chain_on(device, pal: bool, n_aud_frames: int) -> FullChain:
    key = (torch.device(device), pal, n_aud_frames)
    if key not in _CHAINS:
        _CHAINS[key] = FullChain(pal=pal, n_aud_frames=n_aud_frames,
                                 device=device)
    return _CHAINS[key]


def make_sharded_full_chunk(mesh, *, mb_width: int, mb_height: int,
                            n_lanes: int, long_rows: int,
                            steps_long: int, steps_short: int,
                            n_aud_frames: int, channels: int,
                            pal: bool, scrolled: bool, tap: int,
                            return_planes: bool = False,
                            win: int = 0, chunk: int = 128):
    """The full chain under a 'streams' mesh (chain.py:223-299):
    fn(xs, frames, sbc_state, ds_state, tap_idx, slide) -> (frames,
    sbc_state, ds_state, outs), run_full_chunk's contract per shard.

    n_lanes is the GLOBAL lane count; long_rows and the budgets are
    per shard.  xs leaves are [K, lanes-or-rows, ...] cut along axis
    1 (rows pre-packed per shard by scan_dense.
    pack_slice_rows_sharded); frames, SBC history, PDM state and,
    when scrolled, slide are cut along axis 0 (parallel/mesh.
    Sharded; tensors are sharded on entry).  Each tick runs
    FullChain.tick on every shard (K1-K5 on a card) before the next
    tick starts; tap_idx holds GLOBAL lanes, and each tick's taps are
    the sum over the shards of their masked taps, on the mesh's first
    device (the JAX chain's masked psum).  outs: err, audio_err,
    field_sum, pdm_sum and y/u/v (or ysum) Sharded along axis 1;
    tap_fields / tap_pdm one tensor each."""
    from espflix_tpu_torch.parallel import mesh as PM
    n_sh = mesh.shape["streams"]
    assert mesh.axis_names == ("streams",) and n_lanes % n_sh == 0
    n_loc = n_lanes // n_sh
    devs = mesh.device_list()
    dev0 = mesh.first
    kw = dict(mb_width=mb_width, mb_height=mb_height, n_lanes=n_loc,
              long_rows=long_rows, steps_long=steps_long,
              steps_short=steps_short, tap=tap,
              return_planes=return_planes, win=win, chunk=chunk,
              channels=channels)

    def fn(xs, frames, sbc_state, ds_state, tap_idx, slide):
        xs = PM.shard_axis1_tree(mesh, xs)
        frames = PM.shard_lane_tree(mesh, frames)
        sbc = list(PM.shard_lane_tree(mesh, sbc_state))
        ds = list(PM.shard_lane_tree(mesh, ds_state))
        slides = PM.shard_lane_tree(mesh, slide) if scrolled else None
        frs = [PM.local(frames, i) for i in range(len(devs))]
        taps = [tap_idx.to(d) for d in devs]
        K = next(iter(xs.values()))[0].shape[0]
        per_shard = [[] for _ in devs]
        tap_out = []
        for k in range(K):
            tick_taps = []
            for i, dev in enumerate(devs):
                x = {key: v[i][k] for key, v in xs.items()}
                sbc[i], ds[i], out = _chain_on(
                    dev, pal, n_aud_frames).tick(
                    x, frs[i], sbc[i], ds[i], taps[i], **kw,
                    slide=PM.local(slides, i) if scrolled else None,
                    lane0=i * n_loc)
                if tap:
                    tick_taps.append((out.pop("tap_fields"),
                                      out.pop("tap_pdm")))
                per_shard[i].append(out)
            if tap:
                tap_out.append((
                    sum(f.to(dev0) for f, _ in tick_taps)
                    .to(torch.uint8),
                    sum(p.to(dev0) for _, p in tick_taps)))
        outs = PM.stack_shards([
            {key: torch.stack([o[key] for o in shard_outs])
             for key in shard_outs[0]} for shard_outs in per_shard])
        if tap:
            outs["tap_fields"] = torch.stack([f for f, _ in tap_out])
            outs["tap_pdm"] = torch.stack([p for _, p in tap_out])
        return (PM.stack_shards(frs), PM.Sharded(sbc), PM.Sharded(ds),
                outs)
    return fn
