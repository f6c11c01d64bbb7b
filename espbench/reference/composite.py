"""Both composite fields of a frame per lane: the plain form.

A frozen copy of the plain PyTorch form of the port's composite
synthesis (espflix_tpu_torch/ops/composite.py:
synthesize_field_pair_parts_torch, field_canvas and their constants),
kept with the benchmark so that the yardstick does not move when the
program changes.  ``field_pair_parts`` gives (act, strip, field_sum)
and ``field_canvas`` lays them into whole uint8 fields; both run on any
device with plain torch operations.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from espbench.reference import video_tables as T


def wrap16(x: torch.Tensor) -> torch.Tensor:
    """Low 16 bits as int16 (C int16_t wraparound)."""
    x = x.to(torch.int64) & 0xFFFF
    return torch.where(x >= 0x8000, x - 0x10000, x).to(torch.int16)


def wrap32(x: torch.Tensor) -> torch.Tensor:
    """Low 32 bits as int32 (C int32_t wraparound)."""
    x = x.to(torch.int64) & 0xFFFFFFFF
    return torch.where(x >= 0x80000000, x - 0x100000000, x).to(torch.int32)


OSD_W, OSD_H = 80, 16
OSD_PROGRESS_W = 352 - OSD_W - 32  # 240

@functools.cache
def _dither_planes(h: int, w: int):
    """Static [2, h, w] dither fields (one per frame parity): the 4x4
    ordered pattern tiled over the active region."""
    rows = np.arange(h) & 3
    cols = np.arange(w) & 3
    out = np.stack([T.DITHER4x4[p * 4 + rows][:, cols]
                    for p in (0, 1)])
    return out.astype(np.int32)


def _line_templates(pal: bool) -> np.ndarray:
    """[4, line_width] uint8: 0=blank(even), 1=blank(odd), 2..: vsync."""
    g = T.Geometry(pal)
    W = g.line_width
    if not pal:
        blank = np.full(W, T.BLACK_LEVEL, np.uint8)
        blank[:g.hsync] = T.SYNC_LEVEL
        blank[g.hsync:g.hsync + 40] = T.Geometry(False).burst_ntsc()
        vsync = np.full(W, T.BLANKING_LEVEL, np.uint8)
        vsync[:g.hsync_long] = T.SYNC_LEVEL
        return np.stack([blank, blank, vsync, vsync])
    b0, b1 = g.bursts_pal()
    blanks = []
    for b in (b1, b0):     # line_counter&1 ? b0 : b1 (video.cpp:639)
        ln = np.full(W, T.BLACK_LEVEL, np.uint8)
        ln[:g.hsync] = T.SYNC_LEVEL
        ln[g.burst_start:g.burst_start + g.burst_width] = \
            np.clip(b, 0, 255).astype(np.uint8)
        blanks.append(ln)
    # vsync half-line patterns (video.cpp:918-934)

    def half(flag_long):
        w = W // 2
        ln = np.full(w, T.BLANKING_LEVEL, np.uint8)
        sw = g.hsync_long if flag_long else g.hsync_short
        ln[:sw] = T.SYNC_LEVEL
        return ln
    sync_types = [0, 0, 0, 3, 3, 2, 0, 0]
    vs = [np.concatenate([half(t & 2), half(t & 1)]) for t in sync_types]
    return np.stack(blanks + vs)


@functools.cache
def _templates_cached(pal: bool):
    return _line_templates(pal)


@functools.cache
def _packed_consts(pal: bool):
    """(templates int16[line_count, W/2], dither int16[2, 192, 352],
    geometry)."""
    g = T.Geometry(pal)
    tm = _templates_cached(pal)
    lines = np.arange(g.line_count)
    if not pal:
        tidx = np.where(lines >= g.vsync_start, 2, lines & 1)
    else:
        tidx = np.where(lines >= g.vsync_start,
                        2 + (lines - g.vsync_start), lines & 1)
    full = tm[tidx].astype(np.int32)                  # [L, W] bytes
    packed = (full[:, 0::2] | (full[:, 1::2] << 8)).astype(np.int16)
    dither = _dither_planes(192, 352).astype(np.int16)
    return packed, dither, g


@functools.cache
def _parts_consts(pal: bool):
    """(base_sum, geometry): byte sum of the full two-field template
    canvas MINUS the template bytes under the active regions (both
    fields) and the OSD strip rows (both fields)."""
    tmpl, _dith, g = _packed_consts(pal)
    t32 = tmpl.astype(np.int64) & 0xFFFF
    by = (t32 & 0xFF) + (t32 >> 8)
    total = int(by.sum())
    xp = g.active_x0() // 2
    act = int(by[g.active_top:g.active_top + 192, xp:xp + 352].sum())
    osd = int(by[g.osd_top:g.osd_top + 16, :].sum())
    return 2 * (total - act - osd), g


def _geometry_ints(g):
    x0 = g.active_x0()
    return dict(osd_xp=(x0 + 16) // 2, bar_xp=(x0 + 16 + 160 + 16) // 2,
                osd_top=g.osd_top)


def _prep(c):
    """Chroma [N, 96, 176] -> [N, 192, 352] int32: odd lines average
    with the next chroma row (clamped), columns doubled."""
    c = c.to(torch.int32)
    c1 = torch.cat([c[:, 1:], c[:, -1:]], dim=1)
    c0 = c.repeat_interleave(2, dim=1)
    c1 = c1.repeat_interleave(2, dim=1)
    odd = (torch.arange(c0.shape[1], device=c.device) & 1)[None, :, None]
    ci = torch.where(odd == 1, (c0 >> 1) + (c1 >> 1), c0)
    return ci.repeat_interleave(2, dim=2)


def synthesize_field_pair_parts_torch(y, u, v, frame_parity, osd,
                                      osd_blend, osd_progress, *,
                                      pal: bool, tmpl, dither):
    """Plain form of K4 (same contract as synthesize_field_pair_parts)."""
    base, g = _parts_consts(pal)
    gi = _geometry_ints(g)
    N = y.shape[0]
    dev = y.device
    W2 = tmpl.shape[1]
    bias = 2 * T.BLACK_LEVEL

    def amp(c):
        m = (128 - c) * T.BLACK_LEVEL
        return torch.sign(m) * (((2 * m.abs() + 33) * 3972) >> 18)

    ru = amp(_prep(u))
    rv = amp(_prep(v))
    pu_m = (bias - ru).clamp(0, 127)
    pu_p = (bias + ru).clamp(0, 127)
    pv_m = (bias - rv).clamp(0, 127)
    pv_p = (bias + rv).clamp(0, 127)
    rows = torch.arange(192, device=dev)[None, :, None]
    vsw = ((rows & 1) == 1) if pal else torch.zeros_like(rows).bool()
    k2v = torch.where(vsw, pv_p, pv_m)
    k3v = torch.where(vsw, pv_m, pv_p)
    cw0 = ((pu_m + bias) & 0xFC) >> 2
    cw1 = ((pu_p + bias) & 0xFC) >> 2
    cw2 = ((bias + k2v) & 0xFC) >> 2
    cw3 = ((bias + k3v) & 0xFC) >> 2
    col = torch.arange(352, device=dev)[None, None, :]
    col_odd = (col & 1) == 1
    cxa = torch.where(col_odd, cw2, cw3)
    cxb = torch.where(col_odd, cw0, cw1)

    y32 = y.to(torch.int32)
    par = (frame_parity.to(torch.int64) & 1)
    d = dither.to(torch.int32)
    acts = []
    act_sum = torch.zeros(N, dtype=torch.int64, device=dev)
    for f in range(2):
        df = d[(par + f) & 1]                          # [N, 192, 352]
        P = (y32 + df) & 0xFC
        p0 = P >> 2
        Pm1 = torch.cat([torch.zeros_like(P[:, :, :1]), P[:, :, :-1]], 2)
        p0m1 = Pm1 >> 2
        sa = torch.where((col & 3) == 0, (p0 + p0m1) >> 1,
                         ((Pm1 >> 1) + (P >> 1)) >> 2)
        sac = (sa + cxa) & 0xFF
        pbc = (p0 + cxb) & 0xFF
        acts.append(wrap16(sac | (pbc << 8)))
        act_sum += (sac + pbc).sum(dim=(1, 2))
    act = torch.stack(acts, dim=1)

    blend = osd_blend.to(torch.int32)
    scale = torch.where((blend != -1) & (blend < 32),
                        (63 * blend.clamp(min=0)) >> 5, 63)[:, None, None]
    show = (blend != 0)[:, None, None]
    text = ((T.BLACK_LEVEL << 8) + osd.to(torch.int32) * scale) >> 8
    c0 = ((T.BLACK_LEVEL << 8) + (scale << 8)) >> 8
    c1 = ((T.BLACK_LEVEL << 8) + (scale << 7)) >> 8
    top = gi["osd_top"]
    strip = (tmpl[top:top + OSD_H].to(torch.int32) & 0xFFFF)[None] \
        .expand(N, OSD_H, W2).clone()
    ox, bx = gi["osd_xp"], gi["bar_xp"]
    strip[:, :, ox:ox + OSD_W] = torch.where(
        show, text | (text << 8), strip[:, :, ox:ox + OSD_W])
    units = torch.arange(OSD_PROGRESS_W, device=dev)[None, :]
    filled = (units & ~1) < osd_progress.to(torch.int32)[:, None]
    bar = torch.where(filled[:, None, :], c0, c1)
    strip[:, 3:9, bx:bx + OSD_PROGRESS_W] = torch.where(
        show, bar | (bar << 8), strip[:, 3:9, bx:bx + OSD_PROGRESS_W])
    strip_sum = ((strip & 0xFF) + (strip >> 8)).sum(dim=(1, 2))
    chk = act_sum + 2 * strip_sum + base
    return act, wrap16(strip), wrap32(chk)


def field_canvas(act, strip, *, pal: bool, tmpl):
    """K4's parts as whole fields: act int16[N, F, 192, 352] (F fields,
    e.g. both or field 0 alone) and strip int16[N, 16, W/2] ->
    uint8[N, F, L, W], the line templates tmpl int16[L, W/2] with the
    active samples and the OSD strip laid in (the packed int16 pairs
    are little-endian byte pairs).  The copies move 8-byte words: the
    line width and the active region's origin and width are multiples
    of 8 bytes in both standards."""
    _t, _d, g = _packed_consts(pal)
    N, F = act.shape[:2]
    L = tmpl.shape[0]
    w64 = torch.int64
    canvas = tmpl.view(w64)[None, None].expand(N, F, L, -1).clone()
    x = g.active_x0() // 8
    canvas[:, :, g.active_top:g.active_top + 192, x:x + 88] = \
        act.view(w64)
    canvas[:, :, g.osd_top:g.osd_top + OSD_H, :] = \
        strip.view(w64)[:, None]
    return canvas.view(torch.uint8)


@functools.cache
def consts(pal: bool, device: str):
    """(templates int16[L, W/2], dither int16[2, 192, 352]) on device."""
    tmpl, dither, _g = _packed_consts(pal)
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                 for a in (tmpl, dither))


def field_pair_parts(y, u, v, frame_parity, osd, osd_blend, osd_progress,
                     *, pal: bool):
    """(act int16[N, 2, 192, 352], strip int16[N, 16, W/2], field_sum
    int32[N] incl. the template base) for planes y uint8[N, 192, 352],
    u, v uint8[N, 96, 176] and the per-lane OSD state."""
    tmpl, dither = consts(pal, str(y.device))
    return synthesize_field_pair_parts_torch(
        y, u, v, frame_parity, osd, osd_blend, osd_progress, pal=pal,
        tmpl=tmpl, dither=dither)


def field_pair(y, u, v, frame_parity, osd, osd_blend, osd_progress, *,
               pal: bool):
    """(uint8[N, 2, L, W] both whole fields, field_sum int32[N])."""
    act, strip, chk = field_pair_parts(y, u, v, frame_parity, osd,
                                       osd_blend, osd_progress, pal=pal)
    tmpl, _d = consts(pal, str(y.device))
    return field_canvas(act, strip, pal=pal, tmpl=tmpl), chk
