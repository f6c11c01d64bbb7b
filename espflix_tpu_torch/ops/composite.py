"""NTSC/PAL composite synthesis: both fields of a frame, parts form (K4).

The port of espflix_tpu.ops.composite_pallas.synthesize_field_pair_parts
(composite_pallas.py:205-264) and of its tap helpers
assemble_canvas_packed / unpack_fields (:280-317).  The signal stays
packed (one int16 = two DAC bytes, little-endian) and in parts form:
per-field active sample pairs [N, 2, 192, 352], ONE OSD strip
[N, 16, W2] shared by both fields, and the complete per-lane canvas
byte sum (the constant template bytes enter as ``_parts_consts``' base).
``apply_hscroll`` (plain torch; XLA in the JAX package) is the flip
animation's wraparound blit that the scrolled chain applies first.

The constants (dither planes, line templates and their packed form) are
numpy code copied from espflix_tpu.ops.composite / composite_pallas and
pinned equal by tests/test_torch_host.py.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from espflix_tpu_torch.video import tables as T
from espflix_tpu_torch.ops.intwrap import wrap16, wrap32

OSD_W, OSD_H = 80, 16
OSD_PROGRESS_W = 352 - OSD_W - 32  # 240

launches = 0            # K4 launches (counted by the CUDA path only)


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


def synthesize_field_pair_parts(y, u, v, frame_parity, osd, osd_blend,
                                osd_progress, *, pal: bool, tmpl,
                                dither):
    """Both composite fields of a frame per lane, parts form.

    y uint8[N, 192, 352]; u, v uint8[N, 96, 176]; frame_parity,
    osd_blend, osd_progress int32[N]; osd uint8[N, 16, 80]; tmpl
    int16[L, W2] and dither int16[2, 192, 352] from _packed_consts(pal)
    on the same device.  Returns (act int16[N, 2, 192, 352], strip
    int16[N, 16, W2], chk int32[N] incl. the template base).  CPU
    tensors take the plain form; CUDA tensors launch K4
    (csrc/composite.cu)."""
    global launches
    if y.device.type == "cpu":
        return synthesize_field_pair_parts_torch(
            y, u, v, frame_parity, osd, osd_blend, osd_progress, pal=pal,
            tmpl=tmpl, dither=dither)
    if y.device.type != "cuda":
        raise ValueError(f"unsupported device {y.device}")
    from espflix_tpu_torch import build

    if T.BLACK_LEVEL != 24:
        raise RuntimeError("csrc/composite.cu assumes BLACK_LEVEL == 24")
    base, g = _parts_consts(pal)
    gi = _geometry_ints(g)
    dev = y.device
    N = y.shape[0]
    W2 = tmpl.shape[1]
    build.check(y, dev, torch.uint8, (N, 192, 352))
    build.check(u, dev, torch.uint8, (N, 96, 176))
    build.check(v, dev, torch.uint8, (N, 96, 176))
    build.check(frame_parity, dev, torch.int32, (N,))
    build.check(osd, dev, torch.uint8, (N, OSD_H, OSD_W))
    build.check(osd_blend, dev, torch.int32, (N,))
    build.check(osd_progress, dev, torch.int32, (N,))
    build.check(tmpl, dev, torch.int16, (g.line_count, g.line_width // 2))
    build.check(dither, dev, torch.int16, (2, 192, 352))
    act = torch.empty((N, 2, 192, 352), dtype=torch.int16, device=dev)
    strip = torch.empty((N, OSD_H, W2), dtype=torch.int16, device=dev)
    chk = torch.zeros(N, dtype=torch.int32, device=dev)
    build.launch("esp_composite_parts", y, u, v, frame_parity, osd,
                 osd_blend, osd_progress, tmpl, dither, act, strip, chk, N,
                 W2, int(pal), gi["osd_top"], gi["osd_xp"], gi["bar_xp"],
                 base)
    launches += 1
    return act, strip, chk


def assemble_canvas_packed(act, strip, *, pal: bool, tmpl):
    """(act, strip) -> the full packed canvas int16[N, 2, L, W2]."""
    _t, _d, g = _packed_consts(pal)
    N = act.shape[0]
    L, W2 = tmpl.shape
    xp = g.active_x0() // 2
    canvas = tmpl[None, None].expand(N, 2, L, W2).clone()
    canvas[:, :, g.active_top:g.active_top + 192, xp:xp + 352] = act
    canvas[:, :, g.osd_top:g.osd_top + OSD_H, :] = strip[:, None]
    return canvas


# ease-in/out scroll animator table (video.cpp:1077), indexed by the
# per-field countdown |animate_index| - 1; sign selects direction
EASE = np.array([0, 8, 16, 24, 48, 72, 104, 136,
                 176, 216, 248, 280, 304, 328, 336, 344], np.int32)


def apply_hscroll(y, u, v, y2, u2, v2, hscroll):
    """Per-lane wraparound blit between two frame buffers (the port of
    espflix_tpu.ops.composite.apply_hscroll): displayed plane = columns
    [h, W) of the primary frame followed by columns [0, h) of the
    secondary; a negative hscroll swaps which buffer leads, with
    h = hscroll + W.  Chroma scrolls by h >> 1.  hscroll: int32[N] in
    [-W, W]; 0 = no animation."""
    N, H, W = y.shape
    neg = hscroll < 0
    h = torch.where(neg, hscroll + W, hscroll).long()
    m = neg[:, None, None]

    def wrap(a, b, off):
        first, second = torch.where(m, b, a), torch.where(m, a, b)
        w = a.shape[2]
        cols = (torch.arange(w, device=a.device)[None, :]
                + off[:, None]) % (2 * w)                   # [N, w]
        both = torch.cat([first, second], dim=2)            # [N, H, 2w]
        return torch.gather(both, 2,
                            cols[:, None, :].expand(N, a.shape[1], w))

    return wrap(y, y2, h), wrap(u, u2, h >> 1), wrap(v, v2, h >> 1)


def unpack_fields(packed):
    """int16[N, 2, L, W/2] -> uint8[N, 2, L, W] (little-endian pairs)."""
    N, F2, L, W2 = packed.shape
    p = packed.to(torch.int32) & 0xFFFF
    return torch.stack([p & 0xFF, p >> 8], dim=-1).reshape(
        N, F2, L, W2 * 2).to(torch.uint8)
