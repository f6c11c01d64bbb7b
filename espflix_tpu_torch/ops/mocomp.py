"""Half-pel motion compensation fused with compose and the parity put (K3).

Prediction follows the JAX package's main-path edge rule
(espflix_tpu.ops.mocomp.predict_plane_mxu, mocomp.py:124-175, and the
Pallas kernels predict_plane_phase2p / predict_chroma_pair_packedp):
each MB's window origin is clamped, clip(xh >> 1, 0, W - S), and taps
past the plane read zero; MPEG-1 rounding (a+b+1)>>1, (a+b+c+d+2)>>2.
Compose and put follow models/mpeg1.dense_compose (mpeg1.py:562-664):
STALE keeps the current picture, INTRA is pin(res), everything else
pin(int16(pred + res)) with pin = clip to 0..248; each live lane's new
picture goes into its parity slot, inactive lanes keep theirs.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from espflix_tpu_torch.ops.vlc_scan import MAX_MB_WIDTH, MB_INTRA, \
    MB_STALE

launches = 0            # K3 launches (counted by the CUDA path only)


def _sext12(x):
    x = x & 0xFFF
    return torch.where(x >= 0x800, x - 0x1000, x)


def mb_fields(recs, mb_width: int, mb_height: int):
    """recs int32[N, MB] -> (kind, mv_h, mv_v) int32[N, mbh, mbw]."""
    N = recs.shape[0]
    shape = (N, mb_height, mb_width)
    return ((recs & 3).reshape(shape), _sext12(recs >> 7).reshape(shape),
            _sext12(recs >> 19).reshape(shape))


def predict_plane_torch(ref, mv_h, mv_v, mb_size: int):
    """uint8[N, H, W] prediction of every MB from `ref` (clamped window
    origin, zero past the plane)."""
    N, H, W = ref.shape
    mbh, mbw = mv_h.shape[1], mv_h.shape[2]
    S = mb_size
    dev = ref.device
    refp = F.pad(ref.to(torch.int32), (0, 1, 0, 1)).reshape(N, -1)
    xh = (torch.arange(mbw, device=dev) * 2 * S)[None, None, :] + mv_h
    yh = (torch.arange(mbh, device=dev) * 2 * S)[None, :, None] + mv_v
    x0 = (xh >> 1).clamp(0, W - S)
    y0 = (yh >> 1).clamp(0, H - S)
    k = torch.arange(S + 1, device=dev)
    yy = (y0[..., None] + k)[..., :, None]
    xx = (x0[..., None] + k)[..., None, :]
    idx = (yy * (W + 1) + xx).reshape(N, -1)
    win = torch.gather(refp, 1, idx).reshape(N, mbh, mbw, S + 1, S + 1)
    a = win[..., :S, :S]
    b = win[..., :S, 1:]
    c = win[..., 1:, :S]
    d = win[..., 1:, 1:]
    hx = ((xh & 1) == 1)[..., None, None]
    hy = ((yh & 1) == 1)[..., None, None]
    out = torch.where(~hx & ~hy, a, torch.where(
        hx & ~hy, (a + b + 1) >> 1, torch.where(
            ~hx & hy, (a + c + 1) >> 1, (a + b + c + d + 2) >> 2)))
    return out.permute(0, 1, 3, 2, 4).reshape(N, H, W).to(torch.uint8)


def residual_planes(res_T, mb_width: int, mb_height: int):
    """res_T int16[N, 64, MB*6] -> (ry [N, H, W], ru, rv [N, H/2, W/2])
    in raster order (the JAX package's transposed plane assembly)."""
    N = res_T.shape[0]
    H, W = mb_height * 16, mb_width * 16
    rT = res_T.reshape(N, 8, 8, mb_height, mb_width, 6)
    ry = rT[..., :4].reshape(N, 8, 8, mb_height, mb_width, 2, 2) \
        .permute(0, 3, 5, 1, 4, 6, 2).reshape(N, H, W)
    ru = rT[..., 4].permute(0, 3, 1, 4, 2).reshape(N, H // 2, W // 2)
    rv = rT[..., 5].permute(0, 3, 1, 4, 2).reshape(N, H // 2, W // 2)
    return ry, ru, rv


def predict_compose_put_torch(res_T, recs, active, frames, *,
                              mb_width: int, mb_height: int):
    """Plain form of K3 (same contract as predict_compose_put)."""
    N = recs.shape[0]
    lanes = torch.arange(N, device=recs.device)
    parity = frames["parity"].long()
    kind, mv_h, mv_v = mb_fields(recs, mb_width, mb_height)
    resid = residual_planes(res_T, mb_width, mb_height)
    presented = {}
    for key, res, S in zip("yuv", resid, (16, 8, 8)):
        planes = frames[key]
        cur = planes[lanes, parity]
        ref = planes[lanes, 1 - parity]
        mh, mv = (mv_h, mv_v) if S == 16 else (mv_h >> 1, mv_v >> 1)
        pred = predict_plane_torch(ref, mh, mv, S)

        def up(m):
            return m.repeat_interleave(S, 1).repeat_interleave(S, 2)

        pinned = torch.where(up(kind == MB_INTRA), res,
                             pred.to(torch.int16) + res).clamp(0, 248)
        new = torch.where(up(kind == MB_STALE), cur,
                          pinned.to(torch.uint8))
        upd = torch.where(active[:, None, None], new, cur)
        planes[lanes, parity] = upd
        presented[key] = upd
    return presented


def predict_compose_put(res_T, recs, active, frames, *, mb_width: int,
                        mb_height: int):
    """Predict every MB from the reference slot, compose with the
    residuals and put the result into each live lane's parity slot.

    res_T int16[N, 64, MB*6] (K2's output); recs int32[N, MB]; active
    bool[N]; frames y/u/v uint8[N, 2, H, W] (+ parity int32[N]) are
    written IN PLACE (slot `parity` only; the parity is not flipped
    here).  Returns presented y/u/v uint8[N, H, W] as new tensors.
    CPU tensors take the plain form; CUDA tensors launch K3
    (csrc/compose.cu)."""
    global launches
    if res_T.device.type == "cpu":
        return predict_compose_put_torch(res_T, recs, active, frames,
                                         mb_width=mb_width,
                                         mb_height=mb_height)
    if res_T.device.type != "cuda":
        raise ValueError(f"unsupported device {res_T.device}")
    from espflix_tpu_torch import build

    if mb_width > MAX_MB_WIDTH:
        raise ValueError(f"mb_width {mb_width} > {MAX_MB_WIDTH}")
    dev = res_T.device
    N = recs.shape[0]
    H, W = mb_height * 16, mb_width * 16
    build.check(res_T, dev, torch.int16, (N, 64, mb_width * mb_height * 6))
    build.check(recs, dev, torch.int32, (N, mb_width * mb_height))
    build.check(active, dev, torch.bool, (N,))
    build.check(frames["parity"], dev, torch.int32, (N,))
    build.check(frames["y"], dev, torch.uint8, (N, 2, H, W))
    build.check(frames["u"], dev, torch.uint8, (N, 2, H // 2, W // 2))
    build.check(frames["v"], dev, torch.uint8, (N, 2, H // 2, W // 2))
    pres = {k: torch.empty(frames[k].shape[:1] + frames[k].shape[2:],
                           dtype=torch.uint8, device=dev) for k in "yuv"}
    build.launch("esp_compose_put", res_T, recs, active, frames["parity"],
                 frames["y"], frames["u"], frames["v"], pres["y"],
                 pres["u"], pres["v"], N, mb_width, mb_height)
    launches += 1
    return pres
