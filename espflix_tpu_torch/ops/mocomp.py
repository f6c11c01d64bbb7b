"""Half-pel motion compensation, fused with compose and the parity put.

K23 (idct_compose_put), the main path's, takes the scanner's raw levels
[N, 64, BL] and decodes each MB row's residuals in shared memory (K2's
dequant and IDCT) before K3's prediction, compose and put.  K3
(predict_compose_put) takes K2's [N, 64, BL] residuals; K3F
(predict_compose_put_flat) takes K2F's lane-minor [N, MB*6, 64] ones.
K3P (predict_plane, predict_chroma_pair, predict_plane_rows) predicts
alone, for the mesh's decoders, which compose in torch ops
(``compose_put``) as the JAX package composes in XLA.

Prediction follows the JAX package's main-path edge rule
(espflix_tpu.ops.mocomp.predict_plane_mxu, mocomp.py:124-175, and the
Pallas kernels predict_plane_phase2p / predict_chroma_pair_packedp):
each MB's window origin is clamped, clip(xh >> 1, 0, W - S), and taps
past the plane read zero; MPEG-1 rounding (a+b+1)>>1, (a+b+c+d+2)>>2.
Compose and put follow models/mpeg1.dense_compose (mpeg1.py:562-664):
STALE keeps the current picture, INTRA is pin(res), everything else
pin(int16(pred + res)) with pin = clip to 0..248; each live lane's new
picture goes into its parity slot, inactive lanes keep theirs.

The JAX package has a second edge rule, and K3P serves both: rule A
above (every Pallas predict kernel and predict_plane_mxu) and rule B,
each tap clamped into the plane, clip(x, 0, W - 1) (mocomp.predict_plane
and predict_plane_rows, mocomp.py:54-57, :208-211), which the 'space'
split of the mesh uses.  The two differ wherever a window touches the
right or bottom edge with a half-pel offset or reaches past the plane.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from espflix_tpu_torch.ops import idct as idct_ops
from espflix_tpu_torch.ops.vlc_scan import MAX_MB_WIDTH, MB_INTRA, \
    MB_STALE

launches_fused = 0      # K23 launches (counted by the CUDA path only)
launches = 0            # K3 launches (counted by the CUDA path only)
launches_flat = 0       # K3F launches (counted by the CUDA path only)
launches_predict = 0    # K3P launches (counted by the CUDA path only)


def _sext12(x):
    x = x & 0xFFF
    return torch.where(x >= 0x800, x - 0x1000, x)


def mb_fields(recs, mb_width: int, mb_height: int):
    """recs int32[N, MB] -> (kind, mv_h, mv_v) int32[N, mbh, mbw]."""
    N = recs.shape[0]
    shape = (N, mb_height, mb_width)
    return ((recs & 3).reshape(shape), _sext12(recs >> 7).reshape(shape),
            _sext12(recs >> 19).reshape(shape))


def _predict_band_torch(ref, mv_h, mv_v, mb_size: int, row0_mb: int,
                        clip_taps: bool):
    """uint8[N, mbh_loc*S, W] prediction of MB rows [row0_mb, row0_mb +
    mbh_loc) from the full-height `ref` [N, H, W]: rule B (clip_taps)
    or rule A."""
    N, H, W = ref.shape
    mbh, mbw = mv_h.shape[1], mv_h.shape[2]
    S = mb_size
    dev = ref.device
    xh = (torch.arange(mbw, device=dev) * 2 * S)[None, None, :] + mv_h
    yh = ((row0_mb + torch.arange(mbh, device=dev)) * 2 * S)[None, :, None] \
        + mv_v
    k = torch.arange(S + 1, device=dev)
    if clip_taps:
        # every tap clamped into the plane
        refp, Wp = ref.to(torch.int32).reshape(N, -1), W
        xx = ((xh >> 1)[..., None] + k).clamp(0, W - 1)
        yy = ((yh >> 1)[..., None] + k).clamp(0, H - 1)
    else:
        # clamped window origin, a zero row and column past the plane
        refp = F.pad(ref.to(torch.int32), (0, 1, 0, 1)).reshape(N, -1)
        Wp = W + 1
        xx = (xh >> 1).clamp(0, W - S)[..., None] + k
        yy = (yh >> 1).clamp(0, H - S)[..., None] + k
    idx = (yy[..., :, None] * Wp + xx[..., None, :]).reshape(N, -1)
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
    return out.permute(0, 1, 3, 2, 4).reshape(N, mbh * S, mbw * S) \
        .to(torch.uint8)


def predict_plane_torch(ref, mv_h, mv_v, mb_size: int):
    """uint8[N, H, W] prediction of every MB from `ref` (rule A:
    clamped window origin, zero past the plane)."""
    return _predict_band_torch(ref, mv_h, mv_v, mb_size, 0, False)


def predict_plane_rows_torch(ref_full, mv_h, mv_v, mb_size: int,
                             row0_mb: int = 0):
    """Plain form of predict_plane_rows (rule B)."""
    return _predict_band_torch(ref_full, mv_h, mv_v, mb_size, row0_mb, True)


def predict_chroma_pair_torch(ref_u, ref_v, mv_h, mv_v):
    """Plain form of predict_chroma_pair (rule A)."""
    return (predict_plane_torch(ref_u, mv_h, mv_v, 8),
            predict_plane_torch(ref_v, mv_h, mv_v, 8))


def _predict_operands(refs, mv_h, mv_v, S: int, row0_mb: int):
    """Check K3P's operands (reference planes `refs` sharing the
    vectors) and allocate one output band for each plane."""
    if refs[0].device.type != "cuda":
        raise ValueError(f"unsupported device {refs[0].device}")
    from espflix_tpu_torch import build

    N, H, W = refs[0].shape
    mbh, mbw = mv_h.shape[1], mv_h.shape[2]
    if S not in (8, 16) or mbw * S != W or not 0 <= row0_mb \
            or (row0_mb + mbh) * S > H:
        raise ValueError(f"band of {mbh} MB rows at {row0_mb} (S={S}) "
                         f"does not fit a {H}x{W} plane")
    dev = refs[0].device
    for ref in refs:
        build.check(ref, dev, torch.uint8, (N, H, W))
    build.check(mv_h, dev, torch.int32, (N, mbh, mbw))
    build.check(mv_v, dev, torch.int32, (N, mbh, mbw))
    outs = [torch.empty((N, mbh * S, W), dtype=torch.uint8, device=dev)
            for _ in refs]
    # K3P reads reference rows as aligned 32-bit words and stores each
    # MB row as one S-byte vector
    if W % S or any(r.data_ptr() % 4 for r in refs) \
            or any(o.data_ptr() % S for o in outs):
        raise ValueError(f"K3P needs W % {S} == 0 (W={W}), 4-byte "
                         f"aligned references and {S}-byte aligned "
                         f"outputs")
    return outs


def _predict(ref, mv_h, mv_v, mb_size: int, row0_mb: int, clip_taps: bool):
    """CPU tensors: the plain form; CUDA tensors: one K3P launch."""
    global launches_predict
    if ref.device.type == "cpu":
        return _predict_band_torch(ref, mv_h, mv_v, mb_size, row0_mb,
                                   clip_taps)
    from espflix_tpu_torch import build

    out, = _predict_operands([ref], mv_h, mv_v, mb_size, row0_mb)
    N, H, W = ref.shape
    build.launch("esp_predict", ref, ref, mv_h, mv_v, out, out, 1, N, H, W,
                 mb_size, mv_h.shape[2], mv_h.shape[1], row0_mb,
                 int(clip_taps))
    launches_predict += 1
    return out


def predict_plane(ref, mv_h, mv_v, mb_size: int):
    """Predict every MB of a plane: the port of mocomp_pallas.
    predict_plane_pallas and of every other Pallas predict variant
    (rule A).  ref uint8[N, H, W]; mv_h / mv_v int32[N, mbh, mbw]
    half-pel vectors at the plane's scale; mb_size 16 (luma) or 8.
    Returns uint8[N, H, W].  CPU tensors take the plain form
    (predict_plane_torch); CUDA tensors launch K3P (csrc/compose.cu)."""
    return _predict(ref, mv_h, mv_v, mb_size, 0, False)


def predict_chroma_pair(ref_u, ref_v, mv_h, mv_v):
    """Both chroma planes from chroma-scale vectors (the port of
    predict_chroma_pair_phase / _packed; rule A).  CPU tensors take the
    plain form (predict_chroma_pair_torch); CUDA tensors launch K3P
    once for both planes.  Returns (pred_u, pred_v)."""
    global launches_predict
    if ref_u.device.type == "cpu":
        return predict_chroma_pair_torch(ref_u, ref_v, mv_h, mv_v)
    from espflix_tpu_torch import build

    out_u, out_v = _predict_operands([ref_u, ref_v], mv_h, mv_v, 8, 0)
    N, H, W = ref_u.shape
    build.launch("esp_predict", ref_u, ref_v, mv_h, mv_v, out_u, out_v, 2,
                 N, H, W, 8, mv_h.shape[2], mv_h.shape[1], 0, 0)
    launches_predict += 1
    return out_u, out_v


def predict_plane_rows(ref_full, mv_h, mv_v, mb_size: int,
                       row0_mb: int = 0):
    """Predict a band of MB rows from the FULL reference plane: the port
    of mocomp.predict_plane_rows (rule B).  ref_full uint8[N, H, W];
    mv_h / mv_v int32[N, mbh_loc, mbw] for MB rows [row0_mb, row0_mb +
    mbh_loc).  Returns uint8[N, mbh_loc*S, W].  CPU tensors take the
    plain form; CUDA tensors launch K3P with rule B."""
    return _predict(ref_full, mv_h, mv_v, mb_size, row0_mb, True)


def compose_put(preds, resid, recs, active, frames, *, mb_width: int,
                mb_height: int):
    """Compose + put from predicted and residual planes in torch ops
    (models/mpeg1.dense_compose's compose and put, mpeg1.py:611-664).

    preds / resid: (y, u, v) uint8 / int16 planes of the frames' height
    (a band's, under the 'space' split); recs int32[N, mbh*mbw]; frames
    are updated IN PLACE in each live lane's parity slot.  Returns the
    presented y/u/v."""
    N = recs.shape[0]
    lanes = torch.arange(N, device=recs.device)
    parity = frames["parity"].long()
    kind = (recs & 3).reshape(N, mb_height, mb_width)
    presented = {}
    for key, pred, res, S in zip("yuv", preds, resid, (16, 8, 8)):
        planes = frames[key]
        cur = planes[lanes, parity]

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


def residual_planes_flat(res, mb_width: int, mb_height: int):
    """res int16[N, MB*6, 64] -> (ry [N, H, W], ru, rv [N, H/2, W/2]) in
    raster order (the JAX package's lane-minor plane assembly,
    mpeg1.py:592-609)."""
    N = res.shape[0]
    H, W = mb_height * 16, mb_width * 16
    r = res.reshape(N, mb_height, mb_width, 6, 8, 8)
    ry = r[:, :, :, :4].reshape(N, mb_height, mb_width, 2, 2, 8, 8) \
        .permute(0, 1, 3, 5, 2, 4, 6).reshape(N, H, W)
    ru = r[:, :, :, 4].permute(0, 1, 3, 2, 4).reshape(N, H // 2, W // 2)
    rv = r[:, :, :, 5].permute(0, 1, 3, 2, 4).reshape(N, H // 2, W // 2)
    return ry, ru, rv


def _compose_put_planes(resid, recs, active, frames, mb_width: int,
                        mb_height: int):
    """Plain prediction + compose + put from raster residual planes."""
    N = recs.shape[0]
    lanes = torch.arange(N, device=recs.device)
    parity = frames["parity"].long()
    _kind, mv_h, mv_v = mb_fields(recs, mb_width, mb_height)
    preds = []
    for key, S in zip("yuv", (16, 8, 8)):
        ref = frames[key][lanes, 1 - parity]
        mh, mv = (mv_h, mv_v) if S == 16 else (mv_h >> 1, mv_v >> 1)
        preds.append(predict_plane_torch(ref, mh, mv, S))
    return compose_put(preds, resid, recs, active, frames,
                       mb_width=mb_width, mb_height=mb_height)


def predict_compose_put_torch(res_T, recs, active, frames, *,
                              mb_width: int, mb_height: int):
    """Plain form of K3 (same contract as predict_compose_put)."""
    return _compose_put_planes(residual_planes(res_T, mb_width, mb_height),
                               recs, active, frames, mb_width, mb_height)


def predict_compose_put_flat_torch(res, recs, active, frames, *,
                                   mb_width: int, mb_height: int):
    """Plain form of K3F (same contract as predict_compose_put_flat)."""
    return _compose_put_planes(
        residual_planes_flat(res, mb_width, mb_height), recs, active,
        frames, mb_width, mb_height)


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
    pres = _launch_compose("esp_compose_put", res_T,
                           (64, mb_width * mb_height * 6), recs, active,
                           frames, mb_width, mb_height)
    launches += 1
    return pres


def _launch_compose(entry, res, res_shape, recs, active, frames,
                    mb_width: int, mb_height: int, extra=()):
    """Check the operands of K3 / K3F / K23 and launch C entry `entry`
    (K23's levels in place of the residuals, then its `extra` operands,
    checked by its wrapper)."""
    if res.device.type != "cuda":
        raise ValueError(f"unsupported device {res.device}")
    from espflix_tpu_torch import build

    if mb_width > MAX_MB_WIDTH:
        raise ValueError(f"mb_width {mb_width} > {MAX_MB_WIDTH}")
    dev = res.device
    N = recs.shape[0]
    H, W = mb_height * 16, mb_width * 16
    build.check(res, dev, torch.int16, (N,) + res_shape)
    build.check(recs, dev, torch.int32, (N, mb_width * mb_height))
    build.check(active, dev, torch.bool, (N,))
    build.check(frames["parity"], dev, torch.int32, (N,))
    build.check(frames["y"], dev, torch.uint8, (N, 2, H, W))
    build.check(frames["u"], dev, torch.uint8, (N, 2, H // 2, W // 2))
    build.check(frames["v"], dev, torch.uint8, (N, 2, H // 2, W // 2))
    # K3 / K3F read residuals as 16-byte vectors; K23 reads its levels
    # in the widest vectors their alignment allows
    for t in (frames["y"], frames["u"], frames["v"]) + (() if extra
                                                        else (res,)):
        if t.data_ptr() % 16:
            raise ValueError("K3 / K3F / K23 move 16-byte vectors: "
                             "residuals and frames must start 16-byte "
                             "aligned")
    pres = {k: torch.empty(frames[k].shape[:1] + frames[k].shape[2:],
                           dtype=torch.uint8, device=dev) for k in "yuv"}
    build.launch(entry, res, recs, *extra, active, frames["parity"],
                 frames["y"], frames["u"], frames["v"], pres["y"], pres["u"],
                 pres["v"], N, mb_width, mb_height)
    return pres


def predict_compose_put_flat(res, recs, active, frames, *, mb_width: int,
                             mb_height: int):
    """predict_compose_put from lane-minor residuals: the port of the
    compose of models/mpeg1.dense_compose's lane-minor branch
    (mpeg1.py:592-665 -- residual-plane assembly, compose, put,
    presented) and of its Pallas kernels compose_plane_pallas /
    compose_plane_pallas2 (mocomp_pallas.py:92, 161).

    res int16[N, MB*6, 64] (K2F's output); the rest and the in-place
    contract as predict_compose_put.  CPU tensors take the plain form;
    CUDA tensors launch K3F (csrc/compose.cu)."""
    global launches_flat
    if res.device.type == "cpu":
        return predict_compose_put_flat_torch(res, recs, active, frames,
                                              mb_width=mb_width,
                                              mb_height=mb_height)
    pres = _launch_compose("esp_compose_put_flat", res,
                           (mb_width * mb_height * 6, 64), recs, active,
                           frames, mb_width, mb_height)
    launches_flat += 1
    return pres


def idct_compose_put_torch(coeffs_T, recs, nfinal, intra_q, non_intra_q,
                           active, frames, *, mb_width: int, mb_height: int,
                           scale_dct=None):
    """Plain form of K23: K2's plain form, then K3's (same contract as
    idct_compose_put)."""
    intra_bl, qs_bl = idct_ops.block_flags(recs)
    res_T = idct_ops.block_residuals_T_torch(
        coeffs_T, intra_bl, qs_bl, intra_q, non_intra_q, nfinal, scale_dct)
    return predict_compose_put_torch(res_T, recs, active, frames,
                                     mb_width=mb_width, mb_height=mb_height)


def idct_compose_put(coeffs_T, recs, nfinal, intra_q, non_intra_q, active,
                     frames, *, mb_width: int, mb_height: int,
                     scale_dct=None):
    """Dequant + IDCT of the raw levels, then predict_compose_put, with
    the residuals never leaving the card's shared memory: K2 then K3 in
    one pass (csrc/compose.cu, K23).

    coeffs_T int16[N, 64, MB*6], nfinal int32[N, MB*6], intra_q /
    non_intra_q int32[N, 64] and scale_dct int32[64] (SCALE_DCT_Q, made
    on the device when omitted) as block_residuals_T takes them, the
    intra flags and qscales read from recs int32[N, MB]; active, frames
    and the in-place contract as predict_compose_put.  Returns presented
    y/u/v uint8[N, H, W] as new tensors.  CPU tensors take the plain
    form; CUDA tensors launch K23."""
    global launches_fused
    if coeffs_T.device.type == "cpu":
        return idct_compose_put_torch(
            coeffs_T, recs, nfinal, intra_q, non_intra_q, active, frames,
            mb_width=mb_width, mb_height=mb_height, scale_dct=scale_dct)
    from espflix_tpu_torch import build

    dev = coeffs_T.device
    N, BL = recs.shape[0], mb_width * mb_height * 6
    if scale_dct is None:
        scale_dct = idct_ops.scale_dct_q(dev)
    build.check(nfinal, dev, torch.int32, (N, BL))
    build.check(intra_q, dev, torch.int32, (N, 64))
    build.check(non_intra_q, dev, torch.int32, (N, 64))
    build.check(scale_dct, dev, torch.int32, (64,))
    pres = _launch_compose(
        "esp_idct_compose_put", coeffs_T, (64, BL), recs, active, frames,
        mb_width, mb_height, (nfinal, intra_q, non_intra_q, scale_dct))
    launches_fused += 1
    return pres
