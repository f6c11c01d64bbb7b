"""Exact dequant + fixed-point 8x8 IDCT (K2 and K2F).

K2 works on the [N, 64, BL] layout: the port of
espflix_tpu.ops.idct.block_residuals_T (idct.py:143-195) and of its
Pallas kernel idct_pallas._kernel_T (idct_pallas.py:171-255).  K2F
works on the lane-minor [N, MB*384] layout: the port of
idct.block_residuals_flat (idct.py:197-204) and of the Pallas kernel
idct_pallas._kernel (idct_pallas.py:86-155).

All arithmetic is int32 with the reference decoder's rounding: doubling
+ oddification + truncating /16 (sign handled explicitly: torch's //
floors), the +-2048 clip, intra DC as lev << 8, the 473/196/362
butterflies, the nfinal == 1 non-intra DC shortcut and the nfinal == 0
zero block.
"""

from __future__ import annotations

import torch

from espflix_tpu_torch.core import vlc_tables as V
from espflix_tpu_torch.ops.intwrap import wrap16
from espflix_tpu_torch.ops.vlc_scan import MB_INTRA

launches = 0            # K2 launches (counted by the CUDA path only)
launches_flat = 0       # K2F launches (counted by the CUDA path only)


def scale_dct_q(device) -> torch.Tensor:
    return torch.as_tensor(V.SCALE_DCT_Q, dtype=torch.int32,
                           device=device)


def _butterfly_parts(c, final):
    """One 8-point IDCT pass over a list of 8 tensors (idct.py:97-125)."""
    b1 = c[4]
    b3 = c[2] + c[6]
    b4 = c[5] - c[3]
    tmp1 = c[1] + c[7]
    tmp2 = c[3] + c[5]
    b6 = c[1] - c[7]
    b7 = tmp1 + tmp2
    m0 = c[0]
    x4 = ((b6 * 473 - b4 * 196 + 128) >> 8) - b7
    x0 = x4 - (((tmp1 - tmp2) * 362 + 128) >> 8)
    x1 = m0 - b1
    x2 = (((c[2] - c[6]) * 362 + 128) >> 8) - b3
    x3 = m0 + b1
    y3 = x1 + x2
    y4 = x3 + b3
    y5 = x1 - x2
    y6 = x3 - b3
    y7 = -x0 - ((b4 * 473 + b6 * 196 + 128) >> 8)
    rows = [b7 + y4, x4 + y3, y5 - x0, y6 - y7,
            y6 + y7, x0 + y5, y3 - x4, y4 - b7]
    if final:
        rows = [(r + 128) >> 8 for r in rows]
    return rows


# ---------------------------------------------------------------------------
# the JAX package's building blocks (espflix_tpu.ops.idct, idct.py:26-222)
# with its signatures: int32 in, int32 out, plain torch ops
# ---------------------------------------------------------------------------

def dequant_levels(levels, intra, qscale, qmat):
    """Exact dequant (idct.py:26-62): levels int32[..., 64] raw levels
    (raster positions, intra DC absolute at position 0); intra
    bool[...]; qscale int32[...]; qmat int32[..., 64] (intra or
    non-intra selected).  Returns int32[..., 64]: dequant *
    SCALE_DCT_Q, intra DC as dc << 8."""
    intra_b = intra[..., None]
    v = levels * 2
    v = torch.where(intra_b, v, v + torch.sign(v))
    num = v * qscale[..., None] * qmat
    q = torch.where(num < 0, -((-num) >> 4), num >> 4)
    # an even q drops to the next-lower odd magnitude; a q truncated to
    # 0 becomes +1 only at a coded position (level != 0)
    odd = torch.where(q > 0, q - 1, torch.where(
        q < 0, q + 1, (levels != 0).to(q.dtype)))
    q = torch.where((q & 1) == 0, odd, q).clamp(-2048, 2047)
    b = q * scale_dct_q(levels.device)
    pos0 = torch.arange(64, device=levels.device) == 0
    return torch.where(intra_b & pos0, levels << 8, b)


def idct_8x8(b):
    """Exact fixed-point IDCT over int32[..., 8, 8] (idct.py:65-94):
    the column pass unshifted, then the row pass with (+128) >> 8."""
    rows = _butterfly_parts([b[..., i, :] for i in range(8)], final=False)
    cols = torch.stack(rows, dim=-2).transpose(-1, -2)
    out = _butterfly_parts([cols[..., i, :] for i in range(8)], final=True)
    return torch.stack(out, dim=-2).transpose(-1, -2)


def idct_8x8_flat(b64):
    """idct_8x8 over int32[..., 64], raster order in and out
    (idct.py:128-143)."""
    rows = _butterfly_parts([b64[..., 8 * i:8 * i + 8] for i in range(8)],
                            final=False)
    t = torch.cat(rows, dim=-1)                     # p = 8r + j
    o = _butterfly_parts([t[..., j::8] for j in range(8)], final=True)
    return torch.stack(o, dim=-1).reshape(*b64.shape[:-1], 64)


def dequant_levels_T(levels_T, intra, qscale, qmat_T):
    """dequant_levels on the [N, 64, B] layout (idct.py:146-167):
    levels_T int32[N, 64, B]; intra bool[N, B]; qscale int32[N, B];
    qmat_T int32[N, 64, B] (or broadcastable).  Returns int32[N, 64,
    B]."""
    b = dequant_levels(levels_T.transpose(1, 2), intra, qscale,
                       qmat_T.transpose(-1, -2))
    return b.transpose(1, 2)


def idct_8x8_T(bT):
    """Exact IDCT over int32[N, 64, B], raster positions on axis 1
    (idct.py:170-187)."""
    return idct_8x8_flat(bT.transpose(1, 2)).transpose(1, 2)


def block_residuals(levels64, intra, qscale, qmat, nfinal):
    """levels int32[..., 64] -> spatial residuals int32[..., 8, 8]
    (idct.py:207-222): nfinal int32[...] is the scanner's final
    coefficient count; 0 gives a zero block, 1 on a non-intra block the
    DC shortcut broadcast(b0 >> 8) instead of the IDCT."""
    b = dequant_levels(levels64, intra, qscale, qmat)
    full = idct_8x8(b.reshape(*b.shape[:-1], 8, 8))
    dc = (b[..., 0] >> 8)[..., None, None].expand(full.shape)
    shortcut = ((nfinal == 1) & ~intra)[..., None, None]
    out = torch.where(shortcut, dc, full)
    return torch.where((nfinal == 0)[..., None, None], 0, out)


def block_residuals_T_torch(coeffs_T, intra_bl, qs_bl, intra_q,
                            non_intra_q, nfinal, scale_dct=None):
    """Plain form of K2 (same arguments and result as
    block_residuals_T)."""
    N, _, BL = coeffs_T.shape
    lev = coeffs_T.to(torch.int32)
    intra = intra_bl[:, None, :]
    qs = qs_bl.to(torch.int32)[:, None, :]
    qmat = torch.where(intra, intra_q.to(torch.int32)[:, :, None],
                       non_intra_q.to(torch.int32)[:, :, None])
    if scale_dct is None:
        scale_dct = scale_dct_q(coeffs_T.device)
    v = lev * 2
    v = torch.where(intra, v, v + torch.sign(v))
    num = v * qs * qmat
    q = torch.where(num < 0, -((-num) >> 4), num >> 4)
    odd = torch.where(q > 0, q - 1, torch.where(
        q < 0, q + 1, (lev != 0).to(torch.int32)))
    q = torch.where((q & 1) == 0, odd, q).clamp(-2048, 2047)
    b = q * scale_dct[None, :, None]
    pos0 = (torch.arange(64, device=coeffs_T.device) == 0)[None, :, None]
    b = torch.where(intra & pos0, lev * 256, b)

    c = [b[:, 8 * i:8 * i + 8, :] for i in range(8)]
    rows = _butterfly_parts(c, final=False)          # rows[r'][:, j]
    c2 = [torch.stack([rows[r][:, j, :] for r in range(8)], dim=1)
          for j in range(8)]                         # c2[j][:, r']
    o = _butterfly_parts(c2, final=True)             # o[m][:, r']
    full = torch.stack(o, dim=2).reshape(N, 64, BL)  # p = 8r' + m

    dc = (b[:, 0:1, :] >> 8).expand(N, 64, BL)
    shortcut = ((nfinal == 1) & ~intra_bl)[:, None, :]
    out = torch.where(shortcut, dc, full)
    out = torch.where((nfinal == 0)[:, None, :], 0, out)
    return wrap16(out)


def block_residuals_T(coeffs_T, intra_bl, qs_bl, intra_q, non_intra_q,
                      nfinal, scale_dct=None):
    """Residuals int16[N, 64, BL] from raw levels.

    coeffs_T int16[N, 64, BL] (position-major; p = 8*row + col);
    intra_bl bool[N, BL]; qs_bl int32[N, BL]; intra_q / non_intra_q
    int32[N, 64]; nfinal int32[N, BL]; scale_dct int32[64]
    (SCALE_DCT_Q, made on the device when omitted).  CPU tensors take
    the plain form; CUDA tensors launch K2 (csrc/idct.cu)."""
    global launches
    if coeffs_T.device.type == "cpu":
        return block_residuals_T_torch(coeffs_T, intra_bl, qs_bl, intra_q,
                                       non_intra_q, nfinal, scale_dct)
    if coeffs_T.device.type != "cuda":
        raise ValueError(f"unsupported device {coeffs_T.device}")
    from espflix_tpu_torch import build

    dev = coeffs_T.device
    N, P, BL = coeffs_T.shape
    if P != 64:
        raise ValueError(f"coeffs_T {tuple(coeffs_T.shape)}")
    if scale_dct is None:
        scale_dct = scale_dct_q(dev)
    build.check(coeffs_T, dev, torch.int16)
    build.check(intra_bl, dev, torch.bool, (N, BL))
    build.check(qs_bl, dev, torch.int32, (N, BL))
    build.check(intra_q, dev, torch.int32, (N, 64))
    build.check(non_intra_q, dev, torch.int32, (N, 64))
    build.check(nfinal, dev, torch.int32, (N, BL))
    build.check(scale_dct, dev, torch.int32, (64,))
    out = torch.empty_like(coeffs_T)
    build.launch("esp_idct_T", coeffs_T, intra_bl, qs_bl, intra_q,
                 non_intra_q, nfinal, scale_dct, out, N, BL)
    launches += 1
    return out


# ---------------------------------------------------------------------------
# lane-minor form (K2F): [N, MB*384] levels -> [N, MB*6, 64] residuals
# ---------------------------------------------------------------------------

def block_flags(recs):
    """Per-block intra flag bool[N, MB*6] and qscale int32[N, MB*6] from
    the MB records int32[N, MB]."""
    intra_bl = ((recs & 3) == MB_INTRA).repeat_interleave(6, dim=1)
    qs_bl = ((recs >> 2) & 31).repeat_interleave(6, dim=1)
    return intra_bl, qs_bl


def block_residuals_flat_torch(coeffs, recs, nfinal, intra_q, non_intra_q,
                               scale_dct=None):
    """Plain form of K2F: the [N, 64, BL] plain form on the transposed
    levels, transposed back (same arguments and result as
    block_residuals_flat)."""
    N = coeffs.shape[0]
    levels_T = coeffs.reshape(N, -1, 64).transpose(1, 2)
    intra_bl, qs_bl = block_flags(recs)
    res_T = block_residuals_T_torch(levels_T, intra_bl, qs_bl, intra_q,
                                    non_intra_q, nfinal, scale_dct)
    return res_T.transpose(1, 2).contiguous()


def block_residuals_flat(coeffs, recs, nfinal, intra_q, non_intra_q,
                         scale_dct=None):
    """Residuals int16[N, MB*6, 64] from lane-minor levels: the port of
    espflix_tpu.ops.idct.block_residuals_flat as models/mpeg1.
    dense_compose's lane-minor branch calls it (mpeg1.py:571-590, intra
    flag and qscale from each block's MB record, the int16 cast of
    :590) and of its Pallas kernel idct_pallas._kernel
    (block_residuals_pallas, idct_pallas.py:86-155).

    coeffs int16[N, MB*384] (MB-major, then block, then raster
    position); recs int32[N, MB]; nfinal int32[N, MB*6]; intra_q /
    non_intra_q int32[N, 64]; scale_dct int32[64] (SCALE_DCT_Q, made on
    the device when omitted).  CPU tensors take the plain form; CUDA
    tensors launch K2F (csrc/idct.cu)."""
    global launches_flat
    if coeffs.device.type == "cpu":
        return block_residuals_flat_torch(coeffs, recs, nfinal, intra_q,
                                          non_intra_q, scale_dct)
    if coeffs.device.type != "cuda":
        raise ValueError(f"unsupported device {coeffs.device}")
    from espflix_tpu_torch import build

    dev = coeffs.device
    N, MB = recs.shape
    if scale_dct is None:
        scale_dct = scale_dct_q(dev)
    build.check(coeffs, dev, torch.int16, (N, MB * 384))
    build.check(recs, dev, torch.int32, (N, MB))
    build.check(nfinal, dev, torch.int32, (N, MB * 6))
    build.check(intra_q, dev, torch.int32, (N, 64))
    build.check(non_intra_q, dev, torch.int32, (N, 64))
    build.check(scale_dct, dev, torch.int32, (64,))
    out = torch.empty((N, MB * 6, 64), dtype=torch.int16, device=dev)
    build.launch("esp_idct_flat", coeffs, recs, nfinal, intra_q,
                 non_intra_q, scale_dct, out, N, MB)
    launches_flat += 1
    return out
