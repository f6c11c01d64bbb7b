"""Exact dequant + fixed-point 8x8 IDCT on the [N, 64, BL] layout (K2).

The port of espflix_tpu.ops.idct.block_residuals_T (idct.py:143-195) and
of its Pallas kernel idct_pallas._kernel_T (idct_pallas.py:171-255).
All arithmetic is int32 with the reference decoder's rounding: doubling
+ oddification + truncating /16 (sign handled explicitly: torch's //
floors), the +-2048 clip, intra DC as lev << 8, the 473/196/362
butterflies, the nfinal == 1 non-intra DC shortcut and the nfinal == 0
zero block.
"""

from __future__ import annotations

import torch

from espflix_tpu.core import vlc_tables as V
from espflix_tpu_torch.ops.intwrap import wrap16

launches = 0            # K2 launches (counted by the CUDA path only)


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
