"""MPEG-1 video elementary-stream encoder for test fixtures and content.

Copied from espflix_tpu/tools/mpeg1_encode.py; tests/test_torch_isolation.py
pins the copy to the original.

This environment has no ffmpeg (the reference's content pipeline shells out
to it, indexer/indexer.cpp:302-330), so the framework
carries its own encoder.  It emits ISO 11172-2 video elementary streams
restricted to exactly the subset the decoders support (I/P pictures, no
B/D, full-width slices), from a structured *script*:

    script = {
      "width": 352, "height": 192,
      "intra_q": None | 64 bytes, "non_intra_q": None | 64 bytes,
      "pictures": [
         {"type": "I"|"P", "qscale": 1..31, "full_pel": 0|1, "f_code": 1..7,
          "slices": [ {"row": r, "qscale": q, "mbs": [MB, ...]}, ...]},
      ...]
    }

    MB = {"addr_inc": 1.., "intra": bool, "quant": None|1..31,
          "mv": None | (h, v)   # absolute half-pel MV (full-pel if
                                # picture.full_pel), None = no MV bit
          "blocks": [None | [(scan_pos, level), ...]] * 6}
          # intra blocks: scan_pos 0 entry is the absolute DC (0..255)

The script doubles as ground truth in tests.  ``random_script`` generates
valid scripts that exercise every VLC table, escape coding, skipped
macroblocks, qscale updates and both half-pel phases.

NOTE on custom quant matrices: the reference stores transmitted matrices
in transmission order but indexes them by raster position
(player.cpp:646-651 vs 1113), i.e. it treats them as raster-order.  We
preserve that behavior end-to-end; scripts supply matrices in raster
order.
"""

from __future__ import annotations

import numpy as np

from espflix_tpu_torch.core import vlc_tables as V
from espflix_tpu_torch.core.bitio import BitWriter

# value -> bitstring inverses
_INV_MB_ADDR = {v: k for k, v in V.MB_ADDR_INC.items()}
_INV_MB_TYPE_I = {v: k for k, v in V.MB_TYPE_I.items()}
_INV_MB_TYPE_P = {v: k for k, v in V.MB_TYPE_P.items()}
_INV_CBP = {v: k for k, v in V.CBP.items()}
_INV_MOTION = {v: k for k, v in V.MOTION_CODE.items()}
_INV_DC_LUM = {v: k for k, v in V.DC_SIZE_LUM.items()}
_INV_DC_CHROM = {v: k for k, v in V.DC_SIZE_CHROM.items()}
_INV_DCT = {rl: k for k, rl in V.DCT_COEFF.items()}  # (run,|level|)->code

PICTURE, SEQUENCE, EXTENSION = 0x00, 0xB3, 0xB5
SEQUENCE_END, GOP_CODE, USER_DATA = 0xB7, 0xB8, 0xB2


def put_addr_inc(w: BitWriter, inc: int):
    while inc > 33:
        w.put_str(_INV_MB_ADDR[V.MB_ESCAPE])
        inc -= 33
    w.put_str(_INV_MB_ADDR[inc])


def put_motion_delta(w: BitWriter, delta: int, r_size: int):
    """Encode one motion_code (+ residual), inverse of player.cpp:891-910."""
    scale = 1 << r_size
    assert -(scale << 4) <= delta <= (scale << 4) - 1, (delta, r_size)
    if delta == 0 or scale == 1:
        assert -16 <= delta <= 16
        w.put_str(_INV_MOTION[delta])
        return
    mag = abs(delta)
    code = ((mag - 1) >> r_size) + 1
    residual = (mag - 1) & (scale - 1)
    assert 1 <= code <= 16
    w.put_str(_INV_MOTION[code if delta > 0 else -code])
    w.put(residual, r_size)


def wrap_motion(m: int, r_size: int) -> int:
    scale = 1 << r_size
    if m > (scale << 4) - 1:
        m -= scale << 5
    elif m < -(scale << 4):
        m += scale << 5
    return m


def put_dc(w: BitWriter, delta: int, luma: bool):
    size = abs(delta).bit_length()
    assert size <= 8
    w.put_str((_INV_DC_LUM if luma else _INV_DC_CHROM)[size])
    if size:
        bits = delta if delta > 0 else delta + (1 << size) - 1
        w.put(bits, size)


def put_coeff(w: BitWriter, run: int, level: int, first: bool):
    """Encode one run/level, inverse of get_vlc_dct (player.cpp:548-644)."""
    assert level != 0 and 0 <= run <= 63
    key = (run, abs(level))
    if key == (0, 1):
        w.put_str("1" if first else "11")
        w.put(0 if level > 0 else 1, 1)
        return
    code = _INV_DCT.get(key)
    if code is not None and code != "11":
        w.put_str(code)
        w.put(0 if level > 0 else 1, 1)
        return
    # escape: '000001' + run(6) + 8/16-bit level (player.cpp:1092-1099)
    assert 1 <= abs(level) <= 255
    w.put_str(V.DCT_ESCAPE_PREFIX)
    w.put(run, 6)
    if 1 <= level <= 127:
        w.put(level, 8)
    elif -127 <= level <= -1:
        w.put(level + 256, 8)
    elif level >= 128:
        w.put(0, 8)
        w.put(level, 8)
    else:  # -255..-128
        w.put(128, 8)
        w.put(level + 256, 8)


def encode_block(w, coeffs, intra, dc_pred, luma):
    """Encode one 8x8 block.  coeffs: [(scan_pos, level)...] ascending scan
    positions; for intra, a scan_pos-0 entry is the absolute DC (0..255).
    Returns the new DC predictor (intra) or dc_pred unchanged."""
    n = 0
    new_pred = dc_pred
    coeffs = sorted(coeffs)
    if intra:
        if coeffs and coeffs[0][0] == 0:
            dc = coeffs[0][1]
            coeffs = coeffs[1:]
        else:
            dc = dc_pred
        assert 0 <= dc <= 255
        put_dc(w, dc - dc_pred, luma=luma)
        new_pred = dc
        n = 1
    for pos, level in coeffs:
        assert pos >= n
        put_coeff(w, pos - n, level, first=(n == 0 and not intra))
        n = pos + 1
    if not intra:
        assert coeffs
    w.put_str("10")
    return new_pred


def encode_picture(w: BitWriter, pic: dict, mb_width: int):
    w.start_code(PICTURE)
    w.put(pic.get("temporal_reference", 0), 10)
    ptype = 1 if pic["type"] == "I" else 2
    w.put(ptype, 3)
    w.put(0xFFFF, 16)  # vbv_delay
    full_pel = pic.get("full_pel", 0)
    f_code = pic.get("f_code", 1)
    if ptype == 2:
        w.put(full_pel, 1)
        w.put(f_code, 3)
    w.put(0, 1)  # extra_bit_picture
    r_size = f_code - 1

    for sl in pic["slices"]:
        w.start_code(sl["row"] + 1)
        w.put(sl["qscale"], 5)
        w.put(0, 1)  # extra slice info: none
        # predictor state, mirroring player.cpp:726-730,1260
        y_dc = u_dc = v_dc = 128
        mv_h = mv_v = 0
        first_mb = True
        for mb in sl["mbs"]:
            inc = mb.get("addr_inc", 1)
            put_addr_inc(w, inc)
            if inc > 1 and not first_mb:
                y_dc = u_dc = v_dc = 128
                mv_h = mv_v = 0
            first_mb = False

            intra = mb["intra"]
            quant = mb.get("quant")
            mv = mb.get("mv")
            blocks = mb.get("blocks", [None] * 6)
            cbp = 0
            for i, b in enumerate(blocks):
                if b is not None:
                    cbp |= 0x20 >> i

            if ptype == 1:
                assert intra
                t = V.MBT_INTRA | (V.MBT_QUANT if quant else 0)
                w.put_str(_INV_MB_TYPE_I[t])
            else:
                if intra:
                    t = V.MBT_INTRA | (V.MBT_QUANT if quant else 0)
                else:
                    t = (V.MBT_MOTION_F if mv is not None else 0) | (
                        V.MBT_PATTERN if cbp else 0)
                    t |= V.MBT_QUANT if quant else 0
                    assert t & (V.MBT_MOTION_F | V.MBT_PATTERN), \
                        "P MB must have MC or coefficients (else skip it)"
                    # quant flag only legal on coded variants in B.2
                    if quant:
                        assert t & V.MBT_PATTERN or (t & V.MBT_INTRA)
                w.put_str(_INV_MB_TYPE_P[t])

            if quant:
                w.put(quant, 5)

            if intra:
                mv_h = mv_v = 0
            else:
                y_dc = u_dc = v_dc = 128
                if mv is not None:
                    dh = wrap_motion(mv[0] - mv_h, r_size)
                    dv = wrap_motion(mv[1] - mv_v, r_size)
                    put_motion_delta(w, dh, r_size)
                    put_motion_delta(w, dv, r_size)
                    mv_h, mv_v = mv
                else:
                    mv_h = mv_v = 0

            if intra:
                assert all(b is not None for b in blocks)
            elif cbp:
                w.put_str(_INV_CBP[cbp])

            for i, b in enumerate(blocks):
                if b is None:
                    continue
                if i < 4:
                    y_dc = encode_block(w, b, intra, y_dc, True)
                elif i == 4:
                    u_dc = encode_block(w, b, intra, u_dc, False)
                else:
                    v_dc = encode_block(w, b, intra, v_dc, False)
        w.align()


def encode_es(script: dict, sequence_end: bool = True) -> bytes:
    w = BitWriter()
    width, height = script["width"], script["height"]
    mb_width = (width + 15) >> 4

    w.start_code(SEQUENCE)
    w.put(width, 12)
    w.put(height, 12)
    w.put(script.get("aspect", 1), 4)
    w.put(script.get("rate_code", 5), 4)  # 5 = 30fps nominal
    w.put(script.get("bit_rate", 2928), 18)
    w.put(1, 1)  # marker
    w.put(script.get("vbv_size", 20), 10)
    w.put(0, 1)  # constrained flag
    iq = script.get("intra_q")
    w.put(1 if iq is not None else 0, 1)
    if iq is not None:
        for b in iq:
            w.put(int(b), 8)
    nq = script.get("non_intra_q")
    w.put(1 if nq is not None else 0, 1)
    if nq is not None:
        for b in nq:
            w.put(int(b), 8)

    if script.get("gop", True):
        w.start_code(GOP_CODE)
        w.put(0, 25)  # timecode
        w.put(1, 1)   # closed_gop
        w.put(0, 1)   # broken_link
        w.align()

    for k, pic in enumerate(script["pictures"]):
        pic.setdefault("temporal_reference", k & 0x3FF)
        encode_picture(w, pic, mb_width)

    if sequence_end:
        w.start_code(SEQUENCE_END)
    w.align()
    return w.tobytes()


# ---------------------------------------------------------------------------
# Random script generation
# ---------------------------------------------------------------------------

def _rand_block(rng, intra: bool, max_coeffs: int, dc: int | None = None):
    """Random 8x8 coefficients in ascending scan positions."""
    out = []
    if intra:
        out.append((0, int(dc if dc is not None else rng.integers(0, 256))))
    ncoef = int(rng.integers(0 if intra else 1, max_coeffs + 1))
    if ncoef:
        positions = sorted(
            rng.choice(np.arange(1, 64), size=min(ncoef, 63), replace=False)
            .tolist())
        for p in positions:
            if rng.random() < 0.08:   # exercise escapes
                level = int(rng.integers(41, 256)) * (
                    1 if rng.random() < 0.5 else -1)
            else:
                level = int(rng.integers(1, 12)) * (
                    1 if rng.random() < 0.5 else -1)
            out.append((int(p), level))
    return out


def _safe_mv_range(mb_xy: int, size_px: int, extent_px: int, full_pel: int,
                   f_code: int):
    """Inclusive half-pel MV bounds keeping mocomp reads in-bounds
    (incl. the +1 half-pel tap; see ops/mocomp.py)."""
    lo = -mb_xy * size_px * 2
    hi = (extent_px - size_px - 1) * 2 - mb_xy * size_px * 2
    # decoder range limit for this f_code
    scale = 1 << (f_code - 1)
    lim_lo, lim_hi = -(scale << 4), (scale << 4) - 1
    if full_pel:
        lim_lo *= 2
        lim_hi = lim_hi * 2 + 1
    return max(lo, lim_lo), min(hi, lim_hi)


def random_script(rng, width=352, height=192, n_pictures=3, p_frames=True,
                  max_coeffs=8, seed_note="", allow_custom_q=True) -> dict:
    mb_w, mb_h = (width + 15) >> 4, (height + 15) >> 4
    script = {"width": width, "height": height, "pictures": []}
    if allow_custom_q and rng.random() < 0.3:
        script["intra_q"] = rng.integers(1, 256, 64).astype(np.uint8)
    if allow_custom_q and rng.random() < 0.3:
        script["non_intra_q"] = rng.integers(1, 256, 64).astype(np.uint8)

    for k in range(n_pictures):
        is_i = (k == 0) or not p_frames or rng.random() < 0.2
        full_pel = int(rng.random() < 0.25) if not is_i else 0
        f_code = int(rng.integers(1, 4)) if not is_i else 1
        pic = {"type": "I" if is_i else "P", "full_pel": full_pel,
               "f_code": f_code, "slices": []}
        for row in range(mb_h):
            sl = {"row": row, "qscale": int(rng.integers(1, 32)), "mbs": []}
            x = 0
            while x < mb_w:
                inc = 1
                if not is_i and x > 0 and rng.random() < 0.15:
                    inc = int(rng.integers(2, min(mb_w - x, 33) + 1)) \
                        if mb_w - x >= 2 else 1
                x += inc - 1
                if x >= mb_w:
                    break
                quant = int(rng.integers(1, 32)) if rng.random() < 0.15 \
                    else None
                if is_i or rng.random() < 0.15:
                    mb = {"addr_inc": inc, "intra": True, "quant": quant,
                          "blocks": [
                              _rand_block(rng, True, max_coeffs)
                              for _ in range(6)]}
                else:
                    has_mv = rng.random() < 0.7
                    mv = None
                    if has_mv:
                        unit = 2 if full_pel else 1
                        hlo, hhi = _safe_mv_range(x, 16, width, full_pel,
                                                  f_code)
                        vlo, vhi = _safe_mv_range(row, 16, height, full_pel,
                                                  f_code)
                        h = int(rng.integers(-(-hlo // unit),
                                              hhi // unit + 1))
                        v = int(rng.integers(-(-vlo // unit),
                                              vhi // unit + 1))
                        mv = (h, v)
                    nblocks = int(rng.integers(0 if has_mv else 1, 7))
                    idxs = rng.choice(6, size=nblocks, replace=False)
                    blocks = [None] * 6
                    for i in idxs:
                        blocks[int(i)] = _rand_block(rng, False, max_coeffs)
                    if not has_mv and not any(b is not None for b in blocks):
                        blocks[0] = _rand_block(rng, False, max_coeffs)
                    if quant and not any(b is not None for b in blocks):
                        quant = None  # quant flag needs a coded variant
                    mb = {"addr_inc": inc, "intra": False, "quant": quant,
                          "mv": mv, "blocks": blocks}
                sl["mbs"].append(mb)
                x += 1
            pic["slices"].append(sl)
        script["pictures"].append(pic)
    return script
