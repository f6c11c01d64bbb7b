"""ISO/IEC 11172-2 Annex B variable-length code tables, in LUT form.

A frozen copy of espflix_tpu_torch/core/vlc_tables.py, kept with
the benchmark so that the yardstick does not move when the program
changes.

The MPEG-1 VLC tables are public-standard constants (Tables B.1 macroblock
address increment, B.2 macroblock type, B.3 coded block pattern, B.4 motion
code, B.5 / ISO 13818-2 B-14 DCT coefficients, B.12/B.13 DC size).  They are
written here canonically as ``bitstring -> value`` maps and compiled into
flat peek-indexed lookup tables:

    entry = LUT[next_maxlen_bits_of_stream]   # one gather per symbol

which is the natural TPU decode primitive — a batch of N lanes resolves N
symbols with one vectorized gather instead of walking a bit-serial tree
(the reference walks binary-tree FSMs, src/player.cpp:
516-530, and hand-unrolled branches for DCT coefficients, player.cpp:
548-644; both are hostile to SIMD).  Equivalence with the reference's
encodings is enforced by tests/test_vlc_tables.py.

LUT packing
-----------
Header tables (``build_lut``): int32 ``(length << 16) | (value & 0xFFFF)``;
0 means invalid code.  Value is sign-extended from 16 bits on use.

DCT tables (``build_dct_luts``): two int32 LUTs of size 2^17 indexed by the
next 17 bits (sign bit included in the code), one for the first coefficient
of a block and one for subsequent coefficients (they differ only in the
leading-'1' short form and EOB, per B-14):

    bits  0..11  signed level (two's complement, 12 bits)
    bits 12..17  run (6 bits; escape: run from the bitstream prefix)
    bits 18..22  consumed bits (5 bits)
    bits 24..25  kind: 0 invalid, 1 coefficient, 2 EOB, 3 escape

For escapes the consumed count covers '000001' + 6 run bits = 12; the level
then follows as 8 or 16 literal bits (handled by the caller, matching
player.cpp:1092-1099).
"""

from __future__ import annotations

import numpy as np

# --- Table B.1: macroblock_address_increment (34 = stuffing, 35 = escape) ---
MB_ADDR_INC = {
    "1": 1, "011": 2, "010": 3, "0011": 4, "0010": 5,
    "00011": 6, "00010": 7, "0000111": 8, "0000110": 9,
    "00001011": 10, "00001010": 11, "00001001": 12, "00001000": 13,
    "00000111": 14, "00000110": 15,
    "0000010111": 16, "0000010110": 17, "0000010101": 18, "0000010100": 19,
    "0000010011": 20, "0000010010": 21,
    "00000100011": 22, "00000100010": 23, "00000100001": 24,
    "00000100000": 25, "00000011111": 26, "00000011110": 27,
    "00000011101": 28, "00000011100": 29, "00000011011": 30,
    "00000011010": 31, "00000011001": 32, "00000011000": 33,
    "00000001111": 34,   # macroblock_stuffing
    "00000001000": 35,   # macroblock_escape (+33 to following increment)
}
MB_STUFFING = 34
MB_ESCAPE = 35

# --- Table B.2: macroblock_type.  Flag bits (as used by the reference,
# player.cpp:1292-1307): 0x10 quant, 0x08 motion_forward, 0x04
# motion_backward, 0x02 pattern (cbp present), 0x01 intra. ---
MB_TYPE_I = {"1": 0x01, "01": 0x11}
MB_TYPE_P = {
    "1": 0x0A, "01": 0x02, "001": 0x08, "00011": 0x01,
    "00010": 0x1A, "00001": 0x12, "000001": 0x11,
}
MB_TYPE_B = {
    "10": 0x0C, "11": 0x0E, "010": 0x04, "011": 0x06, "0010": 0x08,
    "0011": 0x0A, "00011": 0x01, "00010": 0x1E, "000011": 0x1A,
    "000010": 0x16, "000001": 0x11,
}
MBT_QUANT, MBT_MOTION_F, MBT_MOTION_B, MBT_PATTERN, MBT_INTRA = (
    0x10, 0x08, 0x04, 0x02, 0x01,
)

# --- Table B.3: coded_block_pattern ---
CBP = {
    "111": 60, "1101": 4, "1100": 8, "1011": 16, "1010": 32,
    "10011": 12, "10010": 48, "10001": 20, "10000": 40,
    "01111": 28, "01110": 44, "01101": 52,
    "01100": 56, "01011": 1, "01010": 61, "01001": 2, "01000": 62,
    "001111": 24, "001110": 36, "001101": 3, "001100": 63,
    "0010111": 5, "0010110": 9, "0010101": 17, "0010100": 33,
    "0010011": 6, "0010010": 10, "0010001": 18, "0010000": 34,
    "00011111": 7, "00011110": 11, "00011101": 19, "00011100": 35,
    "00011011": 13, "00011010": 49, "00011001": 21, "00011000": 41,
    "00010111": 14, "00010110": 50, "00010101": 22, "00010100": 42,
    "00010011": 15, "00010010": 51, "00010001": 23, "00010000": 43,
    "00001111": 25, "00001110": 37, "00001101": 26, "00001100": 38,
    "00001011": 29, "00001010": 45, "00001001": 53, "00001000": 57,
    "00000111": 30, "00000110": 46, "00000101": 54, "00000100": 58,
    "000000111": 31, "000000110": 47, "000000101": 55, "000000100": 59,
    "000000011": 27, "000000010": 39,
}

# --- Table B.4: motion_code (shared prefix; trailing bit 1 = negative) ---
MOTION_CODE = {
    "1": 0, "010": 1, "011": -1, "0010": 2, "0011": -2,
    "00010": 3, "00011": -3, "0000110": 4, "0000111": -4,
    "00001010": 5, "00001011": -5, "00001000": 6, "00001001": -6,
    "00000110": 7, "00000111": -7,
    "0000010110": 8, "0000010111": -8, "0000010100": 9, "0000010101": -9,
    "0000010010": 10, "0000010011": -10,
    "00000100010": 11, "00000100011": -11, "00000100000": 12,
    "00000100001": -12, "00000011110": 13, "00000011111": -13,
    "00000011100": 14, "00000011101": -14, "00000011010": 15,
    "00000011011": -15, "00000011000": 16, "00000011001": -16,
}

# --- Tables B.12 / B.13: dct_dc_size ---
DC_SIZE_LUM = {
    "100": 0, "00": 1, "01": 2, "101": 3, "110": 4,
    "1110": 5, "11110": 6, "111110": 7, "1111110": 8,
}
DC_SIZE_CHROM = {
    "00": 0, "01": 1, "10": 2, "110": 3, "1110": 4,
    "11110": 5, "111110": 6, "1111110": 7, "11111110": 8,
}

# --- Table B.5a-d (== ISO 13818-2 Table B-14): dct_coeff run/level codes,
# excluding the sign bit, EOB ('10') and the first-coefficient short form
# ('1' instead of '11' for (0,1)). '000001' is the escape prefix. ---
DCT_COEFF = {
    "11": (0, 1),          # "next" form; "first" form is '1'
    "011": (1, 1),
    "0100": (0, 2), "0101": (2, 1),
    "00101": (0, 3), "00111": (3, 1), "00110": (4, 1),
    "000110": (1, 2), "000111": (5, 1), "000101": (6, 1), "000100": (7, 1),
    "0000110": (0, 4), "0000100": (2, 2), "0000111": (8, 1),
    "0000101": (9, 1),
    "00100110": (0, 5), "00100001": (0, 6), "00100101": (1, 3),
    "00100100": (3, 2), "00100111": (10, 1), "00100011": (11, 1),
    "00100010": (12, 1), "00100000": (13, 1),
    "0000001010": (0, 7), "0000001100": (1, 4), "0000001011": (2, 3),
    "0000001111": (4, 2), "0000001001": (5, 2), "0000001110": (14, 1),
    "0000001101": (15, 1), "0000001000": (16, 1),
    "000000011101": (0, 8), "000000011000": (0, 9),
    "000000010011": (0, 10), "000000010000": (0, 11),
    "000000011011": (1, 5), "000000010100": (2, 4),
    "000000011100": (3, 3), "000000010010": (4, 3),
    "000000011110": (6, 2), "000000010101": (7, 2),
    "000000010001": (8, 2), "000000011111": (17, 1),
    "000000011010": (18, 1), "000000011001": (19, 1),
    "000000010111": (20, 1), "000000010110": (21, 1),
    "0000000011010": (0, 12), "0000000011001": (0, 13),
    "0000000011000": (0, 14), "0000000010111": (0, 15),
    "0000000010110": (1, 6), "0000000010101": (1, 7),
    "0000000010100": (2, 5), "0000000010011": (3, 4),
    "0000000010010": (5, 3), "0000000010001": (9, 2),
    "0000000010000": (10, 2), "0000000011111": (22, 1),
    "0000000011110": (23, 1), "0000000011101": (24, 1),
    "0000000011100": (25, 1), "0000000011011": (26, 1),
    "00000000011111": (0, 16), "00000000011110": (0, 17),
    "00000000011101": (0, 18), "00000000011100": (0, 19),
    "00000000011011": (0, 20), "00000000011010": (0, 21),
    "00000000011001": (0, 22), "00000000011000": (0, 23),
    "00000000010111": (0, 24), "00000000010110": (0, 25),
    "00000000010101": (0, 26), "00000000010100": (0, 27),
    "00000000010011": (0, 28), "00000000010010": (0, 29),
    "00000000010001": (0, 30), "00000000010000": (0, 31),
    "000000000011000": (0, 32), "000000000010111": (0, 33),
    "000000000010110": (0, 34), "000000000010101": (0, 35),
    "000000000010100": (0, 36), "000000000010011": (0, 37),
    "000000000010010": (0, 38), "000000000010001": (0, 39),
    "000000000010000": (0, 40),
    "000000000011111": (1, 8), "000000000011110": (1, 9),
    "000000000011101": (1, 10), "000000000011100": (1, 11),
    "000000000011011": (1, 12), "000000000011010": (1, 13),
    "000000000011001": (1, 14),
    "0000000000010011": (1, 15), "0000000000010010": (1, 16),
    "0000000000010001": (1, 17), "0000000000010000": (1, 18),
    "0000000000010100": (6, 3), "0000000000011010": (11, 2),
    "0000000000011001": (12, 2), "0000000000011000": (13, 2),
    "0000000000010111": (14, 2), "0000000000010110": (15, 2),
    "0000000000010101": (16, 2),
    "0000000000011111": (27, 1), "0000000000011110": (28, 1),
    "0000000000011101": (29, 1), "0000000000011100": (30, 1),
    "0000000000011011": (31, 1),
}
DCT_ESCAPE_PREFIX = "000001"

# Zigzag scan order (ISO 11172-2 Fig 2-D.45; player.cpp:150-159).
ZIG_ZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10,
    17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34,
    27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36,
    29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46,
    53, 60, 61, 54, 47, 55, 62, 63,
], dtype=np.int32)

# Default intra quantizer matrix (ISO 11172-2 2.4.3.2; player.cpp:172-181).
DEFAULT_INTRA_Q = np.array([
    8, 16, 19, 22, 26, 27, 29, 34,
    16, 16, 22, 24, 27, 29, 34, 37,
    19, 22, 26, 27, 29, 34, 34, 38,
    22, 22, 26, 27, 29, 34, 37, 40,
    22, 26, 27, 29, 32, 35, 40, 48,
    26, 27, 29, 32, 35, 40, 48, 58,
    26, 27, 29, 34, 38, 46, 56, 69,
    27, 29, 35, 38, 46, 56, 69, 83,
], dtype=np.int32)

DEFAULT_NON_INTRA_Q = np.full(64, 16, dtype=np.int32)

# IDCT input prescale folded into dequant by the reference decoder
# (player.cpp:161-170, applied at player.cpp:1121).  These are
# round(C(u)C(v)/8 * 2^8)-style constants of its fixed-point IDCT.
SCALE_DCT_Q = np.array([
    32, 44, 42, 38, 32, 25, 17, 9,
    44, 62, 58, 52, 44, 35, 24, 12,
    42, 58, 55, 49, 42, 33, 23, 12,
    38, 52, 49, 44, 38, 30, 20, 10,
    32, 44, 42, 38, 32, 25, 17, 9,
    25, 35, 33, 30, 25, 20, 14, 7,
    17, 24, 23, 20, 17, 14, 9, 5,
    9, 12, 12, 10, 9, 7, 5, 2,
], dtype=np.int32)


# --------------------------------------------------------------------------
# LUT construction
# --------------------------------------------------------------------------

def build_lut(codes: dict, maxlen: int | None = None) -> np.ndarray:
    """Compile a bitstring->value map into a peek-indexed int32 LUT.

    LUT[peek_maxlen_bits] = (code_length << 16) | (value & 0xFFFF);
    0 for invalid peeks.
    """
    if maxlen is None:
        maxlen = max(len(c) for c in codes)
    lut = np.zeros(1 << maxlen, dtype=np.int32)
    for code, value in codes.items():
        n = len(code)
        assert n <= maxlen
        base = int(code, 2) << (maxlen - n)
        span = 1 << (maxlen - n)
        entry = (n << 16) | (value & 0xFFFF)
        assert not lut[base: base + span].any(), f"overlap at {code}"
        lut[base: base + span] = entry
    return lut


def lut_value(entry):
    """Sign-extended 16-bit value field of a build_lut entry."""
    v = entry & 0xFFFF
    return np.where(v >= 0x8000, v - 0x10000, v) if not isinstance(
        entry, int) else (v - 0x10000 if v >= 0x8000 else v)


def lut_length(entry):
    return (entry >> 16) & 0xFF


DCT_KIND_INVALID, DCT_KIND_COEFF, DCT_KIND_EOB, DCT_KIND_ESCAPE = 0, 1, 2, 3
DCT_PEEK_BITS = 17


def _pack_dct(kind: int, bits: int, run: int, level: int) -> int:
    return (kind << 24) | (bits << 18) | (run << 12) | (level & 0xFFF)


def build_dct_luts() -> tuple[np.ndarray, np.ndarray]:
    """Build the (first, next) 17-bit DCT-coefficient LUTs."""
    size = 1 << DCT_PEEK_BITS

    def fill(lut, code, entry):
        n = len(code)
        base = int(code, 2) << (DCT_PEEK_BITS - n)
        span = 1 << (DCT_PEEK_BITS - n)
        assert not lut[base: base + span].any(), f"overlap at {code}"
        lut[base: base + span] = entry

    luts = []
    for first in (True, False):
        lut = np.zeros(size, dtype=np.int32)
        for code, (run, level) in DCT_COEFF.items():
            if code == "11":
                continue  # handled below (first/next forms)
            for sign in (0, 1):
                lvl = -level if sign else level
                fill(lut, code + str(sign),
                     _pack_dct(DCT_KIND_COEFF, len(code) + 1, run, lvl))
        if first:
            fill(lut, "10", _pack_dct(DCT_KIND_COEFF, 2, 0, 1))
            fill(lut, "11", _pack_dct(DCT_KIND_COEFF, 2, 0, -1))
        else:
            fill(lut, "10", _pack_dct(DCT_KIND_EOB, 2, 0, 0))
            fill(lut, "110", _pack_dct(DCT_KIND_COEFF, 3, 0, 1))
            fill(lut, "111", _pack_dct(DCT_KIND_COEFF, 3, 0, -1))
        # escape: '000001' + 6-bit run; 12 bits consumed, level follows.
        for run in range(64):
            code = DCT_ESCAPE_PREFIX + format(run, "06b")
            fill(lut, code, _pack_dct(DCT_KIND_ESCAPE, 12, run, 0))
        luts.append(lut)
    return luts[0], luts[1]


def unpack_dct(entry):
    """Unpack a DCT LUT entry -> (kind, bits, run, level). Array-friendly."""
    kind = (entry >> 24) & 0x3
    bits = (entry >> 18) & 0x1F
    run = (entry >> 12) & 0x3F
    level = entry & 0xFFF
    if isinstance(entry, int):
        if level >= 0x800:
            level -= 0x1000
    else:
        level = np.where(level >= 0x800, level - 0x1000, level)
    return kind, bits, run, level


# Precompiled LUTs (module-level, shared by oracle tests, the numpy
# reference decoder, and the device decoder's constant buffers).
LUT_MB_ADDR = build_lut(MB_ADDR_INC)          # 11-bit peek
LUT_MB_TYPE_I = build_lut(MB_TYPE_I, 6)       # padded to 6 for uniformity
LUT_MB_TYPE_P = build_lut(MB_TYPE_P, 6)
LUT_CBP = build_lut(CBP)                      # 9-bit peek
LUT_MOTION = build_lut(MOTION_CODE)           # 11-bit peek
LUT_DC_LUM = build_lut(DC_SIZE_LUM, 8)        # padded to 8
LUT_DC_CHROM = build_lut(DC_SIZE_CHROM, 8)
LUT_DCT_FIRST, LUT_DCT_NEXT = build_dct_luts()
