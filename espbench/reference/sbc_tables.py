"""Bluetooth SIG A2DP SBC codec constants (8-subband subset).

A frozen copy of espflix_tpu_torch/core/sbc_tables.py, kept with the
benchmark so that the yardstick does not move when the program changes.

The synthesis cosine matrix is generated from the spec formula
(A2DP 12.8: N[k][i] = cos((i+0.5)(k+4)pi/8)) in Q16 fixed point with
floor rounding (exact zeros stay zero), matching the reference's
fixed-point convention (src/sbc_decoder.cpp:40-57).

PROTO_8 is the 80-tap prototype window filter of the same spec (Table
12.23) in Q16, stored in the output-sample-major interleaved order used
by the synthesis loop (coefficients m[10*i + 2*j] / m[10*i + 2*j + 1]
weight the even/odd V-history taps of output sample i; see
models/sbc.py).  BLOCK_MODE and the loudness OFFSET tables are spec
tables 12.17/12.8.
"""

from __future__ import annotations

import math

import numpy as np


def _syn8() -> np.ndarray:
    out = np.zeros((16, 8), np.int64)
    for k in range(16):
        for i in range(8):
            x = math.cos((i + 0.5) * (k + 4) * math.pi / 8)
            if abs(x) < 1e-9:
                out[k, i] = 0
            else:
                out[k, i] = math.floor(65536 * x + 1e-12)
    return out.astype(np.int32)


SYN_8 = _syn8()  # [16 rows (v-lane), 8 cols (subband)]

# Q16 prototype filter taps, interleaved (A2DP 12.8 Table 12.23 values
# scaled 2^16, in the even/odd V-history order described above).
PROTO_8 = np.array([
    0, -528, -1484, -3392, -17826, -38524, 17825, -3392, 1483, -528,
    -42, -552, -2105, -2322, -21754, -38114, 13942, -4016, 916, -468,
    -90, -523, -2742, -767, -25579, -36898, 10243, -4253, 432, -388,
    -146, -424, -3342, 1288, -29150, -34935, 6844, -4170, 46, -299,
    -216, -237, -3842, 3837, -32314, -32314, 3837, -3842, -237, -216,
    -299, 46, -4170, 6844, -34935, -29150, 1288, -3342, -424, -146,
    -388, 432, -4253, 10243, -36898, -25579, -767, -2742, -523, -90,
    -468, 916, -4016, 13942, -38114, -21754, -2322, -2105, -552, -42,
], dtype=np.int32).reshape(8, 10)

BLOCK_MODE = np.array([4, 8, 12, 16], np.int32)  # spec 12.17

# Loudness bit-allocation offset tables (A2DP 12.8 Tables 12.11/12.12),
# indexed [sampling_frequency][subband].
OFFSET_4 = np.array([
    [-1, 0, 0, 0],
    [-2, 0, 0, 1],
    [-2, 0, 0, 1],
    [-2, 0, 0, 1],
], np.int32)

OFFSET_8 = np.array([
    [-2, 0, 0, 0, 0, 0, 0, 1],
    [-3, 0, 0, 0, 0, 0, 1, 2],
    [-4, 0, 0, 0, 0, 0, 1, 2],
    [-4, 0, 0, 0, 0, 0, 1, 2],
], np.int32)
