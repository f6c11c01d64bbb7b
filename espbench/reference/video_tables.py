"""Composite-signal constants: IRE levels, timing, chroma tables, dither.

A frozen copy of espflix_tpu_torch/video/tables.py, kept with
the benchmark so that the yardstick does not move when the program
changes.

Everything here is derived from formulas (the reference generated its
tables with in-tree code and pasted the output: gen_palettes,
src/espflix.cpp:1091-1200, timing video.cpp:514-630);
tests/test_composite_tables.py verifies bit-equality against the pasted
arrays when the checkout is present.

Conventions: the framework's signal model is the 8-bit DAC sample
stream in temporal order.  (The reference's DMA buffer stores 16-bit
words whose low bytes are packing artifacts the DAC ignores, and whose
sample pairs are position-swapped for the I2S FIFO; both are undone
here.)
"""

from __future__ import annotations

import math

import numpy as np


def ire(x: float) -> int:
    """IRE level -> DAC byte (video.cpp:520: value<<8 for 16-bit)."""
    return int((x + 40) * 255 / 3.3 / 147.5)


SYNC_LEVEL = ire(-40)        # 0
BLANKING_LEVEL = ire(0)      # 20
BLACK_LEVEL = ire(7.5)       # 24
GRAY_LEVEL = ire(50)
WHITE_LEVEL = ire(100)       # 73

NTSC_FREQUENCY = 315000000.0 / 88
PAL_FREQUENCY = 4433618.75
SAMPLES_PER_CC = 4


def usec(us: float, sample_rate_mhz: float, spc: int = SAMPLES_PER_CC) -> int:
    """Color-clock/word-aligned sample count (video.cpp:554-558)."""
    r = int(us * sample_rate_mhz)
    return ((r + spc) // (spc << 1)) * (spc << 1)


def _rup(v: float) -> int:
    return -int(-v + 0.5) if v < 0 else int(v + 0.5)


def _pin127(p: int) -> int:
    return 0 if p < 0 else (p if p < 127 else 127)


def _swaz(w: int) -> int:
    return (w & 0xFF0000FF) | ((w >> 8) & 0xFF00) | ((w << 8) & 0xFF0000)


def _chroma_words(fn) -> np.ndarray:
    """gen_palettes (espflix.cpp:1119-1187): 4 subcarrier samples per
    chroma byte value, packed+swazzed."""
    scale = BLACK_LEVEL / 33.0
    out = np.zeros(256, np.uint32)
    for c in range(256):
        comp = 128 - c
        w = 0
        for i in range(4):
            p = _rup(fn(i) * comp * scale) + 2 * BLACK_LEVEL
            w = (w << 8) | _pin127(p)
        out[c] = _swaz(w)
    return out


UV_TAB_U = _chroma_words(lambda i: math.sin(2 * math.pi * i / 4))
UV_TAB_V = _chroma_words(lambda i: math.cos(2 * math.pi * i / 4))
UV_TAB_V_NEG = _chroma_words(lambda i: -math.cos(2 * math.pi * i / 4))


def table_bytes(words: np.ndarray) -> np.ndarray:
    """[256] packed words -> [256, 4] bytes (byte k = phase slot k)."""
    return np.stack([(words >> (8 * k)) & 0xFF for k in range(4)],
                    axis=1).astype(np.int32)


# 4x4 ordered temporal dither (video.cpp:673-683); [frame_parity*4 +
# line%4][pixel%4]
DITHER4x4 = np.array([
    [0x01, 0x03, 0x02, 0x00],
    [0x02, 0x00, 0x01, 0x03],
    [0x00, 0x01, 0x03, 0x02],
    [0x03, 0x02, 0x00, 0x01],
    [0x02, 0x00, 0x01, 0x03],
    [0x01, 0x03, 0x02, 0x00],
    [0x03, 0x02, 0x00, 0x01],
    [0x00, 0x01, 0x03, 0x02],
], np.int32)


class Geometry:
    """Per-standard line geometry (video.cpp:572-630)."""

    def __init__(self, pal: bool):
        self.pal = pal
        spc = SAMPLES_PER_CC
        if not pal:
            self.sample_rate = 315.0 / 88 * spc
            self.line_width = 228 * spc                # 912
            self.line_count = 262
            self.hsync = usec(4.7, self.sample_rate)   # 64
            self.hsync_long = usec(63.555 - 4.7, self.sample_rate)  # 840
            self.active_start = usec(10, self.sample_rate)          # 144
            self.active_top = 32
            self.vsync_start = self.line_count - 3     # 259
            self.active_shift = 0
        else:
            self.sample_rate = PAL_FREQUENCY * spc / 1e6
            self.line_width = 284 * spc                # 1136
            self.line_count = 312
            self.hsync = usec(4.7, self.sample_rate)
            self.hsync_short = usec(2, self.sample_rate)
            self.hsync_long = usec(30, self.sample_rate)
            self.burst_start = usec(5.6, self.sample_rate)
            self.burst_width = (10 * spc + 4) & 0xFFFE  # 44
            self.active_start = usec(10.4, self.sample_rate)
            self.active_top = 64
            self.vsync_start = self.line_count - 8      # 304
            self.active_shift = 80                      # blit dst += 80
        self.active_lines = 192
        self.active_bottom = self.active_top + 192
        # OSD overlay region (video.cpp:1181-1187)
        self.osd_top = self.active_bottom + 2

    def active_x0(self) -> int:
        return self.active_start + 16 + self.active_shift

    def burst_ntsc(self) -> np.ndarray:
        """Temporal DAC burst samples at [hsync, hsync+40)
        (video.cpp:814-822, position swap undone)."""
        bl = BLANKING_LEVEL
        # buffer positions i..i+3 hold [+BL/2, 0, -BL/2, 0] around BL
        # (video.cpp:817-821); temporal sample t plays buffer[t^1]
        pos = [bl + bl // 2, bl, bl - bl // 2, bl]
        t = [pos[1], pos[0], pos[3], pos[2]]   # [20, 30, 20, 10]
        return np.array(t * 10, np.int32)

    def bursts_pal(self) -> tuple[np.ndarray, np.ndarray]:
        """PAL even/odd line bursts (video.cpp:607-630), float32 phase
        accumulation as in the reference; temporal order."""
        bl = BLANKING_LEVEL << 8
        b0 = np.zeros(self.burst_width, np.int32)
        b1 = np.zeros(self.burst_width, np.int32)
        phase = np.float32(2 * math.pi / 2)
        step = np.float32(2 * math.pi / 4)
        for i in range(self.burst_width):
            b0[i] = int(bl + math.sin(float(phase) + 3 * math.pi / 4)
                        * bl / 1.5)
            b1[i] = int(bl + math.sin(float(phase) - 3 * math.pi / 4)
                        * bl / 1.5)
            phase = np.float32(phase + step)
        # burst_pal writes line[i^1] = b[i] -> temporal sample j = b[j^1]
        idx = np.arange(self.burst_width) ^ 1
        return (b0[idx] >> 8).astype(np.int32), \
            (b1[idx] >> 8).astype(np.int32)
