"""Text/OSD renderer: proportional 16-px font, alpha blend.

Copied from espflix_tpu/video/render.py; tests/test_torch_isolation.py
pins the copy to the original.

Host-side equivalent of the reference's Render class
(src/espflix.cpp:62-174): draws text into either the
80x16 OSD compositing buffer (time readout) or full frame planes
(menus/posters), with the same alpha-blend formula
``p = (color*a + (255-a)*dst) >> 8``.  The glyph set is a procedural
framework-native font (the reference embeds a 1,036-line bitmap font;
we synthesize digits, punctuation and the transport icons
STOP/PAUSE/PLAY/FFWD/RWND at the same metrics instead).
"""

from __future__ import annotations

import functools

import numpy as np

GLYPH_H = 16

# icon code points just below ASCII space (espflix.cpp:53-59)
STOP, PAUSE, PLAY, FFWD, RWND = 0x18, 0x19, 0x1A, 0x1B, 0x1C


def _seg_digit(d: int) -> np.ndarray:
    """7-segment-ish 8x14 digit bitmap, alpha 0/255."""
    on = "1111110 0110000 1101101 1111001 0110011 1011011 1011111 " \
         "1110000 1111111 1111011".split()[d]
    g = np.zeros((14, 8), np.uint8)

    def hseg(row):
        g[row, 2:6] = 255

    def vseg(rows, col):
        g[rows[0]:rows[1], col] = 255

    a, b, c, dd, e, f, gg = (x == "1" for x in on)
    if a:
        hseg(0)
    if b:
        vseg((1, 7), 6)
    if c:
        vseg((8, 13), 6)
    if dd:
        hseg(13)
    if e:
        vseg((8, 13), 1)
    if f:
        vseg((1, 7), 1)
    if gg:
        hseg(7)
    return g


@functools.cache
def font() -> dict[int, np.ndarray]:
    """code point -> [16, w] alpha bitmap."""
    out: dict[int, np.ndarray] = {}
    for d in range(10):
        g = np.zeros((16, 10), np.uint8)
        g[1:15, 1:9] = _seg_digit(d)
        out[ord("0") + d] = g
    colon = np.zeros((16, 5), np.uint8)
    colon[5:7, 1:3] = 255
    colon[10:12, 1:3] = 255
    out[ord(":")] = colon
    out[ord(" ")] = np.zeros((16, 5), np.uint8)
    out[ord(".")] = np.pad(colon[:, :3] * 0, ((0, 0), (0, 0)))
    dot = np.zeros((16, 4), np.uint8)
    dot[12:14, 1:3] = 255
    out[ord(".")] = dot

    def tri(flip=False):
        g = np.zeros((16, 10), np.uint8)
        for r in range(12):
            w = (r if r < 6 else 11 - r) + 1
            g[2 + r, 1:1 + w] = 255
        return g[:, ::-1] if flip else g

    out[PLAY] = tri()
    stop = np.zeros((16, 10), np.uint8)
    stop[3:13, 1:9] = 255
    out[STOP] = stop
    pause = np.zeros((16, 10), np.uint8)
    pause[2:14, 1:4] = 255
    pause[2:14, 6:9] = 255
    out[PAUSE] = pause
    ff = np.zeros((16, 14), np.uint8)
    ff[:, 0:6] = tri()[:, 1:7]
    ff[:, 7:13] = tri()[:, 1:7]
    out[FFWD] = ff
    out[RWND] = ff[:, ::-1]
    # minimal ASCII letters for menus: 5x7 blocky capitals scaled x2
    for ch, pat in _LETTERS.items():
        g = np.zeros((16, 12), np.uint8)
        bm = np.array([[255 if c == "1" else 0 for c in row]
                       for row in pat], np.uint8)
        g[2:2 + 14, 1:11] = np.kron(bm, np.ones((2, 2), np.uint8))
        out[ord(ch)] = g
    return out


_LETTERS = {
    "A": ["01110", "10001", "10001", "11111", "10001", "10001", "10001"],
    "B": ["11110", "10001", "11110", "10001", "10001", "10001", "11110"],
    "C": ["01111", "10000", "10000", "10000", "10000", "10000", "01111"],
    "D": ["11110", "10001", "10001", "10001", "10001", "10001", "11110"],
    "E": ["11111", "10000", "11110", "10000", "10000", "10000", "11111"],
    "L": ["10000", "10000", "10000", "10000", "10000", "10000", "11111"],
    "N": ["10001", "11001", "10101", "10011", "10001", "10001", "10001"],
    "O": ["01110", "10001", "10001", "10001", "10001", "10001", "01110"],
    "P": ["11110", "10001", "11110", "10000", "10000", "10000", "10000"],
    "R": ["11110", "10001", "11110", "10100", "10010", "10001", "10001"],
    "S": ["01111", "10000", "01110", "00001", "00001", "10001", "01110"],
    "T": ["11111", "00100", "00100", "00100", "00100", "00100", "00100"],
}


class Render:
    """Draw into an OSD buffer ([16, 80] uint8) or a frame's Y plane."""

    def __init__(self, target: np.ndarray, color: int = 240):
        self.t = target
        self.color = color

    def erase(self):
        self.t[:] = 0

    def measure_char(self, c: int) -> int:
        g = font().get(c)
        return g.shape[1] if g is not None else 5

    def measure_text(self, s) -> int:
        return sum(self.measure_char(c if isinstance(c, int) else ord(c))
                   for c in s)

    def draw_char(self, x: int, y: int, c: int) -> int:
        g = font().get(c)
        if g is None:
            return 5
        h, w = g.shape
        H, W = self.t.shape[:2]
        for gy in range(h):
            ty = y + gy
            if not (0 <= ty < H):
                continue
            for gx in range(w):
                tx = x + gx
                if not (0 <= tx < W):
                    continue
                a = int(g[gy, gx])
                if a:
                    s = int(self.t[ty, tx])
                    self.t[ty, tx] = (self.color * a
                                      + (255 - a) * s) >> 8
        return w

    def draw_text(self, x: int, y: int, s) -> int:
        for c in s:
            x += self.draw_char(x, y, c if isinstance(c, int) else ord(c))
        return x

    def fill(self, x, y, w, h, color):
        self.t[max(y, 0):y + h, max(x, 0):x + w] = color


def show_time(osd: np.ndarray, seconds: int, icon: int = ord(" ")):
    """Render 'icon h:mm:ss' into the 80x16 OSD buffer
    (espflix.cpp:163-174)."""
    m, s = divmod(int(seconds), 60)
    h, m = divmod(m, 60)
    txt = f"{h}:{m:02d}:{s:02d}" if h else f"  {m:02d}:{s:02d}"
    r = Render(osd)
    r.erase()
    x = r.draw_char(0, 0, icon)
    r.draw_text(x, 0, txt)
    return osd
