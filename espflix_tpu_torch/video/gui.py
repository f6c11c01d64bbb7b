"""Onboarding GUI: link picker, secret keyboard, connecting screen.

Copied from espflix_tpu/video/gui.py; tests/test_torch_isolation.py
pins the copy to the original.

Frame-buffer-drawn UI equivalent of the reference's WiFi onboarding
(espflix.cpp:180-523): a scrolling scan list with quality bars, an
8-row grid keyboard with del/back/join buttons, and a connecting
screen; the key() reducer also folds in link-manager state changes
(scan results arriving, connect completing).  Drawing targets a numpy
Y plane through video.render.Render; the caller presents it like any
other frame (double-buffered immediate mode in the reference,
push_video espflix.cpp:224-227).

Key codes match runtime/input.py (espflix.cpp key_event mapping).
"""

from __future__ import annotations

import numpy as np

from espflix_tpu_torch.streaming.netmgr import LinkState, AUTH_OPEN
from espflix_tpu_torch.video.render import Render

# keyboard grid rows (espflix.cpp:180-189)
PWDS = [
    "0123456789",
    "ABCDEFGHIJKLM",
    "NOPQRSTUVWXZY",
    "abcdefghijklm",
    "nopqrstuvwxyz",
    "!\"#$%&'()*+,-",
    "./:;<=>?@[\\]^",
    "_`{|}~",
]

CELL_W = 20
CELL_H = 17
LIST_LINES = 9

KEY_MENU, KEY_PLAY, KEY_SELECT = 16, 19, 40
KEY_RIGHT, KEY_LEFT, KEY_DOWN, KEY_UP = 79, 80, 81, 82

ST_SELECT, ST_SECRET, ST_CONNECTING = 0, 1, 2


class Gui:
    """State reducer + renderer.  net: NetworkManager."""

    def __init__(self, net, width: int = 352, height: int = 192):
        self.net = net
        self.frame = np.zeros((height, width), np.uint8)
        self.r = Render(self.frame)
        self.state = ST_SELECT
        self.selected = 0
        self.row = 0
        self.col = 0
        self.scroll = 0
        self.secret = ""
        self._link = ""
        self._mode = 0
        self._net_state = LinkState.NONE
        self.dirty = True

    # ---- drawing -------------------------------------------------------

    def _text(self, x, y, s):
        if x == -1:
            x = (self.frame.shape[1] - self.r.measure_text(s)) // 2
        self.r.draw_text(x, y, s)

    def _bars(self, x, y, quality):
        x += 13 * CELL_W - 2 - self.r.measure_text("lllll")
        n = min(max((quality + 85) // 10 + 1, 0), 5)
        for i in range(5):
            self.r.color = 0xA0 if i < n else 0x40
            x = self.r.draw_text(x, y + 3, "l")
        self.r.color = 240

    def draw_select(self):
        links = list(self.net.links().items())
        if self.selected - self.scroll >= LIST_LINES:
            self.scroll = self.selected - LIST_LINES + 1
        elif self.selected < self.scroll:
            self.scroll = self.selected
        y = CELL_H
        x = 2 * CELL_W
        for i, (name, packed) in enumerate(links):
            if not (self.scroll <= i < self.scroll + LIST_LINES):
                continue
            self.r.fill(x, y + 1, 13 * CELL_W, CELL_H - 2,
                        0x40 if i == self.selected else 0x10)
            if i == self.selected:
                self._link = name
                self._mode = packed & 0xFF
            self._text(x + 8, y + 3, name)
            q = (packed >> 8) & 0xFF
            self._bars(x, y, q - 256 if q >= 128 else q)
            y += CELL_H
        self._text(2 * CELL_W, 10 * CELL_H + 3, "Select Access Point")

    def _button(self, x, y, w, label, hot):
        px, py = (x + 2) * CELL_W, (y + 2) * CELL_H
        self.r.fill(px + 1, py, w * CELL_W - 2, CELL_H - 2,
                    0x40 if hot else 0x10)
        tx = px + (CELL_W * w - self.r.measure_text(label)) // 2
        self.r.draw_text(tx, py + 2, label)

    def draw_secret(self):
        # entry line, right-scrolled to fit (draw_p, espflix.cpp:333-343)
        x, y = 2 * CELL_W, CELL_H
        self.r.fill(x, y, 13 * CELL_W, CELL_H, 0x60)
        p = self.secret
        while self.r.measure_text(p + "_") > 12 * CELL_W:
            p = p[1:]
        self.r.draw_text(x + 8, y + 2, p + "_")
        for row, chars in enumerate(PWDS):
            for cx, c in enumerate(chars):
                self._button(cx, row, 1, c,
                             row == self.row and cx == self.col)
        self._button(10, 0, 3, "del", self.row == 0 and self.col >= 10)
        self._button(6, 7, 3, "back",
                     self.row == 7 and 6 <= self.col < 9)
        self._button(9, 7, 4, "join", self.row == 7 and self.col >= 9)
        self._text(2 * CELL_W, 10 * CELL_H + 3, "Enter Password")

    def draw_connecting(self):
        self._text(-1, 4 * CELL_H + 3, "Connecting To")
        self._text(-1, 5 * CELL_H + 3, self.net.current() or self._link)

    def service_error(self):
        self._text(-1, 4 * CELL_H + 3, "Can't connect to service")

    def update(self):
        if self.dirty:
            self.r.erase()
            (self.draw_select, self.draw_secret,
             self.draw_connecting)[self.state]()
            self.dirty = False

    # ---- key reducers ----------------------------------------------------

    def _join(self):
        if len(self.secret) >= 8 or self._mode == AUTH_OPEN:
            self.state = ST_CONNECTING
            self._net_state = LinkState.CONNECTING
            self.dirty = True
            self.update()
            self.net.join(self._link, self.secret)

    def _key_select(self, key):
        n = len(self.net.links())
        if key == KEY_SELECT:
            self.state = ST_SECRET
            if self._mode == AUTH_OPEN:
                self.secret = ""
                self._join()
            self.dirty = True
        elif key == KEY_DOWN and self.selected < n - 1:
            self.selected += 1
            self.dirty = True
        elif key == KEY_UP and self.selected > 0:
            self.selected -= 1
            self.dirty = True

    def _key_secret(self, key):
        if key == KEY_PLAY:
            self._join()
        elif key == KEY_SELECT:
            chars = PWDS[self.row]
            if self.col >= len(chars):
                if self.secret and self.row == 0:
                    self.secret = self.secret[:-1]       # del
                elif self.row == 7:
                    if self.col >= 9:
                        self._join()
                    else:
                        self.state = ST_SELECT           # back
            elif len(self.secret) < 63:
                self.secret += chars[self.col]
            self.dirty = True
        elif key == KEY_RIGHT:
            if self.row == 7 and 6 <= self.col < 9:
                self.col = 9
            if self.col < 12:
                self.col += 1
            self.dirty = True
        elif key == KEY_LEFT:
            if self.row == 0 and self.col > 10:
                self.col = 10
            if self.row == 7:
                if self.col >= 9:
                    self.col = 9
                elif self.col > 6:
                    self.col = 6
            if self.col > 0:
                self.col -= 1
            self.dirty = True
        elif key == KEY_DOWN and self.row < 7:
            self.row += 1
            self.dirty = True
        elif key == KEY_UP and self.row > 0:
            self.row -= 1
            self.dirty = True

    def key(self, k: int, keydown: bool = True) -> int:
        """Feed one key; returns 1 when the link completes, -1 if it was
        already up, 0 otherwise (gui::key, espflix.cpp:487-522)."""
        s = self.net.state()
        if s != self._net_state:
            self._net_state = s
            self.dirty = True
            if s == LinkState.CONNECTED:
                return 1
            if s in (LinkState.SCANNING, LinkState.SCAN_COMPLETE):
                self.state = ST_SELECT
            elif s == LinkState.CONNECTING:
                self.state = ST_CONNECTING
        elif s == LinkState.CONNECTED:
            return -1
        if keydown and k:
            if self.state == ST_SELECT:
                self._key_select(k)
            elif self.state == ST_SECRET:
                self._key_secret(k)
        self.update()
        return 0
