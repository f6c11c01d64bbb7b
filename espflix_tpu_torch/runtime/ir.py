"""IR remote input: scanline-rate sampling, 4 wire protocols, HID synth.

Copied from espflix_tpu/runtime/ir.py; tests/test_torch_isolation.py
pins the copy to the original.

TPU-native equivalent of the reference's IR stack (ir_input.h: `ir_sample`
at :38-49, `ir_event` dispatch :643-657, NEC/Apple :163-182, Atari
Flashback :190-266, RETCON :270-356, WebTV keyboard :360-630, repeat/HID
state :51-96).  The reference samples a GPIO once per scanline (63.55us)
inside the video ISR and feeds level-change events to per-protocol FSMs.

Here the sampling side is batch-first: the output stage synthesizes whole
fields at a time, so IR arrives as per-field sample VECTORS (one sample
per scanline, matching the composite geometry's line count).  Edge
extraction over a field is vectorized numpy run-length encoding with
carried (last_level, run_count) state across fields; the protocol FSMs
then consume the handful of edges per field as cheap host scalars (a
remote produces <100 edges per field -- this is control plane, not data
plane).  Timing is in scanline ticks exactly like the reference, so all
protocol thresholds carry over unchanged.

Intended scale: IR is per-viewer input, a few events per second per
session at most.  The per-lane host cost is O(edges in the field), so
thousands of lanes with attached remotes stay in control-plane noise
(lanes without an input device never touch this module); the decode
data path is unaffected either way.

Every decoder is a small class; `IrInput` fans each event to all enabled
protocols and polls them once per frame for HID reports, mirroring
`ir_event`/`get_hid_ir`.
"""

from __future__ import annotations

import numpy as np

# generic button mask (streamer.h:145-163)
GENERIC_MENU = 0x0001
GENERIC_UP = 0x0002
GENERIC_DOWN = 0x0004
GENERIC_LEFT = 0x0008
GENERIC_RIGHT = 0x0010
GENERIC_FIRE = 0x0020
GENERIC_SELECT = 0x0040
GENERIC_START = 0x0080
GENERIC_RESET = 0x0100
GENERIC_FIRE_C = 0x0200
GENERIC_FIRE_B = 0x0400
GENERIC_FIRE_A = 0x0800
GENERIC_FIRE_Z = 0x1000
GENERIC_FIRE_Y = 0x2000
GENERIC_FIRE_X = 0x4000
GENERIC_OTHER = 0x8000

NEC_REPEAT = 0xAAAA

# Apple silver remote 7-bit codes (ir_input.h:107-115)
APPLE_MENU = 0x40
APPLE_PLAY = 0x7A
APPLE_CENTER = 0x3A
APPLE_RIGHT = 0x60
APPLE_LEFT = 0x10
APPLE_UP = 0x50
APPLE_DOWN = 0x30


class EdgeSampler:
    """Scanline-rate GPIO sampling -> (ticks, level) edge events.

    Equivalent of `ir_sample` (ir_input.h:38-49) but consuming a whole
    field's samples per call, vectorized.  Tick counts saturate at 255
    exactly like the reference's uint8 `_ir_count`."""

    def __init__(self):
        self._last = 0
        self._count = 0

    def feed(self, samples: np.ndarray):
        """samples: uint8/bool [n_lines].  Returns list[(ticks, level)]
        of level-change events; `level` is the level BEFORE the edge."""
        s = np.asarray(samples).astype(np.uint8)
        events = []
        # positions where the level differs from the previous sample
        prev = np.concatenate(([self._last], s[:-1]))
        edges = np.nonzero(s != prev)[0]
        start = 0
        count = self._count
        for e in edges:
            count = min(count + int(e - start), 255)
            events.append((count, int(prev[e])))
            count = 0
            start = int(e)
        self._count = min(count + int(len(s) - start), 255)
        self._last = int(s[-1]) if len(s) else self._last
        return events


class RepeatState:
    """Held-button mask pair with expiry timers + HID joystick report
    (IRState, ir_input.h:51-96)."""

    def __init__(self):
        self._joy = [0, 0]
        self._joy_last = [0, 0]
        self._timer = [0, 0]

    def set(self, player: int, mask: int, frames: int):
        # reject impossible opposite-direction chords (ir_input.h:61-70)
        if (mask & (GENERIC_LEFT | GENERIC_RIGHT)) == \
                (GENERIC_LEFT | GENERIC_RIGHT):
            return
        if (mask & (GENERIC_UP | GENERIC_DOWN)) == \
                (GENERIC_UP | GENERIC_DOWN):
            return
        self._joy[player] = mask
        self._timer[player] = frames

    def get_hid(self) -> bytes:
        for i in (0, 1):
            if self._timer[i]:
                self._timer[i] -= 1
                if not self._timer[i]:
                    self._joy[i] = 0
        if self._joy != self._joy_last:
            self._joy_last = list(self._joy)
            return bytes([0xA1, 0x42,
                          self._joy[0] & 0xFF, self._joy[0] >> 8,
                          self._joy[1] & 0xFF, self._joy[1] >> 8])
        return b""


class NecDecoder:
    """NEC protocol (Apple TV remote variant), ir_input.h:163-182.

    9ms preamble, 4.5ms start space (2.25ms = repeat); 32 data bits,
    bit = mark-to-mark distance (>=12 ticks -> 1, <12 -> 0).  Output is
    the full 32-bit code's low 16 bits with the 7-bit Apple key in bits
    14-8; repeat emits NEC_REPEAT."""

    APPLE_MAP = {
        APPLE_UP: GENERIC_UP, APPLE_DOWN: GENERIC_DOWN,
        APPLE_LEFT: GENERIC_LEFT, APPLE_RIGHT: GENERIC_RIGHT,
        APPLE_CENTER: GENERIC_FIRE, APPLE_MENU: GENERIC_RESET,
        APPLE_PLAY: GENERIC_SELECT,
    }

    def __init__(self):
        self._state = 0
        self._code = 0
        self.output = 0
        self._key_down = 0
        self._rep = RepeatState()

    def event(self, ticks: int, level: int):
        if level == 0:
            if ticks > 32:          # preamble-length low: restart
                self._state = 0
        else:
            if ticks < 32:          # data mark spacing
                self._code = ((self._code << 1) & 0xFFFF)
                if ticks >= 12:
                    self._code |= 1
                self._state += 1
                if self._state == 32:
                    self.output = self._code
            else:
                if 32 < ticks < 40 and self._state == 0:
                    self.output = NEC_REPEAT   # 2.25ms repeat space
                self._state = 0

    def get_nec(self) -> int:
        k, self.output = self.output, 0
        return k

    def get_hid(self) -> bytes:
        if self.output:
            if self.output != NEC_REPEAT:
                self._key_down = (self.output >> 8) & 0x7F
            self.output = 0
            mask = self.APPLE_MAP.get(self._key_down, 0)
            self._rep.set(0, mask, 15)     # 108ms repeat window
        return self._rep.get_hid()


class FlashbackDecoder:
    """Atari Flashback 4 wireless controller, ir_input.h:190-266.

    2.3ms zero preamble (34..38 ticks), then 18+1 rising-edge bits:
    long mark (11..15) = 1, short (2..6) = 0; 12 button bits + 4-bit
    checksum distinguishing player 1 (sum+1) from player 2 (sum-1)."""

    def __init__(self):
        self._state = 0
        self._code = 0
        self.output = 0
        self._rep = RepeatState()

    @staticmethod
    def _short(t):
        return 2 <= t <= 6

    @staticmethod
    def _long(t):
        return 11 <= t <= 15

    def event(self, ticks: int, level: int):
        if self._state == 0:
            if 34 <= ticks <= 38 and level == 0:
                self._state = 1
        elif level:
            self._code = (self._code << 1) & 0x7FFFF
            if self._long(ticks):
                self._code |= 1
            elif not self._short(ticks):
                self._state = 0
                return
            self._state += 1
            if self._state == 19:
                self.output = self._code & 0xFFFF
                self._state = 0
        else:
            if not self._short(ticks):
                self._state = 0

    def get_hid(self) -> bytes:
        if self.output:
            mask = self.output >> 4
            csum = self.output & 0xF
            s = (mask + (mask >> 4) + (mask >> 8)) & 0xF
            if ((s + 1) & 0xF) == csum:
                self._rep.set(0, mask, 15)
            elif ((s - 1) & 0xF) == csum:
                self._rep.set(1, mask, 20)
            self.output = 0
        return self._rep.get_hid()


class RetconDecoder:
    """RETCON controller, ir_input.h:270-356.

    Preamble 0.80ms low (12..14 ticks); 16 bits signalled by low-pulse
    width (4..6 = 1, 8..10 = 0); bit 15 selects the player; 12 button
    bits map through _JMAP."""

    _JMAP = (
        (0x0400, GENERIC_UP), (0x0200, GENERIC_DOWN),
        (0x0100, GENERIC_LEFT), (0x0080, GENERIC_RIGHT),
        (0x1000, GENERIC_SELECT), (0x0800, GENERIC_START),
        (0x0020, GENERIC_FIRE_X), (0x0040, GENERIC_FIRE_Y),
        (0x0002, GENERIC_FIRE_Z), (0x2000, GENERIC_FIRE_A),
        (0x4000, GENERIC_FIRE_B), (0x0008, GENERIC_FIRE_C),
    )

    def __init__(self):
        self._state = 0
        self._code = 0
        self.output = 0
        self._rep = RepeatState()

    def event(self, ticks: int, level: int):
        if self._state == 0:
            if level == 0 and 12 <= ticks <= 14:
                self._state = 1
        elif level == 0:
            self._code = (self._code << 1) & 0xFFFF
            if 4 <= ticks <= 6:
                self._code |= 1
            if self._state == 16:
                self.output = self._code
                self._state = 0
            else:
                self._state += 1

    def get_hid(self) -> bytes:
        if self.output:
            k, self.output = self.output, 0
            mask = 0
            for bit, generic in self._JMAP:
                if k & bit:
                    mask |= generic
            self._rep.set(k >> 15, mask, 20)
        return self._rep.get_hid()


# WebTV keyboard IR code -> key name (the factual protocol mapping from
# ir_input.h:365-506's commented table; usages resolved through the
# standard USB HID usage table below rather than copied numerically)
_WEBTV_KEYS = {
    0x04: "B", 0x0A: "Down", 0x12: "Left", 0x14: "RAlt", 0x16: "/",
    0x18: "LAlt", 0x1A: "Right", 0x1C: "Space", 0x1E: "N", 0x20: "#",
    0x24: "5", 0x26: "F8", 0x28: "F2", 0x2A: "RCtrl", 0x2E: "=",
    0x30: "F1", 0x32: "Home", 0x36: "-", 0x38: "LCtrl", 0x3A: "`",
    0x3C: "F9", 0x3E: "6", 0x44: "V", 0x46: ".", 0x48: "C", 0x4A: "F13",
    0x4C: "RShift", 0x4E: ",", 0x50: "X", 0x52: "End", 0x58: "Z",
    0x5C: "Return", 0x5E: "M", 0x62: "RGui", 0x64: "F", 0x66: "L",
    0x68: "D", 0x6A: "PageDown", 0x6E: "K", 0x70: "S", 0x72: "PageUp",
    0x76: ";", 0x78: "A", 0x7C: "|", 0x7E: "J", 0x84: "T", 0x86: "F7",
    0x88: "F3", 0x8C: "LShift", 0x8E: "]", 0x90: "CapsLock",
    0x94: "Escape", 0x96: "[", 0x98: "Tab", 0x9C: "Backspace",
    0x9E: "Y", 0xA4: "4", 0xA6: "9", 0xA8: "3", 0xAA: "F11", 0xAE: "8",
    0xB0: "2", 0xB4: "PrintScreen", 0xB6: "0", 0xB8: "1", 0xBA: "F12",
    0xBC: "F10", 0xBE: "7", 0xC4: "G", 0xC8: "F4", 0xD0: "F5",
    0xD2: "Up", 0xD4: "LGui", 0xD6: "'", 0xD8: "Escape", 0xDA: "Pause",
    0xDC: "F6", 0xDE: "H", 0xE4: "R", 0xE6: "O", 0xE8: "E", 0xEE: "I",
    0xF0: "W", 0xF4: "NumLock", 0xF6: "P", 0xF8: "Q", 0xFE: "U",
}

# standard USB HID keyboard usage IDs
_HID_USAGE = {}
for _i in range(26):
    _HID_USAGE[chr(ord("A") + _i)] = 0x04 + _i
for _i in range(9):
    _HID_USAGE[str(_i + 1)] = 0x1E + _i
_HID_USAGE.update({
    "0": 0x27, "Return": 0x28, "Escape": 0x29, "Backspace": 0x2A,
    "Tab": 0x2B, "Space": 0x2C, "-": 0x2D, "=": 0x2E, "[": 0x2F,
    "]": 0x30, "|": 0x31, "#": 0x32, ";": 0x33, "'": 0x34, "`": 0x35,
    ",": 0x36, ".": 0x37, "/": 0x38, "CapsLock": 0x39,
    "PrintScreen": 0x46, "Pause": 0x48, "Home": 0x4A, "PageUp": 0x4B,
    "End": 0x4D, "PageDown": 0x4E, "Right": 0x4F, "Left": 0x50,
    "Down": 0x51, "Up": 0x52, "NumLock": 0x53, "F13": 0x68,
    "LCtrl": 0xE0, "LShift": 0xE1, "LAlt": 0xE2, "LGui": 0xE3,
    "RCtrl": 0xE4, "RShift": 0xE5, "RAlt": 0xE6, "RGui": 0xE7,
})
for _i in range(12):
    _HID_USAGE[f"F{_i + 1}"] = 0x3A + _i

_MOD_MASK = {"LCtrl": 0x01, "LShift": 0x02, "LAlt": 0x04, "LGui": 0x08,
             "RCtrl": 0x10, "RShift": 0x20, "RAlt": 0x40, "RGui": 0x80}


def _webtv_scancode(code7: int) -> int:
    return _HID_USAGE.get(_WEBTV_KEYS.get((code7 << 1) & 0xFE, ""), 0)


def _webtv_modmask(code7: int) -> int:
    return _MOD_MASK.get(_WEBTV_KEYS.get((code7 << 1) & 0xFE, ""), 0)


def _parity_ok(k: int) -> bool:
    return bin(k).count("1") & 1 == 1


class WebTVKeyboard:
    """WebTV IR keyboard: UART-like 12-tick baud, ir_input.h:360-630.

    3.25-baud zero preamble, short start bit, then 16 bits sampled by
    run length; code = [cmd:8][key7:7][parity:1]; cmd 0x4A = keydown,
    0x5E = keyup.  Poll side keeps 6-key rollover with 8-frame expiry
    and a modifier mask, emitting HID keyboard records (A1 01 ...)."""

    BAUD = 12

    def __init__(self):
        self._state = 0
        self._code = 0
        self._key_down = 0
        self._key_up = 0
        self._keys = [0] * 6
        self._expire = [0] * 6
        self._mods = 0

    def event(self, ticks: int, level: int):
        if self._state == 0:
            if 36 <= ticks <= 40 and level == 0:
                self._state = 1
        elif self._state == 1:
            self._state = 2 if (9 <= ticks <= 13 and level == 1) else 0
        else:
            t = ticks + (self.BAUD >> 1)
            bits = self._state - 2
            while t > self.BAUD and bits < 16:
                t -= self.BAUD
                self._code = ((self._code << 1) | level) & 0xFFFF
                bits += 1
            if bits == 16:
                self._code |= int(t <= self.BAUD)   # trailing bit
                cmd = self._code >> 8
                if cmd == 0x4A:
                    self._key_down = self._code & 0xFF
                elif cmd == 0x5E:
                    self._key_up = self._code & 0xFF
                self._state = 0
            else:
                self._state = bits + 2

    def get_hid(self) -> bytes:
        dirty = False
        k = self._key_up if _parity_ok(self._key_up) else 0
        self._key_up = 0
        if k:
            self._mods &= ~_webtv_modmask(k >> 1)
            for i in range(6):
                if self._keys[i] == k:
                    self._expire[i] = 1
                    break
        k = self._key_down if _parity_ok(self._key_down) else 0
        self._key_down = 0
        if k:
            self._mods |= _webtv_modmask(k >> 1)
            j = 0
            for i in range(6):
                if (self._keys[i] == 0 or self._expire[i] == 0
                        or self._keys[i] == k):
                    j = i
                    break
                if self._expire[i] < self._expire[j]:
                    j = i
            if self._keys[j] != k:
                self._keys[j] = k
                dirty = True
            self._expire[j] = 8     # held ~130ms
        out = bytearray([0xA1, 0x01, self._mods, 0, 0, 0, 0, 0, 0, 0])
        j = 0
        for i in range(6):
            if self._expire[i]:
                self._expire[i] -= 1
                if not self._expire[i]:
                    dirty = True
            if self._expire[i] == 0:
                self._keys[i] = 0
            else:
                out[4 + j] = _webtv_scancode(self._keys[i] >> 1)
                j += 1
        return bytes(out) if dirty else b""


class IrInput:
    """Sampling + multi-protocol dispatch + per-frame HID poll
    (ir_event/get_hid_ir, ir_input.h:643-680)."""

    def __init__(self, protocols=("nec",)):
        self._sampler = EdgeSampler()
        self.nec = NecDecoder() if "nec" in protocols else None
        self.retcon = RetconDecoder() if "retcon" in protocols else None
        self.flashback = (FlashbackDecoder()
                          if "flashback" in protocols else None)
        self.webtv = WebTVKeyboard() if "webtv" in protocols else None
        self._decoders = [d for d in (self.webtv, self.retcon, self.nec,
                                      self.flashback) if d is not None]

    def feed_field(self, samples: np.ndarray):
        """One field's scanline-rate GPIO samples."""
        for ticks, level in self._sampler.feed(samples):
            for d in self._decoders:
                d.event(ticks, level)

    def get_nec(self) -> int:
        return self.nec.get_nec() if self.nec else 0

    def get_hid(self) -> bytes:
        """Per-frame poll: first decoder with a report wins
        (get_hid_ir priority order, ir_input.h:660-680)."""
        for d in (self.nec, self.retcon, self.flashback):
            if d is not None:
                r = d.get_hid()
                if r:
                    return r
        if self.webtv is not None:
            return self.webtv.get_hid()
        return b""
