"""Key-event surface: remote-control semantics for sessions.

Copied from espflix_tpu/runtime/input.py; tests/test_torch_isolation.py
pins the copy to the original.

The reference samples an IR photodiode in the video ISR and decodes
NEC/Apple pulses into HID-ish key codes (src/
ir_input.h, mapped at espflix.cpp:1012-1040).  The scanline-rate pulse
demodulation itself lives in espflix_tpu/runtime/ir.py (all four wire
protocols); this module is the *key-event -> playback state machine*
surface with the same key codes and dispatch semantics
(espflix.cpp:941-1008), so any transport (IR waveform, websocket, RPC,
test script) can drive a lane like the remote drives the reference.
"""

from __future__ import annotations

from espflix_tpu_torch.runtime.player import PlayerSession, State

# key codes (espflix.cpp key_event mapping)
KEY_MENU = 16        # 'M'
KEY_PLAY = 19        # 'P' / play-pause
KEY_SELECT = 40      # center
KEY_RIGHT = 79
KEY_LEFT = 80
KEY_DOWN = 81
KEY_UP = 82

# Apple remote scan codes -> key codes (espflix.cpp:1012-1040)
APPLE_MAP = {
    0x40: KEY_MENU, 0x7A: KEY_PLAY, 0x3A: KEY_SELECT,
    0x60: KEY_RIGHT, 0x10: KEY_LEFT, 0x50: KEY_UP, 0x30: KEY_DOWN,
}


def apple_to_key(nec_code: int) -> int:
    return APPLE_MAP.get((nec_code >> 8) & 0x7F, 0)


def dispatch_key(session: PlayerSession, key: int,
                 keydown: bool = True) -> None:
    """Reference key dispatch (espflix.cpp:941-1008) on a session."""
    if not keydown or key == 0:
        return
    st = session.state
    if key == KEY_MENU:
        session.menu()
    elif key in (KEY_PLAY, KEY_SELECT):
        session.play_pause()
    elif key in (KEY_RIGHT, KEY_LEFT):
        left = key == KEY_LEFT
        if st == State.NAV:
            session.nav(session.nav_index + (-1 if left else 1))
        elif st in (State.PLAYING, State.PAUSED):
            session.save_pos(False)
            if left:
                session.rewind()
            else:
                session.fast_forward()
    elif key == KEY_UP:
        if st == State.PLAYING:
            session.skip(30)
    elif key == KEY_DOWN:
        if st == State.PLAYING:
            session.skip(-30)
