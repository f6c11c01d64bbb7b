"""Navigation menu screen: title list + selection, drawn into frames.

Copied from espflix_tpu/video/menu.py; tests/test_torch_isolation.py
pins the copy to the original.

The reference's GUI renders WiFi onboarding screens into the frame
buffers with cell-grid buttons and a highlight bar
(src/espflix.cpp:195-523).  WiFi onboarding itself is
hardware-specific (dropped, SURVEY non-goal); the framework keeps the
*frame-drawn menu surface*: a title browser rendered into a lane's
YUV planes, used by the NAV state alongside posters.  Same cell
metrics (20x17) and fill/highlight levels as the reference.
"""

from __future__ import annotations

import numpy as np

from espflix_tpu_torch.video.render import Render

CELL_W, CELL_H = 20, 17
LINES = 9


def draw_menu(y_plane: np.ndarray, titles: list[str], selected: int,
              scroll: int = 0, header: str = "SELECT TITLE"):
    """Render the nav list into a Y plane (uint8 [H, W]); U/V stay
    neutral (callers fill 128).  Returns the scroll offset actually
    used (the reference's keep-selection-visible rule,
    espflix.cpp:252-257)."""
    if selected - scroll >= LINES:
        scroll = selected - LINES + 1
    elif selected < scroll:
        scroll = selected
    r = Render(y_plane)
    y_plane[:] = 0
    x = 2 * CELL_W
    y = CELL_H
    for i, t in enumerate(titles):
        if i < scroll or i - scroll >= LINES:
            continue
        r.fill(x, y + 1, 13 * CELL_W, CELL_H - 2,
               0x40 if i == selected else 0x10)
        r.draw_text(x + 8, y + 1, t.upper()[:18])
        y += CELL_H
    r.draw_text(x, 10 * CELL_H + 3, header.upper())
    return scroll


def menu_frame(titles: list[str], selected: int, width=352, height=192):
    """Full YUV menu frame (neutral chroma)."""
    y = np.zeros((height, width), np.uint8)
    draw_menu(y, titles, selected)
    u = np.full((height // 2, width // 2), 128, np.uint8)
    v = np.full((height // 2, width // 2), 128, np.uint8)
    return y, u, v
