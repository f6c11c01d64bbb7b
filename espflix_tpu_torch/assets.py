"""Embedded boot assets: procedurally generated splash movie.

Copied from espflix_tpu/assets.py; tests/test_torch_isolation.py
pins the copy to the original.

The reference ships a 247KB splash TS in flash (splash.h:12) played at
boot via play_rom (espflix.cpp:699) before any network exists.  Blobs
in a package are a liability; the splash here is GENERATED -- a
deterministic short A/V title card (fade-in text + sine sting) built
from the in-tree MPEG-1/SBC encoders and TS muxer -- and cached on
disk (build/assets of this checkout), so the boot pathway
(PlayerSession.play_rom) has real content with zero checked-in
binaries.

Determinism: integer-only drawing and fixed synthesis; the same version
always produces byte-identical assets (safe to cache and hash).
"""

from __future__ import annotations

import os

import numpy as np

_CACHE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "build", "assets")
_SPLASH_VERSION = 1


def _splash_script(n_pictures: int = 24, width: int = 352,
                   height: int = 192) -> dict:
    """Title card fading in: every picture is intra, per-MB DC tracks
    the drawn card's mean luma scaled by the fade."""
    from espflix_tpu_torch.video.render import Render

    mbw, mbh = width // 16, height // 16
    canvas = np.zeros((height, width), np.uint8)
    r = Render(canvas, color=200)
    text = "ESPFLIX TPU"
    x = (width - r.measure_text(text)) // 2
    r.draw_text(x, height // 2 - 8, text)

    card_dc = np.zeros((mbh, mbw), np.int32)
    for my in range(mbh):
        for mx in range(mbw):
            blk = canvas[my * 16:(my + 1) * 16, mx * 16:(mx + 1) * 16]
            card_dc[my, mx] = min(int(blk.mean()) + 16, 232)

    pictures = []
    for k in range(n_pictures):
        fade_num = k + 1
        slices = []
        for my in range(mbh):
            mbs = []
            for mx in range(mbw):
                dc = int(card_dc[my, mx]) * fade_num // n_pictures
                blocks = [[(0, dc)]] * 4 + [[(0, 128)]] * 2
                mbs.append(dict(intra=True, blocks=blocks))
            slices.append(dict(row=my, qscale=8, mbs=mbs))
        pictures.append(dict(type="I", slices=slices))
    return dict(width=width, height=height, pictures=pictures)


def _encode_splash(fps: int = 12) -> bytes:
    from espflix_tpu_torch.tools import mpeg1_encode as E
    from espflix_tpu_torch.tools import sbc_encode
    from espflix_tpu_torch.tools import ts_mux

    es = E.encode_es(_splash_script())
    lead, pics, trail = ts_mux.split_es_by_picture(es)
    per = 90000 // fps
    video = [(p, k * per) for k, p in enumerate(pics)]

    # 2s 440Hz sting with a soft attack, SBC mono 48kHz
    t = np.arange(48000 * 2, dtype=np.float64)
    pcm = (np.sin(2 * np.pi * 440 * t / 48000)
           * 6000 * np.minimum(t / 4800, 1.0)).astype(np.int16)
    frames = sbc_encode.encode_pcm_mono(pcm)
    audio = [(f, k * 240) for k, f in enumerate(frames)]  # 128/48k@90k

    return ts_mux.mux_av(video, audio, leading_es=lead,
                         trailing_es=trail)


def splash_ts(refresh: bool = False) -> bytes:
    """The boot splash TS; generated once and cached."""
    path = os.path.join(_CACHE, f"splash_v{_SPLASH_VERSION}.ts")
    if not refresh and os.path.exists(path):
        with open(path, "rb") as f:
            return f.read()
    data = _encode_splash()
    os.makedirs(_CACHE, exist_ok=True)
    tmp = path + f".tmp{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(data)
    os.replace(tmp, path)
    return data
