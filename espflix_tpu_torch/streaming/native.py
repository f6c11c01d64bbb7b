"""ctypes bindings to the native bulk TS demuxer (native/ts_demux.cpp),
with transparent fallback to the Python walker.

Copied from espflix_tpu/streaming/native.py; tests/test_torch_isolation.py
pins the copy to the original.
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

from espflix_tpu_torch.streaming import ts as pyts

_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "native")
_LIB = os.path.join(_DIR, "libespflix_native.so")
_lib = None
_tried = False


def lib():
    global _lib, _tried
    if _lib is None and not _tried:
        _tried = True
        try:
            if not os.path.exists(_LIB):
                subprocess.run(["make", "-s"], cwd=_DIR, check=True)
            L = ctypes.CDLL(_LIB)
            L.ts_demux_bulk.restype = ctypes.c_int
            L.ts_demux_bulk.argtypes = [
                ctypes.c_char_p, ctypes.c_long,
                ctypes.c_void_p, ctypes.POINTER(ctypes.c_long),
                ctypes.c_void_p, ctypes.c_void_p,
                ctypes.POINTER(ctypes.c_int), ctypes.c_int,
                ctypes.c_void_p, ctypes.POINTER(ctypes.c_long),
                ctypes.c_void_p, ctypes.c_void_p,
                ctypes.POINTER(ctypes.c_int), ctypes.c_int]
            _lib = L
        except Exception:
            _lib = None
    return _lib


def available() -> bool:
    return lib() is not None


def demux_ts(data: bytes,
             audio_started: bool = False) -> pyts.DemuxResult:
    """Native bulk demux; same output as streaming.ts.demux_ts.
    audio_started keeps the continuing payload of an audio PES that
    opened in a previous buffer (incremental feeds)."""
    L = lib()
    if L is None:
        return pyts.demux_ts_numpy(data, audio_started)
    n = len(data)
    max_marks = max(n // 188, 16)
    # scratch reuse: this runs once per pump chunk per lane (tens of
    # thousands of calls/s at 1k lanes); fresh allocs dominated the
    # host profile
    global _scr
    try:
        video, audio, voff, vpts, aoff, apts = _scr
        if len(video) < n or len(voff) < max_marks:
            raise ValueError
    except (NameError, ValueError):
        cap = max(n, 1 << 20)
        mcap = max(max_marks, 8192)
        video = np.empty(cap, np.uint8)
        audio = np.empty(cap, np.uint8)
        voff = np.empty(mcap, np.int64)
        vpts = np.empty(mcap, np.int64)
        aoff = np.empty(mcap, np.int64)
        apts = np.empty(mcap, np.int64)
        _scr = (video, audio, voff, vpts, aoff, apts)
    vlen = ctypes.c_long(0)
    alen = ctypes.c_long(0)
    nv = ctypes.c_int(0)
    na = ctypes.c_int(0)
    rc = L.ts_demux_bulk(
        data, n, video.ctypes.data, ctypes.byref(vlen),
        voff.ctypes.data, vpts.ctypes.data, ctypes.byref(nv), max_marks,
        audio.ctypes.data, ctypes.byref(alen),
        aoff.ctypes.data, apts.ctypes.data, ctypes.byref(na),
        1 if audio_started else 0)
    out = pyts.DemuxResult()
    out.sync_lost = rc != 0
    out.video = video[:vlen.value].tobytes()
    out.video_pts_marks = [(int(voff[i]), int(vpts[i]))
                           for i in range(nv.value)]
    # audio marks -> AudioChunk list (one chunk per PES for parity with
    # the Python walker is not needed by consumers; deliver one chunk
    # per PES span)
    spans = [int(aoff[i]) for i in range(na.value)] + [int(alen.value)]
    ab = audio[:alen.value].tobytes()
    if spans and spans[0] > 0:
        # continuing payload of a PES opened in a previous buffer
        out.audio.append(pyts.AudioChunk(ab[:spans[0]], -1, True))
    elif not na.value and alen.value:
        out.audio.append(pyts.AudioChunk(ab, -1, True))
    for i in range(na.value):
        out.audio.append(pyts.AudioChunk(
            ab[spans[i]:spans[i + 1]], int(apts[i]), True))
    return out
