"""MPEG-TS muxer: packs video ES + SBC audio into 188-byte packets.

A frozen copy of espflix_tpu_torch/tools/ts_mux.py, kept with
the benchmark so that the yardstick does not move when the program
changes.

Produces streams shaped like the reference's content pipeline output
(indexer/indexer.cpp:302-330: mpegts mux, video PID
0x100, SBC audio PID 0x102, PES PTS on every picture PES / audio PES,
last packet of a PES padded with adaptation-field stuffing).  Used for
test fixtures and for the framework's own content tooling.
"""

from __future__ import annotations

import numpy as np

TS_PACKET = 188
VIDEO_PID = 0x100
AUDIO_PID = 0x102
VIDEO_STREAM_ID = 0xE0
AUDIO_STREAM_ID = 0xBD  # private stream (ffmpeg uses streamid mapping)


def encode_pts(pts: int, flags: int = 0x80) -> bytes:
    """Inverse of the reference's parse_pts (player.cpp:299-307)."""
    check = (flags >> 2) & 0x30
    b0 = check | ((pts >> 29) & 0x0E) | 1
    b12 = (((pts >> 15) & 0x7FFF) << 1) | 1
    b34 = ((pts & 0x7FFF) << 1) | 1
    return bytes([b0, (b12 >> 8) & 0xFF, b12 & 0xFF,
                  (b34 >> 8) & 0xFF, b34 & 0xFF])


def make_pes(stream_id: int, payload: bytes, pts: int = -1,
             with_length: bool = False) -> bytes:
    flags = 0x0080 if pts >= 0 else 0
    hdr_data = encode_pts(pts) if pts >= 0 else b""
    body_len = 3 + len(hdr_data) + len(payload)
    length = body_len if with_length else 0
    assert length < 65536, "PES too large for explicit length"
    return bytes([0, 0, 1, stream_id,
                  (length >> 8) & 0xFF, length & 0xFF,
                  0x80, (flags >> 0) & 0xFF, len(hdr_data)]) \
        + hdr_data + payload


class TsMuxer:
    def __init__(self):
        self.packets: list[bytes] = []
        self.cc = {}

    def _ts_header(self, pid: int, pusi: bool, adapt: bool) -> bytes:
        cc = self.cc.get(pid, 0)
        self.cc[pid] = (cc + 1) & 0xF
        b1 = ((pid >> 8) & 0x1F) | (0x40 if pusi else 0)
        b3 = (0x30 if adapt else 0x10) | cc
        return bytes([0x47, b1, pid & 0xFF, b3])

    def put_pes(self, pid: int, pes: bytes):
        pos = 0
        first = True
        while pos < len(pes):
            chunk = pes[pos:pos + TS_PACKET - 4]
            pos += len(chunk)
            pad = TS_PACKET - 4 - len(chunk)
            if pad == 0:
                pkt = self._ts_header(pid, first, False) + chunk
            else:
                # adaptation-field stuffing (player.cpp:486 consumes it)
                af_len = pad - 1
                af = bytes([af_len]) + (
                    (b"\x00" + b"\xff" * (af_len - 1)) if af_len else b"")
                pkt = self._ts_header(pid, first, True) + af + chunk
            assert len(pkt) == TS_PACKET
            self.packets.append(pkt)
            first = False

    def tobytes(self) -> bytes:
        return b"".join(self.packets)


def mux_av(video_pictures: list[tuple[bytes, int]],
           audio_frames: list[tuple[bytes, int]] | None = None,
           audio_interleave: int = 6,
           leading_es: bytes = b"", trailing_es: bytes = b"") -> bytes:
    """Build a TS from per-picture video ES chunks and SBC audio frames.

    video_pictures: [(es_bytes_for_picture_k, pts_90kHz), ...] -- each
      picture gets its own PES with a PTS (the reference latches _pts per
      video PES, player.cpp:417-419).  leading_es (sequence/GOP headers)
      is prepended to the first picture's PES; trailing_es (sequence_end)
      appended to the last.
    audio_frames: [(sbc_frame_bytes, pts), ...]; grouped audio_interleave
      frames per PES, interleaved with video by PTS order.
    """
    mux = TsMuxer()
    events = []
    for k, (es, pts) in enumerate(video_pictures):
        if k == 0:
            es = leading_es + es
        if k == len(video_pictures) - 1:
            es = es + trailing_es
        events.append((pts, 0, VIDEO_PID, VIDEO_STREAM_ID, es, False))
    if audio_frames:
        for k in range(0, len(audio_frames), audio_interleave):
            group = audio_frames[k:k + audio_interleave]
            data = b"".join(g[0] for g in group)
            pts = group[0][1]
            events.append((pts, 1, AUDIO_PID, AUDIO_STREAM_ID, data, True))
    events.sort(key=lambda e: (e[0], e[1]))
    for pts, _, pid, sid, data, with_len in events:
        mux.put_pes(pid, make_pes(sid, data, pts, with_length=with_len))
    return mux.tobytes()


def split_es_by_picture(es: bytes) -> tuple[bytes, list[bytes], bytes]:
    """Split an ES into (leading headers, per-picture chunks, trailer).

    A picture chunk starts at the sequence/GOP headers immediately
    preceding its picture start code (so a seek to the chunk's PES finds
    the sequence header -- the random-access property the reference's
    indexer keys on, indexer.cpp:128-133) and runs to the start of the
    next chunk; the sequence_end code becomes the trailer.
    """
    a = np.frombuffer(es, np.uint8)
    hits = np.where((a[:-3] == 0) & (a[1:-2] == 0) & (a[2:-1] == 1))[0]
    codes = [(int(p), int(a[p + 3])) for p in hits]
    starts = []          # chunk start per picture
    pending = None       # earliest header pos since last slice/picture
    end = len(es)
    for pos, code in codes:
        if code in (0xB3, 0xB8, 0xB2, 0xB5):
            if pending is None:
                pending = pos
        elif code == 0x00:
            starts.append(pending if pending is not None else pos)
            pending = None
        elif code == 0xB7:
            end = pos
            break
        else:  # slice
            pending = None
    if not starts:
        return es, [], b""
    lead = es[:starts[0]]
    bounds = starts + [end]
    pics = [es[bounds[i]:bounds[i + 1]] for i in range(len(starts))]
    return lead, pics, es[end:]


def mux_video_es(es: bytes, fps: int = 30, pts0: int = 0) -> bytes:
    """Convenience: TS-wrap a whole video ES with 90kHz PTS at fps."""
    lead, pics, trail = split_es_by_picture(es)
    per = 90000 // fps
    video = [(p, pts0 + k * per) for k, p in enumerate(pics)]
    return mux_av(video, leading_es=lead, trailing_es=trail)
