"""MPEG transport-stream demux (host side).

Copied from espflix_tpu/streaming/ts.py; tests/test_torch_isolation.py
pins the copy to the original.

Mirrors the reference's integrated TS walk (src/
player.cpp:459-493 ``more`` and :381-436 ``demux``): 188-byte packets,
PID 0x100 = video PES, PID 0x101/0x102 = audio PES (SBC), everything
else skipped (PAT/PMT/PCR tolerated, not required).  Output is the video
elementary stream plus PTS marks at PES boundaries, and the audio
payload records -- the feed for the batched device decoders.

This is the slow-path pure-Python walker; the vectorized/native bulk
demux for thousands of streams lives alongside (demux_ts_numpy).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

VIDEO_PID = 0x100
AUDIO_PIDS = (0x101, 0x102)
TS_PACKET = 188


def parse_pts(d: bytes, flags: int) -> int:
    """PES PTS/DTS 33-bit parse (player.cpp:299-307)."""
    check = (flags >> 2) & 0x30
    if (d[0] & 0xF0) != check:
        return -1
    n = (d[0] & 0x0E) << 29
    n += (((d[1] << 8 | d[2]) >> 1) << 15)
    return n + ((d[3] << 8 | d[4]) >> 1)


@dataclass
class AudioChunk:
    data: bytes
    pts: int          # -1 if none on this PES
    pes_complete: bool


@dataclass
class DemuxResult:
    video: bytes = b""
    # (offset into video, pts) set at each video PES start carrying a PTS
    video_pts_marks: list = field(default_factory=list)
    audio: list = field(default_factory=list)  # list[AudioChunk]
    sync_lost: bool = False


def demux_ts(data: bytes, audio_started: bool = False) -> DemuxResult:
    """audio_started: an audio PES was already open when this buffer
    begins (incremental feeds) -- its continuing payload is kept."""
    out = DemuxResult()
    video = bytearray()
    audio_expected = 0
    audio_mark = 0

    n = len(data) // TS_PACKET
    for k in range(n):
        d = data[k * TS_PACKET:(k + 1) * TS_PACKET]
        if d[0] != 0x47:
            out.sync_lost = True
            break
        pid = ((d[1] << 8) | d[2]) & 0x1FFF
        pusi = (d[1] & 0x40) != 0
        ofs = 4
        if d[3] & 0x20:  # adaptation field
            ofs = 5 + d[4]
        if not (d[3] & 0x10):  # no payload
            continue
        payload = d[ofs:]
        if pid == VIDEO_PID:
            pts = -1
            if pusi:
                expected = (payload[4] << 8) | payload[5]
                flags = (payload[6] << 8) | payload[7]
                hdr = 9 + payload[8]
                if flags & 0x0080:
                    pts = parse_pts(payload[9:14], flags)
                if pts != -1:
                    out.video_pts_marks.append((len(video), pts))
                payload = payload[hdr:]
            video += payload
        elif pid in AUDIO_PIDS:
            pts = -1
            if pusi:
                expected = (payload[4] << 8) | payload[5]
                flags = (payload[6] << 8) | payload[7]
                hdr = 9 + payload[8]
                if flags & 0x0080:
                    pts = parse_pts(payload[9:14], flags)
                if expected:
                    expected -= 3 + payload[8]
                audio_expected = expected
                audio_mark = 0
                audio_started = True
                payload = payload[hdr:]
            if audio_started:
                audio_mark += len(payload)
                out.audio.append(AudioChunk(
                    bytes(payload), pts, audio_mark == audio_expected))
    out.video = bytes(video)
    return out


def demux_ts_numpy(data: bytes,
                   audio_started: bool = False) -> DemuxResult:
    """Vectorized single-stream demux: classifies all packets at once,
    then assembles.  ~20x faster than the scalar walker for long streams;
    identical output."""
    a = np.frombuffer(data, np.uint8)
    n = len(a) // TS_PACKET
    a = a[:n * TS_PACKET].reshape(n, TS_PACKET)
    if n and (a[:, 0] != 0x47).any():
        # fall back to the scalar walker to reproduce stop-at-sync-loss
        return demux_ts(data, audio_started)
    pid = ((a[:, 1].astype(np.int32) << 8) | a[:, 2]) & 0x1FFF
    pusi = (a[:, 1] & 0x40) != 0
    has_af = (a[:, 3] & 0x20) != 0
    has_pay = (a[:, 3] & 0x10) != 0
    ofs = np.where(has_af, 5 + a[:, 4].astype(np.int32), 4)

    out = DemuxResult()
    video_parts = []
    vlen = 0
    vid_sel = np.where((pid == VIDEO_PID) & has_pay)[0]
    for k in vid_sel:
        payload = a[k, ofs[k]:].tobytes()
        if pusi[k]:
            flags = (payload[6] << 8) | payload[7]
            hdr = 9 + payload[8]
            if flags & 0x0080:
                pts = parse_pts(payload[9:14], flags)
                if pts != -1:
                    out.video_pts_marks.append((vlen, pts))
            payload = payload[hdr:]
        video_parts.append(payload)
        vlen += len(payload)
    out.video = b"".join(video_parts)

    audio_expected = 0
    audio_mark = 0
    aud_sel = np.where(np.isin(pid, AUDIO_PIDS) & has_pay)[0]
    for k in aud_sel:
        payload = a[k, ofs[k]:].tobytes()
        pts = -1
        if pusi[k]:
            expected = (payload[4] << 8) | payload[5]
            flags = (payload[6] << 8) | payload[7]
            hdr = 9 + payload[8]
            if flags & 0x0080:
                pts = parse_pts(payload[9:14], flags)
            if expected:
                expected -= 3 + payload[8]
            audio_expected = expected
            audio_mark = 0
            audio_started = True
            payload = payload[hdr:]
        if audio_started:
            audio_mark += len(payload)
            out.audio.append(AudioChunk(
                payload, pts, audio_mark == audio_expected))
    return out
