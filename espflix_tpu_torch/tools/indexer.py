"""Content pipeline: build a service directory (TS files + video.idx).

Copied from espflix_tpu/tools/indexer.py; tests/test_torch_isolation.py
pins the copy to the original.

The framework-native replacement for the reference's offline indexer
(indexer/indexer.cpp): generates/accepts main, fast-
forward and rewind transport streams, scans them for sequence-start
random-access points, and writes the binary-compatible ``video.idx``
(1/12-second bins of 188-byte packet indices; see streaming/index.py).

Since this environment has no ffmpeg, trick streams are produced by the
in-tree encoder: video_fwd.ts re-encodes every ``speed``-th frame with
GOP 3 and PTS compressed by ``speed`` (the setpts=PTS/15 analogue,
indexer.cpp:308); video_rwd.ts is the reversed forward stream
(indexer.cpp:309).
"""

from __future__ import annotations

import os

import numpy as np

from espflix_tpu_torch.streaming import ts as ts_demux
from espflix_tpu_torch.streaming.index import BIN_SIZE, IdxHdr, IdxRec
from espflix_tpu_torch.tools import mpeg1_encode as E
from espflix_tpu_torch.tools import ts_mux
from espflix_tpu_torch.tools.content import realistic_gop_script


def scan_sequence_points(ts_bytes: bytes):
    """(pts, packet_index) of every video PES starting with a sequence
    header, plus (first_pts, last_pts) (indexer.cpp:90-173)."""
    a = np.frombuffer(ts_bytes, np.uint8)
    n = len(a) // 188
    a = a[:n * 188].reshape(n, 188)
    seqs = []
    first_pts = -1
    last_pts = -1
    for k in range(n):
        d = a[k]
        if d[0] != 0x47:
            break
        pid = ((int(d[1]) << 8) | int(d[2])) & 0x1FFF
        if pid != ts_demux.VIDEO_PID or not (d[1] & 0x40) \
                or not (d[3] & 0x10):
            continue
        ofs = 5 + int(d[4]) if d[3] & 0x20 else 4
        payload = bytes(d[ofs:])
        flags = (payload[6] << 8) | payload[7]
        hdr = 9 + payload[8]
        pts = -1
        if flags & 0x0080:
            pts = ts_demux.parse_pts(payload[9:14], flags)
        es = payload[hdr:]
        marker = es[3] if len(es) >= 4 and es[:3] == b"\x00\x00\x01" \
            else -1
        if marker == 0xB3:
            if first_pts == -1:
                first_pts = pts
            seqs.append((pts, k))
        if pts != -1:
            last_pts = pts
    return seqs, first_pts, last_pts


def build_samples(seqs, first_pts, last_pts, bin_size=BIN_SIZE):
    """Nearest-sequence-point packet index per bin (indexer.cpp:176-214)."""
    samples = []
    pts = 0
    end = last_pts - first_pts
    arr = np.array([p for p, _ in seqs], np.int64)
    pos = np.array([q for _, q in seqs], np.uint32)
    while pts <= end:
        i = int(np.abs(arr - (pts + first_pts)).argmin())
        samples.append(int(pos[i]))
        pts += bin_size
    return samples


def make_index(video_ts: bytes, fwd_ts: bytes, rwd_ts: bytes,
               speed: int = 15) -> bytes:
    """Build video.idx bytes from the three streams."""
    recs = []
    sample_arrays = []
    for data, sp in ((video_ts, 1), (fwd_ts, speed), (rwd_ts, speed)):
        seqs, first, last = scan_sequence_points(data)
        assert seqs, "stream has no sequence random-access points"
        samples = build_samples(seqs, first, last)
        recs.append(IdxRec(first, last, BIN_SIZE, sp, len(samples)))
        sample_arrays.append(samples)
    hdr = IdxHdr(*recs)
    out = hdr.pack()
    for s in sample_arrays:
        out += np.asarray(s, np.uint32).tobytes()
    return out


def encode_multi_gop(scripts: list[dict]) -> bytes:
    """Concatenate per-GOP elementary streams (each with its own sequence
    header = a random-access point) + one sequence_end."""
    es = b"".join(E.encode_es(s, sequence_end=False) for s in scripts)
    return es + b"\x00\x00\x01\xb7"


def make_title(rng, n_gops=4, gop=12, fps=30, speed=15,
               audio_frames=None, width=352, height=192,
               i_coeffs=6, p_coeffs=8):
    """Generate (video_ts, fwd_ts, rwd_ts, idx_bytes, poster_ts).

    i_coeffs/p_coeffs bound per-block AC coefficient counts
    (tools/content.realistic_gop_script) -- small values produce
    low-entropy titles whose slices decode within small scan budgets
    (used by the multichip dryrun to keep interpret-mode cost down)."""
    scripts = [realistic_gop_script(rng, n_pictures=gop,
                                    width=width, height=height,
                                    i_coeffs=i_coeffs,
                                    p_coeffs=p_coeffs)
               for _ in range(n_gops)]
    es = encode_multi_gop(scripts)
    per = 90000 // fps
    lead, pics, trail = ts_mux.split_es_by_picture(es)
    video = [(p, k * per) for k, p in enumerate(pics)]
    af = None
    if audio_frames is not None:
        af = audio_frames
    video_ts = ts_mux.mux_av(video, af, leading_es=lead,
                             trailing_es=trail)

    # forward trick stream: every `speed`-th frame as I-only GOP 3,
    # PTS compressed by `speed`
    n_total = n_gops * gop
    n_fwd = max(n_total // speed, 2)
    fwd_scripts = [realistic_gop_script(rng, n_pictures=3,
                                        width=width, height=height,
                                        i_coeffs=i_coeffs,
                                        p_coeffs=p_coeffs)
                   for _ in range(max(n_fwd // 3, 1))]
    fes = encode_multi_gop(fwd_scripts)
    _, fpics, ftrail = ts_mux.split_es_by_picture(fes)
    flead = b""
    fwd_video = [(p, k * per) for k, p in enumerate(fpics)]
    fwd_ts = ts_mux.mux_av(fwd_video, None, leading_es=flead,
                           trailing_es=ftrail)

    # rewind = reversed forward chunks, fresh ascending PTS
    rpics = list(reversed(fpics))
    rwd_video = [(p, k * per) for k, p in enumerate(rpics)]
    rwd_ts = ts_mux.mux_av(rwd_video, None, trailing_es=ftrail)

    idx = make_index(video_ts, fwd_ts, rwd_ts, speed)

    poster_scripts = [realistic_gop_script(rng, n_pictures=1,
                                           width=width, height=height,
                                           i_coeffs=i_coeffs,
                                           p_coeffs=p_coeffs)]
    poster_es = encode_multi_gop(poster_scripts)
    poster_ts = ts_mux.mux_video_es(poster_es, fps=fps)
    return video_ts, fwd_ts, rwd_ts, idx, poster_ts


def make_service(root: str, titles: list[str], seed=0, **kw):
    """Write a complete on-disk service: manifest.txt + per-title media
    dirs (video.ts, video_fwd.ts, video_rwd.ts, video.idx, poster.ts),
    browsable by the player over file:// or HTTP (mirrors
    indexer.cpp:332-338 make_service)."""
    rng = np.random.default_rng(seed)
    os.makedirs(root, exist_ok=True)
    with open(os.path.join(root, "manifest.txt"), "w") as f:
        f.write("\n".join(titles) + "\n")
    for t in titles:
        d = os.path.join(root, "media", t)
        os.makedirs(d, exist_ok=True)
        video, fwd, rwd, idx, poster = make_title(rng, **kw)
        for name, data in (("video.ts", video), ("video_fwd.ts", fwd),
                           ("video_rwd.ts", rwd), ("video.idx", idx),
                           ("poster.ts", poster)):
            with open(os.path.join(d, name), "wb") as f:
                f.write(data)
