"""Content pipeline: build a service directory (TS files + video.idx).

A frozen copy of espflix_tpu_torch/tools/indexer.py, kept with
the benchmark so that the yardstick does not move when the program
changes; here a title may also play its encoded GOPs several times over
(`make_title(repeat=)`), and the index scan is vectorised.

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

from espbench.content import ts_demux
from espbench.content.index_format import BIN_SIZE, IdxHdr, IdxRec
from espbench.content import mpeg1_encode as E
from espbench.content import ts_mux
from espbench.content.gop_script import realistic_gop_script


def scan_sequence_points(ts_bytes: bytes):
    """(pts, packet_index) of every video PES starting with a sequence
    header, plus (first_pts, last_pts) (indexer.cpp:90-173).  The packets
    that start a video PES are picked out at once; only those are read
    one by one."""
    a = np.frombuffer(ts_bytes, np.uint8)
    n = len(a) // 188
    a = a[:n * 188].reshape(n, 188)
    lost = np.flatnonzero(a[:, 0] != 0x47)
    if len(lost):
        a = a[:lost[0]]
    pid = ((a[:, 1].astype(np.int32) << 8) | a[:, 2]) & 0x1FFF
    starts = np.flatnonzero((pid == ts_demux.VIDEO_PID)
                            & ((a[:, 1] & 0x40) != 0)
                            & ((a[:, 3] & 0x10) != 0))
    seqs = []
    first_pts = -1
    last_pts = -1
    for k in starts:
        d = a[k]
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
            seqs.append((pts, int(k)))
        if pts != -1:
            last_pts = pts
    return seqs, first_pts, last_pts


def build_samples(seqs, first_pts, last_pts, bin_size=BIN_SIZE):
    """Nearest-sequence-point packet index per bin (indexer.cpp:176-214);
    the first of two equally near points."""
    end = last_pts - first_pts
    if end < 0:
        return []
    arr = np.array([p for p, _ in seqs], np.int64)
    pos = np.array([q for _, q in seqs], np.uint32)
    pts = np.arange(end // bin_size + 1, dtype=np.int64) * bin_size \
        + first_pts
    nearest = np.abs(arr[None, :] - pts[:, None]).argmin(axis=1)
    return [int(q) for q in pos[nearest]]


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
               i_coeffs=6, p_coeffs=8, repeat=1):
    """Generate (video_ts, fwd_ts, rwd_ts, idx_bytes, poster_ts, es), es
    the video elementary stream of the title's `n_gops` encoded GOPs.

    The title plays those GOPs `repeat` times over with continuing
    timestamps: every GOP is closed (its own sequence header, an I
    picture first), so picture j of the title decodes as picture
    j % (n_gops * gop) of `es`.  `audio_frames` [(sbc_frame, pts)] spans
    the n_gops GOPs and repeats with them; the trick streams repeat
    likewise.

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
    video = [(p, k * per) for k, p in enumerate(pics * repeat)]
    af = None
    if audio_frames is not None:
        span = len(pics) * per
        af = [(f, pts + r * span) for r in range(repeat)
              for f, pts in audio_frames]
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
    fpics = fpics * repeat
    fwd_video = [(p, k * per) for k, p in enumerate(fpics)]
    fwd_ts = ts_mux.mux_av(fwd_video, None, trailing_es=ftrail)

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
    return video_ts, fwd_ts, rwd_ts, idx, poster_ts, es


def make_service(root: str, titles: list[str], rngs: list, audio: list,
                 **kw) -> list[bytes]:
    """Write a complete on-disk service: manifest.txt + per-title media
    dirs (video.ts, video_fwd.ts, video_rwd.ts, video.idx, poster.ts),
    browsable by the player over file:// or HTTP (mirrors
    indexer.cpp:332-338 make_service).  Title i draws its pictures from
    rngs[i] and muxes audio[i], its [(sbc_frame, pts)].  Returns each
    title's video elementary stream."""
    os.makedirs(root, exist_ok=True)
    with open(os.path.join(root, "manifest.txt"), "w") as f:
        f.write("\n".join(titles) + "\n")
    out = []
    for t, rng, af in zip(titles, rngs, audio):
        d = os.path.join(root, "media", t)
        os.makedirs(d, exist_ok=True)
        video, fwd, rwd, idx, poster, es = make_title(rng, audio_frames=af,
                                                      **kw)
        for name, data in (("video.ts", video), ("video_fwd.ts", fwd),
                           ("video_rwd.ts", rwd), ("video.idx", idx),
                           ("poster.ts", poster)):
            with open(os.path.join(d, name), "wb") as f:
                f.write(data)
        out.append(es)
    return out
