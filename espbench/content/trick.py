"""Titles with upstream-shaped trick streams, and the trick cell's lanes.

The upstream indexer (indexer/indexer.cpp:302-330) makes three streams a
title: ``video.ts``; ``video_fwd.ts``, every ``speed``-th frame
re-encoded at GOP 3 with ``setpts=PTS/speed`` and no audio; and
``video_rwd.ts``, the forward frames reversed and encoded afresh, so its
PTS ascend too.  Then ``video.idx`` over all three.  Here the main
stream is built as content/indexer.make_title builds it (the same
draws from the title's generator, so the same seed gives the same main
stream), and each trick stream is its own `trick_unique` closed GOPs of
`trick_gop` pictures (I P P), drawn with the main stream's content
statistics and played over and over with continuing timestamps, one
picture a tick, as many pictures as the main stream has pictures /
`speed`.  Every trick GOP opens on its sequence header and I picture.

``sessions`` writes a service of such titles and draws the lanes:
starts, titles and hops as content/indexer's served cell draws them
(workload.sessions), and the remote's schedule: `trick_lanes` lanes
cycling through FF, play, RWD, play at a seeded chunk phase, and
`skip_lanes` lanes pressing UP or DOWN once a `skip_every_ticks` ticks
at a seeded chunk phase; the phases of each group spread evenly over
its period, dealt to the lanes at random.
Nothing here imports the program.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

from espbench.content import indexer
from espbench.content import ts_mux
from espbench.content.gop_script import realistic_gop_script
from espbench.content.sbc_encode import random_frame
from espbench.workload import Sessions, rng_for

STREAMS = ("video.ts", "video_fwd.ts", "video_rwd.ts")


def _trick_stream(rng, n_pictures: int, unique: int, gop: int, per: int,
                  width: int, height: int):
    """(ts, es): `unique` closed GOPs of `gop` pictures played over and
    over for `n_pictures` pictures, PTS k * per, no audio."""
    es = indexer.encode_multi_gop([
        realistic_gop_script(rng, n_pictures=gop, width=width,
                             height=height) for _ in range(unique)])
    _lead, pics, trail = ts_mux.split_es_by_picture(es)
    video = [(pics[k % len(pics)], k * per) for k in range(n_pictures)]
    return ts_mux.mux_av(video, None, trailing_es=trail), es


def make_title(rng, trng, audio_frames, n_gops=4, gop=12, fps=30,
               width=352, height=192, repeat=1, speed=15, trick_gop=3,
               trick_unique=4):
    """A title's files {name: bytes} (the three streams, video.idx,
    poster.ts) and its elementary streams [main, fwd, rwd] (one period of
    each).  The main stream draws from `rng`, the trick streams and the
    poster from `trng`."""
    scripts = [realistic_gop_script(rng, n_pictures=gop, width=width,
                                    height=height) for _ in range(n_gops)]
    es = indexer.encode_multi_gop(scripts)
    per = 90000 // fps
    lead, pics, trail = ts_mux.split_es_by_picture(es)
    video = [(p, k * per) for k, p in enumerate(pics * repeat)]
    span = len(pics) * per
    af = [(f, pts + r * span) for r in range(repeat)
          for f, pts in audio_frames]
    main = ts_mux.mux_av(video, af, leading_es=lead, trailing_es=trail)
    n_trick, rest = divmod(len(pics) * repeat, speed)
    if rest or n_trick % (trick_gop * trick_unique):
        raise ValueError("the trick streams are not whole periods")
    fwd, fwd_es = _trick_stream(trng, n_trick, trick_unique, trick_gop,
                                per, width, height)
    rwd, rwd_es = _trick_stream(trng, n_trick, trick_unique, trick_gop,
                                per, width, height)
    poster = ts_mux.mux_video_es(indexer.encode_multi_gop([
        realistic_gop_script(trng, n_pictures=1, width=width,
                             height=height)]), fps=fps)
    files = dict(zip(STREAMS, (main, fwd, rwd)))
    files["video.idx"] = indexer.make_index(main, fwd, rwd, speed)
    files["poster.ts"] = poster
    return files, [es, fwd_es, rwd_es]


@dataclass
class TrickSessions(Sessions):
    """A trick service on disk, the lanes' plays and the remote's
    schedule."""
    trick_es: list = None        # [titles] (fwd es, rwd es), one period
    trick_period: int = 0        # pictures a trick stream repeats
    files: list = None           # [titles] {stream name or "video.idx":
    #                              bytes} the reference reads
    trick: np.ndarray = None     # int64[trick_lanes] sorted
    trick_phase: np.ndarray = None   # int64[trick_lanes] chunk phase
    skip: np.ndarray = None      # int64[skip_lanes] sorted
    skip_phase: np.ndarray = None    # int64[skip_lanes] chunk phase
    skip_up: np.ndarray = None   # bool[skip_lanes, presses]: UP, or DOWN


def sessions(seed: int, cfg: dict, mix: dict, root: str) -> TrickSessions:
    """Write the service under `root` and draw the lanes (see the
    module's docstring)."""
    v, a, tr = cfg["video"], cfg["audio"], cfg["trick"]
    n_titles, unique, gop = mix["titles"], mix["unique_gops"], v["gop"]
    repeat, rest = divmod(mix["gops"], unique)
    n_frames, part = divmod(unique * gop * (90000 // cfg["tick_hz"]), 240)
    if rest or part or mix["start_gops"] > mix["gops"]:
        raise ValueError("a title is not whole periods of video and audio")
    mode = 0 if a["channels"] == 1 else 2
    names = [f"title{i:02d}" for i in range(n_titles)]
    os.makedirs(os.path.join(root, "media"), exist_ok=True)
    with open(os.path.join(root, "manifest.txt"), "w") as f:
        f.write("\n".join(names) + "\n")
    es, trick_es, audio, kept = [], [], [], []
    for i, name in enumerate(names):
        ar = rng_for(seed, 5, i)
        af = [random_frame(ar, mode=mode, bitpool=a["bitpool"])
              for _ in range(n_frames)]
        files, (m, fw, rw) = make_title(
            rng_for(seed, 3, i), rng_for(seed, 6, i),
            [(f, k * 240) for k, f in enumerate(af)], n_gops=unique,
            gop=gop, fps=cfg["tick_hz"], width=v["width"],
            height=v["height"], repeat=repeat, speed=tr["speed"],
            trick_gop=tr["gop"], trick_unique=tr["unique_gops"])
        d = os.path.join(root, "media", name)
        os.makedirs(d, exist_ok=True)
        for fname, data in files.items():
            with open(os.path.join(d, fname), "wb") as f:
                f.write(data)
        del files["poster.ts"]
        es.append(m)
        trick_es.append((fw, rw))
        audio.append(af)
        kept.append(files)
    return TrickSessions(
        root=root, es=es, audio=audio, period=unique * gop,
        trick_es=trick_es, trick_period=tr["unique_gops"] * tr["gop"],
        files=kept, **draw_lanes(seed, mix))


def draw_lanes(seed: int, mix: dict) -> dict:
    """The lanes' starts, hops, groups, taps and key phases (see the
    module's docstring) as TrickSessions fields."""
    rng = rng_for(seed, 4)
    lanes = mix["lanes"]
    first_title = rng.integers(0, mix["titles"], lanes)
    first_gop = rng.integers(0, mix["start_gops"], lanes)
    next_titles = rng.integers(0, mix["titles"], (lanes, mix["hops"]))
    g = rng_for(seed, 7)
    order = g.permutation(lanes)
    nt, ns = mix["trick_lanes"], mix["skip_lanes"]
    trick, skip = np.sort(order[:nt]), np.sort(order[nt:nt + ns])
    plain = np.sort(order[nt + ns:])
    K = mix["ticks_per_chunk"]
    cycle = 2 * (mix["ff_ticks"] + mix["play_ticks"]) // K
    taps = [g.choice(grp, n, replace=False) for grp, n in
            zip((trick, skip, plain), mix["check_per_group"])]
    # phases spread evenly over the cycle, dealt out at random: every
    # chunk boundary sends about as many keys as every other
    period = mix["skip_every_ticks"] // K
    return dict(
        first_title=first_title, first_gop=first_gop,
        next_titles=next_titles, checked=np.sort(np.concatenate(taps)),
        trick=trick, trick_phase=g.permutation(np.arange(nt) * cycle // nt),
        skip=skip, skip_phase=g.permutation(np.arange(ns) * period // ns),
        skip_up=g.random((ns, mix["hops"])) < 0.5)
