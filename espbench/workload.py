"""The benchmark's one traffic generator: a cell's inputs from its seed.

A traffic mix is a data file (espbench/traffic/<mix>.json) of
parameters; this module reads it with the cell's configuration
(espbench/configs/<config>.json) and makes everything the cell feeds the
program and the reference: the encoded MPEG-1 streams with their SBC
audio, and per kind of mix the lanes' schedule.

- ``kind: "device_fed"``: `distinct` streams of `pictures` pictures
  tiled over `lanes` lanes, each lane at a seeded GOP phase; per tick
  and lane a seeded OSD, blend, progress, frame parity, beep and a
  `starve_share` of starved lanes.  One chunk of `pictures` ticks, which
  the cell replays: a lane's GOP loop continues seamlessly from chunk to
  chunk.
- ``kind: "sessions"``: a service of `titles` titles of `gops` GOPs
  with their SBC audio, written under a directory the caller gives.  A
  title plays its `unique_gops` encoded GOPs (closed, with their audio)
  over and over with continuing timestamps, so a long title costs no
  more encoding.  Each lane plays a seeded title from a seeded GOP under
  `start_gops`; a lane whose title ends moves to the next of its seeded
  titles from the start.

Same seed, same inputs; every seed draws the same sizes, only the
content and the order differ.  Nothing here imports the program.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from espbench.content import mpeg1_encode as E
from espbench.content.gop_script import realistic_gop_script
from espbench.content.sbc_encode import random_frame


def rng_for(seed: int, *tags: int) -> np.random.Generator:
    """An independent generator for one use of the seed (any whole
    number; negative seeds wrap to 64 bits)."""
    return np.random.default_rng([seed % (1 << 64), *tags])


@dataclass
class Stream:
    """One encoded stream: its MPEG-1 elementary stream and, per picture,
    the SBC frames of that picture's tick."""
    es: bytes
    audio: list          # audio[j]: list of frames_per_tick frames (bytes)


def make_stream(rng, cfg: dict, n_pictures: int) -> Stream:
    """`n_pictures` pictures of the configuration's video in GOPs of
    `gop` (an I picture, then P pictures: the upstream encoder's
    ~1.5 Mb/s operating point) and its SBC audio (`frames_per_tick`
    frames of the configuration's bitpool a picture)."""
    v, a = cfg["video"], cfg["audio"]
    gop = v["gop"]
    if n_pictures % gop:
        raise ValueError(f"{n_pictures} pictures are not whole GOPs of {gop}")
    script = None
    for _ in range(n_pictures // gop):
        s = realistic_gop_script(rng, width=v["width"], height=v["height"],
                                 n_pictures=gop)
        if script is None:
            script = s
        else:
            script["pictures"] += s["pictures"]
    es = E.encode_es(script)
    mode = 0 if a["channels"] == 1 else 2
    audio = [[random_frame(rng, mode=mode, bitpool=a["bitpool"])
              for _ in range(cfg["frames_per_tick"])]
             for _ in range(n_pictures)]
    return Stream(es, audio)


@dataclass
class DeviceFed:
    """A replayed chunk of `K` ticks over `lanes` lanes."""
    streams: list        # [distinct] Stream
    stream_of: np.ndarray    # int64[lanes]
    phase: np.ndarray        # int64[lanes]: lane i shows picture
    #                          (k + phase[i]) % K of its stream at tick k
    osd: np.ndarray          # uint8[K, lanes, 16, 80]
    blend: np.ndarray        # int32[K, lanes]
    progress: np.ndarray     # int32[K, lanes]
    parity: np.ndarray       # int32[K, lanes]
    beep_left: np.ndarray    # int32[K, lanes]
    starved: np.ndarray      # bool[K, lanes]
    checked: np.ndarray      # int64[check_lanes] sorted lanes the
    #                          reference follows in full (tapped)

    @property
    def K(self) -> int:
        return self.osd.shape[0]

    @property
    def lanes(self) -> int:
        return self.stream_of.shape[0]

    def picture(self, k: int) -> np.ndarray:
        """int64[lanes]: the picture index each lane shows at tick k of
        a chunk."""
        return (k + self.phase) % self.K


def device_fed(seed: int, cfg: dict, mix: dict) -> DeviceFed:
    K, lanes, distinct = mix["pictures"], mix["lanes"], mix["distinct"]
    streams = [make_stream(rng_for(seed, 1, s), cfg, K)
               for s in range(distinct)]
    rng = rng_for(seed, 2)
    shape = (K, lanes)
    return DeviceFed(
        streams=streams,
        stream_of=np.arange(lanes) % distinct,
        phase=rng.integers(0, K, lanes),
        osd=rng.integers(0, 256, (K, lanes, 16, 80), dtype=np.uint8),
        blend=rng.integers(0, 256, shape).astype(np.int32),
        progress=rng.integers(0, 241, shape).astype(np.int32),
        parity=rng.integers(0, 2, shape).astype(np.int32),
        beep_left=rng.integers(0, 3, shape).astype(np.int32),
        starved=rng.random(shape) < mix["starve_share"],
        checked=np.sort(rng.choice(lanes, min(mix["check_lanes"], lanes),
                                   replace=False)),
    )


@dataclass
class Sessions:
    """A service on disk and the lanes' plays over it."""
    root: str                # the service's directory
    es: list                 # [titles] the encoded GOPs' elementary
    #                          stream: picture j of a title decodes as
    #                          picture j % period of it
    audio: list              # [titles] the SBC frames (bytes) of one
    #                          period, in order; the title repeats them
    period: int              # pictures a title repeats
    first_title: np.ndarray  # int64[lanes]
    first_gop: np.ndarray    # int64[lanes]
    next_titles: np.ndarray  # int64[lanes, hops]: the title after each end
    checked: np.ndarray      # int64[check_lanes] sorted, tapped lanes

    @property
    def lanes(self) -> int:
        return self.first_title.shape[0]


def sessions(seed: int, cfg: dict, mix: dict, root: str) -> Sessions:
    from espbench.content import indexer
    v, a = cfg["video"], cfg["audio"]
    n_titles, unique, gop = mix["titles"], mix["unique_gops"], v["gop"]
    repeat, rest = divmod(mix["gops"], unique)
    # one SBC frame a 128 samples: 240 ticks of the 90 kHz clock
    n_frames, part = divmod(unique * gop * (90000 // cfg["tick_hz"]), 240)
    if rest or part or mix["start_gops"] > mix["gops"]:
        raise ValueError("a title is not whole periods of video and audio")
    mode = 0 if a["channels"] == 1 else 2
    rngs = [rng_for(seed, 3, i) for i in range(n_titles)]
    arngs = [rng_for(seed, 5, i) for i in range(n_titles)]
    audio = [[random_frame(r, mode=mode, bitpool=a["bitpool"])
              for _ in range(n_frames)] for r in arngs]
    es = indexer.make_service(
        root, [f"title{i:02d}" for i in range(n_titles)], rngs,
        [[(f, k * 240) for k, f in enumerate(af)] for af in audio],
        n_gops=unique, gop=gop, fps=cfg["tick_hz"], width=v["width"],
        height=v["height"], repeat=repeat)
    rng = rng_for(seed, 4)
    lanes = mix["lanes"]
    return Sessions(
        root=root, es=es, audio=audio, period=unique * gop,
        first_title=rng.integers(0, n_titles, lanes),
        first_gop=rng.integers(0, mix["start_gops"], lanes),
        next_titles=rng.integers(0, n_titles, (lanes, mix["hops"])),
        checked=np.sort(rng.choice(lanes, min(mix["check_lanes"], lanes),
                                   replace=False)))
