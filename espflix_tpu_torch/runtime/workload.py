"""Host-side chunk inputs shaped like bench.py --stage full.

``bench_chunk`` builds the per-tick xs of the full chain exactly as
bench.py's build_chain does (bench.py:268-343): realistic I/P GOPs at
352x192 (tools/content.realistic_gop_script), `distinct` streams tiled
over the lanes in a mixed (or aligned) GOP phase, span-sorted slice
rows, 13 SBC frames per tick from random_frame(mode=0, bitpool=28), and
random OSD, blend, progress, parity, beep and starved state; when
scrolled, random hscrolls and outgoing planes, laid out by
runtime/chunk_layout.py.  The arrays are numpy, so the same inputs feed
the JAX package and the port.
"""

from __future__ import annotations

import functools

import numpy as np

from espflix_tpu_torch.tools import mpeg1_encode as E
from espflix_tpu_torch.tools.content import realistic_gop_script
from espflix_tpu_torch.tools.sbc_encode import random_frame
from espflix_tpu_torch.models import mpeg1 as M
from espflix_tpu_torch.models import sbc as dsbc
from espflix_tpu_torch.ops import scan_dense as SD
from espflix_tpu_torch.ops import vlc_scan as VS
from espflix_tpu_torch.runtime import chunk_layout as CL

F_AUDIO = 13        # 13 x 128 = 1664 >= 1600 PCM samples per 30 Hz tick


@functools.lru_cache(maxsize=4)
def bench_streams(n_pictures: int = 12, distinct: int = 8) -> tuple:
    """(streams, words_per_lane): `distinct` realistic_gop_script
    streams of n_pictures PictureData each, encoded once per process;
    words_per_lane fits the largest picture."""
    streams = []
    for s in range(distinct):
        rng = np.random.default_rng(1000 + s)
        streams.append(tuple(M.parse_es(E.encode_es(realistic_gop_script(
            rng, n_pictures=n_pictures)))[1]))
    wpl = max(max((len(p.payload) + 3) // 4 + 4 for p in ps)
              for ps in streams)
    return tuple(streams), wpl


def bench_pictures(lanes: int, *, n_pictures: int = 12, distinct: int = 8,
                   phase: str = "mixed"):
    """(ticks, words_per_lane): ticks[k] the PictureData of every lane
    at tick k -- bench_streams tiled over the lanes, each lane at a
    random GOP position (phase "mixed", bench.py:137-141) or all at the
    first picture ("aligned")."""
    streams, wpl = bench_streams(n_pictures, distinct)
    if phase == "mixed":
        start = np.random.default_rng(7).integers(0, n_pictures, lanes)
    elif phase == "aligned":
        start = np.zeros(lanes, np.int64)
    else:
        raise ValueError(f"phase {phase!r}")
    ticks = [[streams[i % distinct][(k + start[i]) % n_pictures]
              for i in range(lanes)] for k in range(n_pictures)]
    return ticks, wpl


def bench_chunk(lanes: int, *, n_pictures: int = 12, distinct: int = 8,
                win: bool = False, starve_p: float = 0.01,
                long_rows: int | None = None, phase: str = "mixed",
                pal: bool = False, scrolled: bool = False):
    """(xs, kw, slide): xs a dict of numpy [K, ...] arrays (K =
    n_pictures) with the decode keys (device-window keys when `win`),
    the output keys and, when scrolled, "hscroll"; kw the static
    keyword arguments of run_full_chunk; slide the outgoing (y, u, v)
    uint8[lanes, H, W] planes when scrolled, else None."""
    ticks, wpl = bench_pictures(lanes, n_pictures=n_pictures,
                                distinct=distinct, phase=phase)
    seq = ticks[0][0].seq
    mbw, mbh = seq.mb_width, seq.mb_height
    K = n_pictures
    arng = np.random.default_rng(17)
    frames_a = np.stack(
        [np.frombuffer(random_frame(arng, mode=0, bitpool=28), np.uint8)
         for _ in range(F_AUDIO)])
    aw = dsbc.frames_to_words(np.ascontiguousarray(
        np.broadcast_to(frames_a, (lanes, F_AUDIO, 64))))
    orng = np.random.default_rng(23)
    state = dict(
        osd=orng.integers(0, 256, (K, lanes, 16, 80), dtype=np.uint8),
        blend=orng.integers(0, 256, (K, lanes)).astype(np.int32),
        progress=orng.integers(0, 352, (K, lanes)).astype(np.int32),
        parity=orng.integers(0, 2, (K, lanes)).astype(np.int32),
        beep_left=orng.integers(0, 3, (K, lanes)).astype(np.int32))
    starved = orng.random((K, lanes)) < starve_p
    slide = None
    if scrolled:
        state["hscroll"] = orng.integers(0, 352, (K, lanes)).astype(
            np.int32)
        slide = tuple(orng.integers(0, 249, (lanes, h, w), dtype=np.uint8)
                      for h, w in ((192, 352), (96, 176), (96, 176)))
    xs_t = []
    for k, sel in enumerate(ticks):
        b = M.make_picture_batch(sel, words_per_lane=wpl, max_slices=mbh)
        sl = VS.pack_slice_rows(b, sort_rows=True, device_windows=win)
        assert not sl["overflow"].any()
        perm, dup = SD.row_perm(sl["lane_of_row"], sl["rows"],
                                sl["alive"], lanes, mbh)
        assert not dup.any()
        xs_t.append(CL.tick_inputs(
            sl, perm, b, {n: v[k] for n, v in state.items()},
            (aw, np.ones(lanes, bool), np.full(lanes, F_AUDIO, np.int32),
             starved[k])))
    xs, win = CL.stack_chunk(xs_t)
    NS = lanes * mbh
    kw = dict(mb_width=mbw, mb_height=mbh, n_lanes=lanes,
              long_rows=long_rows or min(2 * lanes, NS // 2),
              steps_long=1024, steps_short=384, n_aud_frames=F_AUDIO,
              channels=1, pal=pal, scrolled=scrolled,
              win=win, chunk=128)
    return xs, kw, slide
