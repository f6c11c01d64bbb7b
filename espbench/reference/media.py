"""What the reference works out from a cell's streams: decoded pictures,
the parse's counts, and each tick's PCM.

Plain NumPy over the frozen reference decoders (refdec.py, sbc.py).
``decode_all`` decodes every stream in a pool of worker processes (one
stream a task), which it shuts down before it returns.
"""

from __future__ import annotations

import concurrent.futures as cf
import multiprocessing
import os

import numpy as np

from espbench.reference import refdec
from espbench.reference.audio import decode_frames


def decode_stream(es: bytes, control: bool = False):
    """(pictures, stats): pictures[j] = (y, u, v) uint8 planes of the
    j-th picture in decode order, stats[j] the parse's counts of that
    picture (refdec.Mpeg1Decoder.pic_stats) plus its coded bytes.
    control=True decodes with the float32 IDCT (the control)."""
    dec = refdec.Mpeg1Decoder(
        idct=refdec.idct_float32 if control else refdec.idct_ref)
    frames = dec.decode_es(es)
    if len(frames) != len(dec.pic_stats):
        raise ValueError(f"{len(frames)} pictures presented, "
                         f"{len(dec.pic_stats)} parsed")
    sizes = picture_bytes(es)
    stats = [dict(st, bytes=n) for st, n in zip(dec.pic_stats, sizes)]
    return [(f.y, f.u, f.v) for f in frames], stats


def picture_bytes(es: bytes) -> list[int]:
    """Coded bytes of each picture: from its picture start code to the
    next picture, sequence-end or sequence start code."""
    starts, ends = [], []
    i = es.find(b"\x00\x00\x01")
    while i >= 0 and i + 3 < len(es):
        code = es[i + 3]
        if code in (0x00, 0xB3, 0xB7, 0xB8) and len(starts) > len(ends):
            ends.append(i)
        if code == 0x00:
            starts.append(i)
        i = es.find(b"\x00\x00\x01", i + 3)
    if len(starts) > len(ends):
        ends.append(len(es))
    return [e - s for s, e in zip(starts, ends)]


def decode_all(streams: list[bytes], control: bool = False) -> list:
    """decode_stream over every stream; several processes when there is
    more than one stream and more than one core."""
    n = min(len(streams), os.cpu_count() or 1, 8)
    if n <= 1:
        return [decode_stream(es, control) for es in streams]
    ctx = multiprocessing.get_context("spawn")
    with cf.ProcessPoolExecutor(max_workers=n, mp_context=ctx) as pool:
        futs = [pool.submit(decode_stream, es, control) for es in streams]
        return [f.result() for f in futs]


def tick_pcm(audio: list) -> tuple[np.ndarray, np.ndarray]:
    """(steady, fresh) int16[K, F * 128 * channels]: the PCM of each
    picture's tick for a lane that plays the stream's audio in a loop
    (steady: the decoder's history from the tick before), and for a
    lane whose first tick it is (fresh: the decoder's history zero)."""
    K = len(audio)
    _first, dec = decode_frames([f for j in range(K) for f in audio[j]])
    steady = [decode_frames(audio[j], dec)[0] for j in range(K)]
    fresh = [decode_frames(audio[j])[0] for j in range(K)]
    return np.stack(steady), np.stack(fresh)
