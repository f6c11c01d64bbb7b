"""One tick of host gather: pictures and SBC frames from a lane range.

The in-process Fleet (runtime/scheduler.py) and every HostPool worker
(runtime/hostpool.py) gather through these functions, so both apply the
same containment policies and log the same events:

  * ``admit`` -- a picture of the wrong geometry parks its lane
    (Ev.LANE_GEOMETRY); an oversize one (more words than a lane holds,
    or more slices than MB rows) is dropped and its lane re-seeked
    (Ev.LANE_OVERSIZE, Ev.LANE_RESYNC).  ``fits`` is the size test that
    make_picture_batch and the packed batch both rely on;
  * ``gather_pictures`` -- advance every presentation clock, pop at most
    one picture per lane (native feeds fleet-wide in one ctypes call a
    pump round, ``batched_next_pictures``) and admit them in lane order;
    it adds the tick's session-feed counts (``feed.*``, named in
    runtime/telemetry.py) to a `tally` dict and opens the spans
    ``gather.pop`` and ``gather.read`` through a `measure` callable
    (Timers.measure-shaped), when the caller gives them;
  * ``gather_audio_arrays`` -- one tick of SBC frames as the chain's
    big-endian word array, grouped by channel count
    (Ev.AUDIO_OP_POINT, Ev.AUDIO_STARVED).

`log` is an EventLog.log-shaped callable, ``log(ev, lane, value=0)``,
with lanes numbered within `sessions`.  Torch-free: the workers import
this module and never torch.
"""

from __future__ import annotations

from contextlib import nullcontext

import numpy as np

from espflix_tpu_torch.audio.sbc import SbcDecoder
from espflix_tpu_torch.runtime.events import Ev
from espflix_tpu_torch.runtime.player import PlayerSession, State
from espflix_tpu_torch.streaming import native_feed as NF

PUMP_STATES = (State.PLAYING, State.FAST_FORWARD, State.REWIND)


def sbc_probe(data: bytes):
    """(frame size, channels, blocks) of the SBC frame at the head of
    `data`, or 0 when it holds none (the audio rings' discover probe)."""
    d = SbcDecoder()
    r = d.parse_frame(data)
    if not r:
        return 0
    return r[1], d.channels, d.blocks


def fits(payload_len, n_slices, words_per_lane: int, max_slices: int):
    """Whether a picture of payload_len bytes and n_slices slices fits a
    lane: its words plus the 16-byte EOS pad within words_per_lane, its
    slices within max_slices (make_picture_batch's asserts).  Works on
    ints and on numpy arrays alike."""
    return (((payload_len + 3) // 4 + 4 <= words_per_lane)
            & (n_slices <= max_slices))


def admit(log, i: int, s, width: int, height: int, payload_len: int,
          n_slices: int, *, geometry: tuple[int, int], words_per_lane: int,
          max_slices: int, pre_errors: np.ndarray) -> bool:
    """The geometry and oversize containment policies of one gathered
    picture on lane i; True when it may enter the batch.  A stream of
    the wrong geometry (pixels, != `geometry`) can never decode into
    these planes: the lane is flagged and parked.  An oversize picture
    is dropped, the lane flagged and re-seeked to its next
    random-access point (SURVEY.md 5.3)."""
    gw, gh = geometry
    if width != gw or height != gh:
        log(Ev.LANE_GEOMETRY, i, value=(width << 16) | height)
        pre_errors[i] = True
        s.park(f"geometry {width}x{height} != fleet {gw}x{gh}")
        s.park_geometry = (width, height)
        return False
    if not fits(payload_len, n_slices, words_per_lane, max_slices):
        log(Ev.LANE_OVERSIZE, i, value=payload_len)
        pre_errors[i] = True
        if s.resync():
            log(Ev.LANE_RESYNC, i)
        return False
    return True


def fast_lanes(sessions):
    """(fast, slow) lists of (lane, session): fast lanes are playing on
    a native feed with the stock next_picture -- any override (subclass
    or instance patch) keeps a lane on the per-lane path
    (scheduler.py:307-316)."""
    fast, slow = [], []
    for i, s in enumerate(sessions):
        if s is None:
            continue
        if (s.state in PUMP_STATES
                and isinstance(s.feed, NF.NativeStreamFeed)
                and "next_picture" not in s.__dict__
                and type(s).next_picture is PlayerSession.next_picture):
            fast.append((i, s))
        else:
            slow.append((i, s))
    return fast, slow


def no_span(_name):
    """A Timers.measure-shaped span function that times nothing."""
    return nullcontext()


def batched_next_pictures(sessions, tally: dict | None = None,
                          measure=None):
    """Native-feed lanes pop in ONE sf_pop_pictures call per pump round
    (scheduler.py:294-338), with PlayerSession.next_picture's per-lane
    order: pop, pump on a miss, pop again, DONE at EOS.  Returns {lane:
    PictureData|None} for every lane it handled, or None when no lane
    is on the fast path.  Counts its rounds in `tally` ("feed.rounds");
    `measure` spans each round's pop ("gather.pop") and pumps
    ("gather.read", which holds their feed calls too)."""
    pending = fast_lanes(sessions)[0]
    if not pending:
        return None
    span = measure or no_span
    got = {i: None for i, _ in pending}
    rounds = 0
    for _ in range(64):                  # next_picture max_pumps
        if not pending:
            break
        rounds += 1
        with span("gather.pop"):
            res = NF.pop_many([s.feed for _, s in pending])
        nxt = []
        with span("gather.read"):
            for (i, s), p in zip(pending, res):
                if p is not None:
                    got[i] = p
                elif s.pump():
                    nxt.append((i, s))
                else:
                    p = s.feed.pop_picture()
                    if p is None:
                        s.state = State.DONE
                        s.save_pos(False)
                    got[i] = p
        pending = nxt
    if tally is not None:
        add_counts(tally, {"feed.rounds": rounds})
    return got


def gather_pictures(sessions, log, *, geometry: tuple[int, int],
                    words_per_lane: int, max_slices: int,
                    tally: dict | None = None, measure=None):
    """One display tick of picture gather: advance every session's
    presentation clock, pull at most one complete picture per lane
    (native lanes through batched_next_pictures, the others through
    their next_picture), and admit them in lane order.  Returns
    (pictures, pts int64[N], pre_errors bool[N]).  With `tally`, adds
    the tick's feed.bytes_read (what the sessions' pumps read),
    feed.rounds (the batched pop's rounds; one when no lane is
    native), feed.lane_ticks and feed.underruns."""
    n = len(sessions)
    pics = [None] * n
    pts = np.full(n, -1, np.int64)
    # one tick = one display frame interval (video.cpp:1165)
    for s in sessions:
        if s is not None:
            s.clock.tick()
    if tally is not None:
        playing = sum(s is not None and s.state in PUMP_STATES
                      for s in sessions)
        read0 = read_total(sessions)
    pre_errors = np.zeros(n, bool)
    got = batched_next_pictures(sessions, tally, measure)
    for i, s in enumerate(sessions):
        if s is None:
            continue
        p = got[i] if got is not None and i in got else s.next_picture()
        if p is None:
            continue
        if not admit(log, i, s, p.seq.width, p.seq.height, len(p.payload),
                     len(p.slice_offsets), geometry=geometry,
                     words_per_lane=words_per_lane, max_slices=max_slices,
                     pre_errors=pre_errors):
            continue
        pics[i] = p
        pts[i] = p.pts
    if tally is not None:
        add_counts(tally, {
            "feed.bytes_read": read_total(sessions) - read0,
            "feed.rounds": 0 if got is not None else 1,
            "feed.lane_ticks": playing,
            "feed.underruns": playing - sum(p is not None for p in pics)})
    return pics, pts, pre_errors


def read_total(sessions) -> int:
    """Bytes the sessions' pumps have read (PlayerSession.bytes_read; a
    session that keeps no such count reads 0)."""
    return sum(getattr(s, "bytes_read", 0) for s in sessions
               if s is not None)


def add_counts(tally: dict, counts: dict):
    """Add `counts` to the `tally` dict, name by name."""
    for k, v in counts.items():
        tally[k] = tally.get(k, 0) + int(v)


def gather_audio_arrays(sessions, F: int, op, log):
    """One tick of SBC frames as fixed-shape chain inputs
    (scheduler.py:1078-1165).  Lanes group by channel count `op` (None
    until the first discovered 16-block lane sets it); frame sizes vary
    freely per lane and pad to the tick's largest, quantized to 32
    bytes.  A lane outside the group is silent in the chain and logs
    Ev.AUDIO_OP_POINT.  Native rings of one pool drain in ONE
    sf_audio_pop_batch call straight into the arena; they count their
    discovered frame size towards the width (a lane that pops nothing
    may widen it by one 32-byte step: zero padding past a
    self-describing frame is never read).

    Returns (words uint32[N, F, W], active bool[N], n_valid int32[N],
    starved bool[N], channels, op)."""
    n = len(sessions)
    starved = np.zeros(n, bool)
    act = np.zeros(n, bool)
    nval = np.zeros(n, np.int32)
    frames_list: list[tuple[int, np.ndarray]] = []
    fast_rings: list = []
    fast_slots: list[int] = []
    fast_pool = None
    fs_max = 16
    for i, s in enumerate(sessions):
        if s is None:
            continue
        ring = s.feed.audio
        if not (ring.discover(sbc_probe) and ring.frame_size):
            continue
        if op is None and ring.blocks == 16:
            op = ring.channels
        if op is None or ring.blocks != 16 or ring.channels != op:
            log(Ev.AUDIO_OP_POINT, i,
                value=(ring.channels << 8) | ring.blocks)
            continue
        if isinstance(ring, NF.NativeAudioRing) and \
                (fast_pool is None or ring._p is fast_pool):
            fast_pool = ring._p
            fast_rings.append(ring)
            fast_slots.append(i)
            fs_max = max(fs_max, ring.frame_size)
            continue
        fa = ring.pop_frames_array(F)
        if fa is None:
            if s.state in PUMP_STATES and not s.eos:
                starved[i] = True
                log(Ev.AUDIO_STARVED, i)
            continue
        act[i] = True
        nval[i] = len(fa)
        fs_max = max(fs_max, fa.shape[1])
        frames_list.append((i, fa))
    ch = op if op else 1
    fs_q = -(-fs_max // 32) * 32
    # word-padded rows (+4 trailing zero bytes) so the words are a dtype
    # view + in-place byteswap
    arr = np.zeros((n, F, fs_q + 4), np.uint8)
    if fast_rings:
        counts = NF.pop_audio_many(fast_rings, fast_slots, F, arr)
        slots = np.asarray(fast_slots)
        got = counts > 0
        act[slots[got]] = True
        nval[slots[got]] = counts[got]
        for k in np.flatnonzero(~got):
            i = fast_slots[k]
            s = sessions[i]
            if s.state in PUMP_STATES and not s.eos:
                starved[i] = True
                log(Ev.AUDIO_STARVED, i)
    for i, fa in frames_list:
        arr[i, :len(fa), :fa.shape[1]] = fa
    words = arr.view(np.uint32)
    words.byteswap(inplace=True)
    return words, act, nval, starved, ch, op
