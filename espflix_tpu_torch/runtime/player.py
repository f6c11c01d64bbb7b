"""Per-stream playback session: state machine, seek and trick play.

Copied from espflix_tpu.runtime.player (player.py:26-296), which
imports the JAX package's runtime.session; here the feed is the port's
runtime/session.StreamFeed.  tests/test_torch_serve.py pins the copy
to the original.

The per-lane re-design of the reference application layer
(the reference src/espflix.cpp:551-1010): the same states
(NAV/PLAYING/PAUSED/FAST_FORWARD/REWIND/...), the same stream selection
(video.ts / video_fwd.ts / video_rwd.ts), the same O(1) index seeks and
saved-position resume -- but synchronous and batched: a session exposes
``next_picture()`` to the fleet scheduler (runtime/scheduler.py), which
decodes thousands of sessions per jitted device call.
"""

from __future__ import annotations

from dataclasses import dataclass
from enum import Enum

from espflix_tpu_torch.runtime.checkpoint import PositionStore
from espflix_tpu_torch.streaming import index as idx
from espflix_tpu_torch.streaming.streamer import Streamer
from espflix_tpu_torch.runtime.session import make_stream_feed

VID_NAMES = {-1: "/video_rwd.ts", 0: "/video.ts", 1: "/video_fwd.ts"}
READ_CHUNK = 8 * 188 * 4


class State(Enum):
    NONE = 0
    NAV = 1
    PLAYING = 2
    PAUSED = 3
    STOPPED = 4
    FAST_FORWARD = 5
    REWIND = 6
    DONE = 7


@dataclass
class TitleInfo:
    pos: int = 0
    idx_hdr: idx.IdxHdr | None = None


class PlayerSession:
    """One stream's control plane.  All I/O is pull-based and bounded."""

    def __init__(self, service_root: str, store: PositionStore | None = None,
                 streamer: Streamer | None = None, pal: bool = False):
        from espflix_tpu_torch.video.clock import PresentationClock
        self.root = service_root.rstrip("/")
        self.store = store or PositionStore()
        self.streamer = streamer or Streamer()
        self.state = State.NONE
        self.speed = 0
        self.nav_index = -1
        self.manifest: list[str] = []
        self.info: dict[int, TitleInfo] = {}
        self.feed = make_stream_feed()
        self.eos = False
        self.bytes_read = 0         # bytes pump() read, running total
        self.last_pts = -1          # last presented PTS (current stream)
        self.clock = PresentationClock(pal=pal)
        self.last_due = 0           # counter value the frame was due at

    # -- service bootstrap (espflix.cpp:676-695) ------------------------
    @classmethod
    def from_boot_url(cls, boot_url: str, **kw) -> "PlayerSession | None":
        """Service indirection: the boot URL's body is the service root
        (the reference fetches service.txt first, espflix.cpp:528)."""
        st = Streamer()
        body = st.get_url(boot_url)
        if not body:
            return None
        root = body.decode().splitlines()[0].strip()
        s = cls(root, **kw)
        return s if s.init_service() else None

    def init_service(self) -> bool:
        data = self.streamer.get_url(self.root + "/manifest.txt")
        if not data:
            return False
        self.manifest = [x for x in data.decode().splitlines() if x]
        self.state = State.NAV
        return bool(self.manifest)

    # -- modal sources (espflix.cpp:1043-1069) --------------------------
    def play_rom(self, data: bytes):
        """Play an in-memory TS (the splash-movie pathway)."""
        self.streamer.get_rom(data)
        self.feed = make_stream_feed()
        self.eos = False
        self.last_pts = -1
        self.speed = 0
        self.state = State.PLAYING

    def load_poster(self, i: int, direction: int = 0):
        """Stream a 1-picture poster TS for the nav screen.

        direction mirrors load_poster(i, dir) -> flush_picture mode
        (espflix.cpp:1060-1069): 0 = plain flip, <0 = slide in from
        the left (mode 2), >0 = slide in from the right (mode 3).  The
        mode is recorded in .poster_slide for the output stage to pick
        up (OutputStage.start_slide).
        """
        rc = self.streamer.get(self.folder(i) + "/poster.ts", 0)
        if rc != 0:
            return False
        self.feed = make_stream_feed()
        self.eos = False
        self.speed = 0
        self.state = State.PLAYING
        self.poster_slide = 0 if direction == 0 else \
            (2 if direction < 0 else 3)
        return True

    # -- checkpoint (SURVEY.md 5.4: {title, pts, speed} tuples) ---------
    def snapshot(self) -> dict:
        ti = self.info.get(self.nav_index)
        return dict(title=self.manifest[self.nav_index]
                    if 0 <= self.nav_index < len(self.manifest) else None,
                    nav=self.nav_index, pos=ti.pos if ti else 0,
                    speed=self.speed, state=self.state.name)

    def restore(self, snap: dict) -> bool:
        if snap.get("title") is None:
            return False
        try:
            i = self.manifest.index(snap["title"])
        except ValueError:
            return False
        self.nav(i)
        self.info[i].pos = int(snap.get("pos", 0))
        speed = int(snap.get("speed", 0))
        if snap.get("state") in ("PLAYING", "FAST_FORWARD", "REWIND"):
            self.play(i, speed, self.get_index(speed, self.info[i].pos)
                      * 188)
        return True

    def resync(self) -> bool:
        """Error recovery: re-seek to the nearest random-access point
        after the current position (per-stream error containment,
        SURVEY.md 5.3)."""
        if self.nav_index < 0 or self.info[self.nav_index].idx_hdr is None:
            return False
        ti = self.info[self.nav_index]
        ti.pos = min(ti.pos + ti.idx_hdr.video.bin_size,
                     ti.idx_hdr.video.last_pts)
        self.play(self.nav_index, self.speed,
                  self.get_index(self.speed, ti.pos) * 188)
        return self.state in (State.PLAYING, State.FAST_FORWARD,
                              State.REWIND)

    def folder(self, i: int) -> str:
        return f"{self.root}/media/{self.manifest[i]}"

    def nav(self, i: int):
        if not (0 <= i < len(self.manifest)):
            return
        self.nav_index = i
        ti = self.info.setdefault(i, TitleInfo())
        if ti.idx_hdr is None:
            ti.idx_hdr = idx.fetch_header(
                Streamer(), self.folder(i) + "/video.idx")
        ti.pos = self.store.read(self.manifest[i])
        self.state = State.NAV

    # -- seek math ------------------------------------------------------
    def get_index(self, speed: int, pts: int) -> int:
        ti = self.info[self.nav_index]
        return idx.get_index(Streamer(), self.folder(self.nav_index)
                             + "/video.idx", ti.idx_hdr, speed, pts)

    # -- transport ------------------------------------------------------
    def play(self, i: int, speed: int = 0, offset: int = 0):
        name = VID_NAMES[speed]
        self.speed = speed
        rc = self.streamer.get(self.folder(i) + name, offset)
        if rc != 0:
            self.state = State.STOPPED
            return
        self.feed = make_stream_feed()
        self.eos = False
        self.last_pts = -1
        self.clock.reset()          # new stream: re-latch the origin
        self.state = State.PLAYING if speed == 0 else (
            State.FAST_FORWARD if speed > 0 else State.REWIND)

    def save_pos(self, write_store: bool):
        """Map current stream PTS back to main-stream time
        (espflix.cpp:851-859)."""
        if self.nav_index < 0 or self.last_pts < 0:
            return
        ti = self.info[self.nav_index]
        pts = ti.idx_hdr.pts2pts(self.last_pts, self.speed) \
            if ti.idx_hdr else self.last_pts
        ti.pos = pts
        if write_store:
            self.store.write(self.manifest[self.nav_index], pts)

    # -- controls (espflix.cpp:787-848) --------------------------------
    def play_pause(self):
        if self.state in (State.PLAYING, State.FAST_FORWARD, State.REWIND):
            if self.speed:
                self.save_pos(False)
                self.play(self.nav_index, 0,
                          self.get_index(0, self.info[self.nav_index].pos)
                          * 188)
            else:
                self.save_pos(False)
                self.clock.pause(True)
                self.state = State.PAUSED
        elif self.state == State.PAUSED:
            self.clock.pause(False)
            self.state = State.PLAYING
        elif self.state == State.NAV:
            ti = self.info[self.nav_index]
            self.play(self.nav_index, 0, self.get_index(0, ti.pos) * 188)

    def fast_forward(self):
        self.save_pos(False)
        ti = self.info[self.nav_index]
        self.play(self.nav_index, 1, self.get_index(1, ti.pos) * 188)

    def rewind(self):
        self.save_pos(False)
        ti = self.info[self.nav_index]
        self.play(self.nav_index, -1, self.get_index(-1, ti.pos) * 188)

    def skip(self, seconds: int):
        self.save_pos(False)
        ti = self.info[self.nav_index]
        ti.pos += seconds * 90000
        ti.pos = max(0, ti.pos)
        self.play(self.nav_index, 0, self.get_index(0, ti.pos) * 188)

    def park(self, reason: str = ""):
        """Stop the lane on unrecoverable content (e.g. stream geometry
        that can never fit its fleet).  State is kept for inspection;
        nav()/play() revives the session."""
        self.streamer.close()
        self.park_reason = reason
        self.state = State.STOPPED

    def menu(self):
        if self.state in (State.PLAYING, State.PAUSED, State.FAST_FORWARD,
                          State.REWIND):
            self.save_pos(True)
            self.streamer.close()
        self.state = State.NAV

    # -- data pump ------------------------------------------------------
    def pump(self) -> bool:
        """Read one bounded chunk into the feed; False at EOS."""
        if self.eos:
            return False
        data = self.streamer.read(READ_CHUNK)
        if not data:
            self.feed.eos()
            self.eos = True
            return False
        self.bytes_read += len(data)
        self.feed.feed(data)
        return True

    def next_picture(self, max_pumps: int = 64):
        """Next complete picture, pumping the network as needed."""
        if self.state not in (State.PLAYING, State.FAST_FORWARD,
                              State.REWIND):
            return None
        for _ in range(max_pumps):
            p = self.feed.pop_picture()
            if p is not None:
                return p
            if not self.pump():
                p = self.feed.pop_picture()
                if p is None:
                    self.state = State.DONE
                    self.save_pos(False)
                return p
        return None

    def on_presented(self, pts: int):
        if pts >= 0:
            # A/V master-clock mapping (video.cpp:1024-1057): in batch
            # serving nothing blocks, but the due counter + late-reset
            # bookkeeping drive pacing/telemetry at the service edge.
            self.last_due = self.clock.due_time(pts)
            self.last_pts = pts
            self.save_pos(False)

    # -- progress (espflix.cpp:862-874) ---------------------------------
    def progress(self) -> tuple[int, int]:
        """(seconds, permille) of main-stream position."""
        ti = self.info.get(self.nav_index)
        if not ti or not ti.idx_hdr:
            return 0, 0
        pts = ti.pos
        total = max(ti.idx_hdr.video.last_pts, 1)
        return int(pts // 90000), int(pts * 1000 // total)
