"""Pooled async byte fetching for thousands of concurrent streams.

The reference blocks a core on lwIP recv per stream (SURVEY.md 5.8);
a fleet feeding thousands of lanes needs the host network path off the
scheduler thread.  FetchPool runs bounded-prefetch readers on a thread
pool: each stream has a small queue of fixed-size chunks (the scaled
analogue of the reference's 4x1504 B pool) that the fleet drains
without blocking; backpressure is the queue bound.

Copied from espflix_tpu/streaming/fetch_pool.py; tests/test_torch_isolation.py
pins the copy to the original.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field

from espflix_tpu_torch.streaming.streamer import Streamer

CHUNK = 8 * 188 * 4


@dataclass
class _Stream:
    streamer: Streamer
    q: "queue.Queue[bytes]" = field(
        default_factory=lambda: queue.Queue(maxsize=4))
    eos: bool = False
    stop: bool = False


class FetchPool:
    def __init__(self, workers: int = 16):
        self.pool = ThreadPoolExecutor(max_workers=workers)
        self.streams: dict[int, _Stream] = {}
        self._lock = threading.Lock()

    def open(self, key: int, url: str, offset: int = 0) -> bool:
        self.close(key)
        st = Streamer()
        if st.get(url, offset) != 0:
            return False
        s = _Stream(st)
        with self._lock:
            self.streams[key] = s
        self.pool.submit(self._reader, s)
        return True

    def _reader(self, s: _Stream):
        while not s.stop:
            data = s.streamer.read(CHUNK)
            if not data:
                s.eos = True
                try:
                    s.q.put(b"", timeout=5)
                except queue.Full:
                    pass
                return
            while not s.stop:
                try:
                    s.q.put(data, timeout=0.5)
                    break
                except queue.Full:
                    continue

    def poll(self, key: int) -> bytes | None:
        """Non-blocking: next chunk, b'' at EOS, None if not ready."""
        s = self.streams.get(key)
        if s is None:
            return None
        try:
            return s.q.get_nowait()
        except queue.Empty:
            return b"" if s.eos and s.q.empty() else None

    def close(self, key: int):
        with self._lock:
            s = self.streams.pop(key, None)
        if s is not None:
            s.stop = True
            s.streamer.close()

    def shutdown(self):
        for k in list(self.streams):
            self.close(k)
        self.pool.shutdown(wait=False)
