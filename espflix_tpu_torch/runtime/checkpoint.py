"""Per-title resume positions: the NVS store analogue.

Copied from espflix_tpu/runtime/checkpoint.py; tests/test_torch_isolation.py
pins the copy to the original.

The reference persists the last main-stream PTS per title to ESP32 NVS
flash, with keys truncated to their last 15 characters
(espflix.ino:149-178).  Here: a JSON file (or any
mapping), same key-truncation quirk preserved for compatibility of
behavior, plus whole-fleet checkpoint/restore for the batched runtime
(per-stream {title, pts, speed} tuples -- SURVEY.md 5.4).
"""

from __future__ import annotations

import json
import os
import tempfile


def limit_key(key: str) -> str:
    return key if len(key) < 15 else key[len(key) - 15:]


class PositionStore:
    def __init__(self, path: str | None = None):
        self.path = path
        self._data: dict[str, int] = {}
        if path and os.path.exists(path):
            try:
                with open(path) as f:
                    self._data = {k: int(v)
                                  for k, v in json.load(f).items()}
            except (OSError, ValueError):
                self._data = {}

    def read(self, title: str) -> int:
        return self._data.get(limit_key(title), 0)

    def write(self, title: str, pts: int):
        self._data[limit_key(title)] = int(pts)
        self._flush()

    def snapshot(self) -> dict:
        return dict(self._data)

    def _flush(self):
        if not self.path:
            return
        d = os.path.dirname(self.path) or "."
        fd, tmp = tempfile.mkstemp(dir=d)
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(self._data, f)
            os.replace(tmp, self.path)
        except OSError:
            try:
                os.unlink(tmp)
            except OSError:
                pass
