"""Link/connection manager: the WiFi-manager equivalent.

Copied from espflix_tpu/streaming/netmgr.py; tests/test_torch_isolation.py
pins the copy to the original.

The reference's WiFi manager (espflix.ino:180-293) is an event-driven
state machine: auto-connect with stored credentials on boot, scan on
disconnect, keep a top-16 list of (ssid -> rssi<<8|authmode), join with
manual credentials; its state enum (streamer.h:49-55) drives the GUI.

A TPU host has real networking, so "links" here are pluggable content
endpoints (service roots, mirrors, proxies) probed for reachability and
quality instead of radio APs -- but the state machine, the packed
quality list, the stored-credential auto-connect and the
rescan-on-disconnect behavior keep the reference's surface so the same
GUI reducer drives either.
"""

from __future__ import annotations

import threading
from enum import IntEnum


class LinkState(IntEnum):           # streamer.h:49-55
    NONE = 0
    SCANNING = 1
    SCAN_COMPLETE = 2
    CONNECTING = 3
    CONNECTED = 4


AUTH_OPEN = 0                        # no secret required to join


class NetworkManager:
    """scan_fn() -> list[(name, quality_db, auth_mode)];
    join_fn(name, secret) -> bool.

    Synchronous core with an optional worker thread (`tick` runs one
    pending transition; `start` spawns a thread that ticks)."""

    MAX_LINKS = 16                   # top-16 list (espflix.ino scan cb)

    def __init__(self, scan_fn, join_fn, creds=None):
        self._scan_fn = scan_fn
        self._join_fn = join_fn
        self._creds = creds          # optional PositionStore-like map
        self._lock = threading.Lock()
        self._state = LinkState.NONE
        self._links: dict[str, int] = {}
        self._current = ""
        self._pending = None         # (name, secret) to join on tick
        self._want_scan = False

    # -- state surface (wifi_state / wifi_list / wifi_ssid) -------------
    def state(self) -> LinkState:
        with self._lock:
            return self._state

    def links(self) -> dict[str, int]:
        """name -> quality<<8 | auth_mode, best-first, max 16."""
        with self._lock:
            return dict(self._links)

    def current(self) -> str:
        with self._lock:
            return self._current

    # -- requests --------------------------------------------------------
    def scan(self):
        with self._lock:
            self._want_scan = True
            self._state = LinkState.SCANNING

    def join(self, name: str, secret: str = ""):
        with self._lock:
            self._pending = (name, secret)
            self._current = name
            self._state = LinkState.CONNECTING

    def auto_connect(self):
        """Boot path: stored credentials -> join, else scan
        (espflix.ino:258-263)."""
        name = secret = ""
        if self._creds is not None:
            name = self._creds.read("link") or ""
            secret = self._creds.read("secret") or ""
        if name:
            self.join(name, secret)
        else:
            self.scan()

    def disconnect(self):
        """Drop the link and rescan (the reference's disconnect handler
        re-enters scanning, espflix.ino:247-250)."""
        with self._lock:
            self._current = ""
        self.scan()

    # -- engine ------------------------------------------------------------
    def tick(self):
        """Run at most one pending transition."""
        with self._lock:
            want_scan = self._want_scan
            pending = self._pending
            self._want_scan = False
            self._pending = None
        if pending is not None:
            name, secret = pending
            ok = False
            try:
                ok = bool(self._join_fn(name, secret))
            except Exception:
                ok = False
            with self._lock:
                if ok:
                    self._state = LinkState.CONNECTED
                    if self._creds is not None:
                        self._creds.write("link", name)
                        self._creds.write("secret", secret)
                else:
                    self._current = ""
            if not ok:
                self.scan()
                self.tick()
            return
        if want_scan:
            try:
                found = list(self._scan_fn())
            except Exception:
                found = []
            found.sort(key=lambda t: -t[1])
            with self._lock:
                self._links = {
                    name: ((q & 0xFF) << 8) | (mode & 0xFF)
                    for name, q, mode in found[:self.MAX_LINKS]}
                self._state = LinkState.SCAN_COMPLETE

    def start(self, interval: float = 0.1):
        """Optional background pump."""
        def run():
            import time
            while not self._stop.is_set():
                self.tick()
                time.sleep(interval)
        self._stop = threading.Event()
        t = threading.Thread(target=run, daemon=True)
        t.start()
        return t
