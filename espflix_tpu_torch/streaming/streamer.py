"""Byte-source streamer: HTTP-range / file / memory, reference API.

Copied from espflix_tpu/streaming/streamer.py; tests/test_torch_isolation.py
pins the copy to the original.

Same surface and semantics as the reference Streamer
(src/streamer.cpp:408-562): ``get(url, offset, len)``
issues an HTTP/1.1 GET over a raw TCP socket with a ``Range:
bytes=o-[e]`` header when offset/len given, parses status +
Content-Length, then exposes sequential ``read``; ``file://`` paths and
in-memory buffers (``get_rom``) are interchangeable sources (the test
fixture pathway, SURVEY.md 4.2).  ``get_url`` is the whole-body
convenience fetch used for manifests and index reads.

A pooled async variant for thousands of concurrent streams lives in
streaming/fetch_pool.py.
"""

from __future__ import annotations

import os
import socket
import time
from urllib.parse import urlparse


class Streamer:
    def __init__(self, retries: int = 3, backoff: float = 0.1):
        self._sock: socket.socket | None = None
        self._file = None
        self._rom: bytes | None = None
        self._content_length = -1
        self._mark = 0
        self._offset = 0
        self._retries = retries
        self._backoff = backoff

    # -- open -----------------------------------------------------------
    def get(self, url: str, offset: int = 0, length: int = 0) -> int:
        """Open with retry + exponential backoff on transient failures
        (SURVEY.md 5.3: the reference returns -1 up the stack and the
        app re-enters its connect loop; a TPU host fronting thousands
        of lanes retries here instead so one blip doesn't error a
        lane)."""
        delay = self._backoff
        for attempt in range(self._retries + 1):
            rc = self._get_once(url, offset, length)
            if rc == 0 or attempt == self._retries:
                return rc
            time.sleep(delay)
            delay *= 2
        return rc

    def _get_once(self, url: str, offset: int = 0,
                  length: int = 0) -> int:
        self._content_length = -1
        self._mark = 0
        self._offset = offset
        self.close()

        if url.startswith("file"):
            path = url[7:] if url.startswith("file://") else url[5:]
            try:
                f = open(path, "rb")
            except OSError:
                return -1
            f.seek(0, os.SEEK_END)
            self._content_length = f.tell() - offset
            if length:
                self._content_length = min(length, self._content_length)
            f.seek(offset)
            self._file = f
            return 0

        u = urlparse(url)
        if u.scheme != "http":
            return -1
        port = u.port or 80
        try:
            s = socket.create_connection((u.hostname, port), timeout=30)
        except OSError:
            return -1
        path = u.path or "/"
        if u.query:
            path += "?" + u.query
        req = f"GET {path} HTTP/1.1\r\nHost: {u.hostname}:{port}\r\n"
        if offset != 0 or length != 0:
            req += f"Range: bytes={offset}-"
            if length:
                req += str(offset + length - 1)
            req += "\r\n"
        req += "User-Agent: espflix-tpu\r\nConnection: close\r\n\r\n"
        try:
            s.sendall(req.encode())
            # read headers byte-wise (matches the reference's parser)
            line = b""
            status = 0
            h = 0
            while True:
                c = s.recv(1)
                if not c:
                    s.close()
                    return -1
                if c == b"\n":
                    text = line.rstrip(b"\r").decode("latin1")
                    if h == 0:
                        try:
                            status = int(text.split()[1])
                        except (IndexError, ValueError):
                            s.close()
                            return -1
                    elif text.lower().startswith("content-length:"):
                        self._content_length = int(text[15:].strip())
                    if text == "":
                        break
                    h += 1
                    line = b""
                else:
                    line += c
        except OSError:
            s.close()
            return -1
        if status not in (200, 206):
            s.close()
            return -1
        self._sock = s
        if status == 200 and offset:
            # server ignored the Range header: discard the prefix so
            # read() semantics stay offset-based
            to_skip = offset
            while to_skip > 0:
                chunk = s.recv(min(to_skip, 65536))
                if not chunk:
                    break
                to_skip -= len(chunk)
            if self._content_length >= 0:
                self._content_length -= offset
                if length:
                    self._content_length = min(self._content_length,
                                               length)
        return 0

    def get_url(self, url: str, offset: int = 0,
                length: int = 0) -> bytes | None:
        if self.get(url, offset, length) != 0 or self._content_length < 0:
            self.close()
            return None
        out = self.read(self._content_length)
        self.close()
        return out

    def get_rom(self, data: bytes):
        self.close()
        self._rom = data
        self._content_length = len(data)
        self._mark = self._offset = 0

    # -- read -----------------------------------------------------------
    def read(self, n: int, with_offset: bool = False):
        pos = self._offset + self._mark
        n = min(n, max(self._content_length - self._mark, 0))
        if self._rom is not None:
            out = self._rom[self._mark:self._mark + n]
            self._mark += len(out)
        elif self._file is not None:
            out = self._file.read(n)
            self._mark += len(out)
        elif self._sock is not None:
            parts = []
            got = 0
            while got < n:
                try:
                    chunk = self._sock.recv(n - got)
                except OSError:
                    break
                if not chunk:
                    break
                parts.append(chunk)
                got += len(chunk)
            out = b"".join(parts)
            self._mark += len(out)
        else:
            out = b""
        return (out, pos) if with_offset else out

    def close(self):
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
        if self._file is not None:
            self._file.close()
        self._sock = None
        self._file = None
        self._rom = None
        self._mark = 0
