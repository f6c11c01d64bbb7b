"""Thread-safe minimal printf (the printf_nano equivalent).

Copied from espflix_tpu/utils/nanolog.py; tests/test_torch_isolation.py
pins the copy to the original.

The reference routes ALL logging through a mutex-guarded minimal
printf supporting %s %d %x %c with width/zero-pad (streamer.cpp:38-115,
globally substituted via streamer.h:184-185) because newlib's printf
is not task-safe.  Python's print is GIL-atomic-ish but interleaves
across threads at flush granularity; this keeps the same tiny format
language (so log call sites port 1:1), one lock, and an optional
in-memory ring for tests/postmortems.
"""

from __future__ import annotations

import sys
import threading
from collections import deque

_lock = threading.Lock()
_ring: deque[str] = deque(maxlen=1024)
_sink = None        # None = stdout


def _format(fmt: str, args) -> str:
    out = []
    ai = 0
    i = 0
    n = len(fmt)
    while i < n:
        c = fmt[i]
        if c != "%":
            out.append(c)
            i += 1
            continue
        i += 1
        if i < n and fmt[i] == "%":
            out.append("%")
            i += 1
            continue
        zero = False
        width = 0
        if i < n and fmt[i] == "0":
            zero = True
            i += 1
        while i < n and fmt[i].isdigit():
            width = width * 10 + int(fmt[i])
            i += 1
        if i >= n:
            out.append("%")
            break
        conv = fmt[i]
        i += 1
        arg = args[ai] if ai < len(args) else ""
        ai += 1
        if conv == "d":
            s = str(int(arg))
        elif conv in ("x", "X"):
            s = format(int(arg) & 0xFFFFFFFFFFFFFFFF, conv)
        elif conv == "c":
            s = chr(arg) if isinstance(arg, int) else str(arg)[:1]
        elif conv == "s":
            s = str(arg)
        else:               # unknown conversion: emit literally
            out.append("%" + conv)
            continue
        if width > len(s):
            s = ("0" if zero and conv != "s" else " ") * \
                (width - len(s)) + s
        out.append(s)
    return "".join(out)


def nprintf(fmt: str, *args) -> str:
    """Format and emit atomically; returns the formatted string."""
    s = _format(fmt, args)
    with _lock:
        _ring.append(s)
        (_sink or sys.stdout).write(s)
    return s


def set_sink(sink):
    """Redirect output (None = stdout); returns the old sink."""
    global _sink
    with _lock:
        old, _sink = _sink, sink
    return old


def tail(n: int = 64) -> list[str]:
    with _lock:
        return list(_ring)[-n:]
