"""Extract known-good MPEG-TS fixtures from the reference's C headers.

Copied from espflix_tpu/tools/refdata.py; tests/test_torch_isolation.py
pins the copy to the original.

The reference embeds two real, independently-encoded transport streams
as const uint8_t arrays: the boot splash movie
(src/splash.h:12, 247,408 bytes, played at boot via
play_rom, espflix.cpp:699) and a test/media stream
(src/vmedia.h:1, 524,332 bytes).  They are the only
in-tree bitstreams NOT produced by this repo's own encoder, so decoding
them bit-exactly against the C++ oracle guards against a shared
encoder/decoder misreading of ISO 11172 (VERDICT r1 missing #3).

This module parses the hex byte lists out of the headers at run time
(the arrays are test fixtures read from the read-only reference
checkout, not copied into this repo) and caches the binary in
build/refdata of this checkout.  ESPFLIX_REF_SRC names the reference's
src/ directory; without it no fixture is available.
"""

from __future__ import annotations

import os
import re

REF_SRC = os.environ.get("ESPFLIX_REF_SRC", "")
_CACHE = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "build", "refdata")

FIXTURES = {
    "splash": ("splash.h", "splash_ts"),
    "vmedia": ("vmedia.h", "vmedia"),
}


def available() -> bool:
    return bool(REF_SRC) and all(os.path.exists(os.path.join(REF_SRC, f))
               for f, _ in FIXTURES.values())


def load(name: str) -> bytes:
    """Return the named fixture ('splash' or 'vmedia') as bytes."""
    fname, sym = FIXTURES[name]
    cache = os.path.join(_CACHE, name + ".ts")
    if os.path.exists(cache):
        with open(cache, "rb") as f:
            return f.read()
    path = os.path.join(REF_SRC, fname)
    with open(path, "r") as f:
        text = f.read()
    # take everything between the array's opening brace and the final
    # closing brace, then every 0xNN token in order
    start = text.index(sym)
    start = text.index("{", start)
    end = text.rindex("}")
    data = bytes(int(t, 16)
                 for t in re.findall(r"0x([0-9A-Fa-f]{2})",
                                     text[start:end]))
    os.makedirs(_CACHE, exist_ok=True)
    with open(cache, "wb") as f:
        f.write(data)
    return data
