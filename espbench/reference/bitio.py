"""Bit-level I/O: a host-side writer/reader pair for MPEG-1 bitstreams.

A frozen copy of espflix_tpu_torch/core/bitio.py, kept with
the benchmark so that the yardstick does not move when the program
changes.

The writer builds test/encode streams; the scalar reader mirrors the
reference decoder's bit consumption exactly (MSB-first, 32-bit fill
semantics of src/player.cpp:348-352,495-530 are
equivalent to a plain MSB-first cursor for in-memory buffers).

The *device* bit reader (SoA, batched) lives in espflix_tpu.ops.vlc_scan;
this module is the host/oracle-side counterpart.
"""

from __future__ import annotations

import numpy as np


class BitWriter:
    def __init__(self):
        self._bits: list[int] = []

    def put(self, value: int, nbits: int):
        assert nbits >= 0 and 0 <= value < (1 << nbits), (value, nbits)
        for i in range(nbits - 1, -1, -1):
            self._bits.append((value >> i) & 1)
        return self

    def put_str(self, bits: str):
        for c in bits:
            self._bits.append(1 if c == "1" else 0)
        return self

    def align(self, fill: int = 0):
        while len(self._bits) % 8:
            self._bits.append(fill)
        return self

    def start_code(self, code: int):
        """Byte-aligned 00 00 01 <code>."""
        self.align()
        self.put(0x000001, 24)
        self.put(code, 8)
        return self

    @property
    def nbits(self) -> int:
        return len(self._bits)

    def tobytes(self) -> bytes:
        bits = self._bits[:]
        while len(bits) % 8:
            bits.append(0)
        out = bytearray(len(bits) // 8)
        for i, b in enumerate(bits):
            if b:
                out[i >> 3] |= 0x80 >> (i & 7)
        return bytes(out)


class BitReader:
    """MSB-first cursor over a byte buffer, mirroring the reference's
    bit consumption.  Reads past the end return the EOS padding pattern
    (sequence_end start codes), matching player.cpp:456,469-473."""

    EOS = bytes([0x00, 0x00, 0x01, 0xB7]) * 2

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0  # bit position
        self._eos_base: int | None = None

    def _byte(self, i: int) -> int:
        if i < len(self.data):
            return self.data[i]
        return self.EOS[(i - len(self.data)) % len(self.EOS)]

    def peek(self, n: int) -> int:
        first = self.pos >> 3
        last = (self.pos + n - 1) >> 3
        v = 0
        for i in range(first, last + 1):
            v = (v << 8) | self._byte(i)
        drop = 7 - ((self.pos + n - 1) & 7)
        return (v >> drop) & ((1 << n) - 1)

    def get(self, n: int) -> int:
        v = self.peek(n)
        self.pos += n
        return v

    def skip(self, n: int):
        self.pos += n

    def at_end(self) -> bool:
        return self.pos >= 8 * len(self.data)

    def byte_align(self):
        self.pos = (self.pos + 7) & ~7


def bytes_to_words_be(data: bytes, pad_words: int = 2) -> np.ndarray:
    """Pack bytes into big-endian uint32 words (device bitstream layout),
    padded with EOS sequence-end codes so overreads stay well-defined."""
    pad = (-len(data)) % 4
    data = data + BitReader.EOS[:pad] if pad else data
    data = data + BitReader.EOS * pad_words
    arr = np.frombuffer(data, dtype=np.uint8).reshape(-1, 4)
    return (
        (arr[:, 0].astype(np.uint32) << 24)
        | (arr[:, 1].astype(np.uint32) << 16)
        | (arr[:, 2].astype(np.uint32) << 8)
        | arr[:, 3].astype(np.uint32)
    )
