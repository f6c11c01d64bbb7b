"""Scalar SBC decoder (numpy) -- the Python golden model for audio.

A frozen copy of espflix_tpu_torch/audio/sbc.py, kept with
the benchmark so that the yardstick does not move when the program
changes.

From-scratch implementation of the Bluetooth A2DP SBC subset used by the
reference (src/sbc_decoder.cpp): 8 subbands, mono or
dual-channel (no joint stereo, no 4-subband mode, CRC ignored), loudness
or SNR bit allocation, with the reference's exact fixed-point synthesis
(Q16 tables, >>15 stages, +-0x7FFF clip) including its int32 wraparound
behavior on extreme inputs.

PCM layout matches the reference: for 2 channels, each block's 8 left
samples are followed by ... actually per-channel runs are sequential
("left block follows right block", sbc_decoder.h:28).

The batched device implementation lives in espflix_tpu/models/sbc.py; it
must match this model bit-for-bit (enforced by tests/test_sbc.py).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from espbench.reference import sbc_tables as T

I32 = np.int32


def bit_allocation(scale_factor, bitpool, channels, frequency,
                   allocation, subbands=8):
    """A2DP 12.6.3 bit allocation (loudness/SNR), per channel.

    scale_factor: int array [channels][subbands]; returns bits same shape.
    Mirrors sbc_decoder.cpp:142-233 exactly.
    """
    bits = np.zeros((channels, subbands), np.int64)
    for ch in range(channels):
        bitneed = np.zeros(subbands, np.int64)
        if allocation:  # SNR
            bitneed[:] = scale_factor[ch]
        else:           # loudness
            off = (T.OFFSET_8 if subbands == 8 else T.OFFSET_4)[frequency]
            for sb in range(subbands):
                s = int(scale_factor[ch][sb])
                if s == 0:
                    bitneed[sb] = -5
                else:
                    loud = s - int(off[sb])
                    if loud > 0:
                        loud //= 2
                    bitneed[sb] = loud
        max_bitneed = int(bitneed.max())

        bitcount = 0
        slicecount = 0
        bitslice = max_bitneed + 1
        while True:
            bitslice -= 1
            bitcount += slicecount
            slicecount = 0
            for sb in range(subbands):
                if bitslice + 1 < bitneed[sb] < bitslice + 16:
                    slicecount += 1
                elif bitneed[sb] == bitslice + 1:
                    slicecount += 2
            if bitcount + slicecount >= bitpool:
                break
        if bitcount + slicecount == bitpool:
            bitcount += slicecount
            bitslice -= 1

        for sb in range(subbands):
            if bitneed[sb] < bitslice + 2:
                bits[ch][sb] = 0
            else:
                bits[ch][sb] = min(int(bitneed[sb]) - bitslice, 16)

        for sb in range(subbands):
            if bitcount >= bitpool:
                break
            if 2 <= bits[ch][sb] < 16:
                bits[ch][sb] += 1
                bitcount += 1
            elif bitneed[sb] == bitslice + 1 and bitpool > bitcount + 1:
                bits[ch][sb] = 2
                bitcount += 2

        for sb in range(subbands):
            if bitcount >= bitpool:
                break
            if bits[ch][sb] < 16:
                bits[ch][sb] += 1
                bitcount += 1
    return bits


def iquant(sample: int, level: int, scale: int) -> int:
    """sbc_decoder.cpp:257-265 (exact-division variant)."""
    sample = (sample << 1) | 1
    return (sample << scale) // ((1 << level) - 1)


@dataclass
class SbcDecoder:
    v: np.ndarray = field(default_factory=lambda: np.zeros((2, 170), I32))
    v_offset: np.ndarray = field(
        default_factory=lambda: (np.arange(1, 17, dtype=np.int64) * 10)
        [None, :].repeat(2, 0).copy())
    # header fields of the last frame
    frequency: int = 0
    blocks: int = 0
    channels: int = 1
    mode: int = 0
    allocation: int = 0
    subbands: int = 8
    bitpool: int = 0

    def parse_frame(self, data: bytes):
        """Header + scale factors + quantized samples.

        Returns (sb_sample int64[blocks][channels][8], frame_len) or None
        on unsupported/invalid header."""
        if len(data) < 4 or data[0] != 0x9C:
            return None
        self.frequency = (data[1] >> 6) & 3
        self.blocks = int(T.BLOCK_MODE[(data[1] >> 4) & 3])
        self.mode = (data[1] >> 2) & 3
        self.channels = 1 if self.mode == 0 else 2
        self.allocation = (data[1] >> 1) & 1
        self.subbands = 8 if (data[1] & 1) else 4
        self.bitpool = data[2]
        if self.mode == 3 or self.subbands == 4:
            return None

        ch, sb = self.channels, self.subbands
        sf = np.zeros((ch, sb), np.int64)
        p = 4
        for c in range(ch):
            for s in range(0, sb, 2):
                a = data[p]
                p += 1
                sf[c][s] = a >> 4
                sf[c][s + 1] = a & 0xF
        bits = bit_allocation(sf, self.bitpool, ch, self.frequency,
                              self.allocation, sb)

        samples = np.zeros((self.blocks, ch, sb), np.int64)
        base = p
        bpos = 0
        for blk in range(self.blocks):
            for c in range(ch):
                for s in range(sb):
                    level = int(bits[c][s])
                    if level:
                        raw = 0
                        for _ in range(level):
                            raw = (raw << 1) | (
                                (data[base + (bpos >> 3)]
                                 >> (7 - (bpos & 7))) & 1)
                            bpos += 1
                        scale = int(sf[c][s])
                        v = iquant(raw, level, scale) - (1 << scale)
                        samples[blk][c][s] = v
        frame_len = base + (bpos + 7) // 8
        self._sf = sf
        return samples, frame_len

    def decode_frame(self, data: bytes):
        """Decode one frame; returns (pcm int16[channels*blocks*8],
        frame_len)."""
        parsed = self.parse_frame(data)
        if parsed is None:
            return None
        samples, frame_len = parsed
        proto = T.PROTO_8.astype(np.int64)
        syn = T.SYN_8.astype(np.int64)
        out = np.zeros((self.channels, self.blocks, 8), np.int16)
        for c in range(self.channels):
            v = self.v[c]
            offset = self.v_offset[c]
            for blk in range(self.blocks):
                src = samples[blk][c].astype(np.int64)
                for i in range(16):
                    if offset[i] == 0:
                        v[160:169] = v[0:9]
                        offset[i] = 160
                    offset[i] -= 1
                    s = int((syn[i] * src).sum())
                    s = _wrap32(s) >> 15
                    v[offset[i]] = _wrap32(s)
                for i in range(8):
                    p0 = int(offset[i])
                    p1 = int(offset[(i + 8) & 0xF]) + 1
                    s = 0
                    for j in range(5):
                        s += int(v[p0 + 2 * j]) * int(proto[i][2 * j])
                        s += int(v[p1 + 2 * j]) * int(proto[i][2 * j + 1])
                    s = _wrap32(s) >> 15
                    s = max(-0x7FFF, min(0x7FFF, s))
                    out[c][blk][i] = s
        return out.reshape(self.channels, -1).reshape(-1), frame_len


def _wrap32(x: int) -> int:
    """Wrap a python int to signed 32-bit (C int overflow behavior; the
    oracle is compiled with -fwrapv to pin this)."""
    x &= 0xFFFFFFFF
    return x - (1 << 32) if x >= (1 << 31) else x
