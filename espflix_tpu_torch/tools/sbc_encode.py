"""SBC frame builder: fixtures and simple content encoding.

Copied from espflix_tpu/tools/sbc_encode.py; tests/test_torch_isolation.py
pins the copy to the original.

Builds valid A2DP SBC frames for the subset the decoders support
(8 subbands, mono/dual-channel, loudness or SNR allocation).  The service
operating point matches the reference content pipeline: 48 kHz mono,
16 blocks, ~bitpool 28 => 64-byte frames, 128 PCM samples each
(indexer/indexer.cpp:307, video.cpp:952-955).
"""

from __future__ import annotations

import math

import numpy as np

from espflix_tpu_torch.audio.sbc import bit_allocation
from espflix_tpu_torch.core import sbc_tables as T


class _BW:
    def __init__(self):
        self.bits = []

    def put(self, v, n):
        assert 0 <= v < (1 << n)
        for i in range(n - 1, -1, -1):
            self.bits.append((v >> i) & 1)

    def tobytes(self):
        while len(self.bits) % 8:
            self.bits.append(0)
        out = bytearray(len(self.bits) // 8)
        for i, b in enumerate(self.bits):
            if b:
                out[i >> 3] |= 0x80 >> (i & 7)
        return bytes(out)


def make_frame(scale_factors, raw_samples=None, frequency=3, blocks=16,
               mode=0, allocation=0, bitpool=28, rng=None) -> bytes:
    """Assemble one SBC frame.

    scale_factors: int[channels][8] (0..15).
    raw_samples: optional int[blocks][channels][8] quantized values in
      [0, 2^level-1]; random if omitted (rng required).
    """
    channels = 1 if mode == 0 else 2
    sf = np.asarray(scale_factors, np.int64).reshape(channels, 8)
    bits = bit_allocation(sf, bitpool, channels, frequency, allocation, 8)

    blocks_idx = {4: 0, 8: 1, 12: 2, 16: 3}[blocks]
    hdr = bytes([
        0x9C,
        (frequency << 6) | (blocks_idx << 4) | (mode << 2)
        | (allocation << 1) | 1,
        bitpool,
        0,  # CRC (ignored by the decoders)
    ])
    w = _BW()
    for c in range(channels):
        for s in range(0, 8, 2):
            w.put((int(sf[c][s]) << 4) | int(sf[c][s + 1]), 8)
    for blk in range(blocks):
        for c in range(channels):
            for s in range(8):
                level = int(bits[c][s])
                if level:
                    if raw_samples is not None:
                        v = int(raw_samples[blk][c][s])
                    else:
                        v = int(rng.integers(0, 1 << level))
                    w.put(v, level)
    return hdr + w.tobytes()


def random_frame(rng, mode=0, allocation=None, bitpool=None,
                 blocks=16) -> bytes:
    channels = 1 if mode == 0 else 2
    sf = rng.integers(0, 16, (channels, 8))
    if allocation is None:
        allocation = int(rng.random() < 0.3)
    if bitpool is None:
        bitpool = int(rng.integers(8, 96))
    return make_frame(sf, None, frequency=3, blocks=blocks, mode=mode,
                      allocation=allocation, bitpool=bitpool, rng=rng)


def encode_pcm_mono(pcm: np.ndarray, bitpool=28) -> list[bytes]:
    """Minimal real SBC encoder: mono 48 kHz, 16 blocks, loudness.

    Float analysis filterbank (encoder precision is NOT part of the
    bit-exact contract -- only decoders are), spec-shaped quantization.
    Returns the list of frames; pads the tail with zeros.
    """
    pcm = np.asarray(pcm, np.float64)
    n = len(pcm)
    frames = []
    # polyphase analysis via windowed DCT (A2DP 12.5 structure)
    X = np.zeros(80)
    proto = _analysis_proto()
    mat = np.array([[math.cos((i + 0.5) * (k - 4) * math.pi / 8)
                     for k in range(16)] for i in range(8)])
    pos = 0
    while pos < n:
        sb_all = np.zeros((16, 1, 8))
        for blk in range(16):
            chunk = np.zeros(8)
            take = pcm[pos:pos + 8]
            chunk[:len(take)] = take
            pos += 8
            X = np.roll(X, 8)
            X[:8] = chunk[::-1]
            Z = X * proto
            Y = np.array([sum(Z[k + 16 * m] for m in range(5))
                          for k in range(16)])
            sb_all[blk, 0] = mat @ Y
        # scale factors
        sf = np.zeros((1, 8), np.int64)
        for s in range(8):
            m = np.abs(sb_all[:, 0, s]).max() / 32768.0
            sf[0][s] = min(15, max(0, int(np.ceil(np.log2(m * 2))) + 15
                                   ) - 15 + 1) if m > 0 else 0
            lvl = 0
            while (1 << (lvl + 1)) < m * 2 and lvl < 14:
                lvl += 1
            sf[0][s] = lvl + 1 if m >= 1 else 0
        bits = bit_allocation(sf, bitpool, 1, 3, 0, 8)
        raw = np.zeros((16, 1, 8), np.int64)
        for blk in range(16):
            for s in range(8):
                level = int(bits[0][s])
                if level:
                    scale = int(sf[0][s])
                    v = sb_all[blk, 0, s] / 32768.0
                    q = int(((v / (1 << scale) + 1.0) / 2.0)
                            * ((1 << level) - 1))
                    raw[blk, 0, s] = min(max(q, 0), (1 << level) - 1)
        frames.append(make_frame(sf, raw, bitpool=bitpool))
    return frames


def _analysis_proto():
    # Q16 synthesis prototype back to float, standard window shape
    p = np.zeros(80)
    flat = T.PROTO_8.reshape(-1).astype(np.float64) / 65536.0
    # interleaved order -> natural order approximation for the analysis
    # side; encoder fidelity is non-contractual, this just sounds right.
    for i in range(8):
        for j in range(10):
            p[i + 8 * j] = abs(flat[i * 10 + j]) / 4
    return p
