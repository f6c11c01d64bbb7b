"""Audio of a tick: SBC frames -> PCM -> beep / starve selects -> PDM.

Plain NumPy, written for the benchmark from the upstream semantics
(video.cpp:990-1057, espflix.ino:109-120) and the port's plain forms:

- ``decode_frames``: the scalar SBC decoder (reference/sbc.py) over a
  lane's frames in order, its history carried in the decoder;
- ``modulate``: the second-order delta-sigma modulator, two modulator
  ticks of 16 PDM bits (MSB first) a PCM sample, int32 arithmetic that
  wraps, state (i0, i1, i2) carried across calls; vectorised over lanes,
  sequential in time;
- ``audio_out``: a tick's selects around the modulator, as the chain
  applies them.
"""

from __future__ import annotations

import numpy as np

from espbench.reference.sbc import SbcDecoder

A1 = 38973          # int(0x7FFF * 1.18940)
A2 = 69577          # int(0x7FFF * 2.12340)
SILENCE_WORD = 0xAAAA

_S = [0, 6392, 12539, 18204, 23169, 27244, 30272, 32137, 32767]
SIN32 = np.array(
    [-_S[i] for i in range(9)] + [-_S[16 - i] for i in range(9, 16)]
    + [_S[i - 16] for i in range(16, 25)]
    + [_S[32 - i] for i in range(25, 32)], np.int32)


def beep_wave(n_samples: int) -> np.ndarray:
    """The key-feedback sine at >>2 amplitude: int16[n_samples]."""
    return (SIN32[np.arange(n_samples) & 31] >> 2).astype(np.int16)


def decode_frames(frames: list[bytes], decoder: SbcDecoder | None = None
                  ) -> tuple[np.ndarray, SbcDecoder]:
    """PCM int16[sum of samples] of consecutive SBC frames, continuing
    `decoder`'s history (a fresh decoder when None)."""
    dec = decoder or SbcDecoder()
    out = []
    for f in frames:
        got = dec.decode_frame(f)
        if got is None:
            raise ValueError("reference SBC decoder refused a frame")
        out.append(got[0])
    return np.concatenate(out), dec


def modulate(pcm: np.ndarray, state: np.ndarray):
    """pcm int16[N, T] -> (words int32[N, 2T] of 16-bit PDM words, state
    int32[N, 3])."""
    N, T = pcm.shape
    s_all = pcm.astype(np.int32) * np.int32(2)
    i0, i1, i2 = (np.ascontiguousarray(state[:, k], dtype=np.int32)
                  for k in range(3))
    words = np.empty((N, 2 * T), np.int32)
    a1p, a1n = np.int32(A1), np.int32(-A1)
    a2p, a2n = np.int32(A2), np.int32(-A2)
    with np.errstate(over="ignore"):
        for t in range(2 * T):
            i0 = (i0 + s_all[:, t >> 1]) >> 1
            bits = np.zeros(N, np.int32)
            for _ in range(16):
                pos = i2 >= 0
                i1 = i1 + i0 - (i2 >> 7) + np.where(pos, a1n, a1p)
                i2 = i2 + i1 + np.where(pos, a2n, a2p)
                bits = (bits << 1) | pos
            words[:, t] = bits
    return words, np.stack([i0, i1, i2], axis=1)


def audio_out(pcm: np.ndarray, state: np.ndarray, beep_left: np.ndarray,
              active: np.ndarray, starved: np.ndarray):
    """One tick's PDM for N lanes: beeping lanes play the beep wave for
    beep_left * 128 samples; starved or idle lanes emit SILENCE_WORD and
    keep their modulator state.  pcm int16[N, S]; returns (words
    int32[N, 2S], state int32[N, 3])."""
    N, S = pcm.shape
    t = np.arange(S)[None, :]
    beeping = t < (beep_left.astype(np.int64) * 128)[:, None]
    pcm = np.where(beeping, beep_wave(S)[None, :], pcm).astype(np.int16)
    words, new = modulate(pcm, state)
    silent = starved | ~(active | (beep_left > 0))
    words = np.where(silent[:, None], np.int32(SILENCE_WORD), words)
    return words, np.where(silent[:, None], state, new).astype(np.int32)
