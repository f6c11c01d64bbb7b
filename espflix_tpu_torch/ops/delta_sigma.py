"""Batched second-order delta-sigma (PDM) audio modulator (K5).

The port of espflix_tpu.ops.delta_sigma.modulate and of its TPU kernel
delta_sigma_pallas.modulate_pallas: per PCM sample two modulator ticks
of 16 PDM bits each (MSB first); CRFB loop with a1 = 38973,
a2 = 69577, i0 = (i0 + s) >> 1, i1 += i0 -+ a1 - (i2 >> 7),
i2 += i1 -+ a2, bit = i2 >= 0; (i0, i1, i2) carry across calls.  int32
arithmetic wraps.

``modulate`` launches K5 (csrc/pdm.cu, one thread per lane with the
state in registers; the bit step rewritten so that i2's chain is three
dependent integer operations, with the same bits) on CUDA tensors;
``modulate_torch`` is its plain eager recurrence (~2*16*T dependent
steps of a few small ops each), taken for CPU tensors.  ``modulate_spec``
is the same function under the JAX package's second name, and
``silence`` the 0xAAAA words of a starved lane.
"""

from __future__ import annotations

import torch

A1 = int(0x7FFF * 1.18940)   # 38973
A2 = int(0x7FFF * 2.12340)   # 69577
SILENCE_WORD = 0xAAAA

launches = 0            # K5 launches (counted by the CUDA path only)


def init_state(n_lanes: int, device):
    return torch.zeros((n_lanes, 3), dtype=torch.int32, device=device)


def modulate_torch(pcm, state, *, n_samples: int):
    """Plain form of K5 (same contract as modulate)."""
    N, Tn = pcm.shape
    assert Tn == n_samples
    s_all = pcm.to(torch.int32) * 2
    i0 = state[:, 0].clone()
    i1 = state[:, 1].clone()
    i2 = state[:, 2].clone()
    words = torch.empty((N, 2 * Tn), dtype=torch.int32, device=pcm.device)
    # 0-d int32 operands keep every update in wrapping int32
    a1p, a1n, a2p, a2n = (torch.tensor(c, dtype=torch.int32,
                                       device=pcm.device)
                          for c in (A1, -A1, A2, -A2))
    for t in range(2 * Tn):
        i0 = (i0 + s_all[:, t >> 1]) >> 1
        bits = torch.zeros_like(i0)
        for _ in range(16):
            pos = i2 >= 0
            i1 = i1 + i0 - (i2 >> 7) + torch.where(pos, a1n, a1p)
            i2 = i2 + i1 + torch.where(pos, a2n, a2p)
            bits = (bits << 1) | pos
        words[:, t] = bits
    return words, torch.stack([i0, i1, i2], dim=1)


def modulate(pcm, state, *, n_samples: int):
    """pcm: int16[N, T] (int32 too on the CPU) -> (pdm int32[N, 2*T] of
    16-bit words, new state int32[N, 3]).  CPU tensors take the plain
    form; CUDA tensors launch K5 (csrc/pdm.cu)."""
    global launches
    if pcm.device.type == "cpu":
        return modulate_torch(pcm, state, n_samples=n_samples)
    if pcm.device.type != "cuda":
        raise ValueError(f"unsupported device {pcm.device}")
    from espflix_tpu_torch import build

    N, Tn = pcm.shape
    if Tn != n_samples:
        raise ValueError(f"pcm has {Tn} samples, n_samples={n_samples}")
    dev = pcm.device
    build.check(pcm, dev, torch.int16, (N, Tn))
    build.check(state, dev, torch.int32, (N, 3))
    words = torch.empty((N, 2 * Tn), dtype=torch.int32, device=dev)
    state_out = torch.empty((N, 3), dtype=torch.int32, device=dev)
    build.launch("esp_pdm", pcm, state, words, state_out, N, Tn)
    launches += 1
    return words, state_out


def modulate_spec(pcm, state, *, n_samples: int):
    """espflix_tpu.ops.delta_sigma.modulate_spec: bit for bit the same
    function as `modulate`, and run as it (K5 on a card, modulate_torch
    on the CPU).  The JAX form computes both branch outcomes of every
    bit to shorten the TPU vector unit's dependent chain; that is a
    latency trick of that unit, and K5 has its own shortened chain, so
    it is not carried over."""
    return modulate(pcm, state, n_samples=n_samples)


def silence(n_lanes: int, n_words: int, device):
    """PDM silence: int32[n_lanes, n_words] of SILENCE_WORD (0xAAAA)."""
    return torch.full((n_lanes, n_words), SILENCE_WORD, dtype=torch.int32,
                      device=device)
