"""Batched SBC audio decode (8 subbands, 16 blocks, mono or 2-channel).

The port of espflix_tpu.models.sbc: header parse, bit allocation,
unpacking and IQUANT (ops/sbc_ops.py), then the synthesis filterbank as
a 10-tap convolution over the per-block V vectors with invalid frames
compacted out of the timeline.  Every product and sum is int32 with
wraparound, as in the JAX package (no int64 before the >> 15 and the
clip).  PCM layout: per frame, all of channel 0's 128 samples precede
channel 1's.
"""

from __future__ import annotations

import numpy as np
import torch

from espflix_tpu_torch.core import sbc_tables as ST
from espflix_tpu_torch.ops import sbc_ops

BLOCKS = 16
SUBBANDS = 8
PCM_PER_FRAME = BLOCKS * SUBBANDS  # 128 per channel
HIST = 10                          # V-history depth (past blocks)
assert BLOCKS >= HIST              # the history tail lives in one frame


def init_state(n_lanes: int, device):
    """Per-lane synthesis V-history, one [10, 16] bank per channel."""
    return torch.zeros((n_lanes, 2, HIST, 16), dtype=torch.int32,
                       device=device)


def frames_to_words(frames: np.ndarray) -> np.ndarray:
    """uint8[N, F, L] -> uint32[N, F, ceil(L/4)+1] big-endian words."""
    N, F, L = frames.shape
    pad = (-L) % 4 + 4
    b = np.zeros((N, F, L + pad), np.uint8)
    b[..., :L] = frames
    w = b.view(np.uint32)
    w.byteswap(inplace=True)
    return w


def _byte(words, k: int):
    return (words[..., k >> 2] >> (8 * (3 - (k & 3)))) & 0xFF


def _synthesis_conv(samples, fvalid, h0, *, N, F, CH, syn, proto):
    """samples int32[N, F, BLOCKS, CH, SUBBANDS]; fvalid bool[N, F];
    h0 int32[N*CH, 10, 16] (row j = V of the j+1-th most recent past
    block); syn int32[16, 8], proto int32[8, 10].  Returns (pcm
    int32[N, F, CH, BLOCKS, SUBBANDS], new_hist int32[N*CH, 10, 16])."""
    B = N * CH
    T_ = F * BLOCKS
    # V = (SYN_8 @ src) >> 15 per block, int32 wrapping
    src = samples.permute(0, 3, 1, 2, 4)               # [N, CH, F, BLK, 8]
    V = torch.zeros(src.shape[:-1] + (16,), dtype=torch.int32,
                    device=samples.device)
    for s in range(SUBBANDS):
        V = V + src[..., s:s + 1] * syn[:, s]
    V = (V >> 15).reshape(B, F, BLOCKS, 16)

    # valid frames first (stable), invalid at the end
    order = torch.argsort((~fvalid).to(torch.int32), dim=1, stable=True)
    nv = fvalid.sum(dim=1).to(torch.int32)              # [N]
    order_b = order.repeat_interleave(CH, dim=0)        # [B, F]
    Vc = torch.gather(V, 1, order_b[:, :, None, None].expand(
        B, F, BLOCKS, 16))
    s_ = Vc.reshape(B, T_, 16)
    Vext = torch.cat([h0.flip(1), s_], dim=1)           # [B, 10 + T, 16]

    acc = torch.zeros((B, T_, SUBBANDS), dtype=torch.int32,
                      device=samples.device)
    for a in range(5):
        we = Vext[:, HIST - 2 * a:HIST - 2 * a + T_, :8]
        wo = Vext[:, HIST - 2 * a - 1:HIST - 2 * a - 1 + T_, 8:]
        acc = acc + we * proto[:, 2 * a] + wo * proto[:, 2 * a + 1]
    pcm_c = (acc >> 15).clamp(-0x7FFF, 0x7FFF).reshape(
        B, F, BLOCKS, SUBBANDS)

    # invalid / padding slots emit zero; scatter back to frame slots
    iota_f = torch.arange(F, device=samples.device)
    kvalid = (iota_f[None, :] < nv[:, None])             # [N, k]
    kv_b = kvalid.repeat_interleave(CH, dim=0)
    pcm_c = torch.where(kv_b[:, :, None, None], pcm_c, 0)
    pcm = torch.zeros_like(pcm_c).scatter_(
        1, order_b[:, :, None, None].expand(B, F, BLOCKS, SUBBANDS), pcm_c)
    pcm = pcm.reshape(N, CH, F, BLOCKS, SUBBANDS).permute(0, 2, 1, 3, 4)

    # history: the last 10 blocks of the compacted stream all live in
    # the last valid frame; nv == 0 keeps h0
    lastf = (order * kvalid).amax(dim=1) * nv.clamp(max=1)
    lf_b = lastf.repeat_interleave(CH, dim=0).long()
    tail = V[torch.arange(B, device=V.device), lf_b,
             BLOCKS - HIST:BLOCKS]                       # [B, 10, 16]
    h1 = tail.flip(1)
    nv_b = nv.repeat_interleave(CH, dim=0)
    h1 = torch.where((nv_b > 0)[:, None, None], h1, h0)
    return pcm, h1


def decode_frames_batched(words, hist, active=None, n_valid=None, *,
                          n_frames: int, channels: int = 1, syn=None,
                          proto=None):
    """words: int32[N, F, W] (uint32 big-endian bit patterns); hist:
    int32[N, 2, 10, 16] (init_state).  active: optional bool[N]; inactive
    lanes keep their state and emit zero PCM.  n_valid: optional
    int32[N] valid frame count; later frames are padding (no state
    update, zero PCM, no error).  Error frames do not touch the
    V-history.  syn/proto: SYN_8 / PROTO_8 as int32 on the device
    (made here when omitted).

    Returns (pcm int16[N, F*channels*128], new_hist, error bool[N, F],
    frame_bits int32[N, F])."""
    N, F, W = words.shape
    CH = channels
    assert F == n_frames and CH in (1, 2)
    dev = words.device
    if syn is None:
        syn = torch.as_tensor(ST.SYN_8, dtype=torch.int32, device=dev)
    if proto is None:
        proto = torch.as_tensor(ST.PROTO_8, dtype=torch.int32, device=dev)
    b0 = _byte(words, 0)
    b1 = _byte(words, 1)
    bitpool = _byte(words, 2)
    frequency = (b1 >> 6) & 3
    blocks_idx = (b1 >> 4) & 3
    mode = (b1 >> 2) & 3
    allocation = (b1 >> 1) & 1
    sb8 = (b1 & 1) == 1
    hdr_channels = torch.where(mode == 0, 1, 2)
    error = (b0 != 0x9C) | (blocks_idx != 3) | ~sb8 | (mode == 3) | \
        (hdr_channels != CH)

    # scale factors: bytes 4 .. 4+CH*4, channel-major, two nibbles each
    sf = torch.stack(
        [(_byte(words, 4 + k // 2) >> 4) if k % 2 == 0
         else (_byte(words, 4 + k // 2) & 0xF)
         for k in range(CH * 8)], dim=-1).reshape(N, F, CH, 8)

    bits = sbc_ops.bit_allocation_batched(
        sf, bitpool[..., None], frequency[..., None],
        allocation[..., None])                          # [N, F, CH, 8]

    # bit unpack order is (blk, ch, sb)
    widths = bits[:, :, None, :, :].expand(N, F, BLOCKS, CH, SUBBANDS)
    wflat = widths.reshape(N, F, BLOCKS * CH * SUBBANDS)
    ends = torch.cumsum(wflat, dim=-1).to(torch.int32)
    base_bits = (4 + CH * 4) * 8
    offsets = base_bits + ends - wflat
    raw = sbc_ops.extract_bits(words, offsets, wflat)
    raw = raw.reshape(N, F, BLOCKS, CH, SUBBANDS)
    scale = sf[:, :, None, :, :].expand(raw.shape)
    samples = torch.where(widths > 0,
                          sbc_ops.iquant_exact(raw, widths, scale), 0)

    fvalid = ~error
    if n_valid is not None:
        in_n = torch.arange(F, device=dev)[None, :] < n_valid[:, None]
        fvalid = fvalid & in_n
        error = error & in_n

    pcm_c, h1 = _synthesis_conv(
        samples, fvalid, hist[:, :CH].reshape(N * CH, HIST, 16),
        N=N, F=F, CH=CH, syn=syn, proto=proto)
    pcm = pcm_c.reshape(N, F * CH * PCM_PER_FRAME)
    new_hist = hist.clone()
    new_hist[:, :CH] = h1.reshape(N, CH, HIST, 16)
    frame_bits = base_bits + ends[..., -1]
    if active is not None:
        new_hist = torch.where(active[:, None, None, None], new_hist, hist)
        pcm = torch.where(active[:, None], pcm, 0)
        error = error & active[:, None]
    return pcm.to(torch.int16), new_hist, error, frame_bits
