"""Two's-complement narrowing: the port computes wide (int64) where the
JAX package relies on int16 / int32 wraparound, then narrows here."""

from __future__ import annotations

import torch


def wrap16(x: torch.Tensor) -> torch.Tensor:
    """Low 16 bits of an integer tensor as int16."""
    return (((x.long() & 0xFFFF) ^ 0x8000) - 0x8000).to(torch.int16)


def wrap32(x: torch.Tensor) -> torch.Tensor:
    """Low 32 bits of an integer tensor as int32."""
    return (((x.long() & 0xFFFFFFFF) ^ 0x80000000) - 0x80000000) \
        .to(torch.int32)
