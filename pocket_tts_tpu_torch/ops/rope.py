"""Rotary positional embedding, interleaved-pair convention (port of
``pocket_tts_tpu/ops/rope.py``).

Pairs are interleaved along the feature axis: ``(x[2i], x[2i+1])`` is rotated
by ``exp(i * pos * freq_i)`` with ``freq_i = max_period**(-2i/D)``, in float32.
"""

from __future__ import annotations

import math

import torch


def rope_table(positions: torch.Tensor, head_dim: int, max_period: float
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables for integer ``positions`` (any shape), each ``[..., D/2]``."""
    half = head_dim // 2
    ds = torch.arange(half, dtype=torch.float32, device=positions.device)
    freqs = torch.exp(ds * (-math.log(max_period) * 2.0 / head_dim))
    args = positions.float()[..., None] * freqs
    return torch.cos(args), torch.sin(args)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate ``x`` [B, T, H, D] with tables [T, D/2] (or broadcastable, e.g.
    [B, T, 1, D/2])."""
    shape = x.shape
    xf = x.float().reshape(*shape[:-1], shape[-1] // 2, 2)
    xr, xi = xf[..., 0], xf[..., 1]
    if cos.dim() == 2:  # [T, D/2] -> broadcast over batch and heads
        cos = cos[None, :, None, :]
        sin = sin[None, :, None, :]
    yr = xr * cos - xi * sin
    yi = xr * sin + xi * cos
    return torch.stack([yr, yi], dim=-1).reshape(shape).to(x.dtype)
