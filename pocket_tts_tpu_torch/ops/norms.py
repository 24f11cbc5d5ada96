"""Normalization primitives (port of ``pocket_tts_tpu/ops/norms.py``).

Statistics are always computed in float32 and the result is cast back to the
input dtype, whatever the compute dtype.
"""

from __future__ import annotations

import torch


def rms_norm_torchvar(x: torch.Tensor, alpha: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm with PyTorch ``x.var()`` semantics.

    NOT standard RMSNorm: the variance is mean-subtracted AND Bessel-corrected
    (divides by N-1), but the output is ``x * alpha * rsqrt(eps + var)`` with
    the un-centred ``x``.
    """
    xf = x.float()
    n = x.shape[-1]
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().sum(dim=-1, keepdim=True) / (n - 1)
    y = xf * (alpha.float() * torch.rsqrt(eps + var))
    return y.to(x.dtype)


def layer_norm(
    x: torch.Tensor,
    weight: torch.Tensor | None = None,
    bias: torch.Tensor | None = None,
    eps: float = 1e-5,
) -> torch.Tensor:
    """Standard LayerNorm (biased variance), two-pass float32 statistics."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    if weight is not None:
        y = y * weight.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype)
