"""Masked attention in plain PyTorch, the one softmax every attention of the
port runs outside the decode kernel (``ops/attention.py``) and the plain
version of that kernel (``kernels/decode_attention.py``) share.

Softmax runs in float32.  Masked logits use ``-1e30``, not ``-inf``: padded
query rows are fully masked, and ``-inf`` would turn them into NaN.
"""

from __future__ import annotations

import math

import torch

_NEG = -1e30
FP8_DTYPES = (torch.float8_e4m3fn, torch.float8_e5m2)


def sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """q [B,T,H,D], k/v [B,S,H,D]; mask [B,1,T,S] or [1,1,T,S] bool.

    K/V stored in another dtype than q are cast to q's dtype, as in the JAX
    package, except fp8, which goes straight to float32 (the same values:
    every fp8 value is a bf16 value; one cast fewer).  Logits and the
    probability-weighted sum accumulate in float32 (bf16 products are exact
    in f32); probabilities are rounded to q's dtype, never to the storage
    dtype.
    """
    if k.dtype != q.dtype and k.dtype not in FP8_DTYPES:
        k = k.to(q.dtype)
    if v.dtype != q.dtype and v.dtype not in FP8_DTYPES:
        v = v.to(q.dtype)
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("bthd,bshd->bhts", q.float(), k.float()) * scale
    logits = torch.where(mask, logits, torch.full((), _NEG, device=logits.device))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhts,bshd->bthd", probs.to(q.dtype).float(), v.float())
    return out.to(q.dtype)
