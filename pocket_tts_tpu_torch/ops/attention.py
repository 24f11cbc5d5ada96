"""Attention over fixed-capacity KV buffers (port of
``pocket_tts_tpu/ops/attention.py``; plain PyTorch, as the JAX package left
this attention to XLA).

* FlowLM: dense cache ``[B, S, H, D]`` per layer, cursor ``pos``; new KV is
  written at ``pos..pos+T`` and key slot ``j`` is visible to the query at
  absolute position ``p`` iff ``j <= p``.
* Mimi: sliding window over a carried KV *tail* of the last ``context - 1``
  positions (``tail_attention``), or over a whole sequence from position 0
  (``banded_attention``, the batch encoder).  Both run long inputs as query
  blocks batched into one ``sdpa`` call.

Every route but the decode kernel runs ``ops.sdpa.sdpa`` (softmax in
float32, masked logits ``-1e30``).

The FlowLM decode (``causal_cache_attention`` at T = 1) is a hand-written
Hopper kernel, ``kernels/decode_attention.py``: on CUDA it reads only the
cache positions up to ``pos`` at storage width, which is what lets the port
do without the JAX package's static ``window_buckets``.  Calls with T > 1
(prefills) keep the plain ``sdpa`` by a shape rule (counted on CUDA in
``decode_attention.large_t``), as do the Mimi's ``tail_attention`` and
``banded_attention``.

Cache writes are in place: ``cache_write`` and ``prefill_write`` update the
tensor they are given and return it.  An fp8 cache (``kv_dtype``
float8_e4m3 / float8_e5m2) is written through a uint8 view of its bytes,
which is bit-identical and needs no fp8 indexing kernel, and is widened to
float32 only where it is read (``sdpa``, or in the decode kernel's
registers).  Out of range, torch saturates an
e4m3fn cast at +-448 where XLA gives NaN; attention keys and values stay far
inside that range.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from pocket_tts_tpu_torch.kernels.decode_attention import (
    count_large_t,
    decode_attention,
    decode_attention_gqa,
    expand_kv,
)
from pocket_tts_tpu_torch.ops.sdpa import FP8_DTYPES, sdpa


def raw_view(t: torch.Tensor) -> torch.Tensor:
    """The bytes of an fp8 tensor as uint8 (any other tensor as it is)."""
    return t.view(torch.uint8) if t.dtype in FP8_DTYPES else t


def cache_write(cache: torch.Tensor, new: torch.Tensor, start: torch.Tensor) -> torch.Tensor:
    """Write ``new`` [B, T, H, D] into ``cache`` [B, S, H, D] at per-batch
    offsets ``start`` [B].  Like ``lax.dynamic_update_slice``, a start that
    would overrun the cache is clamped to ``S - T``."""
    b, t = new.shape[:2]
    s = cache.shape[1]
    st = start.long().clamp(0, s - t)
    idx = st[:, None] + torch.arange(t, device=cache.device)[None, :]
    rows = torch.arange(b, device=cache.device)[:, None].expand(b, t)
    raw_view(cache)[rows, idx] = raw_view(new.to(cache.dtype))
    return cache


def prefill_write(cache: torch.Tensor, new: torch.Tensor, start: torch.Tensor,
                  t_valid: torch.Tensor) -> torch.Tensor:
    """Prefill write of ``new`` [B,T,H,D] at per-batch ``start``: only the
    first ``t_valid[b]`` positions are written, the rest are DROPPED (never
    clamped backward over live entries), as are positions past the cache."""
    b, t = new.shape[:2]
    s = cache.shape[1]
    offs = torch.arange(t, device=cache.device)[None, :]
    idx = start.long()[:, None] + offs
    keep = (offs < t_valid.long()[:, None]) & (idx >= 0) & (idx < s)
    rows = torch.arange(b, device=cache.device)[:, None].expand(b, t)
    raw_view(cache)[rows[keep], idx[keep]] = raw_view(new.to(cache.dtype))[keep]
    return cache


def causal_cache_attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                           pos: torch.Tensor) -> torch.Tensor:
    """Causal attention of ``q`` [B,T,H,D] (absolute positions ``pos + i``)
    against the cache [B,S,H,D] (new keys already written at ``pos..``), or
    [B,S,Hkv,D] with H a multiple of Hkv (grouped-query attention).
    T = 1 (a decode frame) goes to :func:`decode_attention` (or
    :func:`decode_attention_gqa`): the kernel on CUDA, the plain version on
    the CPU."""
    t, heads = q.shape[1], q.shape[2]
    gqa = k_cache.shape[2] != heads  # grouped-query attention (the LFM2 backbone)
    if t == 1:
        return (decode_attention_gqa if gqa else decode_attention)(q, k_cache, v_cache, pos)
    if q.device.type == "cuda":
        count_large_t()
    if gqa:
        k_cache, v_cache = expand_kv(k_cache, heads), expand_kv(v_cache, heads)
    s = k_cache.shape[1]
    q_pos = pos.long()[:, None] + torch.arange(t, device=q.device)[None, :]  # [B,T]
    key_idx = torch.arange(s, device=q.device)[None, None, :]
    mask = key_idx <= q_pos[:, :, None]  # [B,T,S]
    return sdpa(q, k_cache, v_cache, mask[:, None])


def tail_attention(q: torch.Tensor, k_new: torch.Tensor, v_new: torch.Tensor,
                   k_tail: torch.Tensor, v_tail: torch.Tensor, pos: torch.Tensor,
                   context: int, block: int = 256
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Sliding-window attention with a carried KV tail.

    q/k_new/v_new: [B, T, H, D] at absolute positions ``pos + i``;
    k_tail/v_tail: [B, P, H, D] with P = context - 1, holding positions
    ``pos - P .. pos - 1`` (negative absolute positions are masked).
    Returns (out, new_k_tail, new_v_tail).  Queries are processed in blocks
    of ``block`` rows when T > block, each against its P + block keys.
    """
    b, t, h, d = q.shape
    p = k_tail.shape[1]
    if p != context - 1:
        raise ValueError(f"tail length {p} != context - 1 = {context - 1}")
    dev = q.device
    k = torch.cat([k_tail, k_new.to(k_tail.dtype)], dim=1)
    v = torch.cat([v_tail, v_new.to(v_tail.dtype)], dim=1)
    new_k_tail, new_v_tail = k[:, -p:], v[:, -p:]
    pos = pos.long()

    if t <= block:
        i = torch.arange(t, device=dev)
        j = torch.arange(p + t, device=dev)
        delta = (p + i)[:, None] - j[None, :]  # query abs - key abs
        band = (delta >= 0) & (delta < context)  # [T, S]
        valid = (pos[:, None] - p + j[None, :]) >= 0  # [B, S]
        mask = band[None] & valid[:, None]
        return sdpa(q, k, v, mask[:, None]), new_k_tail, new_v_tail

    q, k, v = _pad_rows(q, k, v, block)
    span = p + block  # keys for query block qs: concat[qs : qs + P + block)
    n = q.shape[1] // block
    ii = torch.arange(block, device=dev)
    jj = torch.arange(span, device=dev)
    delta = (p + ii)[:, None] - jj[None, :]
    band = (delta >= 0) & (delta < context)  # [block, span]
    qs = torch.arange(n, device=dev)[:, None] * block
    valid = (pos[:, None, None] - p + qs[None] + jj) >= 0  # [B, n, span]
    mask = band[None, None] & valid[:, :, None, :]
    return _blocked_sdpa(q, k, v, block, mask)[:, :t], new_k_tail, new_v_tail


def _pad_rows(q, k, v, block: int):
    """Right-pad q, k and v [B, *, H, D] by the same count so q's rows are a
    multiple of ``block``; padded keys lie after every real query, outside its
    causal band."""
    pad = (-q.shape[1]) % block
    if not pad:
        return q, k, v
    return tuple(F.pad(x, (0, 0, 0, 0, 0, pad)) for x in (q, k, v))


def _blocked_sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, block: int,
                  mask: torch.Tensor) -> torch.Tensor:
    """Query block i of ``q`` [B, n*block, H, D] attends the keys
    ``k[:, i*block : i*block + span]`` (k/v [B, (n-1)*block + span, H, D])
    under ``mask`` [B or 1, n, block, span].  All n blocks go through one
    ``sdpa`` call, batched as B*n rows: the score tile is
    [B*n, H, block, span], never O(T²)."""
    b, t, h, d = q.shape
    n = t // block
    span = mask.shape[-1]

    def windows(x):  # [B, L, H, D] -> [B*n, span, H, D]
        return x.unfold(1, span, block).permute(0, 1, 4, 2, 3).reshape(b * n, span, h, d)

    mask = mask.expand(b, n, block, span).reshape(b * n, 1, block, span)
    out = sdpa(q.reshape(b * n, block, h, d), windows(k), windows(v), mask)
    return out.reshape(b, t, h, d)


def banded_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     context: int | None, block: int = 256) -> torch.Tensor:
    """Whole-sequence causal attention from position 0, with an optional
    sliding window of ``context`` keys (Mimi encoder).  q/k/v [B, T, H, D].

    Up to one block (or without a window) it is one masked ``sdpa``.
    Otherwise T is padded to a block multiple and keys are padded on the left
    by ``ctx_pad`` (the context rounded up to a block), so query block i
    attends ``ctx_pad + block`` keys starting ``ctx_pad`` before it."""
    t = q.shape[1]
    dev = q.device
    if context is None or t <= block:
        idx = torch.arange(t, device=dev)
        delta = idx[:, None] - idx[None, :]
        mask = delta >= 0
        if context is not None:
            mask &= delta < context
        return sdpa(q, k, v, mask[None, None])

    q, k, v = _pad_rows(q, k, v, block)
    n = q.shape[1] // block
    ctx_pad = -(-context // block) * block
    k = F.pad(k, (0, 0, 0, 0, ctx_pad, 0))
    v = F.pad(v, (0, 0, 0, 0, ctx_pad, 0))
    span = ctx_pad + block
    ii = torch.arange(block, device=dev)
    jj = torch.arange(span, device=dev)
    delta = (ctx_pad + ii)[:, None] - jj[None, :]  # query pos - key pos
    band = (delta >= 0) & (delta < context)  # [block, span]
    k_pos = (torch.arange(n, device=dev) * block)[:, None] - ctx_pad + jj  # [n, span]
    mask = band[None] & (k_pos >= 0)[:, None, :]
    return _blocked_sdpa(q, k, v, block, mask[None])[:, :t]
