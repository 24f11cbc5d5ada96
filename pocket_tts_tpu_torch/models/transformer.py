"""Streaming transformer over stacked layer parameters (port of
``pocket_tts_tpu/models/transformer.py``).

Pre-LN self-attention + exact-GELU FFN with bias-free linears; LayerScale
(``ls1``/``ls2``) only where the parameters carry it (Mimi).  Parameters are a
dict of tensors stacked on a leading layer axis; ``in_proj`` is ``[L, 3, E, E]``.
A weight may be a ``QTensor``: its linears run through ``kernels.qlinear``.
``cache_forward`` optionally mixes per-slot LoRA deltas into the four
backbone products (``lora`` / ``lora_w``, the adapter bank of
``runtime.engine.Engine.set_adapter_bank``), beside the base product, each
tp rank its cut of the factors.

* ``cache_forward`` — causal over a dense KV cache (FlowLM backbone).  The
  cache is ``[L, B, S, H, D]`` and is updated in place.
* ``tail_forward`` — sliding window over carried KV tails (Mimi decoder,
  streaming encoder).
* ``batch_forward`` — whole sequence from position 0 (Mimi batch encoder).

One layer body (:func:`_qkv`, :func:`_post_attn`) serves one device and a
mesh (``parallel/mesh.py``): a product is a list of per-rank weights, one
on a single device, a dp group's ``Shards`` on a mesh.  LayerNorm runs once
on the lead device (where the residual stream lives), its output goes to
every rank, each rank runs its column-parallel product and row-parallel
partial, and the partials are added on the lead in rank order
(``mesh.reduce_sum``; a single part is returned as it is, so one device
keeps its bits and launches).  Attention runs on each rank over its own
heads (its cache shard), or whole on the lead when tp does not divide the
heads.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from pocket_tts_tpu_torch.kernels.qlinear import linear, qlinear
from pocket_tts_tpu_torch.ops.attention import (
    FP8_DTYPES,
    banded_attention,
    cache_write,
    causal_cache_attention,
    prefill_write,
    tail_attention,
)
from pocket_tts_tpu_torch.ops.norms import layer_norm
from pocket_tts_tpu_torch.ops.qtensor import QTensor
from pocket_tts_tpu_torch.ops.rope import apply_rope
from pocket_tts_tpu_torch.parallel.mesh import Shards, reduce_sum


def _layer(params: dict, i: int) -> dict:
    return {k: v[i] for k, v in params.items()}


def _parts(w) -> list:
    """A product's per-rank weights: a ``Shards``' parts, or ``[w]`` (one rank)."""
    return w.parts if isinstance(w, Shards) else [w]


def _lora_pair(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor, w: torch.Tensor,
               qkv: bool = False) -> torch.Tensor:
    """Per-slot mixed low-rank delta ``sum_n w[:, n] * (x @ A_n^T) @ B_n^T``.

    ``x`` [B, T, in]; ``a`` [N, (3,) r, in] / ``b`` [N, (3,) out, r]: one
    layer's stacked adapter factors (``qkv`` adds in_proj's axis of 3);
    ``w`` [B, N] per-slot rows (one-hot x alpha/rank; a zero row is the base
    model).  In float32, as the offline merge (``training.lora.merge_lora``),
    so a lane tracks its merged single stream."""
    sub = "k" if qkv else ""
    u = torch.einsum(f"bti,n{sub}ri->btn{sub}r", x.float(), a.float())
    u = u * w.reshape(w.shape[0], 1, w.shape[1], *([1] * (u.dim() - 3)))
    return torch.einsum(f"btn{sub}r,n{sub}or->bt{sub}o", u, b.float())


def _add_lora(y: torch.Tensor, x: torch.Tensor, lora: list | None, r: int, lora_w,
              name: str, qkv: bool = False) -> torch.Tensor:
    """``y`` plus the ``name`` target's delta on ``x`` when the bank has one:
    rank ``r``'s factors (``lora``: one dict per rank, rank r's cut of a
    product split on tp; :meth:`Engine.set_adapter_bank`), the rows
    ``lora_w`` on ``x``'s device."""
    if lora is None or name not in lora[r]:
        return y
    f = lora[r][name]
    delta = _lora_pair(x, f["a"], f["b"], lora_w.to(x.device, non_blocking=True), qkv)
    return y + delta.reshape(y.shape).to(y.dtype)


def _rank(c, r: int):
    """Rank ``r``'s block of a cache (or KV tail) split on heads, else the whole."""
    return c.parts[r] if isinstance(c, Shards) else c


def _qkv(p_layer: dict, x: torch.Tensor, n_heads: int, cos, sin, lora=None,
         lora_w=None) -> list:
    """(q, k, v) [B, T, h, D], q and k rotated, for each rank of the layer's
    in_proj (one on a single device).  LayerNorm runs once on ``x``'s
    device (the lead); each rank's column-parallel block [3, e, E] gives its
    h = H / tp heads on its own device.  When tp does not divide the heads,
    the ranks' outputs are joined on the lead and the heads attended whole
    there (one entry)."""
    b, t, e = x.shape
    d = e // n_heads
    xn = layer_norm(x, p_layer["norm1_w"], p_layer["norm1_b"], eps=1e-5)
    projs = []
    for r, w in enumerate(_parts(p_layer["in_proj"])):
        xr = xn.to(w.device, non_blocking=True)
        if isinstance(w, QTensor):
            proj = qlinear(xr, w)  # one [3e, E] product
        else:
            proj = torch.einsum("bte,kpe->btkp", xr.to(w.dtype), w)
        projs.append(_add_lora(proj, xr, lora, r, lora_w, "in_proj", qkv=True))
    if n_heads % len(projs):
        projs = [torch.cat([p.reshape(b, t, 3, -1).to(x.device, non_blocking=True)
                            for p in projs], dim=-1)]
    out = []
    for proj in projs:
        proj = proj.reshape(b, t, 3, -1, d)
        q, k, v = proj[:, :, 0], proj[:, :, 1], proj[:, :, 2]
        c, s = cos.to(proj.device, non_blocking=True), sin.to(proj.device, non_blocking=True)
        out.append((apply_rope(q, c, s), apply_rope(k, c, s), v))
    return out


def _post_attn(p_layer: dict, x: torch.Tensor, attn: list, lora=None,
               lora_w=None) -> torch.Tensor:
    """``x`` plus the attention half's update, then the FFN half; ``attn``
    [B, T, h, D] per rank, as :func:`_qkv` gave the heads.  The row-parallel
    out_proj and ff2 partials are added on ``x``'s device in rank order by
    ``mesh.reduce_sum`` (which returns a single part as it is)."""
    b, t = x.shape[:2]
    w_out = _parts(p_layer["out_proj"])
    flat = [a.reshape(b, t, -1) for a in attn]
    if len(flat) < len(w_out):  # heads attended whole on the lead: split for out_proj
        flat = [a.to(w.device, non_blocking=True).contiguous()
                for a, w in zip(flat[0].chunk(len(w_out), dim=-1), w_out)]
    update = reduce_sum([_add_lora(linear(a, w), a, lora, r, lora_w, "out_proj")
                         for r, (a, w) in enumerate(zip(flat, w_out))], x.device)
    if "ls1" in p_layer:
        update = update * p_layer["ls1"].to(update.dtype)
    x = x + update
    xn = layer_norm(x, p_layer["norm2_w"], p_layer["norm2_b"], eps=1e-5)
    parts = []
    for r, (w1, w2) in enumerate(zip(_parts(p_layer["ff1"]), _parts(p_layer["ff2"]))):
        xr = xn.to(w1.device, non_blocking=True)
        h = F.gelu(_add_lora(linear(xr, w1), xr, lora, r, lora_w, "ff1"), approximate="none")
        parts.append(_add_lora(linear(h, w2), h, lora, r, lora_w, "ff2"))
    update = reduce_sum(parts, x.device)
    if "ls2" in p_layer:
        update = update * p_layer["ls2"].to(update.dtype)
    return x + update


def cache_forward(params: dict, n_heads: int, k_cache: torch.Tensor, v_cache: torch.Tensor,
                  pos: torch.Tensor, x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
                  t_valid: torch.Tensor | None = None, lora: dict | list | None = None,
                  lora_w: torch.Tensor | None = None):
    """Dense-cache causal transformer step over ``x`` [B, T, E] at positions
    ``pos + i``.  ``k_cache``/``v_cache`` [L, B, S, H, D] (or a view of their
    first S positions; on a mesh ``Shards`` of their heads) are written in
    place; returns (y, k_cache, v_cache).
    ``t_valid`` [B]: prefill widths (positions past them are not written).
    ``lora`` ({target: {"a": [L, N, (3,) r, in], "b": [L, N, (3,) out, r]}},
    or on a mesh a list of them, one per tp rank, each with its rank's cut)
    and ``lora_w`` [B, N]: per-slot adapter deltas (:func:`_lora_pair`)."""
    ranks = [lora] if isinstance(lora, dict) else lora
    for i in range(k_cache.shape[0]):
        p_layer = _layer(params, i)
        lo = None if ranks is None else [{k: {"a": f["a"][i], "b": f["b"][i]}
                                          for k, f in rank.items()} for rank in ranks]
        attn = []
        for r, (q, k, v) in enumerate(_qkv(p_layer, x, n_heads, cos, sin, lo, lora_w)):
            kc, vc = _rank(k_cache[i], r), _rank(v_cache[i], r)
            p = pos.to(q.device, non_blocking=True)
            if t_valid is None:
                cache_write(kc, k, p)
                cache_write(vc, v, p)
            else:
                tv = t_valid.to(q.device, non_blocking=True)
                prefill_write(kc, k, p, tv)
                prefill_write(vc, v, p, tv)
            attn.append(causal_cache_attention(q, kc, vc, p))
        x = _post_attn(p_layer, x, attn, lo, lora_w)
    return x, k_cache, v_cache


def tail_forward(params: dict, n_heads: int, context: int, k_tail: torch.Tensor,
                 v_tail: torch.Tensor, pos: torch.Tensor, x: torch.Tensor, cos, sin,
                 block: int = 256):
    """Sliding-window streaming step over carried KV tails [L, B, context-1, H, D]
    (on a mesh ``Shards`` of their heads); returns (y, new_k_tail, new_v_tail)."""
    kts, vts = [], []  # per layer, the new tails of each rank
    for i in range(k_tail.shape[0]):
        p_layer = _layer(params, i)
        attn, new_k, new_v = [], [], []
        for r, (q, k, v) in enumerate(_qkv(p_layer, x, n_heads, cos, sin)):
            a, kt, vt = tail_attention(q, k, v, _rank(k_tail[i], r), _rank(v_tail[i], r),
                                       pos.to(q.device, non_blocking=True), context,
                                       block=block)
            attn.append(a)
            new_k.append(kt)
            new_v.append(vt)
        x = _post_attn(p_layer, x, attn)
        kts.append(new_k)
        vts.append(new_v)
    if isinstance(k_tail, Shards):
        return (x, Shards([torch.stack(t) for t in zip(*kts)], k_tail.dim),
                Shards([torch.stack(t) for t in zip(*vts)], v_tail.dim))
    return x, torch.stack([t[0] for t in kts]), torch.stack([t[0] for t in vts])


def batch_forward(params: dict, n_heads: int, context: int | None, x: torch.Tensor,
                  cos: torch.Tensor, sin: torch.Tensor, block: int = 256) -> torch.Tensor:
    """Whole-sequence forward of ``x`` [B, T, E] from position 0 (no state)."""
    for i in range(params["in_proj"].shape[0]):
        p_layer = _layer(params, i)
        attn = [banded_attention(q, k, v, context, block=block)
                for q, k, v in _qkv(p_layer, x, n_heads, cos, sin)]
        x = _post_attn(p_layer, x, attn)
    return x


def init_cache(n_layers: int, batch: int, capacity: int, n_heads: int, head_dim: int,
               dtype=torch.float32, device: torch.device | str = "cpu"):
    """Zero caches [L, B, S, H, D]; an fp8 cache is made as zero bytes (0.0
    in both fp8 formats), which needs no fp8 fill kernel."""
    shape = (n_layers, batch, capacity, n_heads, head_dim)
    if dtype in FP8_DTYPES:
        return tuple(torch.zeros(shape, dtype=torch.uint8, device=device).view(dtype)
                     for _ in range(2))
    return (torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device))


def init_tail(n_layers: int, batch: int, context: int, n_heads: int, head_dim: int,
              dtype=torch.float32, device: torch.device | str = "cpu"):
    return init_cache(n_layers, batch, context - 1, n_heads, head_dim, dtype, device)


def _project(p: dict, name: str, x: torch.Tensor) -> torch.Tensor:
    return linear(x, p[name]) if name in p else x


def projected_batch_forward(p: dict, cfg, x_bct: torch.Tensor, cos, sin,
                            block: int = 256) -> torch.Tensor:
    """Mimi ProjectedTransformer over [B, C, T] from position 0."""
    x = _project(p, "input_proj", x_bct.transpose(1, 2))
    y = batch_forward(p["layers"], cfg.num_heads, cfg.context, x, cos, sin, block=block)
    return _project(p, "output_proj", y).transpose(1, 2)


def projected_tail_forward(p: dict, cfg, k_tail, v_tail, pos, x_bct: torch.Tensor, cos, sin):
    """Mimi ProjectedTransformer over [B, C, T] with optional in/out projections."""
    x = _project(p, "input_proj", x_bct.transpose(1, 2))
    y, k_tail, v_tail = tail_forward(p["layers"], cfg.num_heads, cfg.context, k_tail, v_tail,
                                     pos, x, cos, sin)
    return _project(p, "output_proj", y).transpose(1, 2), k_tail, v_tail
