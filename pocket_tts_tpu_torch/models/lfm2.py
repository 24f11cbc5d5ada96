"""The LFM2-MoE hybrid FlowLM backbone (LiquidAI's LFM2-8B-A1B layer
equations), beside Pocket's transformer (``transformer.py``).

Each layer ``i`` of ``BackboneConfig.layer_types``::

    h   = x + mixer(RMSNorm(x; operator_norm))
    out = h + ffn(RMSNorm(h; ffn_norm))

* ``conv`` mixer (gated short convolution): ``B, C, x' = in_proj(h)``,
  ``y = out_proj(C * conv(B * x'))`` with ``conv`` causal and depthwise over
  ``conv_L_cache`` taps, no bias.  Its state is the last ``conv_L_cache - 1``
  values of ``B * x'`` per channel.
* ``full_attention`` mixer: q, k, v from one product, RMSNorm over each
  head's q and k (``q_layernorm`` / ``k_layernorm``), RoPE in the
  rotate-half convention of base ``rope_theta``, causal attention of
  ``num_attention_heads`` query heads over ``num_key_value_heads`` KV heads
  (the dense cache of ``ops/attention.py``), ``out_proj``.
* ffn: the first ``num_dense_layers`` layers a SwiGLU ``w2(silu(w1 h) * w3 h)``
  of ``intermediate_size``; the others the routed experts of
  ``kernels/moe.py`` (sigmoid router, top-k on score + ``expert_bias``,
  normalised weights, SwiGLU experts of ``moe_intermediate_size``).

The stack ends before the final ``embedding_norm``, which ``flow_lm``
applies in place of Pocket's ``out_norm``.

Parameters (``params["flow_lm"]["lfm"]``, stacked by kind on a leading
axis): ``op_norm`` / ``ffn_norm`` [L, D]; ``conv_in`` [Lc, 3D, D],
``conv_w`` [Lc, D, taps], ``conv_out`` [Lc, D, D]; ``qkv`` [La, (Hq + 2 Hkv)
hd, D], ``qk_norm`` [La, Hq + Hkv, hd] (q's weight on the query heads' rows,
k's on the KV heads'), ``attn_out`` [La, D, D]; ``ff_up`` [Ld, 2 I, D] (w1
rows then w3 rows), ``ff_down`` [Ld, D, I]; ``router`` [Lm, E, D],
``expert_bias`` [Lm, E], ``experts_up`` [Lm, E, 2F, D], ``experts_down``
[Lm, E, D, F]; ``final_norm`` [D].

State (written in place): the KV cache ``kc`` / ``vc`` [La, B, S, Hkv, hd]
of the attention layers and the conv state ``cs`` [Lc, B, D, taps - 1] of
the conv layers.  ``slots`` [Lm, E] (int64, optional) counts the routed
token-slots of each MoE layer and expert on the device.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from pocket_tts_tpu_torch.config import BackboneConfig
from pocket_tts_tpu_torch.kernels import moe
from pocket_tts_tpu_torch.models.transformer import init_cache
from pocket_tts_tpu_torch.ops.attention import causal_cache_attention, prefill_write, raw_view

# the leaves kept in the compute dtype (bf16 on CUDA); the others stay float32
NARROW = ("op_norm", "ffn_norm", "conv_in", "conv_out", "qkv", "qk_norm", "attn_out", "ff_up",
          "ff_down", "experts_up", "experts_down")


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """``x * rsqrt(mean(x^2) + eps) * w`` over the last axis (statistics in
    float32, one fused kernel on CUDA); ``w`` in x's dtype (``NARROW``)."""
    return F.rms_norm(x, (x.shape[-1],), w, eps)


def final_norm(params: dict, bb: BackboneConfig, y: torch.Tensor) -> torch.Tensor:
    """``embedding_norm`` of the last position, float32 (the flow net's and
    the EOS head's input)."""
    return F.rms_norm(y.float(), (y.shape[-1],), params["final_norm"].float(), bb.norm_eps)


def init_state(bb: BackboneConfig, batch: int, capacity: int, kv_dtype: torch.dtype,
               dtype: torch.dtype, device) -> dict:
    """Zero state of ``batch`` lanes: {"kc", "vc", "cs"}."""
    kc, vc = init_cache(len(bb.attn_layers), batch, capacity, bb.num_key_value_heads,
                        bb.head_dim, kv_dtype, device)
    cs = torch.zeros((len(bb.conv_layers), batch, bb.hidden_size, bb.conv_L_cache - 1),
                     dtype=dtype, device=device)
    return {"kc": kc, "vc": vc, "cs": cs}


def _rope_tables(positions: torch.Tensor, head_dim: int, theta: float):
    """(cos, signed sin) [B, T, 1, hd] for the rotate-half RoPE:
    ``x * cos + roll(x, hd / 2) * sin`` with sin negated on the first half."""
    half = head_dim // 2
    inv = theta ** (-torch.arange(half, dtype=torch.float32, device=positions.device) / half)
    ang = positions.float()[..., None] * inv  # [B, T, hd/2]
    cos, sin = torch.cos(ang), torch.sin(ang)
    return (torch.cat([cos, cos], -1)[:, :, None], torch.cat([-sin, sin], -1)[:, :, None])


class LayerStacks(dict):
    """The backbone's stacked leaves (what ``Engine.place_params`` places),
    with each layer's weights as views cached on the dict at first use
    (``layers``): indexing a stacked leaf costs a dispatch, and the frame loop
    would pay ~300 of them a frame.  The cache lives and dies with the dict."""

    layers = None


def _layers(params: dict, bb: BackboneConfig) -> list[tuple]:
    """(kind, kind index, weights) of each layer of ``params``."""
    if params.__class__ is LayerStacks and params.layers is not None:
        return params.layers
    conv_i = {li: c for c, li in enumerate(bb.conv_layers)}
    attn_i = {li: a for a, li in enumerate(bb.attn_layers)}
    out = []
    for i in range(bb.num_hidden_layers):
        w = {"op_norm": params["op_norm"][i], "ffn_norm": params["ffn_norm"][i]}
        if i in conv_i:
            c, kind = conv_i[i], "conv"
            w |= {"conv_in": params["conv_in"][c], "conv_w": params["conv_w"][c][:, None, :],
                  "conv_out": params["conv_out"][c]}
        else:
            c, kind = attn_i[i], "attn"
            w |= {n: params[n][c] for n in ("qkv", "qk_norm", "attn_out")}
        if i < bb.num_dense_layers:
            w |= {"ff_up": params["ff_up"][i], "ff_down": params["ff_down"][i]}
        else:
            m = i - bb.num_dense_layers
            w |= {"router": params["router"][m], "experts_up": params["experts_up"][m],
                  "experts_down": params["experts_down"][m], "moe": m,
                  "expert_bias": params["expert_bias"][m] if bb.use_expert_bias else None}
        out.append((kind, c, w))
    if params.__class__ is LayerStacks:
        params.layers = out
    return out


def forward(params: dict, bb: BackboneConfig, kc: torch.Tensor, vc: torch.Tensor,
            cs: torch.Tensor, pos: torch.Tensor, x: torch.Tensor,
            t_valid: torch.Tensor | None = None,
            slots: torch.Tensor | None = None) -> torch.Tensor:
    """The layer stack over ``x`` [B, T, D] at positions ``pos + i`` (``pos``
    [B]); ``t_valid`` [B] (a prefill): only the first ``t_valid[b]`` positions
    of lane b are written to the caches and counted in ``slots``, and the conv
    state is that of its last valid position.  Returns the stack's output
    [B, T, D] (before ``embedding_norm``); the state is written in place."""
    b, t, d = x.shape
    hq, hkv, hd = bb.num_attention_heads, bb.num_key_value_heads, bb.head_dim
    taps, eps, split = bb.conv_L_cache, bb.norm_eps, (hq + hkv) * hd
    offs = torch.arange(t, device=x.device)
    cos, sin = _rope_tables(pos.long()[:, None] + offs, hd, bb.rope_theta)
    if t_valid is None:  # decode: one write per lane at min(pos, S - 1), as cache_write
        rows = torch.arange(b, device=x.device)[:, None]
        at = pos.long().clamp(0, kc.shape[2] - t)[:, None] + offs
        state_idx, valid = None, None
    else:
        # the conv state after lane b's last valid position: steps t_valid[b] ..
        # t_valid[b] + taps - 2 of [old state, new inputs]
        state_idx = (t_valid.long()[:, None] + torch.arange(taps - 1, device=x.device))
        state_idx = state_idx[:, None, :].expand(b, d, taps - 1)
        valid = (offs[None, :] < t_valid[:, None]).reshape(-1)
    kcs, vcs, css = kc.unbind(0), vc.unbind(0), cs.unbind(0)
    slot_rows = None if slots is None else slots.unbind(0)
    for kind, c, w in _layers(params, bb):
        h = rms_norm(x, w["op_norm"], eps)
        if kind == "conv":
            bg, cg, xx = F.linear(h, w["conv_in"]).chunk(3, dim=-1)
            full = torch.cat([css[c], (bg * xx).transpose(1, 2)], dim=-1)
            conv = (full.unfold(-1, taps, 1) * w["conv_w"]).sum(-1)
            css[c].copy_(full[..., t:] if state_idx is None else full.gather(-1, state_idx))
            mixed = F.linear((cg * conv.transpose(1, 2)).to(x.dtype), w["conv_out"])
        else:
            qkv = F.linear(h, w["qkv"])
            qk = qkv[..., :split].unflatten(-1, (hq + hkv, hd))
            v = qkv[..., split:].unflatten(-1, (hkv, hd))
            qk = F.rms_norm(qk, (hd,), eps=eps) * w["qk_norm"]
            qk = (qk * cos + torch.roll(qk, hd // 2, dims=-1) * sin).to(x.dtype)
            q, k = qk[:, :, :hq], qk[:, :, hq:]
            kcc, vcc = kcs[c], vcs[c]
            if t_valid is None:
                raw_view(kcc)[rows, at] = raw_view(k if k.dtype == kcc.dtype else k.to(kcc.dtype))
                raw_view(vcc)[rows, at] = raw_view(v if v.dtype == vcc.dtype else v.to(vcc.dtype))
            else:
                prefill_write(kcc, k, pos, t_valid)
                prefill_write(vcc, v, pos, t_valid)
            att = causal_cache_attention(q, kcc, vcc, pos)
            mixed = F.linear(att.reshape(b, t, hq * hd), w["attn_out"])
        x = x + mixed
        h = rms_norm(x, w["ffn_norm"], eps)
        if "ff_up" in w:
            gate, up = F.linear(h, w["ff_up"]).chunk(2, dim=-1)
            x = x + F.linear(F.silu(gate) * up, w["ff_down"])
        else:
            flat = h.reshape(b * t, d)
            ids, wt = moe.route(flat, w["router"], w["expert_bias"], bb.num_experts_per_tok,
                                bb.norm_topk_prob, bb.routed_scaling_factor,
                                None if slot_rows is None else slot_rows[w["moe"]], valid)
            x = x + moe.experts(flat, ids, wt, w["experts_up"], w["experts_down"]).view(b, t, d)
    return x
