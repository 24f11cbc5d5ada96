"""FlowLM: causal autoregressive backbone + flow head (port of
``pocket_tts_tpu/models/flow_lm.py``).

Per frame: input linear (latent 32 -> d_model) -> causal transformer over the
dense KV cache -> LayerNorm -> EOS logit -> Gaussian noise (std sqrt(temp),
optionally truncated) -> LSD Euler flow decode back to a latent.  The BOS
input is the explicit ``bos_emb`` latent, not a NaN sentinel.
"""

from __future__ import annotations

import math

import torch

from pocket_tts_tpu_torch.config import Config
from pocket_tts_tpu_torch.kernels.qlinear import linear
from pocket_tts_tpu_torch.models import flow_mlp, transformer
from pocket_tts_tpu_torch.ops.norms import layer_norm
from pocket_tts_tpu_torch.ops.rope import rope_table


def _truncated_normal(generator: torch.Generator, bound: torch.Tensor,
                      shape: tuple[int, ...], device) -> torch.Tensor:
    """Standard normal truncated to [-bound, bound] (``bound`` broadcast over
    ``shape``): the inverse-CDF draw of ``torch.nn.init.trunc_normal_``, with
    per-row bounds, clipped at the bound (erfinv reaches +-inf at u = 0)."""
    hi = torch.erf(bound / math.sqrt(2.0))  # 2 * Phi(bound) - 1
    u = torch.rand(shape, generator=generator, device=device)
    x = torch.erfinv(hi * (2.0 * u - 1.0)) * math.sqrt(2.0)
    return torch.maximum(torch.minimum(x, bound), -bound)


def sample_noise(generator: torch.Generator, shape: tuple[int, ...], temp,
                 noise_clamp, device: torch.device | str,
                 clamped: str | None = None) -> torch.Tensor:
    """Gaussian noise with std sqrt(temp); with ``noise_clamp`` set, truncated
    to +-noise_clamp in absolute units (torch ``trunc_normal_(std=std, a=-c,
    b=c)`` semantics) and clipped at the bound.  temp 0 gives exactly zero.

    ``temp`` may be a per-slot [B] tensor (continuous batching).  With
    ``clamped="vec"``, ``noise_clamp`` is a per-slot [B] tensor: below 0 is
    unclamped, 0 is a hard zero (as the scalar ``noise_clamp=0.0``), above 0
    truncates; both draws are made and each slot takes its own."""
    if clamped != "vec" and not torch.is_tensor(temp):
        std = float(temp) ** 0.5
        if noise_clamp is None:
            return torch.randn(shape, generator=generator, device=device) * std
        bound = noise_clamp / max(std, 1e-12)
        noise = torch.empty(shape, device=device)
        torch.nn.init.trunc_normal_(noise, 0.0, 1.0, -bound, bound, generator=generator)
        return (noise * std).clamp(-noise_clamp, noise_clamp)
    std = torch.as_tensor(temp, dtype=torch.float32, device=device).sqrt()
    if std.dim() == 1:
        std = std[:, None]
    if clamped != "vec":  # per-slot temperatures, one scalar clamp
        if noise_clamp is None:
            return torch.randn(shape, generator=generator, device=device) * std
        noise_clamp = torch.full((shape[0],), float(noise_clamp), device=device)
    clamp = noise_clamp.to(device=device, dtype=torch.float32)[:, None]
    free = torch.randn(shape, generator=generator, device=device)
    bound = torch.where(clamp > 0, clamp, 1.0) / std.clamp_min(1e-12)
    trunc = _truncated_normal(generator, bound, shape, device)
    noise = torch.where(clamp > 0, trunc, free) * std
    hi = clamp.clamp_min(0.0)
    return torch.where(clamp >= 0, torch.maximum(torch.minimum(noise, hi), -hi), noise)


def embed_text(params: dict, tokens: torch.Tensor) -> torch.Tensor:
    """Token-LUT embedding."""
    return params["text_embed"][tokens.long()]


def prefill(params: dict, cfg: Config, k_cache: torch.Tensor, v_cache: torch.Tensor,
            pos: torch.Tensor, embeddings: torch.Tensor, t_valid: torch.Tensor,
            lora: dict | list | None = None, lora_w: torch.Tensor | None = None):
    """Feed conditioning embeddings [B, T, d_model] through the backbone,
    filling the KV cache in place.  Returns (k_cache, v_cache, new_pos).
    ``lora`` / ``lora_w``: the per-slot adapter bank
    (``transformer.cache_forward``)."""
    tcfg = cfg.flow_lm.transformer
    t = embeddings.shape[1]
    positions = pos[:, None] + torch.arange(t, dtype=pos.dtype, device=pos.device)[None, :]
    cos, sin = rope_table(positions, tcfg.head_dim, tcfg.max_period)
    _, k_cache, v_cache = transformer.cache_forward(
        params["tf"], tcfg.num_heads, k_cache, v_cache, pos, embeddings,
        cos[:, :, None, :], sin[:, :, None, :], t_valid=t_valid, lora=lora, lora_w=lora_w)
    return k_cache, v_cache, pos + t_valid.to(pos.dtype)


def step(params: dict, cfg: Config, k_cache: torch.Tensor, v_cache: torch.Tensor,
         pos: torch.Tensor, latent: torch.Tensor, noise: torch.Tensor,
         t_emb_table: torch.Tensor, lsd_decode_steps: int,
         lsd_vec: torch.Tensor | None = None, lora: dict | list | None = None,
         lora_w: torch.Tensor | None = None):
    """One autoregressive frame.  ``latent`` [B, ldim] is the previous latent
    (``bos_emb`` on the first step), ``noise`` [B, ldim] pre-sampled.
    Returns (next_latent, eos_logit [B], k_cache, v_cache, pos + 1); the cache
    is written in place.  The EOS decision (logit > threshold) is the caller's.

    ``lsd_vec`` ([B] int, batched serving): per-slot LSD step counts, with
    ``lsd_decode_steps`` their ceiling and ``t_emb_table`` [ceiling, B, dim];
    the flow decode is then ``flow_mlp.lsd_decode_masked``.  ``lora`` /
    ``lora_w``: the per-slot adapter bank (``transformer.cache_forward``)."""
    tcfg = cfg.flow_lm.transformer
    x = linear(latent, params["input_w"])[:, None, :]  # [B, 1, D]
    cos, sin = rope_table(pos[:, None], tcfg.head_dim, tcfg.max_period)
    y, k_cache, v_cache = transformer.cache_forward(
        params["tf"], tcfg.num_heads, k_cache, v_cache, pos, x,
        cos[:, :, None, :], sin[:, :, None, :], lora=lora, lora_w=lora_w)
    h = layer_norm(y[:, -1], params["out_norm_w"], params["out_norm_b"], eps=1e-5).float()
    eos_logit = h @ params["out_eos_w"][0] + params["out_eos_b"][0]
    cond_emb = flow_mlp.embed_condition(params["flow"], h)
    if lsd_vec is not None:
        next_latent = flow_mlp.lsd_decode_masked(params["flow"], cond_emb, t_emb_table, noise,
                                                 lsd_vec, lsd_decode_steps)
    else:
        next_latent = flow_mlp.lsd_decode(params["flow"], cond_emb, t_emb_table, noise,
                                          lsd_decode_steps)
    return next_latent, eos_logit, k_cache, v_cache, pos + 1


def denormalize(params: dict, latent: torch.Tensor) -> torch.Tensor:
    """latent * emb_std + emb_mean before the Mimi decoder."""
    return latent * params["emb_std"] + params["emb_mean"]


def speaker_project(params: dict, mimi_latent: torch.Tensor) -> torch.Tensor:
    """Mimi latents [B, T, 512] -> speaker conditioning [B, T, d_model], in
    float32 (``speaker_proj`` [d_model, 512] is kept in float32)."""
    return linear(mimi_latent, params["speaker_proj"])
