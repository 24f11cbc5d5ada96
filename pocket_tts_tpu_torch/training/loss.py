"""Flow-matching fine-tune objective for the FlowLM (port of
``pocket_tts_tpu/training/loss.py``).

Three per-frame masked terms, as in the JAX package:

* **Flow matching** at the zero-width limit t = s on the rectified-flow
  interpolant ``x_s = (1 - s) eps + s x1`` with target velocity ``x1 - eps``
  (the field ``flow_mlp.lsd_decode`` Euler-integrates).
* **LSD self-consistency** (opt-in, ``consistency_weight``): the two-time
  head's jump [s, t] against two detached half-jumps through the midpoint.
* **EOS**: binary cross-entropy on the stop logit, 0 while frames remain and 1
  at the position after the final frame.

Teacher forcing runs the backbone once over the packed sequence
``[conditioning, BOS latent, latents...]`` (``transformer.batch_forward``,
causal from position 0).  The flow net runs through the plain, differentiable
ResBlock chain (``flow_blocks_reference``) on every device: the CUDA kernel
has no backward, as the JAX loss calls the plain ``flow_step``.

Noise: ``jax.random`` draws cannot be reproduced in torch, so the loss takes
pre-sampled ``draws`` (``eps``, ``s``, and with consistency ``eps2``, ``s2``,
``u2``) or draws them, in that order, from a ``torch.Generator``.
"""

from __future__ import annotations

import numpy as np
import torch

from pocket_tts_tpu_torch.config import Config, refuse_hybrid
from pocket_tts_tpu_torch.kernels.flow_blocks import flow_blocks_reference
from pocket_tts_tpu_torch.models import flow_mlp, transformer
from pocket_tts_tpu_torch.models.flow_lm import embed_text, speaker_project
from pocket_tts_tpu_torch.ops.norms import layer_norm
from pocket_tts_tpu_torch.ops.qtensor import mat
from pocket_tts_tpu_torch.ops.rope import rope_table
from pocket_tts_tpu_torch.parallel.mesh import Sharded, group_view, reduce_sum, replicas


def _two_time_embedding(flow_params: dict, s: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(TE_s(s) + TE_t(t)) / 2 for [..]-shaped times (the dynamic-time
    counterpart of ``flow_mlp.time_embedding_table``)."""
    e_s = flow_mlp._timestep_embedding(flow_params["time_embed_0"], s)
    e_t = flow_mlp._timestep_embedding(flow_params["time_embed_1"], t)
    return (e_s + e_t) / 2.0


def _flow(flow_params: dict, y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``flow_step`` over [B, Tf, .] inputs, flattened to rows, through the
    plain chain."""
    b, tf = x.shape[:2]
    v = flow_mlp.flow_step(flow_params, y.reshape(b * tf, -1), x.reshape(b * tf, -1),
                           chain=flow_blocks_reference)
    return v.reshape(b, tf, -1)


def _pack_cond_and_latents(params: dict, cond_emb: torch.Tensor, cond_valid: torch.Tensor,
                           latents: torch.Tensor) -> torch.Tensor:
    """Per-example packed input [B, Tc+Tf+1, D]: conditioning, the BOS
    latent, then latents[0..Tf-1], all padding at the tail.  Each row is
    re-packed with a gather (position j reads cond[j] while j < cond_valid,
    then latent input j - cond_valid), so no padded key sits before a valid
    query."""
    b, tc, d = cond_emb.shape
    tf = latents.shape[1]
    w_in = mat(params["input_w"])
    bos = params["bos_emb"].float()[None, None, :].expand(b, 1, latents.shape[2])
    lat_in = torch.cat([bos, latents.float()], dim=1)
    x_lat = torch.einsum("btl,dl->btd", lat_in.to(w_in.dtype), w_in)
    src = torch.cat([cond_emb.to(x_lat.dtype), x_lat], dim=1)  # [B, Tc+Tf+1, D]
    s_len = tc + tf + 1
    j = torch.arange(s_len, device=src.device)[None, :]
    cv = cond_valid.long()[:, None]
    idx = torch.where(j < cv, j, (tc + j - cv).clamp(0, s_len - 1))
    return torch.gather(src, 1, idx[:, :, None].expand(b, s_len, d))


def teacher_forced_conditioning(params: dict, cfg: Config, cond_emb: torch.Tensor,
                                cond_valid: torch.Tensor, latents: torch.Tensor) -> torch.Tensor:
    """One causal pass over the packed sequence; the backbone outputs at the
    frame positions [B, Tf+1, D] float32, after ``out_norm``.  Index i < Tf
    conditions frame i; index Tf is the stop position."""
    tcfg = cfg.flow_lm.transformer
    x = _pack_cond_and_latents(params, cond_emb, cond_valid, latents)
    b, s_len, _ = x.shape
    tf = latents.shape[1]
    positions = torch.arange(s_len, device=x.device)[None, :].expand(b, s_len)
    cos, sin = rope_table(positions, tcfg.head_dim, tcfg.max_period)
    y = transformer.batch_forward(params["tf"], tcfg.num_heads, None, x,
                                  cos[:, :, None, :], sin[:, :, None, :])
    h = layer_norm(y, params["out_norm_w"], params["out_norm_b"], eps=1e-5)
    frame_idx = cond_valid.long()[:, None] + torch.arange(tf + 1, device=x.device)[None, :]
    h_frames = torch.gather(h, 1, frame_idx[:, :, None].expand(b, tf + 1, h.shape[-1]))
    return h_frames.float()


def build_conditioning(params: dict, tokens: torch.Tensor, token_valid: torch.Tensor,
                       voice_latents: torch.Tensor | None = None
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Conditioning as inference builds it: optional speaker-projected voice
    frames [B, Tv, 512] (one length across the batch), then the text
    embeddings (right-padded per example).  Returns (embeddings, valid)."""
    text = embed_text(params, tokens)
    if voice_latents is None:
        return text, token_valid.long()
    voice = speaker_project(params, voice_latents.float())
    cond = torch.cat([voice.to(text.dtype), text], dim=1)
    return cond, voice.shape[1] + token_valid.long()


def sample_draws(generator: torch.Generator, b: int, tf: int, ldim: int,
                 device: torch.device, consistency: bool = False) -> dict:
    """The loss's noise: ``eps`` [B, Tf, ldim] standard normal and ``s``
    [B, Tf] uniform, then (``consistency``) ``eps2``, ``s2``, ``u2``."""
    names = ("eps", "s", "eps2", "s2", "u2") if consistency else ("eps", "s")
    out = {}
    for name in names:
        if name.startswith("eps"):
            out[name] = torch.randn((b, tf, ldim), generator=generator, device=device)
        else:
            out[name] = torch.rand((b, tf), generator=generator, device=device)
    return out


def _tensor(v, dev: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """A batch or draw value (numpy array or tensor) on ``dev`` as ``dtype``."""
    t = v if torch.is_tensor(v) else torch.from_numpy(np.array(v))
    return t.to(device=dev, dtype=dtype)


def _group_terms(params: dict, cfg: Config, batch: dict, draws: dict,
                 consistency: bool) -> dict:
    """The numerator and denominator of each masked mean (``flow_mse``,
    ``eos_bce``, with ``consistency`` also ``consistency``) over one dp
    group's lanes, on the group's lead device."""
    dev = params["out_eos_w"].device

    def get(name, dtype):
        return _tensor(batch[name], dev, dtype)

    latents = get("latents", torch.float32)
    tf = latents.shape[1]
    fv = get("latent_valid", torch.long)
    voice = get("voice_latents", torch.float32) if "voice_latents" in batch else None
    cond_emb, cond_valid = build_conditioning(params, get("tokens", torch.long),
                                              get("token_valid", torch.long), voice)
    h_frames = teacher_forced_conditioning(params, cfg, cond_emb, cond_valid, latents)

    # EOS: the logit at index i stops generation of frame i
    eos_logits = h_frames @ params["out_eos_w"][0] + params["out_eos_b"][0]  # [B, Tf+1]
    i = torch.arange(tf + 1, device=dev)[None, :]
    eos_target = (i == fv[:, None]).float()
    eos_mask = (i <= fv[:, None]).float()
    bce = (eos_logits.clamp_min(0) - eos_logits * eos_target
           + torch.log1p(torch.exp(-eos_logits.abs())))
    terms = {"eos_bce": ((bce * eos_mask).sum(), eos_mask.sum())}

    # flow matching at t = s
    flow = params["flow"]
    cond_flow = flow_mlp.embed_condition(flow, h_frames[:, :tf])  # [B, Tf, dim]
    frame_mask = (torch.arange(tf, device=dev)[None, :] < fv[:, None]).float()
    d = {k: _tensor(v, dev, torch.float32) for k, v in draws.items()}
    eps, s = d["eps"], d["s"]
    x_s = (1.0 - s[..., None]) * eps + s[..., None] * latents
    v_target = latents - eps
    v = _flow(flow, _two_time_embedding(flow, s, s) + cond_flow, x_s)
    terms["flow_mse"] = (((v.float() - v_target).square().mean(dim=-1) * frame_mask).sum(),
                         frame_mask.sum())

    # LSD self-consistency over a finite jump (opt-in)
    if consistency:
        eps2, s2 = d["eps2"], d["s2"]
        t2 = s2 + (1.0 - s2) * d["u2"]
        m = (s2 + t2) / 2.0
        x_s2 = (1.0 - s2[..., None]) * eps2 + s2[..., None] * latents
        # teacher: two detached half-jumps through the midpoint
        v1 = _flow(flow, _two_time_embedding(flow, s2, m) + cond_flow, x_s2)
        x_m = x_s2 + (m - s2)[..., None] * v1.float()
        v2 = _flow(flow, _two_time_embedding(flow, m, t2) + cond_flow, x_m)
        v_teach = ((v1.float() + v2.float()) / 2.0).detach()
        v_stu = _flow(flow, _two_time_embedding(flow, s2, t2) + cond_flow, x_s2)
        terms["consistency"] = (((v_stu.float() - v_teach).square().mean(dim=-1)
                                 * frame_mask).sum(), frame_mask.sum())
    return terms


def _groups(params: dict, batch: dict) -> tuple[list[dict], list[dict]]:
    """(each dp group's params, each group's batch): on a mesh (params placed
    by ``mesh.shard_trainable`` or ``shard_params``) the groups' views, every
    group's replicas built from the masters, and the batch split by
    ``trainer.shard_batch`` unless it is placed already; else the one group."""
    leaf = params["out_eos_w"]
    if not isinstance(leaf, Sharded):
        return [params], [batch]
    mesh = leaf.mesh
    if not isinstance(batch["latents"], Sharded):
        from pocket_tts_tpu_torch.training.trainer import shard_batch

        batch = shard_batch(batch, mesh)
    full = replicas(params)
    dp = mesh.shape["dp"]
    return [group_view(full, g) for g in range(dp)], [group_view(batch, g) for g in range(dp)]


def flow_matching_loss(params: dict, cfg: Config, batch: dict,
                       generator: torch.Generator | None = None, *, draws: dict | None = None,
                       eos_weight: float = 1.0, consistency_weight: float = 0.0
                       ) -> tuple[torch.Tensor, dict]:
    """Total loss and metrics (``flow_mse``, ``eos_bce``, ``consistency``
    when on, ``loss``) for one batch on the params' device, or on a mesh.

    ``batch``: tokens [B, Tt] int, token_valid [B], latents [B, Tf, ldim]
    (normalized, ``data.encode_latent_targets``), latent_valid [B], optional
    voice_latents [B, Tv, 512]; numpy arrays or tensors, or placed by
    ``trainer.shard_batch``.  ``draws``: the pre-sampled noise
    (:func:`sample_draws`' names); else it is drawn from ``generator``.

    On a mesh each dp group runs its lanes through the backbone split over
    its tp ranks; the noise is one draw for the whole batch on the lead
    device, split by group (the one-device draws), and each term is a
    masked mean over the whole batch: the groups' numerators and
    denominators are added on the lead in group order (``mesh.reduce_sum``),
    then divided once."""
    refuse_hybrid(cfg, "training")
    views, batches = _groups(params, batch)
    dev = views[0]["out_eos_w"].device
    lanes = [batch_["latents"].shape[0] for batch_ in batches]
    _, tf, ldim = batches[0]["latents"].shape
    consistency = consistency_weight > 0.0
    if draws is None:
        draws = sample_draws(generator, sum(lanes), tf, ldim, dev, consistency)
    draws = {k: _tensor(v, dev, torch.float32) for k, v in draws.items()}
    parts, lo = [], 0
    for view, batch_, n in zip(views, batches, lanes):
        d = {k: v[lo:lo + n] for k, v in draws.items()}
        parts.append(_group_terms(view, cfg, batch_, d, consistency))
        lo += n

    def mean(name: str) -> torch.Tensor:
        num = reduce_sum([p[name][0] for p in parts], dev)
        return num / reduce_sum([p[name][1] for p in parts], dev).clamp_min(1.0)

    flow_loss, eos_loss = mean("flow_mse"), mean("eos_bce")
    metrics = {"flow_mse": flow_loss, "eos_bce": eos_loss}
    total = flow_loss + eos_weight * eos_loss
    if consistency:
        cons = mean("consistency")
        metrics["consistency"] = cons
        total = total + consistency_weight * cons
    metrics["loss"] = total
    return total, metrics
