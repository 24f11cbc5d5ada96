"""Conditional flow network (SimpleMLPAdaLN) + LSD Euler integrator (port of
``pocket_tts_tpu/models/flow_mlp.py``).

The stacked ResBlock chain runs through ``kernels.flow_blocks`` (the Hopper
port of the Pallas kernel on CUDA, its plain version on the CPU); the input
projection, ``silu(y)``, the final AdaLN layer and the final linear stay
outside it, as in ``flow_step_pallas``.  The two timestep embedders depend
only on the LSD step schedule, so their sum is precomputed once as a
``[num_steps, dim]`` table.  Every other weight may be a ``QTensor``
(``kernels.qlinear``); the engine hands the chain its blocks dequantized.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from pocket_tts_tpu_torch.kernels.flow_blocks import flow_blocks
from pocket_tts_tpu_torch.kernels.qlinear import linear
from pocket_tts_tpu_torch.ops.norms import layer_norm, rms_norm_torchvar


def _timestep_embedding(p_te: dict, t: torch.Tensor, freq_size: int = 256) -> torch.Tensor:
    """p_te: one TimestepEmbedder's params; t: [...]-shaped scalar times."""
    half = freq_size // 2
    freqs = torch.exp(-math.log(10000.0)
                      * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    args = t.float()[..., None] * freqs
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    h = F.silu(linear(emb, p_te["w1"], p_te["b1"]))
    h = linear(h, p_te["w2"], p_te["b2"])
    return rms_norm_torchvar(h, p_te["alpha"], eps=1e-5)


def time_embedding_table(params: dict, num_steps: int) -> torch.Tensor:
    """[num_steps, dim] table of (TE_s(s_i) + TE_t(t_i)) / 2 for the LSD
    schedule s_i = i/N, t_i = (i+1)/N."""
    steps = torch.arange(num_steps, dtype=torch.float32, device=params["in_w"].device)
    s = steps / num_steps
    t = (steps + 1) / num_steps
    e_s = _timestep_embedding(params["time_embed_0"], s)
    e_t = _timestep_embedding(params["time_embed_1"], t)
    return (e_s + e_t) / 2.0


def time_embedding_tables(params: dict, max_steps: int) -> torch.Tensor:
    """[max_steps, max_steps, dim]: row L-1 is the L-step schedule's table,
    zero-padded beyond L.  Indexed per batch slot so requests with different
    ``lsd_decode_steps`` share one decode (the padded rows are the dt = 0
    steps of :func:`lsd_decode_masked`, so their values never matter)."""
    return torch.stack([F.pad(time_embedding_table(params, n), (0, 0, 0, max_steps - n))
                        for n in range(1, max_steps + 1)])


def embed_condition(params: dict, cond: torch.Tensor) -> torch.Tensor:
    """cond_embed: [.., cond_dim] -> [.., dim]."""
    return linear(cond, params["cond_w"], params["cond_b"])


def flow_step(params: dict, y: torch.Tensor, x: torch.Tensor, chain=flow_blocks) -> torch.Tensor:
    """One flow evaluation v = f(y, x): x [B, ldim], y [B, dim] (time + cond).
    ``chain`` runs the ResBlocks: the kernel's wrapper, or (under autograd,
    as the training loss) ``kernels.flow_blocks.flow_blocks_reference``."""
    h0 = linear(x, params["in_w"], params["in_b"])
    sy = F.silu(y)
    h = chain(sy.contiguous(), h0.contiguous(), params["blocks"])
    mod = linear(sy, params["final_ada_w"], params["final_ada_b"])
    shift, scale = mod.chunk(2, dim=-1)
    z = layer_norm(h, None, None, eps=1e-6)
    z = z * (1 + scale) + shift
    return linear(z, params["final_w"], params["final_b"])


def lsd_decode(params: dict, cond_emb: torch.Tensor, t_emb_table: torch.Tensor,
               noise: torch.Tensor, num_steps: int) -> torch.Tensor:
    """Euler-integrate the flow from ``noise``.

    cond_emb: [B, dim] (already cond_embed-projected); t_emb_table: [N, dim].
    """
    x = noise.float()
    for i in range(num_steps):
        y = t_emb_table[i] + cond_emb
        v = flow_step(params, y, x)
        x = x + v.float() / num_steps
    return x


def lsd_decode_masked(params: dict, cond_emb: torch.Tensor, t_emb_sb: torch.Tensor,
                      noise: torch.Tensor, steps_vec: torch.Tensor,
                      max_steps: int) -> torch.Tensor:
    """Per-slot step counts in one decode: every slot runs ``max_steps`` flow
    evaluations (each a ``flow_blocks`` call over the whole batch), but slot
    s integrates with dt = 1/steps[s] for its first steps[s] evaluations and
    dt = 0 afterwards, which equals :func:`lsd_decode` at steps[s].

    t_emb_sb: [max_steps, B, dim] per-slot time embeddings; steps_vec: [B]
    int, each in 1..max_steps."""
    x = noise.float()
    inv = 1.0 / steps_vec.float()
    for i in range(max_steps):
        y = t_emb_sb[i] + cond_emb
        v = flow_step(params, y, x)
        dt = torch.where(steps_vec > i, inv, 0.0)[:, None]
        x = x + v.float() * dt
    return x
