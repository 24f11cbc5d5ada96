"""Plain float32 reference of the Pocket TTS FlowLM with LiquidAI's
LFM2-8B-A1B as its backbone, and the seeded weights both sides of a run are
given (the benchmark's copy of ``reference_torch/lfm2_flowlm.py``, with the
interface ``harness/check.py`` and ``control.py`` call).

It imports nothing of the program under test.  No cache, no batching and no
kernels: the backbone runs its full causal forward pass over the whole
sequence (voice conditioning, text, every frame so far) once per frame.  The
flow net, the Mimi codec, the voice encoder, the wire and ``Numerics`` (the
control's lower precisions) are Pocket's, from ``reference/pocket_tts.py``.
Matrix products and convolutions run in float32 with TF32 off.

The backbone, after LFM2's published description (the model's config.json
and its Hugging Face modelling code), layer i of ``layer_types``::

    h   = x + mixer(rmsnorm(x; operator_norm))
    out = h + ffn(rmsnorm(h; ffn_norm))

* ``conv``: B, C, x' = in_proj(h); y = out_proj(C * conv(B * x')), conv
  causal and depthwise over ``conv_L_cache`` taps with zero history, no bias;
* ``full_attention``: q, k, v projections; RMSNorm over each head's q and k;
  RoPE (rotate-half pairs, base ``rope_theta``); causal softmax attention,
  query head j reading KV head j // (heads / kv heads); out_proj;
* ffn: SwiGLU w2(silu(w1 h) * w3 h) of ``intermediate_size`` in the first
  ``num_dense_layers`` layers; then a mixture of ``num_experts`` SwiGLU
  experts: scores = sigmoid(gate h), the top ``num_experts_per_tok`` of
  scores + expert_bias, weights = their scores / (their sum + 1e-6) times
  ``routed_scaling_factor``;
* rmsnorm(x; w) = x * rsqrt(mean(x^2) + norm_eps) * w; the stack ends in
  ``embedding_norm``, whose output goes to the flow net and the EOS head.

Departures from the published model: LFM2's token embedding and LM head are
not used (the FlowLM's text table, input projection, flow net and EOS head
take their place, at hidden size 2048); ``embedding_norm`` takes the place
of the FlowLM's ``out_norm``; RoPE positions count the FlowLM's sequence
(voice frames, text tokens, latent frames).  The experts are computed per
expert over the tokens routed to it (one host read of a layer's largest
count, to size the batch), which gives each token the same sum.
"""

from __future__ import annotations

import dataclasses
import math
import weakref

import numpy as np
import torch
import torch.nn.functional as F

from reference import pocket_tts as pocket
from reference.pocket_tts import F32, Numerics  # noqa: F401  (the harness reads them here)
from reference.pocket_tts import decode_audio, flow_latent, voice_conditioning, wire_pcm  # noqa: F401

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

NORM_EPS_TOPK = 1e-6  # in the denominator of the normalised top-k weights
EXPERT_BIAS = 0.05  # expert_bias is drawn uniform(+-EXPERT_BIAS)
# The short-conv mixers' and the experts' output projections are drawn at this
# share of their fan-in bound (a layer scale folded into the init, as LayerScale
# and Pocket's Mimi layer_scale start residual branches small).  At the full
# bound the random model's greedy latent loop is chaotic: the gated conv's
# recurrence over the last latents grows any difference ~1.3x a frame, and a
# rounding that flips one routing choice moves the next latent by ~10%, so
# every precision reads alike within ~20 frames.  At this scale a nudge of
# 1e-6 stays ~1e-6 over 25 frames, as in Pocket's own random model.
BRANCH_SCALE = 0.05


@dataclasses.dataclass(frozen=True)
class Sizes(pocket.Sizes):
    """Pocket's sizes (``d_model`` = hidden_size, ``heads``, ``layers``,
    ``ff`` = the dense FFN's width, ``max_period`` = rope_theta) and the
    backbone's own."""

    kv_heads: int = 0
    layer_types: tuple = ()
    taps: int = 3
    expert_ff: int = 0
    experts: int = 0
    topk: int = 0
    dense_layers: int = 0
    norm_eps: float = 1e-5
    norm_topk: bool = True
    scale: float = 1.0

    @property
    def head_dim(self) -> int:
        return self.d_model // self.heads

    @property
    def conv_layers(self) -> list[int]:
        return [i for i, t in enumerate(self.layer_types) if t == "conv"]

    @property
    def attn_layers(self) -> list[int]:
        return [i for i, t in enumerate(self.layer_types) if t == "full_attention"]


def sizes(cfg: dict) -> Sizes:
    """From a configuration file: the backbone's keys at its top level (the
    model's config.json), the flow net, text table and codec under
    ``flow_lm`` / ``mimi``."""
    fl, mi = cfg["flow_lm"], cfg["mimi"]
    mt = mi["transformer"]
    return Sizes(
        d_model=cfg["hidden_size"], heads=cfg["num_attention_heads"],
        layers=cfg["num_hidden_layers"], ff=cfg["intermediate_size"],
        max_period=float(cfg["rope_theta"]), flow_dim=fl["flow"]["dim"],
        flow_depth=fl["flow"]["depth"], n_bins=fl["lookup_table"]["n_bins"],
        ldim=mi["quantizer"]["dimension"], mimi_dim=mt["d_model"], mimi_heads=mt["num_heads"],
        mimi_layers=mt["num_layers"], mimi_ff=mt["dim_feedforward"], mimi_context=mt["context"],
        mimi_layer_scale=mt["layer_scale"], mimi_max_period=float(mt["max_period"]),
        seanet=mi["seanet"], sample_rate=mi["sample_rate"], frame_rate=mi["frame_rate"],
        kv_heads=cfg["num_key_value_heads"], layer_types=tuple(cfg["layer_types"]),
        taps=cfg["conv_L_cache"], expert_ff=cfg["moe_intermediate_size"],
        experts=cfg["num_experts"], topk=cfg["num_experts_per_tok"],
        dense_layers=cfg["num_dense_layers"], norm_eps=float(cfg["norm_eps"]),
        norm_topk=bool(cfg["norm_topk_prob"]), scale=float(cfg["routed_scaling_factor"]))


# ---------------------------------------------------------------------------
# seeded weights
# ---------------------------------------------------------------------------


def _leaves(s: Sizes) -> list[tuple[str, tuple, str, float]]:
    """(path, shape, init, bound) of every weight in the program's tree
    layout (``params["flow_lm"]["lfm"]`` stacked by layer kind): Pocket's
    leaves without its transformer and out_norm, and the backbone's."""
    out = [leaf for leaf in pocket._leaves(s)
           if not leaf[0].startswith(("flow_lm/tf/", "flow_lm/out_norm_"))]
    d, hd, kv = s.d_model, s.head_dim, s.kv_heads * s.head_dim
    lc, la, lm = len(s.conv_layers), len(s.attn_layers), s.layers - s.dense_layers
    ld, f, e = s.dense_layers, s.expert_ff, s.experts
    p = "flow_lm/lfm"
    out += [(f"{p}/op_norm", (s.layers, d), "c", 1.0), (f"{p}/ffn_norm", (s.layers, d), "c", 1.0),
            (f"{p}/conv_in", (lc, 3 * d, d), "u", d ** -0.5),
            (f"{p}/conv_w", (lc, d, s.taps), "u", s.taps ** -0.5),
            (f"{p}/conv_out", (lc, d, d), "u", BRANCH_SCALE * d ** -0.5),
            (f"{p}/qkv", (la, d + 2 * kv, d), "u", d ** -0.5),
            (f"{p}/qk_norm", (la, s.heads + s.kv_heads, hd), "c", 1.0),
            (f"{p}/attn_out", (la, d, d), "u", d ** -0.5),
            (f"{p}/ff_up", (ld, 2 * s.ff, d), "u", d ** -0.5),
            (f"{p}/ff_down", (ld, d, s.ff), "u", s.ff ** -0.5),
            (f"{p}/router", (lm, e, d), "u", d ** -0.5),
            (f"{p}/expert_bias", (lm, e), "u", EXPERT_BIAS),
            (f"{p}/experts_up", (lm, e, 2 * f, d), "u", d ** -0.5),
            (f"{p}/experts_down", (lm, e, d, f), "u", BRANCH_SCALE * f ** -0.5),
            (f"{p}/final_norm", (d,), "c", 1.0)]
    return out


def make_weights(cfg: dict, seed: int, device) -> dict:
    """Seeded float32 weights in the program's tree layout, made on
    ``device`` in one buffer (each leaf a 64-element-aligned view of it),
    filled leaf by leaf from one generator: uniform(+-bound), standard
    normal or a constant (the bounds of ``_leaves``: 1/sqrt(fan_in), the
    conv and expert output projections at ``BRANCH_SCALE`` of it).
    Nothing larger than the weights is allocated (8.2 billion float32
    values at the published widths).  The same seed gives
    the same weights on the same device."""
    s = sizes(cfg)
    leaves = _leaves(s)
    offsets, total = [], 0
    for _, shape, _, _ in leaves:
        offsets.append(total)
        total += -(-int(np.prod(shape)) // 64) * 64
    gen = torch.Generator(device=device).manual_seed(int(seed) % (2 ** 63))
    buf = torch.empty(total, device=device)
    tree: dict = {}
    for (path, shape, init, bound), off in zip(leaves, offsets):
        leaf = buf[off:off + int(np.prod(shape))]
        if init == "u":
            leaf.uniform_(-bound, bound, generator=gen)
        elif init == "n":
            leaf.normal_(generator=gen)
        else:
            leaf.fill_(bound)
        pocket._insert(tree, path, leaf.view(shape))
    return pocket._listify(tree)


# ---------------------------------------------------------------------------
# the backbone
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w


def rope_half(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotate-half RoPE of x [T, H, D] at ``positions`` [T]."""
    half = x.shape[-1] // 2
    inv = theta ** (-torch.arange(half, dtype=torch.float32, device=x.device) / half)
    ang = positions.float()[:, None] * inv
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


# id of an expert bank -> {(layer, kind): that layer's bank rounded to kind},
# dropped with the bank
_ROUNDED: dict[int, dict] = {}


def _rounded_bank(nx, bank: torch.Tensor, m: int) -> torch.Tensor:
    """Layer m of an expert bank [layers, E, out, in] rounded as the
    backbone's products round their weights, once per bank and precision:
    the weights do not change from frame to frame, and rounding a layer's
    705 MB to float8 every frame would be most of the control's time."""
    k = nx.backbone
    if k == "float32":
        return bank[m]
    if id(bank) not in _ROUNDED:
        _ROUNDED[id(bank)] = {}
        weakref.finalize(bank, _ROUNDED.pop, id(bank), None)
    per = _ROUNDED[id(bank)]
    if (m, k) not in per:
        per[(m, k)] = nx.round(bank[m], k)
    return per[(m, k)]


def _blin(nx, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Batched backbone product x [E, n, in] @ w [E, out, in]^T, w already
    rounded (``_rounded_bank``), rounded as ``Numerics.lin`` rounds one."""
    k = nx.backbone
    y = torch.bmm(nx.round(x, k), w.transpose(1, 2))
    return nx.round(y, k) if k != "float8" else nx.round(y, "bfloat16")


def moe(p: dict, m: int, s: Sizes, h: torch.Tensor, nx) -> torch.Tensor:
    """MoE layer ``m`` over tokens h [T, D]: each expert over the tokens
    routed to it, batched over experts (padded to the largest count)."""
    t, d = h.shape
    scores = torch.sigmoid(nx.lin(h, p["router"][m]))
    ids = (scores + p["expert_bias"][m]).topk(s.topk, dim=-1).indices  # [T, k]
    w = scores.gather(-1, ids)
    if s.norm_topk:
        w = w / (w.sum(-1, keepdim=True) + NORM_EPS_TOPK)
    w = w * s.scale
    flat = ids.flatten()
    order = torch.argsort(flat, stable=True)
    counts = torch.bincount(flat, minlength=s.experts)
    cap = int(counts.max())
    e_sorted = flat[order]
    rank = torch.arange(t * s.topk, device=h.device) - (torch.cumsum(counts, 0) - counts)[e_sorted]
    tok = order // s.topk
    xs = h.new_zeros((s.experts, cap, d))
    xs[e_sorted, rank] = h[tok]
    hu = _blin(nx, xs, _rounded_bank(nx, p["experts_up"], m))
    act = F.silu(hu[..., :s.expert_ff]) * hu[..., s.expert_ff:]
    ys = _blin(nx, act, _rounded_bank(nx, p["experts_down"], m))
    out = torch.zeros_like(h)
    return out.index_add_(0, tok, ys[e_sorted, rank] * w.flatten()[order, None])


def backbone(p: dict, s: Sizes, x: torch.Tensor, nx=F32, kv: str = "float32") -> torch.Tensor:
    """The layer stack's full causal pass over x [T, D] from position 0 ->
    [T, D], ``embedding_norm`` applied.  Keys and values are rounded to
    ``kv`` where the program stores them."""
    t, d = x.shape
    hq, hkv, hd = s.heads, s.kv_heads, s.head_dim
    pos = torch.arange(t, device=x.device)
    causal = pos[:, None] >= pos[None, :]
    conv_i = {li: c for c, li in enumerate(s.conv_layers)}
    attn_i = {li: a for a, li in enumerate(s.attn_layers)}
    for i in range(s.layers):
        h = rms_norm(x, p["op_norm"][i], s.norm_eps)
        if i in conv_i:
            c = conv_i[i]
            bg, cg, xx = nx.lin(h, p["conv_in"][c], part="backbone").chunk(3, dim=-1)
            bx = (bg * xx).T[None]  # [1, D, T]
            conv = F.conv1d(bx, p["conv_w"][c][:, None, :], padding=s.taps - 1, groups=d)
            y = cg * conv[0, :, :t].T
            x = x + nx.lin(y, p["conv_out"][c], part="backbone")
        else:
            a = attn_i[i]
            wq, wk, wv = p["qkv"][a].split([d, hkv * hd, hkv * hd])
            q = rms_norm(nx.lin(h, wq, part="backbone").view(t, hq, hd), p["qk_norm"][a][0],
                         s.norm_eps)
            k = rms_norm(nx.lin(h, wk, part="backbone").view(t, hkv, hd), p["qk_norm"][a][hq],
                         s.norm_eps)
            v = nx.lin(h, wv, part="backbone").view(t, hkv, hd)
            q, k = rope_half(q, pos, s.max_period), rope_half(k, pos, s.max_period)
            k, v = nx.round(k, kv), nx.round(v, kv)
            k, v = k.repeat_interleave(hq // hkv, dim=1), v.repeat_interleave(hq // hkv, dim=1)
            scores = torch.einsum("thd,shd->hts", q, k) / math.sqrt(hd)
            probs = torch.softmax(scores.masked_fill(~causal, float("-inf")), dim=-1)
            att = torch.einsum("hts,shd->thd", probs, v).reshape(t, d)
            x = x + nx.lin(att, p["attn_out"][a], part="backbone")
        h = rms_norm(x, p["ffn_norm"][i], s.norm_eps)
        if i < s.dense_layers:
            gate, up = nx.lin(h, p["ff_up"][i], part="backbone").chunk(2, dim=-1)
            x = x + nx.lin(F.silu(gate) * up, p["ff_down"][i], part="backbone")
        else:
            x = x + moe(p, i - s.dense_layers, s, h, nx)
    return rms_norm(x, p["final_norm"], s.norm_eps)


# ---------------------------------------------------------------------------
# the frame loop
# ---------------------------------------------------------------------------


def latents(w: dict, s: Sizes, cond: torch.Tensor, tokens: list[int], n_frames: int,
            nx=F32, kv: str = "float32", steps: int = 1) -> torch.Tensor:
    """Greedy (temperature 0) latents [n_frames, ldim]: the backbone's full
    causal pass over [voice conditioning; text embeddings; the input
    projection of BOS and of each latent so far], once per frame."""
    fl = w["flow_lm"]
    dev = cond.device
    seq = [cond, fl["text_embed"][torch.as_tensor(tokens, device=dev)]]
    latent = fl["bos_emb"][None]
    out = []
    for _ in range(n_frames):
        seq.append(nx.lin(latent, fl["input_w"], part="backbone"))
        h = backbone(fl["lfm"], s, torch.cat(seq), nx, kv)[-1:]
        latent = flow_latent(fl["flow"], h, torch.zeros_like(latent), steps, nx)
        out.append(latent[0])
    return torch.stack(out)
