"""Plain float32 reference of the Pocket TTS FlowLM with LiquidAI's
LFM2-MoE (LFM2-8B-A1B) as its backbone: the whole FlowLM's forward pass in
plain ``torch`` (the layer stack, ``embedding_norm``, the EOS head, the
SimpleMLPAdaLN flow net's LSD decode), with no cache, no kernels and no
batching.  It imports neither JAX nor any module of ``pocket_tts_tpu`` or
``pocket_tts_tpu_torch``; the port's tests hold the port against it on the
CPU, and ``benchmark/reference/lfm2_flowlm.py`` is its copy for the
benchmark (the same backbone, with the harness's interface and Pocket's
codec).

Weights are the port's parameter tree (``params["flow_lm"]``, the backbone
under ``"lfm"`` stacked by layer kind: ``op_norm``, ``ffn_norm``,
``conv_in``, ``conv_w``, ``conv_out``, ``qkv`` (q, k, v rows), ``qk_norm``
(row 0: q's weight, row ``heads``: k's), ``attn_out``, ``ff_up`` (w1 rows,
w3 rows), ``ff_down``, ``router``, ``expert_bias``, ``experts_up`` (per
expert w1 rows, w3 rows), ``experts_down``, ``final_norm``), read as
plain tensors.

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
take their place); ``embedding_norm`` takes the place of the FlowLM's
``out_norm``; RoPE positions count the FlowLM's sequence (voice frames,
text tokens, latent frames); the RMSNorm form, rotate-half RoPE and the 1e-6
of the normalised weights are inferred, not read from the source.  The
experts are computed per expert over the tokens routed to it (one host read
of a layer's largest count, to size the batch), which gives each token the
same sum.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

NORM_EPS_TOPK = 1e-6  # in the denominator of the normalised top-k weights


class _F32:
    """Float32 throughout: the products as they are (the benchmark's copy
    takes Pocket's ``Numerics`` here, for its control's lower precisions)."""

    backbone = "float32"

    @staticmethod
    def round(x, kind):
        return x

    @staticmethod
    def lin(x, w, b=None, part="rest"):
        y = x @ w.T
        return y if b is None else y + b


F32 = _F32()


@dataclasses.dataclass(frozen=True)
class Sizes:
    """The backbone's settings (the model's config.json names in
    :func:`sizes`)."""

    d_model: int
    heads: int
    kv_heads: int
    layers: int
    layer_types: tuple
    taps: int
    ff: int
    expert_ff: int
    experts: int
    topk: int
    dense_layers: int
    norm_eps: float
    norm_topk: bool
    scale: float
    max_period: float

    @property
    def head_dim(self) -> int:
        return self.d_model // self.heads

    @property
    def conv_layers(self) -> list[int]:
        return [i for i, t in enumerate(self.layer_types) if t == "conv"]

    @property
    def attn_layers(self) -> list[int]:
        return [i for i, t in enumerate(self.layer_types) if t == "full_attention"]


def sizes(c: dict) -> Sizes:
    """From the model's config.json keys."""
    return Sizes(d_model=c["hidden_size"], heads=c["num_attention_heads"],
                 kv_heads=c["num_key_value_heads"], layers=c["num_hidden_layers"],
                 layer_types=tuple(c["layer_types"]), taps=c["conv_L_cache"],
                 ff=c["intermediate_size"], expert_ff=c["moe_intermediate_size"],
                 experts=c["num_experts"], topk=c["num_experts_per_tok"],
                 dense_layers=c["num_dense_layers"], norm_eps=float(c["norm_eps"]),
                 norm_topk=bool(c["norm_topk_prob"]),
                 scale=float(c["routed_scaling_factor"]), max_period=float(c["rope_theta"]))


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


def _blin(nx, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Batched backbone product x [E, n, in] @ w [E, out, in]^T, rounded as
    ``Numerics.lin`` rounds one."""
    k = nx.backbone
    y = torch.bmm(nx.round(x, k), nx.round(w, k).transpose(1, 2))
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
    hu = _blin(nx, xs, p["experts_up"][m])
    act = F.silu(hu[..., :s.expert_ff]) * hu[..., s.expert_ff:]
    ys = _blin(nx, act, p["experts_down"][m])
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
# the FlowLM around it: EOS head and flow net
# ---------------------------------------------------------------------------


def flowlm(fl: dict, s: Sizes, seq: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(conditioning h [T, D] after ``embedding_norm``, EOS logits [T]) at
    every position of the input sequence ``seq`` [T, D]."""
    h = backbone(fl["lfm"], s, seq)
    return h, h @ fl["out_eos_w"][0] + fl["out_eos_b"][0]


def _layer_norm(x, w=None, b=None, eps=1e-5):
    mean = x.mean(-1, keepdim=True)
    y = (x - mean) * torch.rsqrt((x - mean).square().mean(-1, keepdim=True) + eps)
    return y if w is None else y * w + b


def _time_embed(p: dict, t: torch.Tensor) -> torch.Tensor:
    freqs = torch.exp(-math.log(10000.0) * torch.arange(128, dtype=torch.float32,
                                                        device=t.device) / 128)
    args = t[..., None] * freqs
    h = F.silu(torch.cat([torch.cos(args), torch.sin(args)], dim=-1) @ p["w1"].T + p["b1"])
    h = h @ p["w2"].T + p["b2"]
    return h * p["alpha"] * torch.rsqrt(1e-5 + h.var(dim=-1, keepdim=True, unbiased=True))


def flow_latent(fp: dict, h: torch.Tensor, noise: torch.Tensor, steps: int) -> torch.Tensor:
    """LSD Euler decode of the next latent from the conditioning h [B, D]
    (Pocket's SimpleMLPAdaLN flow net)."""
    dim = fp["in_w"].shape[0]
    cond = h @ fp["cond_w"].T + fp["cond_b"]
    i = torch.arange(steps, dtype=torch.float32, device=h.device)
    table = (_time_embed(fp["time_embed_0"], i / steps)
             + _time_embed(fp["time_embed_1"], (i + 1) / steps)) / 2.0
    x, blocks = noise, fp["blocks"]
    for st in range(steps):
        sy = F.silu(table[st] + cond)
        z0 = x @ fp["in_w"].T + fp["in_b"]
        for j in range(blocks["ada_w"].shape[0]):
            shift, scale, gate = (sy @ blocks["ada_w"][j].T + blocks["ada_b"][j]).split(dim, -1)
            z = _layer_norm(z0, blocks["ln_w"][j], blocks["ln_b"][j], eps=1e-6)
            z = F.silu((z * (1 + scale) + shift) @ blocks["mlp1_w"][j].T + blocks["mlp1_b"][j])
            z0 = z0 + gate * (z @ blocks["mlp2_w"][j].T + blocks["mlp2_b"][j])
        shift, scale = (sy @ fp["final_ada_w"].T + fp["final_ada_b"]).chunk(2, dim=-1)
        z = _layer_norm(z0, eps=1e-6) * (1 + scale) + shift
        x = x + (z @ fp["final_w"].T + fp["final_b"]) / steps
    return x


def latents(fl: dict, s: Sizes, cond: torch.Tensor, tokens: list[int], n_frames: int,
            steps: int = 1) -> tuple[torch.Tensor, torch.Tensor]:
    """Greedy (temperature 0) generation: (latents [n_frames, ldim], the
    conditioning h [n_frames, D] each was decoded from), the full causal pass
    over [voice conditioning; text embeddings; the input projection of BOS
    and of each latent so far] once per frame."""
    seq = [cond, fl["text_embed"][torch.as_tensor(tokens, device=cond.device).long()]]
    latent = fl["bos_emb"][None]
    out, hs = [], []
    for _ in range(n_frames):
        seq.append(latent @ fl["input_w"].T)
        h = flowlm(fl, s, torch.cat(seq))[0][-1:]
        latent = flow_latent(fl["flow"], h, torch.zeros_like(latent), steps)
        out.append(latent[0])
        hs.append(h[0])
    return torch.stack(out), torch.stack(hs)
