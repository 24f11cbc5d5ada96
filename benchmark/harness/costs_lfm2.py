"""Operations and bytes of a frame with LFM2-MoE as the FlowLM backbone
(``reference/lfm2_flowlm.py``'s ``Sizes``), against the peaks of
``costs.py``."""

from __future__ import annotations

from harness.costs import PEAKS, codec_attention_flops, codec_linear_flops, flow_flops  # noqa: F401


def backbone_linear_flops(s) -> int:
    """The backbone's products for one position (2 FLOP a weight): each conv
    layer's in_proj (3D x D) and out_proj and its depthwise taps, each
    attention layer's q/k/v/out projections, the dense layers' SwiGLU, the
    MoE layers' router and their k chosen experts; the input projection and
    the EOS head."""
    d, kv = s.d_model, s.kv_heads * s.head_dim
    conv = 2 * (3 * d * d + d * d + d * s.taps)
    attn = 2 * (d * (d + 2 * kv) + d * d)
    dense = 2 * 3 * d * s.ff
    moe = 2 * (d * s.experts + s.topk * 3 * d * s.expert_ff)
    n_moe = s.layers - s.dense_layers
    return (len(s.conv_layers) * conv + len(s.attn_layers) * attn + s.dense_layers * dense
            + n_moe * moe + 2 * d * s.ldim + 2 * d)


def backbone_attention_flops(s, pos: float) -> float:
    """Causal attention of one query at ``pos`` over its pos + 1 keys in each
    attention layer: QK and PV, every query head."""
    return len(s.attn_layers) * 4.0 * (pos + 1) * s.heads * s.head_dim


def lane_frame_flops(s, pos: float, steps: int) -> float:
    """Model FLOPs of one lane-frame at cache position ``pos``."""
    return (backbone_linear_flops(s) + backbone_attention_flops(s, pos) + flow_flops(s, steps)
            + codec_linear_flops(s) + codec_attention_flops(s))


def moe_one_token_bytes(s) -> tuple[int, int]:
    """(up, down) bytes of one MoE layer's expert launches for one token: the
    k chosen experts' bf16 rows read once (gate and up: 2F x D each; down: D x
    F each), the token's bf16 activations and the float32 SwiGLU outputs
    (k x F) written by the up launch and read by the down one, the ids and
    weights, the bf16 output row."""
    d, f, k = s.d_model, s.expert_ff, s.topk
    up = k * 2 * f * d * 2 + d * 2 + k * 4 + k * f * 4
    down = k * d * f * 2 + k * f * 4 + k * 8 + d * 2
    return up, down
