"""SEANet convolutional encoder and decoder (port of
``pocket_tts_tpu/models/seanet.py``).

The encoder is an initial conv, then per ratio (reversed) [residual blocks,
ELU, strided conv (k=2r, s=r) doubling the channels], then ELU + final conv
to ``dimension``: 24 kHz audio -> 200 Hz features.  The decoder is an
initial conv, then per ratio [ELU, transposed conv (k=2r, s=r), residual
blocks], then ELU + final conv.  Residual blocks are [ELU, conv(k, dilated),
ELU, conv(1x1)] with an identity skip.  Layer plans carry the torch
ModuleList index of each layer so the checkpoint remap is mechanical.
"""

from __future__ import annotations

import dataclasses
from typing import Literal

import torch
import torch.nn.functional as F

from pocket_tts_tpu_torch.config import SEANetConfig
from pocket_tts_tpu_torch.ops.conv import (
    ConvSpec,
    ConvTrSpec,
    batch_conv1d,
    batch_conv_transpose1d,
    conv_init_state,
    convtr_init_state,
    streaming_conv1d,
    streaming_conv_transpose1d,
)


@dataclasses.dataclass(frozen=True)
class Layer:
    kind: Literal["conv", "convtr", "res", "elu"]
    index: int  # torch ModuleList index
    spec: ConvSpec | ConvTrSpec | None = None
    # residual block sub-convs (kind == "res")
    res_specs: tuple[ConvSpec, ...] = ()


def encoder_plan(cfg: SEANetConfig) -> list[Layer]:
    """Encoder layer plan (voice cloning)."""
    layers: list[Layer] = []
    idx = 0

    def add(kind, spec=None, res_specs=()):
        nonlocal idx
        layers.append(Layer(kind, idx, spec, res_specs))
        idx += 1

    mult = 1
    add("conv", ConvSpec(cfg.channels, mult * cfg.n_filters, cfg.kernel_size,
                         pad_mode=cfg.pad_mode))
    for ratio in reversed(cfg.ratios):
        dim = mult * cfg.n_filters
        for j in range(cfg.n_residual_layers):
            add("res", res_specs=(
                ConvSpec(dim, dim // cfg.compress, cfg.residual_kernel_size,
                         dilation=cfg.dilation_base**j, pad_mode=cfg.pad_mode),
                ConvSpec(dim // cfg.compress, dim, 1, pad_mode=cfg.pad_mode),
            ))
        add("elu")
        add("conv", ConvSpec(dim, dim * 2, kernel_size=ratio * 2, stride=ratio,
                             pad_mode=cfg.pad_mode))
        mult *= 2
    add("elu")
    add("conv", ConvSpec(mult * cfg.n_filters, cfg.dimension, cfg.last_kernel_size,
                         pad_mode=cfg.pad_mode))
    return layers


def decoder_plan(cfg: SEANetConfig) -> list[Layer]:
    layers: list[Layer] = []
    idx = 0

    def add(kind, spec=None, res_specs=()):
        nonlocal idx
        layers.append(Layer(kind, idx, spec, res_specs))
        idx += 1

    mult = int(2 ** len(cfg.ratios))
    add("conv", ConvSpec(cfg.dimension, mult * cfg.n_filters, cfg.kernel_size,
                         pad_mode=cfg.pad_mode))
    for ratio in cfg.ratios:
        add("elu")
        add("convtr", ConvTrSpec(mult * cfg.n_filters, mult * cfg.n_filters // 2,
                                 kernel_size=ratio * 2, stride=ratio))
        dim = mult * cfg.n_filters // 2
        hidden = dim // cfg.compress
        for j in range(cfg.n_residual_layers):
            add("res", res_specs=(
                ConvSpec(dim, hidden, cfg.residual_kernel_size,
                         dilation=cfg.dilation_base**j, pad_mode=cfg.pad_mode),
                ConvSpec(hidden, dim, 1, pad_mode=cfg.pad_mode),
            ))
        mult //= 2
    add("elu")
    add("conv", ConvSpec(cfg.n_filters, cfg.channels, cfg.last_kernel_size,
                         pad_mode=cfg.pad_mode))
    return layers


def init_state(plan: list[Layer], batch: int, dtype=torch.float32,
               device: torch.device | str = "cpu") -> list:
    states = []
    for layer in plan:
        if layer.kind == "conv":
            states.append(conv_init_state(layer.spec, batch, dtype, device))
        elif layer.kind == "convtr":
            states.append(convtr_init_state(layer.spec, batch, dtype, device))
        elif layer.kind == "res":
            states.append({
                "conv0": conv_init_state(layer.res_specs[0], batch, dtype, device),
                "conv1": conv_init_state(layer.res_specs[1], batch, dtype, device),
            })
        else:
            states.append({})
    return states


def batch_forward(plan: list[Layer], params: list, x: torch.Tensor) -> torch.Tensor:
    """Whole-sequence forward from a fresh state (no carried conv tails)."""
    for layer, p in zip(plan, params):
        if layer.kind == "conv":
            x = batch_conv1d(layer.spec, p["w"], p.get("b"), x)
        elif layer.kind == "convtr":
            x = batch_conv_transpose1d(layer.spec, p["w"], p.get("b"), x)
        elif layer.kind == "res":
            v = batch_conv1d(layer.res_specs[0], p["conv0"]["w"], p["conv0"].get("b"),
                             F.elu(x))
            v = batch_conv1d(layer.res_specs[1], p["conv1"]["w"], p["conv1"].get("b"),
                             F.elu(v))
            x = x + v
        else:
            x = F.elu(x)
    return x


def streaming_forward(plan: list[Layer], params: list, states: list, x: torch.Tensor
                      ) -> tuple[torch.Tensor, list]:
    new_states = []
    for layer, p, st in zip(plan, params, states):
        if layer.kind == "conv":
            x, st = streaming_conv1d(layer.spec, p["w"], p.get("b"), st, x)
        elif layer.kind == "convtr":
            x, st = streaming_conv_transpose1d(layer.spec, p["w"], p.get("b"), st, x)
        elif layer.kind == "res":
            v = F.elu(x)
            v, s0 = streaming_conv1d(layer.res_specs[0], p["conv0"]["w"],
                                     p["conv0"].get("b"), st["conv0"], v)
            v = F.elu(v)
            v, s1 = streaming_conv1d(layer.res_specs[1], p["conv1"]["w"],
                                     p["conv1"].get("b"), st["conv1"], v)
            x = x + v
            st = {"conv0": s0, "conv1": s1}
        else:
            x = F.elu(x)
        new_states.append(st)
    return x, new_states
