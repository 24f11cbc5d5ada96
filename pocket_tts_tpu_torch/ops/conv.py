"""1-D convolutions, batch and streaming forms (port of
``pocket_tts_tpu/ops/conv.py``).

Weights keep the checkpoint (torch) layouts: Conv1d ``[out, in/groups, K]``,
ConvTranspose1d ``[in, out/groups, K]``; ``F.conv_transpose1d`` takes the
latter directly.

A weight may be a ``QTensor``: the two convolutions dequantize it with
``mat`` (the streaming forms cast their input to its dtype, the scale's).

The batch forms (``batch_conv1d``, ``batch_conv_transpose1d``) give the
output of the streaming forms run from a fresh state over the whole sequence.

Streaming semantics follow the reference exactly:

* ``streaming_conv1d`` keeps the last ``K_eff - S`` input frames as ``prev``
  state and prepends them before a VALID convolution (``replicate`` pad mode
  fills the very first ``prev`` with the first input frame).
* ``streaming_conv_transpose1d`` adds the carried ``partial`` tail into the
  first ``K - S`` output samples and carries the last ``K - S`` samples, with
  the bias subtracted, as the next partial.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from pocket_tts_tpu_torch.ops.qtensor import mat


@dataclasses.dataclass(frozen=True)
class ConvSpec:
    """Static description of one conv layer."""

    in_channels: int
    out_channels: int
    kernel_size: int
    stride: int = 1
    dilation: int = 1
    groups: int = 1
    bias: bool = True
    pad_mode: str = "constant"  # "constant" | "replicate"

    @property
    def effective_kernel(self) -> int:
        return (self.kernel_size - 1) * self.dilation + 1

    @property
    def state_len(self) -> int:
        return self.effective_kernel - self.stride


@dataclasses.dataclass(frozen=True)
class ConvTrSpec:
    in_channels: int
    out_channels: int
    kernel_size: int
    stride: int = 1
    groups: int = 1
    bias: bool = True

    @property
    def state_len(self) -> int:
        return self.kernel_size - self.stride


def conv1d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None, *,
           stride: int = 1, dilation: int = 1, groups: int = 1) -> torch.Tensor:
    """VALID conv over [B, C, T], computed in the weight dtype (a QTensor
    weight is dequantized first)."""
    w = mat(w)
    y = F.conv1d(x.to(w.dtype), w, None, stride=stride, dilation=dilation, groups=groups)
    if b is not None:
        y = y + b.to(y.dtype)[None, :, None]
    return y


def conv_transpose1d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None, *,
                     stride: int = 1, groups: int = 1) -> torch.Tensor:
    """Transposed conv over [B, C, T] (padding 0): output length
    ``(T - 1) * stride + K``."""
    w = mat(w)
    y = F.conv_transpose1d(x.to(w.dtype), w, None, stride=stride, groups=groups)
    if b is not None:
        y = y + b.to(y.dtype)[None, :, None]
    return y


def conv_init_state(spec: ConvSpec, batch: int, dtype=torch.float32,
                    device: torch.device | str = "cpu") -> dict:
    st = {"prev": torch.zeros((batch, spec.in_channels, spec.state_len), dtype=dtype,
                              device=device)}
    if spec.pad_mode == "replicate":
        st["first"] = torch.ones((batch,), dtype=torch.bool, device=device)
    return st


def streaming_conv1d(spec: ConvSpec, w: torch.Tensor, b: torch.Tensor | None, state: dict,
                     x: torch.Tensor) -> tuple[torch.Tensor, dict]:
    x = x.to(w.dtype)  # streaming state stays in the compute dtype
    p = spec.state_len
    if p == 0:
        return conv1d(x, w, b, stride=spec.stride, dilation=spec.dilation,
                      groups=spec.groups), state
    prev = state["prev"].to(x.dtype)
    if spec.pad_mode == "replicate":
        init = x[..., :1].expand(prev.shape)
        prev = torch.where(state["first"][:, None, None], init, prev)
    xc = torch.cat([prev, x], dim=-1)
    y = conv1d(xc, w, b, stride=spec.stride, dilation=spec.dilation, groups=spec.groups)
    new_state = {"prev": xc[..., -p:]}
    if spec.pad_mode == "replicate":
        new_state["first"] = torch.zeros_like(state["first"])
    return y, new_state


def batch_conv1d(spec: ConvSpec, w: torch.Tensor, b: torch.Tensor | None,
                 x: torch.Tensor) -> torch.Tensor:
    """Whole-sequence conv from a fresh state: left pad of ``state_len`` zeros,
    or of the first frame repeated in ``replicate`` mode."""
    x = x.to(w.dtype)
    p = spec.state_len
    if p > 0:
        if spec.pad_mode == "replicate":
            pad = x[..., :1].expand(*x.shape[:-1], p)
        else:
            pad = x.new_zeros((*x.shape[:-1], p))
        x = torch.cat([pad, x], dim=-1)
    return conv1d(x, w, b, stride=spec.stride, dilation=spec.dilation, groups=spec.groups)


def convtr_init_state(spec: ConvTrSpec, batch: int, dtype=torch.float32,
                      device: torch.device | str = "cpu") -> dict:
    return {"partial": torch.zeros((batch, spec.out_channels, spec.state_len), dtype=dtype,
                                   device=device)}


def streaming_conv_transpose1d(spec: ConvTrSpec, w: torch.Tensor, b: torch.Tensor | None,
                               state: dict, x: torch.Tensor) -> tuple[torch.Tensor, dict]:
    y = conv_transpose1d(x, w, b, stride=spec.stride, groups=spec.groups)
    pt = spec.state_len
    if pt == 0:
        return y, state
    partial = state["partial"].to(y.dtype)
    y = torch.cat([y[..., :pt] + partial, y[..., pt:]], dim=-1)
    tail = y[..., -pt:]
    if b is not None:
        tail = tail - b.to(tail.dtype)[None, :, None]
    return y[..., :-pt], {"partial": tail}


def batch_conv_transpose1d(spec: ConvTrSpec, w: torch.Tensor, b: torch.Tensor | None,
                           x: torch.Tensor) -> torch.Tensor:
    """Whole-sequence transposed conv with the streaming edge behaviour: zero
    initial partial, trailing ``K - S`` samples dropped."""
    y = conv_transpose1d(x, w, b, stride=spec.stride, groups=spec.groups)
    pt = spec.state_len
    return y[..., :-pt] if pt > 0 else y


def pad_for_frame(x: torch.Tensor, frame_size: int) -> torch.Tensor:
    """Right-pad [B, C, T] with zeros to a multiple of ``frame_size``."""
    extra = (-x.shape[-1]) % frame_size
    return F.pad(x, (0, extra)) if extra else x
