"""Mimi codec (port of ``pocket_tts_tpu/models/mimi.py``).

Encode (voice cloning): pad to a frame multiple -> SEANet encoder (24 kHz ->
200 Hz x 512) -> windowed encoder transformer -> stride-16 ``replicate``
downsample -> 512-dim latents at 12.5 Hz.  ``encode_to_latent`` takes the
whole waveform; ``encode_step`` takes it in chunks with carried state and
gives the same latents.

Decode: streaming decode of denormalized 32-dim latents: 1x1 quantizer
projection 32 -> 512, depthwise transposed-conv upsample x16 (12.5 Hz ->
200 Hz), windowed decoder transformer over carried KV tails, SEANet decoder
-> 1920 samples of 24 kHz audio per latent frame.  ``decode_batch`` decodes
a whole utterance from a fresh state in one pass, with the same output.
"""

from __future__ import annotations

import torch

from pocket_tts_tpu_torch.config import MimiConfig
from pocket_tts_tpu_torch.models import seanet, transformer
from pocket_tts_tpu_torch.ops.conv import (
    ConvSpec,
    ConvTrSpec,
    batch_conv1d,
    batch_conv_transpose1d,
    conv_init_state,
    convtr_init_state,
    pad_for_frame,
    streaming_conv1d,
    streaming_conv_transpose1d,
)
from pocket_tts_tpu_torch.ops.qtensor import mat
from pocket_tts_tpu_torch.ops.rope import rope_table


def specs(cfg: MimiConfig) -> dict:
    stride = cfg.resample_stride
    dim = cfg.seanet.dimension
    return {
        "quantizer": ConvSpec(cfg.quantizer.dimension, cfg.quantizer.output_dimension,
                              1, bias=False),
        "downsample": ConvSpec(dim, dim, 2 * stride, stride=stride, bias=False,
                               pad_mode="replicate"),
        "upsample": ConvTrSpec(dim, dim, 2 * stride, stride=stride, groups=dim, bias=False),
    }


class MimiPlans:
    """Static layer plans and conv specs derived from config."""

    def __init__(self, cfg: MimiConfig):
        self.cfg = cfg
        self.encoder = seanet.encoder_plan(cfg.seanet)
        self.decoder = seanet.decoder_plan(cfg.seanet)
        self.specs = specs(cfg)


def encode_to_latent(params: dict, plans: MimiPlans, audio: torch.Tensor,
                     block: int = 256) -> torch.Tensor:
    """[B, 1, T] 24 kHz waveform -> [B, 512, ceil(T / 1920)] latents, from a
    fresh state.  ``block``: query block of the encoder's banded attention."""
    cfg = plans.cfg
    tcfg = cfg.transformer
    x = pad_for_frame(audio, cfg.frame_size)
    emb = seanet.batch_forward(plans.encoder, params["encoder"], x)  # [B, 512, T200]
    positions = torch.arange(emb.shape[-1], device=emb.device)
    cos, sin = rope_table(positions, tcfg.head_dim, tcfg.max_period)
    emb = transformer.projected_batch_forward(params["enc_tf"], tcfg, emb, cos, sin,
                                              block=block)
    return batch_conv1d(plans.specs["downsample"], params["downsample_w"], None, emb)


def init_encode_state(plans: MimiPlans, batch: int, dtype=torch.float32,
                      device: torch.device | str = "cpu") -> dict:
    """Streaming-encode state: SEANet encoder conv tails, encoder-transformer
    KV tails (last context - 1 positions), position cursor, and the
    downsample conv tail with its ``first`` flag (``replicate`` pad)."""
    tcfg = plans.cfg.transformer
    kc, vc = transformer.init_tail(tcfg.num_layers, batch, tcfg.context, tcfg.num_heads,
                                   tcfg.head_dim, dtype, device)
    return {
        "enc": seanet.init_state(plans.encoder, batch, dtype, device),
        "kc": kc,
        "vc": vc,
        "pos": torch.zeros((batch,), dtype=torch.int32, device=device),
        "down": conv_init_state(plans.specs["downsample"], batch, dtype, device),
    }


def encode_step(params: dict, plans: MimiPlans, state: dict, audio: torch.Tensor
                ) -> tuple[torch.Tensor, dict]:
    """Streaming encode of one chunk [B, 1, C * 1920] -> ([B, 512, C], state).

    The chunk length must be a multiple of the frame size, which keeps every
    strided conv's phase aligned across chunks; chained from
    ``init_encode_state`` the latents equal ``encode_to_latent`` of the whole
    waveform."""
    tcfg = plans.cfg.transformer
    x, enc_state = seanet.streaming_forward(plans.encoder, params["encoder"], state["enc"],
                                            audio)
    t200 = x.shape[-1]
    positions = state["pos"][:, None] + torch.arange(t200, dtype=torch.int32,
                                                     device=x.device)[None, :]
    cos, sin = rope_table(positions, tcfg.head_dim, tcfg.max_period)
    x, kc, vc = transformer.projected_tail_forward(
        params["enc_tf"], tcfg, state["kc"], state["vc"], state["pos"], x,
        cos[:, :, None, :], sin[:, :, None, :])
    lat, down_state = streaming_conv1d(plans.specs["downsample"], params["downsample_w"],
                                       None, state["down"], x)
    new_state = {"enc": enc_state, "kc": kc, "vc": vc, "pos": state["pos"] + t200,
                 "down": down_state}
    return lat, new_state


def quantize(params: dict, latent_bct: torch.Tensor) -> torch.Tensor:
    """1x1 conv 32 -> 512 (DummyQuantizer.output_proj)."""
    w = mat(params["quantizer_w"])[:, :, 0]
    return torch.einsum("bct,dc->bdt", latent_bct.to(w.dtype), w)


def init_decode_state(plans: MimiPlans, batch: int, dtype=torch.float32,
                      device: torch.device | str = "cpu") -> dict:
    """Decoder streaming state: upsample partial, transformer KV tails (last
    context - 1 positions), position cursor, SEANet conv tails."""
    tcfg = plans.cfg.transformer
    kc, vc = transformer.init_tail(tcfg.num_layers, batch, tcfg.context, tcfg.num_heads,
                                   tcfg.head_dim, dtype, device)
    return {
        "up": convtr_init_state(plans.specs["upsample"], batch, dtype, device),
        "kc": kc,
        "vc": vc,
        "pos": torch.zeros((batch,), dtype=torch.int32, device=device),
        "dec": seanet.init_state(plans.decoder, batch, dtype, device),
    }


def decode_step(params: dict, plans: MimiPlans, state: dict, latent_bct: torch.Tensor
                ) -> tuple[torch.Tensor, dict]:
    """Streaming decode of T' latent frames [B, ldim, T'] -> audio
    [B, 1, T' * 1920] and the next state."""
    tcfg = plans.cfg.transformer
    x = quantize(params, latent_bct)
    x, up_state = streaming_conv_transpose1d(plans.specs["upsample"], params["upsample_w"],
                                             None, state["up"], x)
    t200 = x.shape[-1]
    positions = state["pos"][:, None] + torch.arange(t200, dtype=torch.int32,
                                                     device=x.device)[None, :]
    cos, sin = rope_table(positions, tcfg.head_dim, tcfg.max_period)
    x, kc, vc = transformer.projected_tail_forward(
        params["dec_tf"], tcfg, state["kc"], state["vc"], state["pos"], x,
        cos[:, :, None, :], sin[:, :, None, :])
    audio, dec_state = seanet.streaming_forward(plans.decoder, params["decoder"],
                                                state["dec"], x)
    new_state = {"up": up_state, "kc": kc, "vc": vc,
                 "pos": state["pos"] + t200, "dec": dec_state}
    return audio, new_state


def decode_batch(params: dict, plans: MimiPlans, latent_bct: torch.Tensor,
                 block: int = 256) -> torch.Tensor:
    """Whole-utterance decode of denormalized latents [B, ldim, T] -> audio
    [B, 1, T * 1920], with fresh-state streaming semantics: equal to
    ``decode_step`` over the frames from ``init_decode_state``.  ``block``:
    query block of the decoder transformer's banded attention."""
    tcfg = plans.cfg.transformer
    x = quantize(params, latent_bct)
    x = batch_conv_transpose1d(plans.specs["upsample"], params["upsample_w"], None, x)
    positions = torch.arange(x.shape[-1], device=x.device)
    cos, sin = rope_table(positions, tcfg.head_dim, tcfg.max_period)
    x = transformer.projected_batch_forward(params["dec_tf"], tcfg, x, cos, sin, block=block)
    return seanet.batch_forward(plans.decoder, params["decoder"], x)
