"""Generation engine around the model (port of the chunked single-stream path
of ``pocket_tts_tpu/runtime/engine.py``).

* One state dict (FlowLM KV cache + cursor, previous latent, Mimi decode
  state) threads through everything; the cache is updated in place.
* ``decode_frames(K)`` runs K FlowLM frames in a Python loop, then ONE
  grouped Mimi decode over the K latents, and converts to int16 PCM — the
  grouping of the JAX package's ``_codec_impl``.  ``pos`` stays a device
  int32 [B] tensor: nothing in the frame loop waits for the device; the host
  reads audio and EOS flags once per chunk.
* Text prefill is bucketed on length (right-padded; padded positions are
  never written to the cache).
* Voice prompts go through the Mimi encoder and the speaker projection
  (``encode_voice``) and are prefilled as conditioning
  (``prefill_conditioning``), unpadded.
"""

from __future__ import annotations

import dataclasses
import logging

import numpy as np
import torch

from pocket_tts_tpu_torch.config import Config
from pocket_tts_tpu_torch.models import flow_lm, flow_mlp, mimi, transformer
from pocket_tts_tpu_torch.models.mimi import MimiPlans
from pocket_tts_tpu_torch.ops.conv import pad_for_frame

logger = logging.getLogger(__name__)


def _bucket(n: int, buckets: tuple[int, ...]) -> int:
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(f"{n} exceeds largest bucket {buckets[-1]}")


@dataclasses.dataclass
class GenParams:
    """Per-request generation knobs, validated at construction."""

    temp: float = 0.7
    lsd_decode_steps: int = 1
    noise_clamp: float | None = None
    eos_threshold: float = -4.0

    def __post_init__(self):
        if self.lsd_decode_steps < 1:
            raise ValueError(f"lsd_decode_steps must be >= 1, got {self.lsd_decode_steps}")
        if not self.temp >= 0.0:  # also rejects NaN
            raise ValueError(f"temp must be >= 0, got {self.temp}")
        if self.noise_clamp is not None:
            if self.noise_clamp != self.noise_clamp:
                raise ValueError("noise_clamp must not be NaN")
            if self.noise_clamp < 0:  # "< 0 = unclamped", the repo-wide convention
                self.noise_clamp = None


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(v, fn) for v in tree]
    return fn(tree)


def place_params(params: dict, device: torch.device, dtype: torch.dtype,
                 codec_dtype: torch.dtype) -> dict:
    """Move params to ``device``: the backbone, input linear and text
    embedding go to ``dtype`` (bf16 on CUDA: they are the bytes streamed per
    frame), the codec to ``codec_dtype``.  The flow net, the output norm /
    EOS head and the latent statistics stay float32."""
    def cast(dt):
        return lambda t: t.to(device=device, dtype=dt).contiguous()

    fl = {k: _map(v, cast(torch.float32)) for k, v in params["flow_lm"].items()}
    for name in ("tf", "input_w", "text_embed"):
        fl[name] = _map(params["flow_lm"][name], cast(dtype))
    return {"flow_lm": fl, "mimi": _map(params["mimi"], cast(codec_dtype))}


class Engine:
    """Single-stream generation programs for one (config, device) pair."""

    def __init__(self, cfg: Config, params: dict, device: torch.device | str):
        self.cfg = cfg
        self.device = torch.device(device)
        self.plans = MimiPlans(cfg.mimi)
        rcfg = cfg.runtime
        self._tcfg = cfg.flow_lm.transformer
        self._rcfg = rcfg
        self.ldim = cfg.mimi.quantizer.dimension
        self.frame_size = cfg.mimi.frame_size
        dt = rcfg.compute_dtype
        if dt == "auto":
            dt = "bfloat16" if self.device.type == "cuda" else "float32"
        self.dtype = getattr(torch, dt)
        kdt = dt if rcfg.kv_dtype == "auto" else rcfg.kv_dtype
        if kdt not in ("bfloat16", "float32"):
            raise NotImplementedError(f"kv_dtype={kdt!r} is not ported yet")
        self.kv_dtype = getattr(torch, kdt)
        if rcfg.transport_format != "int16":
            raise NotImplementedError(
                f"transport_format={rcfg.transport_format!r} is not ported yet")
        # The codec (decoder and voice encoder) runs in float32 on every
        # device: in bf16 its audio output keeps 8 mantissa bits (up to 64
        # int16 LSB at half scale), and the chunk grouping alone moved
        # samples by 32 LSB between generate and generate_stream on an H100;
        # in float32 they agree within 2 LSB.
        self.codec_dtype = torch.float32
        self.params = place_params(params, self.device, self.dtype, self.codec_dtype)
        # autoregressive frames computed by decode_frames (overshoot included)
        self.frames_decoded = 0

    # -- state -------------------------------------------------------------

    def _fresh_decode_state(self) -> dict:
        bos = self.params["flow_lm"]["bos_emb"]
        return {"latent": bos.expand(1, self.ldim).clone(),
                "mimi": mimi.init_decode_state(self.plans, 1, self.codec_dtype, self.device)}

    def new_state(self) -> dict:
        """Empty single-stream (B = 1) state: zero cache, cursor 0."""
        tcfg = self._tcfg
        kc, vc = transformer.init_cache(tcfg.num_layers, 1, self._rcfg.max_seq,
                                        tcfg.num_heads, tcfg.head_dim, self.kv_dtype,
                                        self.device)
        return {"kc": kc, "vc": vc,
                "pos": torch.zeros((1,), dtype=torch.int32, device=self.device),
                **self._fresh_decode_state()}

    def reset_for_segment(self, voice_state: dict) -> dict:
        """Per-segment restart from a voice state: the FlowLM cache is COPIED
        from the voice snapshot (decoding writes in place and must never touch
        the shared snapshot); latent and Mimi decoder start fresh."""
        return {"kc": voice_state["kc"].clone(), "vc": voice_state["vc"].clone(),
                "pos": voice_state["pos"].clone(), **self._fresh_decode_state()}

    # -- prefill -----------------------------------------------------------

    def prefill_tokens(self, state: dict, tokens: np.ndarray, n_valid: int) -> dict:
        """Prefill ``tokens`` [B, n] (right-padded to a text bucket)."""
        b = tokens.shape[0]
        bucket = _bucket(tokens.shape[1], self._rcfg.text_buckets)
        padded = np.zeros((b, bucket), np.int32)
        padded[:, : tokens.shape[1]] = tokens
        params = self.params["flow_lm"]
        emb = flow_lm.embed_text(params, torch.from_numpy(padded).to(self.device))
        t_valid = torch.full((b,), n_valid, dtype=torch.int32, device=self.device)
        kc, vc, pos = flow_lm.prefill(params, self.cfg, state["kc"], state["vc"],
                                      state["pos"], emb, t_valid)
        return {**state, "kc": kc, "vc": vc, "pos": pos}

    def prefill_conditioning(self, state: dict, cond: torch.Tensor, n_valid: int) -> dict:
        """Prefill the first ``n_valid`` frames of speaker conditioning
        ``cond`` [B, T, d_model] (float32; cast here to the backbone dtype)."""
        b = cond.shape[0]
        t_valid = torch.full((b,), n_valid, dtype=torch.int32, device=self.device)
        kc, vc, pos = flow_lm.prefill(self.params["flow_lm"], self.cfg, state["kc"],
                                      state["vc"], state["pos"], cond.to(self.dtype), t_valid)
        return {**state, "kc": kc, "vc": vc, "pos": pos}

    # -- voice encoding ----------------------------------------------------

    @property
    def prompt_reserve(self) -> int:
        """Cache positions held back from voice conditioning: room for a text
        segment plus a typical generated segment (~15 s)."""
        return max(self._rcfg.text_buckets) + 192

    def _encode(self, audio: torch.Tensor) -> torch.Tensor:
        lat = mimi.encode_to_latent(self.params["mimi"], self.plans, audio,
                                    block=self._rcfg.encoder_block)
        return flow_lm.speaker_project(self.params["flow_lm"], lat.transpose(1, 2))

    def encode_voice(self, audio, cap: bool = True) -> tuple[torch.Tensor, int]:
        """24 kHz mono waveform [T] or [1, T] -> (conditioning
        [1, n_frames, d_model] float32 on the device, n_frames), with
        n_frames = ceil(T / 1920).

        Prompts up to the largest ``encode_seconds_buckets`` entry run one
        batch encode of the frame-padded waveform; longer ones run
        ``mimi.encode_step`` over ``voice_prompt_chunk_frames``-frame chunks
        with carried state, which bounds the encoder's memory.  Unlike the
        JAX package, nothing is padded to a bucket: the encoder is causal, so
        padding changed no valid frame there, and here the output holds
        exactly the valid frames.

        ``cap`` truncates the prompt to the cache budget (``max_seq`` minus
        ``prompt_reserve``) with a warning; ``cap=False`` encodes it whole."""
        audio = torch.as_tensor(np.asarray(audio, np.float32).reshape(1, 1, -1))
        max_frames = self._rcfg.max_seq - self.prompt_reserve
        if max_frames <= 0:
            raise ValueError(
                f"max_seq={self._rcfg.max_seq} leaves no room for voice prompts after "
                f"the generation reserve ({self.prompt_reserve} frames)")
        if cap and audio.shape[-1] > max_frames * self.frame_size:
            logger.warning("voice prompt %0.1f s exceeds the cache budget (%d frames); "
                           "truncating", audio.shape[-1] / self.cfg.mimi.sample_rate,
                           max_frames)
            audio = audio[..., : max_frames * self.frame_size]
        n_frames = -(-audio.shape[-1] // self.frame_size)
        audio = audio.to(device=self.device, dtype=self.codec_dtype)
        one_shot = int(self._rcfg.encode_seconds_buckets[-1] * self.cfg.mimi.sample_rate)
        if audio.shape[-1] <= one_shot:
            return self._encode(audio), n_frames
        return self._encode_chunked(audio), n_frames

    def _encode_chunked(self, audio: torch.Tensor) -> torch.Tensor:
        audio = pad_for_frame(audio, self.frame_size)
        samples = max(1, self._rcfg.voice_prompt_chunk_frames) * self.frame_size
        state = mimi.init_encode_state(self.plans, 1, self.codec_dtype, self.device)
        conds = []
        for start in range(0, audio.shape[-1], samples):
            lat, state = mimi.encode_step(self.params["mimi"], self.plans, state,
                                          audio[..., start:start + samples])
            conds.append(flow_lm.speaker_project(self.params["flow_lm"], lat.transpose(1, 2)))
        return torch.cat(conds, dim=1)

    # -- decode ------------------------------------------------------------

    def _pcm16(self, audio: torch.Tensor) -> torch.Tensor:
        """Codec output [B, 1, T] -> int16 PCM [B, T]: clip to [-1, 1], scale
        by 32767, truncate toward zero."""
        a = audio[:, 0, :].float()
        return (a.clamp(-1.0, 1.0) * 32767.0).to(torch.int16)

    def wire_to_float(self, arr) -> np.ndarray:
        """Fetched int16 samples -> float32 in [-1, 1] (host side)."""
        return np.asarray(arr).astype(np.float32) / 32767.0

    def decode_frames(self, state: dict, n_frames: int, gen: GenParams,
                      generator: torch.Generator) -> tuple[dict, torch.Tensor, torch.Tensor]:
        """K = ``n_frames`` autoregressive frames + one grouped codec decode.

        Every frame attends over the whole cache (masked past ``pos``), so a
        frame's arithmetic does not depend on how frames are grouped into
        chunks.  Returns (state, int16 audio [B, K * 1920], is_eos [B, K]),
        both outputs still on the device."""
        params = self.params["flow_lm"]
        b = state["pos"].shape[0]
        kc, vc = state["kc"], state["vc"]
        pos, latent = state["pos"], state["latent"]
        latents, eos_logits = [], []
        table = flow_mlp.time_embedding_table(params["flow"], gen.lsd_decode_steps)
        for _ in range(n_frames):
            noise = flow_lm.sample_noise(generator, (b, self.ldim), gen.temp,
                                         gen.noise_clamp, self.device)
            latent, eos_logit, _, _, pos = flow_lm.step(
                params, self.cfg, kc, vc, pos, latent, noise, table, gen.lsd_decode_steps)
            latents.append(latent)
            eos_logits.append(eos_logit)
        denorm = flow_lm.denormalize(params, torch.stack(latents, dim=1))  # [B, K, ldim]
        audio, mimi_state = mimi.decode_step(self.params["mimi"], self.plans, state["mimi"],
                                             denorm.transpose(1, 2))
        is_eos = torch.stack(eos_logits, dim=-1) > gen.eos_threshold
        self.frames_decoded += n_frames
        new_state = {"kc": kc, "vc": vc, "pos": pos, "latent": latent, "mimi": mimi_state}
        return new_state, self._pcm16(audio), is_eos

    def chunk_schedule(self, max_frames: int, low_latency: bool = True) -> list[int]:
        """Decode chunk sizes covering ``max_frames`` (the tail may overshoot;
        the host truncates).  ``low_latency``: warm-up ramp for fast first
        audio, then the largest chunk; otherwise the largest chunk from the
        start, with the tail right-sized."""
        schedule = list(self._rcfg.decode_chunks)
        out, total = [], 0
        i = len(schedule) - 1 if not low_latency else 0
        while total < max_frames:
            c = schedule[min(i, len(schedule) - 1)]
            remaining = max_frames - total
            if c > remaining:
                c = next(s for s in schedule if s >= remaining)
            out.append(c)
            total += c
            i += 1
        return out
