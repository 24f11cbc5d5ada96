"""Generation engine around the model (port of
``pocket_tts_tpu/runtime/engine.py``, single-stream and batched).

* One state dict (FlowLM KV cache + cursor, previous latent, Mimi decode
  state) threads through everything; the cache is updated in place.
* ``decode_frames(K)`` runs K FlowLM frames in a Python loop, then ONE
  grouped Mimi decode over the K latents, and converts to int16 PCM — the
  grouping of the JAX package's ``_codec_impl``.  ``pos`` stays a device
  int32 [B] tensor: nothing in the frame loop waits for the device; the host
  reads audio and EOS flags once per chunk.  Per-slot temperature, EOS
  threshold, LSD step count and noise clamp vectors serve the continuous
  batcher (``runtime/batcher.py``).
* ``decode_segment`` decodes a whole B = 1 segment with the EOS stop rule:
  the host frame loop stops on EOS flags it reads asynchronously, then the
  codec runs in groups of 64 frames up to the last emitted one.
* ``admit_slot`` / ``admit_prefill_slot`` install a voice snapshot into one
  lane of a batched state and prefill that lane's text, writing that lane
  only, in place.
* Text prefill is bucketed on length (right-padded; padded positions are
  never written to the cache).
* Voice prompts go through the Mimi encoder and the speaker projection
  (``encode_voice``) and are prefilled as conditioning
  (``prefill_conditioning``), unpadded.
* Per-slot LoRA (``set_adapter_bank``): ``decode_frames(lora_w=)`` and
  ``admit_prefill_slot(lora_row=)`` mix each lane's adapter delta into the
  backbone products; without them the plain path runs.
* Narrow storage: int8 / int4 ``QTensor`` weights (scales cast to each
  leaf's dtype, ``q`` never), an fp8 KV cache (``kv_dtype``), and the mu-law
  wire (``transport_format="mulaw"``: encoded on the device, decoded on the
  host).
"""

from __future__ import annotations

import collections
import dataclasses
import logging

import numpy as np
import torch

from pocket_tts_tpu_torch.config import Config
from pocket_tts_tpu_torch.models import flow_lm, flow_mlp, mimi, transformer
from pocket_tts_tpu_torch.models.mimi import MimiPlans
from pocket_tts_tpu_torch.ops import mulaw
from pocket_tts_tpu_torch.ops.attention import raw_view
from pocket_tts_tpu_torch.ops.conv import pad_for_frame
from pocket_tts_tpu_torch.ops.qtensor import QTensor

logger = logging.getLogger(__name__)

# decode_segment's host stop: every SEGMENT_POLL frames the loop enqueues a
# copy of the device's eos_step into pinned memory and records an event; it
# reads a copy once its event is done, and waits on the oldest unread copy
# when SEGMENT_MAX_LAG frames have been enqueued after it.  So at most
# SEGMENT_POLL + SEGMENT_MAX_LAG frames are computed past the stop.
SEGMENT_POLL = 4
SEGMENT_MAX_LAG = 12
# frames per codec decode of a fused segment (the JAX package's group)
CODEC_GROUP = 64


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


def _clone(t: torch.Tensor) -> torch.Tensor:
    """A copy of a cache tensor (an fp8 one copied as its bytes)."""
    return raw_view(t).clone().view(t.dtype)


def _map2(dst, src, fn):
    """``fn(dst_leaf, src_leaf)`` over two trees of one structure."""
    if isinstance(dst, dict):
        for k in dst:
            _map2(dst[k], src[k], fn)
    elif isinstance(dst, list):
        for d, s in zip(dst, src):
            _map2(d, s, fn)
    else:
        fn(dst, src)


def place_params(params: dict, device: torch.device, dtype: torch.dtype,
                 codec_dtype: torch.dtype) -> dict:
    """Move params to ``device``: the backbone, input linear and text
    embedding go to ``dtype`` (bf16 on CUDA: they are the bytes streamed per
    frame), the codec to ``codec_dtype``.  The flow net, the output norm /
    EOS head and the latent statistics stay float32.  A QTensor moves its
    ``q`` as stored and casts its scale to the leaf's dtype.  The flow
    chain's stacked QTensor blocks are dequantized here, once, into the
    float32 stacks ``flow_blocks`` takes (the JAX package dequantizes them
    before every call, to the same values).
    Tensors already on ``device`` in their dtype are kept, not copied, so
    engines built from one placed dict share its tensors."""
    def cast(dt):
        def leaf(t):
            if isinstance(t, QTensor):
                return QTensor(t.q.to(device).contiguous(),
                               t.scale.to(device=device, dtype=dt).contiguous())
            return t.to(device=device, dtype=dt).contiguous()
        return leaf

    narrow = ("tf", "input_w", "text_embed")
    fl = {k: _map(v, cast(dtype if k in narrow else torch.float32))
          for k, v in params["flow_lm"].items()}
    fl["flow"]["blocks"] = {k: v.dequant() if isinstance(v, QTensor) else v
                            for k, v in fl["flow"]["blocks"].items()}
    return {"flow_lm": fl, "mimi": _map(params["mimi"], cast(codec_dtype))}


class Engine:
    """Generation for one (config, device, batch size).  ``params`` may be
    another engine's placed params: they are then shared, not copied."""

    def __init__(self, cfg: Config, params: dict, device: torch.device | str,
                 batch_size: int = 1):
        self.cfg = cfg
        self.device = torch.device(device)
        self.batch = batch_size
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
        # finite-only e4m3 ("fn"), as the JAX package
        self.kv_dtype = {"float8_e4m3": torch.float8_e4m3fn,
                         "float8_e5m2": torch.float8_e5m2}.get(kdt) or getattr(torch, kdt)
        self.transport = rcfg.transport_format
        # The codec (decoder and voice encoder) runs in float32 on every
        # device: in bf16 its audio output keeps 8 mantissa bits (up to 64
        # int16 LSB at half scale), and the chunk grouping alone moved
        # samples by 32 LSB between generate and generate_stream on an H100;
        # in float32 they agree within 2 LSB.
        self.codec_dtype = torch.float32
        self.params = place_params(params, self.device, self.dtype, self.codec_dtype)
        # autoregressive frames computed by decode_frames (overshoot included),
        # and the flow-net evaluations they ran (each one flow_blocks call)
        self.frames_decoded = 0
        self.flow_evals = 0
        self._fresh_mimi1 = None  # read-only fresh B = 1 codec state (admission)
        self.adapter_bank = None  # set_adapter_bank
        self._lora_stacks = None

    def set_adapter_bank(self, bank) -> None:
        """Attach a ``training.lora.AdapterBank``: its stacked factors are
        placed once on the device in float32.  Dispatches opt in with a
        per-slot row (``decode_frames(lora_w=)``, ``admit_prefill_slot(
        lora_row=)``); those without one keep the plain path."""
        self.adapter_bank = bank
        self._lora_stacks = {k: {n: torch.as_tensor(t).to(self.device, torch.float32)
                                 for n, t in f.items()} for k, f in bank.stacks.items()}

    def _lora(self, rows, what: str):
        """(stacks, rows [B, N] on the device) for a dispatch with adapter rows."""
        if self._lora_stacks is None:
            raise ValueError(f"{what} requires set_adapter_bank() first")
        return self._lora_stacks, self.put(rows, torch.float32)

    # -- state -------------------------------------------------------------

    def _fresh_decode_state(self, batch: int = 1) -> dict:
        bos = self.params["flow_lm"]["bos_emb"]
        return {"latent": bos.expand(batch, self.ldim).clone(),
                "mimi": mimi.init_decode_state(self.plans, batch, self.codec_dtype,
                                               self.device)}

    def new_state(self, batch: int | None = None) -> dict:
        """Empty state of ``batch`` lanes (default: the engine's batch size):
        zero cache, cursor 0."""
        batch = batch or self.batch
        tcfg = self._tcfg
        kc, vc = transformer.init_cache(tcfg.num_layers, batch, self._rcfg.max_seq,
                                        tcfg.num_heads, tcfg.head_dim, self.kv_dtype,
                                        self.device)
        return {"kc": kc, "vc": vc,
                "pos": torch.zeros((batch,), dtype=torch.int32, device=self.device),
                **self._fresh_decode_state(batch)}

    def put(self, arr, dtype: torch.dtype) -> torch.Tensor:
        """Host array (or a tensor already on the device) -> tensor on the
        device.  On CUDA a host array is staged in pinned memory and its copy
        enqueued without waiting: a pageable or blocking copy would wait for
        every chunk already in flight."""
        if torch.is_tensor(arr):
            return arr.to(device=self.device, dtype=dtype)
        t = torch.as_tensor(np.asarray(arr), dtype=dtype)
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t

    def reset_for_segment(self, voice_state: dict) -> dict:
        """Per-segment restart from a voice state: the FlowLM cache is COPIED
        from the voice snapshot (decoding writes in place and must never touch
        the shared snapshot); latent and Mimi decoder start fresh."""
        return {"kc": _clone(voice_state["kc"]), "vc": _clone(voice_state["vc"]),
                "pos": voice_state["pos"].clone(), **self._fresh_decode_state()}

    # -- slot admission (continuous batching) --------------------------------

    def admit_slot(self, state: dict, slot: int, voice_state: dict) -> dict:
        """Install a B = 1 voice snapshot (kc, vc, pos) into lane ``slot`` of a
        batched state and reset that lane's latent and Mimi decoder.  Every
        write is in place and touches that lane only; on one stream it runs
        after the chunks already enqueued, which read the lane's old data."""
        lane = slice(slot, slot + 1)
        for name in ("kc", "vc"):  # an fp8 cache is copied as its bytes
            raw_view(state[name])[:, lane].copy_(raw_view(voice_state[name]))
        state["pos"][lane].copy_(voice_state["pos"])
        state["latent"][lane].copy_(self.params["flow_lm"]["bos_emb"])
        if self._fresh_mimi1 is None:
            self._fresh_mimi1 = mimi.init_decode_state(self.plans, 1, self.codec_dtype,
                                                       self.device)
        fresh, dec = self._fresh_mimi1, state["mimi"]
        for name in ("kc", "vc"):  # [L, B, ...]
            dec[name][:, lane].copy_(fresh[name])
        for name in ("up", "pos", "dec"):
            _map2(dec[name], fresh[name], lambda dst, src: dst[lane].copy_(src))
        return state

    def pad_token_row(self, tokens: np.ndarray) -> torch.Tensor:
        """[1, n] int32 -> [1, bucket] host row for ``admit_prefill_slot``
        (pinned on CUDA, so its upload at admission is enqueued, not waited
        for).  Safe from any thread."""
        bucket = _bucket(tokens.shape[1], self._rcfg.text_buckets)
        padded = torch.zeros((1, bucket), dtype=torch.int32)
        padded[:, : tokens.shape[1]] = torch.from_numpy(np.asarray(tokens, np.int32))
        return padded.pin_memory() if self.device.type == "cuda" else padded

    def admit_prefill_slot(self, state: dict, slot: int, voice_state: dict,
                           tokens_row: torch.Tensor, n_tokens: int,
                           lora_row: np.ndarray | None = None) -> dict:
        """``admit_slot`` plus this lane's text prefill at B = 1, on the
        lane's view of the batched cache (the prefill writes through the view
        into the shared buffer).  ``tokens_row``: from ``pad_token_row``.
        ``lora_row`` [N]: the lane's adapter row (its prefill runs through
        that adapter; needs ``set_adapter_bank``)."""
        lora, lora_w = (None, None) if lora_row is None else self._lora(
            np.asarray(lora_row, np.float32).reshape(1, -1), "lora_row")
        state = self.admit_slot(state, slot, voice_state)
        lane = slice(slot, slot + 1)
        params = self.params["flow_lm"]
        emb = flow_lm.embed_text(params, tokens_row.to(self.device, non_blocking=True))
        t_valid = torch.full((1,), n_tokens, dtype=torch.int32, device=self.device)
        _, _, pos = flow_lm.prefill(params, self.cfg, state["kc"][:, lane], state["vc"][:, lane],
                                    state["pos"][lane], emb, t_valid, lora, lora_w)
        state["pos"][lane].copy_(pos)
        return state

    # -- prefill -----------------------------------------------------------

    def prefill_tokens(self, state: dict, tokens: np.ndarray,
                       n_valid: int | np.ndarray | list) -> dict:
        """Prefill ``tokens`` [B, n] (right-padded to a text bucket).
        ``n_valid`` is one count for every lane or a per-lane [B] vector; a
        lane with 0 valid tokens writes nothing and keeps its position.
        Adapter rows never reach this prefill: a batched adapter request
        prefills through ``admit_prefill_slot``, and a voice state for one
        through the adapter's merged model."""
        b = tokens.shape[0]
        bucket = _bucket(tokens.shape[1], self._rcfg.text_buckets)
        padded = np.zeros((b, bucket), np.int32)
        padded[:, : tokens.shape[1]] = tokens
        params = self.params["flow_lm"]
        emb = flow_lm.embed_text(params, self.put(padded, torch.int32))
        counts = np.asarray(n_valid, np.int32)
        if counts.ndim == 0:
            counts = np.full((b,), counts, np.int32)
        elif counts.shape != (b,):
            raise ValueError(f"prefill_tokens: n_valid of shape {counts.shape} for {b} lanes")
        t_valid = self.put(counts, torch.int32)
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
        """Codec output [B, 1, T] -> wire samples [B, T]: int16 PCM (clip to
        [-1, 1], scale by 32767, truncate toward zero), companded to uint8
        mu-law on the device when ``transport_format="mulaw"``."""
        a = audio[:, 0, :].float()
        pcm = (a.clamp(-1.0, 1.0) * 32767.0).to(torch.int16)
        return mulaw.encode(pcm) if self.transport == "mulaw" else pcm

    @property
    def wire_dtype(self) -> torch.dtype:
        return torch.uint8 if self.transport == "mulaw" else torch.int16

    def wire_to_float(self, arr) -> np.ndarray:
        """Fetched wire samples -> float32 in [-1, 1] (host side)."""
        a = np.asarray(arr)
        if self.transport == "mulaw":
            a = mulaw.decode(a)
        return a.astype(np.float32) / 32767.0

    def decode_frames(self, state: dict, n_frames: int, gen: GenParams,
                      generator: torch.Generator, *, temps=None, eos_thresholds=None,
                      lsd_vec: np.ndarray | None = None, clamp_vec=None,
                      lora_w=None) -> tuple[dict, torch.Tensor, torch.Tensor]:
        """K = ``n_frames`` autoregressive frames + one grouped codec decode.

        Every frame attends over the whole cache (masked past ``pos``), so a
        frame's arithmetic does not depend on how frames are grouped into
        chunks.  Returns (state, int16 audio [B, K * 1920], is_eos [B, K]),
        both fresh tensors on the device (never views of the state).

        ``temps`` / ``eos_thresholds``: optional per-slot [B] vectors (host
        arrays or device tensors) in place of ``gen``'s.  ``lsd_vec`` (host
        [B] ints, each >= 1) / ``clamp_vec`` ([B]; < 0 unclamped, 0 a hard
        zero): per-slot step counts and noise clamps, run as masked Euler
        steps up to the batch maximum (the output does not depend on it).
        ``lora_w`` [B, N]: per-slot adapter rows (needs ``set_adapter_bank``;
        a zero row is the base model)."""
        params = self.params["flow_lm"]
        b = state["pos"].shape[0]
        lora, lora_w = (None, None) if lora_w is None else self._lora(lora_w, "lora_w")
        temp = gen.temp if temps is None else self.put(temps, torch.float32)
        eos_th = (gen.eos_threshold if eos_thresholds is None
                  else self.put(eos_thresholds, torch.float32)[:, None])
        if lsd_vec is not None or clamp_vec is not None:
            lsd = np.asarray(np.full((b,), gen.lsd_decode_steps) if lsd_vec is None
                             else lsd_vec, np.int64)
            if np.any(lsd < 1):
                # 0 would index the tables at -1 and emit raw noise as the latent
                raise ValueError(f"lsd_vec entries must be >= 1, got {lsd}")
            if clamp_vec is None:
                clamp_vec = np.full((b,), -1.0 if gen.noise_clamp is None else gen.noise_clamp)
            steps, clamped = int(lsd.max()), "vec"
            lsd_t = self.put(lsd, torch.int64)
            clamp = self.put(clamp_vec, torch.float32)
            tables = flow_mlp.time_embedding_tables(params["flow"], steps)
            table = tables[lsd_t - 1].transpose(0, 1)  # [steps, B, dim]
        else:
            steps, clamped, lsd_t, clamp = gen.lsd_decode_steps, None, None, gen.noise_clamp
            table = flow_mlp.time_embedding_table(params["flow"], steps)
        kc, vc = state["kc"], state["vc"]
        pos, latent = state["pos"], state["latent"]
        latents, eos_logits = [], []
        for _ in range(n_frames):
            noise = flow_lm.sample_noise(generator, (b, self.ldim), temp, clamp, self.device,
                                         clamped=clamped)
            latent, eos_logit, _, _, pos = flow_lm.step(
                params, self.cfg, kc, vc, pos, latent, noise, table, steps, lsd_vec=lsd_t,
                lora=lora, lora_w=lora_w)
            latents.append(latent)
            eos_logits.append(eos_logit)
        denorm = flow_lm.denormalize(params, torch.stack(latents, dim=1))  # [B, K, ldim]
        audio, mimi_state = mimi.decode_step(self.params["mimi"], self.plans, state["mimi"],
                                             denorm.transpose(1, 2))
        is_eos = torch.stack(eos_logits, dim=-1) > eos_th
        self.frames_decoded += n_frames
        self.flow_evals += n_frames * steps
        new_state = {"kc": kc, "vc": vc, "pos": pos, "latent": latent, "mimi": mimi_state}
        return new_state, self._pcm16(audio), is_eos

    def segment_bucket(self, max_frames: int) -> int | None:
        """The smallest ``segment_buckets`` entry covering ``max_frames``
        (None: too big for ``decode_segment``; callers take the chunk
        schedule)."""
        return next((b for b in self._rcfg.segment_buckets if max_frames <= b), None)

    @staticmethod
    def segment_groups(bucket: int, n_valid: int) -> list[tuple[int, int]]:
        """(first frame, frames) of each codec decode ``decode_segment`` runs:
        groups of ``min(CODEC_GROUP, bucket)`` frames that start below
        ``n_valid``, the last one cut at ``n_valid``."""
        group = min(CODEC_GROUP, bucket)
        return [(g, min(group, n_valid - g)) for g in range(0, n_valid, group)]

    def decode_segment(self, state: dict, gen: GenParams, generator: torch.Generator, *,
                       max_frames: int, frames_after_eos: int, bucket: int
                       ) -> tuple[dict, torch.Tensor, int, int]:
        """A whole B = 1 segment with the EOS stop rule: frames until
        ``n_valid = min(max_frames, eos_step + frames_after_eos)``, then the
        codec over those frames only.

        ``eos_step`` is the first frame whose EOS logit is above
        ``gen.eos_threshold``; it lives on the device and each frame updates
        it with ``torch.where``, so the frame loop never waits for the
        device.  The host learns it through ``_EosWatch``: on CUDA from a copy
        every ``SEGMENT_POLL`` frames, read once its event is done, which
        bounds the frames computed past the stop at ``SEGMENT_POLL +
        SEGMENT_MAX_LAG``; on the CPU it reads every frame (a read there waits
        for nothing), so the loop stops where the JAX package's while_loop
        does: at ``n_valid``, or at ``eos_step + 1`` when
        ``frames_after_eos`` is 0.  Frames past the stop count in
        ``frames_decoded`` / ``flow_evals`` and are never decoded by the
        codec.  The noise is one draw per frame from ``generator``, as in
        ``decode_frames``, so both paths agree at any temperature.

        The latents are denormalized and decoded in ``segment_groups``: the
        last group is decoded as it is, cut at ``n_valid`` (the codec is
        causal, so frames past ``n_valid`` change no emitted sample).
        ``bucket`` (at least ``max_frames``) sizes the latent buffer and the
        group.  Returns (state, wire audio [1, n_valid * 1920], n_valid,
        eos_step or -1), the two counts on the host."""
        if state["pos"].shape[0] != 1:
            raise ValueError("decode_segment decodes one lane (B = 1)")
        if not 0 < max_frames <= bucket:
            raise ValueError(f"decode_segment: max_frames {max_frames} outside (0, {bucket}]")
        params = self.params["flow_lm"]
        steps = gen.lsd_decode_steps
        table = flow_mlp.time_embedding_table(params["flow"], steps)
        kc, vc, pos, latent = state["kc"], state["vc"], state["pos"], state["latent"]
        latents = torch.empty((bucket, 1, self.ldim), dtype=torch.float32, device=self.device)
        eos_step = torch.full((), -1, dtype=torch.int32, device=self.device)
        watch = _EosWatch(self.device, bucket, max_frames, frames_after_eos)
        i = 0
        while i < watch.stop:
            noise = flow_lm.sample_noise(generator, (1, self.ldim), gen.temp, gen.noise_clamp,
                                         self.device)
            latent, eos_logit, _, _, pos = flow_lm.step(params, self.cfg, kc, vc, pos, latent,
                                                        noise, table, steps)
            latents[i].copy_(latent)
            eos_step = torch.where((eos_logit[0] > gen.eos_threshold) & (eos_step < 0), i,
                                   eos_step)
            i += 1
            watch.after_frame(i, eos_step)
        n_valid = watch.finish(i, eos_step)
        self.frames_decoded += i
        self.flow_evals += i * steps
        lat_bct = flow_lm.denormalize(params, latents[:n_valid]).permute(1, 2, 0)  # [1, ldim, n]
        mimi_state, pcm = state["mimi"], []
        for g, k in self.segment_groups(bucket, n_valid):
            audio, mimi_state = mimi.decode_step(self.params["mimi"], self.plans, mimi_state,
                                                 lat_bct[:, :, g:g + k])
            pcm.append(self._pcm16(audio))
        audio = (torch.cat(pcm, dim=1) if pcm
                 else torch.zeros((1, 0), dtype=self.wire_dtype, device=self.device))
        new_state = {"kc": kc, "vc": vc, "pos": pos, "latent": latent, "mimi": mimi_state}
        return new_state, audio, n_valid, watch.eos_step

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


class _EosWatch:
    """The host side of ``decode_segment``'s stop rule: which frame the loop
    stops at (``stop``) and the first EOS frame it has read (``eos_step``,
    -1 until one is read).

    ``after_frame(i, eos_step)`` runs after the i-th frame is enqueued.  Every
    ``poll`` frames (``SEGMENT_POLL`` on CUDA, 1 on the CPU) it enqueues a
    copy of the device's ``eos_step`` into a pinned host buffer and, on CUDA,
    records an event.  Copies are read in order: each as soon as its event is
    done, and the oldest one with a wait once ``SEGMENT_MAX_LAG`` frames have
    been enqueued after it.  The first copy that shows EOS at frame e is taken
    at most ``poll`` frames after e and read at most ``SEGMENT_MAX_LAG``
    frames after that, so the loop computes at most ``poll + SEGMENT_MAX_LAG``
    frames past ``min(max_frames, e + frames_after_eos)``.  ``event``:
    the event type (``torch.cuda.Event``; None on the CPU, where a copy is
    complete when ``copy_`` returns)."""

    def __init__(self, device: torch.device, bucket: int, max_frames: int,
                 frames_after_eos: int, *, poll: int | None = None, event=None):
        cuda = device.type == "cuda"
        self.poll = poll or (SEGMENT_POLL if cuda else 1)
        self.event = event or (torch.cuda.Event if cuda else None)
        self.host = torch.empty((bucket // self.poll + 1,), dtype=torch.int32, pin_memory=cuda)
        self.unread: collections.deque = collections.deque()  # (frames, slot, event)
        self.stop = max_frames
        self.max_frames = max_frames
        self.fae = frames_after_eos
        self.eos_step = -1

    def after_frame(self, i: int, eos_step: torch.Tensor) -> None:
        if self.eos_step >= 0:
            return
        if i % self.poll == 0:
            slot = i // self.poll
            self.host[slot].copy_(eos_step, non_blocking=True)
            ev = None
            if self.event is not None:
                ev = self.event()
                ev.record()
            self.unread.append((i, slot, ev))
        while self.unread and self.eos_step < 0:
            at, slot, ev = self.unread[0]
            if ev is not None and not ev.query():
                if i - at < SEGMENT_MAX_LAG:
                    return
                ev.synchronize()
            self.unread.popleft()
            self._read(int(self.host[slot]))

    def _read(self, e: int) -> None:
        if e >= 0:
            self.eos_step = e
            self.stop = min(self.max_frames, e + self.fae)
            self.unread.clear()

    def finish(self, i: int, eos_step: torch.Tensor) -> int:
        """``n_valid`` after the loop has computed ``i`` frames.  An EOS not
        read yet is read from the device here: one wait, after the last
        frame.  With ``frames_after_eos`` 0 the EOS frame itself was computed
        before the stop could show, and ``n_valid`` is clamped below it."""
        if self.eos_step < 0:
            self._read(int(eos_step))
        return i if self.eos_step < 0 else self.stop
