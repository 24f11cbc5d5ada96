"""TTSModel — the public orchestrator (port of ``pocket_tts_tpu/tts.py``,
single-stream synthesis with the empty voice on the chunk schedule).

``load`` / ``load_with_params`` / ``get_voice_state`` / ``generate`` /
``generate_stream``.  Host-side orchestration only: all compute is enqueued
by ``runtime.Engine`` on the model's device.  A voice state is a snapshot of
the FlowLM KV cache after conditioning prefill; every text segment restarts
from a copy of it.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import time
from typing import Iterator

import numpy as np
import torch

from pocket_tts_tpu_torch import text as text_mod
from pocket_tts_tpu_torch import weights as weights_mod
from pocket_tts_tpu_torch.config import (
    DEFAULT_EOS_THRESHOLD,
    DEFAULT_LSD_DECODE_STEPS,
    DEFAULT_NOISE_CLAMP,
    DEFAULT_TEMPERATURE,
    DEFAULT_VARIANT,
    Config,
    load_variant,
)
from pocket_tts_tpu_torch.runtime.engine import Engine, GenParams

logger = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class VoiceState:
    """Voice snapshot: prefilled KV cache + cursor.  ``length`` mirrors
    ``pos`` on the host so generation never syncs just to size the cache."""

    kc: torch.Tensor
    vc: torch.Tensor
    pos: torch.Tensor
    length: int = 0

    def as_dict(self) -> dict:
        return {"kc": self.kc, "vc": self.vc, "pos": self.pos}


class TTSModel:
    def __init__(self, cfg: Config, params: dict, *, gen: GenParams, has_real_weights: bool,
                 device: torch.device | str, seed: int = 0):
        self.config = cfg
        self.gen = gen
        self.has_real_weights = has_real_weights
        self.engine = Engine(cfg, params, device)
        self.device = self.engine.device
        self.tokenizer = text_mod.load_tokenizer(None)
        # host generator: draws one seed per text segment, in segment order, for
        # that segment's device generator (segments may be enqueued interleaved)
        self._rng = torch.Generator().manual_seed(seed)
        self._empty_voice: VoiceState | None = None

    # -- loading -----------------------------------------------------------

    @classmethod
    def load(cls, variant: str = DEFAULT_VARIANT, **kwargs) -> "TTSModel":
        return cls.load_with_params(variant, **kwargs)

    @classmethod
    def load_with_params(
        cls,
        variant: str = DEFAULT_VARIANT,
        temp: float = DEFAULT_TEMPERATURE,
        lsd_decode_steps: int = DEFAULT_LSD_DECODE_STEPS,
        noise_clamp: float | None = DEFAULT_NOISE_CLAMP,
        eos_threshold: float = DEFAULT_EOS_THRESHOLD,
        seed: int = 0,
        max_seq: int | None = None,
        device: torch.device | str | None = None,
    ) -> "TTSModel":
        """``device`` defaults to ``cuda`` when a card is visible, else ``cpu``.
        ``max_seq`` overrides the FlowLM KV-cache capacity (default 1024)."""
        cfg = load_variant(variant)
        if max_seq is not None:
            if max_seq < 256:
                raise ValueError(f"max_seq must be >= 256, got {max_seq}")
            cfg = dataclasses.replace(cfg, runtime=dataclasses.replace(cfg.runtime,
                                                                       max_seq=max_seq))
        if device is None:
            device = "cuda" if torch.cuda.is_available() else "cpu"
        params, real = weights_mod.load_params(cfg, variant=variant)
        gen = GenParams(temp=temp, lsd_decode_steps=lsd_decode_steps,
                        noise_clamp=noise_clamp, eos_threshold=eos_threshold)
        return cls(cfg, params, gen=gen, has_real_weights=real, device=device, seed=seed)

    @property
    def sample_rate(self) -> int:
        return self.config.mimi.sample_rate

    @property
    def frame_size(self) -> int:
        return self.config.mimi.frame_size

    # -- voice states ------------------------------------------------------

    def get_voice_state(self, source=None) -> VoiceState:
        """The unconditioned (empty) voice state, built once and shared: it is
        never written (segments decode from copies)."""
        if source is not None:
            raise NotImplementedError("voice cloning (Mimi encoder) is not ported yet")
        if self._empty_voice is None:
            st = self.engine.new_state()
            self._empty_voice = VoiceState(st["kc"], st["vc"], st["pos"], 0)
        return self._empty_voice

    # -- generation --------------------------------------------------------

    def estimate_generation_steps(self, text: str) -> int:
        prepared, _ = text_mod.prepare_text_prompt(text)
        return text_mod.max_generation_frames(prepared)

    def split_into_best_sentences(self, text: str) -> list[str]:
        return text_mod.split_into_best_sentences(self.tokenizer, text)

    def generate(self, text: str, voice_state: VoiceState | None = None,
                 frames_after_eos: int | None = None) -> np.ndarray:
        """Synthesize ``text`` -> float32 waveform [samples] @ 24 kHz.
        ``frames_after_eos``: extra frames after EOS; None derives it from the
        text length (1-3 frames + 2)."""
        chunks = list(self.generate_stream(text, voice_state, frames_after_eos,
                                           low_latency=False))
        return np.concatenate(chunks) if chunks else np.zeros(0, np.float32)

    def generate_stream(self, text: str, voice_state: VoiceState | None = None,
                        frames_after_eos: int | None = None, *,
                        low_latency: bool = True) -> Iterator[np.ndarray]:
        """Stream float32 audio chunks.  Text is split into <= 50-token
        sentence chunks; each restarts from the voice state.
        ``low_latency=False`` skips the warm-up chunk ramp; the audio is the
        same either way."""
        if voice_state is None:
            voice_state = self.get_voice_state()
        chunks = text_mod.split_into_best_sentences(self.tokenizer, text)
        yield from self._run_segments(chunks, voice_state, frames_after_eos, low_latency)

    def _run_segments(self, texts: list[str], voice_state: VoiceState,
                      frames_after_eos: int | None,
                      low_latency: bool = True) -> Iterator[np.ndarray]:
        """Drive the segments with chunks enqueued ahead of the fetches, across
        segment boundaries: the next segment's reset, prefill and first chunks
        are enqueued while the current one drains.  Every chunk depends only on
        its own segment's state and generator, so the audio equals serial
        execution.  Before any audio is out in streaming mode, only one chunk
        is in flight (it keeps time to first audio short)."""
        depth = max(1, self.engine._rcfg.pipeline_depth)
        queue = list(texts)
        active: list[_SegmentRun] = []
        emitted_any = not low_latency
        max_active = 2  # head + one lookahead (each holds a full KV cache copy)
        while queue or active:
            while True:
                in_flight = sum(len(s.pending) for s in active)
                if in_flight > (depth if emitted_any else 0):
                    break
                seg = next((s for s in active if s.dispatchable), None)
                if seg is not None:
                    seg.dispatch_one()
                    continue
                if queue and len(active) < max_active:
                    active.append(_SegmentRun(self, queue.pop(0), voice_state,
                                              frames_after_eos, low_latency))
                    continue
                break
            if not active:
                continue
            head = active[0]
            if head.pending and not head.done:
                out = head.fetch_one()
                if out is not None:
                    emitted_any = True
                    yield out
            if head.done or (not head.pending and not head.dispatchable):
                head.finish()
                active.pop(0)


class _SegmentRun:
    """Dispatch/fetch state machine for one text segment (single stream).

    Chunks are enqueued ahead of fetches; ``fetch_one`` reads the oldest
    chunk's audio and EOS flags (the only host sync), applies the stop rule
    ``min(max_frames, eos_step + frames_after_eos)`` and truncates overshoot.
    """

    def __init__(self, model: TTSModel, chunk_text: str, voice_state: VoiceState,
                 frames_after_eos: int | None, low_latency: bool = True):
        self.model = model
        self.t_start = time.monotonic()
        prepared, fae_guess = text_mod.prepare_text_prompt(chunk_text)
        self.frames_after_eos = (fae_guess + 2 if frames_after_eos is None
                                 else frames_after_eos)
        max_frames = text_mod.max_generation_frames(prepared)
        tokens, n_tokens = text_mod.tokens_array(model.tokenizer, prepared)
        eng = model.engine
        room = eng._rcfg.max_seq - voice_state.length
        clipped = max(room - n_tokens - 1, 0)
        if clipped < max_frames:
            logger.warning(
                "voice prompt (%d frames) leaves only %d of %d budgeted "
                "generation frames in the %d-position cache; audio may cut off",
                voice_state.length, clipped, max_frames, eng._rcfg.max_seq)
        self.max_frames = min(max_frames, clipped)
        state = eng.reset_for_segment(voice_state.as_dict())
        self.state = eng.prefill_tokens(state, tokens, n_tokens)
        seed = int(torch.randint(0, 2**62, (1,), generator=model._rng))
        self.generator = torch.Generator(device=eng.device).manual_seed(seed)
        self._schedule = iter(eng.chunk_schedule(self.max_frames, low_latency=low_latency))
        self._next_k = next(self._schedule, None) if self.max_frames else None
        self.issued = 0
        self.pending: list[tuple[int, torch.Tensor, torch.Tensor]] = []
        self.frames_done = 0
        self.eos_step: int | None = None
        self.total_samples = 0
        self.done = self.max_frames == 0

    @property
    def dispatchable(self) -> bool:
        return not self.done and self._next_k is not None and self.issued < self.max_frames

    def dispatch_one(self) -> None:
        k = self._next_k
        eng = self.model.engine
        self.state, audio, is_eos = eng.decode_frames(self.state, k, self.model.gen,
                                                      self.generator)
        self.pending.append((k, audio, is_eos))
        self.issued += k
        self._next_k = next(self._schedule, None)

    def fetch_one(self) -> np.ndarray | None:
        k, audio, is_eos = self.pending.pop(0)
        audio = self.model.engine.wire_to_float(audio[0].cpu().numpy())
        eos_np = is_eos[0].cpu().numpy()
        if self.eos_step is None:
            hits = np.nonzero(eos_np)[0]
            if hits.size:
                self.eos_step = self.frames_done + int(hits[0])
        target = self.max_frames if self.eos_step is None else min(
            self.max_frames, self.eos_step + self.frames_after_eos)
        emit = min(target, self.frames_done + k) - self.frames_done
        self.frames_done += k
        if self.frames_done >= target:
            self.done = True  # remaining pending chunks are dropped unfetched
        if emit > 0:
            out = audio[: emit * self.model.frame_size]
            self.total_samples += out.size
            return out
        return None

    def finish(self) -> None:
        if self.eos_step is None:
            # the K-prefixed spelling is the variable the reference checks
            if (os.environ.get("POCKET_TTS_ERROR_WITHOUT_EOS", "0") == "1"
                    or os.environ.get("KPOCKET_TTS_ERROR_WITHOUT_EOS", "0") == "1"):
                raise RuntimeError("Generation reached maximum length without EOS!")
            logger.warning("Maximum generation length reached without EOS, "
                           "this very often indicates an error.")
        dt = time.monotonic() - self.t_start
        if self.total_samples:
            dur = self.total_samples / self.model.sample_rate
            logger.info("Generated %.2f s audio in %.2f s (RTF %.3f, %.1fx realtime)",
                        dur, dt, dt / dur, dur / dt)
