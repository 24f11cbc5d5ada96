"""TTSModel — the public orchestrator (port of ``pocket_tts_tpu/tts.py``,
single-stream synthesis).

``load`` / ``load_with_params`` / ``load_from_bytes`` / ``load_quantized`` /
``with_params`` / ``get_voice_state*`` / ``save_voice_prompt`` /
``extend_voice_state`` / ``generate`` / ``generate_stream`` /
``generate_with_pauses`` / ``generate_stream_long``.  Host-side orchestration
only: all compute is enqueued by ``runtime.Engine`` on the model's device.  A
voice state is a snapshot of the FlowLM KV cache after conditioning prefill
(the Mimi-encoded, speaker-projected voice prompt); every text segment
restarts from a copy of it.
"""

from __future__ import annotations

import dataclasses
import logging
import math
import os
import time
from pathlib import Path
from typing import Iterator

import numpy as np
import torch

from pocket_tts_tpu_torch import audio as audio_io
from pocket_tts_tpu_torch import pause as pause_mod
from pocket_tts_tpu_torch import text as text_mod
from pocket_tts_tpu_torch import utils
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
from pocket_tts_tpu_torch.runtime.engine import Engine, GenParams, _clone

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


def codec_stage_device(device: torch.device) -> torch.device | None:
    """Where ``POCKET_TTS_STAGE_CODEC=1`` stages a model's codec: the first
    other CUDA device when the model is on a CUDA device and at least two
    are visible (the JAX package's ``jax.devices()[1]``), else None."""
    if os.environ.get("POCKET_TTS_STAGE_CODEC", "0") != "1" or device.type != "cuda":
        return None
    here = device.index or 0
    return next((torch.device("cuda", i) for i in range(torch.cuda.device_count())
                 if i != here), None)


def _check_device(device) -> None:
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"TTSModel.load: device {str(device)!r} but no CUDA device is "
                           "visible; pass device=\"cpu\" to run on the CPU")


class TTSModel:
    is_quantized = False

    def __init__(self, cfg: Config, params: dict, *, gen: GenParams, has_real_weights: bool,
                 device: torch.device | str, seed: int = 0):
        self.config = cfg
        self.gen = gen
        self.has_real_weights = has_real_weights
        # the unplaced float32 (or loaded quantized) params: quantize_model
        # quantizes these, never the engine's bf16 copy
        self.params = params
        self.engine = Engine(cfg, params, device)
        self.device = self.engine.device
        # the staged codec is opted into here, not in Engine: only the single
        # stream routes state through reset_for_segment's placement; a
        # ContinuousBatcher's engine (even at batch_size=1) never stages
        stage = codec_stage_device(self.device)
        if stage is not None:
            self.engine.enable_staged_codec(stage)
        self.tokenizer = text_mod.load_tokenizer(None)
        # host generator: draws one seed per text segment, in segment order, for
        # that segment's device generator (segments may be enqueued interleaved)
        self._rng = torch.Generator().manual_seed(seed)
        # the empty voice state, built once and shared through this holder by
        # every with_params / quantize_model clone: a per-clone attribute would
        # place a fresh max_seq cache on the device for every request
        self._empty_voice: dict = {"vs": None}

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
        voice_prompt_chunk_frames: int | None = None,
        max_seq: int | None = None,
        transport_format: str | None = None,
        kv_dtype: str | None = None,
        device: torch.device | str = "cuda",
    ) -> "TTSModel":
        """``device`` defaults to ``cuda``; with no card visible that raises
        RuntimeError, and the CPU runs only when asked (``device="cpu"``).
        ``voice_prompt_chunk_frames``, ``max_seq``, ``transport_format`` and
        ``kv_dtype``: see :meth:`_apply_config_overrides`."""
        cfg = cls._apply_config_overrides(
            load_variant(variant), transport_format=transport_format, kv_dtype=kv_dtype,
            voice_prompt_chunk_frames=voice_prompt_chunk_frames, max_seq=max_seq)
        _check_device(device)
        params, real = weights_mod.load_params(cfg, variant=variant)
        gen = GenParams(temp=temp, lsd_decode_steps=lsd_decode_steps,
                        noise_clamp=noise_clamp, eos_threshold=eos_threshold)
        return cls(cfg, params, gen=gen, has_real_weights=real, device=device, seed=seed)

    @staticmethod
    def _apply_config_overrides(cfg: Config, *, transport_format=None, kv_dtype=None,
                                voice_prompt_chunk_frames=None, max_seq=None) -> Config:
        """Runtime-config overrides shared by the loaders.

        * ``transport_format``: the device -> host wire, "int16" (exact) or
          "mulaw" (half the fetched bytes, ~37 dB SNR).  The keyword wins over
          ``POCKET_TTS_TRANSPORT``; the config's default otherwise.
        * ``kv_dtype``: the FlowLM KV cache's storage dtype ("auto",
          "bfloat16", "float32", "float8_e4m3", "float8_e5m2").  The keyword
          wins over ``POCKET_TTS_KV_DTYPE``.
        * ``voice_prompt_chunk_frames``: the chunk size of the streaming
          voice encoder (prompts over 30 s; default 240 frames).
        * ``max_seq``: the FlowLM KV-cache capacity (default 1024, at least
          256)."""
        rt = cfg.runtime
        transport = transport_format or os.environ.get("POCKET_TTS_TRANSPORT")
        if transport is not None:
            rt = dataclasses.replace(rt, transport_format=transport)
        kvd = kv_dtype or os.environ.get("POCKET_TTS_KV_DTYPE")
        if kvd is not None:
            rt = dataclasses.replace(rt, kv_dtype=kvd)
        if voice_prompt_chunk_frames is not None:
            rt = dataclasses.replace(rt, voice_prompt_chunk_frames=voice_prompt_chunk_frames)
        if max_seq is not None:
            if max_seq < 256:
                raise ValueError(f"max_seq must be >= 256, got {max_seq}")
            rt = dataclasses.replace(rt, max_seq=max_seq,
                                     window_buckets=tuple(range(256, max_seq, 256)))
        return dataclasses.replace(cfg, runtime=rt)

    _GEN_KEYS = ("temp", "lsd_decode_steps", "noise_clamp", "eos_threshold")
    _CFG_KEYS = ("transport_format", "kv_dtype", "voice_prompt_chunk_frames", "max_seq")

    @classmethod
    def _parse_loader_kwargs(cls, cfg: Config, kwargs: dict):
        """(cfg, gen, seed, device) for the ``**kwargs`` loaders: the
        GenParams and runtime overrides of :meth:`load_with_params`; an
        unknown key raises TypeError."""
        kw = dict(kwargs)
        gen = GenParams(**{k: kw.pop(k) for k in cls._GEN_KEYS if k in kw})
        seed = kw.pop("seed", 0)
        device = kw.pop("device", "cuda")
        cfg = cls._apply_config_overrides(cfg, **{k: kw.pop(k) for k in cls._CFG_KEYS if k in kw})
        if kw:
            raise TypeError(f"unknown load kwargs: {sorted(kw)}")
        return cfg, gen, seed, device

    @classmethod
    def load_from_bytes(cls, weights_bytes: bytes, variant: str = DEFAULT_VARIANT,
                        **kwargs) -> "TTSModel":
        """Load from in-memory safetensors bytes (the combined checkpoint
        layout); the weights are never written to or read from a file.
        ``kwargs``: those of :meth:`load_with_params`."""
        cfg, gen, seed, device = cls._parse_loader_kwargs(load_variant(variant), kwargs)
        _check_device(device)
        params = weights_mod.from_state_dict(weights_mod.read_safetensors_bytes(weights_bytes),
                                             cfg)
        return cls(cfg, params, gen=gen, has_real_weights=True, device=device, seed=seed)

    @classmethod
    def load_quantized(cls, path: str | Path, variant: str = DEFAULT_VARIANT,
                       **kwargs) -> "TTSModel":
        """Load a quantized artifact (``runtime.quantize.save_quantized``, of
        this package or the JAX package; ``hf://`` URIs resolve through the
        local Hugging Face cache).  ``kwargs``: those of
        :meth:`load_with_params`."""
        from pocket_tts_tpu_torch.runtime.quantize import load_quantized

        cfg, gen, seed, device = cls._parse_loader_kwargs(load_variant(variant), kwargs)
        _check_device(device)
        params = load_quantized(weights_mod.resolve_uri(path))
        model = cls(cfg, params, gen=gen, has_real_weights=True, device=device, seed=seed)
        model.is_quantized = True
        return model

    def with_params(self, **overrides) -> "TTSModel":
        """A per-request clone with other generation knobs (``temp``,
        ``lsd_decode_steps``, ``noise_clamp``, ``eos_threshold``).  It shares
        the params, the engine, the tokenizer, the host generator and the
        empty voice state: nothing is placed on the device.  ``None`` means
        "not overridden"; ``noise_clamp=-1`` unclamps.  An invalid knob
        raises ValueError (``GenParams``)."""
        clone = object.__new__(type(self))
        clone.__dict__.update(self.__dict__)
        clone.gen = dataclasses.replace(
            self.gen, **{k: v for k, v in overrides.items() if v is not None})
        return clone

    @property
    def sample_rate(self) -> int:
        return self.config.mimi.sample_rate

    @property
    def frame_size(self) -> int:
        return self.config.mimi.frame_size

    # -- voice states ------------------------------------------------------

    def get_voice_state(self, source: str | Path | bytes | None = None,
                        truncate: bool = False, overflow: str | None = None) -> VoiceState:
        """Voice state from ``source``, or the unconditioned (empty) state.

        ``source`` may be a WAV path or WAV bytes (Mimi encoder, speaker
        projection, conditioning prefill) or an ``audio_prompt`` safetensors
        path (the stock-voice format).  ``truncate`` keeps the first 30 s of
        a WAV; ``overflow`` is the over-budget policy of
        ``get_voice_state_from_audio``.  The empty state is built once and
        shared: it is never written (segments decode from copies)."""
        if source is not None:
            if isinstance(source, (str, Path)) and str(source).endswith(".safetensors"):
                return self.get_voice_state_from_prompt_file(source)
            return self.get_voice_state_from_wav(source, truncate=truncate, overflow=overflow)
        if self._empty_voice["vs"] is None:
            st = self.engine.new_state()
            self._empty_voice["vs"] = VoiceState(st["kc"], st["vc"], st["pos"], 0)
        return self._empty_voice["vs"]

    def get_voice_state_from_wav(self, path: str | Path | bytes, truncate: bool = False,
                                 overflow: str | None = None) -> VoiceState:
        wav, sr = audio_io.read_wav(path)
        if truncate:
            wav = wav[..., : 30 * sr]
        wav = audio_io.convert_audio(wav, sr, self.sample_rate, 1)
        return self.get_voice_state_from_audio(wav, overflow=overflow)

    def get_voice_state_from_audio(self, wav: np.ndarray,
                                   overflow: str | None = None) -> VoiceState:
        """24 kHz mono waveform -> voice state.

        ``overflow`` sets what happens to a prompt longer than the cache
        budget (``max_seq`` minus ``engine.prompt_reserve``, 768 frames or
        61.44 s at the default 1024):

        * ``"truncate"``: keep the head of the prompt.
        * ``"compress"``: encode the whole prompt, then keep its first
          budget/4 frames (the speaker's onset) and its most recent
          3·budget/4 frames, prefilled contiguously.

        ``None`` reads ``POCKET_TTS_VOICE_OVERFLOW`` (default "truncate")."""
        if overflow is None:
            overflow = os.environ.get("POCKET_TTS_VOICE_OVERFLOW", "truncate")
        if overflow not in ("truncate", "compress"):
            raise ValueError(f"overflow must be 'truncate' or 'compress', got {overflow!r}")
        eng = self.engine
        cond, n_frames = eng.encode_voice(wav, cap=overflow == "truncate")
        budget = eng._rcfg.max_seq - eng.prompt_reserve
        if overflow == "compress" and n_frames > budget:
            sink = budget // 4
            cond = torch.cat([cond[:, :sink], cond[:, n_frames - (budget - sink):]], dim=1)
            logger.info("voice prompt %d frames > %d budget: compressed to %d-frame sink + "
                        "%d-frame recency", n_frames, budget, sink, budget - sink)
            n_frames = budget
        return self._prefill_voice(cond, n_frames)

    def get_voice_state_from_prompt(self, prompt) -> VoiceState:
        """From a precomputed ``audio_prompt`` conditioning [1, T, d_model] or
        [T, d_model] (numpy or tensor), the stock-voice format."""
        prompt = torch.as_tensor(np.asarray(prompt, np.float32))
        if prompt.dim() == 2:
            prompt = prompt[None]
        return self._prefill_voice(prompt.to(self.device), prompt.shape[1])

    def get_voice_state_from_prompt_file(self, path: str | Path) -> VoiceState:
        return self.get_voice_state_from_prompt(
            weights_mod.read_safetensors(path)["audio_prompt"])

    def save_voice_prompt(self, wav: np.ndarray, path: str | Path) -> None:
        """Encode a 24 kHz waveform and save its conditioning as an
        ``audio_prompt`` safetensors file (float32 [1, frames, d_model]),
        loadable with ``get_voice_state``."""
        cond, _ = self.engine.encode_voice(wav)
        weights_mod.write_safetensors({"audio_prompt": cond.float().cpu().numpy()}, path)

    def _prefill_voice(self, cond: torch.Tensor, n_frames: int,
                       base: VoiceState | None = None) -> VoiceState:
        """Prefill ``cond`` [1, n_frames, d_model] into a fresh cache, or into
        a copy of ``base``'s (prefill writes in place; a voice state is never
        written).  Conditioning over the room left beside the generation
        reserve is clipped to its most recent frames; the rest is prefilled
        in pieces of ``max(prompt_buckets)`` frames, whose positions continue
        from the cursor, so the pieces equal one prefill."""
        eng = self.engine
        if base is None:
            st, base_len = eng.new_state(), 0
        else:
            st = {k: _clone(v) for k, v in base.as_dict().items()}
            base_len = base.length
        room = max(0, eng._rcfg.max_seq - eng.prompt_reserve - base_len)
        if n_frames > room:
            logger.warning(
                "voice conditioning (%d frames) exceeds the %d-position cache budget; "
                "keeping the most recent %d frames (load with max_seq=<bigger> for "
                "longer prompts)", n_frames, eng._rcfg.max_seq, room)
            cond = cond[:, n_frames - room: n_frames]
            n_frames = room
        piece = max(eng._rcfg.prompt_buckets)
        for off in range(0, n_frames, piece):
            n = min(piece, n_frames - off)
            st = eng.prefill_conditioning(st, cond[:, off:off + n], n)
        return VoiceState(st["kc"], st["vc"], st["pos"], base_len + n_frames)

    def extend_voice_state(self, voice_state: VoiceState, wav: np.ndarray) -> VoiceState:
        """Prefill the conditioning of ``wav`` (24 kHz mono) after the
        snapshot's, as if the voice prompt had been that much longer; the
        snapshot itself is not written.  Conditioning over the remaining
        budget is clipped to its most recent frames; with no room left the
        snapshot is returned unchanged."""
        eng = self.engine
        room = eng._rcfg.max_seq - eng.prompt_reserve - voice_state.length
        if room <= 0:
            logger.warning("voice state (%d frames) already fills the cache budget; "
                           "skipping continuation conditioning", voice_state.length)
            return voice_state
        cond, n_frames = eng.encode_voice(wav)
        if n_frames > room:
            cond, n_frames = cond[:, n_frames - room:], room
        return self._prefill_voice(cond, n_frames, base=voice_state)

    # -- generation --------------------------------------------------------

    def estimate_generation_steps(self, text: str) -> int:
        prepared, _ = text_mod.prepare_text_prompt(text)
        return text_mod.max_generation_frames(prepared)

    def split_into_best_sentences(self, text: str) -> list[str]:
        return text_mod.split_into_best_sentences(self.tokenizer, text)

    def generate(self, text: str, voice_state: VoiceState | None = None,
                 frames_after_eos: int | None = None, *,
                 continuation_frames: int = 0) -> np.ndarray:
        """Synthesize ``text`` -> float32 waveform [samples] @ 24 kHz.
        ``frames_after_eos``: extra frames after EOS; None derives it from the
        text length (1-3 frames + 2)."""
        chunks = list(self.generate_stream(text, voice_state, frames_after_eos,
                                           low_latency=False,
                                           continuation_frames=continuation_frames))
        return np.concatenate(chunks) if chunks else np.zeros(0, np.float32)

    def generate_stream(self, text: str, voice_state: VoiceState | None = None,
                        frames_after_eos: int | None = None, *,
                        low_latency: bool = True, continuation_frames: int = 0,
                        _tail: dict | None = None,
                        _request: int | None = None) -> Iterator[np.ndarray]:
        """Stream float32 audio chunks.  Text is split into <= 50-token
        sentence chunks; each restarts from the voice state.
        ``low_latency=False`` skips the warm-up chunk ramp; the audio is the
        same either way.

        ``continuation_frames`` > 0: each segment after the first is
        conditioned on the last N frames of audio generated so far,
        re-encoded and prefilled on top of the voice state, so prosody
        carries across segment boundaries.  Such segments run one after
        another.  ``_tail`` ({"audio": array}) carries that tail in from and
        out to the caller (``generate_stream_long`` bridges pauses with it).
        ``_request``: the span request id of a caller that made one."""
        request = utils.new_request() if _request is None else _request
        if voice_state is None:
            voice_state = self.get_voice_state()
        chunks = text_mod.split_into_best_sentences(self.tokenizer, text)
        if continuation_frames > 0 and (len(chunks) > 1 or _tail is not None):
            yield from self._run_segments_continuation(
                chunks, voice_state, frames_after_eos, low_latency, continuation_frames, _tail,
                request)
        else:
            yield from self._run_segments(chunks, voice_state, frames_after_eos, low_latency,
                                          request)

    def generate_with_pauses(self, text: str, voice_state: VoiceState | None = None, *,
                             continuation_frames: int = 0) -> np.ndarray:
        chunks = list(self.generate_stream_long(text, voice_state, low_latency=False,
                                                continuation_frames=continuation_frames))
        return np.concatenate(chunks) if chunks else np.zeros(0, np.float32)

    def generate_stream_long(self, text: str, voice_state: VoiceState | None = None,
                             frames_after_eos: int | None = None, *,
                             low_latency: bool = True,
                             continuation_frames: int = 0) -> Iterator[np.ndarray]:
        """Pause-aware streaming: text segments interleaved with exact
        silence for ``[pause:Xms]`` markers, ellipses and commas.  One
        continuation tail spans the whole utterance, so conditioning carries
        across the pauses."""
        request = utils.new_request()
        if voice_state is None:
            voice_state = self.get_voice_state()
        tail = {"audio": np.zeros(0, np.float32)} if continuation_frames > 0 else None
        for seg in pause_mod.segment_text(text):
            if seg.kind == "pause":
                yield np.zeros(pause_mod.silence_samples(seg.duration_ms, self.sample_rate),
                               np.float32)
            else:
                yield from self.generate_stream(
                    seg.text, voice_state, frames_after_eos, low_latency=low_latency,
                    continuation_frames=continuation_frames, _tail=tail, _request=request)

    def _run_segments(self, texts: list[str], voice_state: VoiceState,
                      frames_after_eos: int | None, low_latency: bool = True,
                      request: int = 0) -> Iterator[np.ndarray]:
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
                                              frames_after_eos, low_latency, request))
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


    def _run_segments_continuation(self, texts: list[str], voice_state: VoiceState,
                                   frames_after_eos: int | None, low_latency: bool,
                                   continuation_frames: int,
                                   tail_holder: dict | None = None,
                                   request: int = 0) -> Iterator[np.ndarray]:
        """``_run_segments`` with each segment conditioned on the tail of the
        audio so far.  Every segment extends the ORIGINAL voice state, so the
        cache holds at most voice + continuation + text + generation."""
        tail_cap = continuation_frames * self.frame_size
        if tail_holder is None:
            tail_holder = {"audio": np.zeros(0, np.float32)}
        for text in texts:
            tail = tail_holder["audio"]
            vs = self.extend_voice_state(voice_state, tail) if tail.size else voice_state
            for out in self._run_segments([text], vs, frames_after_eos, low_latency, request):
                tail_holder["audio"] = np.concatenate([tail_holder["audio"], out])[-tail_cap:]
                yield out


class _SegmentRun:
    """Dispatch/fetch state machine for one text segment (single stream).

    Whole-utterance segments (``low_latency=False``) whose frame budget fits a
    ``segment_buckets`` entry decode in one ``Engine.decode_segment`` call,
    which stops at EOS + ``frames_after_eos`` itself, when
    ``runtime.segment_dispatch`` is "auto" and the EOS threshold is finite
    (with EOS unreachable there is nothing to stop early).  The others run
    the chunk schedule: chunks are enqueued ahead of fetches; ``fetch_one``
    reads the oldest chunk's audio and EOS flags (the only host sync),
    applies the stop rule ``min(max_frames, eos_step + frames_after_eos)``
    and truncates overshoot.

    Spans (``utils.span``, under the request id ``request``): ``tts.setup``
    around the set-up below, ``tts.dispatch`` (n: frames enqueued) and
    ``tts.fetch`` (n: frames emitted).
    """

    def __init__(self, model: TTSModel, chunk_text: str, voice_state: VoiceState,
                 frames_after_eos: int | None, low_latency: bool = True, request: int = 0):
        self.model = model
        self.request = request
        self.t_start = time.monotonic()
        with utils.span("tts.setup", 1, request):
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
            self.fused_bucket = None
            if (not low_latency and self.max_frames and eng._rcfg.segment_dispatch == "auto"
                    and eng._codec_device is None and math.isfinite(model.gen.eos_threshold)):
                self.fused_bucket = eng.segment_bucket(self.max_frames)
            if self.fused_bucket is not None:
                self._schedule = iter([self.fused_bucket])
            else:
                self._schedule = iter(eng.chunk_schedule(self.max_frames, low_latency=low_latency))
            self._next_k = next(self._schedule, None) if self.max_frames else None
            self.issued = 0
            self.pending: list[tuple] = []
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
        with utils.span("tts.dispatch", k, self.request):
            if self.fused_bucket is not None:
                self.state, audio, n_valid, eos_step = eng.decode_segment(
                    self.state, self.model.gen, self.generator, max_frames=self.max_frames,
                    frames_after_eos=self.frames_after_eos, bucket=k)
                self.pending.append(("fused", audio, n_valid, eos_step))
            else:
                self.state, audio, is_eos = eng.decode_frames(self.state, k, self.model.gen,
                                                              self.generator)
                self.pending.append((k, audio, is_eos))
        self.issued += k
        self._next_k = next(self._schedule, None)

    def fetch_one(self) -> np.ndarray | None:
        with utils.span("tts.fetch", 0, self.request) as s:
            out = self._fetch()
            if out is not None:
                s.n = out.size // self.model.frame_size
        return out

    def _fetch(self) -> np.ndarray | None:
        if self.pending[0][0] == "fused":
            _, audio, n_valid, eos_step = self.pending.pop(0)
            self.eos_step = eos_step if eos_step >= 0 else None
            self.frames_done = n_valid
            self.done = True
            if n_valid == 0:
                return None
            out = self.model.engine.wire_to_float(audio[0].cpu().numpy())
            self.total_samples += out.size
            return out
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
