"""Continuous-batched serving: one decode loop, many concurrent requests (port
of ``pocket_tts_tpu/runtime/batcher.py``).

A B-slot generation state stays resident and ONE decode loop runs chunks over
all slots, admitting and retiring requests between chunks:

* Each request is split into its independent <= 50-token text segments up
  front; segments of one request synthesize in parallel across slots and are
  reassembled in order on emit.
* Admission (``Engine.admit_prefill_slot``) copies the voice snapshot into a
  free slot's cache lane and prefills its text at B = 1 on that lane, in
  place; other lanes are untouched.  The token row is made at ``submit``
  time, pinned, so its upload is enqueued and never waited for.
* Per-slot temperature / EOS-threshold vectors, and per-slot LSD step counts
  and noise clamps as data (masked Euler steps); EOS and frame budgets are
  tracked on the host; retired slots keep computing garbage until reused.
* Per-slot LoRA (``adapter_bank``): a request may name an adapter of the
  bank; its lane's prefill and decode mix that adapter's delta in, while
  other lanes serve other adapters or the base model.  Decodes take the
  adapter path only while an adapter request is resident.
* Streaming arrivals get bounded time to first audio: priority admission, a
  warm-chunk ramp at pipeline depth 0-1, preemption of segments that have
  emitted nothing at full occupancy, and a saturation guard that drops the
  ramp when the streaming backlog exceeds the batch.  Abandoned streams
  cancel their remaining work.

Device side: the loop runs on its own thread, on the model's device and on
the CUDA stream current when the batcher was made (the current stream and
grad mode are per thread), with one ``torch.Generator`` it owns.  A chunk's
audio and EOS flags are copied into pinned host buffers when it is
dispatched, and a CUDA event is recorded after the copies; fetching a chunk
waits on that event only, so a chunk in flight behind it keeps running.

Spans (``utils.span``; ``/metrics`` exports their totals): ``batcher.queue``
(a segment's wait from submit, or from its preemption, to admission),
``batcher.admit`` (its admission and prefill), ``batcher.dispatch`` (one
chunk's ``decode_frames``; n: lane-frames), ``batcher.route`` (a chunk's
fetch and routing; n: frames emitted) and ``batcher.idle`` (the loop's poll
while no slot is active).
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import queue
import threading
import time
from typing import Iterator

import numpy as np
import torch

from pocket_tts_tpu_torch import pause as pause_mod
from pocket_tts_tpu_torch import text as text_mod
from pocket_tts_tpu_torch import utils
from pocket_tts_tpu_torch.runtime.engine import Engine, GenParams
from pocket_tts_tpu_torch.tts import TTSModel, VoiceState

logger = logging.getLogger(__name__)

_SENTINEL = object()


@dataclasses.dataclass(eq=False)
class _Segment:
    request: "_Request"
    index: int  # position within the request (for ordered reassembly)
    kind: str  # "text" | "silence"
    tokens: np.ndarray | None = None
    n_tokens: int = 0
    max_frames: int = 0
    frames_after_eos: int = 0
    silence_samples: int = 0
    # [1, bucket] token row made on the SUBMITTING thread (pinned on CUDA),
    # so admission only enqueues its upload
    d_tokens: object = None
    # True only for the FIRST text segment of a latency-sensitive (streaming)
    # request: the one whose first chunk gates time to first audio
    ramp: bool = False
    seq: int = 0  # global submission order (FIFO within a priority class)
    queued_ns: int = 0  # perf_counter_ns when it joined the admission queue
    # bumped on preemption so stale in-flight chunks stop crediting frames
    epoch: int = 0
    # filled during decode.  Progress lives on the SEGMENT, not the slot: with
    # early lane retirement a lane can be re-admitted to a new segment while
    # this one's final chunks are still in flight
    chunks: list = dataclasses.field(default_factory=list)
    done: bool = False
    frames_routed: int = 0      # frames fetched & credited to this segment
    eos_step: int | None = None

    @property
    def target(self) -> int:
        """Exact frame budget: max_frames until EOS is discovered, then the
        host stop rule min(max_frames, eos_step + frames_after_eos)."""
        if self.eos_step is None:
            return self.max_frames
        return min(self.max_frames, self.eos_step + self.frames_after_eos)


@dataclasses.dataclass(eq=False)
class _Request:
    voice: VoiceState
    gen: GenParams
    out: queue.Queue
    latency_sensitive: bool = False  # streaming consumer (vs whole-WAV)
    # [N] adapter-bank row (None = the base model): the request's text
    # prefills and decode run through that adapter's delta on its lane
    lora_row: np.ndarray | None = None
    span_request: int = 0  # utils.new_request() id of its spans
    segments: list = dataclasses.field(default_factory=list)
    emitted_upto: int = 0  # next segment index to stream out
    finished: bool = False
    failed: bool = False

    def pump(self):
        """Emit chunks of completed-prefix segments in order."""
        if self.finished:
            return
        while self.emitted_upto < len(self.segments):
            seg = self.segments[self.emitted_upto]
            for c in seg.chunks:
                self.out.put(c)
            seg.chunks = []
            if not seg.done:
                return
            self.emitted_upto += 1
        self.finished = True
        self.out.put(_SENTINEL)


@dataclasses.dataclass
class _Slot:
    """Lane ownership only: which segment the lane's NEXT dispatch computes
    for, and how far its dispatch frontier has advanced.  Fetch-side progress
    is on the segment (owner snapshots route in-flight results)."""

    segment: _Segment | None = None
    dispatched: int = 0    # frames dispatched for the CURRENT segment

    @property
    def free(self) -> bool:
        return self.segment is None


class ContinuousBatcher:
    """Owns a batched Engine and a background decode thread."""

    def __init__(self, model: TTSModel, batch_size: int = 4,
                 chunk_frames: int = 8, seed: int = 0, depth: int = 2,
                 warm_chunk: int | None = None, adapter_bank=None):
        self.model = model
        self.batch = batch_size
        self.chunk = chunk_frames
        # Warm-up ramp: while any ramp slot is still "young" (dispatched fewer
        # than ramp_frames), the loop uses this smaller chunk and caps the
        # pipeline at one dispatch in flight, so a newcomer's first audio is
        # not stuck behind deep steady chunks.  None disables the ramp.
        self.warm_chunk = min(warm_chunk or chunk_frames, chunk_frames)
        self.ramp_frames = 2 * self.warm_chunk if self.warm_chunk < chunk_frames else 0
        # mid-size chunk while streaming requests are resident; equal to
        # chunk_frames when the ramp is disabled
        self.serve_chunk = (max(self.warm_chunk, chunk_frames // 2)
                            if self.ramp_frames else chunk_frames)
        # arrival-pressure chunk, while streaming admissions WAIT (occupancy
        # full, not yet saturated): the loop turns over sooner, so
        # retirements are found and waiters admitted behind less backlog
        self.press_chunk = (max(self.warm_chunk, self.serve_chunk // 2)
                            if self.ramp_frames else chunk_frames)
        # pipeline depth: dispatches in flight before the oldest is fetched.
        # EOS discovery / lane retirement lag by depth * chunk frames (the
        # overshoot is computed and discarded)
        self.depth = max(1, depth)
        # shares the model engine's placed parameters (no second device copy)
        self.engine = Engine(model.config, model.engine.params, model.device,
                             batch_size=batch_size)
        # training.lora.AdapterBank: requests carry per-slot rows of it
        self.bank = adapter_bank
        if adapter_bank is not None:
            self.engine.set_adapter_bank(adapter_bank)
        self.tokenizer = model.tokenizer
        dev = self.engine.device
        self._generator = torch.Generator(device=dev).manual_seed(seed ^ 0x5EED)
        self._stream = torch.cuda.current_stream(dev) if dev.type == "cuda" else None
        self._submit: queue.Queue[_Segment] = queue.Queue()
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._dead = False
        self._active: set[_Request] = set()  # requests not yet finished
        self._seq = 0  # submission counter (under _lock)
        self._waiting_n = 0  # segments drained but not yet admitted
        # observability counters (written by the decode thread / submit)
        self._stats = {"dispatches": 0, "warm_dispatches": 0,
                       "serve_dispatches": 0,
                       "frames_decoded": 0, "useful_frames": 0,
                       "early_retirements": 0, "preemptions": 0,
                       "requests_completed": 0, "requests_submitted": 0,
                       "requests_cancelled": 0}

    def warmup(self) -> None:
        """One throwaway admission and one throwaway dispatch per chunk size
        the loop can choose (plus one with per-slot step counts), on a
        throwaway state, before serving: the first runs the flow kernel's
        build (nvcc, on CUDA) and the first launch of every op and shape, so
        no request pays for them.  Nothing is compiled per shape."""
        engine, gen = self.engine, self.model.gen
        generator = torch.Generator(device=engine.device).manual_seed(0)
        state = engine.new_state(self.batch)
        row = engine.pad_token_row(np.ones((1, 1), np.int32))
        state = engine.admit_prefill_slot(state, 0, self.model.get_voice_state().as_dict(),
                                          row, 1)
        temps = np.full((self.batch,), gen.temp, np.float32)
        eos_th = np.full((self.batch,), gen.eos_threshold, np.float32)
        audios = []
        for k in sorted({self.warm_chunk, self.press_chunk, self.serve_chunk, self.chunk}):
            state, audio, _ = engine.decode_frames(state, k, gen, generator, temps=temps,
                                                   eos_thresholds=eos_th)
            audios.append(audio)
        _, audio, _ = engine.decode_frames(
            state, self.warm_chunk, gen, generator, temps=temps, eos_thresholds=eos_th,
            lsd_vec=np.full((self.batch,), 2), clamp_vec=np.full((self.batch,), -1.0))
        audios.append(audio)
        if self.bank is not None:  # the adapter path's admission and decode
            zero = np.zeros(self.bank.n, np.float32)
            state = engine.admit_prefill_slot(state, 0, self.model.get_voice_state().as_dict(),
                                              row, 1, lora_row=zero)
            _, audio, _ = engine.decode_frames(state, self.warm_chunk, gen, generator,
                                               temps=temps, eos_thresholds=eos_th,
                                               lora_w=np.zeros((self.batch, self.bank.n)))
            audios.append(audio)
        for a in audios:
            a.cpu()

    def idle(self) -> bool:
        """True when no request is active or queued."""
        with self._lock:
            return not self._active and self._submit.qsize() == 0

    def stats(self) -> dict:
        """Snapshot of the decode loop's counters plus live queue depths.

        ``useful_frames`` counts frames emitted to consumers;
        ``frames_decoded`` counts slot-frames dispatched on segment-owned
        lanes.  Their ratio is the batch's compute efficiency: the gap is
        EOS/budget overshoot (bounded by the pipeline depth) plus
        preemption-discarded work."""
        with self._lock:
            dec = self._stats["frames_decoded"]
            return {**self._stats,
                    "useful_ratio": (round(self._stats["useful_frames"] / dec, 3)
                                     if dec else None),
                    "active_requests": len(self._active),
                    "queued_segments": self._submit.qsize() + self._waiting_n,
                    "batch_size": self.batch,
                    "chunk_frames": self.chunk,
                    "dead": self._dead}

    # -- public API ----------------------------------------------------------

    def start(self) -> None:
        if self._thread is None:
            self._stop.clear()
            self._dead = False
            self._thread = threading.Thread(target=self._run, daemon=True,
                                            name="tts-batcher")
            self._thread.start()

    def stop(self, timeout: float = 600.0) -> None:
        """Stop the decode loop, waiting out the dispatch in progress, then
        fail open: every unfinished request gets an error and its sentinel,
        and later submissions raise."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout)
            if self._thread.is_alive():
                logger.error("batcher decode thread still running after %.0f s; "
                             "abandoning it", timeout)
            self._thread = None
        self._fail_open(RuntimeError("batcher stopped"))

    def submit(self, text: str, voice: VoiceState | None = None,
               gen: GenParams | None = None, *, pauses: bool = True,
               latency_sensitive: bool = True,
               frames_after_eos: int | None = None,
               adapter: str | None = None) -> queue.Queue:
        """Enqueue a request; returns a queue of float32 chunks ending with a
        sentinel (use :meth:`stream` for an iterator).

        ``pauses=True`` gives ``generate_with_pauses`` semantics
        ([pause:Xms] and natural comma/ellipsis silence); ``False`` matches
        plain ``generate``.  ``latency_sensitive=True`` (streaming consumers)
        gives the request's first text segment the warm-chunk admission ramp;
        ``False`` (whole-WAV consumers) optimizes completion time only.
        ``frames_after_eos``: extra frames past EOS for every text segment;
        None derives it per sentence from the text length.

        ``adapter``: a name in the batcher's ``AdapterBank``; this request's
        prefill and decode run through that adapter on its lane.  Its voice
        state should come from the same adapter's merged model (a voice state
        is a prefill through the backbone).  A name the bank lacks raises
        KeyError; any adapter on a batcher without a bank raises ValueError."""
        if not text or not text.strip():
            raise ValueError("Text prompt cannot be empty")
        if self._dead:
            raise RuntimeError("batcher decode loop has crashed; restart it")
        lora_row = None
        if adapter is not None:
            if self.bank is None:
                raise ValueError(f"adapter {adapter!r} requested but this batcher has no "
                                 "adapter bank")
            lora_row = self.bank.row(adapter)  # KeyError for an unknown name
        if voice is None:
            voice = self.model.get_voice_state()
        gen = gen or self.model.gen
        req = _Request(voice=voice, gen=gen, out=queue.Queue(),
                       latency_sensitive=latency_sensitive, lora_row=lora_row,
                       span_request=utils.new_request())
        req.out._pocket_request = req  # lets stream() cancel on disconnect

        if pauses:
            parts = pause_mod.segment_text(text)
        else:
            parts = [pause_mod.Segment("text", text=text)]
        index = 0
        for part in parts:
            if part.kind == "pause":
                n = pause_mod.silence_samples(part.duration_ms, self.model.sample_rate)
                req.segments.append(_Segment(req, index, "silence", silence_samples=n))
                index += 1
                continue
            for chunk in text_mod.split_into_best_sentences(self.tokenizer, part.text):
                prepared, fae = text_mod.prepare_text_prompt(chunk)
                tokens, n_tokens = text_mod.tokens_array(self.tokenizer, prepared)
                max_frames = text_mod.max_generation_frames(prepared)
                room = self.engine._rcfg.max_seq - voice.length - n_tokens - 1
                if room < max_frames:
                    logger.warning(
                        "voice prompt (%d frames) leaves only %d of %d budgeted "
                        "generation frames; audio may cut off",
                        voice.length, max(0, room), max_frames)
                first_text = not any(s.kind == "text" for s in req.segments)
                with self._lock:
                    self._seq += 1
                    seq = self._seq
                seg = _Segment(req, index, "text", tokens=tokens, n_tokens=n_tokens,
                               max_frames=max(0, min(max_frames, room)),
                               frames_after_eos=(fae + 2 if frames_after_eos is None
                                                 else frames_after_eos),
                               ramp=latency_sensitive and first_text, seq=seq)
                seg.d_tokens = self.engine.pad_token_row(tokens)
                req.segments.append(seg)
                index += 1
        if not req.segments:
            req.out.put(_SENTINEL)
            return req.out
        for seg in req.segments:
            if seg.kind == "silence":
                seg.chunks = [np.zeros(seg.silence_samples, np.float32)]
                seg.done = True
        with self._lock:
            # re-check under the lock: the loop may have crashed (or stop()
            # run) meanwhile, and registering now would miss the fail-open
            # sweep and strand the consumer
            if self._dead:
                raise RuntimeError("batcher decode loop has crashed; restart it")
            self._active.add(req)
            self._stats["requests_submitted"] += 1
            req.pump()
            if req.finished:  # e.g. a pause-only request: done synchronously
                self._active.discard(req)
                self._stats["requests_completed"] += 1
                return req.out
        # enqueue only after registration so a crash can always fail us open
        for seg in req.segments:
            if seg.kind == "text":
                seg.queued_ns = time.perf_counter_ns()
                self._submit.put(seg)
        return req.out

    def stream(self, text: str, voice: VoiceState | None = None,
               gen: GenParams | None = None, timeout: float = 300.0, *,
               pauses: bool = True, adapter: str | None = None) -> Iterator[np.ndarray]:
        """Iterator of audio chunks.  Abandoning the iterator (client
        disconnect) CANCELS the request: its remaining segments retire
        instead of decoding to completion in occupied slots."""
        req_out = self.submit(text, voice, gen, pauses=pauses, adapter=adapter)
        req = getattr(req_out, "_pocket_request", None)
        try:
            while True:
                try:
                    item = req_out.get(timeout=timeout)
                except queue.Empty:
                    raise TimeoutError(f"no audio chunk within {timeout}s "
                                       f"(batcher stats: {self.stats()})") from None
                if item is _SENTINEL:
                    return
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            if req is not None and not req.finished:
                self._cancel(req)

    def _cancel(self, req: _Request) -> None:
        """Abandon a request: mark every segment done (admission drops them,
        in-flight routing skips them, the loop-top sweep frees their slots)."""
        with self._lock:
            for seg in req.segments:
                seg.done = True
                seg.chunks.clear()
            req.finished = True
            self._active.discard(req)
            self._stats["requests_cancelled"] += 1

    def generate(self, text: str, voice: VoiceState | None = None,
                 gen: GenParams | None = None, *, pauses: bool = True,
                 adapter: str | None = None) -> np.ndarray:
        out = self.submit(text, voice, gen, pauses=pauses, latency_sensitive=False,
                          adapter=adapter)
        return self._drain(out)

    def _drain(self, out: queue.Queue) -> np.ndarray:
        """Collect a submitted request's chunks into one array."""
        req = getattr(out, "_pocket_request", None)
        chunks = []
        try:
            while True:
                try:
                    item = out.get(timeout=300.0)
                except queue.Empty:
                    raise TimeoutError(f"no audio chunk within 300s "
                                       f"(batcher stats: {self.stats()})") from None
                if item is _SENTINEL:
                    break
                if isinstance(item, Exception):
                    raise item
                chunks.append(item)
        finally:
            # an abandoned request (timeout or any other raise) must CANCEL,
            # or its segments keep occupying slots
            if req is not None and not req.finished:
                self._cancel(req)
        return np.concatenate(chunks) if chunks else np.zeros(0, np.float32)

    def _cancel_out(self, out: queue.Queue | None) -> None:
        if out is None:
            return
        req = getattr(out, "_pocket_request", None)
        if req is not None and not req.finished:
            self._cancel(req)

    def generate_batch(self, texts, voices=None, gens=None, *,
                       pauses: bool = True, frames_after_eos: int | None = None,
                       return_exceptions: bool = False,
                       on_result=None, collect: bool = True,
                       adapters=None) -> list:
        """Synthesize many utterances concurrently at aggregate throughput.

        Every item is submitted up front so the decode loop keeps all
        ``batch_size`` slots busy; results come back in input order.

        ``voices`` / ``gens``: ``None`` (model defaults), one value shared by
        every item, or a list/tuple with one entry per item (``None`` entries
        fall back to the default).

        ``return_exceptions=False`` (default): the first failing item cancels
        everything outstanding and re-raises.  ``True``: a failed item holds
        its exception in the result list and the rest still complete.
        ``on_result(index, audio_or_exception)`` fires as each item finishes,
        in input order, from the calling thread.  ``collect=False`` drops
        each item's audio right after its ``on_result`` call (its slot in the
        returned list is None; exceptions are still recorded).  ``adapters``:
        per-item ``AdapterBank`` names, given as ``voices`` are; items with
        different adapters decode together in one loop."""
        texts = list(texts)
        n = len(texts)

        def per_item(x, name):
            if isinstance(x, (list, tuple)):
                if len(x) != n:
                    raise ValueError(f"{name} has {len(x)} entries for {n} texts")
                return list(x)
            return [x] * n

        voices = per_item(voices, "voices")
        gens = per_item(gens, "gens")
        adapters = per_item(adapters, "adapters")

        outs: list[queue.Queue | None] = [None] * n
        results: list = [None] * n
        try:
            for i in range(n):
                try:
                    outs[i] = self.submit(texts[i], voices[i], gens[i], pauses=pauses,
                                          latency_sensitive=False,
                                          frames_after_eos=frames_after_eos,
                                          adapter=adapters[i])
                except Exception as e:  # noqa: BLE001
                    if not return_exceptions:
                        raise
                    results[i] = e
            for i in range(n):
                if outs[i] is None:  # submit failed, exception recorded
                    if on_result is not None:
                        on_result(i, results[i])
                    continue
                try:
                    results[i] = self._drain(outs[i])
                except Exception as e:  # noqa: BLE001
                    if not return_exceptions:
                        raise
                    results[i] = e
                finally:
                    outs[i] = None  # drained or cancelled by _drain
                if on_result is not None:
                    on_result(i, results[i])
                if not collect and not isinstance(results[i], Exception):
                    results[i] = None
        finally:
            # fail-fast path: everything not yet drained must be cancelled or
            # its segments keep occupying slots after the caller has given up
            for out in outs:
                self._cancel_out(out)
        return results

    # -- decode loop -----------------------------------------------------------

    def _run(self) -> None:
        try:
            stream = (torch.cuda.stream(self._stream) if self._stream is not None
                      else contextlib.nullcontext())
            with torch.no_grad(), stream:
                self._run_inner()
        except Exception as e:  # noqa: BLE001
            logger.exception("batcher decode loop crashed")
            self._fail_open(RuntimeError(f"batcher crashed: {e!r}"))

    def _fail_open(self, error: Exception) -> None:
        """Surface ``error`` to EVERY unfinished request (queued, in-slot, or
        mid-stream) and refuse new submissions."""
        self._dead = True
        with self._lock:
            while True:
                try:
                    self._submit.get_nowait()
                except queue.Empty:
                    break
            for req in list(self._active):
                if not req.finished:
                    req.failed = True
                    req.finished = True
                    req.out.put(error)
                    req.out.put(_SENTINEL)
            self._active.clear()

    def _to_host(self, audio: torch.Tensor, is_eos: torch.Tensor):
        """Enqueue the copies of a chunk's outputs into pinned host buffers
        and record an event after them; (host tensors, event).  On the CPU
        the outputs are already host tensors."""
        if self._stream is None:
            return (audio, is_eos), None
        host = tuple(torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                     for t in (audio, is_eos))
        for h, t in zip(host, (audio, is_eos)):
            h.copy_(t, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        return host, event

    def _run_inner(self) -> None:
        engine = self.engine
        frame_size = engine.frame_size
        slots = [_Slot() for _ in range(self.batch)]
        state = engine.new_state(self.batch)
        temps = np.full((self.batch,), 0.7, np.float32)
        eos_th = np.full((self.batch,), -4.0, np.float32)
        # per-slot lsd step counts (masked Euler) and noise clamps (< 0 =
        # unclamped; 0 is a hard zero-clamp, so None must NOT be encoded as 0)
        lsd = np.ones((self.batch,), np.int32)
        clamp = np.full((self.batch,), -1.0, np.float32)
        # [B, N] per-slot adapter rows (bank mode); a free lane's row is zero
        low = np.zeros((self.batch, self.bank.n), np.float32) if self.bank is not None else None
        vecs = None        # device copies of temps / eos thresholds / adapter rows
        vecs_dirty = True  # re-uploaded only when slot occupancy changes
        waiting: list[_Segment] = []  # decode-thread-only admission queue
        pending: list = []  # in-flight (owners, k, host outputs, event) to fetch

        while not self._stop.is_set():
            # 0. drain new submissions into the priority queue: first segments
            # of streaming requests admit before anything else; FIFO otherwise
            while True:
                try:
                    waiting.append(self._submit.get_nowait())
                except queue.Empty:
                    break
            # cancelled/finished segments free their slot.  EARLY RETIREMENT:
            # a lane whose dispatch frontier already covers its segment's
            # exact budget gains nothing from further dispatches, so it is
            # freed NOW, up to depth chunks before its results are fetched.
            # Owner snapshots keep in-flight routing right, and re-admission
            # cannot corrupt results already dispatched: admission writes the
            # lane in place on the same stream, after those chunks, and their
            # outputs are tensors of their own
            for s in slots:
                if s.segment is None:
                    continue
                if s.segment.done:
                    s.segment = None
                elif s.dispatched >= s.segment.target:
                    s.segment = None
                    with self._lock:
                        self._stats["early_retirements"] += 1
            waiting = [s for s in waiting if not s.done]
            waiting.sort(key=lambda s: (not s.ramp, s.seq))

            # 1a. latency preemption: a waiting ramp segment with no free slot
            # evicts a NON-HEAD segment (a later segment of a request still
            # streaming an earlier one: nothing it produced has been emitted).
            # The victim re-queues and restarts from its text prefill.
            free = [i for i, s in enumerate(slots) if s.free]
            n_ramp_waiting = sum(1 for s in waiting if s.ramp)
            while n_ramp_waiting > len(free):
                victim_i = self._pick_victim(slots)
                if victim_i is None:
                    break
                victim = slots[victim_i].segment
                with self._lock:
                    victim.epoch += 1  # stale in-flight routing ignores it
                    victim.chunks.clear()
                    self._stats["preemptions"] += 1
                slots[victim_i].segment = None
                victim.queued_ns = time.perf_counter_ns()
                waiting.append(victim)
                free.append(victim_i)
            waiting.sort(key=lambda s: (not s.ramp, s.seq))

            # 1b. admit into free slots: one fused admit + prefill per request
            for i in free:
                seg = None
                while waiting:  # skip segments cancelled since the drain
                    cand = waiting.pop(0)
                    if not cand.done:
                        seg = cand
                        break
                if seg is None:
                    break
                slot = slots[i]
                rid = seg.request.span_request
                utils.record("batcher.queue", seg.queued_ns, 1, rid)
                with utils.span("batcher.admit", 1, rid):
                    state = engine.admit_prefill_slot(state, i, seg.request.voice.as_dict(),
                                                      seg.d_tokens, seg.n_tokens,
                                                      lora_row=seg.request.lora_row)
                if low is not None:
                    low[i] = 0.0 if seg.request.lora_row is None else seg.request.lora_row
                slot.segment = seg
                slot.dispatched = 0
                seg.frames_routed = 0   # fresh start (preemption re-queues)
                seg.eos_step = None
                temps[i] = seg.request.gen.temp
                eos_th[i] = seg.request.gen.eos_threshold
                lsd[i] = max(1, seg.request.gen.lsd_decode_steps)
                nc = seg.request.gen.noise_clamp
                clamp[i] = nc if nc is not None else -1.0
                vecs_dirty = True
            self._waiting_n = len(waiting)

            active = [s for s in slots if not s.free]
            if not active:
                while pending:
                    self._route(slots, *pending.pop(0), frame_size)
                with utils.span("batcher.idle"):
                    stopped = self._stop.wait(0.005)
                if stopped:
                    break
                continue

            k, depth, ramping = self._chunk_policy(
                active, len(waiting), sum(1 for s in waiting if s.ramp))
            # 2. dispatch one decode chunk over every slot; older chunks are
            # fetched while newer ones compute.  The slot-ownership snapshot
            # travels with each dispatch: routing credits frames to the
            # segments resident at dispatch time.  Free slots keep lsd 1 so an
            # idle lane never raises the batch's step ceiling
            for i, s in enumerate(slots):
                if s.free:
                    lsd[i] = 1
                    clamp[i] = -1.0
                    if low is not None:
                        low[i] = 0.0
            if vecs_dirty or vecs is None:
                vecs = (engine.put(temps, torch.float32), engine.put(eos_th, torch.float32),
                        None if low is None else engine.put(low, torch.float32))
                vecs_dirty = False
            d_temps, d_eos, d_low = vecs
            # the adapter path only while an adapter request is resident: a
            # zero row is an exact no-op, so base lanes match either way
            lora_on = low is not None and any(
                s.segment is not None and s.segment.request.lora_row is not None for s in slots)
            # Batches where every active slot has the model defaults (nobody
            # overrides lsd / noise_clamp) take the plain decode: the per-slot
            # path pays for masked steps and a second noise draw
            gen = self.model.gen
            base = (max(1, gen.lsd_decode_steps),
                    gen.noise_clamp if gen.noise_clamp is not None else -1.0)
            default_only = all((int(lsd[i]), float(clamp[i])) == base
                               for i, s in enumerate(slots) if not s.free)
            vec = {} if default_only else {"lsd_vec": lsd.copy(), "clamp_vec": clamp.copy()}
            if lora_on:
                vec["lora_w"] = d_low
            with utils.span("batcher.dispatch", k * len(active)):
                state, audio, is_eos = engine.decode_frames(
                    state, k, gen, self._generator, temps=d_temps, eos_thresholds=d_eos, **vec)
            host, event = self._to_host(audio, is_eos)
            for s in active:
                s.dispatched += k
            with self._lock:
                self._stats["dispatches"] += 1
                if ramping:
                    self._stats["warm_dispatches"] += 1
                elif k < self.chunk:
                    self._stats["serve_dispatches"] += 1
                self._stats["frames_decoded"] += k * len(active)
            owners = [(s.segment, s.segment.epoch) if s.segment else None for s in slots]
            pending.append((owners, k, host, event))
            while len(pending) > depth:
                if self._route(slots, *pending.pop(0), frame_size):
                    vecs_dirty = True  # a retirement changed slot occupancy
        while pending:
            self._route(slots, *pending.pop(0), frame_size)

    def _chunk_policy(self, active, n_waiting: int,
                      n_ramp_waiting: int = 0) -> tuple[int, int, bool]:
        """(chunk frames, pipeline depth, ramping) for the next dispatch;
        the smallest applicable chunk wins:

        * warm chunk while any ramp slot is young; depth 0 (fetch right after
          dispatch) until every ramp slot has emitted its first chunk, so the
          first audio does not wait out a second chunk, then depth 1;
        * press chunk + depth 1 while a STREAMING-FIRST segment waits for
          admission at full occupancy (not saturated): retirements are found
          sooner and the waiter sits behind less backlog.  A whole-WAV
          backlog does not trigger it;
        * serve chunk + depth 1 while any streaming request is resident: a
          future arrival waits out one half-size chunk;
        * throughput chunk + full depth for whole-WAV load only.

        Saturation guard: with more streaming-first segments queued than
        slots, bounded first-chunk latency is already lost, so the loop stops
        paying the ramp's throughput cost and drains at full chunk size."""
        saturated = n_ramp_waiting > self.batch
        ramping = (not saturated
                   and any(s.dispatched < self.ramp_frames and s.segment.ramp
                           for s in active))
        streamy = any(s.segment.request.latency_sensitive for s in active)
        if ramping:
            first_audio_pending = any(s.segment.frames_routed == 0 and s.segment.ramp
                                      for s in active)
            return self.warm_chunk, (0 if first_audio_pending else 1), True
        if n_ramp_waiting and not saturated:
            return min(self.press_chunk, self.chunk), 1, False
        if streamy and not saturated:
            return min(self.serve_chunk, self.chunk), 1, False
        return self.chunk, self.depth, False

    @staticmethod
    def _pick_victim(slots) -> int | None:
        """Least-progress active slot whose segment has emitted nothing (a
        later segment of a request still streaming an earlier one).  Head
        segments, whose chunks may already be in a listener's ears, and ramp
        segments are never evicted."""
        best, best_i = None, None
        for i, s in enumerate(slots):
            seg = s.segment
            if seg is None or seg.ramp:
                continue
            if seg.index <= seg.request.emitted_upto:
                continue
            if best is None or seg.frames_routed < best:
                best, best_i = seg.frames_routed, i
        return best_i

    def _route(self, slots, owners, k, host, event, frame_size) -> bool:
        """Fetch one chunk's results (waiting on its event only) and route
        frames to the segments that owned each lane AT DISPATCH TIME.
        Returns True if a slot retired (occupancy changed).  An epoch
        mismatch means the owner was preempted after this chunk was
        dispatched: its lane data is discarded.  Span ``batcher.route``
        (n: frames emitted)."""
        with utils.span("batcher.route") as span:
            if event is not None:
                event.synchronize()
            audio = self.engine.wire_to_float(host[0].numpy())
            eos = host[1].numpy()
            freed = False
            with self._lock:
                touched_requests = set()
                for i, slot in enumerate(slots):
                    if owners[i] is None:
                        continue
                    seg, epoch = owners[i]
                    if seg.done or seg.epoch != epoch:
                        continue
                    if seg.eos_step is None:
                        hits = np.nonzero(eos[i])[0]
                        if hits.size:
                            seg.eos_step = seg.frames_routed + int(hits[0])
                    emit = min(seg.target, seg.frames_routed + k) - seg.frames_routed
                    if emit > 0:
                        seg.chunks.append(audio[i, : emit * frame_size].copy())
                        self._stats["useful_frames"] += emit
                        span.n += emit
                    seg.frames_routed += k
                    if seg.frames_routed >= seg.target:
                        seg.done = True
                        if slot.segment is seg:  # not already early-retired
                            slot.segment = None
                            freed = True
                    touched_requests.add(seg.request)
                for req in touched_requests:
                    req.pump()
                    if req.finished:
                        self._active.discard(req)
                        self._stats["requests_completed"] += 1
        return freed


def batched_tts(model: TTSModel, batch_size: int = 4, chunk_frames: int = 8,
                depth: int = 2, warm_chunk: int | None = None,
                adapter_bank=None) -> ContinuousBatcher:
    """A started :class:`ContinuousBatcher` with the warm ramp on (warm chunk
    4 frames, or the chunk size if smaller)."""
    b = ContinuousBatcher(model, batch_size, chunk_frames, depth=depth,
                          warm_chunk=warm_chunk or min(4, chunk_frames),
                          adapter_bank=adapter_bank)
    b.start()
    return b
