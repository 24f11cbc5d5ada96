"""HTTP serving tier (port of ``pocket_tts_tpu/server/app.py``), the JAX
package's wire API:

  GET  /                  -> the web player (``pocket_tts_tpu/server/webui.html``)
  GET  /health            -> {"status": "ok", "model", "uptime_s", "real_weights",
                              "adapters"?, "batcher"?}
  GET  /metrics           -> Prometheus text of the batcher's counters
  POST /generate          -> whole WAV     {text, voice?, temperature?, lsd_steps?,
                                            eos_threshold?, noise_clamp?,
                                            continuation_frames?, adapter?}
  POST /stream            -> chunked raw s16le PCM (same body)
  POST /tts               -> form (text, voice_url | voice_wav, compat?) or JSON
                             -> WAV; ``compat=python`` streams a WAV instead
  POST /v1/audio/speech   -> OpenAI-compatible {model, input, voice} -> WAV

Two layers.  The request layer (``ServerState``, ``generate_wav``,
``open_stream``, ``metrics_text``, ``health``, ``tts_form_body``,
``openai_body``) imports no HTTP framework: it takes a body dict and raises
``RequestError`` for a client error, so it serves requests where aiohttp is
not installed.  ``create_app`` and ``start_server`` only turn HTTP into calls
of it, and import aiohttp when they are called.

Routing: concurrent traffic rides the continuous batcher when there is one;
a lone request, or one with ``continuation_frames``, runs on the
single-stream engine under ``ServerState.lock``.  Adapters (``adapters``:
name -> fine-tuned checkpoint or LoRA artifact) are selected per request:
those in the batcher's adapter bank ride it as per-slot rows, the rest run
on their merged model (``ServerState.adapted``, an LRU), whose voice states
are cached per adapter (a voice state is a prefill through the backbone).  Blocking work (voice
resolution, which may run the Mimi encoder, and synthesis) runs in
``ServerState.pool``, with autograd off and on the CUDA stream that was
current where the state was built, which is the stream the batcher's decode
thread runs on when both are built in one thread (as ``build_state`` does):
every party enqueues on one stream, so tensors pass between threads in order.
"""

from __future__ import annotations

import asyncio
import base64
import collections
import concurrent.futures
import contextlib
import logging
import os
import threading
import time
from pathlib import Path
from typing import AsyncIterator

import torch

from pocket_tts_tpu_torch import audio as audio_io
from pocket_tts_tpu_torch import utils
from pocket_tts_tpu_torch.server import voices as voices_mod
from pocket_tts_tpu_torch.tts import TTSModel

logger = logging.getLogger(__name__)

WEBUI = Path(__file__).resolve().parents[2] / "pocket_tts_tpu" / "server" / "webui.html"
PCM_CONTENT_TYPE = "audio/pcm;rate=24000;encoding=signed-int;bits=16"
_BATCHER_COUNTERS = ("dispatches", "warm_dispatches", "serve_dispatches", "frames_decoded",
                     "useful_frames", "early_retirements", "preemptions",
                     "requests_submitted", "requests_completed", "requests_cancelled")


class RequestError(Exception):
    """A client error: the HTTP status (400) and the message of its JSON body."""

    def __init__(self, status: int, message: str):
        super().__init__(message)
        self.status = status
        self.message = message


class AdapterError(ValueError):
    """An unknown adapter name, or one whose artifact fails to load."""


class ServerState:
    """What every request shares: the model, the voice-state LRU, the
    optional batcher, the registered adapters, the single-stream lock and
    the worker pool.

    ``adapters``: name -> artifact path (a fine-tuned checkpoint or a LoRA
    adapter).  ``bankable``: the names in the batcher's adapter bank, which
    ride the batcher; the others run on their merged model."""

    def __init__(self, model: TTSModel, *, voice_cache_capacity: int = 8,
                 default_voice: str = voices_mod.DEFAULT_VOICE, batcher=None,
                 adapters: dict[str, str] | None = None, adapter_cache_capacity: int = 2,
                 bankable: frozenset = frozenset()):
        self.model = model
        self.cache = voices_mod.VoiceStateCache(voice_cache_capacity)
        self.default_voice = default_voice
        self.batcher = batcher
        self.bankable = bankable
        self.adapters = dict(adapters or {})
        # name -> (merged model, its voice-state cache), least recent first
        self._adapted: collections.OrderedDict[str, tuple] = collections.OrderedDict()
        self._adapted_lock = threading.Lock()
        self._adapter_cap = max(1, adapter_cache_capacity)
        self._voice_cache_capacity = voice_cache_capacity
        self.lock = asyncio.Lock()
        # a stream occupies one worker for its whole duration (its producer
        # runs in the pool), so the pool covers every batcher slot plus
        # headroom for voice resolution
        workers = batcher.batch + 4 if batcher is not None else 1
        self.pool = concurrent.futures.ThreadPoolExecutor(max_workers=workers,
                                                          thread_name_prefix="tts-request")
        dev = model.device
        self.stream = torch.cuda.current_stream(dev) if dev.type == "cuda" else None
        self.started_at = time.time()

    def submit(self, fn) -> asyncio.Future:
        """``fn()`` in the pool, awaitable from the running loop.  Grad mode
        and the current stream are per thread: both are set here."""
        def run():
            stream = (torch.cuda.stream(self.stream) if self.stream is not None
                      else contextlib.nullcontext())
            with torch.no_grad(), stream:
                return fn()
        return asyncio.get_running_loop().run_in_executor(self.pool, run)

    def adapted(self, name: str) -> tuple:
        """(merged model, voice cache) of a registered adapter, built on
        first use (artifact load, merge, engine: call it off the event loop)
        into an LRU of ``adapter_cache_capacity``.  Two concurrent misses may
        both build it (the build runs outside the lock); the last insert
        wins.  An unknown name, or an artifact that fails to load, raises
        AdapterError."""
        if name not in self.adapters:
            raise AdapterError(f"unknown adapter {name!r}; registered: "
                               f"{sorted(self.adapters) or 'none'}")
        with self._adapted_lock:
            pair = self._adapted.get(name)
            if pair is not None:
                self._adapted.move_to_end(name)
                return pair
        from pocket_tts_tpu_torch.training import apply_adapted

        try:
            model = apply_adapted(self.model, self.adapters[name])
        except (OSError, ValueError) as e:
            raise AdapterError(f"adapter {name!r} failed to load: {e}") from e
        pair = (model, voices_mod.VoiceStateCache(self._voice_cache_capacity))
        with self._adapted_lock:
            self._adapted[name] = pair
            self._adapted.move_to_end(name)
            while len(self._adapted) > self._adapter_cap:
                evicted, _ = self._adapted.popitem(last=False)
                logger.info("adapter cache evicted %s", evicted)
        return pair

    def resolve(self, spec: str | None, *, model: TTSModel | None = None, cache=None):
        """Voice spec -> VoiceState, by ``model`` into ``cache`` (default:
        the base model and its cache; an adapter's world otherwise).  An
        explicitly requested voice that cannot be resolved raises
        ``VoiceResolutionError`` (a 400: another voice would answer 200 with
        the wrong speaker); the default voice falls back to the empty state,
        so a server without the stock voices stays usable."""
        model = model if model is not None else self.model
        cache = cache if cache is not None else self.cache
        explicit = spec is not None and spec != self.default_voice
        spec = spec or self.default_voice
        try:
            return voices_mod.resolve_voice_cached(model, spec, cache)
        except Exception as e:  # noqa: BLE001 - any failure of an explicit voice is the client's
            if explicit:
                raise voices_mod.VoiceResolutionError(f"voice {spec!r} unresolvable: {e}") from e
            logger.warning("voice %r unresolvable (%s); using unconditioned state", spec, e)
            return model.get_voice_state()

    def model_with_overrides(self, body: dict, base: TTSModel | None = None) -> TTSModel:
        return (base if base is not None else self.model).with_params(
            temp=body.get("temperature"),
            # "lsd_steps" is the API's field; the library's spelling is an alias
            lsd_decode_steps=body.get("lsd_steps", body.get("lsd_decode_steps")),
            eos_threshold=body.get("eos_threshold"),
            noise_clamp=body.get("noise_clamp"),
        )


# -- the request layer -----------------------------------------------------------


def _int_field(body: dict, name: str, default: int = 0) -> int:
    """An optional integer field; a malformed value (a JSON boolean too) is
    a client error."""
    val = body.get(name)
    if val is None or val == "":
        return default
    if not isinstance(val, bool):
        try:
            return int(val)
        except (TypeError, ValueError):
            pass
    raise RequestError(400, f"{name} must be an integer")


def _model_for(state: ServerState, body: dict, base: TTSModel | None = None) -> TTSModel:
    """The per-request clone of ``base`` (default: the model); an invalid
    knob (lsd_steps < 1, a negative temperature) is a client error."""
    try:
        return state.model_with_overrides(body, base)
    except (ValueError, TypeError) as e:
        raise RequestError(400, str(e)) from e


def _adapter(body: dict) -> str | None:
    name = body.get("adapter")
    return str(name) if name else None


async def _adapted_for(state: ServerState, body: dict) -> tuple:
    """(model, voice cache) of the request's adapter, or the base model's;
    an unknown adapter, or one that fails to load, is a client error."""
    name = _adapter(body)
    if name is None:
        return state.model, state.cache
    try:
        return await state.submit(lambda: state.adapted(name))
    except AdapterError as e:
        raise RequestError(400, str(e)) from e


def _text(text) -> str:
    if not text or not str(text).strip():
        raise RequestError(400, "text is required")
    return str(text)


async def _resolve_voice(state: ServerState, body: dict, base: TTSModel, cache):
    try:
        return await state.submit(lambda: state.resolve(body.get("voice"), model=base,
                                                        cache=cache))
    except voices_mod.VoiceResolutionError as e:
        raise RequestError(400, str(e)) from e


def route_to_batcher(state: ServerState, cont: int, adapter: str | None = None) -> bool:
    """The routing policy of /generate and /stream alike: concurrent traffic
    rides the batcher, adapter requests too when the bank holds theirs; a
    lone request, a continuation (whose conditioning depends on the audio it
    has made) and an adapter outside the bank take the single-stream path.
    The callers act on the answer with no await in between, so the decision
    is atomic on the event loop."""
    return (state.batcher is not None and cont <= 0
            and (adapter is None or adapter in state.bankable)
            and (state.lock.locked() or not state.batcher.idle()))


async def generate_wav(state: ServerState, body: dict) -> bytes:
    """A whole WAV for a /generate body (``text``, or ``input``)."""
    base, vcache = await _adapted_for(state, body)
    model = _model_for(state, body, base)
    text = _text(body.get("text") or body.get("input"))
    cont = _int_field(body, "continuation_frames")
    voice = await _resolve_voice(state, body, base, vcache)
    adapter = _adapter(body)
    if route_to_batcher(state, cont, adapter):
        # per-request lsd_decode_steps / noise_clamp ride as per-slot data;
        # a bankable adapter as the lane's row (its voice state was prefilled
        # through the adapter's merged model)
        wav = await state.submit(lambda: state.batcher.generate(text, voice, model.gen,
                                                                adapter=adapter))
    else:
        async with state.lock:
            wav = await state.submit(lambda: model.generate_with_pauses(
                text, voice, continuation_frames=cont))
    return audio_io.wav_bytes(wav, model.sample_rate)


async def open_stream(state: ServerState, body: dict) -> AsyncIterator[bytes]:
    """Validate a /stream body and resolve its voice (client errors raise
    here, before any byte is sent), then return an async iterator of s16le
    PCM chunks.  Closing the iterator (``aclose``) cancels the generation:
    the batcher retires the request's segments."""
    base, vcache = await _adapted_for(state, body)
    model = _model_for(state, body, base)
    text = _text(body.get("text"))
    cont = _int_field(body, "continuation_frames")
    voice = await _resolve_voice(state, body, base, vcache)
    return _pcm_chunks(state, model, text, voice, cont, _adapter(body))


async def _pcm_chunks(state: ServerState, model: TTSModel, text: str, voice,
                      cont: int, adapter: str | None) -> AsyncIterator[bytes]:
    loop = asyncio.get_running_loop()
    queue: asyncio.Queue = asyncio.Queue(maxsize=10)
    cancelled = threading.Event()  # set when the consumer goes away

    def put(item) -> bool:
        """Bounded put that gives up once the consumer is gone: a dropped
        connection must never wedge a pool worker on a full queue."""
        fut = asyncio.run_coroutine_threadsafe(queue.put(item), loop)
        while not cancelled.is_set():
            try:
                fut.result(timeout=0.5)
                return True
            except concurrent.futures.TimeoutError:
                continue
            except (concurrent.futures.CancelledError, RuntimeError):  # the loop is closing
                return False
        fut.cancel()
        return False

    def producer():
        try:
            if use_batcher:
                source = state.batcher.stream(text, voice, model.gen, adapter=adapter)
            else:
                source = model.generate_stream_long(text, voice, continuation_frames=cont)
            try:
                for chunk in source:
                    if not put(audio_io.pcm_i16_le_bytes(chunk)):
                        logger.info("stream consumer gone; generation cancelled")
                        return
            finally:
                source.close()  # the batcher retires the request's segments now
            put(None)
        except Exception as e:  # noqa: BLE001 - handed to the consumer, which raises it
            logger.exception("stream producer failed")
            put(e)

    # decided with no await before the lock is taken below
    use_batcher = route_to_batcher(state, cont, adapter)
    async with contextlib.nullcontext() if use_batcher else state.lock:
        task = state.submit(producer)
        try:
            while (item := await queue.get()) is not None:
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            cancelled.set()  # unblocks the producer on every exit path
            while not queue.empty():
                queue.get_nowait()
            await task


def metrics_text(state: ServerState) -> str:
    """Prometheus text exposition of the serving counters, of a hybrid
    backbone's routed token-slots per MoE layer and expert (the model's
    engine and the batcher's, added), and of the program's spans
    (``utils.span_totals``): seconds inside each span name and how many
    ended, whatever the server's state."""
    lines = ["# TYPE pocket_tts_uptime_seconds gauge",
             f"pocket_tts_uptime_seconds {time.time() - state.started_at:.1f}"]
    if state.batcher is not None:
        st = state.batcher.stats()
        for key in _BATCHER_COUNTERS:
            lines += [f"# TYPE pocket_tts_{key} counter", f"pocket_tts_{key} {st[key]}"]
        for key in ("active_requests", "queued_segments"):
            lines += [f"# TYPE pocket_tts_{key} gauge", f"pocket_tts_{key} {st[key]}"]
        if st["useful_ratio"] is not None:
            lines += ["# TYPE pocket_tts_useful_ratio gauge",
                      f"pocket_tts_useful_ratio {st['useful_ratio']}"]
        lines += ["# TYPE pocket_tts_batcher_dead gauge",
                  f"pocket_tts_batcher_dead {int(st['dead'])}"]
    engines = [state.model.engine] + ([state.batcher.engine] if state.batcher else [])
    slots = [e.expert_slots for e in engines if getattr(e, "expert_slots", None) is not None]
    if slots:  # a hybrid backbone's routed token-slots (read here, off the frame loop)
        total = sum(s.cpu() for s in slots)
        lines.append("# TYPE pocket_tts_expert_slots_total counter")
        lines += [f'pocket_tts_expert_slots_total{{layer="{m}",expert="{e}"}} {int(n)}'
                  for m, row in enumerate(total.tolist()) for e, n in enumerate(row)]
    totals = utils.span_totals()
    for key in ("seconds", "count"):
        lines.append(f"# TYPE pocket_tts_span_{key}_total counter")
        lines += [f'pocket_tts_span_{key}_total{{span="{name}"}} {t[key]}'
                  for name, t in sorted(totals.items())]
    return "\n".join(lines) + "\n"


def health(state: ServerState) -> dict:
    """The /health body; "degraded" when the batcher's decode loop died."""
    out = {"status": "ok", "model": "pocket-tts-tpu",
           "uptime_s": round(time.time() - state.started_at, 1),
           "real_weights": state.model.has_real_weights}
    if state.adapters:
        out["adapters"] = sorted(state.adapters)
    if state.batcher is not None:
        out["batcher"] = state.batcher.stats()
        if out["batcher"].pop("dead"):
            out["status"] = "degraded"
    return out


def tts_form_body(form) -> dict:
    """A /tts form (``text``, ``compat``, ``adapter``, ``voice_url``, and
    ``voice_wav`` as a file, bytes or text) -> a request body."""
    body = {}
    for field, key in (("text", "text"), ("compat", "compat"), ("adapter", "adapter"),
                       ("voice_url", "voice")):
        if field in form:
            body[key] = str(form[field])
    if "voice_wav" in form:
        raw = form["voice_wav"]
        raw = raw.file.read() if hasattr(raw, "file") else (
            raw.encode() if isinstance(raw, str) else bytes(raw))
        body["voice"] = base64.b64encode(raw).decode()
    return body


def openai_body(body: dict) -> dict:
    """An OpenAI speech body ``{model, input, voice}`` -> a request body."""
    return {"text": body.get("input"), "voice": body.get("voice"),
            "temperature": body.get("temperature"), "adapter": body.get("adapter")}


def wants_wav_stream(body: dict) -> bool:
    """``compat=python``: the streaming-WAV contract of the Python server."""
    return str(body.get("compat", "")).lower() == "python"


# -- HTTP ------------------------------------------------------------------------------


def _prebuffer_seconds() -> float:
    try:
        return float(os.environ.get("FIRST_CHUNK_LENGTH_SECONDS", "0"))
    except ValueError:
        logger.warning("invalid FIRST_CHUNK_LENGTH_SECONDS=%r; using 0",
                       os.environ["FIRST_CHUNK_LENGTH_SECONDS"])
        return 0.0


def create_app(state: ServerState):
    from aiohttp import web

    routes = web.RouteTableDef()

    @web.middleware
    async def client_errors(request, handler):
        try:
            return await handler(request)
        except RequestError as e:
            return web.json_response({"error": e.message}, status=e.status)

    async def json_body(request) -> dict:
        """A malformed body is a 400: a 500 would make the fleet router mark
        the worker unhealthy."""
        try:
            body = await request.json()
        except ValueError:  # JSON and UTF-8 decode errors
            raise RequestError(400, "request body must be valid JSON") from None
        if not isinstance(body, dict):
            raise RequestError(400, "request body must be a JSON object")
        return body

    async def wav_response(body: dict):
        return web.Response(body=await generate_wav(state, body), content_type="audio/wav")

    async def stream_response(request, body: dict, *, wav_compat: bool = False):
        """/stream: raw s16le PCM chunks.  ``wav_compat``: the Python
        server's streaming WAV (a header with a placeholder length, the first
        FIRST_CHUNK_LENGTH_SECONDS of audio held back, 200 ms of trailing
        silence)."""
        chunks = await open_stream(state, body)
        sr = state.model.sample_rate
        if wav_compat:
            prebuffer = 2 * int(sr * _prebuffer_seconds())
            held, held_size = [audio_io.wav_header(sr)], 0
            headers = {"Content-Type": "audio/wav",
                       "Content-Disposition": "attachment; filename=generated_speech.wav"}
        else:
            held = None
            headers = {"Content-Type": PCM_CONTENT_TYPE}
        resp = web.StreamResponse(headers=headers)
        try:
            await resp.prepare(request)
            async for item in chunks:
                if held is not None:
                    held.append(item)
                    held_size += len(item)
                    if held_size >= prebuffer:
                        await resp.write(b"".join(held))
                        held = None
                    continue
                await resp.write(item)
        except Exception:
            # the 200 status line is on the wire: abort the connection, so
            # the client tells a truncated stream from a complete one
            if request.transport is not None:
                request.transport.close()
            raise
        finally:
            await chunks.aclose()
        if wav_compat:
            if held is not None:  # a short utterance never reached the threshold
                await resp.write(b"".join(held))
            await resp.write(bytes(2 * int(sr * 0.2)))
        await resp.write_eof()
        return resp

    @routes.get("/")
    async def index(request):
        return web.Response(text=WEBUI.read_text(), content_type="text/html")

    @routes.get("/metrics")
    async def metrics(request):
        return web.Response(text=metrics_text(state), content_type="text/plain")

    @routes.get("/health")
    async def health_route(request):
        return web.json_response(health(state))

    @routes.post("/generate")
    async def generate(request):
        return await wav_response(await json_body(request))

    @routes.post("/stream")
    async def stream(request):
        return await stream_response(request, await json_body(request))

    @routes.post("/tts")
    async def tts(request):
        ctype = request.content_type
        if ctype.startswith("multipart") or ctype == "application/x-www-form-urlencoded":
            body = tts_form_body(await request.post())
        else:
            body = await json_body(request)
        if wants_wav_stream(body):
            return await stream_response(request, body, wav_compat=True)
        return await wav_response(body)

    @routes.post("/v1/audio/speech")
    async def openai_speech(request):
        return await wav_response(openai_body(await json_body(request)))

    app = web.Application(middlewares=[client_errors])
    app.add_routes(routes)
    return app


def _sniff_adapters(adapters: dict[str, str]) -> dict[str, str]:
    """Check each artifact's ``format`` (a typo fails at startup, not at the
    first request); return the bankable ones: LoRA adapters whose targets
    all lie on the batched delta path."""
    from pocket_tts_tpu_torch import weights as weights_mod
    from pocket_tts_tpu_torch.training.lora import LORA_FORMAT, bankable_lora_targets
    from pocket_tts_tpu_torch.training.trainer import FINETUNED_FORMAT

    bankable = {}
    for name, path in adapters.items():
        keys, meta = weights_mod.read_safetensors_header(path)
        fmt = meta.get("format")
        if fmt not in (FINETUNED_FORMAT, LORA_FORMAT):
            raise ValueError(f"adapter {name!r}: {path} has unknown format {fmt!r}")
        if fmt == LORA_FORMAT and bankable_lora_targets(keys):
            bankable[name] = str(path)
    return bankable


def build_state(model: TTSModel, *, voice_cache_capacity: int = 8,
                default_voice: str = voices_mod.DEFAULT_VOICE, prewarm: tuple[str, ...] = (),
                warmup: bool = True, batch_size: int = 0,
                adapters: dict[str, str] | None = None) -> ServerState:
    """The state ``start_server`` serves: with ``batch_size > 1`` a started
    ``batched_tts(model, batch_size, chunk_frames=64, depth=2)``, with an
    adapter bank of the bankable ``adapters``; the default and ``prewarm``
    voices resolved into the LRU; then (``warmup``) one ``generate``, the
    registered adapters' merged models built (up to the LRU's capacity)
    with one ``generate`` each, the batcher's warmup and one batched stream,
    so no request pays for first launches."""
    bank = None
    if adapters:
        bankable = _sniff_adapters(adapters)
        if bankable and batch_size > 1:
            from pocket_tts_tpu_torch.training.lora import build_adapter_bank

            bank = build_adapter_bank(bankable)
            logger.info("adapter bank: %s ride the batched decode loop", sorted(bank.names))
    batcher = None
    if batch_size > 1:
        from pocket_tts_tpu_torch.runtime.batcher import batched_tts

        batcher = batched_tts(model, batch_size=batch_size, chunk_frames=64, depth=2,
                              adapter_bank=bank)
    state = ServerState(model, voice_cache_capacity=voice_cache_capacity,
                        default_voice=default_voice, batcher=batcher, adapters=adapters,
                        bankable=frozenset(bank.names) if bank is not None else frozenset())
    voice = state.resolve(default_voice)
    for name in prewarm:
        state.resolve(name)
    if warmup:
        t0 = time.time()
        model.generate("Warm up.", voice)
        # beyond the LRU's capacity a build would be evicted at once
        for name in list(state.adapters)[:state._adapter_cap]:
            ta = time.time()
            state.adapted(name)[0].generate("Warm up.")
            logger.info("adapter %r prewarmed in %.1f s", name, time.time() - ta)
        if batcher is not None:
            batcher.warmup()
            for _ in batcher.stream("Warm up.", voice):
                pass
        logger.info("warmup in %.1f s", time.time() - t0)
    return state


def start_server(model: TTSModel, host: str = "0.0.0.0", port: int = 8000, *,
                 voice_cache_capacity: int = 8, default_voice: str = voices_mod.DEFAULT_VOICE,
                 prewarm: tuple[str, ...] = (), warmup: bool = True, batch_size: int = 0,
                 adapters: dict[str, str] | None = None) -> None:
    """Blocking entry: ``build_state``, then serve until interrupted.
    ``adapters`` maps request-selectable names to fine-tuned checkpoint or
    LoRA artifact paths (``--adapter name=path``)."""
    from aiohttp import web

    state = build_state(model, voice_cache_capacity=voice_cache_capacity,
                        default_voice=default_voice, prewarm=prewarm, warmup=warmup,
                        batch_size=batch_size, adapters=adapters)
    try:
        logger.info("serving on http://%s:%d", host, port)
        web.run_app(create_app(state), host=host, port=port, handle_signals=True, print=None)
    finally:
        if state.batcher is not None:
            state.batcher.stop()
        state.pool.shutdown(wait=False)
