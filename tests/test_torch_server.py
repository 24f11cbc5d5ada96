"""The port's HTTP serving tier (``pocket_tts_tpu_torch/server/app.py``) under
aiohttp's test client, on the small config of tests/test_tts.py with one
weight set for both packages (weights.random_params -> export_state_dict ->
the port's from_state_dict), temp 0.

* Every case of tests/test_server.py that does not need an adapter, against
  the port's app.
* Against the JAX server on the same requests: /generate, /v1/audio/speech
  and a /generate with a base64 voice WAV give WAVs of equal length whose
  int16 samples agree within 4 LSB (the slice's 1e-4 in float audio x 32767,
  plus one truncation step).
* Each route against the library entry point it serves, bit for bit:
  /generate is ``generate_with_pauses``, /stream is ``generate_stream_long``.
  The two routes decode on different chunk schedules (/stream ramps up for
  its first audio), and the grouped codec then differs at rounding level,
  so /stream against /generate is held to the same 4 LSB.
* A request routed to a B=2 batcher against the same request on the
  single-stream path: 4 int16 LSB (1e-4 in float audio).
* Adapters (tests/test_server.py:145-300): a LoRA artifact made by the
  port's ``finetune`` selected per request, against the JAX server serving
  the same artifact within the same 4 LSB; unknown and unloadable names are
  400s; the merged-model LRU; a bankable adapter riding the B=2 batcher
  against its merged single stream (4 LSB).
* The request layer with aiohttp blocked, and the CLI's ``serve`` and
  ``fleet``.
"""

import asyncio
import base64
import dataclasses
import io
import json
import re
import subprocess
import sys
import wave
from pathlib import Path

import numpy as np
import pytest
import torch

pytest.importorskip("aiohttp")
from aiohttp.test_utils import TestClient, TestServer  # noqa: E402

from pocket_tts_tpu import weights as jweights  # noqa: E402
from pocket_tts_tpu.models.mimi import MimiPlans  # noqa: E402
from pocket_tts_tpu.runtime.engine import GenParams as JaxGen  # noqa: E402
from pocket_tts_tpu.server import app as japp  # noqa: E402
from pocket_tts_tpu.tts import TTSModel as JaxTTS  # noqa: E402
from pocket_tts_tpu_torch import audio, cli  # noqa: E402
from pocket_tts_tpu_torch import weights as tweights  # noqa: E402
from pocket_tts_tpu_torch.config import config_from_dict  # noqa: E402
from pocket_tts_tpu_torch.runtime.batcher import batched_tts  # noqa: E402
from pocket_tts_tpu_torch.runtime.engine import GenParams  # noqa: E402
from pocket_tts_tpu_torch.server import app as app_mod  # noqa: E402
from pocket_tts_tpu_torch.server.app import ServerState, create_app  # noqa: E402
from pocket_tts_tpu_torch.tts import TTSModel  # noqa: E402
from tests.test_tts import CFG  # noqa: E402

torch.set_num_threads(1)
PCFG = config_from_dict(dataclasses.asdict(CFG))
ROOT = Path(__file__).resolve().parent.parent
LSB = 4  # 1e-4 in float audio x 32767, plus one truncation step


@pytest.fixture(scope="module")
def exported():
    plans = MimiPlans(CFG.mimi)
    jp = jweights.random_params(CFG, plans, seed=3)
    return jp, jweights.export_state_dict(jp, plans)


@pytest.fixture(scope="module")
def model(exported):
    return TTSModel(PCFG, tweights.from_state_dict(exported[1], PCFG), gen=GenParams(temp=0.0),
                    has_real_weights=False, device="cpu")


@pytest.fixture(scope="module")
def jax_model(exported):
    return JaxTTS(CFG, exported[0], gen=JaxGen(temp=0.0), has_real_weights=False)


def _serve(loop, app) -> TestClient:
    client = TestClient(TestServer(app), loop=loop)
    loop.run_until_complete(client.start_server())
    return client


@pytest.fixture()
def client(model):
    loop = asyncio.new_event_loop()
    c = _serve(loop, create_app(ServerState(model)))
    yield c, loop
    loop.run_until_complete(c.close())
    loop.close()


@pytest.fixture()
def pair(model, jax_model):
    """The port's server and the JAX server on one loop."""
    loop = asyncio.new_event_loop()
    port = _serve(loop, create_app(ServerState(model)))
    ref = _serve(loop, japp.create_app(japp.ServerState(jax_model)))
    yield port, ref, loop
    for c in (port, ref):
        loop.run_until_complete(c.close())
    loop.close()


def _check_wav(data: bytes) -> int:
    with wave.open(io.BytesIO(data), "rb") as f:
        assert f.getframerate() == 24000
        assert f.getnchannels() == 1
        return f.getnframes()


def _samples(wav: bytes) -> np.ndarray:
    n = _check_wav(wav)
    pcm = np.frombuffer(wav[44:], "<i2").astype(np.int64)
    assert pcm.size == n
    return pcm


def _post(loop, c, route, body) -> bytes:
    async def go():
        resp = await c.post(route, json=body)
        assert resp.status == 200, await resp.text()
        return await resp.read()
    return loop.run_until_complete(go())


# -- tests/test_server.py, against the port --------------------------------------


def test_health(client):
    c, loop = client

    async def go():
        resp = await c.get("/health")
        assert resp.status == 200
        return await resp.json()

    body = loop.run_until_complete(go())
    assert body["status"] == "ok"
    assert body["model"] == "pocket-tts-tpu" and body["real_weights"] is False


def test_generate_returns_wav(client):
    c, loop = client

    async def go():
        resp = await c.post("/generate", json={"text": "Hello from the server."})
        assert resp.status == 200
        assert resp.content_type == "audio/wav"
        return await resp.read()

    assert _check_wav(loop.run_until_complete(go())) > 0


def test_generate_missing_text_400(client):
    c, loop = client

    async def go():
        resp = await c.post("/generate", json={})
        return resp.status, await resp.json()

    status, body = loop.run_until_complete(go())
    assert status == 400 and body["error"] == "text is required"


def test_stream_pcm(client):
    c, loop = client

    async def go():
        resp = await c.post("/stream", json={"text": "Stream me some audio."})
        assert resp.status == 200
        assert resp.headers["Content-Type"].startswith("audio/pcm")
        return await resp.read()

    data = loop.run_until_complete(go())
    assert len(data) > 0 and len(data) % 2 == 0
    assert np.isfinite(np.frombuffer(data, "<i2").astype(np.float32)).all()


def test_openai_speech(client):
    c, loop = client
    data = _post(loop, c, "/v1/audio/speech",
                 {"model": "pocket-tts", "input": "OpenAI compatible.", "voice": "alba"})
    assert _check_wav(data) > 0


def test_tts_multipart(client):
    c, loop = client

    async def go():
        import aiohttp

        form = aiohttp.FormData()
        form.add_field("text", "Multipart request.")
        resp = await c.post("/tts", data=form)
        assert resp.status == 200
        return await resp.read()

    assert _check_wav(loop.run_until_complete(go())) > 0


def test_per_request_override(client, model):
    """Per-request knobs take effect on a clone: the shared model keeps its
    own, and the library's spelling of lsd_steps is an alias."""
    c, loop = client
    gen = dataclasses.replace(model.gen)
    plain = _post(loop, c, "/generate", {"text": "Override parameters please."})
    over = _post(loop, c, "/generate", {"text": "Override parameters please.",
                                        "temperature": 0.1, "lsd_steps": 2,
                                        "eos_threshold": -2.0})
    alias = _post(loop, c, "/generate", {"text": "Override parameters please.",
                                         "lsd_decode_steps": 2})
    assert model.gen == gen
    assert plain != alias  # two Euler steps change the audio
    assert _check_wav(over) > 0


def test_generate_continuation_param(client):
    c, loop = client
    text = ("The first sentence sets the voice in motion and keeps a steady "
            "measured pace through every single word of this opening line. "
            "The second sentence should carry that same voice onward without "
            "resetting the established prosody at the segment boundary here.")
    plain = _post(loop, c, "/generate", {"text": text})
    cont = _post(loop, c, "/generate", {"text": text, "continuation_frames": 8})
    _check_wav(plain)
    _check_wav(cont)
    assert plain != cont


def test_malformed_continuation_frames_is_400(client):
    c, loop = client

    async def go(route, body):
        resp = await c.post(route, json=body)
        return resp.status, await resp.json()

    for route in ("/generate", "/stream"):
        for bad in ("lots", [1], {"n": 1}):
            status, body = loop.run_until_complete(
                go(route, {"text": "hi", "continuation_frames": bad}))
            assert status == 400, (route, bad)
            assert "continuation_frames" in body["error"]


def test_continuation_frames_bool_is_400(client):
    c, loop = client

    async def go(val):
        resp = await c.post("/generate", json={"text": "Bool check.", "continuation_frames": val})
        return resp.status

    assert loop.run_until_complete(go(True)) == 400
    assert loop.run_until_complete(go(False)) == 400


def test_tts_python_compat_streaming_wav(client, monkeypatch):
    """compat=python: a WAV streamed with a placeholder length, the first
    FIRST_CHUNK_LENGTH_SECONDS held back, and 200 ms of trailing silence."""
    import struct

    monkeypatch.setenv("FIRST_CHUNK_LENGTH_SECONDS", "0.1")
    c, loop = client

    async def go():
        default = await c.post("/tts", data={"text": "Contract check."})
        assert default.status == 200
        whole = await default.read()
        resp = await c.post("/tts", data={"text": "Contract check.", "compat": "python"})
        assert resp.status == 200
        assert resp.headers["Content-Type"].startswith("audio/wav")
        return whole, await resp.read()

    whole, streamed = loop.run_until_complete(go())
    n_whole = _check_wav(whole)
    assert len(whole) == 44 + 2 * n_whole
    assert streamed[:4] == b"RIFF"
    assert struct.unpack_from("<I", streamed, 40)[0] >= 1_000_000_000
    pcm = streamed[44:]
    trailing = pcm[-int(0.2 * 24000) * 2:]
    assert trailing == bytes(len(trailing))
    assert len(pcm) == 2 * n_whole + int(0.2 * 24000) * 2


def test_occupancy_adaptive_routing(model):
    """A lone request takes the single-stream engine; one arriving while the
    single-stream lock is held rides the batcher; of two at once, at most
    one takes the single stream."""
    batcher = batched_tts(model, batch_size=2, chunk_frames=4)
    loop = asyncio.new_event_loop()
    state = ServerState(model, batcher=batcher)
    c = _serve(loop, create_app(state))
    try:
        async def post(text):
            resp = await c.post("/generate", json={"text": text})
            assert resp.status == 200
            return await resp.read()

        loop.run_until_complete(post("Lone request routing."))
        assert batcher.stats()["requests_submitted"] == 0

        async def busy():
            async with state.lock:
                await post("Busy server routing.")

        loop.run_until_complete(busy())
        assert batcher.stats()["requests_submitted"] == 1

        async def concurrent():
            await asyncio.gather(post("Concurrent request one."), post("Concurrent request two."))

        loop.run_until_complete(concurrent())
        assert batcher.stats()["requests_submitted"] >= 2
    finally:
        loop.run_until_complete(c.close())
        loop.close()
        batcher.stop()


def test_metrics_endpoint(model):
    batcher = batched_tts(model, batch_size=2, chunk_frames=4)
    loop = asyncio.new_event_loop()
    c = _serve(loop, create_app(ServerState(model, batcher=batcher)))
    try:
        async def go():
            resp = await c.get("/metrics")
            assert resp.status == 200
            return await resp.text()

        batcher.generate("Metric fodder.")
        text = loop.run_until_complete(go())
        assert "pocket_tts_requests_completed 1" in text
        assert "pocket_tts_uptime_seconds" in text
        assert "pocket_tts_batcher_dead 0" in text
    finally:
        loop.run_until_complete(c.close())
        loop.close()
        batcher.stop()


def test_invalid_gen_knobs_are_400(client):
    c, loop = client

    async def go(body):
        resp = await c.post("/generate", json=body)
        return resp.status

    assert loop.run_until_complete(go({"text": "x", "lsd_steps": 0})) == 400
    assert loop.run_until_complete(go({"text": "x", "temperature": -1})) == 400
    assert loop.run_until_complete(go({"text": "x", "lsd_steps": 2, "temperature": 0.5})) == 200


def test_genparams_validate():
    with pytest.raises(ValueError, match="lsd_decode_steps"):
        GenParams(lsd_decode_steps=0)
    with pytest.raises(ValueError, match="temp"):
        GenParams(temp=-0.1)
    with pytest.raises(ValueError, match="temp"):
        GenParams(temp=float("nan"))
    GenParams(temp=0.0, lsd_decode_steps=1, noise_clamp=0.0)


PAGE = app_mod.WEBUI.read_text()


def _webui_body_fields() -> set:
    body_js = re.search(r"const body = \(\) => \{(.*?)\n\};", PAGE, re.S).group(1)
    fields = set(re.findall(r"^\s*(\w+):", body_js, re.M))
    return fields | set(re.findall(r"\bb\.(\w+)\s*=", body_js))


def test_webui_fetch_contract(client):
    c, loop = client
    fields = _webui_body_fields()
    assert {"text", "voice", "temperature", "lsd_steps"} <= fields
    body = {"text": "Contract check.", "voice": None, "temperature": 0.6,
            "lsd_steps": 2, "noise_clamp": 1.5, "eos_threshold": 4.0,
            "continuation_frames": 0, "adapter": None}
    assert set(body) == fields, (set(body), fields)
    body["voice"] = "alba"
    pcm = _post(loop, c, "/stream", body)
    assert len(pcm) > 0 and len(pcm) % 2 == 0
    _check_wav(_post(loop, c, "/generate", body))


def test_webui_endpoints_exist(client):
    """Every endpoint the page fetches is routed, and GET / serves the page."""
    endpoints = set(re.findall(r"fetch\('(/[\w/]*)'", PAGE))
    assert {"/stream", "/generate"} <= endpoints
    c, loop = client

    async def go():
        for ep in endpoints:
            resp = await c.post(ep, json={"text": "ping"})
            if resp.status == 405:  # GET-only route (/health)
                resp = await c.get(ep)
            assert resp.status == 200, (ep, await resp.text())
        page = await c.get("/")
        assert page.status == 200 and page.content_type == "text/html"
        return await page.text()

    assert loop.run_until_complete(go()) == PAGE


def test_malformed_json_is_400(client):
    c, loop = client

    async def go(route):
        resp = await c.post(route, data=b"{not json", headers={"Content-Type": "application/json"})
        return resp.status

    for route in ("/generate", "/stream", "/tts", "/v1/audio/speech"):
        assert loop.run_until_complete(go(route)) == 400, route

    async def go_nonobject():
        resp = await c.post("/generate", json=["a", "list"])
        return resp.status

    assert loop.run_until_complete(go_nonobject()) == 400


def test_unresolvable_explicit_voice_is_400(client):
    c, loop = client

    async def go(body):
        resp = await c.post("/generate", json=body)
        return resp.status

    assert loop.run_until_complete(go({"text": "hi", "voice": "albba-no-such-voice"})) == 400
    assert loop.run_until_complete(go({"text": "hi"})) == 200


def test_midstream_failure_aborts_connection(model):
    """A producer failure after the status line aborts the connection, so the
    client tells truncation from success."""
    loop = asyncio.new_event_loop()
    state = ServerState(model)
    orig = model.generate_stream_long

    def exploding(*a, **kw):
        for chunk in orig(*a, **kw):
            yield chunk
            raise RuntimeError("simulated mid-stream decode failure")

    model.generate_stream_long = exploding  # the per-request clone copies it
    try:
        c = _serve(loop, create_app(state))

        async def go():
            import aiohttp

            resp = await c.post("/stream", json={"text": "A failing stream."})
            assert resp.status == 200
            try:
                await resp.read()
            except aiohttp.ClientError:
                return "aborted"
            return "clean"

        assert loop.run_until_complete(go()) == "aborted"
        loop.run_until_complete(c.close())
    finally:
        del model.generate_stream_long
        loop.close()


# -- against the JAX server and the library ---------------------------------------


def _voice_b64() -> str:
    rng = np.random.default_rng(5)
    wav = (rng.standard_normal(16000) * 0.1).astype(np.float32)
    buf = io.BytesIO()
    with wave.open(buf, "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(16000)
        f.writeframes((np.clip(wav, -1, 1) * 32767).astype("<i2").tobytes())
    return base64.b64encode(buf.getvalue()).decode()


@pytest.mark.parametrize("route,body", [
    ("/generate", {"text": "Hello from the server. A second sentence follows."}),
    ("/v1/audio/speech", {"model": "pocket-tts", "input": "OpenAI compatible.",
                          "voice": "alba"}),
    ("/generate", {"text": "A cloned voice speaks.", "voice": _voice_b64()}),
], ids=["generate", "openai", "voice"])
def test_matches_jax_server(pair, route, body):
    port, ref, loop = pair
    got, want = _samples(_post(loop, port, route, body)), _samples(_post(loop, ref, route, body))
    assert got.size == want.size > 0
    assert np.abs(got - want).max() <= LSB


def test_routes_equal_their_library_entry_points(client, model):
    c, loop = client
    text = "The stream and the whole file. [pause:200ms] Then a second segment."
    wav = _post(loop, c, "/generate", {"text": text})
    pcm = _post(loop, c, "/stream", {"text": text})
    assert wav == audio.wav_bytes(model.generate_with_pauses(text), model.sample_rate)
    assert pcm == audio.pcm_i16_le_bytes(np.concatenate(list(model.generate_stream_long(text))))
    whole, streamed = _samples(wav), np.frombuffer(pcm, "<i2").astype(np.int64)
    assert whole.shape == streamed.shape
    assert np.abs(whole - streamed).max() <= LSB


def test_batcher_route_matches_single_stream(model):
    """The same temp-0 request, lone (single stream) and while the lock is
    held (B=2 batcher, its own lane), with lsd_steps 2 and a noise clamp
    riding as per-slot data."""
    batcher = batched_tts(model, batch_size=2, chunk_frames=4)
    loop = asyncio.new_event_loop()
    state = ServerState(model, batcher=batcher)
    c = _serve(loop, create_app(state))
    body = {"text": "Routed to the batcher. [pause:100ms] Still the same voice.",
            "lsd_steps": 2, "noise_clamp": 0.5}
    try:
        lone = _samples(_post(loop, c, "/generate", body))
        assert batcher.stats()["requests_submitted"] == 0

        async def held(route):
            async with state.lock:
                resp = await c.post(route, json=body)
                assert resp.status == 200
                return await resp.read()

        routed = _samples(loop.run_until_complete(held("/generate")))
        streamed = np.frombuffer(loop.run_until_complete(held("/stream")), "<i2")
        assert batcher.stats()["requests_submitted"] == 2
    finally:
        loop.run_until_complete(c.close())
        loop.close()
        batcher.stop()
    assert routed.shape == lone.shape == streamed.shape and lone.size > 0
    assert np.abs(routed - lone).max() <= LSB
    assert np.abs(streamed.astype(np.int64) - lone).max() <= LSB


def test_closed_stream_cancels_its_batcher_request(model):
    """Closing the request layer's iterator after its first chunk retires the
    request in the batcher, which goes idle.  Twelve sentences: the request
    is still decoding when the first chunk is read."""
    import time

    batcher = batched_tts(model, batch_size=2, chunk_frames=4)
    state = ServerState(model, batcher=batcher)

    async def go():
        async with state.lock:  # a busy single stream: the request rides the batcher
            chunks = await app_mod.open_stream(state, {"text": " ".join(
                f"Sentence number {i} of a long stream that the client abandons." for i in range(12))})
            first = await chunks.__anext__()
            await chunks.aclose()
        return first

    try:
        first = asyncio.run(go())
        assert len(first) > 0
        deadline = time.monotonic() + 10
        while not batcher.idle() and time.monotonic() < deadline:
            time.sleep(0.01)
        st = batcher.stats()
        assert batcher.idle() and st["requests_cancelled"] == 1 and st["requests_completed"] == 0
    finally:
        batcher.stop()


# -- adapters, aiohttp missing, the CLI ------------------------------------------


def test_adapters_are_refused(client, model, tmp_path):
    """A name no adapter was registered under, and a registered artifact that
    fails to load, are 400s with the JAX server's words."""
    c, loop = client

    async def go(cl, route, body):
        resp = await cl.post(route, json=body)
        return resp.status, await resp.json()

    for route in ("/generate", "/stream"):
        status, body = loop.run_until_complete(go(c, route, {"text": "hi", "adapter": "spk"}))
        assert status == 400 and body["error"] == "unknown adapter 'spk'; registered: none"
    broken = _serve(loop, create_app(ServerState(
        model, adapters={"spk": str(tmp_path / "missing.safetensors")})))
    try:
        status, body = loop.run_until_complete(go(broken, "/generate",
                                                  {"text": "hi", "adapter": "spk"}))
        assert status == 400 and body["error"].startswith("adapter 'spk' failed to load")
    finally:
        loop.run_until_complete(broken.close())


class TestAdapters:
    """Request-selectable fine-tuned adapters (``--adapter name=path``): the
    merged model on the single stream, per-adapter voice caches, the LRU, and
    bankable adapters on the batcher."""

    @pytest.fixture(scope="class")
    def adapter_path(self, model, tmp_path_factory):
        from pocket_tts_tpu_torch.training import finetune, save_lora_params

        rng = np.random.default_rng(4)
        pairs = [("adapter voice", rng.normal(size=(2 * 1920,)).astype(np.float32) * 0.1)]
        tuned = finetune(model, pairs, steps=4, batch_size=1, lr=5e-2, log_every=0,
                         lora_rank=2)
        factors, rank, alpha = tuned._lora
        path = tmp_path_factory.mktemp("adapters") / "spk.lora.safetensors"
        save_lora_params(factors, path, rank=rank, alpha=alpha)
        return str(path)

    @pytest.fixture()
    def apair(self, model, jax_model, adapter_path):
        """The port's server and the JAX server, both with adapter "spk"."""
        loop = asyncio.new_event_loop()
        port = _serve(loop, create_app(ServerState(model, adapters={"spk": adapter_path})))
        ref = _serve(loop, japp.create_app(japp.ServerState(jax_model,
                                                            adapters={"spk": adapter_path})))
        yield port, ref, loop
        for c in (port, ref):
            loop.run_until_complete(c.close())
        loop.close()

    def test_adapter_selects_tuned_model(self, apair):
        port, ref, loop = apair

        async def health():
            resp = await port.get("/health")
            return (await resp.json())["adapters"]

        assert loop.run_until_complete(health()) == ["spk"]
        body = {"text": "Adapter test.", "adapter": "spk"}
        base = _samples(_post(loop, port, "/generate", {"text": "Adapter test."}))
        tuned = _samples(_post(loop, port, "/generate", body))
        want = _samples(_post(loop, ref, "/generate", body))
        assert tuned.size == want.size > 0
        assert np.abs(tuned - want).max() <= LSB
        # temp 0: the same request differs only through the adapter's weights
        assert base.shape != tuned.shape or np.abs(base - tuned).max() > LSB

    def test_adapter_streams_and_caches(self, apair):
        port, ref, loop = apair
        body = {"text": "Stream adapted.", "adapter": "spk"}
        pcm = np.frombuffer(_post(loop, port, "/stream", body), "<i2").astype(np.int64)
        want = np.frombuffer(_post(loop, ref, "/stream", body), "<i2").astype(np.int64)
        assert pcm.size == want.size > 0 and np.abs(pcm - want).max() <= LSB
        speech = {"input": "Speech.", "adapter": "spk"}
        got = _samples(_post(loop, port, "/v1/audio/speech", speech))
        want = _samples(_post(loop, ref, "/v1/audio/speech", speech))
        assert got.size == want.size > 0 and np.abs(got - want).max() <= LSB

    def test_unknown_adapter_400(self, apair):
        port, _, loop = apair

        async def go():
            resp = await port.post("/generate", json={"text": "x", "adapter": "nope"})
            assert resp.status == 400
            assert "unknown adapter" in (await resp.json())["error"]
            resp = await port.post("/stream", json={"text": "x", "adapter": "nope"})
            assert resp.status == 400

        loop.run_until_complete(go())

    def test_adapter_cache_eviction(self, model, adapter_path):
        """The merged-model LRU is bounded; eviction drops the oldest; each
        adapted model has its own voice cache and shares only the empty voice
        holder with the base."""
        state = ServerState(model, adapters={"a": adapter_path, "b": adapter_path},
                            adapter_cache_capacity=1)
        m_a, cache_a = state.adapted("a")
        assert state.adapted("a")[0] is m_a  # a hit
        assert cache_a is not state.cache and m_a.engine is not model.engine
        assert m_a._empty_voice is model._empty_voice
        state.adapted("b")  # evicts a
        assert list(state._adapted) == ["b"]
        assert state.adapted("a")[0] is not m_a  # rebuilt after eviction
        with pytest.raises(app_mod.AdapterError, match="unknown adapter"):
            state.adapted("zzz")

    def test_bankable_adapter_rides_batcher(self, model, adapter_path):
        """An adapter request on a busy batched server rides the B=2 batcher
        as a per-slot row and matches its merged single stream."""
        from pocket_tts_tpu_torch.training import apply_adapted
        from pocket_tts_tpu_torch.training.lora import build_adapter_bank

        bank = build_adapter_bank({"spk": adapter_path})
        batcher = batched_tts(model, batch_size=2, chunk_frames=4, adapter_bank=bank)
        loop = asyncio.new_event_loop()
        state = ServerState(model, batcher=batcher, adapters={"spk": adapter_path},
                            bankable=frozenset(bank.names))
        c = _serve(loop, create_app(state))
        text = "Adapter rides the batch."
        try:
            async def busy():
                async with state.lock:  # the request must ride the batcher
                    resp = await c.post("/generate", json={"text": text, "adapter": "spk"})
                    assert resp.status == 200
                    return await resp.read()

            got = _samples(loop.run_until_complete(busy()))
            assert batcher.stats()["requests_submitted"] == 1
        finally:
            loop.run_until_complete(c.close())
            loop.close()
            batcher.stop()
        want = _samples(audio.wav_bytes(
            apply_adapted(model, adapter_path).generate_with_pauses(text), model.sample_rate))
        assert got.shape == want.shape and got.size > 0
        assert np.abs(got - want).max() <= LSB

    def test_build_state_banks_lora_and_merges_the_rest(self, model, adapter_path, tmp_path):
        """``build_state(adapters=)``: the artifact formats are checked at
        startup; with a batcher the LoRA adapter joins the bank and a full
        fine-tune stays on the merged path; warmup builds both merged models
        (the LRU's capacity is 2)."""
        from pocket_tts_tpu_torch.training import apply_adapted, save_finetuned_params

        full = tmp_path / "full.safetensors"
        save_finetuned_params(apply_adapted(model, adapter_path).params["flow_lm"], full)
        state = app_mod.build_state(model, batch_size=2, default_voice="none",
                                    adapters={"spk": adapter_path, "full": str(full)})
        try:
            assert state.bankable == frozenset({"spk"})
            assert state.batcher.bank.names == ("spk",)
            assert list(state._adapted) == ["spk", "full"]
            assert app_mod.route_to_batcher(state, 0, "spk") is False  # idle: single stream
        finally:
            state.batcher.stop()
        bad = tmp_path / "bad.safetensors"
        tweights.write_safetensors({"x": np.zeros(1, np.float32)}, bad)
        with pytest.raises(ValueError, match="unknown format"):
            app_mod.build_state(model, warmup=False, adapters={"bad": str(bad)})


_NO_AIOHTTP = r"""
import asyncio, dataclasses, json, sys
sys.modules["aiohttp"] = None  # an import of aiohttp now raises
import numpy as np
import torch
torch.set_num_threads(1)
from pocket_tts_tpu_torch import config, weights
from pocket_tts_tpu_torch.runtime.batcher import batched_tts
from pocket_tts_tpu_torch.runtime.engine import GenParams
from pocket_tts_tpu_torch.server import app, fleet
from pocket_tts_tpu_torch.tts import TTSModel
cfg = config.config_from_dict(json.loads(sys.argv[1]))
model = TTSModel(cfg, weights.from_state_dict(weights.random_state_dict(cfg, 0), cfg),
                 gen=GenParams(temp=0.0), has_real_weights=False, device="cpu")
batcher = batched_tts(model, batch_size=2, chunk_frames=4)
state = app.ServerState(model, batcher=batcher)


async def main():
    wav = await app.generate_wav(state, {"text": "Hi there."})
    chunks = await app.open_stream(state, {"text": "Hi there."})
    pcm = b"".join([c async for c in chunks])
    try:
        await app.generate_wav(state, {"text": "Hi.", "lsd_steps": 0})
        raise SystemExit("no RequestError")
    except app.RequestError as e:
        assert e.status == 400
    return wav, pcm


wav, pcm = asyncio.run(main())
assert wav[:4] == b"RIFF" and len(wav) - 44 == len(pcm) > 0
batcher.generate("Hi there.")
assert "pocket_tts_requests_completed 1" in app.metrics_text(state)
assert app.health(state)["status"] == "ok"
fleet.FleetState(["http://127.0.0.1:9"])
batcher.stop()
assert sys.modules["aiohttp"] is None
print("OK")
"""


def test_request_layer_runs_without_aiohttp():
    res = subprocess.run([sys.executable, "-c", _NO_AIOHTTP, json.dumps(dataclasses.asdict(CFG))],
                         cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.strip().endswith("OK")


def _no_model_load(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("the model was loaded")
    monkeypatch.setattr(TTSModel, "load_with_params", boom)


def test_cli_serve_adapter_exits_2(monkeypatch, capsys):
    """A malformed ``--adapter`` is refused before the model loads."""
    _no_model_load(monkeypatch)
    assert cli.main(["serve", "--device", "cpu", "--adapter", "justaname"]) == 2
    assert "--adapter must be name=path" in capsys.readouterr().err


@pytest.mark.parametrize("command", [["serve", "--device", "cpu"],
                                     ["fleet", "--workers", "http://127.0.0.1:9"]])
def test_cli_without_aiohttp_exits_2(monkeypatch, capsys, command):
    _no_model_load(monkeypatch)
    monkeypatch.setitem(sys.modules, "aiohttp", None)
    assert cli.main(command) == 2
    assert "aiohttp" in capsys.readouterr().err


def test_cli_serve_passes_its_options(monkeypatch, model):
    seen = {}
    monkeypatch.setattr(TTSModel, "load_with_params", lambda *a, **k: model)
    monkeypatch.setattr(app_mod, "start_server", lambda m, **kw: seen.update(model=m, **kw))
    assert cli.main(["serve", "--device", "cpu", "--port", "8123", "--batch-size", "16",
                     "--voice-cache-capacity", "3", "--default-voice", "marius",
                     "--prewarm", "alba", "jean", "--no-warmup"]) == 0
    assert seen == {"model": model, "host": "0.0.0.0", "port": 8123, "voice_cache_capacity": 3,
                    "default_voice": "marius", "prewarm": ("alba", "jean"), "warmup": False,
                    "batch_size": 16, "adapters": None}
    assert cli.main(["serve", "--device", "cpu", "--adapter", "a=x.safetensors",
                     "--adapter", "b=y.safetensors"]) == 0
    assert seen["adapters"] == {"a": "x.safetensors", "b": "y.safetensors"}
