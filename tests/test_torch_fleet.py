"""The port's fleet router (``pocket_tts_tpu_torch/server/fleet.py``): the
cases of tests/test_fleet.py over the port's workers (least-outstanding
routing, fail-over before the first byte, aggregated health, the query
string forwarded), and one mixed fleet, the port's router over a JAX worker
and a port worker on one weight set (small config of tests/test_tts.py,
temp 0): both answer /generate with WAVs of equal length within 4 int16 LSB
(1e-4 in float audio, plus one truncation step), so the wire API is the same.
"""

import asyncio
import dataclasses
import io
import wave

import numpy as np
import pytest
import torch

pytest.importorskip("aiohttp")
from aiohttp import web  # noqa: E402
from aiohttp.test_utils import TestClient, TestServer  # noqa: E402

from pocket_tts_tpu import weights as jweights  # noqa: E402
from pocket_tts_tpu.models.mimi import MimiPlans  # noqa: E402
from pocket_tts_tpu.runtime.engine import GenParams as JaxGen  # noqa: E402
from pocket_tts_tpu.server import app as japp  # noqa: E402
from pocket_tts_tpu.tts import TTSModel as JaxTTS  # noqa: E402
from pocket_tts_tpu_torch import weights as tweights  # noqa: E402
from pocket_tts_tpu_torch.config import config_from_dict  # noqa: E402
from pocket_tts_tpu_torch.runtime.engine import GenParams  # noqa: E402
from pocket_tts_tpu_torch.server.app import ServerState, create_app  # noqa: E402
from pocket_tts_tpu_torch.server.fleet import FleetState, create_router_app  # noqa: E402
from pocket_tts_tpu_torch.tts import TTSModel  # noqa: E402
from tests.test_tts import CFG  # noqa: E402

torch.set_num_threads(1)
PCFG = config_from_dict(dataclasses.asdict(CFG))


@pytest.fixture(scope="module")
def exported():
    plans = MimiPlans(CFG.mimi)
    jp = jweights.random_params(CFG, plans, seed=3)
    return jp, jweights.export_state_dict(jp, plans)


@pytest.fixture(scope="module")
def model(exported):
    return TTSModel(PCFG, tweights.from_state_dict(exported[1], PCFG), gen=GenParams(temp=0.0),
                    has_real_weights=False, device="cpu")


def _url(srv: TestServer) -> str:
    return str(srv.make_url("/"))[:-1]


@pytest.fixture()
def fleet(model):
    """Router over two port workers plus one dead URL."""
    loop = asyncio.new_event_loop()
    workers = []
    for _ in range(2):
        srv = TestServer(create_app(ServerState(model)))
        loop.run_until_complete(srv.start_server())
        workers.append(srv)
    state = FleetState([_url(s) for s in workers] + ["http://127.0.0.1:9"])  # nothing on port 9
    client = TestClient(TestServer(create_router_app(state)), loop=loop)
    loop.run_until_complete(client.start_server())
    yield client, loop, state
    loop.run_until_complete(client.close())
    for s in workers:
        loop.run_until_complete(s.close())
    loop.close()


def _samples(data: bytes) -> np.ndarray:
    with wave.open(io.BytesIO(data), "rb") as f:
        assert f.getframerate() == 24000 and f.getnchannels() == 1
        n = f.getnframes()
    pcm = np.frombuffer(data[44:], "<i2").astype(np.int64)
    assert pcm.size == n > 0
    return pcm


def test_fleet_health_aggregates(fleet):
    client, loop, state = fleet

    async def go():
        resp = await client.get("/health")
        return resp.status, await resp.json()

    status, body = loop.run_until_complete(go())
    assert status == 200 and body["status"] == "ok"
    assert body["workers_ok"] == 2 and len(body["workers"]) == 3
    assert any(w.get("status") == "unreachable" for w in body["workers"])


def test_fleet_generate_and_failover(fleet):
    """The least-loaded candidate is dead: the request fails over before its
    first byte and returns a valid WAV."""
    client, loop, state = fleet
    for w in state.workers:
        w.outstanding = 0 if w.url.endswith(":9") else 1
        w.healthy = True

    async def go():
        resp = await client.post("/generate", json={"text": "Fleet hello."})
        return resp.status, await resp.read()

    status, data = loop.run_until_complete(go())
    assert status == 200
    _samples(data)
    dead = next(w for w in state.workers if w.url.endswith(":9"))
    assert not dead.healthy and dead.last_error


def test_fleet_stream_passthrough(fleet):
    client, loop, state = fleet

    async def go():
        resp = await client.post("/stream", json={"text": "Streaming fleet."})
        assert resp.status == 200
        return await resp.read()

    pcm = loop.run_until_complete(go())
    assert len(pcm) > 0 and len(pcm) % 2 == 0
    assert np.isfinite(np.frombuffer(pcm, "<i2").astype(np.float32)).all()


def test_fleet_all_dead_503():
    loop = asyncio.new_event_loop()
    state = FleetState(["http://127.0.0.1:9", "http://127.0.0.1:10"])
    client = TestClient(TestServer(create_router_app(state)), loop=loop)
    loop.run_until_complete(client.start_server())
    try:
        async def go():
            resp = await client.post("/generate", json={"text": "x"})
            return resp.status

        assert loop.run_until_complete(go()) == 503
    finally:
        loop.run_until_complete(client.close())
        loop.close()


def test_fleet_degraded_worker_not_marked_healthy(model):
    """A worker answering 200 {"status": "degraded"} stays out of the
    healthy routing set."""
    loop = asyncio.new_event_loop()

    async def degraded_health(request):
        return web.json_response({"status": "degraded"})

    stub = web.Application()
    stub.router.add_get("/health", degraded_health)
    stub_srv = TestServer(stub)
    loop.run_until_complete(stub_srv.start_server())
    real_srv = TestServer(create_app(ServerState(model)))
    loop.run_until_complete(real_srv.start_server())
    state = FleetState([_url(stub_srv), _url(real_srv)])
    client = TestClient(TestServer(create_router_app(state)), loop=loop)
    loop.run_until_complete(client.start_server())
    try:
        async def go():
            h = await client.get("/health")
            body = await h.json()
            g = await client.post("/generate", json={"text": "Degraded test."})
            return body, g.status

        body, status = loop.run_until_complete(go())
        assert body["workers_ok"] == 1
        assert not state.workers[0].healthy and state.workers[1].healthy
        assert status == 200
    finally:
        loop.run_until_complete(client.close())
        loop.run_until_complete(stub_srv.close())
        loop.run_until_complete(real_srv.close())
        loop.close()


def test_fleet_forwards_query_string():
    loop = asyncio.new_event_loop()
    seen = []

    async def echo(request):
        seen.append(request.path_qs)
        return web.Response(body=b"ok", content_type="audio/wav")

    stub = web.Application()
    stub.router.add_post("/generate", echo)
    srv = TestServer(stub)
    loop.run_until_complete(srv.start_server())
    client = TestClient(TestServer(create_router_app(FleetState([_url(srv)]))), loop=loop)
    loop.run_until_complete(client.start_server())

    async def go():
        resp = await client.post("/generate?trace=1&x=a%20b", json={"text": "hi"})
        assert resp.status == 200

    try:
        loop.run_until_complete(go())
    finally:
        loop.run_until_complete(client.close())
        loop.run_until_complete(srv.close())
        loop.close()
    assert seen == ["/generate?trace=1&x=a%20b"]


def test_mixed_fleet_jax_and_port_workers_agree(exported, model):
    """The port's router over a JAX worker and a port worker: each answers
    the same /generate when it ranks first, within 4 int16 LSB of the other."""
    loop = asyncio.new_event_loop()
    jax_model = JaxTTS(CFG, exported[0], gen=JaxGen(temp=0.0), has_real_weights=False)
    apps = [japp.create_app(japp.ServerState(jax_model)), create_app(ServerState(model))]
    served = [[], []]  # the paths each worker answered
    for app, log in zip(apps, served):
        async def record(request, response, log=log):
            log.append(request.path)
        app.on_response_prepare.append(record)
    servers = [TestServer(app) for app in apps]
    for srv in servers:
        loop.run_until_complete(srv.start_server())
    state = FleetState([_url(s) for s in servers])
    client = TestClient(TestServer(create_router_app(state)), loop=loop)
    loop.run_until_complete(client.start_server())

    async def via(first: int) -> bytes:
        for i, w in enumerate(state.workers):
            w.outstanding = 0 if i == first else 5
        resp = await client.post("/generate", json={"text": "Two workers, one wire API."})
        assert resp.status == 200, await resp.text()
        return await resp.read()

    try:
        jax_wav, port_wav = (loop.run_until_complete(via(i)) for i in (0, 1))
    finally:
        loop.run_until_complete(client.close())
        for srv in servers:
            loop.run_until_complete(srv.close())
        loop.close()
    assert served == [["/generate"], ["/generate"]]
    got, want = _samples(port_wav), _samples(jax_wav)
    assert got.size == want.size
    assert np.abs(got - want).max() <= 4
    assert all(w.healthy for w in state.workers)
