"""Fleet router: one HTTP front over N serving workers (port of
``pocket_tts_tpu/server/fleet.py``; it imports nothing of the model, and the
workers may be servers of either package: the wire API is the same).

* Least-outstanding-requests routing: a long /stream holds a worker for its
  whole duration, so round-robin would pile streams onto a busy one.
* Fail-over before the first byte: a worker that refuses the request or fails
  before any body bytes are sent is skipped for the next-best one.  After
  bytes have streamed the client sees a truncated stream: audio cannot be
  replayed mid-utterance without duplicating it.
* Health: GET /health probes every worker and aggregates; a worker that fails
  its probe, or answers "degraded", is ranked last until it answers again.

    python -m pocket_tts_tpu_torch.cli serve --port 8001   (one per card)
    python -m pocket_tts_tpu_torch.cli fleet --workers http://h1:8001,http://h2:8001
"""

from __future__ import annotations

import asyncio
import json
import logging
import time

logger = logging.getLogger(__name__)

# request paths the router forwards verbatim
_PROXY_POSTS = ("/generate", "/stream", "/tts", "/v1/audio/speech")


class Worker:
    def __init__(self, url: str):
        self.url = url.rstrip("/")
        self.outstanding = 0
        self.healthy = True
        self.last_error: str | None = None

    def __repr__(self):
        return (f"Worker({self.url}, out={self.outstanding}, "
                f"healthy={self.healthy})")


class FleetState:
    def __init__(self, worker_urls: list[str]):
        if not worker_urls:
            raise ValueError("fleet needs at least one worker URL")
        self.workers = [Worker(u) for u in worker_urls]
        self.started_at = time.time()
        self._session = None

    async def session(self):
        import aiohttp

        if self._session is None:
            # sock_read bounds the gap between received bytes: generous enough
            # for a whole non-streaming /generate of a long text, but converts
            # a hung (accepted-then-deadlocked) worker into a clean fail-over
            # instead of wedging the client forever
            self._session = aiohttp.ClientSession(
                timeout=aiohttp.ClientTimeout(total=None, sock_connect=10,
                                              sock_read=300))
        return self._session

    def ranked(self) -> list[Worker]:
        """Healthy workers first, least outstanding first; unhealthy workers
        last (they get retried when everything else is busy/failing)."""
        return sorted(self.workers,
                      key=lambda w: (not w.healthy, w.outstanding))

    async def close(self):
        if self._session is not None:
            await self._session.close()
            self._session = None


def create_router_app(state: FleetState):
    from aiohttp import web

    routes = web.RouteTableDef()

    @routes.get("/health")
    async def health(request):
        sess = await state.session()

        async def probe(w: Worker):
            try:
                async with sess.get(w.url + "/health") as r:
                    body = await r.json()
                    # a worker whose batcher crashed answers 200 with
                    # status "degraded" (fail-open) — do NOT route to it
                    w.healthy = r.status == 200 and body.get("status") == "ok"
                    w.last_error = None if w.healthy else body.get("status")
                    return {"url": w.url, "outstanding": w.outstanding,
                            **body}
            except Exception as e:  # noqa: BLE001
                w.healthy = False
                w.last_error = str(e)
                return {"url": w.url, "status": "unreachable",
                        "error": str(e)}

        results = await asyncio.gather(*(probe(w) for w in state.workers))
        n_ok = sum(1 for r in results if r.get("status") == "ok")
        return web.json_response({
            "status": "ok" if n_ok else "unavailable",
            "model": "pocket-tts-tpu-fleet",
            "uptime_s": round(time.time() - state.started_at, 1),
            "workers_ok": n_ok,
            "workers": results,
        }, status=200 if n_ok else 503)

    async def proxy(request):
        body = await request.read()
        sess = await state.session()
        candidates = state.ranked()
        last_exc: Exception | None = None
        for w in candidates:
            w.outstanding += 1
            # Fail-over is legal only BEFORE resp.prepare(): once the status
            # line/headers have gone to the client, retrying would write a
            # second header block into the half-sent response.
            prepared = False
            try:
                async with sess.post(
                    # path_qs: forward the query string too, not just the path
                    w.url + request.path_qs, data=body,
                    headers={"Content-Type":
                             request.headers.get("Content-Type",
                                                 "application/json")},
                ) as upstream:
                    if upstream.status >= 500:
                        # worker-side failure before we streamed anything:
                        # eligible for fail-over
                        w.healthy = False
                        w.last_error = f"HTTP {upstream.status}"
                        last_exc = RuntimeError(w.last_error)
                        continue
                    w.healthy = True
                    resp = web.StreamResponse(
                        status=upstream.status,
                        headers={"Content-Type":
                                 upstream.headers.get("Content-Type",
                                                      "application/octet-stream")})
                    while True:
                        # read upstream FIRST: upstream errors here are still
                        # fail-over-eligible until prepare() below runs
                        chunk = await upstream.content.readany()
                        try:
                            if not prepared:
                                await resp.prepare(request)
                                prepared = True
                            if not chunk:
                                await resp.write_eof()
                                return resp
                            await resp.write(chunk)
                        except Exception as e:  # noqa: BLE001
                            # CLIENT-side failure (disconnect/abort): the
                            # worker is fine — do not mark it unhealthy, do
                            # not fail over, just stop forwarding
                            logger.info("client gone during %s via %s: %s",
                                        request.path, w.url, e)
                            return resp
            except Exception as e:  # noqa: BLE001
                w.healthy = False
                w.last_error = str(e)
                last_exc = e
                if prepared:
                    logger.warning("worker %s died mid-stream: %s", w.url, e)
                    raise  # response already started; nothing to fail over to
                logger.warning("worker %s failed pre-stream (%s); failing over",
                               w.url, e)
            finally:
                w.outstanding -= 1
        raise web.HTTPServiceUnavailable(
            text=json.dumps({"error": f"no worker available: {last_exc}"}),
            content_type="application/json")

    for path in _PROXY_POSTS:
        routes.post(path)(proxy)

    app = web.Application()
    app.add_routes(routes)

    async def on_cleanup(app):
        await state.close()

    app.on_cleanup.append(on_cleanup)
    return app


def serve_fleet(worker_urls: list[str], host: str = "0.0.0.0",
                port: int = 8000) -> None:
    from aiohttp import web

    state = FleetState(worker_urls)
    app = create_router_app(state)
    logger.info("fleet router on %s:%d over %d workers", host, port,
                len(state.workers))
    web.run_app(app, host=host, port=port)
