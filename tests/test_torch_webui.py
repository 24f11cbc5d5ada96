"""The web player against the port's server: the cases of
tests/test_webui_player.py on the page the port serves at GET / (read by
path from ``pocket_tts_tpu/server/webui.html``), with the scraped model of
the page's AudioWorklet player (``ScrapedPlayer``, reused from that file)
driven by a real /stream response of the port.
"""

import re

import numpy as np
import pytest

pytest.importorskip("aiohttp")

from tests.test_webui_player import ScrapedPlayer  # noqa: E402

from .test_torch_server import client, exported, model  # noqa: E402,F401  (fixtures)


@pytest.fixture()
def page(client):  # noqa: F811
    c, loop = client

    async def go():
        resp = await c.get("/")
        assert resp.status == 200 and resp.content_type == "text/html"
        return await resp.text()

    return loop.run_until_complete(go())


def test_scraped_constants_match_reference_spa(page):
    """3 s start pre-roll, 0.5 s resume, 24 kHz, reports every 40 quanta, the
    5 s adaptive bump, and the worklet registered under its node's name."""
    p = ScrapedPlayer()
    assert p.worklet in page
    assert p.sample_rate == 24000
    assert p.start_threshold == 24000 * 3
    assert p.resume_threshold == 24000 // 2
    assert p.report_every == 40
    assert re.search(r"received / elapsed < (\d+)", page)
    assert int(re.search(r"startThreshold: (\d+) \* 5\.0", page).group(1)) == 24000
    assert "registerProcessor('pcm-processor'" in page
    assert "AudioWorkletNode(ctx, 'pcm-processor'" in page


def test_stock_voice_picker_and_selectors(page):
    opts = re.findall(r"<option(?: value=\"(__\w+__)\")?>([^<]*)</option>",
                      re.search(r'<select id="voice">(.*?)</select>', page, re.S).group(1))
    assert [text for val, text in opts if not val] == [
        "alba", "marius", "javert", "jean", "fantine", "cosette", "eponine", "azelma"]
    assert {val for val, _ in opts if val} == {"__upload__", "__url__"}
    assert "fetch('/health')" in page and "h.adapters" in page
    for el in ("bufbar", "bufsec", "recv", "wall", "rtf", "state", "gen", "chars"):
        assert f'id="{el}"' in page, f"stats element #{el} missing"
    assert re.search(r"\$\('gen'\)\.textContent = \(\(performance\.now", page)
    assert "$('text').oninput" in page


def test_player_drives_real_stream(client):  # noqa: F811
    """A real /stream response of the port through the scraped player: the
    state machine walks to playing and then finished, buffer reports update,
    the stream ends on a whole sample."""
    c, loop = client

    async def fetch_pcm():
        body = {"text": "Drive the player with real streamed audio.",
                "voice": None, "temperature": 0.0, "lsd_steps": 1}
        resp = await c.post("/stream", json=body)
        assert resp.status == 200, await resp.text()
        return [piece async for piece, _ in resp.content.iter_chunks()]

    chunks = loop.run_until_complete(fetch_pcm())
    assert chunks and sum(map(len, chunks)) > 0
    p = ScrapedPlayer()
    p.start_threshold = p.sample_rate // 5  # the page's #startbuf for a short utterance
    total, leftover = 0, b""
    for piece in chunks:  # the page's reader loop: 16-bit alignment carry
        data = leftover + piece
        usable = len(data) & ~1
        leftover = data[usable:]
        n = np.frombuffer(data[:usable], "<i2").size
        total += n
        p.push(n)
        assert p.process()
    assert not leftover, "stream ended on a half-sample"
    p.eos()
    alive, guard = True, 0
    while alive:
        alive = p.process()
        guard += 1
        assert guard < 10_000_000
    states = [e[1] for e in p.events if e[0] == "state"]
    assert states[0] == "playing" and states[-1] == "finished"
    reports = [e[1] for e in p.events if e[0] == "buffer"]
    assert reports and max(reports) > 0, "buffer stats never updated"
    assert total * 1000 // 24000 > 100, "less than 100 ms of audio streamed"
