"""Voice specification resolution and an LRU voice-state cache (port of
``pocket_tts_tpu/server/voices.py``).

Resolution order: predefined names -> hf:// URI -> http(s):// URL (gated) ->
local .wav / .safetensors path -> base64 or data-URL WAV bytes.  Resolved
states are cached in an LRU keyed by a spec hash (file keys include mtime and
size, so edits invalidate).  The stock voices' files are not shipped: a
predefined name resolves only when its file is in the local Hugging Face
cache (``weights.resolve_uri``), and raises ``FileNotFoundError`` otherwise.
"""

from __future__ import annotations

import base64
import binascii
import collections
import hashlib
import logging
import os
import threading
import urllib.parse
import urllib.request
from pathlib import Path

from pocket_tts_tpu_torch import weights as weights_mod
from pocket_tts_tpu_torch.tts import TTSModel, VoiceState

logger = logging.getLogger(__name__)

PREDEFINED_VOICES = (
    "alba", "marius", "javert", "jean", "fantine", "cosette", "eponine", "azelma",
)
_STOCK_REPO = "kyutai/pocket-tts-without-voice-cloning"
_STOCK_REV = "d4fdd22ae8c8e1cb3634e150ebeff1dab2d16df3"
DEFAULT_VOICE = "alba"


class VoiceResolutionError(ValueError):
    """A voice spec that is none of the accepted forms."""


def stock_voice_uri(name: str) -> str:
    return f"hf://{_STOCK_REPO}/embeddings/{name}.safetensors@{_STOCK_REV}"


def voice_cache_key(spec: str) -> str:
    spec = spec.strip()
    if spec in PREDEFINED_VOICES:
        return f"stock:{spec}"
    if spec.startswith("hf://"):
        return f"hf:{spec}"
    if spec.startswith(("http://", "https://")):
        return f"url:{spec}"
    try:
        path = Path(spec)
        if len(spec) < 4096 and path.exists():
            st = path.stat()
            return f"file:{path.resolve()}:{int(st.st_mtime)}:{st.st_size}"
    except OSError:
        pass
    # base64 / data-url: content hash
    return "b64:" + hashlib.sha256(spec.encode()).hexdigest()[:32]


def _decode_base64_audio(spec: str) -> bytes | None:
    data = spec
    if spec.startswith("data:"):
        if "," not in spec:
            return None
        data = spec.split(",", 1)[1]
    try:
        raw = base64.b64decode(data, validate=True)
    except (binascii.Error, ValueError):
        return None
    return raw if raw[:4] == b"RIFF" else None


def resolve_voice(model: TTSModel, spec: str | None) -> VoiceState:
    """Spec -> VoiceState (reads the HF cache; fetches a URL only when its
    gate is open)."""
    if not spec:
        spec = DEFAULT_VOICE
    spec = spec.strip()
    if spec in PREDEFINED_VOICES:
        path = weights_mod.resolve_uri(stock_voice_uri(spec))
        return model.get_voice_state_from_prompt_file(path)
    if spec.startswith("hf://"):
        return _from_path(model, weights_mod.resolve_uri(spec))
    if spec.startswith(("http://", "https://")):
        return _from_url(model, spec)
    try:
        path = Path(spec)
        if len(spec) < 4096 and path.exists():
            return _from_path(model, path)
    except OSError:
        pass
    raw = _decode_base64_audio(spec)
    if raw is not None:
        return model.get_voice_state_from_wav(raw)
    raise VoiceResolutionError(
        f"Cannot resolve voice {spec!r}: not a predefined name "
        f"{list(PREDEFINED_VOICES)}, hf:// URI, http(s):// URL, existing "
        f"file, or base64 WAV")


def _from_path(model: TTSModel, path: Path) -> VoiceState:
    if path.suffix == ".safetensors":
        return model.get_voice_state_from_prompt_file(path)
    return model.get_voice_state_from_wav(path)


def _from_url(model: TTSModel, url: str) -> VoiceState:
    """Plain-URL voice: a WAV, or an ``audio_prompt`` safetensors file.

    Fetching is gated on POCKET_TTS_ONLINE=1 (an ungated fetch on a machine
    without network would hang for the socket timeout).  Loopback URLs have
    their own opt-in, POCKET_TTS_LOOPBACK_VOICES=1: an unconditional loopback
    exemption would let any client probe localhost-only services."""
    host = urllib.parse.urlparse(url).hostname or ""
    if host in ("localhost", "127.0.0.1", "::1"):
        if os.environ.get("POCKET_TTS_LOOPBACK_VOICES", "0") != "1":
            raise ValueError(
                f"loopback URL voice {url!r} is disabled; set "
                f"POCKET_TTS_LOOPBACK_VOICES=1 to allow fetching from localhost services")
    elif os.environ.get("POCKET_TTS_ONLINE", "0") != "1":
        raise ValueError(f"URL voice {url!r} needs network access; set POCKET_TTS_ONLINE=1")
    with urllib.request.urlopen(url, timeout=30) as resp:
        raw = resp.read()
    if raw[:4] == b"RIFF":
        return model.get_voice_state_from_wav(raw, truncate=True)
    sd = weights_mod.read_safetensors_bytes(raw, url)
    if "audio_prompt" not in sd:
        raise ValueError(f"URL voice {url!r} is neither a WAV nor an audio_prompt safetensors")
    return model.get_voice_state_from_prompt(sd["audio_prompt"])


class VoiceStateCache:
    """Thread-safe LRU of voice states."""

    def __init__(self, capacity: int = 8):
        self.capacity = capacity
        self._store: collections.OrderedDict[str, VoiceState] = collections.OrderedDict()
        self._lock = threading.Lock()

    def __len__(self) -> int:
        return len(self._store)

    def get(self, key: str) -> VoiceState | None:
        with self._lock:
            if key in self._store:
                self._store.move_to_end(key)
                return self._store[key]
        return None

    def put(self, key: str, state: VoiceState) -> None:
        with self._lock:
            self._store[key] = state
            self._store.move_to_end(key)
            while len(self._store) > self.capacity:
                evicted, _ = self._store.popitem(last=False)
                logger.info("voice cache evicted %s", evicted)


def resolve_voice_cached(model: TTSModel, spec: str | None,
                         cache: VoiceStateCache) -> VoiceState:
    key = voice_cache_key(spec or DEFAULT_VOICE)
    hit = cache.get(key)
    if hit is not None:
        return hit
    state = resolve_voice(model, spec)
    cache.put(key, state)
    return state
