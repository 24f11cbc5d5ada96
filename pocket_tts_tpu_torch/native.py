"""ctypes binding of the native (C++) audio runtime, ``native/pocket_audio.cc``
(port of ``pocket_tts_tpu/native.py``).

The library is found by path: ``$POCKET_TTS_NATIVE_LIB``, then the copy an
installed wheel carries (``pocket_tts_tpu/_native/``), then the in-tree
``native/libpocket_audio.so``, built with ``make -C native`` when it is
missing or older than its source.  Every entry point has a numpy / scipy
counterpart in :mod:`pocket_tts_tpu_torch.audio`, which ``available()``
gates.  ``POCKET_TTS_NO_NATIVE=1`` forces those.
"""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

logger = logging.getLogger(__name__)

_ROOT = Path(__file__).resolve().parent.parent
_NATIVE_DIR = _ROOT / "native"
_LIB_PATH = _NATIVE_DIR / "libpocket_audio.so"
_WHEEL_LIB = _ROOT / "pocket_tts_tpu" / "_native" / "libpocket_audio.so"
_lib: ctypes.CDLL | None = None
_tried = False
_load_lock = threading.Lock()  # one build and one load, from any thread


def _build() -> bool:
    if not (_NATIVE_DIR / "pocket_audio.cc").exists():
        return False
    try:
        subprocess.run(["make", "-C", str(_NATIVE_DIR)], check=True, capture_output=True,
                       timeout=120)
        return _LIB_PATH.exists()
    except (OSError, subprocess.SubprocessError) as e:
        logger.debug("native build failed: %s", e)
        return False


def _find_lib() -> Path | None:
    env = os.environ.get("POCKET_TTS_NATIVE_LIB")
    if env:
        if Path(env).exists():
            return Path(env)
        logger.warning("POCKET_TTS_NATIVE_LIB=%s does not exist; falling back to the "
                       "bundled library", env)
    if _WHEEL_LIB.exists():
        return _WHEEL_LIB
    src = _NATIVE_DIR / "pocket_audio.cc"
    if _LIB_PATH.exists():
        # rebuild a library older than its source; if that fails (no make),
        # the stale library still beats none
        if src.exists() and src.stat().st_mtime > _LIB_PATH.stat().st_mtime:
            _build()
        return _LIB_PATH
    return _LIB_PATH if _build() else None


def _load() -> ctypes.CDLL | None:
    global _tried
    with _load_lock:
        if not _tried:
            _tried = True
            if os.environ.get("POCKET_TTS_NO_NATIVE") != "1":
                _open()
        return _lib


def _open() -> None:
    global _lib
    path = _find_lib()
    if path is None:
        return
    try:
        lib = ctypes.CDLL(str(path))
        i64, i32 = ctypes.c_int64, ctypes.c_int32
        f32p, i16p, u8p = (np.ctypeslib.ndpointer(np.float32), np.ctypeslib.ndpointer(np.int16),
                           np.ctypeslib.ndpointer(np.uint8))
        lib.pcm_f32_to_i16.argtypes = [f32p, i64, i16p]
        lib.pcm_f32_to_i16.restype = None
        lib.normalize_peak.argtypes = [f32p, i64, ctypes.c_float]
        lib.normalize_peak.restype = None
        lib.resample_poly_out_len.argtypes = [i64, i64, i64]
        lib.resample_poly_out_len.restype = i64
        lib.resample_poly.argtypes = [f32p, i64, i64, i64, f32p]
        lib.resample_poly.restype = i64
        lib.wav_encoded_size.argtypes = [i64]
        lib.wav_encoded_size.restype = i64
        lib.wav_encode.argtypes = [f32p, i64, i32, u8p]
        lib.wav_encode.restype = None
    except (OSError, AttributeError) as e:
        # a stale or foreign library without one of the symbols: the numpy
        # versions serve instead of a crash at the first conversion
        logger.warning("native library unusable (%s); using the numpy versions", e)
        return
    _lib = lib


def available() -> bool:
    return _load() is not None


def pcm_i16_le_bytes(audio: np.ndarray) -> bytes:
    lib = _load()
    flat = np.ascontiguousarray(audio.reshape(-1), np.float32)
    out = np.empty(flat.size, np.int16)
    lib.pcm_f32_to_i16(flat, flat.size, out)
    return out.tobytes()


def resample(audio: np.ndarray, from_rate: int, to_rate: int) -> np.ndarray:
    lib = _load()
    audio = np.ascontiguousarray(audio, np.float32)
    shape = audio.shape
    flat = audio.reshape(-1, shape[-1])
    n_out = lib.resample_poly_out_len(shape[-1], from_rate, to_rate)
    out = np.empty((flat.shape[0], n_out), np.float32)
    for i in range(flat.shape[0]):
        row = np.ascontiguousarray(flat[i])
        lib.resample_poly(row, row.size, from_rate, to_rate, out[i])
    return out.reshape(*shape[:-1], n_out)


def normalize_peak(audio: np.ndarray, peak: float = 0.99) -> np.ndarray:
    lib = _load()
    out = np.ascontiguousarray(audio, np.float32).copy()
    lib.normalize_peak(out.reshape(-1), out.size, ctypes.c_float(peak))
    return out


def wav_bytes(audio: np.ndarray, sample_rate: int) -> bytes:
    lib = _load()
    flat = np.ascontiguousarray(audio.reshape(-1), np.float32)
    buf = np.empty(lib.wav_encoded_size(flat.size), np.uint8)
    lib.wav_encode(flat, flat.size, sample_rate, buf)
    return buf.tobytes()
