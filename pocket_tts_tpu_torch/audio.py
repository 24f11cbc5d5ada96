"""Audio I/O and resampling on the host, numpy and scipy only (port of
``pocket_tts_tpu/audio.py``).

``read_wav`` is a direct RIFF parser (the stdlib ``wave`` module rejects
IEEE-float files); ``resample`` is ``scipy.signal.resample_poly``, the
reference's conversion.  ``pcm_i16_le_bytes``, ``wav_bytes``, ``resample``
and ``normalize_peak`` run the native library (:mod:`.native`) when it is
built, and these numpy versions otherwise.
"""

from __future__ import annotations

import io
import math
import wave
from pathlib import Path

import numpy as np


def read_wav(path: str | Path | bytes) -> tuple[np.ndarray, int]:
    """WAV file or bytes -> (float32 [channels, samples] in [-1, 1], sample rate).

    Handles PCM 8/16/24/32-bit and 32-bit float, WAVE_FORMAT_EXTENSIBLE,
    skips unknown chunks and tolerates a truncated data chunk.  The channel
    count and sample rate are validated before any sample is decoded: the
    bytes may come from a client."""
    buf = path if isinstance(path, bytes) else Path(path).read_bytes()
    if len(buf) < 12 or buf[:4] != b"RIFF" or buf[8:12] != b"WAVE":
        raise ValueError("Not a RIFF/WAVE file")

    def u16(at: int) -> int:
        return int(np.frombuffer(buf[at:at + 2], "<u2")[0])

    def u32(at: int) -> int:
        return int(np.frombuffer(buf[at:at + 4], "<u4")[0])

    off = 12
    fmt = None
    while off + 8 <= len(buf):
        cid = buf[off:off + 4]
        size = u32(off + 4)
        if cid == b"fmt " and off + 24 <= len(buf):
            body = off + 8  # tag, channels, rate, byte rate, block align, bits
            tag, n_ch, sr, bits = u16(body), u16(body + 2), u32(body + 4), u16(body + 14)
            if tag == 0xFFFE and size >= 40 and body + 26 <= len(buf):
                # EXTENSIBLE: the real format tag opens the SubFormat GUID
                tag = u16(body + 24)
            if n_ch < 1 or n_ch > 64:
                raise ValueError(f"Invalid WAV channel count {n_ch}")
            if sr < 1 or sr > 4_000_000:
                raise ValueError(f"Invalid WAV sample rate {sr}")
            fmt = (tag, n_ch, sr, bits)
        elif cid == b"data" and fmt is not None:
            tag, n_ch, sr, bits = fmt
            raw = buf[off + 8: off + 8 + size]  # tolerate truncation
            bytes_per = max(bits // 8, 1)
            raw = raw[: len(raw) - len(raw) % (bytes_per * n_ch)]
            if tag == 3 and bits == 32:
                samples = np.frombuffer(raw, "<f4").astype(np.float32)
            elif bits == 16:
                samples = np.frombuffer(raw, "<i2").astype(np.float32) / 32768.0
            elif bits == 32:
                samples = np.frombuffer(raw, "<i4").astype(np.float32) / 2147483648.0
            elif bits == 24:
                b = np.frombuffer(raw, np.uint8).reshape(-1, 3).astype(np.int32)
                val = b[:, 0] | (b[:, 1] << 8) | (b[:, 2] << 16)
                val = np.where(val >= 1 << 23, val - (1 << 24), val)
                samples = val.astype(np.float32) / float(1 << 23)
            elif bits == 8:
                samples = (np.frombuffer(raw, np.uint8).astype(np.float32) - 128.0) / 128.0
            else:
                raise ValueError(f"Unsupported WAV format tag={tag} bits={bits}")
            return np.ascontiguousarray(samples.reshape(-1, n_ch).T), sr
        off += 8 + size + (size & 1)
    raise ValueError("No data chunk found in WAV file")


def pcm_i16_le_bytes(audio: np.ndarray) -> bytes:
    """float [-1, 1] -> little-endian int16 PCM bytes: samples clipped,
    scaled by 32767 and truncated toward zero."""
    from pocket_tts_tpu_torch import native

    if native.available():
        return native.pcm_i16_le_bytes(np.asarray(audio, np.float32))
    pcm = np.clip(np.asarray(audio, np.float32).reshape(-1), -1.0, 1.0) * 32767.0
    return pcm.astype("<i2").tobytes()


def write_wav(path: str | Path, audio: np.ndarray, sample_rate: int) -> None:
    """Mono 16-bit PCM WAV (``pcm_i16_le_bytes``)."""
    with wave.open(str(path), "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(sample_rate)
        f.writeframes(pcm_i16_le_bytes(audio))


def wav_bytes(audio: np.ndarray, sample_rate: int) -> bytes:
    """A whole mono 16-bit PCM WAV file in memory."""
    from pocket_tts_tpu_torch import native

    if native.available():
        return native.wav_bytes(np.asarray(audio, np.float32), sample_rate)
    buf = io.BytesIO()
    with wave.open(buf, "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(sample_rate)
        f.writeframes(pcm_i16_le_bytes(audio))
    return buf.getvalue()


def wav_header(sample_rate: int, n_frames: int = 1_000_000_000) -> bytes:
    """The 44-byte header of a mono 16-bit WAV stream whose length is not
    known yet: ``n_frames`` is a large placeholder, not patched later."""
    buf = io.BytesIO()
    f = wave.open(buf, "wb")
    f.setnchannels(1)
    f.setsampwidth(2)
    f.setframerate(sample_rate)
    f.setnframes(n_frames)
    f._write_header(0)  # noqa: SLF001 - the stdlib has no header-only API
    return buf.getvalue()


def resample(audio: np.ndarray, from_rate: int, to_rate: int) -> np.ndarray:
    """Polyphase resampling along the last axis."""
    if from_rate == to_rate:
        return audio
    from pocket_tts_tpu_torch import native

    if native.available():
        return native.resample(np.asarray(audio, np.float32), from_rate, to_rate)
    from scipy.signal import resample_poly

    g = math.gcd(int(from_rate), int(to_rate))
    return resample_poly(audio, int(to_rate) // g, int(from_rate) // g,
                         axis=-1).astype(np.float32)


def convert_audio(audio: np.ndarray, from_rate: int, to_rate: int,
                  to_channels: int = 1) -> np.ndarray:
    """[C, T] -> [to_channels, T'] at ``to_rate`` (downmix by the mean)."""
    audio = np.atleast_2d(np.asarray(audio, np.float32))
    if audio.shape[0] != to_channels:
        if to_channels != 1:
            raise ValueError(f"Cannot convert {audio.shape[0]} -> {to_channels} channels")
        audio = audio.mean(axis=0, keepdims=True)
    return resample(audio, from_rate, to_rate)


def normalize_peak(audio: np.ndarray, peak: float = 0.99) -> np.ndarray:
    """Scale ``audio`` down so its largest magnitude is ``peak``; quieter
    audio is returned as it is."""
    from pocket_tts_tpu_torch import native

    if native.available():
        return native.normalize_peak(np.asarray(audio, np.float32), peak)
    m = float(np.max(np.abs(audio))) if audio.size else 0.0
    if m <= peak or m == 0.0:
        return audio
    return audio * (peak / m)
