"""The port's binding of the native (C++) audio runtime
(``pocket_tts_tpu_torch/native.py``): the cases of tests/test_native.py,
each against the port's numpy / scipy versions (``audio.py`` with the
library switched off), and the port's ``wav_bytes`` / ``pcm_i16_le_bytes``
byte-equal to the JAX package's on the same input, on both routes.  The
cases that need the built library skip when it cannot be built (no
compiler), as the JAX package's do.  Left out: the golden-asset input case
(test_native.py:66), which reads a reference checkout that the repo does
not carry; the resampler is held to scipy at four rates here.
"""

import io
import wave

import numpy as np
import pytest

from pocket_tts_tpu import audio as jaudio
from pocket_tts_tpu_torch import audio, native


@pytest.fixture
def lib():
    if not native.available():
        pytest.skip("native library unavailable (no compiler?)")
    return native


@pytest.fixture
def numpy_audio(monkeypatch):
    """``audio`` with the native library switched off."""
    monkeypatch.setattr(native, "available", lambda: False)
    return audio


def test_pcm_parity(lib, numpy_audio):
    rng = np.random.default_rng(0)
    x = (rng.normal(size=10000) * 0.7).astype(np.float32)
    x[:3] = [2.0, -2.0, 0.0]
    assert lib.pcm_i16_le_bytes(x) == numpy_audio.pcm_i16_le_bytes(x)


@pytest.mark.parametrize("from_rate,to_rate", [(44100, 24000), (16000, 24000),
                                               (48000, 24000), (22050, 24000)])
def test_resample_matches_scipy(lib, numpy_audio, from_rate, to_rate):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(1, from_rate)).astype(np.float32) * 0.5
    got = lib.resample(x, from_rate, to_rate)
    ref = numpy_audio.resample(x, from_rate, to_rate)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() < 1e-5


def test_resample_identity(lib):
    x = np.random.default_rng(2).normal(size=(1, 1000)).astype(np.float32)
    np.testing.assert_array_equal(lib.resample(x, 24000, 24000), x)


def test_normalize_peak_parity(lib, numpy_audio):
    x = np.array([0.5, -2.0, 1.2], np.float32)
    np.testing.assert_allclose(lib.normalize_peak(x), numpy_audio.normalize_peak(x), atol=1e-7)
    quiet = np.array([0.1, -0.2], np.float32)
    np.testing.assert_array_equal(lib.normalize_peak(quiet), quiet)


def test_wav_encode_parses(lib):
    sr = 24000
    x = np.sin(np.linspace(0, 50, sr)).astype(np.float32) * 0.5
    data = lib.wav_bytes(x, sr)
    with wave.open(io.BytesIO(data), "rb") as f:
        assert f.getframerate() == sr and f.getnchannels() == 1 and f.getnframes() == sr
    back, sr2 = audio.read_wav(data)
    assert sr2 == sr
    assert np.abs(back[0] - x).max() < 1e-3


def test_wav_encode_matches_python(lib, numpy_audio):
    x = np.random.default_rng(3).normal(size=4321).astype(np.float32) * 0.5
    assert lib.wav_bytes(x, 24000) == numpy_audio.wav_bytes(x, 24000)


def test_pcm_nan_is_zero(numpy_audio):
    """NaN converts to 0 on the numpy route and, where it is built, on the
    native one."""
    x = np.array([float("nan"), 0.25, float("-nan"), -0.25], np.float32)
    want = (np.where(np.isnan(x), 0.0, x) * 32767.0).astype("<i2")
    got = np.frombuffer(numpy_audio.pcm_i16_le_bytes(x), "<i2")
    np.testing.assert_array_equal(got, want)
    if native._load() is not None:
        np.testing.assert_array_equal(np.frombuffer(native.pcm_i16_le_bytes(x), "<i2"), want)


@pytest.mark.parametrize("route", ["native", "numpy"])
def test_bytes_equal_the_jax_package(route, monkeypatch):
    """The port's WAV, PCM, header and peak normalization against the JAX
    package's on the same input."""
    if route == "native" and not native.available():
        pytest.skip("native library unavailable (no compiler?)")
    if route == "numpy":
        from pocket_tts_tpu import native as jnative

        monkeypatch.setattr(native, "available", lambda: False)
        monkeypatch.setattr(jnative, "available", lambda: False)
    rng = np.random.default_rng(4)
    x = (rng.normal(size=5003) * 0.6).astype(np.float32)
    x[:4] = [1.5, -1.5, 1.0, -1.0]
    assert audio.wav_bytes(x, 24000) == jaudio.wav_bytes(x, 24000)
    assert audio.pcm_i16_le_bytes(x) == jaudio.pcm_i16_le_bytes(x)
    assert audio.wav_header(24000) == jaudio.wav_header(24000)
    np.testing.assert_array_equal(audio.normalize_peak(x), jaudio.normalize_peak(x))


def test_binding_honours_no_native_and_lib_path(monkeypatch, tmp_path):
    """``POCKET_TTS_NO_NATIVE=1`` switches the library off; a missing
    ``POCKET_TTS_NATIVE_LIB`` falls back to the in-tree library."""
    monkeypatch.setattr(native, "_tried", False)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setenv("POCKET_TTS_NO_NATIVE", "1")
    assert not native.available()
    monkeypatch.delenv("POCKET_TTS_NO_NATIVE")
    monkeypatch.setenv("POCKET_TTS_NATIVE_LIB", str(tmp_path / "missing.so"))
    assert native._find_lib() in (None, native._WHEEL_LIB, native._LIB_PATH)
