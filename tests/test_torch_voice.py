"""Voice-conditioned synthesis in the port against the JAX package, on the
small config of tests/test_tts.py (its ``encode_seconds_buckets=(1.0, 2.0)``
sends prompts over 2 s down the chunked encoder).  Both packages load one set
of weights (random_params -> export_state_dict -> the port's
from_state_dict); inputs come from numpy seeds; generation runs at temp 0.

Bounds: 1e-5 for ops and single modules (the same float32 algorithm, sums in
another order); 2e-4 for Mimi latents (tests/test_frozen_parity.py); 5e-4 for
the conditioning out of ``encode_voice`` (latents through the speaker
projection); 1e-4 in float audio for whole generations (tests/test_tts.py).
"""

import dataclasses
import struct
import wave

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pocket_tts_tpu import audio as jaudio
from pocket_tts_tpu import pause as jpause
from pocket_tts_tpu import weights as jweights
from pocket_tts_tpu.models import mimi as jmimi
from pocket_tts_tpu.models import seanet as jseanet
from pocket_tts_tpu.models import transformer as jtf
from pocket_tts_tpu.ops import attention as jatt
from pocket_tts_tpu.ops import conv as jconv
from pocket_tts_tpu.ops import rope as jrope
from pocket_tts_tpu.runtime.engine import GenParams as JaxGen
from pocket_tts_tpu.tts import TTSModel as JaxTTS
from pocket_tts_tpu_torch import audio as taudio
from pocket_tts_tpu_torch import pause as tpause
from pocket_tts_tpu_torch import weights as tweights
from pocket_tts_tpu_torch.config import config_from_dict
from pocket_tts_tpu_torch.models import mimi as tmimi
from pocket_tts_tpu_torch.models import seanet as tseanet
from pocket_tts_tpu_torch.models import transformer as ttf
from pocket_tts_tpu_torch.ops import attention as tatt
from pocket_tts_tpu_torch.ops import conv as tconv
from pocket_tts_tpu_torch.ops import rope as trope
from pocket_tts_tpu_torch.runtime.engine import GenParams
from pocket_tts_tpu_torch.tts import TTSModel
from tests.test_tts import CFG

torch.set_num_threads(1)
PCFG = config_from_dict(dataclasses.asdict(CFG))
SR = 24000
TWO_SEGMENTS = ("The first sentence sets the voice in motion and keeps a steady "
                "measured pace through every single word of this opening line. "
                "The second sentence should carry that same voice onward without "
                "resetting the established prosody at the segment boundary here.")


def maxdiff(a, b) -> float:
    a = a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.abs(a.astype(np.float32) - b.astype(np.float32)).max())


def _randn(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _voice(seed: int, seconds: float) -> np.ndarray:
    return _randn(np.random.default_rng(seed), int(seconds * SR), scale=0.1)


@pytest.fixture(scope="module")
def exported():
    plans = jmimi.MimiPlans(CFG.mimi)
    jp = jweights.random_params(CFG, plans, seed=3)
    return jp, jweights.export_state_dict(jp, plans)


def _pair(exported, **runtime):
    jp, sd = exported
    jcfg = dataclasses.replace(CFG, runtime=dataclasses.replace(CFG.runtime, **runtime))
    pcfg = dataclasses.replace(PCFG, runtime=dataclasses.replace(PCFG.runtime, **runtime))
    jax_model = JaxTTS(jcfg, jp, gen=JaxGen(temp=0.0), has_real_weights=False)
    port = TTSModel(pcfg, tweights.from_state_dict(sd, pcfg), gen=GenParams(temp=0.0),
                    has_real_weights=False, device="cpu")
    return jax_model, port


@pytest.fixture(scope="module")
def models(exported):
    return _pair(exported)


@pytest.fixture(scope="module")
def mimi_params(exported):
    jp, sd = exported
    return jp["mimi"], tweights.from_state_dict(sd, PCFG)["mimi"]


# -- ops ---------------------------------------------------------------------


@pytest.mark.parametrize("pad_mode,kernel,stride,dilation", [
    ("constant", 7, 1, 1), ("constant", 3, 1, 4), ("constant", 8, 4, 1),
    ("replicate", 32, 16, 1), ("replicate", 3, 1, 2)])
def test_batch_conv1d_matches_jax(pad_mode, kernel, stride, dilation):
    rng = np.random.default_rng(kernel * 10 + stride)
    spec = tconv.ConvSpec(6, 5, kernel, stride=stride, dilation=dilation, pad_mode=pad_mode)
    jspec = jconv.ConvSpec(6, 5, kernel, stride=stride, dilation=dilation, pad_mode=pad_mode)
    x = _randn(rng, 2, 6, 64) + 1.5  # offset: a zero pad and a replicate pad differ
    w, b = _randn(rng, 5, 6, kernel, scale=0.3), _randn(rng, 5)
    ref = jconv.batch_conv1d(jspec, jnp.asarray(w), jnp.asarray(b), jnp.asarray(x))
    got = tconv.batch_conv1d(spec, torch.from_numpy(w), torch.from_numpy(b),
                             torch.from_numpy(x))
    assert maxdiff(got, ref) <= 1e-5


@pytest.mark.parametrize("groups", [1, 4])
def test_batch_conv_transpose1d_matches_jax(groups):
    rng = np.random.default_rng(groups)
    spec = tconv.ConvTrSpec(4, 4, 8, stride=4, groups=groups)
    jspec = jconv.ConvTrSpec(4, 4, 8, stride=4, groups=groups)
    x, w, b = _randn(rng, 2, 4, 9), _randn(rng, 4, 4 // groups, 8), _randn(rng, 4)
    ref = jconv.batch_conv_transpose1d(jspec, jnp.asarray(w), jnp.asarray(b), jnp.asarray(x))
    got = tconv.batch_conv_transpose1d(spec, torch.from_numpy(w), torch.from_numpy(b),
                                       torch.from_numpy(x))
    assert maxdiff(got, ref) <= 1e-5


@pytest.mark.parametrize("t", [1920, 1921, 5000])
def test_pad_for_frame_matches_jax(t):
    x = _randn(np.random.default_rng(t), 1, 1, t)
    ref = jconv.pad_for_frame(jnp.asarray(x), 1920)
    got = tconv.pad_for_frame(torch.from_numpy(x), 1920)
    assert got.shape[-1] % 1920 == 0 and maxdiff(got, ref) == 0.0


@pytest.mark.parametrize("t,context,block", [
    (10, 6, 16),     # T < block: one masked call
    (64, 20, 16),    # T a block multiple
    (50, 20, 16),    # T ragged
    (50, None, 16),  # no window: plain causal
    (70, 37, 16),    # context not a block multiple (ctx_pad 48)
    (90, 12, 32),    # context under one block
])
def test_banded_attention_matches_jax(t, context, block):
    rng = np.random.default_rng(t + block)
    q, k, v = (_randn(rng, 2, t, 3, 8) for _ in range(3))
    ref = jatt.banded_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), context,
                                block=block)
    got = tatt.banded_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                                context, block=block)
    assert maxdiff(got, ref) <= 1e-5


# -- modules -----------------------------------------------------------------


def test_projected_batch_forward_matches_jax(mimi_params):
    jm, tm = mimi_params
    tcfg = CFG.mimi.transformer
    x = _randn(np.random.default_rng(7), 1, tcfg.d_model, 120)
    jcos, jsin = jrope.rope_table(jnp.arange(120), tcfg.head_dim, tcfg.max_period)
    tcos, tsin = trope.rope_table(torch.arange(120), tcfg.head_dim, tcfg.max_period)
    ref = jtf.projected_batch_forward(jm["enc_tf"], tcfg, jnp.asarray(x), jcos, jsin, block=32)
    got = ttf.projected_batch_forward(tm["enc_tf"], PCFG.mimi.transformer,
                                      torch.from_numpy(x), tcos, tsin, block=32)
    assert maxdiff(got, ref) <= 1e-5


def test_seanet_encoder_batch_forward_matches_jax(mimi_params):
    jm, tm = mimi_params
    x = _randn(np.random.default_rng(8), 1, 1, 1920 * 3, scale=0.1)
    ref = jseanet.batch_forward(jmimi.MimiPlans(CFG.mimi).encoder, jm["encoder"], jnp.asarray(x))
    got = tseanet.batch_forward(tmimi.MimiPlans(PCFG.mimi).encoder, tm["encoder"],
                                torch.from_numpy(x))
    assert got.shape == (1, PCFG.mimi.seanet.dimension, 3 * 16)
    assert maxdiff(got, ref) <= 1e-5


def test_encode_to_latent_matches_jax(mimi_params):
    jm, tm = mimi_params
    x = _randn(np.random.default_rng(9), 1, 1, 1920 * 6 - 700, scale=0.1)  # ragged tail
    ref = jmimi.encode_to_latent(jm, jmimi.MimiPlans(CFG.mimi), jnp.asarray(x), block=16)
    got = tmimi.encode_to_latent(tm, tmimi.MimiPlans(PCFG.mimi), torch.from_numpy(x), block=16)
    assert got.shape == (1, PCFG.mimi.seanet.dimension, 6)
    assert maxdiff(got, ref) <= 2e-4


def test_encode_step_chain_matches_encode_to_latent(mimi_params):
    """7 frames in chunks of 2 (the last padded), carried conv state, KV tails
    and the downsample's ``first`` flag: the chain equals the batch encode."""
    _, tm = mimi_params
    plans = tmimi.MimiPlans(PCFG.mimi)
    x = torch.from_numpy(_randn(np.random.default_rng(10), 1, 1, 1920 * 7 - 50, scale=0.1))
    ref = tmimi.encode_to_latent(tm, plans, x, block=16)
    samples = 2 * 1920
    xp = torch.nn.functional.pad(x, (0, (-x.shape[-1]) % samples))
    st = tmimi.init_encode_state(plans, 1)
    lats = []
    for start in range(0, xp.shape[-1], samples):
        lat, st = tmimi.encode_step(tm, plans, st, xp[..., start:start + samples])
        lats.append(lat)
    got = torch.cat(lats, dim=-1)[..., :7]
    assert maxdiff(got, ref) <= 2e-4


@pytest.mark.parametrize("seconds", [1.5, 3.3])  # one-shot, chunked
def test_encode_voice_matches_jax(models, seconds):
    jax_model, port = models
    wav = _voice(11, seconds)
    jcond, jn = jax_model.engine.encode_voice(wav)
    cond, n = port.engine.encode_voice(wav)
    assert n == jn == -(-wav.size // 1920)
    assert cond.shape == (1, n, PCFG.flow_lm.transformer.d_model)
    assert maxdiff(cond, np.asarray(jcond)[:, :n]) <= 5e-4


# -- the slice ---------------------------------------------------------------


def test_voice_from_audio_generate_matches_jax(models):
    jax_model, port = models
    wav = _voice(12, 1.2)
    jvs, vs = jax_model.get_voice_state_from_audio(wav), port.get_voice_state_from_audio(wav)
    assert vs.length == jvs.length == 15 and int(vs.pos[0]) == 15
    ref = jax_model.generate("Testing voice state.", jvs)
    got = port.generate("Testing voice state.", vs)
    assert got.size > 0 and maxdiff(got, ref) <= 1e-4
    # the voice state is never written: a second run gives the same audio
    assert int(vs.pos[0]) == 15
    np.testing.assert_array_equal(port.generate("Testing voice state.", vs), got)


def test_voice_from_wav_path_matches_jax(models, tmp_path):
    """A 16 kHz stereo 16-bit WAV: the reader, the resampler and the downmix run."""
    jax_model, port = models
    rng = np.random.default_rng(13)
    pcm = (rng.standard_normal((16000, 2)) * 3000).astype("<i2")
    path = tmp_path / "voice.wav"
    with wave.open(str(path), "wb") as f:
        f.setnchannels(2)
        f.setsampwidth(2)
        f.setframerate(16000)
        f.writeframes(pcm.tobytes())
    jvs, vs = jax_model.get_voice_state(str(path)), port.get_voice_state(path)
    assert vs.length == jvs.length == 13
    ref = jax_model.generate("Hello, world!", jvs)
    got = port.generate("Hello, world!", vs)
    assert maxdiff(got, ref) <= 1e-4
    # WAV bytes are a source too
    np.testing.assert_array_equal(port.generate("Hello, world!",
                                                port.get_voice_state(path.read_bytes())), got)


@pytest.mark.parametrize("overflow", ["truncate", "compress"])
def test_overflow_matches_jax(exported, overflow):
    """Budget = 384 - (64 + 192) = 128 frames; the prompt has 168."""
    jax_model, port = _pair(exported, max_seq=384, voice_prompt_chunk_frames=32)
    wav = _voice(14, 168 * 1920 / SR)
    jvs = jax_model.get_voice_state_from_audio(wav, overflow=overflow)
    vs = port.get_voice_state_from_audio(wav, overflow=overflow)
    assert vs.length == jvs.length == 128
    assert maxdiff(vs.kc, np.asarray(jvs.kc)) <= 5e-4
    text = "Compressed voice speaks."
    assert maxdiff(port.generate(text, vs), jax_model.generate(text, jvs)) <= 1e-4


def test_overflow_policy_is_validated(models, monkeypatch):
    _, port = models
    wav = _voice(15, 0.5)
    with pytest.raises(ValueError, match="overflow"):
        port.get_voice_state_from_audio(wav, overflow="middle-out")
    monkeypatch.setenv("POCKET_TTS_VOICE_OVERFLOW", "sideways")
    with pytest.raises(ValueError, match="overflow"):
        port.get_voice_state_from_audio(wav)
    monkeypatch.setenv("POCKET_TTS_VOICE_OVERFLOW", "compress")
    assert port.get_voice_state_from_audio(wav).length == 7


def test_voice_prompt_files_interchange_with_jax(models, tmp_path):
    from safetensors.numpy import load_file

    jax_model, port = models
    wav = _voice(16, 1.3)
    jax_model.save_voice_prompt(wav, str(tmp_path / "jax.safetensors"))
    port.save_voice_prompt(wav, tmp_path / "port.safetensors")
    theirs = load_file(str(tmp_path / "port.safetensors"))["audio_prompt"]
    ours = load_file(str(tmp_path / "jax.safetensors"))["audio_prompt"]
    assert theirs.dtype == np.float32 and theirs.shape == ours.shape == (1, 17, 64)
    assert maxdiff(theirs, ours) <= 5e-4
    vs = port.get_voice_state(str(tmp_path / "jax.safetensors"))
    jvs = jax_model.get_voice_state(str(tmp_path / "jax.safetensors"))
    assert vs.length == jvs.length == 17
    assert maxdiff(port.generate("Hello, world!", vs),
                   jax_model.generate("Hello, world!", jvs)) <= 1e-4


def test_prompt_over_budget_keeps_most_recent_frames(models):
    """300 frames of conditioning against 256 of room: the last 256 are
    prefilled, in pieces of max(prompt_buckets) = 64 frames."""
    jax_model, port = models
    prompt = _randn(np.random.default_rng(21), 1, 300, 64)
    vs = port.get_voice_state_from_prompt(prompt)
    jvs = jax_model.get_voice_state_from_prompt(prompt)
    assert vs.length == jvs.length == 256
    assert maxdiff(vs.kc, np.asarray(jvs.kc)) <= 5e-4
    tail = port.get_voice_state_from_prompt(prompt[:, -256:])
    assert maxdiff(vs.kc, tail.kc.numpy()) == 0.0


def test_extend_voice_state_respects_cache_budget(models):
    """512 - (64 + 192) = 256 frames of room: a 250-frame prompt takes 6 more
    of a 13-frame extension, then no more; the base state is never written."""
    _, port = models
    rng = np.random.default_rng(17)
    vs = port.get_voice_state_from_prompt(_randn(rng, 1, 250, 64))
    assert vs.length == 250
    kc = vs.kc.clone()
    one_sec = _voice(18, 1.0)
    vs2 = port.extend_voice_state(vs, one_sec)
    assert vs2.length == 256 and int(vs2.pos[0]) == 256
    assert port.extend_voice_state(vs2, one_sec) is vs2
    assert int(vs.pos[0]) == 250 and torch.equal(vs.kc, kc)


def test_continuation_generate_matches_jax(models):
    jax_model, port = models
    assert len(port.split_into_best_sentences(TWO_SEGMENTS)) == 2
    ref = jax_model.generate(TWO_SEGMENTS, continuation_frames=4)
    got = port.generate(TWO_SEGMENTS, continuation_frames=4)
    assert maxdiff(got, ref) <= 1e-4
    # the tail changed the second segment
    plain = port.generate(TWO_SEGMENTS)
    assert got.shape != plain.shape or np.abs(got - plain).max() > 1e-6


def test_generate_with_pauses_matches_jax(models):
    jax_model, port = models
    vs = port.get_voice_state_from_audio(_voice(19, 0.8))
    jvs = jax_model.get_voice_state_from_audio(_voice(19, 0.8))
    text = "Hello there everyone today. [pause:500ms] Goodbye, friends."
    head = port.generate("Hello there everyone today.", vs)
    got = port.generate_with_pauses(text, vs, continuation_frames=4)
    ref = jax_model.generate_with_pauses(text, jvs, continuation_frames=4)
    assert maxdiff(got, ref) <= 1e-4
    np.testing.assert_array_equal(got[:head.size], head)
    assert np.all(got[head.size:head.size + SR // 2] == 0.0)


# -- host helpers ------------------------------------------------------------


def _riff(tag: int, n_ch: int, sr: int, bits: int, data: bytes, *,
          extensible: bool = False, claimed: int | None = None) -> bytes:
    block = n_ch * bits // 8
    fmt = struct.pack("<HHIIHH", 0xFFFE if extensible else tag, n_ch, sr, sr * block,
                      block, bits)
    if extensible:  # cbSize, valid bits, channel mask, SubFormat GUID
        fmt += struct.pack("<HHIH", 22, bits, 0, tag) + bytes(14)
    size = len(data) if claimed is None else claimed
    body = (b"WAVE" + b"fmt " + struct.pack("<I", len(fmt)) + fmt
            + b"LIST" + struct.pack("<I", 3) + b"abc\0"  # odd-sized chunk to skip
            + b"data" + struct.pack("<I", size) + data)
    return b"RIFF" + struct.pack("<I", len(body)) + body


def _wav_cases():
    rng = np.random.default_rng(20)
    x = rng.uniform(-0.9, 0.9, (50, 2))
    i24 = np.round(x * (1 << 23)).astype(np.int32).reshape(-1)
    b24 = np.stack([i24 & 255, (i24 >> 8) & 255, (i24 >> 16) & 255], -1).astype(np.uint8)
    pcm16 = np.round(x * 32767).astype("<i2").tobytes()
    return {
        "pcm16": _riff(1, 2, 16000, 16, pcm16),
        "pcm24": _riff(1, 2, 44100, 24, b24.tobytes()),
        "float32": _riff(3, 2, 22050, 32, x.astype("<f4").tobytes()),
        "extensible_float32": _riff(3, 2, 48000, 32, x.astype("<f4").tobytes(),
                                    extensible=True),
        "pcm16_truncated": _riff(1, 2, 16000, 16, pcm16[:-3], claimed=len(pcm16)),
    }


@pytest.mark.parametrize("case", list(_wav_cases()))
def test_read_wav_matches_jax(case):
    data = _wav_cases()[case]
    ref, ref_sr = jaudio.read_wav(data)
    got, sr = taudio.read_wav(data)
    assert sr == ref_sr and got.dtype == np.float32
    np.testing.assert_array_equal(got, ref)


def test_read_wav_rejects_bad_headers():
    with pytest.raises(ValueError, match="RIFF"):
        taudio.read_wav(b"RIFX" + bytes(40))
    with pytest.raises(ValueError, match="channel"):
        taudio.read_wav(_riff(1, 0, 16000, 16, bytes(8)))
    with pytest.raises(ValueError, match="sample rate"):
        taudio.read_wav(_riff(1, 1, 0, 16, bytes(8)))


def test_write_wav_round_trips_through_jax_reader(tmp_path):
    x = np.sin(np.arange(2400) / 7.0).astype(np.float32) * 0.5
    taudio.write_wav(tmp_path / "a.wav", x, SR)
    got, sr = jaudio.read_wav(str(tmp_path / "a.wav"))
    assert sr == SR and got.shape == (1, 2400)
    assert np.abs(got[0] - x).max() <= 1.0 / 16384
    jaudio.write_wav(str(tmp_path / "b.wav"), x, SR)
    assert (tmp_path / "a.wav").read_bytes() == (tmp_path / "b.wav").read_bytes()


@pytest.mark.parametrize("text", [
    "Hello there. [pause:500ms] Goodbye.",
    "Wait... what, really?",
    "It costs 1,000 dollars, or so.",
    "[pause:1.5s]Leading pause and trailing one [pause:0ms] [pause:20ms]",
    "No pauses here at all",
])
def test_segment_text_matches_jax(text):
    def flat(segs):
        return [(s.kind, s.text, s.duration_ms) for s in segs]

    assert flat(tpause.segment_text(text)) == flat(jpause.segment_text(text))
    assert tpause.silence_samples(500, SR) == jpause.silence_samples(500, SR) == 12000
