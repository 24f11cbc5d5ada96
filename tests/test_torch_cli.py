"""The port's voice resolution (``server/voices.py``), ``weights.resolve_uri``
and CLI (``generate``, ``batch``) on the small config of tests/test_tts.py,
after tests/test_voices.py and tests/test_server.py:293-443.  The CLI runs the
small model through ``monkeypatch.setattr(cli, "_load_model", ...)``.
"""

import base64
import dataclasses
import wave

import numpy as np
import pytest
import torch

from pocket_tts_tpu_torch import audio as audio_io
from pocket_tts_tpu_torch import cli
from pocket_tts_tpu_torch import weights as tweights
from pocket_tts_tpu_torch.config import config_from_dict
from pocket_tts_tpu_torch.runtime.engine import GenParams
from pocket_tts_tpu_torch.server import voices
from pocket_tts_tpu_torch.tts import TTSModel
from tests.test_tts import CFG

torch.set_num_threads(1)
PCFG = config_from_dict(dataclasses.asdict(CFG))


@pytest.fixture(scope="module")
def model():
    params = tweights.from_state_dict(tweights.random_state_dict(PCFG, 3), PCFG)
    return TTSModel(PCFG, params, gen=GenParams(temp=0.0), has_real_weights=False, device="cpu")


@pytest.fixture
def cli_model(model, monkeypatch):
    monkeypatch.setattr(cli, "_load_model", lambda args: model)
    return model


def _wav_bytes(tmp_path, seed, samples=24000):
    wav = np.random.default_rng(seed).normal(size=samples).astype(np.float32) * 0.1
    path = tmp_path / f"v{seed}.wav"
    audio_io.write_wav(path, wav, 24000)
    return path.read_bytes(), path


def _frames(path) -> int:
    with wave.open(str(path), "rb") as f:
        assert f.getframerate() == 24000 and f.getnchannels() == 1
        return f.getnframes()


# -- voice resolution ---------------------------------------------------------


def test_cache_keys(tmp_path):
    assert voices.voice_cache_key("alba") == "stock:alba"
    assert voices.voice_cache_key("hf://a/b/c.safetensors").startswith("hf:")
    assert voices.voice_cache_key("https://x.test/v.wav").startswith("url:")
    assert voices.voice_cache_key("AAAA").startswith("b64:")
    p = tmp_path / "v.wav"
    p.write_bytes(b"RIFF0000WAVE")
    k1 = voices.voice_cache_key(str(p))
    p.write_bytes(b"RIFF00000000WAVE")
    assert k1 != voices.voice_cache_key(str(p))  # a size change invalidates


def test_lru_eviction_order():
    cache = voices.VoiceStateCache(capacity=2)
    cache.put("a", "A")
    cache.put("b", "B")
    cache.get("a")
    cache.put("c", "C")  # evicts b
    assert cache.get("b") is None and cache.get("a") == "A" and cache.get("c") == "C"


def test_resolve_wav_file_base64_and_data_url(model, tmp_path):
    raw, path = _wav_bytes(tmp_path, 0)
    direct = model.get_voice_state_from_wav(path)
    for spec in (str(path), base64.b64encode(raw).decode(),
                 "data:audio/wav;base64," + base64.b64encode(raw).decode()):
        vs = voices.resolve_voice(model, spec)
        assert vs.length == direct.length == 13
        assert torch.equal(vs.kc, direct.kc)


def test_resolve_prompt_safetensors(model, tmp_path):
    d = PCFG.flow_lm.transformer.d_model
    prompt = np.random.default_rng(2).normal(size=(1, 5, d)).astype(np.float32)
    path = tmp_path / "stock.safetensors"
    tweights.write_safetensors({"audio_prompt": prompt}, path)
    assert voices.resolve_voice(model, str(path)).length == 5


def test_unresolvable_spec_raises(model):
    with pytest.raises(voices.VoiceResolutionError):
        voices.resolve_voice(model, "no_such_voice_xyz")
    assert issubclass(voices.VoiceResolutionError, ValueError)


def test_cached_resolution_reuses(model, tmp_path):
    _, path = _wav_bytes(tmp_path, 4)
    cache = voices.VoiceStateCache(4)
    v1 = voices.resolve_voice_cached(model, str(path), cache)
    assert voices.resolve_voice_cached(model, str(path), cache) is v1
    assert len(cache) == 1


def test_remote_url_offline_is_clean_error(model, monkeypatch):
    monkeypatch.delenv("POCKET_TTS_ONLINE", raising=False)
    with pytest.raises(ValueError, match="POCKET_TTS_ONLINE"):
        voices.resolve_voice(model, "https://example.com/v.wav")


def test_loopback_url_gated(model, monkeypatch):
    monkeypatch.delenv("POCKET_TTS_LOOPBACK_VOICES", raising=False)
    monkeypatch.setenv("POCKET_TTS_ONLINE", "1")  # the online gate is not enough
    with pytest.raises(ValueError, match="LOOPBACK"):
        voices.resolve_voice(model, "http://127.0.0.1:9091/admin")


def test_resolve_uri_reads_the_hf_cache(tmp_path, monkeypatch):
    """``hf://owner/repo/file@rev`` against a fake cache tree: a commit
    revision, a branch through refs/, no revision (main), and a clean
    FileNotFoundError for a file that is not cached."""
    monkeypatch.setenv("HF_HUB_CACHE", str(tmp_path))
    commit = "d4fdd22ae8c8e1cb3634e150ebeff1dab2d16df3"
    repo = tmp_path / "models--kyutai--pocket-tts-without-voice-cloning"
    f = repo / "snapshots" / commit / "embeddings" / "alba.safetensors"
    f.parent.mkdir(parents=True)
    f.write_bytes(b"x")
    (repo / "refs").mkdir()
    (repo / "refs" / "main").write_text(commit + "\n")
    base = "hf://kyutai/pocket-tts-without-voice-cloning/embeddings/alba.safetensors"
    assert tweights.resolve_uri(f"{base}@{commit}") == f
    assert tweights.resolve_uri(f"{base}@main") == f
    assert tweights.resolve_uri(base) == f
    assert tweights.resolve_uri(voices.stock_voice_uri("alba")) == f
    with pytest.raises(FileNotFoundError, match="not in the local Hugging Face cache"):
        tweights.resolve_uri(voices.stock_voice_uri("marius"))
    with pytest.raises(ValueError, match="Bad hf"):
        tweights.resolve_uri("hf://no-file")
    assert tweights.resolve_uri("local/x.wav").name == "x.wav"


def test_stock_voice_resolves_through_the_cache(model, tmp_path, monkeypatch):
    monkeypatch.setenv("HF_HUB_CACHE", str(tmp_path / "empty"))
    with pytest.raises(FileNotFoundError):
        voices.resolve_voice(model, "alba")
    monkeypatch.setenv("HF_HUB_CACHE", str(tmp_path))
    d = PCFG.flow_lm.transformer.d_model
    f = (tmp_path / "models--kyutai--pocket-tts-without-voice-cloning" / "snapshots"
         / voices._STOCK_REV / "embeddings" / "alba.safetensors")
    f.parent.mkdir(parents=True)
    tweights.write_safetensors({"audio_prompt": np.ones((1, 3, d), np.float32) * 0.01}, f)
    assert voices.resolve_voice(model, "alba").length == 3


def test_voice_prompt_chunk_frames_reaches_the_chunked_encoder(monkeypatch):
    """``load_with_params(voice_prompt_chunk_frames=N)`` sets the chunk size
    ``Engine._encode_chunked`` streams a long prompt in."""
    from pocket_tts_tpu_torch import tts
    from pocket_tts_tpu_torch.models import mimi

    cfg = dataclasses.replace(PCFG, runtime=dataclasses.replace(
        PCFG.runtime, encode_seconds_buckets=(1.0,)))
    monkeypatch.setattr(tts, "load_variant", lambda variant: cfg)
    model = TTSModel.load_with_params(voice_prompt_chunk_frames=5, temp=0.0, device="cpu")
    assert model.engine._rcfg.voice_prompt_chunk_frames == 5
    sizes = []
    real_step = mimi.encode_step

    def spy(params, plans, state, audio):
        sizes.append(audio.shape[-1])
        return real_step(params, plans, state, audio)

    monkeypatch.setattr(mimi, "encode_step", spy)
    wav = np.random.default_rng(0).standard_normal(int(1.5 * 24000)).astype(np.float32) * 0.1
    cond, n = model.engine.encode_voice(wav)
    assert n == 19 and cond.shape[1] == 19
    assert sizes == [5 * 1920] * 3 + [4 * 1920]


# -- CLI ------------------------------------------------------------------------


def test_generate_to_wav(cli_model, tmp_path, capsys):
    out = tmp_path / "out.wav"
    assert cli.main(["generate", "--text", "CLI generation test.", "--output", str(out),
                     "--quiet"]) == 0
    want = cli_model.generate_with_pauses("CLI generation test.")
    assert _frames(out) == want.size > 0
    assert "device: cpu" in capsys.readouterr().err


def test_generate_stream_to_stdout(cli_model, capfdbinary):
    assert cli.main(["generate", "--text", "Stream to stdout.", "--stream"]) == 0
    data = capfdbinary.readouterr().out
    want = np.concatenate(list(cli_model.generate_stream_long("Stream to stdout.")))
    assert len(data) == 2 * want.size
    np.testing.assert_array_equal(np.frombuffer(data, "<i2"),
                                  np.frombuffer(audio_io.pcm_i16_le_bytes(want), "<i2"))


def test_generate_with_continuation_and_unresolvable_voice(cli_model, tmp_path, capsys):
    out = tmp_path / "c.wav"
    text = "First sentence here. And a second sentence follows it."
    assert cli.main(["generate", "--text", text, "-o", str(out), "--quiet",
                     "--continuation", "4", "--voice", "no_such_voice_xyz"]) == 0
    assert "unresolvable" in capsys.readouterr().err
    assert _frames(out) == cli_model.generate_with_pauses(text, continuation_frames=4).size


def test_batch_manifest(cli_model, tmp_path):
    """A mixed plain/JSONL manifest: one WAV per line, JSONL ``output`` names
    and voices honored, a blank-text item fails alone (exit 1)."""
    _, voice = _wav_bytes(tmp_path, 9)
    manifest = tmp_path / "lines.txt"
    manifest.write_text(
        "A plain manifest line.\n"
        "# a comment, skipped\n"
        f'{{"text": "A JSONL line.", "output": "named.wav", "voice": "{voice}"}}\n'
        '{"text": "   "}\n'
        '{"text": "Nested output line.", "output": "sub/dir/x.wav"}\n', encoding="utf-8")
    out_dir = tmp_path / "out"
    rc = cli.main(["batch", "--manifest", str(manifest), "--out-dir", str(out_dir),
                   "--batch-size", "2", "--chunk-frames", "4", "--quiet"])
    assert rc == 1  # the blank-text item failed
    m = cli_model
    assert _frames(out_dir / "00000.wav") == m.generate_with_pauses("A plain manifest line.").size
    assert _frames(out_dir / "named.wav") == m.generate_with_pauses(
        "A JSONL line.", m.get_voice_state(voice)).size
    assert _frames(out_dir / "sub/dir/x.wav") == m.generate_with_pauses("Nested output line.").size
    assert not (out_dir / "00002.wav").exists()


@pytest.mark.parametrize("line", [
    '{"voice": "no text key"}',
    '{"text": "x", "output": 5}',
    '{"text": "x", "output": "../esc.wav"}',
    '{"text": "x", "output": "/tmp/abs.wav"}',
    '{"text": "x", "adapter": "spk"}',
    '{"text": "x", "voice": "no-such-voice.wav"}',
    '{"text": "x", "output": "same.wav"}\n{"text": "y", "output": "same.wav"}',
    "# only a comment",
])
def test_batch_refuses_bad_manifests(cli_model, tmp_path, line):
    bad = tmp_path / "bad.txt"
    bad.write_text(line + "\n", encoding="utf-8")
    assert cli.main(["batch", "--manifest", str(bad), "--out-dir", str(tmp_path / "o")]) == 2
    assert not list((tmp_path / "o").glob("*.wav"))


def test_batch_frames_after_eos_reaches_the_batcher(cli_model, tmp_path):
    manifest = tmp_path / "m.txt"
    manifest.write_text("Frames after EOS line.\n", encoding="utf-8")
    lengths = []
    for fae in (None, "40"):
        out = tmp_path / f"o{fae}"
        extra = [] if fae is None else ["--frames-after-eos", fae]
        assert cli.main(["batch", "--manifest", str(manifest), "--out-dir", str(out),
                         "--quiet", *extra]) == 0
        lengths.append(_frames(out / "00000.wav"))
    assert lengths[1] > lengths[0]


def test_batch_write_failure_is_per_item(cli_model, tmp_path, monkeypatch):
    manifest = tmp_path / "m.txt"
    manifest.write_text("First utterance.\nSecond utterance.\n", encoding="utf-8")
    out_dir = tmp_path / "out"
    real_write = audio_io.write_wav

    def flaky_write(path, *a, **kw):
        if path.name == "00000.wav":
            raise OSError(28, "No space left on device")
        return real_write(path, *a, **kw)

    monkeypatch.setattr(audio_io, "write_wav", flaky_write)
    assert cli.main(["batch", "--manifest", str(manifest), "--out-dir", str(out_dir),
                     "--quiet"]) == 1
    assert not (out_dir / "00000.wav").exists()
    assert _frames(out_dir / "00001.wav") > 0


def test_device_flag_defaults_to_the_visible_card(monkeypatch):
    """``--device`` defaults to cuda whether or not a card is visible here;
    ``--device cpu`` is passed through."""
    seen = {}

    def fake_load(variant, **kw):
        seen.update(kw)
        raise SystemExit(0)

    monkeypatch.setattr(TTSModel, "load_with_params", staticmethod(fake_load))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    args = cli.build_parser().parse_args(["generate", "--text", "x"])
    assert args.device == "cuda"
    with pytest.raises(SystemExit):
        cli._load_model(args)
    assert seen["device"] == "cuda"
    args = cli.build_parser().parse_args(["batch", "--manifest", "m", "--device", "cpu"])
    assert args.batch_size == 16 and args.chunk_frames == 64
    with pytest.raises(SystemExit):
        cli._load_model(args)
    assert seen["device"] == "cpu"


@pytest.mark.parametrize("command", [["generate", "--text", "x"], ["batch", "--manifest", "m"]])
def test_cli_without_a_card_raises_unless_cpu_is_asked(monkeypatch, command):
    """No silent CPU run: the cuda default with no card visible raises and
    names ``--device cpu``; the model is never loaded."""
    def no_load(variant, **kw):
        raise AssertionError("the model must not load")

    monkeypatch.setattr(TTSModel, "load_with_params", staticmethod(no_load))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        cli._load_model(cli.build_parser().parse_args(command))


def test_load_defaults_to_cuda_and_raises_without_a_card(monkeypatch):
    """``TTSModel.load()`` asks for cuda; with no card visible it raises and
    names ``device="cpu"`` before any weights load."""
    import inspect

    assert inspect.signature(TTSModel.load_with_params).parameters["device"].default == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(tweights, "load_params",
                        lambda *a, **kw: pytest.fail("weights loaded without a device"))
    for call in (lambda: TTSModel.load(), lambda: TTSModel.load_with_params(device="cuda:0")):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            call()


# -- narrow storage: quantize and --quantized ----------------------------------


@pytest.fixture
def small_variant(monkeypatch):
    """``load_variant`` -> the small config, so the real loaders (random
    weights from seed 0) run at test size."""
    from pocket_tts_tpu_torch import tts

    monkeypatch.setattr(tts, "load_variant", lambda variant: PCFG)
    monkeypatch.delenv("POCKET_TTS_WEIGHTS", raising=False)
    return PCFG


@pytest.mark.parametrize("bits", ["8", "4"])
def test_quantize_writes_an_artifact_jax_reads(small_variant, tmp_path, capsys, bits):
    """``quantize -o`` on the CPU writes the JAX package's artifact format:
    its ``load_quantized`` reads back exactly what its own ``quantize_params``
    makes from the same weights."""
    import jax.numpy as jnp

    from pocket_tts_tpu import weights as jweights
    from pocket_tts_tpu.models.mimi import MimiPlans
    from pocket_tts_tpu.ops.qtensor import QTensor
    from pocket_tts_tpu.runtime import quantize as jquant

    out = tmp_path / f"m.int{bits}.safetensors"
    assert cli.main(["quantize", "-o", str(out), "--bits", bits, "--device", "cpu"]) == 0
    err = capsys.readouterr().err
    assert "device: cpu" in err and f"int{bits} tensors, SNR dB min" in err
    sd = tweights.random_state_dict(PCFG, 0)
    want = jquant.quantize_params(
        jweights.convert_tts_state_dict(sd, CFG, MimiPlans(CFG.mimi)), int(bits))
    got = dict(jquant._flatten_paths(jquant.load_quantized(out)))
    want = dict(jquant._flatten_paths(want))
    assert sorted(got) == sorted(want)
    assert sum(isinstance(v, QTensor) for v in got.values()) > 5
    for path, w in want.items():
        g = got[path]
        if isinstance(w, QTensor):
            np.testing.assert_array_equal(np.asarray(g.q), np.asarray(w.q), err_msg=path)
            np.testing.assert_array_equal(np.asarray(g.scale), np.asarray(w.scale), err_msg=path)
        else:
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w, jnp.float32), err_msg=path)


def test_generate_quantized_on_cpu(small_variant, tmp_path, capsys):
    """``generate --quantized --device cpu`` runs the int8 clone: the WAV
    equals ``quantize_model(model).generate_with_pauses`` to the int16 LSB."""
    from pocket_tts_tpu_torch.runtime.quantize import quantize_model

    out = tmp_path / "q.wav"
    text = "Quantized command line."
    assert cli.main(["generate", "--text", text, "-o", str(out), "--quiet", "--quantized",
                     "--temperature", "0", "--device", "cpu"]) == 0
    assert "device: cpu" in capsys.readouterr().err
    qmodel = quantize_model(TTSModel.load_with_params(temp=0.0, device="cpu"))
    want = qmodel.generate_with_pauses(text)
    got, sr = audio_io.read_wav(out)
    assert sr == 24000 and got.size == want.size > 0
    assert np.abs(got.reshape(-1) - want).max() <= 1.5 / 32767


def test_quantized_flag_reaches_the_loader(monkeypatch):
    args = cli.build_parser().parse_args(["batch", "--manifest", "m", "--quantized"])
    assert args.quantized
    assert not cli.build_parser().parse_args(["generate", "--text", "x"]).quantized
    args = cli.build_parser().parse_args(["quantize"])
    assert (args.output, args.bits, args.device) == ("model.int8.safetensors", 8, "cuda")


# -- fine-tuning: finetune, --finetuned and batch --adapter ------------------------


def _training_manifest(model, tmp_path):
    rng = np.random.default_rng(0)
    for name in ("a.wav", "b.wav"):
        audio_io.write_wav(tmp_path / name,
                           (rng.normal(size=model.sample_rate // 2) * 0.1).astype(np.float32),
                           model.sample_rate)
    manifest = tmp_path / "pairs.jsonl"
    manifest.write_text('{"text": "first pair", "audio": "a.wav"}\n'
                        "# comment\n"
                        '{"text": "second pair", "audio": "b.wav"}\n', encoding="utf-8")
    return manifest


def test_finetune_command_and_finetuned_flag(model, tmp_path, monkeypatch, capsys):
    """``finetune`` trains on a JSONL manifest of (text, audio) pairs and
    writes the artifact and a sample; ``generate --finetuned`` loads either
    kind through the real ``_load_model`` (``load_with_params`` patched to the
    small model), which applies it before ``--quantized``; the JAX package
    reads both artifacts."""
    from pocket_tts_tpu.training import load_finetuned_params, load_lora_params
    from pocket_tts_tpu_torch.training import apply_adapted

    manifest = _training_manifest(model, tmp_path)
    monkeypatch.setattr(TTSModel, "load_with_params", classmethod(lambda cls, *a, **k: model))
    art = tmp_path / "tuned.safetensors"
    assert cli.main(["finetune", "--manifest", str(manifest), "--output", str(art),
                     "--steps", "2", "--batch-size", "2", "--log-every", "0",
                     "--sample-text", "tuned sample", "--device", "cpu"]) == 0
    assert "full FlowLM checkpoint" in capsys.readouterr().err
    assert _frames(tmp_path / "tuned.sample.wav") > 0
    assert sorted(load_finetuned_params(art)) == sorted(model.params["flow_lm"])

    out = tmp_path / "gen.wav"
    text = "With tuned weights."
    assert cli.main(["generate", "--text", text, "--finetuned", str(art), "--output", str(out),
                     "--quiet", "--temperature", "0", "--device", "cpu"]) == 0
    assert _frames(out) == apply_adapted(model, art).generate_with_pauses(text).size

    lart = tmp_path / "tuned.lora.safetensors"
    assert cli.main(["finetune", "--manifest", str(manifest), "--output", str(lart),
                     "--steps", "2", "--batch-size", "2", "--log-every", "0",
                     "--lora-rank", "2", "--device", "cpu"]) == 0
    assert "rank-2 LoRA adapter" in capsys.readouterr().err
    assert lart.stat().st_size < art.stat().st_size / 2
    assert load_lora_params(lart)[1:] == (2, 2.0)
    assert cli.main(["generate", "--text", "With a LoRA adapter.", "--finetuned", str(lart),
                     "--output", str(out), "--quiet", "--quantized", "--device", "cpu"]) == 0

    bad = tmp_path / "bad.jsonl"
    bad.write_text('{"text": "no audio key"}\n', encoding="utf-8")
    assert cli.main(["finetune", "--manifest", str(bad), "--device", "cpu"]) == 2
    bad.write_text('{"text": "x", "audio": "missing.wav"}\n', encoding="utf-8")
    assert cli.main(["finetune", "--manifest", str(bad), "--device", "cpu"]) == 2


def test_finetune_parser_has_every_option():
    args = cli.build_parser().parse_args(["finetune", "--manifest", "m"])
    assert (args.output, args.steps, args.batch_size, args.lr, args.weight_decay,
            args.clip_norm, args.warmup_steps, args.eos_weight, args.lora_rank,
            args.lora_alpha, args.max_tokens, args.voice_wav, args.log_every,
            args.sample_text, args.finetuned, args.device) == (
        "model.finetuned.safetensors", 200, 8, 1e-4, 0.01, 1.0, 10, 1.0, 0, None, None,
        None, 25, None, None, "cuda")


def test_batch_manifest_adapters(cli_model, tmp_path):
    """Manifest lines select registered LoRA adapters and ride one decode
    loop, each as its merged single stream; an unregistered name, a malformed
    --adapter and a full checkpoint (not bankable) exit 2 before synthesis."""
    from pocket_tts_tpu_torch.training import (
        apply_adapted, finetune, save_finetuned_params, save_lora_params)

    rng = np.random.default_rng(9)
    tuned = finetune(cli_model, [("batch adapter voice",
                                  rng.normal(size=(2 * 1920,)).astype(np.float32) * 0.1)],
                     steps=2, batch_size=1, lr=5e-2, log_every=0, lora_rank=2)
    factors, rank, alpha = tuned._lora
    apath = tmp_path / "spk.lora.safetensors"
    save_lora_params(factors, apath, rank=rank, alpha=alpha)
    manifest = tmp_path / "m.txt"
    manifest.write_text('{"text": "Tuned item.", "adapter": "spk", "output": "a.wav"}\n'
                        '{"text": "Base item.", "output": "b.wav"}\n', encoding="utf-8")
    out_dir = tmp_path / "out"
    assert cli.main(["batch", "--manifest", str(manifest), "--out-dir", str(out_dir),
                     "--batch-size", "2", "--chunk-frames", "4", "--adapter", f"spk={apath}",
                     "--quiet"]) == 0
    want = apply_adapted(cli_model, apath).generate_with_pauses("Tuned item.")
    got, _ = audio_io.read_wav(out_dir / "a.wav")
    assert got.size == want.size and np.abs(got.reshape(-1) - want).max() <= 1.5e-4
    assert _frames(out_dir / "b.wav") == cli_model.generate_with_pauses("Base item.").size

    bad = tmp_path / "bad.txt"
    bad.write_text('{"text": "x", "adapter": "nope"}\n', encoding="utf-8")
    assert cli.main(["batch", "--manifest", str(bad), "--out-dir", str(out_dir)]) == 2
    assert cli.main(["batch", "--manifest", str(manifest), "--out-dir", str(out_dir),
                     "--adapter", "justaname"]) == 2
    fpath = tmp_path / "full.safetensors"
    save_finetuned_params(tuned.params["flow_lm"], fpath)
    assert cli.main(["batch", "--manifest", str(manifest), "--out-dir", str(tmp_path / "o2"),
                     "--adapter", f"spk={fpath}"]) == 2
