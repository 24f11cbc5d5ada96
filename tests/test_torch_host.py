"""Host side of the port: tokenizer, config, safetensors reader and loader,
and the rule that the port runs without JAX (and without tokenizers, yaml and
safetensors), as on a machine that has only PyTorch."""

import ast
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from pocket_tts_tpu import config as jconfig
from pocket_tts_tpu import text as jtext
from pocket_tts_tpu import weights as jweights
from pocket_tts_tpu.models.mimi import MimiPlans
from pocket_tts_tpu_torch import config as tconfig
from pocket_tts_tpu_torch import text as ttext
from pocket_tts_tpu_torch import weights as tweights
from tests.test_tts import CFG

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parent.parent
PCFG = tconfig.config_from_dict(dataclasses.asdict(CFG))

STRINGS = [
    "Hello, world!", "Hello there everyone today.", "hi", "ok", "What?",
    "The year 1984 had 365 days; pi is 3.14159.", "Call 555-0123 at 10:30 a.m.",
    "Café, naïve, résumé, über, señor.", "Ωμέγα and Ελληνικά", "Emoji 🎉 party 🙂🙂",
    "中文 text and 日本語", "Quotes «like» these — and ‘these’.", "Tabs\tand\nnewlines",
    "  leading and trailing spaces  ", "multiple   inner    spaces", "<s>literal</s> <pad>",
    "ALL CAPS SHOUTING!!!", "a" * 80, "x🎉y", ".!...?", "ﬁ ligature ǅ", "$100 & 50% off #1",
    "Don't, won't, can't; it's.", "e-mail: someone@example.com",
    "This is the first sentence. And here is the second one!",
    " ".join(["word"] * 60),
]


@pytest.fixture(scope="module")
def tokenizers_pair():
    return jtext.load_tokenizer(None), ttext.load_tokenizer(None)


def test_tokenizer_ids_equal_hf_tokenizers(tokenizers_pair):
    hf, ours = tokenizers_pair
    texts = STRINGS + [jtext.prepare_text_prompt(s)[0] for s in STRINGS if s.strip()]
    for s in texts:
        ids = hf.encode(s)
        assert ours.encode(s) == ids, s
        assert ours.decode(ids) == hf.decode(ids), s
    assert ours.vocab_size == hf.vocab_size


def test_sentence_split_equals_jax(tokenizers_pair):
    hf, ours = tokenizers_pair
    long = " ".join(["word"] * 70) + ". Short one. " + "Another sentence here! " * 8
    for text in ("Hello, world!", long, STRINGS[-2]):
        assert ttext.split_into_best_sentences(ours, text) == \
            jtext.split_into_best_sentences(hf, text)
        assert ttext.prepare_text_prompt(text) == jtext.prepare_text_prompt(text)
        assert ttext.max_generation_frames(text) == jtext.max_generation_frames(text)
        for a, b in zip(ttext.tokens_array(ours, text, 256), jtext.tokens_array(hf, text, 256)):
            np.testing.assert_array_equal(a, b)


def test_load_variant_equals_jax_field_for_field():
    assert dataclasses.asdict(tconfig.load_variant()) == \
        dataclasses.asdict(jconfig.load_variant())
    assert tconfig.load_variant() == tconfig.load_variant("b6369a24")
    with pytest.raises(FileNotFoundError):
        tconfig.load_variant("nope")
    with pytest.raises(ValueError):
        tconfig.RuntimeConfig(compute_dtype="fp16")


def test_safetensors_reader_equals_safetensors(tmp_path):
    from safetensors.numpy import load_file
    from safetensors.torch import save_file

    sd = tweights.random_state_dict(PCFG, seed=1)
    params = jweights.convert_tts_state_dict(sd, CFG, MimiPlans(CFG.mimi))
    path = tmp_path / "tts_small.safetensors"
    jweights.save_checkpoint(params, MimiPlans(CFG.mimi), path)
    ref, got = load_file(str(path)), tweights.read_safetensors(path)
    assert sorted(got) == sorted(ref)
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k])
    narrow = {"h": torch.randn(3, 5).half(), "b": torch.randn(7).bfloat16()}
    save_file(narrow, str(tmp_path / "narrow.safetensors"))
    got = tweights.read_safetensors(tmp_path / "narrow.safetensors")
    for k, v in narrow.items():
        np.testing.assert_array_equal(got[k], v.float().numpy())


def test_load_params_env_file_and_random_fallback(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("POCKET_TTS_WEIGHTS", raising=False)
    _, real = tweights.load_params(PCFG, seed=0)
    assert real is False
    with pytest.raises(FileNotFoundError):
        tweights.load_params(PCFG, allow_random=False)
    sd = tweights.random_state_dict(PCFG, seed=2)
    path = tmp_path / "ckpt.safetensors"
    jweights.save_checkpoint(jweights.convert_tts_state_dict(sd, CFG, MimiPlans(CFG.mimi)),
                             MimiPlans(CFG.mimi), path)
    monkeypatch.setenv("POCKET_TTS_WEIGHTS", str(path))
    params, real = tweights.load_params(PCFG)
    assert real is True
    np.testing.assert_array_equal(params["flow_lm"]["bos_emb"].numpy(), sd["flow_lm.bos_emb"])
    monkeypatch.setenv("POCKET_TTS_WEIGHTS", str(tmp_path / "missing.safetensors"))
    with pytest.raises(FileNotFoundError):
        tweights.load_params(PCFG)


def test_split_checkpoint_files_merge_like_jax(tmp_path):
    from safetensors.numpy import save_file

    sd = tweights.random_state_dict(PCFG, seed=3)
    renames = {"conditioner.embed.weight":
               "condition_provider.conditioners.transcript_in_segment.embed.weight",
               "speaker_proj_weight":
               "condition_provider.conditioners.speaker_wavs.output_proj.weight"}
    flow = {renames.get(k[8:], k[8:]): v for k, v in sd.items() if k.startswith("flow_lm.")}
    codec = {"model." + k[5:]: v for k, v in sd.items() if k.startswith("mimi.")}
    paths = [tmp_path / "flow_lm.safetensors", tmp_path / "mimi.safetensors"]
    save_file(flow, str(paths[0]))
    save_file(codec, str(paths[1]))
    spec = os.pathsep.join(map(str, paths))
    got, ref = tweights.load_state_dict_any(spec), jweights.load_state_dict_any(spec)
    assert sorted(got) == sorted(ref) == sorted(sd)
    for k in sd:
        np.testing.assert_array_equal(got[k], sd[k])


def test_port_sources_import_no_jax():
    for path in (ROOT / "pocket_tts_tpu_torch").rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for name in names:
                top = name.split(".")[0]
                assert top not in ("jax", "jaxlib", "pocket_tts_tpu"), f"{path}: {name}"


_NO_JAX = r"""
import dataclasses, json, sys
BLOCKED = ("jax", "jaxlib", "tokenizers", "yaml", "safetensors")


class Block:  # an import finder, not sys.modules[m] = None: scipy probes sys.modules
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"{name} is blocked")


sys.meta_path.insert(0, Block())
import numpy as np
import torch
torch.set_num_threads(1)
import pocket_tts_tpu_torch
from pocket_tts_tpu_torch import config, weights
from pocket_tts_tpu_torch.runtime.engine import GenParams
cfg = config.config_from_dict(json.loads(sys.argv[1]))
model = pocket_tts_tpu_torch.TTSModel(
    cfg, weights.from_state_dict(weights.random_state_dict(cfg, 0), cfg),
    gen=GenParams(temp=0.5), has_real_weights=False, device="cpu")
wav = model.generate("Hi there.")
assert wav.size and wav.size % 1920 == 0 and np.isfinite(wav).all()
import os, tempfile
from pocket_tts_tpu_torch import audio
with tempfile.TemporaryDirectory() as tmp:
    path = os.path.join(tmp, "voice.wav")
    audio.write_wav(path, np.random.default_rng(0).standard_normal(16000) * 0.1, 16000)
    vs = model.get_voice_state(path)
    model.save_voice_prompt(audio.convert_audio(*audio.read_wav(path), 24000)[0],
                            os.path.join(tmp, "voice.safetensors"))
    assert model.get_voice_state(os.path.join(tmp, "voice.safetensors")).length == vs.length
voiced = model.generate("Hi there.", vs)
assert vs.length == 13 and voiced.size and np.isfinite(voiced).all()
from pocket_tts_tpu_torch import cli, native, training
from pocket_tts_tpu_torch.kernels import decode_attention, flow_blocks, qlinear
from pocket_tts_tpu_torch.server import app, fleet
from pocket_tts_tpu_torch.training import data, loss, lora, trainer
tuned = training.finetune(model, [("Hi there.", np.zeros(3000, np.float32))], steps=1,
                          log_every=0, lora_rank=2)
with tempfile.TemporaryDirectory() as tmp:
    path = os.path.join(tmp, "a.lora.safetensors")
    training.save_lora_params(tuned._lora[0], path, rank=2, alpha=2.0)
    assert training.apply_adapted(model, path).generate("Hi.").size
assert audio.wav_bytes(voiced, 24000) == audio.wav_header(24000, voiced.size) + \
    audio.pcm_i16_le_bytes(voiced)
from pocket_tts_tpu_torch import utils
from pocket_tts_tpu_torch.tts import _SegmentRun
with tempfile.TemporaryDirectory() as tmp:
    os.makedirs(os.path.join(tmp, "config"))
    with open(os.path.join(tmp, "config", "tiny.yaml"), "w") as f:
        f.write(sys.argv[2])
    here = os.getcwd()
    os.chdir(tmp)
    try:
        vcfg = config.load_variant("tiny")
    finally:
        os.chdir(here)
assert vcfg == dataclasses.replace(cfg, runtime=dataclasses.replace(
    cfg.runtime, segment_buckets=(64, 200))), vcfg
fused = pocket_tts_tpu_torch.TTSModel(
    vcfg, weights.from_state_dict(weights.random_state_dict(vcfg, 0), vcfg),
    gen=GenParams(temp=0.5), has_real_weights=False, device="cpu")
assert _SegmentRun(fused, "Hi there.", fused.get_voice_state(), None,
                   low_latency=False).fused_bucket == 64
with utils.display_execution_time("fused generate", print_output=False) as t:
    wav = fused.generate("Hi there.")
assert wav.size % 1920 == 0 and np.isfinite(wav).all() and t.elapsed_ms > 0
from pocket_tts_tpu_torch.parallel.mesh import make_mesh
from pocket_tts_tpu_torch.runtime.engine import Engine
mesh_eng = Engine(cfg, model.params, batch_size=2, mesh=make_mesh(2, devices=["cpu"] * 2))
st = mesh_eng.prefill_tokens(mesh_eng.new_state(), np.ones((2, 3), np.int32), 3)
_, pcm, _ = mesh_eng.decode_frames(st, 2, GenParams(temp=0.5), torch.Generator())
assert mesh_eng.mesh.shape == {"dp": 1, "tp": 2} and pcm.shape == (2, 2 * 1920)
from pocket_tts_tpu_torch.training import shard_batch
placed = shard_batch({"latent_valid": np.array([3, 5], np.int32)},
                     make_mesh(2, tp=1, devices=["cpu"] * 2))
assert [int(placed["latent_valid"].group(g)[0]) for g in range(2)] == [3, 5]
loaded = sorted(m for m, mod in sys.modules.items()
                if mod is not None and m.split(".")[0] in ("jax", "pocket_tts_tpu"))
assert not loaded, loaded
print("OK", wav.size)
"""


def _yaml_lines(tree: dict, indent: int = 0) -> list[str]:
    """A nested dict of scalars and lists as block-mapping YAML with flow
    sequences (the subset the port's reader takes)."""
    lines = []
    for key, value in tree.items():
        pad = " " * indent
        if isinstance(value, dict):
            lines += [f"{pad}{key}:  # a mapping", *_yaml_lines(value, indent + 2)]
        elif isinstance(value, (list, tuple)):
            lines.append(f"{pad}{key}: [{', '.join(json.dumps(v) for v in value)}]")
        else:
            lines.append(f"{pad}{key}: {json.dumps(value)}")
    return lines


def run_no_jax(cwd: Path, env: dict | None = None) -> subprocess.CompletedProcess:
    """The ``_NO_JAX`` script in a fresh interpreter at ``cwd`` (``env``: the
    whole environment, None for this process's)."""
    tree = dataclasses.asdict(CFG)
    tree["runtime"]["segment_buckets"] = [64, 200]
    variant = "\n".join(["# the test config as a variant file", *_yaml_lines(tree)]) + "\n"
    return subprocess.run([sys.executable, "-c", _NO_JAX, json.dumps(dataclasses.asdict(CFG)),
                           variant], cwd=cwd, env=env, capture_output=True, text=True,
                          timeout=120)


def test_port_runs_without_jax_tokenizers_yaml_safetensors():
    res = run_no_jax(ROOT)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.startswith("OK")
