"""The port's public API against the JAX package's: the YAML subset reader
against ``yaml.safe_load``, variant discovery (assets, ``./``, ``./config/``)
through both packages' ``load_variant``, ``TTSModel.load`` and the CLI's
``--variant``, the package exports, ``TextTokenizer.count_tokens``,
``mimi.decode_batch``, ``export_state_dict`` / ``save_checkpoint`` and the
utilities of ``utils.py``.  Small config of tests/test_tts.py; weights from
``weights.random_params`` carried across by ``export_state_dict``.

Bounds: 2e-4 for the Mimi decode (tests/test_mimi_parity.py); exports and
checkpoints byte-equal; configs equal.
"""

import dataclasses
import json
import types
import wave

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

import pocket_tts_tpu as jpkg
import pocket_tts_tpu_torch as tpkg
from pocket_tts_tpu import config as jconfig
from pocket_tts_tpu import text as jtext
from pocket_tts_tpu import utils as jutils
from pocket_tts_tpu import weights as jweights
from pocket_tts_tpu.models import mimi as jmimi
from pocket_tts_tpu.runtime import quantize as jquantize
from pocket_tts_tpu_torch import cli, config, utils
from pocket_tts_tpu_torch import text as ttext
from pocket_tts_tpu_torch import weights as tweights
from pocket_tts_tpu_torch.models import mimi as tmimi
from pocket_tts_tpu_torch.runtime import quantize as tquantize
from pocket_tts_tpu_torch.runtime.engine import GenParams
from pocket_tts_tpu_torch.tts import TTSModel, _SegmentRun
from tests.test_tts import CFG

torch.set_num_threads(1)
PCFG = config.config_from_dict(dataclasses.asdict(CFG))
ASSET = config._CONFIG_DIR / "b6369a24.yaml"

# the small config of tests/test_tts.py as a variant file, with runtime
# overrides, flow sequences, comments and quoted strings
TINY = """\
# A small variant for tests.
weights_path: null
weights_path_without_voice_cloning: ~

flow_lm:
  dtype: 'float32'   # quoted
  flow: {flow}
  transformer:
    d_model: 64
    hidden_scale: 2
    max_period: 10000
    num_heads: 4
    num_layers: 2
  lookup_table:
    dim: 64
    n_bins: 4000
    tokenizer: sentencepiece
    tokenizer_path: "hf://kyutai/pocket-tts-without-voice-cloning/tokenizer.model@rev"

mimi:
  dtype: float32
  sample_rate: 24000
  channels: 1
  frame_rate: 12.5
  seanet:
    dimension: 32
    n_filters: 4
    ratios: [6, 5, 4]
    pad_mode: constant
  transformer:
    d_model: 32
    input_dimension: 32
    output_dimensions: [32]
    num_heads: 4
    num_layers: 2
    layer_scale: 0.01
    context: 48
    dim_feedforward: 64
  quantizer:
    dimension: 16
    output_dimension: 32

runtime:
  max_seq: 512
  text_buckets: [16, 32, 64]
  prompt_buckets: [16, 64]
  decode_chunks: [2, 4, 8]
  encode_seconds_buckets: [1.0, 2.0]
  segment_buckets: [56, 96, 200]   # runtime override
  pipeline_depth: 2
"""
FLOW = "\n    depth: 2\n    dim: 48"


def _tiny(tmp_path, where: str, name: str = "tiny_variant"):
    folder = tmp_path / "config" if where == "config" else tmp_path
    folder.mkdir(exist_ok=True)
    path = folder / f"{name}.yaml"
    path.write_text(TINY.format(flow=FLOW))
    return path


# -- the YAML reader -------------------------------------------------------------


@pytest.mark.parametrize("source", ["asset", "tiny"])
def test_parse_yaml_agrees_with_safe_load(source, tmp_path):
    text = ASSET.read_text() if source == "asset" else _tiny(tmp_path, "cwd").read_text()
    assert config.parse_yaml(text, source) == yaml.safe_load(text)


@pytest.mark.parametrize("text", [
    "a: 1", "a: 010", "a: 0x1F", "a: 0b101", "a: 1_000", "a: +12", "a: -0", "a: 09",
    "a: 1.5e+3", "a: 1e9", "a: 1.", "a: .5", "a: -.Inf", "a: yes", "a: Off", "a: ~", "a:",
    "a: NULL", "a: 'it''s'", 'a: "x\\ty\\u00e9"', "a: [1, 'b, c', 2.5, ]", "a: []",
    "a: hf://x/y@z  # comment", "a: b#c", "a: foo bar", "---\na:\n  b: 1\n  c:\n    d: [6]\n  e:",
    "# only a comment\n\na: 1\n"])
def test_parse_yaml_scalars_agree_with_safe_load(text):
    assert repr(config.parse_yaml(text)) == repr(yaml.safe_load(text))
    assert config.parse_yaml(".nan_key: .nan")[".nan_key"] != 0  # NaN compares unequal


@pytest.mark.parametrize("text,line", [
    ("a: 1\nb:\n  - 1", 3), ("a: 1:30", 1), ("a: 2001-01-01", 1), ("a: &x 1", 1), ("a: *x", 1),
    ("a: !!str 1", 1), ("a: |\n  x", 1), ("a: {b: 1}", 1), ("a: 1\na: 2", 2),
    ("a: 1\n  b: 2", 2), ("? a\n: 1", 1), ("a: b: c", 1), ("<<: 1", 1), ("a: 'x", 1),
    ("a: 1\n---\nb: 2", 2), ("\ta: 1", 1), ("a: [[1]]", 1), ("a: [1, {b: 2}]", 1),
    ("a: 'x' y", 1), ("a:\n  b: 1\n c: 2", 3), ("a: [1, 2", 1), ("plain", 1)])
def test_parse_yaml_refuses_outside_the_subset(text, line):
    with pytest.raises(ValueError, match=f"^f.yaml:{line}: .*outside the YAML subset"):
        config.parse_yaml(text, "f.yaml")


def test_b6369a24_literal_equals_the_asset():
    assert config.load_config(ASSET) == config.load_variant("b6369a24")
    assert config.load_variant() == config.config_from_dict(
        dataclasses.asdict(jconfig.load_variant()))


# -- variant discovery -----------------------------------------------------------


@pytest.mark.parametrize("where", ["cwd", "config"])
def test_load_variant_finds_yaml_like_jax(where, tmp_path, monkeypatch):
    path = _tiny(tmp_path, where)
    monkeypatch.chdir(tmp_path)
    assert config.find_config_path("tiny_variant") == jconfig.find_config_path("tiny_variant")
    assert config.find_config_path("tiny_variant").resolve() == path.resolve()
    ours = config.load_variant("tiny_variant")
    assert ours == config.config_from_dict(dataclasses.asdict(jconfig.load_variant(
        "tiny_variant")))
    assert ours.runtime.segment_buckets == (56, 96, 200)
    assert ours.flow_lm.transformer == PCFG.flow_lm.transformer and ours.mimi == PCFG.mimi


def test_unknown_variant_lists_where_it_looked(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    with pytest.raises(FileNotFoundError, match="no_such_variant.yaml"):
        config.load_variant("no_such_variant")
    (tmp_path / "bad.yaml").write_text("runtime:\n  segment_buckets:\n    - 8\n")
    with pytest.raises(ValueError, match="bad.yaml:3"):
        config.load_variant("bad")


def test_model_and_cli_load_a_yaml_variant(tmp_path, monkeypatch):
    """``TTSModel.load(variant=)`` and ``cli generate --variant`` build the
    YAML's model (random weights), and its segment_buckets override picks the
    fused segment's bucket."""
    _tiny(tmp_path, "config")
    monkeypatch.chdir(tmp_path)
    model = TTSModel.load("tiny_variant", temp=0.0, eos_threshold=1e9, device="cpu")
    assert model.config == config.load_variant("tiny_variant")
    assert not model.has_real_weights
    text = "Hi there."
    budget = model.estimate_generation_steps(text)
    assert model.engine.segment_bucket(budget) == 56 and budget <= 56
    assert _SegmentRun(model, text, model.get_voice_state(), None,
                       low_latency=False).fused_bucket == 56
    wav = model.generate(text)
    assert wav.size == budget * model.frame_size and model.engine.frames_decoded == budget
    out = tmp_path / "out.wav"
    assert cli.main(["generate", "--variant", "tiny_variant", "--text", text, "-o", str(out),
                     "--quiet", "--temperature", "0", "--eos-threshold", "1e9",
                     "--device", "cpu"]) == 0
    with wave.open(str(out), "rb") as f:
        assert f.getnframes() == wav.size


# -- exports, tokenizer ----------------------------------------------------------


def test_exports_cover_the_jax_package():
    public = {n for n, v in vars(jpkg).items()
              if not n.startswith("_") and not isinstance(v, types.ModuleType)}
    assert public | {"__version__"} <= set(tpkg.__all__)
    for name in tpkg.__all__:
        assert hasattr(tpkg, name)
    assert tpkg.__version__ == jpkg.__version__
    for name in [n for n in public if n.startswith("DEFAULT_")]:
        assert getattr(tpkg, name) == getattr(jpkg, name)
    assert tpkg.TTSModel is TTSModel and tpkg.load_variant is config.load_variant


@pytest.mark.parametrize("text", ["", "Hello, world!", "Numbers 1234 and émigré café.",
                                  "A much longer sentence, with commas; and more words."])
def test_count_tokens_matches_jax(text):
    assert (ttext.load_tokenizer(None).count_tokens(text)
            == jtext.load_tokenizer(None).count_tokens(text))


# -- decode_batch, export_state_dict, save_checkpoint ----------------------------


@pytest.fixture(scope="module")
def params():
    plans = jmimi.MimiPlans(CFG.mimi)
    jp = jweights.random_params(CFG, plans, seed=3)
    sd = jweights.export_state_dict(jp, plans)
    return jp, sd, tweights.from_state_dict(sd, PCFG)


def test_decode_batch_matches_streaming_and_jax(params):
    jp, _, pp = params
    plans = tmimi.MimiPlans(PCFG.mimi)
    lat = np.random.default_rng(0).standard_normal((1, 16, 9)).astype(np.float32)
    st = tmimi.init_decode_state(plans, 1)
    chunks = []
    for a, b in ((0, 2), (2, 3), (3, 7), (7, 9)):
        y, st = tmimi.decode_step(pp["mimi"], plans, st, torch.from_numpy(lat[:, :, a:b]))
        chunks.append(y)
    stream = torch.cat(chunks, -1)
    got = tmimi.decode_batch(pp["mimi"], plans, torch.from_numpy(lat), block=64)
    assert got.shape == stream.shape == (1, 1, 9 * 1920)
    assert (got - stream).abs().max().item() < 2e-4
    ref = np.asarray(jmimi.decode_batch(jp["mimi"], jmimi.MimiPlans(CFG.mimi),
                                        jnp.asarray(lat), block=64))
    assert np.abs(got.numpy() - ref).max() < 2e-4


def test_export_state_dict_equals_jax_export(params):
    _, sd, pp = params
    ours = tweights.export_state_dict(pp, PCFG)
    assert sorted(ours) == sorted(sd)
    for k, v in sd.items():
        assert ours[k].dtype == np.float32 and ours[k].shape == v.shape, k
        assert ours[k].tobytes() == np.asarray(v, np.float32).tobytes(), k
    ours[next(iter(ours))][...] = 0  # a copy: the params stay as they were
    assert tweights.export_state_dict(pp, PCFG).keys() == ours.keys()
    np.testing.assert_array_equal(tweights.export_state_dict(pp, PCFG)[next(iter(sd))],
                                  sd[next(iter(sd))])


def test_export_refuses_quantized_params_like_jax(params):
    jp, _, pp = params
    with pytest.raises(TypeError, match="save_quantized"):
        tweights.export_state_dict(tquantize.quantize_params(pp), PCFG)
    with pytest.raises(Exception):
        jweights.export_state_dict(jquantize.quantize_params(jp), jmimi.MimiPlans(CFG.mimi))


def test_save_checkpoint_round_trip(params, tmp_path, monkeypatch):
    """The port reads its checkpoint back bit for bit, generates the same
    audio from it (temp 0, through ``load_params``' ./tts_<variant> file),
    and the JAX package's loader reads it to its own params."""
    jp, sd, pp = params
    path = tmp_path / "tts_tiny_variant.safetensors"
    tweights.save_checkpoint(pp, PCFG, path)
    back = tweights.read_safetensors(path)
    assert sorted(back) == sorted(sd)
    assert all(back[k].tobytes() == np.asarray(sd[k], np.float32).tobytes() for k in sd)
    monkeypatch.setenv("POCKET_TTS_WEIGHTS", str(path))
    jback, real = jweights.load_params(CFG, jmimi.MimiPlans(CFG.mimi))
    assert real
    flat_a = dict(jax_leaves(jback))
    for key, leaf in jax_leaves(jp):
        assert np.asarray(flat_a[key]).tobytes() == np.asarray(leaf).tobytes(), key
    monkeypatch.delenv("POCKET_TTS_WEIGHTS")
    _tiny(tmp_path, "cwd")
    monkeypatch.chdir(tmp_path)
    loaded = TTSModel.load("tiny_variant", temp=0.0, device="cpu")
    assert loaded.has_real_weights
    direct = TTSModel(config.load_variant("tiny_variant"), pp, gen=GenParams(temp=0.0),
                      has_real_weights=True, device="cpu")
    a, b = loaded.generate("Round trip."), direct.generate("Round trip.")
    assert a.size > 0 and a.tobytes() == b.tobytes()


def jax_leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from jax_leaves(v, f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from jax_leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


# -- utils -----------------------------------------------------------------------


def test_display_execution_time_sets_elapsed_ms():
    with utils.display_execution_time("block") as t:
        assert t.elapsed_ms == 0.0
        sum(range(10000))
    assert t.elapsed_ms > 0.0
    with jutils.display_execution_time("block", print_output=False) as ref:
        pass
    assert type(ref.elapsed_ms) is type(t.elapsed_ms) is float


def test_profiler_trace_writes_a_chrome_trace(tmp_path):
    with utils.profiler_trace(tmp_path / "trace", device="cpu") as log_dir:
        torch.ones(64, 64) @ torch.ones(64, 64)
    traces = list(log_dir.glob("trace_*.json"))
    assert len(traces) == 1
    events = json.loads(traces[0].read_text())["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            with utils.profiler_trace(tmp_path / "x"):
                pass
