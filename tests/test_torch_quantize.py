"""Weight quantization in the port against the JAX package (the small config
of tests/test_tts.py, one weight set: weights.random_params ->
export_state_dict -> the port's from_state_dict).

* ``quantize_array`` / ``quantize_tree`` / ``quantize_params``: ``q`` and
  ``scale`` bit-equal to JAX's jitted ``runtime.quantize.quantize_params``,
  int8 and int4, stacked, conv and flagship-shaped weights.
* ``snr_report`` within 1e-3 dB of JAX's (the port sums in float64).
* The artifact interchanges both ways, bit-equal; a plain file is refused.
* The int8 and int4 models against JAX's at temp 0: FlowLM latents within
  5e-4 (tests/test_frozen_parity.py), audio within 1e-4 (tests/test_tts.py).
* The quantized ContinuousBatcher case of tests/test_batcher.py:382.
* ``kernels.qlinear`` on the CPU: its plain route, the shape rule, the int4
  split-half layout, odd shapes.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pocket_tts_tpu import weights as jweights
from pocket_tts_tpu.models.mimi import MimiPlans
from pocket_tts_tpu.ops import qtensor as jqt
from pocket_tts_tpu.runtime import quantize as jquant
from pocket_tts_tpu.runtime.engine import Engine as JaxEngine
from pocket_tts_tpu.runtime.engine import GenParams as JaxGen
from pocket_tts_tpu.tts import TTSModel as JaxTTS
from pocket_tts_tpu_torch import weights as tweights
from pocket_tts_tpu_torch.config import config_from_dict
from pocket_tts_tpu_torch.kernels import qlinear as ql
from pocket_tts_tpu_torch.ops import qtensor as tqt
from pocket_tts_tpu_torch.runtime import quantize as tquant
from pocket_tts_tpu_torch.runtime.batcher import ContinuousBatcher
from pocket_tts_tpu_torch.runtime.engine import Engine, GenParams
from pocket_tts_tpu_torch.tts import TTSModel
from tests.test_tts import CFG

torch.set_num_threads(1)
PCFG = config_from_dict(dataclasses.asdict(CFG))
TEXT = "Testing the quantized model now."


@pytest.fixture(scope="module")
def exported():
    plans = MimiPlans(CFG.mimi)
    jp = jweights.random_params(CFG, plans, seed=3)
    sd = jweights.export_state_dict(jp, plans)
    return jp, sd, tweights.from_state_dict(sd, PCFG)


@pytest.fixture(scope="module")
def models(exported):
    jp, _, tp = exported
    jax_model = JaxTTS(CFG, jp, gen=JaxGen(temp=0.0), has_real_weights=False)
    port = TTSModel(PCFG, tp, gen=GenParams(temp=0.0), has_real_weights=False, device="cpu")
    return jax_model, port


def _assert_trees_equal(jtree, ttree):
    """A JAX param tree against a port one: same paths, QTensor leaves where
    JAX has them with bit-equal q and scale, plain leaves bit-equal."""
    jflat, tflat = dict(jquant._flatten_paths(jtree)), dict(tquant._flatten_paths(ttree))
    assert sorted(jflat) == sorted(tflat)
    n_q = 0
    for path, a in jflat.items():
        b = tflat[path]
        if isinstance(a, jqt.QTensor):
            assert isinstance(b, tqt.QTensor), path
            assert b.q.dtype == {jnp.int8: torch.int8, jnp.uint8: torch.uint8}[a.q.dtype.type], path
            np.testing.assert_array_equal(b.q.numpy(), np.asarray(a.q), err_msg=path)
            np.testing.assert_array_equal(b.scale.float().numpy(), np.asarray(a.scale, np.float32),
                                          err_msg=path)
            n_q += 1
        else:
            assert not isinstance(b, tqt.QTensor), path
            np.testing.assert_array_equal(b.numpy(), np.asarray(a, np.float32), err_msg=path)
    return n_q


# -- quantization against JAX's jitted quantize_params ------------------------


@pytest.mark.parametrize("bits", [8, 4])
def test_quantize_params_bit_equal_to_jax(exported, bits):
    jp, _, tp = exported
    n_q = _assert_trees_equal(jquant.quantize_params(jp, bits), tquant.quantize_params(tp, bits))
    assert n_q > 5  # backbone in_proj/ff1/ff2, flow net, Mimi transformers, SEANet convs


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("shape,name", [
    ((6, 3, 256, 512), "in_proj"),  # a stacked in_proj (scales over [L, 3, E])
    ((6, 1024, 512), "ff1"),  # an ff1-shaped stack
    ((1536, 512), "final_ada_w"),  # [out, in], the int4 [1536, 512] case
    ((64, 32, 7), "w"),  # a conv kernel: odd last dim, int8 storage at int4 levels
])
def test_quantize_array_bit_equal_to_jitted_jax(shape, name, bits):
    """Scales are absmax * float32(1/qmax), as XLA computes the division
    under jit; q rounds w / scale half to even."""
    w = np.random.default_rng(len(shape) + bits).standard_normal(shape).astype(np.float32) * 0.05
    jtree = jquant.quantize_params({name: jnp.asarray(w)}, bits)
    ttree = tquant.quantize_params({name: torch.from_numpy(w)}, bits)
    assert _assert_trees_equal(jtree, ttree) == 1
    assert ttree[name].shape == shape and ttree[name].packed == (bits == 4 and shape[-1] % 2 == 0)


def test_qtensor_layout_and_policy():
    w = torch.from_numpy(np.random.default_rng(0).standard_normal((6, 8)).astype(np.float32))
    qt = tqt.quantize_array(w, bits=4)
    assert qt.packed and qt.q.shape == (6, 4) and qt.shape == (6, 8)
    scale = np.maximum(np.abs(w.numpy()).max(axis=1), 1e-12) / 7.0
    ref = np.clip(np.round(w.numpy() / scale[:, None]), -7, 7)
    np.testing.assert_allclose(qt.dequant().numpy(), ref * scale[:, None], rtol=1e-6)
    stacked = tqt.quantize_array(torch.randn(2, 3, 4, 8), channel_axes=3)
    assert stacked[1].shape == (3, 4, 8) and stacked[1].scale.shape == (3, 4)
    assert stacked.to(torch.bfloat16).q.dtype == torch.int8
    assert stacked.to(torch.bfloat16).dtype == torch.bfloat16
    assert tqt.mat(w) is w
    for name, leaf, want in (("mimi/dec_tf/layers/ls1", torch.ones(2, 512), False),
                             ("tf/ff1", torch.ones(64, 64), True),
                             ("flow_lm/text_embed", torch.ones(64, 64), False),
                             ("tf/out_proj", torch.ones(64, 64), False),
                             ("flow/blocks/mlp1_b", torch.ones(6, 512), False),
                             ("tiny", torch.ones(4, 4), False)):
        assert tqt.should_quantize(name, leaf) == want == jqt.should_quantize(
            name, jnp.asarray(leaf.numpy())), name


def test_snr_report_matches_jax(exported):
    jp, _, tp = exported
    for bits in (8, 4):
        js = jquant.snr_report(jp, jquant.quantize_params(jp, bits))
        ts = tquant.snr_report(tp, tquant.quantize_params(tp, bits))
        assert sorted(ts) == sorted(js) and any("ff1" in k for k in ts)
        assert max(abs(ts[k] - js[k]) for k in js) <= 1e-3
        if bits == 8:
            assert min(ts.values()) > 25.0  # tests/test_quantize.py:96


# -- the artifact --------------------------------------------------------------


@pytest.mark.parametrize("bits", [8, 4])
def test_artifact_interchanges_with_jax(exported, tmp_path, bits):
    """Port save -> JAX load and JAX save -> port load: the same tree, bit
    for bit, and the artifact far smaller than float32."""
    jp, _, tp = exported
    tq = tquant.quantize_params(tp, bits)
    ours = tmp_path / "port.safetensors"
    tquant.save_quantized(tq, ours)
    _assert_trees_equal(jquant.load_quantized(ours), tq)
    theirs = tmp_path / "jax.safetensors"
    jquant.save_quantized(jquant.quantize_params(jp, bits), theirs)
    loaded = tquant.load_quantized(theirs)
    _assert_trees_equal(jquant.quantize_params(jp, bits), loaded)
    _assert_trees_equal(jquant.load_quantized(theirs), tquant.load_quantized(ours))
    assert tweights.read_safetensors(ours, with_metadata=True)[1] == {
        "format": "pocket-tts-tpu-int8", "bits": str(bits)}
    f32_bytes = sum(t.numel() * 4 for _, t in tquant._flatten_paths(tp))
    saved = sum(leaf.q.numel() * 3 for _, leaf in tquant._flatten_paths(tq)
                if isinstance(leaf, tqt.QTensor))
    assert ours.stat().st_size < f32_bytes - 0.9 * saved


def test_load_quantized_rejects_a_plain_file(tmp_path):
    plain = tmp_path / "plain.safetensors"
    tweights.write_safetensors({"w": np.zeros((4, 4), np.float32)}, plain)
    with pytest.raises(ValueError, match="int8 checkpoint"):
        tquant.load_quantized(plain)
    with pytest.raises(ValueError, match="int8 checkpoint"):
        TTSModel.load_quantized(plain, device="cpu")


def test_load_quantized_model_equals_quantize_model(models, tmp_path, monkeypatch):
    import pocket_tts_tpu_torch.tts as tts_mod

    _, port = models
    qmodel = tquant.quantize_model(port)
    path = tmp_path / "m.int8.safetensors"
    tquant.save_quantized(qmodel.params, path)
    monkeypatch.setattr(tts_mod, "load_variant", lambda variant: PCFG)
    loaded = TTSModel.load_quantized(path, temp=0.0, device="cpu")
    with pytest.raises(TypeError, match="unknown load kwargs"):
        TTSModel.load_quantized(path, temperature=0.0, device="cpu")
    assert loaded.is_quantized and qmodel.is_quantized and not port.is_quantized
    np.testing.assert_array_equal(loaded.generate(TEXT), qmodel.generate(TEXT))


# -- the quantized model against JAX's -----------------------------------------


@pytest.mark.parametrize("bits", [8, 4])
def test_quantized_engine_matches_jax(exported, bits):
    """decode_frames of the quantized engines at temp 0: latents within 5e-4,
    int16 audio within 4 LSB (1e-4 in float audio is 3.3 LSB)."""
    jp, _, tp = exported
    jeng = JaxEngine(CFG, jquant.quantize_params(jp, bits), batch_size=1)
    teng = Engine(PCFG, tquant.quantize_params(tp, bits), "cpu")
    toks = np.array([[3, 1, 4, 1, 5, 9, 2]], np.int32)
    jst = jeng.prefill_tokens(jeng.new_state(1), toks, toks.shape[1])
    tst = teng.prefill_tokens(teng.new_state(1), toks, toks.shape[1])
    key, g = jax.random.PRNGKey(0), torch.Generator().manual_seed(0)
    for k in (4, 2):
        jst, key, jaudio, _ = jeng.decode_frames(jst, key, k, JaxGen(temp=0.0))
        tst, taudio, _ = teng.decode_frames(tst, k, GenParams(temp=0.0), g)
        assert np.abs(tst["latent"].numpy() - np.asarray(jst["latent"])).max() <= 5e-4
        assert np.abs(taudio.numpy().astype(np.int64)
                      - np.asarray(jaudio).astype(np.int64)).max() <= 4


def test_quantized_model_generate_matches_jax(models):
    jax_model, port = models
    ref = jquant.quantize_model(jax_model).generate(TEXT)
    qmodel = tquant.quantize_model(port)
    got = qmodel.generate(TEXT)
    assert got.shape == ref.shape and got.size > 0
    assert np.abs(got - ref).max() <= 1e-4
    # the clone quantized the float32 params and left the source model alone
    assert not isinstance(port.engine.params["flow_lm"]["tf"]["ff1"], tqt.QTensor)
    assert isinstance(qmodel.engine.params["flow_lm"]["tf"]["ff1"], tqt.QTensor)
    blocks = qmodel.engine.params["flow_lm"]["flow"]["blocks"]
    assert all(t.dtype == torch.float32 and torch.is_tensor(t) for t in blocks.values())


def test_quantized_model_batched(models):
    """tests/test_batcher.py:382: a real-int8 model rides the continuous
    batcher unchanged; each request equals the quantized single stream at
    temp 0."""
    _, port = models
    qmodel = tquant.quantize_model(port)
    single = qmodel.generate_with_pauses("Quantized batching works.")
    b = ContinuousBatcher(qmodel, batch_size=2, chunk_frames=4)
    b.start()
    try:
        assert isinstance(b.engine.params["flow_lm"]["tf"]["ff1"], tqt.QTensor)
        batched = b.generate("Quantized batching works.")
    finally:
        b.stop()
    assert batched.shape == single.shape
    np.testing.assert_allclose(batched, single, atol=1e-4)


# -- kernels.qlinear on the CPU ------------------------------------------------


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("m,n,k", [(1, 96, 64), (3, 1000, 1002), (16, 32, 512)])
def test_qlinear_plain_route(m, n, k, bits):
    """On CPU tensors qlinear is its plain version, x @ mat(w).T + b, in the
    weight's dtype, and launches nothing."""
    rng = np.random.default_rng(m + n + bits)
    w = tqt.quantize_array(torch.from_numpy(rng.standard_normal((n, k)).astype(np.float32)),
                           bits=bits)
    x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal(n).astype(np.float32))
    launches = ql.qlinear.launches
    y = ql.qlinear(x, w, b)
    assert ql.qlinear.launches == launches
    assert y.shape == (m, n) and y.dtype == torch.float32
    assert torch.equal(y, x @ w.dequant().T + b)
    assert torch.equal(ql.linear(x, w, b), y)
    wb = w.to(torch.bfloat16)
    assert ql.qlinear(x, wb).dtype == torch.bfloat16
    assert torch.equal(ql.qlinear(x, wb), x.bfloat16() @ wb.dequant().T)


def test_qlinear_split_half_int4_and_stacked_in_proj():
    """Byte j of an int4 row holds element j (low nibble) and j + K/2 (high
    nibble); a stacked [3, E, E] in_proj is one [3E, E] product."""
    q = torch.tensor([[0x9F, 0x18]], dtype=torch.uint8)  # lo 15, 8 | hi 9, 1 -> 7, 0, 1, -7
    w = tqt.QTensor(q, torch.tensor([0.5]))
    np.testing.assert_array_equal(w.dequant().numpy(), [[3.5, 0.0, 0.5, -3.5]])
    x = torch.tensor([[1.0, 2.0, 3.0, 4.0]])
    assert ql.qlinear(x, w).item() == 3.5 + 1.5 - 14.0
    stacked = tqt.quantize_array(torch.randn(3, 8, 8), channel_axes=2)
    flat = ql.as_matrix(stacked)
    assert flat.shape == (24, 8) and flat.scale.shape == (24,)
    assert flat.q.data_ptr() == stacked.q.data_ptr()
    xs = torch.randn(2, 5, 8)
    y = ql.qlinear(xs, stacked)
    assert y.shape == (2, 5, 24)
    ref = torch.einsum("bte,kpe->btkp", xs, stacked.dequant()).reshape(2, 5, 24)
    torch.testing.assert_close(y, ref, rtol=0, atol=1e-5)


def test_qlinear_shape_rule():
    """The kernel takes at most MAX_ROWS rows of x; more go through mat() and
    one matmul (on CUDA; on the CPU every call is the plain version)."""
    assert ql.MAX_ROWS == 32 and ql.MAX_ROW_BYTES == 4096
    src = ql.SOURCE.read_text()
    assert "kMaxRows = 32" in src
    # the f32 route's limits, which cover rows of MAX_ROW_BYTES in both formats
    assert f"kF32MaxChunks = {ql.F32_MAX_CHUNKS}" in src
    assert f"kF32MaxExtent = {ql.F32_MAX_X_EXTENT}" in src
    for k, packed in ((ql.MAX_ROW_BYTES, False), (2 * ql.MAX_ROW_BYTES, True)):
        p = ql.launch_plan_f32(8, k, packed)
        assert p.chunks_per_lane * p.k_warps * p.lanes_per_row * 16 >= ql.MAX_ROW_BYTES
    w = tqt.quantize_array(torch.randn(16, 64))
    x = torch.randn(40, 64)
    large = ql.qlinear.large_m
    assert torch.equal(ql.qlinear(x, w), x @ w.dequant().T)
    assert ql.qlinear.large_m == large  # CPU: the plain version, not the CUDA shape rule
