"""Fine-tuning in the port (``pocket_tts_tpu_torch/training``) against the
JAX package's ``pocket_tts_tpu/training``, on the small config of
tests/test_tts.py with one weight set for both packages (weights.random_params
-> export_state_dict -> the port's from_state_dict).  Every case of
tests/test_training.py but the two sharded ones, which are in
tests/test_torch_mesh_train.py.

Bounds, float32 on the CPU:

* loss and each metric within 1e-5 * max(1, |JAX|), with the draws JAX's key
  makes passed to the port (torch cannot reproduce ``jax.random``);
* each gradient leaf within 1e-4 * max(1, max |g_JAX|);
* the optimizer fed JAX's gradients for 3 steps (warmup 1, total 3) within
  1e-6 of optax;
* ``init_lora``'s factors bit-equal; artifacts written by either package and
  read by the other bit-equal, with equal metadata;
* ``make_batch`` latents within 2e-4 (tests/test_frozen_parity.py);
* temp-0 audio of ``apply_adapted`` clones within 1e-4 of JAX's
  (tests/test_tts.py).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pocket_tts_tpu import training as jtraining
from pocket_tts_tpu import weights as jweights
from pocket_tts_tpu.models.mimi import MimiPlans
from pocket_tts_tpu.runtime.engine import GenParams as JaxGen
from pocket_tts_tpu.runtime.quantize import _flatten_paths as jflat
from pocket_tts_tpu.training import lora as jlora
from pocket_tts_tpu.training import trainer as jtrainer
from pocket_tts_tpu.tts import TTSModel as JaxTTS
from pocket_tts_tpu_torch import training
from pocket_tts_tpu_torch import weights as tweights
from pocket_tts_tpu_torch.config import config_from_dict
from pocket_tts_tpu_torch.runtime.engine import GenParams
from pocket_tts_tpu_torch.runtime.quantize import _flatten_paths as tflat
from pocket_tts_tpu_torch.runtime.quantize import quantize_model
from pocket_tts_tpu_torch.training import lora, trainer
from pocket_tts_tpu_torch.tts import TTSModel
from tests.test_tts import CFG

torch.set_num_threads(1)
PCFG = config_from_dict(dataclasses.asdict(CFG))
LDIM = CFG.mimi.quantizer.dimension
AUDIO_TOL = 1e-4


@pytest.fixture(scope="module")
def exported():
    plans = MimiPlans(CFG.mimi)
    jp = jweights.random_params(CFG, plans, seed=11)
    return jp, jweights.export_state_dict(jp, plans)


@pytest.fixture(scope="module")
def model(exported):
    return TTSModel(PCFG, tweights.from_state_dict(exported[1], PCFG), gen=GenParams(temp=0.0),
                    has_real_weights=False, device="cpu")


@pytest.fixture(scope="module")
def jax_model(exported):
    return JaxTTS(CFG, exported[0], gen=JaxGen(temp=0.0), has_real_weights=False)


def synthetic_batch(seed=0, b=4, tt=6, tf=6):
    """A training batch with random latent targets (no Mimi encode)."""
    rng = np.random.default_rng(seed)
    return {
        "tokens": rng.integers(1, 50, size=(b, tt)).astype(np.int32),
        "token_valid": np.array([tt, tt - 2, tt, tt - 1][:b], np.int32),
        "latents": rng.normal(size=(b, tf, LDIM)).astype(np.float32),
        "latent_valid": np.array([tf, tf - 2, tf - 1, tf][:b], np.int32),
    }


def jax_draws(key, batch, consistency: bool) -> dict:
    """The noise JAX's loss draws from ``key``, as numpy arrays."""
    b, tf = batch["latents"].shape[:2]
    k_eps, k_s, k_cons = jax.random.split(key, 3)
    d = {"eps": jax.random.normal(k_eps, (b, tf, LDIM), jnp.float32),
         "s": jax.random.uniform(k_s, (b, tf), jnp.float32)}
    if consistency:
        k_e2, k_s2, k_u2 = jax.random.split(k_cons, 3)
        d.update(eps2=jax.random.normal(k_e2, (b, tf, LDIM), jnp.float32),
                 s2=jax.random.uniform(k_s2, (b, tf), jnp.float32),
                 u2=jax.random.uniform(k_u2, (b, tf), jnp.float32))
    return {k: np.asarray(v) for k, v in d.items()}


@functools.lru_cache(maxsize=None)
def jax_value_and_grad(consistency_weight: float):
    return jax.jit(jax.value_and_grad(
        lambda p, b, k: jtraining.flow_matching_loss(p, CFG, b, k,
                                                     consistency_weight=consistency_weight),
        has_aux=True))


def trainable(tree):
    return trainer._map(tree, lambda t: t.detach().clone().requires_grad_(True))


def flat_np(tree) -> dict:
    """path -> numpy leaf of a tree of tensors or arrays."""
    return {k: v.detach().numpy() if torch.is_tensor(v) else np.asarray(v)
            for k, v in tflat(tree)}


def tweights_tree(jtree):
    """A JAX param tree as float32 CPU tensors."""
    return trainer._map(jtree, lambda a: torch.from_numpy(np.array(a, np.float32)))


def _pairs(seed, n=2):
    rng = np.random.default_rng(seed)
    texts = ["one sentence", "another line", "a third pair", "and a fourth"]
    return [(texts[i], rng.normal(size=(2 * 1920,)).astype(np.float32) * 0.1)
            for i in range(n)]


# -- the loss ----------------------------------------------------------------------


@pytest.mark.parametrize("consistency_weight", [0.0, 0.5])
def test_loss_metrics_and_gradients_match_jax(exported, model, consistency_weight):
    jp = exported[0]
    batch = synthetic_batch()
    key = jax.random.PRNGKey(0)
    (_, jm), jg = jax_value_and_grad(consistency_weight)(
        jp["flow_lm"], {k: jnp.asarray(v) for k, v in batch.items()}, key)
    params = trainable(model.params["flow_lm"])
    loss, metrics = training.flow_matching_loss(
        params, PCFG, batch, draws=jax_draws(key, batch, consistency_weight > 0),
        consistency_weight=consistency_weight)
    loss.backward()
    assert sorted(metrics) == sorted(jm)
    for name, want in jm.items():
        want = float(want)
        assert abs(metrics[name].item() - want) <= 1e-5 * max(1.0, abs(want)), name
    jgrad = dict(jflat(jg))
    for path, leaf in tflat(params):
        want = np.asarray(jgrad[path])
        got = np.zeros_like(want) if leaf.grad is None else leaf.grad.numpy()
        assert np.abs(got - want).max() <= 1e-4 * max(1.0, np.abs(want).max()), path
    assert metrics["flow_mse"] > 0 and metrics["eos_bce"] > 0
    if consistency_weight:
        assert metrics["consistency"] > 0


def test_loss_finite_and_masked(model):
    """Garbage in padded latent rows and padded token ids does not move the
    loss (tests/test_training.py's bound)."""
    batch = synthetic_batch()
    gen = torch.Generator().manual_seed(0)
    draws = training.loss.sample_draws(gen, 4, 6, LDIM, torch.device("cpu"))
    params = model.params["flow_lm"]
    loss, _ = training.flow_matching_loss(params, PCFG, batch, draws=draws)
    assert np.isfinite(float(loss))
    poisoned = {k: np.array(v) for k, v in batch.items()}
    for i, fv in enumerate(poisoned["latent_valid"]):
        poisoned["latents"][i, fv:] = 1e3
    for i, tv in enumerate(poisoned["token_valid"]):
        poisoned["tokens"][i, tv:] = 77
    loss2, _ = training.flow_matching_loss(params, PCFG, poisoned, draws=draws)
    np.testing.assert_allclose(float(loss), float(loss2), rtol=1e-6)


# -- the optimizer and the step --------------------------------------------------------


def test_optimizer_matches_optax(exported):
    """Three steps (warmup 1, total 3: the first rate is 0) fed JAX's
    gradients, the third scaled past the clip: params within 1e-6 of optax."""
    jp = exported[0]["flow_lm"]
    batch = {k: jnp.asarray(v) for k, v in synthetic_batch().items()}
    (_, _), g = jax_value_and_grad(0.0)(jp, batch, jax.random.PRNGKey(0))
    grads = [g, jax.tree.map(lambda x: x * 0.5, g), jax.tree.map(lambda x: x * 50.0, g)]
    kw = dict(weight_decay=0.01, clip_norm=1.0, warmup_steps=1, total_steps=3)
    jopt = jtrainer.make_optimizer(1e-2, **kw)
    jparams, jstate = jp, jopt.init(jp)
    params = tweights_tree(jp)
    state = training.make_optimizer(1e-2, **kw).init(params)
    for gk in grads:
        updates, jstate = jopt.update(gk, jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        gflat = dict(jflat(gk))
        for path, leaf in tflat(params):
            leaf.grad = torch.from_numpy(np.array(gflat[path]))
        norm = state.step()
        assert abs(float(norm) - float(optax.global_norm(gk))) <= 1e-6 * float(norm)
    want = dict(jflat(jparams))
    for path, leaf in tflat(params):
        np.testing.assert_allclose(leaf.detach().numpy(), np.asarray(want[path]), rtol=0,
                                   atol=1e-6, err_msg=path)
    # the first step ran at rate 0: only the later two moved the params
    assert state.count == 3 and trainer._schedule(1e-2, 1, 3)(0) == 0.0


def test_training_reduces_loss(model):
    opt = training.make_optimizer(2e-3, clip_norm=1.0)
    step = training.make_train_step(PCFG, opt)
    params = trainer._map(model.params["flow_lm"], lambda t: t.clone())
    state = opt.init(params)
    batch = synthetic_batch()
    gen = torch.Generator().manual_seed(7)
    first = None
    for _ in range(60):
        params, state, metrics = step(params, state, batch, gen)
        if first is None:
            first = {k: float(v) for k, v in metrics.items()}
    last = {k: float(v) for k, v in metrics.items()}
    assert np.isfinite(last["loss"]) and np.isfinite(first["grad_norm"])
    assert last["loss"] < first["loss"] * 0.8
    assert last["eos_bce"] < first["eos_bce"]


def test_consistency_term_trains(model):
    opt = training.make_optimizer(1e-3)
    step = training.make_train_step(PCFG, opt, consistency_weight=0.5)
    params = trainer._map(model.params["flow_lm"], lambda t: t.clone())
    _, _, metrics = step(params, opt.init(params), synthetic_batch(seed=3),
                         torch.Generator().manual_seed(1))
    m = {k: float(v) for k, v in metrics.items()}
    assert np.isfinite(m["consistency"]) and m["consistency"] > 0
    assert np.isfinite(m["grad_norm"]) and m["grad_norm"] > 0


# -- data ---------------------------------------------------------------------------------


def test_latent_preimage_matches_jax_and_roundtrips(model, jax_model):
    pinv = training.latent_preimage_matrix(model.params)
    np.testing.assert_array_equal(pinv, jtraining.latent_preimage_matrix(jax_model.params))
    w = model.params["mimi"]["quantizer_w"].numpy()[:, :, 0]
    z32 = np.random.default_rng(5).normal(size=(3, w.shape[1])).astype(np.float32)
    np.testing.assert_allclose((z32 @ w.T) @ pinv.T, z32, atol=1e-4)


def test_make_batch_matches_jax(model, jax_model):
    rng = np.random.default_rng(9)
    wav_a = rng.normal(size=(2 * 1920,)).astype(np.float32) * 0.1
    wav_b = rng.normal(size=(3 * 1920 + 500,)).astype(np.float32) * 0.1
    latents, valid = training.encode_latent_targets(model, [wav_a, wav_b])
    assert latents.shape == (2, 4, LDIM) and list(valid) == [2, 4]  # a partial frame rounds up
    pairs = [("hello there", wav_a), ("general kenobi", wav_b)]
    got = training.make_batch(model, pairs, voice_wav=wav_a)
    want = jtraining.make_batch(jax_model, pairs, voice_wav=wav_a)
    assert sorted(got) == sorted(want)
    for k in ("tokens", "token_valid", "latent_valid"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for k in ("latents", "voice_latents"):
        assert got[k].shape == want[k].shape
        assert np.abs(got[k] - want[k]).max() <= 2e-4, k
    assert got["voice_latents"].shape[2] == CFG.mimi.seanet.dimension


# -- finetune and the artifacts ----------------------------------------------------------


def _same_tree(a: dict, b: dict):
    fa, fb = flat_np(a), flat_np(b)
    assert sorted(fa) == sorted(fb)
    for k in fa:
        np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)


def _audio_matches_jax(port_model, jax_model, text="hi"):
    got, want = port_model.generate(text), jax_model.generate(text)
    assert got.size > 0 and got.shape == want.shape and np.isfinite(got).all()
    assert np.abs(got - want).max() <= AUDIO_TOL


def test_finetune_e2e_and_artifact_roundtrip(model, jax_model, tmp_path):
    tuned = training.finetune(model, _pairs(2), steps=3, batch_size=2, lr=1e-3, log_every=1)
    assert {"loss", "flow_mse", "eos_bce", "grad_norm"} <= set(tuned._finetune_metrics)
    before = model.params["flow_lm"]["input_w"]
    after = tuned.params["flow_lm"]["input_w"]
    assert not torch.allclose(before, after)
    assert tuned.engine is not model.engine and tuned.device == model.device

    port_path, jax_path = tmp_path / "port.safetensors", tmp_path / "jax.safetensors"
    training.save_finetuned_params(tuned.params["flow_lm"], port_path)
    loaded = jtraining.load_finetuned_params(port_path)  # the JAX package reads the port's
    _same_tree(tuned.params["flow_lm"], loaded)
    jtraining.save_finetuned_params(loaded, jax_path)  # and the port reads the JAX package's
    _same_tree(training.load_finetuned_params(jax_path), tuned.params["flow_lm"])
    assert (tweights.read_safetensors_header(port_path)[1]
            == tweights.read_safetensors_header(jax_path)[1])

    # the tuned FlowLM synthesizes as the JAX package's with the same artifact
    _audio_matches_jax(training.apply_finetuned(model, port_path),
                       jtraining.apply_adapted(jax_model, port_path))
    bad = tmp_path / "bad.safetensors"
    tweights.write_safetensors({"x": np.zeros((1,), np.float32)}, bad)
    with pytest.raises(ValueError):
        training.load_finetuned_params(bad)


class TestLoRA:
    def test_init_is_exact_noop_and_equals_jax(self, model, exported):
        base = model.params["flow_lm"]
        factors = training.init_lora(base, rank=2, seed=1)
        jfactors = jlora.init_lora(exported[0]["flow_lm"], rank=2, seed=1)
        assert list(factors) == list(jfactors)
        for t in factors:
            for leaf in ("a", "b"):
                np.testing.assert_array_equal(factors[t][leaf].numpy(),
                                              np.asarray(jfactors[t][leaf]))
        merged = training.merge_lora(base, factors, alpha=2.0, rank=2)
        _same_tree(base, merged)
        batch = synthetic_batch()
        draws = training.loss.sample_draws(torch.Generator().manual_seed(0), 4, 6, LDIM,
                                           torch.device("cpu"))
        l0, _ = training.flow_matching_loss(base, PCFG, batch, draws=draws)
        l1, _ = training.flow_matching_loss(merged, PCFG, batch, draws=draws)
        assert float(l0) == float(l1)

    def test_training_moves_targets_only(self, model):
        opt = training.make_optimizer(2e-3)
        step = training.make_lora_train_step(PCFG, opt, alpha=4.0, rank=4)
        base = trainer._map(model.params["flow_lm"], lambda t: t.clone())
        snapshot = trainer._map(base, lambda t: t.clone())
        factors = training.init_lora(base, rank=4, seed=2)
        state = opt.init(factors)
        batch = synthetic_batch()
        gen = torch.Generator().manual_seed(5)
        first = None
        for _ in range(40):
            factors, state, metrics = step(factors, state, base, batch, gen)
            if first is None:
                first = float(metrics["loss"])
        last = float(metrics["loss"])
        assert np.isfinite(last) and last < first * 0.9
        _same_tree(snapshot, base)  # the frozen base never moved
        merged = training.merge_lora(base, factors, alpha=4.0, rank=4)
        for (path, a), (_, b) in zip(tflat(base), tflat(merged)):
            assert torch.allclose(a, b) != (path in lora.LORA_DEFAULT_TARGETS), path

    def test_finetune_lora_artifact_and_dispatch(self, model, jax_model, tmp_path):
        tuned = training.finetune(model, _pairs(6), steps=3, batch_size=2, lr=2e-3,
                                  log_every=0, lora_rank=2)
        factors, rank, alpha = tuned._lora
        assert rank == 2 and alpha == 2.0
        lpath, fpath = tmp_path / "v.lora.safetensors", tmp_path / "v.full.safetensors"
        training.save_lora_params(factors, lpath, rank=rank, alpha=alpha)
        training.save_finetuned_params(tuned.params["flow_lm"], fpath)
        assert lpath.stat().st_size < fpath.stat().st_size / 2

        # both directions, factors and metadata
        jfactors, jrank, jalpha = jlora.load_lora_params(lpath)
        assert (jrank, jalpha) == (rank, alpha)
        jpath = tmp_path / "jax.lora.safetensors"
        jlora.save_lora_params(jfactors, jpath, rank=jrank, alpha=jalpha)
        back, r2, a2 = training.load_lora_params(jpath)
        assert (r2, a2) == (rank, alpha) and sorted(back) == sorted(factors)
        for t in factors:
            for leaf in ("a", "b"):
                np.testing.assert_array_equal(np.asarray(jfactors[t][leaf]),
                                              factors[t][leaf].numpy())
                np.testing.assert_array_equal(back[t][leaf].numpy(), factors[t][leaf].numpy())
        assert (tweights.read_safetensors_header(lpath)[1]
                == tweights.read_safetensors_header(jpath)[1])

        # apply_adapted dispatches on the format and reproduces the tuned params
        via_lora = training.apply_adapted(model, lpath)
        for (pa, a), (_, b) in zip(tflat(tuned.params["flow_lm"]),
                                   tflat(via_lora.params["flow_lm"])):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6, msg=pa)
        _audio_matches_jax(via_lora, jtraining.apply_adapted(jax_model, lpath))
        assert training.apply_adapted(model, fpath).generate("hi").size > 0

        bad = tmp_path / "bad.safetensors"
        tweights.write_safetensors({"x": np.zeros((1,), np.float32)}, bad)
        with pytest.raises(ValueError, match="unknown checkpoint format"):
            training.apply_adapted(model, bad)

    def test_init_validation(self, model):
        with pytest.raises(ValueError, match="rank"):
            training.init_lora(model.params["flow_lm"], rank=0)
        with pytest.raises(ValueError, match="not in params"):
            training.init_lora(model.params["flow_lm"], rank=2, targets=("tf/nope",))


def test_quantized_base_is_refused_by_both_packages(model, exported):
    """A QTensor has no ``+``: neither package can merge an adapter into an
    int8 leaf, and the port refuses to fine-tune a quantized model."""
    from pocket_tts_tpu.runtime.quantize import quantize_params as jquantize

    qmodel = quantize_model(model)
    factors = training.init_lora(model.params["flow_lm"], rank=2)
    with pytest.raises(ValueError, match="quantized"):
        training.merge_lora(qmodel.params["flow_lm"], factors, alpha=2.0, rank=2)
    with pytest.raises(ValueError, match="quantized"):
        training.finetune(qmodel, _pairs(3), steps=1, log_every=0)
    with pytest.raises(ValueError, match="quantized"):
        training.finetune(qmodel, _pairs(3), steps=1, log_every=0, lora_rank=2)
    jq = jquantize(exported[0])["flow_lm"]
    jfactors = jlora.init_lora(exported[0]["flow_lm"], rank=2)
    with pytest.raises(TypeError):
        jlora.merge_lora(jq, jfactors, alpha=2.0, rank=2)
