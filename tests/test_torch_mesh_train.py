"""Training on the port's dp x tp mesh and the adapter bank on a mesh engine
(``parallel/mesh.shard_trainable``, ``training.shard_batch``, the loss over
dp groups, ``finetune(mesh=)``, ``Engine(mesh=).set_adapter_bank``) against
the port's one-device runs and the JAX package's (ports of
tests/test_training.py:280-345 and tests/test_adapter_bank.py).

The port's meshes repeat the CPU device (dp 4 x tp 2, dp 2 x tp 2, dp 1 x
tp 2, dp 2 x tp 1); JAX's mesh is ``make_mesh(8, tp=2)`` over the 8
virtual CPU devices that tests/conftest.py forces.  One weight set for
both packages: the small config of tests/test_tts.py, ``random_params`` ->
``export_state_dict`` -> the port's ``from_state_dict``.

Bounds, float32 on the CPU:

* a sharded step against the one-device step: loss rtol 2e-4, params after
  the step rtol 2e-3 / atol 2e-4 (tests/test_training.py:338-345), and
  ``grad_norm`` within 1e-5 relative;
* against JAX's sharded step fed the draws JAX's key makes: loss and
  metrics within 1e-5 * max(1, |JAX|), params within 2e-3 / 2e-4;
* ``finetune(mesh=)`` against ``finetune()``: the tuned trees within 2e-3 /
  2e-4, the clones' temp-0 audio within 1e-4 (tests/test_tts.py);
* the bank's lanes on a mesh engine against the one-device bank at temp 0.5
  (the same noise): int16 audio within 1 LSB, latents within 1e-4
  (tests/test_sharding.py:82-86); against JAX's one-device bank at temp 0:
  1e-4 in float audio (tests/test_torch_adapter_bank.py), f32 and int8.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from pocket_tts_tpu import training as jtraining
from pocket_tts_tpu import weights as jweights
from pocket_tts_tpu.models.mimi import MimiPlans
from pocket_tts_tpu.parallel import mesh as jmesh
from pocket_tts_tpu.runtime.engine import Engine as JaxEngine
from pocket_tts_tpu.runtime.engine import GenParams as JaxGen
from pocket_tts_tpu.runtime.quantize import _flatten_paths as jflat
from pocket_tts_tpu.runtime.quantize import quantize_params as jquantize
from pocket_tts_tpu.training import lora as jlora
from pocket_tts_tpu_torch import training
from pocket_tts_tpu_torch import weights as tweights
from pocket_tts_tpu_torch.config import config_from_dict
from pocket_tts_tpu_torch.parallel import mesh as tmesh
from pocket_tts_tpu_torch.runtime.engine import Engine, GenParams
from pocket_tts_tpu_torch.runtime.quantize import _flatten_paths as tflat
from pocket_tts_tpu_torch.runtime.quantize import quantize_params
from pocket_tts_tpu_torch.training import trainer
from pocket_tts_tpu_torch.training.lora import build_adapter_bank, init_lora, save_lora_params
from pocket_tts_tpu_torch.tts import TTSModel
from tests.test_torch_training import _pairs, jax_draws, synthetic_batch
from tests.test_tts import CFG

torch.set_num_threads(1)
PCFG = config_from_dict(dataclasses.asdict(CFG))
CPU8 = [torch.device("cpu")] * 8
# name -> (devices, tp): dp 4 x tp 2 (JAX's make_mesh(8, tp=2)), 2 x 2, 1 x 2, 2 x 1
MESHES = {"dp4tp2": (8, 2), "dp2tp2": (4, 2), "dp1tp2": (2, 2), "dp2tp1": (2, 1)}
LOSS_RTOL = 2e-4
PARAM_TOL = dict(rtol=2e-3, atol=2e-4)
JAX_TOL = 1e-5  # x max(1, |JAX|), the loss and each metric
NORM_RTOL = 1e-5
AUDIO_TOL = 1e-4
MESH_LSB, LATENT_TOL = 1, 1e-4
LORA = dict(alpha=2.0, rank=2)


def _mesh(name):
    n, tp = MESHES[name]
    return tmesh.make_mesh(n, tp=tp, devices=CPU8)


@pytest.fixture(scope="module")
def exported():
    plans = MimiPlans(CFG.mimi)
    jp = jweights.random_params(CFG, plans, seed=11)
    return jp, tweights.from_state_dict(jweights.export_state_dict(jp, plans), PCFG)


@pytest.fixture(scope="module")
def model(exported):
    return TTSModel(PCFG, exported[1], gen=GenParams(temp=0.0), has_real_weights=False,
                    device="cpu")


def _copy(tree):
    return trainer._map(tree, lambda t: t.detach().clone())


def _flat_np(tree) -> dict:
    return {k: (v.detach().numpy() if torch.is_tensor(v) else np.asarray(v))
            for k, v in tflat(tree)}


def _close_trees(got: dict, want: dict, **tol):
    got, want = _flat_np(got), _flat_np(want)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **tol)


def _near_jax(metrics: dict, jm: dict):
    assert sorted(metrics) == sorted(jm)
    for k, v in jm.items():
        want = float(v)
        assert abs(float(metrics[k]) - want) <= JAX_TOL * max(1.0, abs(want)), k


# -- JAX's sharded steps (tests/test_training.py:280-345), once each --------------


def _jax_sharded(jp: dict, kind: str):
    """(metrics, params after the step as numpy by path, the batch, the draws
    of JAX's key) of JAX's sharded full or LoRA step on make_mesh(8, tp=2)
    over the FlowLM params ``jp``."""
    jopt = jtraining.make_optimizer(1e-3)
    seed = 4 if kind == "full" else 8
    batch = synthetic_batch(seed=seed, b=4)
    key = jax.random.PRNGKey(3 if kind == "full" else 9)
    mesh = jmesh.make_mesh(8, tp=2)
    jbatch = jtraining.shard_batch(batch, mesh)
    if kind == "full":
        params = jmesh.shard_params(jax.tree.map(jnp.array, jp), mesh)
        step = jtraining.make_train_step(CFG, jopt)
        params, _, metrics = step(params, jax.jit(jopt.init)(params), jbatch, key)
    else:
        base = jmesh.shard_params(jax.tree.map(jnp.array, jp), mesh)
        params = jlora.init_lora(jp, rank=2, seed=3)
        step = jlora.make_lora_train_step(CFG, jopt, **LORA)
        params, _, metrics = step(params, jax.jit(jopt.init)(params), base, jbatch, key)
    out = {k: np.asarray(v) for k, v in jflat(jax.device_get(params))}
    return ({k: float(v) for k, v in jax.device_get(metrics).items()}, out, batch,
            jax_draws(key, batch, False))


@pytest.fixture(scope="module")
def jax_steps(exported):
    return {kind: _jax_sharded(exported[0]["flow_lm"], kind) for kind in ("full", "lora")}


def _full_step(params, batch, draws):
    opt = training.make_optimizer(1e-3)
    step = training.make_train_step(PCFG, opt)
    params, _, metrics = step(params, opt.init(params), batch, draws=draws)
    return params, metrics


def _lora_step(base, factors, batch, draws):
    opt = training.make_optimizer(1e-3)
    step = training.make_lora_train_step(PCFG, opt, **LORA)
    factors, _, metrics = step(factors, opt.init(factors), base, batch, draws=draws)
    return factors, metrics


@pytest.mark.parametrize("name", sorted(MESHES))
def test_sharded_train_step_matches_one_device_and_jax(model, jax_steps, name):
    """The full step over the mesh: the params' masters tp-split / replicated,
    the batch dp-split with latent_valid unequal between groups; against
    the one-device step and JAX's dp 4 x tp 2 step."""
    jm, jparams, batch, draws = jax_steps["full"]
    mesh = _mesh(name)
    p_ref, m_ref = _full_step(_copy(model.params["flow_lm"]), batch, draws)
    p_sh, m_sh = _full_step(tmesh.shard_trainable(model.params["flow_lm"], mesh),
                            training.shard_batch(batch, mesh), draws)
    np.testing.assert_allclose(float(m_sh["loss"]), float(m_ref["loss"]), rtol=LOSS_RTOL)
    assert abs(float(m_sh["grad_norm"]) - float(m_ref["grad_norm"])) <= \
        NORM_RTOL * float(m_ref["grad_norm"])
    tuned = tmesh.gather(p_sh, "cpu")
    _close_trees(tuned, p_ref, **PARAM_TOL)
    _near_jax(m_sh, jm)
    _close_trees(tuned, jparams, **PARAM_TOL)


@pytest.mark.parametrize("name", sorted(MESHES))
def test_sharded_lora_step_matches_one_device_and_jax(model, jax_steps, name):
    """The LoRA step over a tp-sharded base (``shard_params``), the factors
    replicated (one master each), the batch dp-split."""
    jm, jfactors, batch, draws = jax_steps["lora"]
    mesh = _mesh(name)
    base = model.params["flow_lm"]
    f_ref, m_ref = _lora_step(base, init_lora(base, rank=2, seed=3), batch, draws)
    f_sh, m_sh = _lora_step(tmesh.shard_params(base, mesh),
                            tmesh.shard_trainable(init_lora(base, rank=2, seed=3), mesh),
                            training.shard_batch(batch, mesh), draws)
    np.testing.assert_allclose(float(m_sh["loss"]), float(m_ref["loss"]), rtol=LOSS_RTOL)
    assert abs(float(m_sh["grad_norm"]) - float(m_ref["grad_norm"])) <= \
        NORM_RTOL * float(m_ref["grad_norm"])
    tuned = tmesh.gather(f_sh, "cpu")
    _close_trees(tuned, f_ref, **PARAM_TOL)
    _near_jax(m_sh, jm)
    _close_trees(tuned, jfactors, **PARAM_TOL)
    # the merged base of the mesh: block by block, the one-device merge
    merged = training.merge_lora(tmesh.shard_params(base, mesh), f_sh, **LORA)
    with torch.no_grad():
        _close_trees(tmesh.gather(merged, "cpu"), training.merge_lora(base, f_ref, **LORA),
                     **PARAM_TOL)


@pytest.mark.parametrize("name", ["dp2tp1", "dp4tp2"])
def test_loss_is_a_global_mean_over_groups(model, name):
    """latent_valid differs between the groups (6 / 4 / 5 / 6 frames): the
    loss adds each group's numerator and denominator, then divides once,
    the consistency term too.  The mean of per-group means misses the bound
    (so this test can fail; the consistency term is too small to show it
    against the bound); the mesh's loss meets it."""
    batch = synthetic_batch(seed=5, b=4)
    mesh = _mesh(name)
    params = model.params["flow_lm"]
    draws = training.loss.sample_draws(torch.Generator().manual_seed(2), 4, 6,
                                       CFG.mimi.quantizer.dimension, torch.device("cpu"),
                                       consistency=True)
    kw = dict(draws=draws, consistency_weight=0.5)
    _, ref = training.flow_matching_loss(params, PCFG, batch, **kw)
    _, got = training.flow_matching_loss(tmesh.shard_trainable(params, mesh), PCFG,
                                         training.shard_batch(batch, mesh), **kw)
    per = mesh.shape["dp"]
    n = 4 // per
    groups = [training.flow_matching_loss(
        params, PCFG, {k: v[g * n:(g + 1) * n] for k, v in batch.items()},
        draws={k: v[g * n:(g + 1) * n] for k, v in draws.items()},
        consistency_weight=0.5)[1] for g in range(per)]
    assert sorted(got) == sorted(ref) == ["consistency", "eos_bce", "flow_mse", "loss"]
    for k in ref:
        want = float(ref[k])
        bound = 1e-5 * max(1.0, abs(want))
        assert abs(float(got[k]) - want) <= bound, k
        mean_of_means = sum(float(m[k]) for m in groups) / per
        # the consistency term (~2e-3 here) sits below the bound's floor of 1e-5
        assert abs(mean_of_means - want) > bound or k == "consistency", k


@pytest.mark.parametrize("name", sorted(MESHES))
def test_masters_count_each_logical_block_once(model, name):
    """The optimizer's leaves are the masters: each tp block once (on its
    rank's device in group 0), each replicated leaf once (on the lead), all
    of them leaf tensors of their own; together they hold every logical
    element once.  A ``shard_params`` tree has no masters."""
    mesh = _mesh(name)
    params = model.params["flow_lm"]
    placed = tmesh.shard_trainable(params, mesh)
    man = tmesh.sharding_manifest(placed)
    tp = mesh.shape["tp"]
    split = [k for k, v in man.items() if "tp" in v["spec"] and tp > 1]
    want = sum(tp if k in split else 1 for k in man)
    got = tmesh.masters(placed)
    assert len(got) == want and len({id(t) for t in got}) == want
    assert sum(t.numel() for t in got) == sum(t.numel() for _, t in tflat(params))
    assert all(t.dtype == torch.float32 and t.grad_fn is None for t in got)
    assert (tp > 1) == bool(split) and (not split or "tf/ff1" in split)
    assert len(training.make_optimizer().init(placed).leaves) == want
    with pytest.raises(ValueError, match="shard_trainable"):
        tmesh.masters(tmesh.shard_params(params, mesh))


def test_shard_batch_places_lanes_by_group():
    """Group g holds lanes [g B/dp, (g+1) B/dp) on its lead device, each a
    tensor of its own; a batch dp does not divide raises; the exports are
    the JAX package's."""
    batch = synthetic_batch(seed=1, b=4)
    mesh = _mesh("dp4tp2")
    placed = training.shard_batch(batch, mesh)
    assert sorted(placed) == sorted(batch)
    for k, v in placed.items():
        assert str(v.spec) == str(P("dp", *([None] * (batch[k].ndim - 1))))
        assert len(v.blocks) == 4 and all(len(row) == 1 for row in v.blocks)
        for g in range(4):
            np.testing.assert_array_equal(v.group(g).numpy(), batch[k][g:g + 1])
        np.testing.assert_array_equal(tmesh.gather(v, "cpu").numpy(), batch[k])
    assert len({placed["latents"].group(g).data_ptr() for g in range(4)}) == 4
    with pytest.raises(ValueError, match="not a multiple"):
        training.shard_batch(synthetic_batch(b=3), _mesh("dp2tp1"))
    assert sorted(training.__all__) == sorted(jtraining.__all__)


# -- finetune(mesh=) ----------------------------------------------------------------


@pytest.mark.parametrize("lora_rank", [0, 2])
def test_finetune_on_a_mesh_matches_one_device(model, lora_rank):
    """Three steps on dp 2 x tp 2 against ``finetune()``, with a voice prompt
    (its latents split over dp with the rest of the batch): the tuned trees
    (LoRA: the factors and the merged FlowLM), the clones' temp-0 audio;
    the clone is a single-device model on the model's device."""
    wav = np.random.default_rng(8).normal(size=(2 * 1920,)).astype(np.float32) * 0.1
    kw = dict(steps=3, batch_size=4, lr=1e-3, log_every=1, lora_rank=lora_rank, voice_wav=wav)
    pairs = _pairs(6, n=4)
    one = training.finetune(model, pairs, **kw)
    sharded = training.finetune(model, pairs, mesh=_mesh("dp2tp2"), **kw)
    assert sharded.engine.mesh is None and sharded.device == model.device
    _close_trees(sharded.params["flow_lm"], one.params["flow_lm"], **PARAM_TOL)
    assert not torch.equal(sharded.params["flow_lm"]["tf"]["ff1"],
                           model.params["flow_lm"]["tf"]["ff1"])
    if lora_rank:
        _close_trees(sharded._lora[0], one._lora[0], **PARAM_TOL)
        assert sharded._lora[1:] == one._lora[1:]
        assert all(t.device.type == "cpu" for _, t in tflat(sharded._lora[0]))
    for k, v in one._finetune_metrics.items():
        assert abs(sharded._finetune_metrics[k] - v) <= 2e-4 * max(1.0, abs(v)), k
    got, want = sharded.generate("hi"), one.generate("hi")
    assert got.shape == want.shape and got.size > 0
    assert np.abs(got - want).max() <= AUDIO_TOL


# -- the adapter bank on a mesh engine --------------------------------------------------

K = 4  # frames of the bank runs
BANK_LANES = ["one", None, "two", "one"]


def _random_lora(params_fl, rank, seed, targets=training.lora.LORA_DEFAULT_TARGETS):
    factors = init_lora(params_fl, rank, targets=targets, seed=seed)
    rng = np.random.default_rng(seed + 100)
    return {t: {"a": f["a"], "b": torch.from_numpy(
        rng.normal(0, 0.02, tuple(f["b"].shape)).astype(np.float32))}
        for t, f in factors.items()}


@pytest.fixture(scope="module")
def bank_paths(exported, tmp_path_factory):
    d = tmp_path_factory.mktemp("mesh_adapters")
    base = exported[1]["flow_lm"]
    paths = {"one": d / "one.safetensors", "two": d / "two.safetensors"}
    save_lora_params(_random_lora(base, 2, 1), paths["one"], rank=2, alpha=4.0)
    save_lora_params(_random_lora(base, 3, 2, ("tf/in_proj", "tf/ff1")), paths["two"], rank=3,
                     alpha=3.0)
    return {k: str(v) for k, v in paths.items()}


def _tokens():
    rng = np.random.default_rng(5)
    return [rng.integers(1, 40, size=(1, n)).astype(np.int32) for n in (5, 4, 6, 3)]


def _bank_run(params, bank, mesh, temp):
    """Lanes admitted with their adapter rows, then K frames: (int16 audio
    [4, K * 1920], latents [4, ldim])."""
    eng = Engine(PCFG, params, None if mesh else "cpu", batch_size=4, mesh=mesh)
    eng.set_adapter_bank(bank)
    empty = {k: v for k, v in Engine(PCFG, params, "cpu").new_state(1).items()
             if k in ("kc", "vc", "pos")}
    rows = np.stack([bank.row(n) for n in BANK_LANES])
    st = eng.new_state()
    for i, tok in enumerate(_tokens()):
        st = eng.admit_prefill_slot(st, i, empty, eng.pad_token_row(tok), tok.shape[1],
                                    lora_row=rows[i])
    st, audio, _ = eng.decode_frames(st, K, GenParams(temp=temp),
                                     torch.Generator().manual_seed(0), lora_w=rows)
    return audio.numpy().astype(np.int64), tmesh.gather(st["latent"], "cpu").numpy()


def _jax_bank(jp: dict, paths: dict, bits: int):
    """JAX's one-device bank engine at temp 0 on the same lanes: int16 audio."""
    jeng = JaxEngine(CFG, jquantize(jp, bits) if bits else jp, batch_size=4)
    bank = jlora.build_adapter_bank(paths)
    jeng.set_adapter_bank(bank)
    st = jeng.new_state(4)
    empty = {"kc": jnp.zeros_like(st["kc"][:, :1]), "vc": jnp.zeros_like(st["vc"][:, :1]),
             "pos": jnp.zeros((1,), jnp.int32)}
    rows = np.stack([bank.row(n) for n in BANK_LANES])
    for i, tok in enumerate(_tokens()):
        st = jeng.admit_prefill_slot(st, i, empty, jeng.pad_token_row(tok), tok.shape[1],
                                     lora_row=rows[i])
    _, _, audio, _ = jeng.decode_frames(st, jax.random.PRNGKey(0), K, JaxGen(temp=0.0),
                                        lora_w=jnp.asarray(rows))
    return np.asarray(audio).astype(np.int64)


@pytest.fixture(scope="module")
def jax_banks(exported, bank_paths):
    return functools.cache(lambda bits: _jax_bank(exported[0], bank_paths, bits))


@pytest.mark.parametrize("bits", [0, 8])
@pytest.mark.parametrize("name", ["dp1tp2", "dp2tp2"])
def test_bank_on_a_mesh_engine(exported, bank_paths, jax_banks, name, bits):
    """B = 4 (adapters one / base / two / one) on a mesh engine: the bank's
    stacks cut per tp rank, float32 and int8 weights; each lane against the
    one-device bank at temp 0.5 and JAX's one-device bank at temp 0."""
    params = exported[1] if not bits else quantize_params(exported[1], bits)
    bank = build_adapter_bank(bank_paths)
    mesh = _mesh(name)
    ref_audio, ref_latent = _bank_run(params, bank, None, 0.5)
    audio, latent = _bank_run(params, bank, mesh, 0.5)
    assert audio.shape == ref_audio.shape and np.abs(audio - ref_audio).max() <= MESH_LSB
    np.testing.assert_allclose(latent, ref_latent, atol=LATENT_TOL, rtol=LATENT_TOL)
    eng = Engine(PCFG, params, batch_size=4, mesh=mesh)
    eng.set_adapter_bank(bank)
    rank0, rank1 = eng._lora_stacks[0]
    assert rank0["in_proj"]["b"].shape[-2] == rank1["in_proj"]["b"].shape[-2] == 64 // 2
    assert rank0["ff2"]["a"].shape[-1] == bank.stacks["ff2"]["a"].shape[-1] // 2
    assert torch.equal(torch.cat([rank0["out_proj"]["a"], rank1["out_proj"]["a"]], -1),
                       bank.stacks["out_proj"]["a"])
    got, _ = _bank_run(params, bank, mesh, 0.0)
    want = jax_banks(bits)
    gap = np.abs(got - want).max()
    assert gap <= AUDIO_TOL * 32767.0, gap  # 1e-4 in float audio
    apart = np.abs(got[0] - got[1]).max()
    assert apart > 1  # the adapter moves the audio
