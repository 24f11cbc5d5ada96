"""Per-slot LoRA serving in the port (the adapter bank in
``training/lora.py``, ``models/transformer.py``, ``runtime/engine.py`` and
``runtime/batcher.py``) against the JAX package, on the small config of
tests/test_tts.py with one weight set for both packages.  Every case of
tests/test_adapter_bank.py.

Bounds, float32 on the CPU:

* ``build_adapter_bank``'s stacks and scales bit-equal to the JAX package's
  from the same artifacts;
* the backbone with a bank row against the same backbone on the merged
  weights: 2e-4 + 1e-4 relative (tests/test_adapter_bank.py), and against
  the JAX package's bank path the same;
* a B=3 bank decode (one / two / base): each lane within 1e-4 in float
  audio of the JAX package's merged single stream (tests/test_tts.py);
* batcher lanes against the port's merged single stream: 1e-4
  (tests/test_batcher.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pocket_tts_tpu import weights as jweights
from pocket_tts_tpu.models import transformer as jtransformer
from pocket_tts_tpu.models.mimi import MimiPlans
from pocket_tts_tpu.ops.rope import rope_table as jrope_table
from pocket_tts_tpu.runtime.engine import Engine as JaxEngine
from pocket_tts_tpu.runtime.engine import GenParams as JaxGen
from pocket_tts_tpu.training import lora as jlora
from pocket_tts_tpu_torch import weights as tweights
from pocket_tts_tpu_torch.config import config_from_dict
from pocket_tts_tpu_torch.models import transformer
from pocket_tts_tpu_torch.ops.rope import rope_table
from pocket_tts_tpu_torch.runtime.batcher import ContinuousBatcher
from pocket_tts_tpu_torch.runtime.engine import Engine, GenParams
from pocket_tts_tpu_torch.training.lora import (
    LORA_DEFAULT_TARGETS,
    bankable_lora_targets,
    build_adapter_bank,
    init_lora,
    merge_lora,
    save_lora_params,
)
from pocket_tts_tpu_torch.tts import TTSModel
from tests.test_tts import CFG

torch.set_num_threads(1)
PCFG = config_from_dict(dataclasses.asdict(CFG))
TOL = 1e-4
TEXT = "The quick brown fox jumps over the lazy dog."


def _random_lora(params_fl, rank, seed, targets=LORA_DEFAULT_TARGETS):
    """Non-trivial factors (``init_lora`` zeroes b, an exact no-op)."""
    factors = init_lora(params_fl, rank, targets=targets, seed=seed)
    rng = np.random.default_rng(seed + 100)
    return {t: {"a": f["a"], "b": torch.from_numpy(
        rng.normal(0, 0.02, tuple(f["b"].shape)).astype(np.float32))}
        for t, f in factors.items()}


@pytest.fixture(scope="module")
def exported():
    plans = MimiPlans(CFG.mimi)
    jp = jweights.random_params(CFG, plans, seed=21)
    return jp, jweights.export_state_dict(jp, plans)


@pytest.fixture(scope="module")
def base(exported):
    return tweights.from_state_dict(exported[1], PCFG)


@pytest.fixture(scope="module")
def bank_paths(base, tmp_path_factory):
    d = tmp_path_factory.mktemp("adapters")
    l1 = _random_lora(base["flow_lm"], rank=2, seed=1)
    # another rank and a subset of the targets: rank padding and zero fill
    l2 = _random_lora(base["flow_lm"], rank=3, seed=2, targets=("tf/in_proj", "tf/ff1"))
    p1, p2 = d / "one.safetensors", d / "two.safetensors"
    save_lora_params(l1, p1, rank=2, alpha=4.0)
    save_lora_params(l2, p2, rank=3, alpha=3.0)
    return {"one": str(p1), "two": str(p2)}, {"one": (l1, 2, 4.0), "two": (l2, 3, 3.0)}


def _merged(base, loaded, name):
    if name is None:
        return base
    factors, rank, alpha = loaded[name]
    return {**base, "flow_lm": merge_lora(base["flow_lm"], factors, alpha=alpha, rank=rank)}


class TestBankBuild:
    def test_shapes_rows_scales(self, bank_paths):
        paths, loaded = bank_paths
        bank = build_adapter_bank(paths)
        assert bank.names == ("one", "two")
        assert set(bank.stacks) == {"in_proj", "out_proj", "ff1", "ff2"}
        a = bank.stacks["in_proj"]["a"]
        n_layers = loaded["one"][0]["tf/in_proj"]["a"].shape[0]
        assert a.shape[:2] == (n_layers, 2) and a.shape[-2] == 3  # rank padded to the max
        assert not bank.stacks["out_proj"]["a"][:, 1].any()  # "two" has no out_proj
        np.testing.assert_allclose(bank.row("one"), [4.0 / 2, 0.0])
        np.testing.assert_allclose(bank.row("two"), [0.0, 3.0 / 3])
        np.testing.assert_allclose(bank.row(None), [0.0, 0.0])
        with pytest.raises(KeyError):
            bank.row("nope")
        # bit-equal to the JAX package's bank from the same artifacts
        jbank = jlora.build_adapter_bank(paths)
        assert jbank.names == bank.names
        np.testing.assert_array_equal(jbank.scales, bank.scales)
        assert sorted(jbank.stacks) == sorted(bank.stacks)
        for k, f in bank.stacks.items():
            for leaf in ("a", "b"):
                np.testing.assert_array_equal(f[leaf].numpy(), np.asarray(jbank.stacks[k][leaf]))

    def test_rejects_unsupported_targets(self, base, tmp_path):
        """Bankability is the exact target set of the batched delta path, not
        a tf/ prefix: tf/norm1_w would stack and then be dropped at serving."""
        for targets in (("tf/in_proj", "input_w"), ("tf/in_proj", "tf/norm1_w")):
            factors = _random_lora(base["flow_lm"], rank=2, seed=3, targets=targets)
            p = tmp_path / "bad.safetensors"
            save_lora_params(factors, p, rank=2, alpha=2.0)
            with pytest.raises(ValueError, match="outside the batched"):
                build_adapter_bank({"bad": str(p)})
            assert not bankable_lora_targets([f"{t}/{leaf}" for t in targets
                                              for leaf in ("a", "b")])
        assert bankable_lora_targets([f"{t}/a" for t in LORA_DEFAULT_TARGETS])

    def test_empty(self):
        with pytest.raises(ValueError, match="at least one"):
            build_adapter_bank({})


def _inputs(b, t, seed):
    tcfg = PCFG.flow_lm.transformer
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, t, tcfg.d_model)).astype(np.float32)
    shape = (tcfg.num_layers, b, 16, tcfg.num_heads, tcfg.head_dim)
    return x, shape


def _port_forward(params_tf, x, shape, t_valid, lora=None, lora_w=None):
    tcfg = PCFG.flow_lm.transformer
    b, t = x.shape[:2]
    pos = torch.zeros((b,), dtype=torch.int32)
    cos, sin = rope_table(pos[:, None] + torch.arange(t)[None, :], tcfg.head_dim, tcfg.max_period)
    kc, vc = torch.zeros(shape), torch.zeros(shape)
    tv = None if t_valid is None else torch.full((b,), t_valid, dtype=torch.int32)
    y, _, _ = transformer.cache_forward(params_tf, tcfg.num_heads, kc, vc, pos,
                                        torch.from_numpy(x), cos[:, :, None, :],
                                        sin[:, :, None, :], t_valid=tv, lora=lora,
                                        lora_w=None if lora_w is None else torch.from_numpy(lora_w))
    return y.numpy()


class TestTransformerEquivalence:
    """``cache_forward`` with a one-hot bank row == ``cache_forward`` on the
    merged weights, as a prefill (T = 3, ``t_valid``) and as a decode step
    (T = 1); and == the JAX package's bank path on the same inputs."""

    @pytest.mark.parametrize("mode", ["prefill", "step"])
    @pytest.mark.parametrize("name", ["one", "two"])
    def test_matches_merged(self, exported, base, bank_paths, name, mode):
        paths, loaded = bank_paths
        bank = build_adapter_bank(paths)
        t, t_valid = (3, 3) if mode == "prefill" else (1, None)
        x, shape = _inputs(2, t, 7)
        w = np.broadcast_to(bank.row(name), (2, bank.n)).astype(np.float32)
        got = _port_forward(base["flow_lm"]["tf"], x, shape, t_valid, bank.stacks, w)
        want = _port_forward(_merged(base, loaded, name)["flow_lm"]["tf"], x, shape, t_valid)
        np.testing.assert_allclose(got, want, atol=2e-4, rtol=1e-4)
        # the JAX package's bank path on the same inputs
        tcfg = CFG.flow_lm.transformer
        pos = jnp.zeros((2,), jnp.int32)
        cos, sin = jrope_table(pos[:, None] + jnp.arange(t)[None, :], tcfg.head_dim,
                               tcfg.max_period)
        jbank = jlora.build_adapter_bank(paths)
        jy, _, _ = jtransformer.cache_forward(
            exported[0]["flow_lm"]["tf"], tcfg.num_heads, jnp.zeros(shape), jnp.zeros(shape),
            pos, jnp.asarray(x), cos[:, :, None, :], sin[:, :, None, :],
            t_valid=None if t_valid is None else jnp.full((2,), t_valid, jnp.int32),
            lora=jbank.stacks, lora_w=jnp.asarray(w))
        np.testing.assert_allclose(got, np.asarray(jy), atol=2e-4, rtol=1e-4)

    def test_zero_row_is_base(self, base, bank_paths):
        bank = build_adapter_bank(bank_paths[0])
        x, shape = _inputs(1, 2, 8)
        y0 = _port_forward(base["flow_lm"]["tf"], x, shape, None, bank.stacks,
                           np.zeros((1, bank.n), np.float32))
        y = _port_forward(base["flow_lm"]["tf"], x, shape, None)
        np.testing.assert_array_equal(y0, y)


class TestEngineE2E:
    """B = 3: lane 0 adapter "one", lane 1 the base, lane 2 adapter "two";
    each lane's temp-0 audio against the JAX package's merged single stream."""

    K = 8  # frames

    def _jax_single(self, params, tokens, n_tokens):
        eng = JaxEngine(CFG, params, batch_size=1)
        st = eng.new_state(1)
        empty = {"kc": jnp.zeros_like(st["kc"]), "vc": jnp.zeros_like(st["vc"]),
                 "pos": jnp.zeros((1,), jnp.int32)}
        st = eng.admit_prefill_slot(st, 0, empty, eng.pad_token_row(tokens), n_tokens)
        st, _, audio, _ = eng.decode_frames(st, jax.random.PRNGKey(0), self.K,
                                            JaxGen(temp=0.0))
        return eng.wire_to_float(audio)[0]

    def test_mixed_batch_matches_merged(self, exported, base, bank_paths):
        paths, _ = bank_paths
        bank = build_adapter_bank(paths)
        eng = Engine(PCFG, base, "cpu", batch_size=3)
        eng.set_adapter_bank(bank)
        rng = np.random.default_rng(5)
        toks = [rng.integers(1, 40, size=(1, n)).astype(np.int32) for n in (5, 4, 6)]
        names = ["one", None, "two"]
        st = eng.new_state(3)
        empty = eng.new_state(1)
        rows = np.stack([bank.row(n) for n in names])
        for i in range(3):
            st = eng.admit_prefill_slot(st, i, empty, eng.pad_token_row(toks[i]),
                                        toks[i].shape[1], lora_row=rows[i])
        st, audio, _ = eng.decode_frames(st, self.K, GenParams(temp=0.0), torch.Generator(),
                                         lora_w=rows)
        audio = eng.wire_to_float(audio.numpy())
        jbase = exported[0]
        jfac = {n: jlora.load_lora_params(p) for n, p in paths.items()}
        for i, name in enumerate(names):
            jparams = jbase if name is None else {**jbase, "flow_lm": jlora.merge_lora(
                jbase["flow_lm"], jfac[name][0], alpha=jfac[name][2], rank=jfac[name][1])}
            want = self._jax_single(jparams, toks[i], toks[i].shape[1])
            assert audio[i].shape == want.shape
            assert np.abs(audio[i] - want).max() <= TOL, f"lane {i} ({name})"

    def test_lora_w_without_bank_raises(self, base):
        eng = Engine(PCFG, base, "cpu", batch_size=2)
        st = eng.new_state(2)
        with pytest.raises(ValueError, match="set_adapter_bank"):
            eng.decode_frames(st, 2, GenParams(temp=0.0), torch.Generator(),
                              lora_w=np.zeros((2, 1), np.float32))
        with pytest.raises(ValueError, match="set_adapter_bank"):
            eng.admit_prefill_slot(st, 0, eng.new_state(1),
                                   eng.pad_token_row(np.ones((1, 2), np.int32)), 2,
                                   lora_row=np.zeros(1, np.float32))


class TestBatcherAdapters:
    """Concurrent requests for different adapters ride one decode loop."""

    def _model(self, params):
        return TTSModel(PCFG, params, gen=GenParams(temp=0.0), has_real_weights=False,
                        device="cpu")

    def test_concurrent_mixed_adapters_match_merged(self, base, bank_paths):
        paths, loaded = bank_paths
        model = self._model(base)
        b = ContinuousBatcher(model, batch_size=3, chunk_frames=4,
                              adapter_bank=build_adapter_bank(paths))
        b.start()
        names = ["one", None, "two"]
        try:
            outs = [b.submit(TEXT, adapter=n, latency_sensitive=False) for n in names]
            got = [b._drain(o) for o in outs]
        finally:
            b.stop()
        refs = []
        for i, name in enumerate(names):
            want = self._model(_merged(base, loaded, name)).generate_with_pauses(TEXT)
            refs.append(want)
            assert got[i].shape == want.shape, f"lane {i} ({name})"
            np.testing.assert_allclose(got[i], want, rtol=0, atol=TOL,
                                       err_msg=f"lane {i} ({name})")
        n = min(len(refs[0]), len(refs[1]))  # the adapters change the audio
        assert not np.allclose(refs[0][:n], refs[1][:n], atol=2e-3)

    def test_generate_batch_per_item_adapters(self, base, bank_paths):
        paths, loaded = bank_paths
        model = self._model(base)
        b = ContinuousBatcher(model, batch_size=3, chunk_frames=4,
                              adapter_bank=build_adapter_bank(paths))
        b.start()
        try:
            got = b.generate_batch([TEXT] * 3, adapters=["one", None, "two"])
        finally:
            b.stop()
        for i, name in enumerate(["one", None, "two"]):
            want = self._model(_merged(base, loaded, name)).generate_with_pauses(TEXT)
            np.testing.assert_allclose(got[i], want, rtol=0, atol=TOL, err_msg=str(name))

    def test_unknown_or_bankless_adapter_raises(self, base, bank_paths):
        model = self._model(base)
        b = ContinuousBatcher(model, batch_size=2, chunk_frames=4)
        with pytest.raises(ValueError, match="no adapter bank"):
            b.submit(TEXT, adapter="one")
        b2 = ContinuousBatcher(model, batch_size=2, chunk_frames=4,
                               adapter_bank=build_adapter_bank(bank_paths[0]))
        with pytest.raises(KeyError, match="nope"):
            b2.submit(TEXT, adapter="nope")
