"""The port's dp x tp mesh (``parallel/mesh.py``, ``Engine(mesh=)``) against
the JAX package's (ports of tests/test_sharding.py).

The port's meshes repeat the CPU device (torch has one), so every shard,
reduction and dp group runs as on distinct devices while the copies between
them are no-ops; the JAX side runs on the 8 virtual CPU devices that
tests/conftest.py forces.  Both packages load one weight set:
``__graft_entry__.tiny_config(heads=8)`` random params -> the JAX package's
``export_state_dict`` -> the port's ``from_state_dict``.

Bounds (tests/test_sharding.py:82-86): int16 audio within 1 LSB and latents
within atol / rtol 1e-4, the port's mesh against its single-device engine at
temp 0.5 (the same noise draws) and against JAX's sharded and single-device
runs at temp 0 (the RNGs differ).  The flagship manifest is placement only,
on the meta device: no forward, no weight memory.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import __graft_entry__ as ge
import tests.test_torch_decode_attention as da_plan
import tests.test_torch_qlinear_plan as ql_plan
from pocket_tts_tpu import weights as jweights
from pocket_tts_tpu.config import load_variant as jload_variant
from pocket_tts_tpu.models.mimi import MimiPlans
from pocket_tts_tpu.parallel import mesh as jmesh
from pocket_tts_tpu.runtime.engine import Engine as JaxEngine
from pocket_tts_tpu.runtime.engine import GenParams as JaxGen
from pocket_tts_tpu.runtime.quantize import quantize_params as jquantize
from pocket_tts_tpu_torch import weights as tweights
from pocket_tts_tpu_torch.config import config_from_dict, load_variant
from pocket_tts_tpu_torch.ops.qtensor import QTensor
from pocket_tts_tpu_torch.parallel import mesh as tmesh
from pocket_tts_tpu_torch.runtime.engine import Engine, GenParams
from pocket_tts_tpu_torch.runtime.quantize import quantize_params

torch.set_num_threads(1)
JCFG = ge.tiny_config(heads=8)
PCFG = config_from_dict(dataclasses.asdict(JCFG))
CPU8 = [torch.device("cpu")] * 8
TOKENS = np.arange(1, 7, dtype=np.int32)[None]
LATENT_TOL = 1e-4


@pytest.fixture(scope="module")
def exported():
    jp = ge._build(JCFG)[1]
    return jp, tweights.from_state_dict(jweights.export_state_dict(jp, MimiPlans(JCFG.mimi)),
                                        PCFG)


def _lsb(a, b) -> int:
    assert a.shape == b.shape, (a.shape, b.shape)
    return int(np.abs(a.astype(np.int32) - b.astype(np.int32)).max())


def _port_run(params, mesh=None, batch=4, temp=0.5):
    """Prefill + one 2-frame chunk; (int16 audio [B, T], latent [B, ldim])."""
    eng = Engine(PCFG, params, None if mesh else "cpu", batch_size=batch, mesh=mesh)
    st = eng.prefill_tokens(eng.new_state(), np.tile(TOKENS, (batch, 1)), 6)
    st, audio, _ = eng.decode_frames(st, 2, GenParams(temp=temp), torch.Generator().manual_seed(0))
    return audio.numpy(), tmesh.gather(st["latent"], "cpu").numpy()


def _jax_run(params, mesh=None, batch=4, temp=0.0):
    """tests/test_sharding.py's _run_generation at ``temp``."""
    eng = JaxEngine(JCFG, params, batch_size=batch, mesh=mesh)

    def go():
        st = eng.new_state(batch)
        if mesh is not None:
            eng.params = jmesh.shard_params(eng.params, mesh)
            st = jmesh.shard_state(st, mesh)
        st = eng.prefill_tokens(st, np.tile(TOKENS, (batch, 1)), 6)
        st, _, audio, _ = eng.decode_frames(st, jax.random.PRNGKey(0), 2, JaxGen(temp=temp))
        return tuple(np.asarray(a) for a in jax.device_get((audio, st["latent"])))

    if mesh is None:
        return go()
    with mesh:
        return go()


def test_mesh_shapes():
    m = tmesh.make_mesh(8, devices=CPU8)
    assert m.shape["dp"] * m.shape["tp"] == 8 and m.shape["tp"] in (2, 4, 8)
    assert m.shape == dict(jmesh.make_mesh(8).shape)  # dp 2 x tp 4, JAX's choice
    for n in (1, 2, 4, 6):
        assert tmesh.make_mesh(n, devices=CPU8).shape == dict(jmesh.make_mesh(n).shape)
    m = tmesh.make_mesh(8, tp=2, devices=CPU8)
    assert m.devices.shape == (4, 2) and m.lead(3) == torch.device("cpu")
    with pytest.raises(ValueError, match="does not divide"):
        tmesh.make_mesh(6, tp=4, devices=CPU8)


def test_make_mesh_without_cuda_raises(monkeypatch):
    """No CUDA device and no devices=: raise, never fall back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmesh.make_mesh()


PARAM_NAMES = ["flow_lm/tf/ff1", "flow_lm/tf/ff2", "flow_lm/tf/in_proj", "flow_lm/tf/out_proj",
               "flow_lm/tf/norm1_w", "mimi/dec_tf/layers/in_proj", "mimi/enc_tf/layers/ff2",
               "mimi/dec_tf/layers/ls1", "mimi/dec_tf/output_proj", "flow_lm/flow/blocks/ada_w",
               "flow_lm/text_embed", "mimi/quantizer_w"]
STATE_NAMES = ["kc", "vc", "pos", "latent", "mimi/kc", "mimi/vc", "mimi/pos",
               "mimi/up/partial", "mimi/dec/0/prev"]


def test_param_sharding_rules():
    assert tmesh.param_sharding_rules(("flow_lm", "tf", "ff1")) == tmesh.Spec(None, "tp", None)
    assert tmesh.param_sharding_rules(("flow_lm", "tf", "ff2")) == tmesh.Spec(None, None, "tp")
    assert tmesh.param_sharding_rules(("flow_lm", "tf", "in_proj")) == \
        tmesh.Spec(None, None, "tp", None)
    assert tmesh.param_sharding_rules(("flow_lm", "tf", "out_proj")) == \
        tmesh.Spec(None, None, "tp")
    assert tmesh.param_sharding_rules(("flow_lm", "tf", "norm1_w")) == tmesh.Spec()
    for name in PARAM_NAMES:  # name by name, as JAX's, printed as JAX's
        want = jmesh.param_sharding_rules(tuple(name.split("/")), None)
        assert str(tmesh.param_sharding_rules(name)) == str(want), name
    for name in STATE_NAMES:
        want = jmesh.state_sharding_rules(tuple(name.split("/")))
        assert str(tmesh.state_sharding_rules(name)) == str(want), name
    assert str(tmesh.Spec("dp")) == str(P("dp")) and str(tmesh.Spec()) == str(P())


@pytest.mark.parametrize("tp", [2, 4, 8])
def test_fit_spec_drops_axes_as_jax(tp):
    tm, jm = tmesh.make_mesh(8, tp=tp, devices=CPU8), jmesh.make_mesh(8, tp=tp)
    for spec, shape in [(("dp", None, None, "tp", None), (2, 4, 64, 8, 16)),
                        ((None, "dp", None, "tp", None), (2, 2, 47, 4, 8)),
                        ((None, None, "tp", None), (2, 3, 32, 32)), (("dp",), (3,)),
                        ((None, "tp"), (2, 6)), ((None, None, "tp"), (2, 3))]:
        assert str(tmesh._fit_spec(tmesh.Spec(*spec), shape, tm)) == \
            str(jmesh._fit_spec(P(*spec), shape, jm)), (spec, shape)


@pytest.mark.parametrize("tp", [2, 4, 8])
def test_sharded_equals_single_device(exported, tp):
    """A wrong but finite layout must not pass: dp x tp over 8 (repeated)
    devices against the single device, the port's and JAX's."""
    jp, tparams = exported
    mesh = tmesh.make_mesh(8, tp=tp, devices=CPU8)
    batch = 4 if mesh.shape["dp"] <= 4 else 8
    ref_audio, ref_latent = _port_run(tparams, batch=batch)
    audio, latent = _port_run(tparams, mesh, batch=batch)
    assert _lsb(audio, ref_audio) <= 1
    np.testing.assert_allclose(latent, ref_latent, atol=LATENT_TOL, rtol=LATENT_TOL)
    audio0, latent0 = _port_run(tparams, mesh, batch=batch, temp=0.0)
    for j_audio, j_latent in (_jax_run(jp, jmesh.make_mesh(8, tp=tp), batch),
                              _jax_run(jp, None, batch)):
        assert _lsb(audio0, j_audio) <= 1
        np.testing.assert_allclose(latent0, j_latent, atol=LATENT_TOL, rtol=LATENT_TOL)


def test_state_placement_and_manifest_match_jax(exported):
    """shard_state / sharding_manifest / format_shard_report against JAX's on
    the engine state at dp 2 x tp 4: each block its own allocation of the
    shard's shape, on its device."""
    jp, tparams = exported
    eng = Engine(PCFG, tparams, batch_size=4, mesh=tmesh.make_mesh(8, devices=CPU8))
    st = eng.new_state()
    jm = jmesh.make_mesh(8)
    want = jmesh.sharding_manifest(jmesh.shard_state(JaxEngine(JCFG, jp).new_state(4), jm))
    got = tmesh.sharding_manifest(st)
    assert got == {k: {**v, "shape": tuple(v["shape"])} for k, v in want.items()}
    assert tmesh.format_shard_report(st, 0) == jmesh.format_shard_report(
        jmesh.shard_state(JaxEngine(JCFG, jp).new_state(4), jm), 0)
    kc = st["kc"]
    assert [tuple(p.shape) for p in kc.blocks[1]] == [(2, 2, 64, 2, 16)] * 4
    ptrs = {p.data_ptr() for row in kc.blocks for p in row}
    assert len(ptrs) == 8 and all(p.is_contiguous() for row in kc.blocks for p in row)
    assert len(st["pos"].blocks[0]) == 1  # not split on tp: on the group's lead
    whole = tmesh.gather(st, "cpu")
    assert whole["kc"].shape == (2, 4, 64, 8, 16) and whole["mimi"]["kc"].shape[1] == 4


def test_dp_sharded_batched_admission(exported):
    """The serving tier's admission over the dp axis: admit_prefill_slot of
    two requests with different voice snapshots and texts into slots 0 and
    2 (one per dp group), 1 and 3 idle, then decode: each lane against the
    single-device engine slot for slot, the two requests different; and at
    temp 0 against JAX's single-device admission."""
    jp, tparams = exported
    batch = 4
    ve = Engine(PCFG, tparams, "cpu")

    def voice(toks):
        st = ve.prefill_tokens(ve.new_state(1), toks, toks.shape[1])
        return {k: st[k] for k in ("kc", "vc", "pos")}

    vs_a, vs_b = voice(np.arange(1, 7, dtype=np.int32)[None]), voice(
        np.arange(3, 11, dtype=np.int32)[None])
    text = np.zeros((batch, 6), np.int32)
    text[0] = np.arange(10, 16)
    text[1, :4] = np.arange(20, 24)

    def run(mesh, temp):
        eng = Engine(PCFG, tparams, None if mesh else "cpu", batch_size=batch, mesh=mesh)
        st = eng.new_state()
        st = eng.admit_prefill_slot(st, 0, vs_a, eng.pad_token_row(text[0:1, :6]), 6)
        st = eng.admit_prefill_slot(st, 2, vs_b, eng.pad_token_row(text[1:2, :4]), 4)
        _, audio, _ = eng.decode_frames(st, 2, GenParams(temp=temp),
                                        torch.Generator().manual_seed(7))
        return audio.numpy()

    mesh = tmesh.make_mesh(8, devices=CPU8)  # dp 2 x tp 4
    ref, sh = run(None, 0.5), run(mesh, 0.5)
    assert _lsb(sh, ref) <= 1
    assert np.abs(ref[0].astype(np.int32) - ref[2].astype(np.int32)).max() > 1

    jeng = JaxEngine(JCFG, jp, batch_size=batch)
    jvs = {k: np.asarray(v.numpy()) for k, v in vs_a.items()}, {
        k: np.asarray(v.numpy()) for k, v in vs_b.items()}
    jst = jeng.new_state(batch)
    jst = jeng.admit_prefill_slot(jst, 0, jvs[0], jeng.pad_token_row(text[0:1, :6]), 6)
    jst = jeng.admit_prefill_slot(jst, 2, jvs[1], jeng.pad_token_row(text[1:2, :4]), 4)
    _, _, jaudio, _ = jeng.decode_frames(jst, jax.random.PRNGKey(7), 2, JaxGen(temp=0.0))
    assert _lsb(run(mesh, 0.0), np.asarray(jaudio)) <= 1


def _to_meta(tree):
    """A param tree with every tensor on the meta device: shapes and dtypes
    only, no weight memory."""
    if isinstance(tree, dict):
        return {k: _to_meta(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_meta(v) for v in tree]
    return tree.to("meta") if torch.is_tensor(tree) else tree


@pytest.fixture(scope="module")
def flagship_meta():
    cfg = load_variant("b6369a24")
    return _to_meta(tweights.from_state_dict(tweights.random_state_dict(cfg, 0), cfg))


FLAGSHIP_SHARDED = [
    "flow_lm/tf/in_proj", "flow_lm/tf/out_proj", "flow_lm/tf/ff1", "flow_lm/tf/ff2",
    "mimi/enc_tf/layers/in_proj", "mimi/enc_tf/layers/out_proj",
    "mimi/enc_tf/layers/ff1", "mimi/enc_tf/layers/ff2",
    "mimi/dec_tf/layers/in_proj", "mimi/dec_tf/layers/out_proj",
    "mimi/dec_tf/layers/ff1", "mimi/dec_tf/layers/ff2",
]


@pytest.mark.parametrize("tp", [2, 4, 8])
def test_flagship_sharding_manifest(flagship_meta, tp):
    """Guard against silent de-sharding at the flagship's dims: the twelve
    transformer products of tests/test_sharding.py:182-189 are split at
    every tp, and every leaf's spec is the one JAX's rules and _fit_spec
    give its shape (placement only, on meta devices)."""
    assert jload_variant("b6369a24").flow_lm.transformer.d_model == 1024
    mesh = tmesh.make_mesh(8, tp=tp, devices=[torch.device("meta")] * 8)
    man = tmesh.sharding_manifest(tmesh.shard_params(flagship_meta, mesh))
    missing = [k for k in FLAGSHIP_SHARDED if not man[k]["sharded"]]
    assert not missing, f"tp={tp}: silently de-sharded: {missing}"
    jm = jmesh.make_mesh(8, tp=tp)
    for name, info in man.items():
        want = jmesh._fit_spec(jmesh.param_sharding_rules(tuple(name.split("/")), None),
                               info["shape"], jm)
        assert info["spec"] == str(want), name
        assert info["sharded"] == (name in FLAGSHIP_SHARDED), name


@pytest.mark.parametrize("bits", [8, 4])
def test_quantized_params_shard_under_tp(exported, bits):
    """A QTensor's q takes its leaf's rule, in_proj's scale is split with it
    and ff2's (row-parallel) stays whole, as JAX's manifest of the same
    quantized tree says; quantized sharded generation against quantized
    single-device (a packed int4 ff2 split on its logical elements)."""
    jp, tparams = exported
    qparams = quantize_params(tparams, bits=bits)
    mesh = tmesh.make_mesh(8, tp=4, devices=CPU8)
    placed = tmesh.shard_params(qparams, mesh)
    qt = placed["flow_lm"]["tf"]["in_proj"]
    assert isinstance(qt, QTensor) and qt.q.sharded and qt.scale.sharded
    ff2 = placed["flow_lm"]["tf"]["ff2"]
    assert ff2.q.sharded and not ff2.scale.sharded
    want = jmesh.sharding_manifest(jmesh.shard_params(jquantize(jp, bits=bits),
                                                      jmesh.make_mesh(8, tp=4)))
    got = tmesh.sharding_manifest(placed)
    for name in [k for k in want if "/tf/" in k]:
        assert got[name]["spec"] == want[name]["spec"], name
        assert got[name]["sharded"] == want[name]["sharded"], name
        assert got[name]["shape"] == tuple(want[name]["shape"]), name
    ref, _ = _port_run(qparams)
    audio, _ = _port_run(qparams, mesh)
    assert _lsb(audio, ref) <= 1


def test_packed_int4_split_is_the_logical_block():
    """An int4 ff2 shard dequantizes to the same columns of the whole."""
    from pocket_tts_tpu_torch.ops.qtensor import quantize_array

    w = torch.randn(2, 16, 64, generator=torch.Generator().manual_seed(1))
    qt = quantize_array(w, channel_axes=2, bits=4)
    mesh = tmesh.make_mesh(4, tp=4, devices=CPU8)
    placed = tmesh.shard_params({"ff2": qt}, mesh)["ff2"]
    view = tmesh.group_view({"ff2": placed}, 0)["ff2"]
    whole = qt.dequant()
    for r, part in enumerate(view.parts):
        assert part.packed
        torch.testing.assert_close(part.dequant(), whole[..., 16 * r:16 * (r + 1)],
                                   rtol=0, atol=0)


def _shard_shapes(d, f, tp):
    """(N, K) of a layer's four products on one tp rank."""
    return [(3 * d // tp, d), (d, d // tp), (f // tp, d), (d, f // tp)]


# the backbone (d_model 1024, FFN 4096) and the Mimi transformers (512, 2048)
SHARD_NK = sorted({nk for tp in (2, 4, 8) for d, f in ((1024, 4096), (512, 2048))
                   for nk in _shard_shapes(d, f, tp)})


@pytest.mark.parametrize("fmt", sorted(ql_plan.FORMATS))
@pytest.mark.parametrize("n,k", SHARD_NK)
def test_qlinear_plans_at_every_flagship_shard_shape(n, k, fmt):
    """Both qlinear routes cover every row and K byte once, fit shared
    memory, and (tensor cores) take the same split at M 1 and 16."""
    ql_plan.test_plan_covers_every_row_and_k_once(n, k, fmt)
    ql_plan.test_plan_split_and_order_do_not_depend_on_m(n, k, fmt)
    ql_plan.test_plan_shared_memory_fits_a_block(n, k, fmt)
    ql_plan.test_f32_plan_covers_every_row_and_k_byte_once(n, k, fmt)
    ql_plan.test_f32_plan_fits_shared_memory_at_every_m(n, k, fmt)


@pytest.mark.parametrize("b", [1, 4, 16])
@pytest.mark.parametrize("h", [8, 4, 2])
def test_decode_attention_plans_at_every_head_shard(b, h):
    """The decode kernel's plan at a rank's 16 / tp heads: every (lane,
    head) once, shared memory within the limit for bf16 and e4m3 caches."""
    for kv in (torch.bfloat16, torch.float8_e4m3fn):
        da_plan.test_plan_covers_every_lane_and_head_once(b, 1024, h, 64, kv)
        da_plan.test_plan_shared_memory_fits_and_does_not_depend_on_b(b, 1024, h, 64, kv)


def test_mesh_engine_refuses_what_waits(exported):
    """What a mesh engine does not run raises: the staged codec beside a
    batch, a batch dp does not divide, a device that is not the mesh's."""
    _, tparams = exported
    eng = Engine(PCFG, tparams, batch_size=2, mesh=tmesh.make_mesh(2, devices=CPU8))
    with pytest.raises(ValueError, match="batch_size=1"):
        eng.enable_staged_codec("cpu")
    with pytest.raises(ValueError, match="multiple of the mesh's dp"):
        Engine(PCFG, tparams, batch_size=3, mesh=tmesh.make_mesh(4, tp=2, devices=CPU8))
    with pytest.raises(ValueError, match="mesh's first device"):
        Engine(PCFG, tparams, "meta", batch_size=2, mesh=tmesh.make_mesh(2, devices=CPU8))


@pytest.mark.parametrize("tp", [2, 8])
def test_mesh_engine_segment_voice_and_conditioning(exported, tp):
    """decode_segment (B = 1, dp 1), encode_voice (the Mimi encoder's
    transformer split on tp: by heads at tp 2, joined on the lead at tp 8,
    above its 4 heads) and prefill_conditioning on a mesh engine against the
    single-device engine (a cache of 512 leaves room for a voice prompt)."""
    _, tparams = exported
    cfg = dataclasses.replace(PCFG, runtime=dataclasses.replace(PCFG.runtime, max_seq=512))
    mesh = tmesh.make_mesh(tp, tp=tp, devices=CPU8)
    one, sh = Engine(cfg, tparams, "cpu"), Engine(cfg, tparams, mesh=mesh)
    wav = np.random.default_rng(3).standard_normal(5000).astype(np.float32) * 0.1
    (c1, n1), (c2, n2) = one.encode_voice(wav), sh.encode_voice(wav)
    assert n1 == n2
    np.testing.assert_allclose(c2.numpy(), c1.numpy(), atol=2e-4, rtol=0)
    voice = one.prefill_conditioning(one.new_state(), c1, n1)
    placed = tmesh.gather(sh.prefill_conditioning(sh.new_state(), c1, n1), "cpu")
    assert placed["pos"].tolist() == voice["pos"].tolist() == [n1]
    np.testing.assert_allclose(placed["kc"].numpy(), voice["kc"].numpy(), atol=1e-5, rtol=0)
    gen = GenParams(temp=0.5, eos_threshold=-1e9)
    outs = []
    for eng in (one, sh):  # a segment restarts from the one-device snapshot
        st = eng.prefill_tokens(eng.reset_for_segment(voice), TOKENS, 6)
        _, audio, n_valid, eos = eng.decode_segment(
            st, gen, torch.Generator().manual_seed(5), max_frames=4, frames_after_eos=2,
            bucket=8)
        outs.append((audio.numpy(), n_valid, eos))
    assert outs[0][1:] == outs[1][1:] and _lsb(outs[0][0], outs[1][0]) <= 1


def test_products_tp_does_not_divide_run_whole(exported):
    """_fit_spec drops tp per product: at tp 8 a backbone of d_model 20 (2
    heads) keeps in_proj / out_proj whole while its FFN (80) is split, and a
    Mimi FFN of 36 stays whole beside its split attention (32, 4 heads, so
    attended whole on the lead).  Such a layer runs its whole half on the
    lead: against one device at temp 0.5 and JAX's mesh at temp 0."""
    jcfg = dataclasses.replace(JCFG, flow_lm=dataclasses.replace(
        JCFG.flow_lm, transformer=dataclasses.replace(JCFG.flow_lm.transformer, d_model=20,
                                                      num_heads=2),
        lookup_table=dataclasses.replace(JCFG.flow_lm.lookup_table, dim=20)),
        mimi=dataclasses.replace(JCFG.mimi, transformer=dataclasses.replace(
            JCFG.mimi.transformer, dim_feedforward=36)))
    pcfg = config_from_dict(dataclasses.asdict(jcfg))
    jp = ge._build(jcfg)[1]
    tparams = tweights.from_state_dict(jweights.export_state_dict(jp, MimiPlans(jcfg.mimi)),
                                       pcfg)
    mesh = tmesh.make_mesh(8, tp=8, devices=CPU8)
    man = tmesh.sharding_manifest(Engine(pcfg, tparams, mesh=mesh).params)
    assert [man[f"flow_lm/tf/{k}"]["sharded"] for k in ("in_proj", "out_proj", "ff1", "ff2")] \
        == [False, False, True, True]
    assert [man[f"mimi/dec_tf/layers/{k}"]["sharded"]
            for k in ("in_proj", "out_proj", "ff1", "ff2")] == [True, True, False, False]

    def port(mesh_, temp):
        eng = Engine(pcfg, tparams, None if mesh_ else "cpu", batch_size=2, mesh=mesh_)
        st = eng.prefill_tokens(eng.new_state(), np.tile(TOKENS, (2, 1)), 6)
        _, audio, _ = eng.decode_frames(st, 2, GenParams(temp=temp),
                                        torch.Generator().manual_seed(0))
        return audio.numpy()

    assert _lsb(port(mesh, 0.5), port(None, 0.5)) <= 1
    jeng = JaxEngine(jcfg, jp, batch_size=2, mesh=jmesh.make_mesh(8, tp=8))
    with jeng.mesh:
        jeng.params = jmesh.shard_params(jeng.params, jeng.mesh)
        jst = jeng.prefill_tokens(jmesh.shard_state(jeng.new_state(2), jeng.mesh),
                                  np.tile(TOKENS, (2, 1)), 6)
        _, _, jaudio, _ = jeng.decode_frames(jst, jax.random.PRNGKey(0), 2, JaxGen(temp=0.0))
        jaudio = np.asarray(jax.device_get(jaudio))
    assert _lsb(port(mesh, 0.0), jaudio) <= 1
