"""LFM2-MoE as the FlowLM backbone of the port (``models/lfm2.py``,
``kernels/moe.py``, the engine's conv state), held against the plain float32
reference ``reference_torch/lfm2_flowlm.py`` (and its benchmark copy, which
adds Pocket's codec, for audio) on the CPU at a tiny size: hidden 64, 8 query
/ 2 KV heads, the layer pattern conv conv attn conv attn conv with the first
2 dense, 8 experts top-2, 3 conv taps, seeded random weights.

Tolerances: the port on the CPU runs float32 (``compute_dtype`` "auto"), the
reference float32 with the same weights; they differ only in the order of
float32 sums (matmuls blocked differently, RMSNorm fused, the experts summed
per token instead of per expert), ~1e-6 relative after 6 layers.  The bound
1e-4 (relative to the largest magnitude) leaves two orders of room above that,
and a run of the port in bfloat16 (the next precision down, 8 mantissa bits)
misses it by far (``test_bfloat16_port_fails_the_tolerance``).  Audio: the
repository's bound for the flagship's whole slice against its reference,
relative L2 gap under 1e-4 and at most 16 int16 LSB anywhere
(benchmark/tests/test_bench_reference.py), since the codec after the FlowLM
is the flagship's."""

import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from pocket_tts_tpu_torch import utils
from pocket_tts_tpu_torch import weights as tweights
from pocket_tts_tpu_torch.config import config_from_dict
from pocket_tts_tpu_torch.kernels import moe
from pocket_tts_tpu_torch.models import flow_lm, flow_mlp, lfm2
from pocket_tts_tpu_torch.runtime.batcher import batched_tts
from pocket_tts_tpu_torch.runtime.engine import Engine, GenParams, place_params
from pocket_tts_tpu_torch.server import app
from pocket_tts_tpu_torch.tts import TTSModel
from reference_torch import lfm2_flowlm as ref
from tests.test_tts import CFG

BENCH = Path(__file__).resolve().parents[1] / "benchmark"
BACKBONE = dict(hidden_size=64, num_hidden_layers=6, num_attention_heads=8,
                num_key_value_heads=2, layer_types=["conv", "conv", "full_attention", "conv",
                                                    "full_attention", "conv"],
                conv_L_cache=3, intermediate_size=96, moe_intermediate_size=32, num_experts=8,
                num_experts_per_tok=2, num_dense_layers=2)


def _cfg(**runtime):
    d = dataclasses.asdict(CFG)
    d["flow_lm"]["backbone"] = dict(BACKBONE)
    d["runtime"].update(runtime)
    return config_from_dict(d)


PCFG = _cfg()
BB = PCFG.flow_lm.backbone
S = ref.sizes(dataclasses.asdict(BB))
TOL = 1e-4
INF = float("inf")


def _close(got, want, tol=TOL) -> float:
    """max |got - want| over max |want|; asserted below ``tol``."""
    err = ((got.float() - want.float()).abs().max() / want.float().abs().max()).item()
    assert err < tol, err
    return err


@pytest.fixture(scope="module")
def params():
    return tweights.from_state_dict(tweights.random_state_dict(PCFG, 5), PCFG)


@pytest.fixture(scope="module")
def model(params):
    return TTSModel(PCFG, params, gen=GenParams(temp=0.0, eos_threshold=1e9),
                    has_real_weights=False, device="cpu", seed=1)


def _placed(params, dtype=torch.float32):
    return place_params(params, torch.device("cpu"), dtype, torch.float32)["flow_lm"]


def _stack(fl, x, dtype=torch.float32, t_valid=None, state=None, pos=None):
    """The port's layer stack over x [1, T, D] from ``pos`` (0) on ``state``
    (fresh): (y [1, T, D] after embedding_norm, EOS logits [T], state)."""
    state = state or lfm2.init_state(BB, 1, 64, dtype, dtype, "cpu")
    pos = torch.zeros(1, dtype=torch.int32) if pos is None else pos
    y = lfm2.forward(fl["lfm"], BB, state["kc"], state["vc"], state["cs"], pos,
                     x.to(dtype), t_valid=t_valid)
    h = lfm2.final_norm(fl["lfm"], BB, y)
    return h, h[0] @ fl["out_eos_w"][0] + fl["out_eos_b"][0], state


def _seq(t, seed=0):
    return torch.randn((t, BB.hidden_size), generator=torch.Generator().manual_seed(seed))


# -- (a) the full-sequence stack and the EOS logit ------------------------------------


def test_full_sequence_backbone_and_eos_match_reference(params):
    fl = _placed(params)
    x = _seq(20)
    h, eos, _ = _stack(fl, x[None], t_valid=torch.tensor([20]))
    want_h, want_eos = ref.flowlm(params["flow_lm"], S, x)
    _close(h[0], want_h)
    _close(eos, want_eos)


def test_bfloat16_port_fails_the_tolerance(params):
    """The same stack with weights, activations and state in bfloat16 misses
    the float32 bound: the tests can tell the configuration's precision from
    the next one down."""
    fl = _placed(params, torch.bfloat16)
    x = _seq(20)
    h, _, _ = _stack(fl, x[None], torch.bfloat16, t_valid=torch.tensor([20]))
    want_h, _ = ref.flowlm(params["flow_lm"], S, x)
    err = ((h[0].float() - want_h).abs().max() / want_h.abs().max()).item()
    assert err > 10 * TOL


# -- (b) prefill, then decode through the KV and conv state ---------------------------


def test_prefill_then_decode_matches_the_full_forward_at_every_position(params):
    """A conditioning prefill in two pieces, then one frame at a time through
    ``flow_lm.step``: the conditioning vector and the EOS logit of every
    decoded position, and the greedy latents, against the reference's full
    causal pass per frame."""
    fl = _placed(params)
    cond, tokens, n = _seq(9, 1), [5, 17, 300, 2, 41], 6
    state = lfm2.init_state(BB, 1, 64, torch.float32, torch.float32, "cpu")
    pos = torch.zeros(1, dtype=torch.int32)
    text = flow_lm.embed_text(fl, torch.tensor([tokens]))
    for piece in (cond[None, :4], cond[None, 4:], text):
        _, _, pos = flow_lm.prefill(fl, PCFG, state["kc"], state["vc"], pos, piece,
                                    torch.tensor([piece.shape[1]]), cs=state["cs"])
    want_lat, want_h = ref.latents(params["flow_lm"], S, cond, tokens, n)
    table = flow_mlp.time_embedding_table(fl["flow"], 1)
    latent = fl["bos_emb"][None]
    for i in range(n):
        # the step's conditioning vector, on a copy of the state
        probe = {k: v.clone() for k, v in state.items()}
        x = latent @ fl["input_w"].T
        h = lfm2.final_norm(fl["lfm"], BB, lfm2.forward(fl["lfm"], BB, probe["kc"], probe["vc"],
                                                       probe["cs"], pos, x[:, None])[:, -1])
        _close(h[0], want_h[i])
        latent, eos, _, _, pos = flow_lm.step(fl, PCFG, state["kc"], state["vc"], pos, latent,
                                              torch.zeros_like(latent), table, 1, cs=state["cs"])
        _close(eos, want_h[i] @ fl["out_eos_w"][0] + fl["out_eos_b"][0])
        _close(latent[0], want_lat[i])
    assert int(pos) == 9 + len(tokens) + n


# -- (c) a padded prefill -------------------------------------------------------------


def test_a_padded_prefill_leaves_the_unpadded_state(params):
    fl = _placed(params)
    x = _seq(12, 2)[None]
    pos0 = torch.tensor([3], dtype=torch.int32)
    base = lfm2.init_state(BB, 1, 64, torch.float32, torch.float32, "cpu")
    _stack(fl, _seq(3, 3)[None], t_valid=torch.tensor([3]), state=base)
    padded = {k: v.clone() for k, v in base.items()}
    _stack(fl, x, t_valid=torch.tensor([5]), state=padded, pos=pos0)
    plain = {k: v.clone() for k, v in base.items()}
    _stack(fl, x[:, :5], t_valid=torch.tensor([5]), state=plain, pos=pos0)
    assert torch.equal(padded["cs"], plain["cs"])
    assert not torch.equal(plain["cs"], base["cs"])
    for k in ("kc", "vc"):
        assert torch.equal(padded[k][:, :, :8], plain[k][:, :, :8])
        assert not padded[k][:, :, 8:].any()
    # flow_lm.prefill at B = 1 with the host's count runs the valid positions
    # alone: the same state (float32 sums over 5 rows instead of 12: 1e-6)
    cut = {k: v.clone() for k, v in base.items()}
    _, _, pos = flow_lm.prefill(fl, PCFG, cut["kc"], cut["vc"], pos0, x, torch.tensor([5]),
                                cs=cut["cs"], positions=5)
    assert int(pos) == 8
    for k in ("kc", "vc", "cs"):
        assert torch.allclose(cut[k], padded[k], rtol=1e-5, atol=1e-6), k


# -- (d) voice snapshots and lane admission -------------------------------------------


def _voice(model, seconds=1.0, seed=4):
    wav = np.random.default_rng(seed).standard_normal(int(24000 * seconds)).astype(np.float32)
    return model.get_voice_state_from_audio(0.1 * wav)


def test_snapshot_reset_decode_equals_a_fresh_prefill(model):
    eng, gen = model.engine, model.gen
    vs = _voice(model)
    assert vs.cs is not None and vs.cs.shape == (4, 1, 64, 2)
    tokens = np.array([[7, 8, 9, 10]], np.int32)

    def decode(state):
        state = eng.prefill_tokens(state, tokens, 4)
        _, audio, _ = eng.decode_frames(state, 5, gen, torch.Generator().manual_seed(0))
        return audio

    a = decode(eng.reset_for_segment(vs.as_dict()))
    cond, n = eng.encode_voice(0.1 * np.random.default_rng(4).standard_normal(24000)
                               .astype(np.float32))
    fresh = eng.prefill_conditioning(eng.new_state(), cond, n)
    assert torch.equal(a, decode(fresh))
    assert torch.equal(a, decode(eng.reset_for_segment(vs.as_dict())))  # the snapshot kept


def test_admit_slot_writes_its_lane_only(model):
    eng = Engine(PCFG, model.engine.params, "cpu", batch_size=4)
    gen = GenParams(temp=0.7)
    state = eng.new_state()
    state = eng.prefill_tokens(state, np.array([[3, 4, 5]] * 4, np.int32), 3)
    state, _, _ = eng.decode_frames(state, 3, gen, torch.Generator().manual_seed(2))
    before = {k: v.clone() for k, v in state.items() if k != "mimi"}
    mimi_before = {k: v.clone() for k, v in state["mimi"].items() if torch.is_tensor(v)}
    vs = _voice(model)
    state = eng.admit_slot(state, 2, vs.as_dict())
    others = [0, 1, 3]
    for k, v in before.items():
        axis = 1 if k in ("kc", "vc", "cs") else 0
        assert torch.equal(v.index_select(axis, torch.tensor(others)),
                           state[k].index_select(axis, torch.tensor(others))), k
    for k, v in mimi_before.items():
        assert torch.equal(v[:, others] if k in ("kc", "vc") else v[others],
                           state["mimi"][k][:, others] if k in ("kc", "vc")
                           else state["mimi"][k][others]), k
    for k in ("kc", "vc", "cs"):
        assert torch.equal(state[k][:, 2:3], getattr(vs, k))
    assert int(state["pos"][2]) == vs.length


# -- (e) the entry points against the reference's audio -------------------------------


@pytest.fixture(scope="module")
def bench_ref():
    sys.path.insert(0, str(BENCH))
    from reference import lfm2_flowlm as bref

    return bref


def _bench_cfg():
    """The tiny configuration in the benchmark's file layout."""
    d = dataclasses.asdict(CFG)
    return {**{k: v for k, v in BACKBONE.items()}, "rope_theta": 1e6, "norm_eps": 1e-5,
            "norm_topk_prob": True, "routed_scaling_factor": 1.0,
            "flow_lm": {"flow": d["flow_lm"]["flow"],
                        "lookup_table": {"dim": 64, "n_bins": d["flow_lm"]["lookup_table"]
                                         ["n_bins"]}},
            "mimi": d["mimi"]}


def _reference_pcm(bref, params, wav, text):
    from pocket_tts_tpu_torch import text as pt

    cfg = _bench_cfg()
    s = bref.sizes(cfg)
    prepared, _ = pt.prepare_text_prompt(text)
    tokens = pt.load_tokenizer(None).encode(prepared)
    n = pt.max_generation_frames(prepared)
    cond = bref.voice_conditioning(params, s, wav)
    lat = bref.latents(params, s, cond, tokens, n)
    return bref.wire_pcm(bref.decode_audio(params, s, lat)).astype(np.int64)


def _assert_pcm(got: np.ndarray, want: np.ndarray) -> None:
    got = np.rint(got.astype(np.float64) * 32767).astype(np.int64)
    assert got.shape == want.shape
    diff = (got - want).astype(np.float64)
    assert np.sqrt(np.square(diff).sum() / np.square(want).sum()) < 1e-4
    assert np.abs(diff).max() <= 16


WAV = (0.1 * np.random.default_rng(6).standard_normal(24000)).astype(np.float32)
TEXT = "the cat sat down"


def test_generate_stream_and_decode_segment_match_reference_audio(model, params, bench_ref):
    want = _reference_pcm(bench_ref, params, WAV, TEXT)
    vs = model.get_voice_state_from_audio(WAV)
    _assert_pcm(np.concatenate(list(model.generate_stream(TEXT, vs))), want)
    segment = model.engine.decode_segment
    calls = []
    model.engine.decode_segment = lambda *a, **k: calls.append(1) or segment(*a, **k)
    try:
        _assert_pcm(model.generate(TEXT, vs), want)  # the fused segment (finite threshold)
    finally:
        del model.engine.decode_segment
    assert calls


def test_batched_tts_matches_reference_audio(model, params, bench_ref):
    want = _reference_pcm(bench_ref, params, WAV, TEXT)
    vs = model.get_voice_state_from_audio(WAV)
    batcher = batched_tts(model, batch_size=2, chunk_frames=4)
    try:
        outs = batcher.generate_batch([TEXT, TEXT], voices=[vs, vs])
    finally:
        batcher.stop()
    for out in outs:
        _assert_pcm(out, want)


def test_the_two_reference_copies_agree(params, bench_ref):
    x = _seq(16, 7)
    want, _ = ref.flowlm(params["flow_lm"], S, x)
    got = bench_ref.backbone(params["flow_lm"]["lfm"], bench_ref.sizes(_bench_cfg()), x)
    assert torch.equal(got, want)


# -- (f) the MoE layer against a dense loop over every expert -------------------------


def _dense_moe(x, router, bias, up, down, topk, norm):
    """Every expert on every token; each token keeps its top-k (by score +
    bias) weighted by the unbiased scores."""
    f = up.shape[1] // 2
    scores = torch.sigmoid(x @ router.T)
    ids = (scores + bias).topk(topk, dim=-1).indices
    keep = torch.zeros_like(scores).scatter(1, ids, 1.0)
    w = scores * keep
    if norm:
        w = w / (w.sum(-1, keepdim=True) + 1e-6)
    out = torch.zeros_like(x)
    for e in range(router.shape[0]):
        h = torch.nn.functional.silu(x @ up[e, :f].T) * (x @ up[e, f:].T)
        out += w[:, e:e + 1] * (h @ down[e].T)
    return out


@pytest.mark.parametrize("norm", [True, False])
def test_moe_matches_a_dense_loop_over_every_expert(params, norm):
    p = _placed(params)["lfm"]
    x = _seq(30, 8)
    bias = p["expert_bias"][0]
    ids, w = moe.route(x, p["router"][0], bias, 2, norm)
    got = moe.experts(x, ids, w, p["experts_up"][0], p["experts_down"][0])
    want = _dense_moe(x, p["router"][0], bias, p["experts_up"][0], p["experts_down"][0], 2, norm)
    _close(got, want)
    if norm:
        assert torch.allclose(w.sum(-1), torch.ones(30), atol=1e-5)
    # the bias moves choices, never weights: the weights are the unbiased scores
    ids0, _ = moe.route(x, p["router"][0], None, 2, norm)
    assert not torch.equal(ids0, ids)
    scores = torch.sigmoid(x @ p["router"][0].T)
    raw = scores.gather(-1, ids.long())
    assert torch.allclose(w, raw / (raw.sum(-1, keepdim=True) + 1e-6) if norm else raw)


def test_the_moe_layer_of_the_stack_matches_the_reference(params):
    p = _placed(params)["lfm"]
    h = _seq(25, 9)
    ids, w = moe.route(h, p["router"][1], p["expert_bias"][1], S.topk, S.norm_topk)
    got = moe.experts(h, ids, w, p["experts_up"][1], p["experts_down"][1])
    _close(got, ref.moe(params["flow_lm"]["lfm"], 1, S, h, ref.F32))


def test_route_counts_valid_slots_only():
    g = torch.Generator().manual_seed(3)
    x, router = torch.randn(6, 16, generator=g), torch.randn(4, 16, generator=g)
    slots = torch.zeros(4, dtype=torch.int64)
    valid = torch.tensor([True, True, False, True, False, False])
    ids, _ = moe.route(x, router, None, 2, slots=slots, valid=valid)
    assert int(slots.sum()) == 2 * 3
    assert torch.equal(slots, torch.bincount(ids[valid].flatten().long(), minlength=4))


# -- (g) the paths that refuse the backbone -------------------------------------------


def test_unsupported_paths_refuse_the_backbone(model, monkeypatch):
    from pocket_tts_tpu_torch import tts
    from pocket_tts_tpu_torch.parallel.mesh import make_mesh
    from pocket_tts_tpu_torch.runtime.quantize import quantize_model
    from pocket_tts_tpu_torch.training import lora, trainer
    from pocket_tts_tpu_torch.training.loss import flow_matching_loss

    monkeypatch.setattr(tts, "load_variant", lambda variant: PCFG)
    calls = [
        lambda: quantize_model(model),
        lambda: TTSModel.load_quantized("x.safetensors", variant="tiny", device="cpu"),
        lambda: Engine(PCFG, model.engine.params, "cpu",
                       mesh=make_mesh(2, tp=2, devices=[torch.device("cpu")] * 2)),
        lambda: model.engine.set_adapter_bank(None),
        lambda: trainer.make_train_step(PCFG, trainer.make_optimizer()),
        lambda: trainer.finetune(model, []),
        lambda: trainer.apply_adapted(model, "x.safetensors"),
        lambda: lora.make_lora_train_step(PCFG, trainer.make_optimizer(), alpha=1.0, rank=1),
        lambda: lora.apply_lora(model, "x.safetensors"),
        lambda: flow_matching_loss(model.params["flow_lm"], PCFG, {}),
    ]
    for call in calls:
        with pytest.raises(ValueError, match="lfm2_moe"):
            call()


# -- spans and counters ---------------------------------------------------------------


def test_spans_and_expert_slots_count_lane_frames_and_positions(model):
    eng = Engine(PCFG, model.engine.params, "cpu", batch_size=3)
    before = utils.span_totals()

    def grew(name):
        now = utils.span_totals()
        return now[name]["n"] - before.get(name, {"n": 0})["n"]

    state = eng.prefill_tokens(eng.new_state(), np.array([[3, 4, 5, 6]] * 3, np.int32),
                               np.array([4, 2, 0]))
    assert grew("flow_lm.prefill") == 6
    state, _, _ = eng.decode_frames(state, 5, GenParams(temp=0.7),
                                    torch.Generator().manual_seed(0))
    assert grew("flow_lm.backbone") == 3 * 5
    per_layer = eng.expert_slots.sum(-1)
    assert torch.equal(per_layer, torch.full((BB.moe_layers,), 2 * (6 + 15)))
    model.engine.expert_slots.zero_()
    model.generate("hello", _voice(model))
    st = app.ServerState(model)
    try:
        lines = app.metrics_text(st).splitlines()
    finally:
        st.pool.shutdown()
    slots = {ln.split(" ")[0]: int(ln.split(" ")[1]) for ln in lines
             if ln.startswith("pocket_tts_expert_slots_total{")}
    assert len(slots) == BB.moe_layers * BB.num_experts
    assert sum(slots.values()) == int(model.engine.expert_slots.sum()) > 0
    for name in ("flow_lm.backbone", "flow_lm.prefill"):
        assert any(ln.startswith(f'pocket_tts_span_count_total{{span="{name}"}}')
                   for ln in lines)


def test_checkpoint_round_trip_and_config_from_yaml(params, tmp_path, monkeypatch):
    """export_state_dict inverts from_state_dict for the hybrid backbone, and a
    variant YAML with a ``backbone`` mapping loads it."""
    sd = tweights.export_state_dict(params, PCFG)
    assert "flow_lm.backbone.layers.5.feed_forward.experts.7.w2.weight" in sd
    assert not any(k.startswith(("flow_lm.transformer.", "flow_lm.out_norm")) for k in sd)
    back = tweights.from_state_dict(sd, PCFG)
    for k, v in params["flow_lm"]["lfm"].items():
        assert torch.equal(back["flow_lm"]["lfm"][k], v), k
    from pocket_tts_tpu_torch.config import load_variant

    (tmp_path / "tiny_lfm2.yaml").write_text(
        "flow_lm:\n  backbone:\n    hidden_size: 64\n    num_hidden_layers: 6\n"
        "    num_attention_heads: 8\n    num_key_value_heads: 2\n"
        "    layer_types: [conv, conv, full_attention, conv, full_attention, conv]\n"
        "    intermediate_size: 96\n    moe_intermediate_size: 32\n    num_experts: 8\n"
        "    num_experts_per_tok: 2\n")
    monkeypatch.chdir(tmp_path)
    assert load_variant("tiny_lfm2").flow_lm.backbone == BB
