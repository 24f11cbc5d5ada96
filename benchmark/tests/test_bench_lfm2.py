"""The LFM2-8B-A1B configuration's yardstick: its file against the
catalog's published config, the FLOP and byte counts behind ``lfm2_step.mfu``
and ``moe_experts_roofline`` against the reference's own weight shapes, and
the new readers on traces and span rings with and without what they read."""

from __future__ import annotations

import json
import types

import numpy as np
import pytest

from conftest import BENCH
from harness import costs_lfm2
from reference import lfm2_flowlm as ref

CFG = json.loads((BENCH / "configs" / "lfm2-8b-a1b-flowlm-bf16.json").read_text())
# LFM2-8B-A1B's config.json as the model catalog gives it
PUBLISHED = {"conv_L_cache": 3, "conv_bias": False, "hidden_size": 2048,
             "intermediate_size": 7168, "max_position_embeddings": 128000,
             "model_type": "lfm2_moe", "moe_intermediate_size": 1792, "norm_eps": 1e-05,
             "norm_topk_prob": True, "num_attention_heads": 32, "num_dense_layers": 2,
             "num_experts": 32, "num_experts_per_tok": 4, "num_hidden_layers": 24,
             "num_key_value_heads": 8, "rope_theta": 1000000, "routed_scaling_factor": 1,
             "use_expert_bias": True, "vocab_size": 65536}


def _load(name):
    from run import load_module

    return load_module(BENCH / "metrics" / f"{name}.py", "metric_" + name)


def test_the_file_holds_the_published_config_unchanged():
    for k, v in PUBLISHED.items():
        assert CFG[k] == v, k
    attn = [i for i, t in enumerate(CFG["layer_types"]) if t == "full_attention"]
    assert attn == [2, 6, 10, 14, 18, 21] and len(CFG["layer_types"]) == 24
    assert CFG["reduced"] == [] and CFG["flow_lm"]["lookup_table"]["dim"] == 2048


def test_backbone_flops_are_two_a_weight_of_what_a_token_reads():
    s = ref.sizes(CFG)
    total, experts = 0, {"flow_lm/lfm/experts_up", "flow_lm/lfm/experts_down"}
    for path, shape, _, _ in ref._leaves(s):
        name = path.split("/")[-1]
        if path.startswith("flow_lm/lfm/") and name not in ("op_norm", "ffn_norm", "qk_norm",
                                                            "final_norm", "expert_bias"):
            n = int(np.prod(shape))
            total += n * s.topk // s.experts if path in experts else n
        elif path in ("flow_lm/input_w", "flow_lm/out_eos_w"):
            total += int(np.prod(shape))
    assert costs_lfm2.backbone_linear_flops(s) == 2 * total
    # ~1.5 B active parameters (the published 1.5 B less the unused embedding and head)
    assert 1.2e9 < total < 1.6e9


def test_one_token_expert_bytes_at_the_published_widths():
    up, down = costs_lfm2.moe_one_token_bytes(ref.sizes(CFG))
    assert abs(up - 4 * 2 * 1792 * 2048 * 2) < 40_000  # 58.7 MB of rows, activations beside
    assert abs(down - 4 * 2048 * 1792 * 2) < 40_000


def test_the_roofline_reads_only_one_token_launches():
    read = _load("moe_experts_roofline").read
    s = ref.sizes(CFG)
    up, down = costs_lfm2.moe_one_token_bytes(s)
    t = (up + down) / costs_lfm2.PEAKS["hbm_bytes_per_s"]
    kernels = {"moe_up_kernel<true>": [22 * 2 * t / 2, 22], "moe_down_kernel<true>":
               [22 * 2 * t / 2, 22], "moe_up_kernel<false>": [1.0, 22]}
    ctx = types.SimpleNamespace(trace={"kernels": kernels}, sizes=s)
    assert read(ctx) == pytest.approx(50.0)
    assert read(types.SimpleNamespace(trace={"kernels": {}}, sizes=s)) is None
    assert read(types.SimpleNamespace(trace=None, sizes=s)) is None


def test_the_prefill_median_takes_requests_only(monkeypatch):
    from harness import spans

    read = _load("flow_lm.prefill_ms_p50").read
    recs = [(0, 0.0, 0.5, 125), (3, 1.0, 1.010, 12), (4, 2.0, 2.030, 20), (4, 3.0, 3.010, 5),
            (5, 4.0, 4.020, 8)]
    monkeypatch.setattr(spans, "named", lambda ctx, name: recs)
    assert read(None) == pytest.approx(20.0)
    monkeypatch.setattr(spans, "named", lambda ctx, name: None)
    assert read(None) is None


def _tiny_lfm2() -> dict:
    cfg = json.loads(json.dumps(CFG))
    cfg.update(hidden_size=128, num_attention_heads=2, num_key_value_heads=1,
               intermediate_size=256, moe_intermediate_size=64, num_experts=8,
               num_experts_per_tok=2)
    cfg["flow_lm"]["lookup_table"]["dim"] = 128
    return cfg


def test_the_seeded_branches_start_small():
    """The conv mixers' and the experts' output projections at
    ``BRANCH_SCALE`` of their fan-in bound; every other backbone linear at
    the bound."""
    s = ref.sizes(_tiny_lfm2())
    bounds = {path.split("/")[-1]: bound for path, _, _, bound in ref._leaves(s)}
    assert bounds["conv_out"] == pytest.approx(ref.BRANCH_SCALE * 128 ** -0.5)
    assert bounds["experts_down"] == pytest.approx(ref.BRANCH_SCALE * 64 ** -0.5)
    assert bounds["attn_out"] == pytest.approx(128 ** -0.5)
    assert bounds["ff_down"] == pytest.approx(256 ** -0.5)


@pytest.mark.parametrize("kind", ["float8", "bfloat16"])
def test_rounded_expert_banks_equal_rounding_every_call(monkeypatch, kind):
    """The control's experts rounded once per bank give the numbers of
    rounding them at every product, and the rounded copies go with the
    weights."""
    import gc

    import torch

    cfg = _tiny_lfm2()
    s = ref.sizes(cfg)
    w = ref.make_weights(cfg, 5, "cpu")["flow_lm"]["lfm"]
    x = torch.randn(12, 128, generator=torch.Generator().manual_seed(0))
    nx = ref.Numerics(kind, "bfloat16", "float32")
    once = ref.backbone(w, s, x, nx)
    again = ref.backbone(w, s, x, nx)
    assert len(ref._ROUNDED) == 2  # experts_up and experts_down
    monkeypatch.setattr(ref, "_rounded_bank", lambda nx, bank, m: nx.round(bank[m], nx.backbone))
    every = ref.backbone(w, s, x, nx)
    assert torch.equal(once, again) and torch.equal(once, every)
    del w
    gc.collect()
    assert not ref._ROUNDED


# the LFM2 cell's readers of spans and counters (the device trace's need a card)
HOST_READ = {"orchestrator.useful_ratio", "engine.ms_per_step", "engine.enqueue_ms_per_frame",
             "orchestrator.fetch_wait_ms_per_frame", "orchestrator.kept_ratio",
             "orchestrator.setup_ms_p50", "orchestrator.first_chunk_ms_p50", "lfm2_step.mfu",
             "backbone.enqueue_ms_per_frame", "flow_lm.prefill_ms_p50"}


@pytest.fixture(scope="module")
def tiny_lfm2_base(tmp_path_factory):
    """The rehearsal's base with its stream cell on a tiny LFM2-MoE FlowLM:
    the configuration file's backbone at hidden 64 (8 / 2 heads, 6 layers,
    8 experts top-2), the tiny Pocket's flow net, codec and float32 runtime."""
    from conftest import TINY_MIXES, make_base

    tmp = tmp_path_factory.mktemp("lfm2")
    base = make_base(tmp / "base", {"tiny-stream": TINY_MIXES["tiny-stream"]})
    tiny = json.loads((BENCH / "tests" / "tiny.json").read_text())
    cfg = json.loads(json.dumps(CFG))
    cfg.update(hidden_size=64, num_hidden_layers=6, num_attention_heads=8, num_key_value_heads=2,
               layer_types=["conv", "conv", "full_attention", "conv", "full_attention", "conv"],
               intermediate_size=128, moe_intermediate_size=32, num_experts=8,
               num_experts_per_tok=2)
    cfg["flow_lm"] = {**tiny["flow_lm"], "lookup_table": {"dim": 64, "n_bins": 4000}}
    cfg["mimi"], cfg["runtime"] = tiny["mimi"], tiny["runtime"]
    (tmp / "lfm2-tiny.json").write_text(json.dumps(cfg))
    m = json.loads((base / "BENCHMARK.json").read_text())
    m["configs"] = [{"name": "tiny", "source": CFG["source"], "file": str(tmp / "lfm2-tiny.json"),
                     "reduced": [], "why": "tests"}]
    (base / "BENCHMARK.json").write_text(json.dumps(m))
    return base


@pytest.mark.parametrize("trace", [0, 1])
def test_a_tiny_lfm2_run_is_correct_and_reports_its_metrics(tiny_lfm2_base, trace):
    """The cell's path through run.py on the CPU: correct against the LFM2
    reference, and every per-layer metric BENCHMARK.json lists for
    lfm2moe-stream1 that reads the program's spans or counters reported."""
    import types

    import run

    args = types.SimpleNamespace(workload="tiny-stream", seed=2 ** 32 + 17, seconds=2.0,
                                 trace=trace)
    code, result, lines = run.run(args, device="cpu", manifest_path=tiny_lfm2_base /
                                  "BENCHMARK.json", base=tiny_lfm2_base)
    assert code == 0 and result["correct"], lines
    assert result["attempted"] > 0 and result["failed"] == 0
    listed = {p["name"] for p in json.loads((BENCH.parent / "BENCHMARK.json").read_text())[
        "per_layer"] if "lfm2moe-stream1" in p.get("workloads", [])}
    assert HOST_READ <= listed
    if trace:
        assert HOST_READ <= set(result["metrics"]), set(result["metrics"])
    else:
        assert {"x_realtime", "first_audio_p50_ms", "setup_s"} <= set(result["metrics"])
