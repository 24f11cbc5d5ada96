"""Tests that run only on an NVIDIA GPU: the port's CUDA kernels (sm_90a,
built with nvcc; a CUDA kernel has no CPU mode) and the voice encoder on the
card against its CPU run.  Without a card they skip.

This file imports no JAX (the GPU machine has none), so it runs there with
the JAX-importing tests/conftest.py left out:

    python -m pytest --noconftest tests/test_torch_cuda.py -m cuda -q
"""

import pytest
import torch

from pocket_tts_tpu_torch.kernels import flow_blocks as fb

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (sm_90a) and nvcc: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _blocks(device, seed, dim=512, depth=6):
    g = torch.Generator().manual_seed(seed)
    bound = dim ** -0.5
    blocks = {
        "ada_w": (torch.rand(depth, 3 * dim, dim, generator=g) * 2 - 1) * bound,
        "ada_b": torch.randn(depth, 3 * dim, generator=g) * 0.1,
        "ln_w": 1 + torch.randn(depth, dim, generator=g) * 0.1,
        "ln_b": torch.randn(depth, dim, generator=g) * 0.1,
        "mlp1_w": (torch.rand(depth, dim, dim, generator=g) * 2 - 1) * bound,
        "mlp1_b": torch.randn(depth, dim, generator=g) * 0.1,
        "mlp2_w": (torch.rand(depth, dim, dim, generator=g) * 2 - 1) * bound,
        "mlp2_b": torch.randn(depth, dim, generator=g) * 0.1,
    }
    return {k: v.to(device) for k, v in blocks.items()}, g


def _inputs(g, batch, dim, device):
    sy = torch.nn.functional.silu(torch.randn(batch, dim, generator=g)).to(device)
    return sy, torch.randn(batch, dim, generator=g).to(device)


# (batch, dim, depth): the flagship at the main path's and the batcher's B,
# B = 3 and the largest B of the earlier multi-launch design (113), the widest dim at depth 1,
# a streamed (ring) shape, and the small test config's width
KERNEL_SHAPES = [(1, 512, 6), (3, 512, 6), (4, 512, 6), (16, 512, 6), (113, 512, 6),
                 (16, 1024, 1), (4, 1024, 6), (1, 64, 3), (16, 64, 3)]


@pytest.mark.parametrize("batch,dim,depth", KERNEL_SHAPES)
def test_flow_blocks_kernel_matches_plain_on_cuda(cuda_device, batch, dim, depth):
    """1e-4: both sides accumulate f32 in different orders over `depth`
    chained dim-wide products."""
    blocks, g = _blocks(cuda_device, batch, dim, depth)
    sy, h0 = _inputs(g, batch, dim, cuda_device)
    launches = fb.flow_blocks.launches
    got = fb.flow_blocks(sy, h0, blocks)
    torch.cuda.synchronize()
    assert fb.flow_blocks.launches == launches + 1
    ref = fb.flow_blocks_reference(sy, h0, blocks)
    assert (got - ref).abs().max().item() <= 1e-4


def test_flow_blocks_lane_is_bit_identical_at_any_batch(cuda_device):
    """A lane's result does not depend on B or on the other lanes: the same
    row alone (B = 1) and at every position of a B = 16 batch, bit for bit."""
    blocks, g = _blocks(cuda_device, 7)
    sy, h0 = _inputs(g, 16, 512, cuda_device)
    batched = fb.flow_blocks(sy, h0, blocks)
    for b in (0, 5, 15):
        alone = fb.flow_blocks(sy[b:b + 1].contiguous(), h0[b:b + 1].contiguous(), blocks)
        assert torch.equal(alone[0], batched[b])
    assert torch.equal(fb.flow_blocks(sy, h0, blocks), batched)  # run to run


def test_flow_blocks_cuda_graph_replays_eager(cuda_device):
    """One call captured in a CUDA graph (a cooperative launch) replays to the
    eager result."""
    blocks, g = _blocks(cuda_device, 8)
    sy, h0 = _inputs(g, 4, 512, cuda_device)
    eager = fb.flow_blocks(sy, h0, blocks)
    fb.flow_blocks(sy, h0, blocks)  # plan and library ready before capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fb.flow_blocks(sy, h0, blocks)
    out.zero_()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, eager)


def test_flow_blocks_raises_on_cuda_input_it_cannot_take(cuda_device):
    """On CUDA the wrapper launches the kernel or raises: never the plain path."""
    blocks, g = _blocks(cuda_device, 0)
    sy = torch.randn(1, 512, generator=g).to(cuda_device)
    launches = fb.flow_blocks.launches
    with pytest.raises(TypeError, match="float32"):
        fb.flow_blocks(sy.bfloat16(), sy, blocks)
    with pytest.raises(ValueError, match="on cpu"):
        fb.flow_blocks(sy, sy.cpu(), blocks)
    assert fb.flow_blocks.launches == launches


def _small_config(runtime):
    """The small config of tests/test_tts.py (this file imports no JAX)."""
    from pocket_tts_tpu_torch import config as c

    return c.Config(
        flow_lm=c.FlowLMConfig(
            flow=c.FlowConfig(dim=48, depth=2),
            transformer=c.TransformerConfig(d_model=64, num_heads=4, num_layers=2,
                                            hidden_scale=2),
            lookup_table=c.LookupTableConfig(dim=64, n_bins=4000)),
        mimi=c.MimiConfig(
            seanet=c.SEANetConfig(dimension=32, n_filters=4),
            transformer=c.MimiTransformerConfig(d_model=32, input_dimension=32,
                                                output_dimensions=(32,), num_heads=4,
                                                num_layers=2, context=48, dim_feedforward=64),
            quantizer=c.QuantizerConfig(dimension=16, output_dimension=32)),
        runtime=runtime)


@pytest.mark.parametrize("seconds", [1.5, 3.3])  # one-shot, chunked
def test_voice_encoder_on_cuda_matches_cpu(cuda_device, seconds):
    """The voice encoder (Mimi encoder + speaker projection, float32) on the
    card against the same model on the CPU, at a small config whose encode
    buckets send 3.3 s down the chunked path.  1e-4: f32 on both sides, TF32
    off, sums in another order."""
    import numpy as np

    from pocket_tts_tpu_torch import config as c
    from pocket_tts_tpu_torch import weights
    from pocket_tts_tpu_torch.runtime.engine import Engine

    cfg = _small_config(c.RuntimeConfig(encode_seconds_buckets=(1.0, 2.0),
                                        voice_prompt_chunk_frames=8))
    torch.backends.cudnn.allow_tf32 = False
    params = weights.from_state_dict(weights.random_state_dict(cfg, 0), cfg)
    wav = (np.random.default_rng(1).standard_normal(int(seconds * 24000)) * 0.1
           ).astype(np.float32)
    got, n = Engine(cfg, params, cuda_device).encode_voice(wav)
    ref, n_ref = Engine(cfg, params, "cpu").encode_voice(wav)
    assert got.device.type == "cuda" and n == n_ref == -(-wav.size // 1920)
    assert (got.cpu() - ref).abs().max().item() <= 1e-4


def test_batcher_matches_single_stream_on_cuda(cuda_device):
    """A B = 4 ContinuousBatcher on the card in float32, four concurrent
    requests with their own lsd step count and noise clamp at temp 0, each
    against the port's single stream on the card.  1e-4 in float audio (3.3
    int16 LSB): f32 on both sides, TF32 off, lanes at B = 4 summed in another
    order than at B = 1.  Every flow evaluation is one kernel launch."""
    from pocket_tts_tpu_torch import config as c
    from pocket_tts_tpu_torch import weights
    from pocket_tts_tpu_torch.runtime.batcher import ContinuousBatcher
    from pocket_tts_tpu_torch.runtime.engine import GenParams
    from pocket_tts_tpu_torch.tts import TTSModel

    torch.backends.cudnn.allow_tf32 = False
    cfg = _small_config(c.RuntimeConfig(compute_dtype="float32", decode_chunks=(2, 4, 8)))
    params = weights.from_state_dict(weights.random_state_dict(cfg, 3), cfg)
    base = GenParams(temp=0.0, eos_threshold=float("inf"))
    model = TTSModel(cfg, params, gen=base, has_real_weights=False, device=cuda_device)
    texts = ["First request on the card.", "Second one, two steps.",
             "Third with a noise clamp.", "Fourth [pause:100ms] after a pause."]
    gens = [base, GenParams(temp=0.0, eos_threshold=float("inf"), lsd_decode_steps=2),
            GenParams(temp=0.0, eos_threshold=float("inf"), noise_clamp=0.5), base]
    singles = []
    for text, gen in zip(texts, gens):
        model.gen = gen
        singles.append(model.generate_with_pauses(text))
    model.gen = base
    b = ContinuousBatcher(model, batch_size=4, chunk_frames=4)
    b.start()
    try:
        launches, evals = fb.flow_blocks.launches, b.engine.flow_evals
        results = b.generate_batch(texts, gens=gens)
        assert fb.flow_blocks.launches - launches == b.engine.flow_evals - evals > 0
    finally:
        b.stop()
    for got, want in zip(results, singles):
        assert got.shape == want.shape and got.size > 0
        assert abs(got - want).max() <= 1e-4


def test_mesh_tp2_on_one_card_matches_single_device(cuda_device):
    """tp = 2 over [cuda:0] * 2: the sharded code on one card (a cache shard
    per rank, decode attention over each rank's heads, partial sums added
    in rank order) against the single-device engine in float32 at B = 2,
    prefill and two chunks at temp 0.5 from one generator.  Audio within 1
    int16 LSB and latents within 1e-4 (tests/test_sharding.py:82-86);
    decode_attention launches = frames x layers x dp x tp."""
    import numpy as np

    from pocket_tts_tpu_torch import config as c
    from pocket_tts_tpu_torch import weights
    from pocket_tts_tpu_torch.kernels import decode_attention as da
    from pocket_tts_tpu_torch.parallel.mesh import gather, make_mesh
    from pocket_tts_tpu_torch.runtime.engine import Engine, GenParams

    torch.backends.cudnn.allow_tf32 = False
    cfg = _small_config(c.RuntimeConfig(compute_dtype="float32", max_seq=256))
    params = weights.from_state_dict(weights.random_state_dict(cfg, 4), cfg)
    outs = []
    for mesh in (None, make_mesh(2, devices=[cuda_device] * 2)):
        eng = Engine(cfg, params, None if mesh else cuda_device, batch_size=2, mesh=mesh)
        st = eng.prefill_tokens(eng.new_state(), np.tile(np.arange(1, 7, dtype=np.int32),
                                                         (2, 1)), 6)
        gen, pcm = torch.Generator(device=cuda_device).manual_seed(0), []
        da.decode_attention.launches = 0
        for _ in range(2):
            st, audio, _ = eng.decode_frames(st, 2, GenParams(temp=0.5), gen)
            pcm.append(audio.cpu().numpy().astype(np.int64))
        assert da.decode_attention.launches == 4 * 2 * (2 if mesh else 1)
        outs.append((np.concatenate(pcm, 1), gather(st["latent"], "cpu").numpy()))
    assert np.abs(outs[0][0] - outs[1][0]).max() <= 1
    np.testing.assert_allclose(outs[1][1], outs[0][1], atol=1e-4, rtol=1e-4)


def test_staged_codec_on_its_own_stream_is_bit_identical(cuda_device):
    """The codec staged on a CUDA stream of its own on the engine's card:
    generate and generate_stream (chunk schedule) bit for bit the unstaged
    model's, its stream not the frames', and the audio of a public
    ``decode_frames`` call read at once (no wait of the caller's) bit for bit
    the unstaged engine's."""
    import numpy as np

    from pocket_tts_tpu_torch import config as c
    from pocket_tts_tpu_torch import weights
    from pocket_tts_tpu_torch.runtime.engine import GenParams
    from pocket_tts_tpu_torch.tts import TTSModel

    cfg = _small_config(c.RuntimeConfig(compute_dtype="float32", segment_dispatch="chunked",
                                        decode_chunks=(2, 4, 8)))
    params = weights.from_state_dict(weights.random_state_dict(cfg, 5), cfg)
    gen = GenParams(temp=0.0, eos_threshold=float("inf"))
    plain = TTSModel(cfg, params, gen=gen, has_real_weights=False, device=cuda_device)
    staged = TTSModel(cfg, params, gen=gen, has_real_weights=False, device=cuda_device)
    staged.engine.enable_staged_codec(cuda_device)
    text = "Staged codec on its own stream. A second sentence follows it."
    for run in (lambda m: m.generate(text),
                lambda m: np.concatenate(list(m.generate_stream(text)))):
        want, got = run(plain), run(staged)
        assert got.shape == want.shape and got.size > 0
        np.testing.assert_array_equal(got, want)
    eng = staged.engine
    assert eng._codec_stream != torch.cuda.current_stream(cuda_device)
    pcm = []
    for e in (plain.engine, eng):
        st = e.prefill_tokens(e.new_state(), np.array([[1, 2, 3]], np.int32), 3)
        g, chunks = torch.Generator(device=cuda_device).manual_seed(0), []
        for _ in range(3):
            st, audio, _ = e.decode_frames(st, 4, GenParams(temp=0.5), g)
            chunks.append(audio.cpu().numpy())
        pcm.append(np.concatenate(chunks, 1))
    np.testing.assert_array_equal(pcm[1], pcm[0])


def _train_batch(b=4, tf=5, ldim=16):
    """A training batch with unequal latent_valid between dp groups."""
    import numpy as np

    rng = np.random.default_rng(0)
    return {"tokens": rng.integers(1, 50, size=(b, 6)).astype(np.int32),
            "token_valid": np.array([6, 4, 6, 5][:b], np.int32),
            "latents": rng.normal(size=(b, tf, ldim)).astype(np.float32),
            "latent_valid": np.array([5, 3, 4, 5][:b], np.int32)}


def test_sharded_train_steps_on_one_card_match_single_device(cuda_device):
    """One full and one LoRA step of the small config in float32 (TF32 off)
    on dp 2 x tp 2 over [cuda:0] * 4 against the one-device step on the card,
    the same draws: loss rtol 2e-4, params (factors) after the step rtol
    2e-3 / atol 2e-4 (tests/test_training.py:338-345), grad_norm within
    1e-5 relative; no hand kernel launched."""
    from pocket_tts_tpu_torch import config as c
    from pocket_tts_tpu_torch import training, weights
    from pocket_tts_tpu_torch.kernels import decode_attention as da
    from pocket_tts_tpu_torch.kernels import qlinear as ql
    from pocket_tts_tpu_torch.parallel import mesh as pm
    from pocket_tts_tpu_torch.training.trainer import _map

    cfg = _small_config(c.RuntimeConfig())
    flow_lm = _map(weights.from_state_dict(weights.random_state_dict(cfg, 3), cfg)["flow_lm"],
                   lambda t: t.to(cuda_device))
    batch = _train_batch()
    draws = training.loss.sample_draws(torch.Generator().manual_seed(1), 4, 5, 16,
                                       torch.device("cpu"))
    mesh = pm.make_mesh(4, tp=2, devices=[cuda_device] * 4)
    launches = (fb.flow_blocks.launches, ql.qlinear.launches, da.decode_attention.launches)
    opt = training.make_optimizer(1e-3)
    full = training.make_train_step(cfg, opt)
    lora = training.make_lora_train_step(cfg, opt, alpha=2.0, rank=2)
    runs = []
    for placed in (False, True):
        p = pm.shard_trainable(flow_lm, mesh) if placed else _map(flow_lm, torch.clone)
        b = training.shard_batch(batch, mesh) if placed else batch
        p, _, m_full = full(p, opt.init(p), b, draws=draws)
        base = pm.shard_params(flow_lm, mesh) if placed else flow_lm
        f = training.init_lora(flow_lm, 2, seed=4)
        f = {t: {"a": x["a"], "b": x["b"] + 0.01} for t, x in f.items()}
        f = pm.shard_trainable(f, mesh) if placed else f
        f, _, m_lora = lora(f, opt.init(f), base, b, draws=draws)
        runs.append((pm.gather(p, "cpu"), m_full, pm.gather(f, "cpu"), m_lora))
    assert launches == (fb.flow_blocks.launches, ql.qlinear.launches,
                        da.decode_attention.launches)
    (p1, mf1, f1, ml1), (p2, mf2, f2, ml2) = runs
    for one, sh in ((mf1, mf2), (ml1, ml2)):
        assert abs(sh["loss"].item() - one["loss"].item()) <= 2e-4 * abs(one["loss"].item())
        assert abs(sh["grad_norm"].item() - one["grad_norm"].item()) <= \
            1e-5 * one["grad_norm"].item()
    for one, sh in ((p1, p2), (f1, f2)):
        flat_one, flat_sh = dict(_flat(one)), dict(_flat(sh))
        assert sorted(flat_one) == sorted(flat_sh)
        for k, v in flat_one.items():
            torch.testing.assert_close(flat_sh[k], v.detach().cpu(), rtol=2e-3, atol=2e-4)


def _flat(tree):
    from pocket_tts_tpu_torch.runtime.quantize import _flatten_paths

    return _flatten_paths(tree)


def test_bank_on_a_tp2_engine_on_one_card(cuda_device):
    """The adapter bank on a float32 tp 2 engine over [cuda:0] * 2, B = 4
    (two adapters, a zero row), against the one-device bank on the card at
    temp 0.5 from one generator: int16 audio within 1 LSB, latents within
    1e-4; decode_attention launches = frames x layers x dp x tp."""
    import tempfile
    from pathlib import Path

    import numpy as np

    from pocket_tts_tpu_torch import config as c
    from pocket_tts_tpu_torch import weights
    from pocket_tts_tpu_torch.kernels import decode_attention as da
    from pocket_tts_tpu_torch.parallel.mesh import gather, make_mesh
    from pocket_tts_tpu_torch.runtime.engine import Engine, GenParams
    from pocket_tts_tpu_torch.training import init_lora, save_lora_params
    from pocket_tts_tpu_torch.training.lora import build_adapter_bank

    torch.backends.cudnn.allow_tf32 = False
    cfg = _small_config(c.RuntimeConfig(compute_dtype="float32", max_seq=256))
    params = weights.from_state_dict(weights.random_state_dict(cfg, 4), cfg)
    paths = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, rank, seed in (("one", 2, 5), ("two", 3, 6)):
            f = init_lora(params["flow_lm"], rank, seed=seed)
            g = torch.Generator().manual_seed(seed)
            f = {t: {"a": x["a"], "b": torch.randn(x["b"].shape, generator=g) * 0.05}
                 for t, x in f.items()}
            paths[name] = str(Path(tmp) / f"{name}.safetensors")
            save_lora_params(f, paths[name], rank=rank, alpha=float(rank))
        bank = build_adapter_bank(paths)
    rows = np.stack([bank.row(n) for n in ("one", None, "two", "one")])
    outs = []
    for mesh in (None, make_mesh(2, devices=[cuda_device] * 2)):
        eng = Engine(cfg, params, None if mesh else cuda_device, batch_size=4, mesh=mesh)
        eng.set_adapter_bank(bank)
        empty = Engine(cfg, params, cuda_device).new_state(1)
        st = eng.new_state()
        for i in range(4):
            tok = np.arange(1, 4 + i, dtype=np.int32)[None]
            st = eng.admit_prefill_slot(st, i, empty, eng.pad_token_row(tok), tok.shape[1],
                                        lora_row=rows[i])
        gen, pcm = torch.Generator(device=cuda_device).manual_seed(0), []
        da.decode_attention.launches = 0
        for _ in range(2):
            st, audio, _ = eng.decode_frames(st, 2, GenParams(temp=0.5), gen, lora_w=rows)
            pcm.append(audio.cpu().numpy().astype(np.int64))
        assert da.decode_attention.launches == 4 * 2 * (2 if mesh else 1)
        outs.append((np.concatenate(pcm, 1), gather(st["latent"], "cpu").numpy()))
    assert np.abs(outs[0][0] - outs[1][0]).max() <= 1
    np.testing.assert_allclose(outs[1][1], outs[0][1], atol=1e-4, rtol=1e-4)
    assert np.abs(outs[1][0][0] - outs[1][0][1]).max() > 1  # the adapter moves the audio


def test_staged_codec_on_a_tp2_engine_on_one_card(cuda_device):
    """A tp 2 engine over [cuda:0] * 2 with its codec staged on a CUDA stream
    of its own: chunked decode_frames audio bit for bit the unstaged tp 2
    engine's."""
    import numpy as np

    from pocket_tts_tpu_torch import config as c
    from pocket_tts_tpu_torch import weights
    from pocket_tts_tpu_torch.parallel.mesh import make_mesh
    from pocket_tts_tpu_torch.runtime.engine import Engine, GenParams

    cfg = _small_config(c.RuntimeConfig(compute_dtype="float32", max_seq=256))
    params = weights.from_state_dict(weights.random_state_dict(cfg, 5), cfg)
    pcm = []
    for staged in (False, True):
        eng = Engine(cfg, params, batch_size=1, mesh=make_mesh(2, devices=[cuda_device] * 2))
        if staged:
            eng.enable_staged_codec(cuda_device)
            assert eng._codec_stream != torch.cuda.current_stream(cuda_device)
        st = eng.prefill_tokens(eng.reset_for_segment(
            Engine(cfg, params, cuda_device).new_state(1)), np.array([[1, 2, 3]], np.int32), 3)
        g, chunks = torch.Generator(device=cuda_device).manual_seed(0), []
        for _ in range(3):
            st, audio, _ = eng.decode_frames(st, 4, GenParams(temp=0.5), g)
            chunks.append(audio.cpu().numpy())
        pcm.append(np.concatenate(chunks, 1))
    assert pcm[0].size > 0
    np.testing.assert_array_equal(pcm[1], pcm[0])


# -- qlinear: the weight-only int8 / int4 products ------------------------------

# (M, N, K) of the decode frame at B = 1, 4, 16, 32: in_proj as [3E, E], ff1,
# ff2, and the flow net's final linear; then an odd shape
QLINEAR_SHAPES = [(m, n, k) for m in (1, 4, 16, 32)
                  for n, k in ((3072, 1024), (4096, 1024), (1024, 4096), (32, 512))]
QLINEAR_SHAPES += [(3, 1000, 1002), (2, 1024, 32)]


def qlinear_tolerance(dtype, ref: torch.Tensor) -> float:
    """bf16: two bf16 ulps of max|y| (2^(floor(log2 max|y|) - 6)): each side
    rounds its output to bf16 once, and the plain version also rounds each
    dequantized weight to bf16 before its product (and sums in cuBLAS's
    order) where the kernel sums q * x in f32 and scales once.  f32:
    1e-5 max(1, max|y|), sums in another order."""
    import math

    top = ref.float().abs().max().item()
    if dtype == torch.bfloat16:
        return 2.0 ** (math.floor(math.log2(max(top, 1e-30))) - 6)
    return 1e-5 * max(1.0, top)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m,n,k", QLINEAR_SHAPES)
def test_qlinear_kernel_matches_plain_on_cuda(cuda_device, m, n, k, dtype, bits):
    from pocket_tts_tpu_torch.kernels import qlinear as ql
    from pocket_tts_tpu_torch.ops.qtensor import quantize_array

    g = torch.Generator().manual_seed(m * n + k + bits)
    w = quantize_array(torch.randn(n, k, generator=g) * k ** -0.5, bits=bits)
    w = w.to(cuda_device).to(dtype)
    x = torch.randn(m, k, generator=g).to(cuda_device, dtype)
    b = (torch.randn(n, generator=g) * 0.1).to(cuda_device, dtype)
    launches = ql.qlinear.launches
    got = ql.qlinear(x, w, b)
    torch.cuda.synchronize()
    assert ql.qlinear.launches == launches + 1 and got.dtype == dtype
    ref = ql.qlinear_reference(x, w, b)
    assert (got.float() - ref.float()).abs().max().item() <= qlinear_tolerance(dtype, ref)


def _qlinear_case(device, m, n, k, bits, seed):
    from pocket_tts_tpu_torch.ops.qtensor import quantize_array

    g = torch.Generator().manual_seed(seed)
    w = quantize_array(torch.randn(n, k, generator=g) * k ** -0.5, bits=bits)
    x = torch.randn(m, k, generator=g).to(device, torch.bfloat16)
    return w.to(device).to(torch.bfloat16), x


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("n,k", [(3072, 1024), (4096, 1024), (1024, 4096)])
def test_qlinear_lane_is_bit_identical_at_any_batch(cuda_device, n, k, bits):
    """The tensor-core route's tiling, K split and reduction order do not
    depend on M: a row of x alone (M = 1) gives the same y, bit for bit, as
    the same row inside M = 16 (and M = 32), and a call repeats bit for bit."""
    from pocket_tts_tpu_torch.kernels import qlinear as ql

    w, x = _qlinear_case(cuda_device, 32, n, k, bits, n + k + bits)
    y16, y32 = ql.qlinear(x[:16], w), ql.qlinear(x, w)
    for r in (0, 7, 15):
        alone = ql.qlinear(x[r:r + 1].contiguous(), w)
        assert torch.equal(alone[0], y16[r]) and torch.equal(alone[0], y32[r])
    assert torch.equal(ql.qlinear(x[:16], w), y16)


@pytest.mark.parametrize("bits", [8, 4])
def test_qlinear_cuda_graph_replays_eager(cuda_device, bits):
    """One call (a cluster launch) captured in a CUDA graph replays to the
    eager result, and a replay does not pass through the wrapper."""
    from pocket_tts_tpu_torch.kernels import qlinear as ql

    w, x = _qlinear_case(cuda_device, 16, 1024, 4096, bits, 11)
    eager = ql.qlinear(x, w)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = ql.qlinear(x, w)
    out.zero_()
    launches = ql.qlinear.launches
    graph.replay()
    torch.cuda.synchronize()
    assert ql.qlinear.launches == launches and torch.equal(out, eager)


def test_qlinear_stacked_in_proj_and_shape_rule_on_cuda(cuda_device):
    """A stacked [3, E, E] in_proj view of one layer is one launch; more than
    MAX_ROWS rows of x go through mat() and one matmul, counted apart."""
    from pocket_tts_tpu_torch.kernels import qlinear as ql
    from pocket_tts_tpu_torch.ops.qtensor import quantize_array

    g = torch.Generator().manual_seed(5)
    stack = quantize_array(torch.randn(2, 3, 256, 256, generator=g) * 0.06, channel_axes=3)
    w = stack.to(cuda_device).to(torch.bfloat16)[1]
    x = torch.randn(1, 1, 256, generator=g).to(cuda_device, torch.bfloat16)
    launches, large = ql.qlinear.launches, ql.qlinear.large_m
    got = ql.qlinear(x, w)
    assert got.shape == (1, 1, 768) and ql.qlinear.launches == launches + 1
    ref = ql.qlinear_reference(x, w)
    assert (got.float() - ref.float()).abs().max().item() <= qlinear_tolerance(torch.bfloat16, ref)
    big = torch.randn(40, 256, generator=g).to(cuda_device, torch.bfloat16)
    assert torch.equal(ql.qlinear(big, w), ql.qlinear_reference(big, w))
    assert ql.qlinear.launches == launches + 1 and ql.qlinear.large_m == large + 1


def test_qlinear_raises_on_cuda_input_it_cannot_take(cuda_device):
    """On CUDA the wrapper launches the kernel or raises: never the plain path."""
    from pocket_tts_tpu_torch.kernels import qlinear as ql
    from pocket_tts_tpu_torch.ops.qtensor import QTensor, quantize_array

    w = quantize_array(torch.randn(64, 128)).to(cuda_device)
    x = torch.randn(1, 128, device=cuda_device)
    launches = ql.qlinear.launches
    with pytest.raises(TypeError, match="scale dtype"):
        ql.qlinear(x, w.to(torch.float16))
    with pytest.raises(TypeError, match="bias"):
        ql.qlinear(x, w, torch.zeros(64, device=cuda_device, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="q on cpu"):
        ql.qlinear(x, QTensor(w.q.cpu(), w.scale))
    with pytest.raises(ValueError, match="at most 4096"):
        ql.qlinear(torch.randn(1, 8192, device=cuda_device),
                   quantize_array(torch.randn(8, 8192)).to(cuda_device))
    assert ql.qlinear.launches == launches


def test_quantized_frame_launches_qlinear_on_cuda(cuda_device):
    """Every quantized linear of a B = 1 frame is a qlinear launch: the
    backbone's in_proj, ff1 and ff2 per layer, the input linear, cond_w, and
    in_w, final_ada_w and final_w per flow evaluation."""
    from pocket_tts_tpu_torch import config as c
    from pocket_tts_tpu_torch import weights
    import numpy as np

    from pocket_tts_tpu_torch.kernels import qlinear as ql
    from pocket_tts_tpu_torch.ops.qtensor import QTensor
    from pocket_tts_tpu_torch.runtime.engine import Engine, GenParams
    from pocket_tts_tpu_torch.runtime.quantize import quantize_params

    cfg = _small_config(c.RuntimeConfig(kv_dtype="float8_e4m3", transport_format="mulaw"))
    params = quantize_params(weights.from_state_dict(weights.random_state_dict(cfg, 3), cfg))
    eng = Engine(cfg, params, cuda_device)
    st = eng.prefill_tokens(eng.new_state(), np.array([[3, 1, 4, 1, 5]], np.int32), 5)
    launches = ql.qlinear.launches
    _, audio, _ = eng.decode_frames(st, 4, GenParams(temp=0.0, lsd_decode_steps=2),
                                    torch.Generator(device=cuda_device))
    torch.cuda.synchronize()
    assert audio.dtype == torch.uint8 and audio.shape == (1, 4 * 1920)
    fl = params["flow_lm"]
    backbone = sum(w.q.shape[0] for w in fl["tf"].values() if isinstance(w, QTensor))
    frame = backbone + sum(isinstance(fl[k], QTensor) for k in ("input_w",))
    frame += isinstance(fl["flow"]["cond_w"], QTensor)
    flow = sum(isinstance(fl["flow"][k], QTensor) for k in ("in_w", "final_ada_w", "final_w"))
    assert backbone == 3 * cfg.flow_lm.transformer.num_layers and flow >= 1
    assert ql.qlinear.launches - launches == 4 * (frame + 2 * flow)


# -- the serving tier's request layer (no aiohttp on the card machine) -----------


def test_request_layer_serves_lone_and_routed_requests_on_cuda(cuda_device):
    """``server.app`` driven without HTTP on the card, float32, temp 0: a lone
    /generate takes the single stream and equals the library's
    ``generate_with_pauses`` bit for bit; the same request while the
    single-stream lock is held rides a B = 2 batcher and matches it within
    1e-4 in float audio (4 int16 LSB with truncation); /stream with the lock
    held too.  Every flow evaluation is one kernel launch."""
    import asyncio

    import numpy as np

    from pocket_tts_tpu_torch import audio
    from pocket_tts_tpu_torch import config as c
    from pocket_tts_tpu_torch import weights
    from pocket_tts_tpu_torch.runtime.batcher import batched_tts
    from pocket_tts_tpu_torch.runtime.engine import GenParams
    from pocket_tts_tpu_torch.server import app
    from pocket_tts_tpu_torch.tts import TTSModel

    torch.backends.cudnn.allow_tf32 = False
    cfg = _small_config(c.RuntimeConfig(compute_dtype="float32", decode_chunks=(2, 4, 8)))
    params = weights.from_state_dict(weights.random_state_dict(cfg, 3), cfg)
    model = TTSModel(cfg, params, gen=GenParams(temp=0.0, eos_threshold=float("inf")),
                     has_real_weights=False, device=cuda_device)
    batcher = batched_tts(model, batch_size=2, chunk_frames=4)
    state = app.ServerState(model, batcher=batcher)
    body = {"text": "Served on the card. [pause:100ms] Twice.", "lsd_steps": 2}

    async def main():
        lone = await app.generate_wav(state, body)
        assert batcher.stats()["requests_submitted"] == 0
        async with state.lock:
            routed = await app.generate_wav(state, body)
            chunks = await app.open_stream(state, body)
            pcm = b"".join([c async for c in chunks])
        return lone, routed, pcm

    try:
        launches, evals = fb.flow_blocks.launches, model.engine.flow_evals + batcher.engine.flow_evals
        lone, routed, pcm = asyncio.run(main())
        evals = model.engine.flow_evals + batcher.engine.flow_evals - evals
        assert fb.flow_blocks.launches - launches == evals > 0
        assert batcher.stats()["requests_submitted"] == 2
    finally:
        batcher.stop()
    assert lone == audio.wav_bytes(model.with_params(lsd_decode_steps=2).generate_with_pauses(
        body["text"]), model.sample_rate)
    want = np.frombuffer(lone[44:], "<i2").astype(np.int64)
    for got in (np.frombuffer(routed[44:], "<i2"), np.frombuffer(pcm, "<i2")):
        assert got.shape == want.shape and want.size > 0
        assert np.abs(got.astype(np.int64) - want).max() <= 4


# -- fine-tuning and the adapter bank ---------------------------------------------


def test_kernels_refuse_autograd_on_cuda(cuda_device):
    """Both kernels launch through raw pointers and have no backward: under
    autograd, with an input that requires grad, each raises instead of
    returning a result with no grad_fn; without grad mode both launch."""
    from pocket_tts_tpu_torch.kernels import qlinear as ql
    from pocket_tts_tpu_torch.ops.qtensor import quantize_array

    blocks, g = _blocks(cuda_device, 1)
    sy, h0 = _inputs(g, 2, 512, cuda_device)
    with pytest.raises(RuntimeError, match="flow_blocks_reference"):
        fb.flow_blocks(sy, h0.requires_grad_(True), blocks)
    w = quantize_array(torch.randn(64, 128)).to(cuda_device).to(torch.bfloat16)
    x = torch.randn(1, 128, device=cuda_device, dtype=torch.bfloat16, requires_grad=True)
    with pytest.raises(RuntimeError, match="qlinear_reference"):
        ql.qlinear(x, w)
    with torch.no_grad():
        assert fb.flow_blocks(sy, h0, blocks).shape == h0.shape
        assert ql.qlinear(x, w).shape == (1, 64)


def test_lora_step_on_cuda_matches_cpu(cuda_device):
    """One LoRA train step of the small config in float32 (TF32 off), the
    same draws on both sides: the loss, the metrics and the gradient norm
    on the card against the CPU within 1e-5 relative, each factor's
    (clipped) gradient within 1e-4 of its largest; the step moved every
    factor on the card and kept it finite.  (Adam's first step divides
    each gradient by its own magnitude, so near-zero gradients make the
    updated factors no finer test than the gradients.)"""
    import numpy as np

    from pocket_tts_tpu_torch import config as c
    from pocket_tts_tpu_torch import weights
    from pocket_tts_tpu_torch.training import init_lora, make_lora_train_step, make_optimizer
    from pocket_tts_tpu_torch.training.loss import sample_draws
    from pocket_tts_tpu_torch.training.trainer import _map

    cfg = _small_config(c.RuntimeConfig())
    base = weights.from_state_dict(weights.random_state_dict(cfg, 3), cfg)["flow_lm"]
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(1, 50, size=(2, 6)).astype(np.int32),
             "token_valid": np.array([6, 4], np.int32),
             "latents": rng.normal(size=(2, 5, 16)).astype(np.float32),
             "latent_valid": np.array([5, 3], np.int32)}
    draws = sample_draws(torch.Generator().manual_seed(1), 2, 5, 16, torch.device("cpu"))
    out = {}
    for dev in ("cpu", cuda_device):
        b = _map(base, lambda t: t.to(dev))
        factors = init_lora(b, 2, seed=4)
        factors = {t: {"a": f["a"], "b": f["b"] + 0.01} for t, f in factors.items()}
        start = {t: {k: v.clone() for k, v in f.items()} for t, f in factors.items()}
        opt = make_optimizer(1e-2)
        step = make_lora_train_step(cfg, opt, alpha=2.0, rank=2)
        factors, _, metrics = step(factors, opt.init(factors), b, batch, draws=draws)
        out[str(dev)] = (metrics, factors, start)
    (m_cpu, f_cpu, _), (m_gpu, f_gpu, start) = out["cpu"], out[str(cuda_device)]
    assert sorted(m_gpu) == sorted(m_cpu) and "grad_norm" in m_cpu
    for k, v in m_cpu.items():
        assert abs(m_gpu[k].item() - v.item()) <= 1e-5 * max(1.0, abs(v.item())), k
    for t in f_cpu:
        for leaf in ("a", "b"):
            g_cpu, g_gpu = f_cpu[t][leaf].grad, f_gpu[t][leaf].grad.cpu()
            assert (g_gpu - g_cpu).abs().max() <= 1e-4 * max(1.0, g_cpu.abs().max().item()), t
            moved = f_gpu[t][leaf].detach()
            assert torch.isfinite(moved).all() and not torch.equal(moved, start[t][leaf]), t


def test_bank_lane_matches_merged_stream_on_cuda(cuda_device):
    """A B = 2 batcher with a one-adapter bank in float32 on the card: the
    adapter lane against the merged model's single stream on the card, and
    the base lane against the base stream, within 1e-4 in float audio; every
    flow evaluation one kernel launch."""
    import tempfile
    from pathlib import Path

    import numpy as np

    from pocket_tts_tpu_torch import config as c
    from pocket_tts_tpu_torch import weights
    from pocket_tts_tpu_torch.runtime.batcher import ContinuousBatcher
    from pocket_tts_tpu_torch.runtime.engine import GenParams
    from pocket_tts_tpu_torch.training import apply_adapted, init_lora, save_lora_params
    from pocket_tts_tpu_torch.training.lora import build_adapter_bank
    from pocket_tts_tpu_torch.tts import TTSModel

    torch.backends.cudnn.allow_tf32 = False
    cfg = _small_config(c.RuntimeConfig(compute_dtype="float32", decode_chunks=(2, 4, 8)))
    params = weights.from_state_dict(weights.random_state_dict(cfg, 3), cfg)
    gen = GenParams(temp=0.0, eos_threshold=float("inf"))
    model = TTSModel(cfg, params, gen=gen, has_real_weights=False, device=cuda_device)
    factors = init_lora(params["flow_lm"], 2, seed=5)
    rng = np.random.default_rng(6)
    factors = {t: {"a": f["a"], "b": torch.from_numpy(
        rng.normal(0, 0.05, tuple(f["b"].shape)).astype(np.float32))} for t, f in factors.items()}
    text = "A lane of its own on the card."
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "spk.lora.safetensors"
        save_lora_params(factors, path, rank=2, alpha=2.0)
        merged = apply_adapted(model, path)
        bank = build_adapter_bank({"spk": str(path)})
    want = [merged.generate_with_pauses(text), model.generate_with_pauses(text)]
    b = ContinuousBatcher(model, batch_size=2, chunk_frames=4, adapter_bank=bank)
    b.start()
    try:
        launches, evals = fb.flow_blocks.launches, b.engine.flow_evals
        got = b.generate_batch([text, text], adapters=["spk", None])
        assert fb.flow_blocks.launches - launches == b.engine.flow_evals - evals > 0
    finally:
        b.stop()
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.size > 0
        assert abs(g - w).max() <= 1e-4
    assert abs(want[0] - want[1]).max() > 1e-3  # the adapter changes the audio


# -- decode attention over the KV cache ----------------------------------------

# (q dtype, cache dtype): the bf16 model on its bf16 / fp8 caches, an f32
# cache under bf16 q (kv_dtype float32), and the f32 reference model on its
# f32 and fp8 caches
DECODE_DTYPES = [(torch.bfloat16, torch.bfloat16), (torch.bfloat16, torch.float8_e4m3fn),
                 (torch.bfloat16, torch.float8_e5m2), (torch.bfloat16, torch.float32),
                 (torch.float32, torch.float32), (torch.float32, torch.float8_e4m3fn)]
# (B, S, H, D): the flagship's heads at a short cache, an odd S, a narrow
# head (clusters of 2), a cluster of one CTA, a share streamed through the
# ring of tiles
DECODE_SHAPES = [(6, 1024, 16, 64), (5, 300, 3, 64), (3, 64, 2, 32), (3, 7, 2, 16),
                 (4, 8192, 2, 64)]


def _decode_case(device, b, s, h, d, q_dtype, kv_dtype, seed):
    """q, k/v caches and per-slot pos (0, 1, S - 1, S + 5, then random)."""
    g = torch.Generator().manual_seed(seed)
    q = torch.randn(b, 1, h, d, generator=g).to(device, q_dtype)
    k = torch.randn(b, s, h, d, generator=g).to(device).to(kv_dtype)
    v = torch.randn(b, s, h, d, generator=g).to(device).to(kv_dtype)
    pos = torch.randint(0, s, (b,), generator=g, dtype=torch.int32)
    pos[:4] = torch.tensor([0, 1, s - 1, s + 5])[:b]
    return q, k, v, pos.to(device)


@pytest.mark.parametrize("b,s,h,d", DECODE_SHAPES)
@pytest.mark.parametrize("q_dtype,kv_dtype", DECODE_DTYPES)
def test_decode_attention_kernel_matches_plain_on_cuda(cuda_device, b, s, h, d, q_dtype,
                                                       kv_dtype):
    from pocket_tts_tpu_torch.kernels import decode_attention as da

    q, k, v, pos = _decode_case(cuda_device, b, s, h, d, q_dtype, kv_dtype, b + s + d)
    launches = da.decode_attention.launches
    got = da.decode_attention(q, k, v, pos)
    torch.cuda.synchronize()
    assert da.decode_attention.launches == launches + 1
    assert got.dtype == q_dtype and got.shape == q.shape and bool(torch.isfinite(got).all())
    ref = da.decode_attention_reference(q, k, v, pos)
    # each element within da.error_bound: f32 1e-5 max(1, max|out|), the sums
    # run in another order; bf16 derived from the inputs (each side's
    # probabilities rounded to bf16 after an f32 softmax in another order)
    assert ((got.double() - ref.double()).abs() <= da.error_bound(q, k, v, pos, ref)).all()


@pytest.mark.parametrize("q_dtype,kv_dtype", DECODE_DTYPES)
def test_decode_attention_idle_ranks_and_rank_edges_on_cuda(cuda_device, q_dtype, kv_dtype):
    """pos that leave ranks without keys (0 .. 7, 31 .. 33, 100), ranks
    joining at 128, 256 and 384 keys (127 / 128 / 129, 255 / 256 / 257,
    383 / 384 / 385): each element within da.error_bound, at the plan's
    schedule, at a cluster of 8 (one CTA a rank, CTAs idle) and at a CTA
    alone (every rank), the three bit-identical."""
    from pocket_tts_tpu_torch.kernels import decode_attention as da

    pos_values = [0, 1, 2, 7, 31, 32, 33, 100, 127, 128, 129, 255, 256, 257, 383, 384, 385,
                  1023]
    b = len(pos_values)
    q, k, v, _ = _decode_case(cuda_device, b, 1024, 16, 64, q_dtype, kv_dtype, 8)
    pos = torch.tensor(pos_values, dtype=torch.int32, device=cuda_device)
    got = da.decode_attention(q, k, v, pos)
    ref = da.decode_attention_reference(q, k, v, pos)
    assert ((got.double() - ref.double()).abs() <= da.error_bound(q, k, v, pos, ref)).all()
    for c in (8, 1):
        plan = da.launch_plan(b, 1024, 16, 64, (q_dtype, kv_dtype), cluster=c)
        assert torch.equal(da._launch(da._load(), q, k, v, pos, plan), got)


@pytest.mark.parametrize("b,s,h,d", DECODE_SHAPES)
def test_decode_attention_any_cluster_is_bit_identical_on_cuda(cuda_device, b, s, h, d):
    """The order is fixed by the logical ranks: a cluster of one CTA a rank
    and a CTA alone with 1 .. 4 teams give the same bits, bf16 and f32 q;
    so do they all with ranks of 32 keys (lanes without keys in a team's
    first rank), within the bound."""
    from pocket_tts_tpu_torch.kernels import decode_attention as da

    lib = da._load()
    for q_dtype, kv_dtype in ((torch.bfloat16, torch.bfloat16), (torch.float32, torch.float32)):
        q, k, v, pos = _decode_case(cuda_device, b, s, h, d, q_dtype, kv_dtype, 2 * b + s)
        want = da.decode_attention(q, k, v, pos)
        for mk in (da.MIN_KEYS_PER_RANK, 32):
            ranks = da.launch_plan(b, s, h, d, (q_dtype, kv_dtype), min_keys=mk).ranks
            plans = [da.launch_plan(b, s, h, d, (q_dtype, kv_dtype), cluster=1, min_keys=mk,
                                    teams=t) for t in range(1, min(ranks, da.SOLO_TEAMS) + 1)]
            plans.append(da.launch_plan(b, s, h, d, (q_dtype, kv_dtype), cluster=ranks,
                                        min_keys=mk))
            outs = [da._launch(lib, q, k, v, pos, plan) for plan in plans]
            if mk == da.MIN_KEYS_PER_RANK:
                assert torch.equal(outs[0], want)
            ref = da.decode_attention_reference(q, k, v, pos)
            assert ((outs[0].double() - ref.double()).abs()
                    <= da.error_bound(q, k, v, pos, ref)).all()
            assert all(torch.equal(o, outs[0]) for o in outs), plans


@pytest.mark.parametrize("kv_dtype", [torch.bfloat16, torch.float8_e4m3fn])
def test_decode_attention_lane_is_bit_identical_at_any_batch(cuda_device, kv_dtype):
    """Every sum's order depends on (n, S, D, the cache type) alone: a lane
    alone (B = 1, clusters of 8) equals the same lane inside B = 16 (a CTA
    alone per (b, h)), bit for bit, and a call repeats bit for bit."""
    from pocket_tts_tpu_torch.kernels import decode_attention as da

    q, k, v, pos = _decode_case(cuda_device, 16, 1024, 16, 64, torch.bfloat16, kv_dtype, 3)
    batched = da.decode_attention(q, k, v, pos)
    for b in (0, 2, 3, 9, 15):
        alone = da.decode_attention(q[b:b + 1], k[b:b + 1], v[b:b + 1], pos[b:b + 1])
        assert torch.equal(alone[0], batched[b])
    assert torch.equal(da.decode_attention(q, k, v, pos), batched)


def test_decode_attention_cuda_graph_replays_eager(cuda_device):
    """pos is read on the device: a captured call replays to the eager result
    after pos moves, with no launch through the wrapper."""
    from pocket_tts_tpu_torch.kernels import decode_attention as da

    q, k, v, pos = _decode_case(cuda_device, 4, 1024, 16, 64, torch.bfloat16, torch.bfloat16, 4)
    da.decode_attention(q, k, v, pos)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = da.decode_attention(q, k, v, pos)
    pos.add_(7)
    launches = da.decode_attention.launches
    graph.replay()
    torch.cuda.synchronize()
    assert da.decode_attention.launches == launches
    assert torch.equal(out, da.decode_attention(q, k, v, pos))


def test_decode_attention_refuses_autograd_and_bad_input_on_cuda(cuda_device):
    """On CUDA the wrapper launches the kernel or raises: under autograd, for
    another dtype, a cache over MAX_POSITIONS, a head width it cannot split."""
    from pocket_tts_tpu_torch.kernels import decode_attention as da

    q, k, v, pos = _decode_case(cuda_device, 2, 64, 2, 64, torch.float32, torch.float32, 5)
    launches = da.decode_attention.launches
    with pytest.raises(RuntimeError, match="decode_attention_reference"):
        da.decode_attention(q.requires_grad_(True), k, v, pos)
    q = q.detach()
    with pytest.raises(ValueError, match="float16"):
        da.decode_attention(q.half(), k, v, pos)
    big = torch.zeros(2, da.MAX_POSITIONS + 1, 2, 64, device=cuda_device)
    with pytest.raises(ValueError, match="positions"):
        da.decode_attention(q, big, big, pos)
    odd = torch.zeros(2, 64, 2, 24, device=cuda_device)
    with pytest.raises(ValueError, match="power of two"):
        da.decode_attention(q[..., :24].contiguous(), odd, odd, pos)
    with torch.no_grad():
        assert da.decode_attention(q.requires_grad_(True), k, v, pos).shape == q.shape
    assert da.decode_attention.launches == launches + 1


def test_causal_cache_attention_routes_decode_to_the_kernel_on_cuda(cuda_device):
    """T = 1 launches the kernel; T > 1 (a prefill) keeps the plain sdpa by
    the shape rule and counts in large_t."""
    from pocket_tts_tpu_torch.kernels import decode_attention as da
    from pocket_tts_tpu_torch.ops.attention import causal_cache_attention

    q, k, v, pos = _decode_case(cuda_device, 2, 128, 4, 64, torch.bfloat16, torch.bfloat16, 6)
    launches, large = da.decode_attention.launches, da.decode_attention.large_t
    causal_cache_attention(q, k, v, pos)
    assert (da.decode_attention.launches, da.decode_attention.large_t) == (launches + 1, large)
    causal_cache_attention(q.expand(2, 8, 4, 64).contiguous(), k, v, pos)
    assert (da.decode_attention.launches, da.decode_attention.large_t) == (launches + 1,
                                                                           large + 1)


# -- qlinear, f32 x: the flow net's CUDA-core route ------------------------------

# (N, K): in_w, final_ada_w, final_w, then the f32 reference model's backbone
QLINEAR_F32_NK = [(512, 32), (1024, 512), (32, 512), (3072, 1024), (4096, 1024), (1024, 4096)]


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("n,k", QLINEAR_F32_NK)
def test_qlinear_f32_matches_plain_and_rows_are_bit_identical(cuda_device, n, k, bits):
    """Against plain within 1e-5 max(1, max|y|) (sums in another order) at
    M = 1, 16 and 32; the plan depends on (N, K, format) alone, so a row of x
    alone equals the same row inside M = 16 and M = 32, bit for bit."""
    from pocket_tts_tpu_torch.kernels import qlinear as ql
    from pocket_tts_tpu_torch.ops.qtensor import quantize_array

    g = torch.Generator().manual_seed(n + k + bits)
    w = quantize_array(torch.randn(n, k, generator=g) * k ** -0.5, bits=bits).to(cuda_device)
    x = torch.randn(32, k, generator=g).to(cuda_device)
    b = (torch.randn(n, generator=g) * 0.1).to(cuda_device)
    y16, y32 = ql.qlinear(x[:16], w, b), ql.qlinear(x, w, b)
    for y, m in ((y16, 16), (y32, 32)):
        ref = ql.qlinear_reference(x[:m], w, b)
        assert (y - ref).abs().max().item() <= qlinear_tolerance(torch.float32, ref)
    for r in (0, 5, 15):
        alone = ql.qlinear(x[r:r + 1].contiguous(), w, b)
        assert torch.equal(alone[0], y16[r]) and torch.equal(alone[0], y32[r])
    assert torch.equal(ql.qlinear(x[:16], w, b), y16)


# -- the fused segment decode ------------------------------------------------------


def _eos_threshold_mid_budget(model, text: str) -> tuple[float, int]:
    """(threshold, frame): a threshold halfway between two EOS logit values of
    ``text``'s temp-0 run at which EOS first fires nearest mid-budget."""
    import numpy as np

    from pocket_tts_tpu_torch import text as text_mod
    from pocket_tts_tpu_torch.models import flow_lm, flow_mlp

    eng = model.engine
    prepared, _ = text_mod.prepare_text_prompt(text)
    tokens, n_tokens = text_mod.tokens_array(model.tokenizer, prepared)
    st = eng.prefill_tokens(eng.reset_for_segment(model.get_voice_state().as_dict()), tokens,
                            n_tokens)
    params = eng.params["flow_lm"]
    table = flow_mlp.time_embedding_table(params["flow"], 1)
    pos, latent, logits = st["pos"], st["latent"], []
    for _ in range(model.estimate_generation_steps(text)):
        latent, logit, _, _, pos = flow_lm.step(params, eng.cfg, st["kc"], st["vc"], pos, latent,
                                                torch.zeros(1, eng.ldim, device=eng.device),
                                                table, 1)
        logits.append(logit[0])
    logits = torch.stack(logits).float().cpu().numpy()
    values = sorted(set(logits.tolist()), reverse=True)
    cands = [((hi + lo) / 2, int(np.argmax(logits > (hi + lo) / 2)))
             for hi, lo in zip(values, values[1:])]
    return min(cands, key=lambda c: abs(c[1] - logits.size // 2))


def _fused_against_chunked(device, fae):
    """(emitted frames, frames decoded, frames the stop rule allows, max LSB
    between the fused and chunked paths, EOS frame) on the small config."""
    import dataclasses

    import numpy as np

    from pocket_tts_tpu_torch import config as c
    from pocket_tts_tpu_torch import weights
    from pocket_tts_tpu_torch.runtime.engine import GenParams
    from pocket_tts_tpu_torch.tts import TTSModel, _SegmentRun

    text = "Hello there friend."
    cfg = _small_config(c.RuntimeConfig(max_seq=512, text_buckets=(16, 32, 64),
                                        decode_chunks=(2, 4, 8)))
    params = weights.from_state_dict(weights.random_state_dict(cfg, 3), cfg)
    model = TTSModel(cfg, params, gen=GenParams(temp=0.0), has_real_weights=False,
                     device=device)
    threshold, frame = _eos_threshold_mid_budget(model, text)
    model.gen = GenParams(temp=0.0, eos_threshold=threshold)
    chunked = TTSModel(dataclasses.replace(cfg, runtime=dataclasses.replace(
        cfg.runtime, segment_dispatch="chunked")), params, gen=model.gen,
        has_real_weights=False, device=device)
    run = _SegmentRun(model, text, model.get_voice_state(), fae, low_latency=False)
    assert run.fused_bucket is not None
    a, b = model.generate(text, frames_after_eos=fae), chunked.generate(text, frames_after_eos=fae)
    assert a.shape == b.shape and a.size > 0
    lsb = int(np.abs(np.round(a * 32767).astype(np.int64) - np.round(b * 32767)).max())
    allowed = min(run.max_frames, frame + run.frames_after_eos)
    return a.size // 1920, model.engine.frames_decoded, allowed, lsb, frame


@pytest.mark.parametrize("fae", [None, 0])
def test_fused_segment_on_cuda_stops_within_the_bound(cuda_device, fae):
    """The fused segment on the card (bf16 backbone) emits exactly the stop
    rule's frames, computes at most SEGMENT_POLL + SEGMENT_MAX_LAG more, and
    agrees with the chunk schedule within 2 int16 LSB (the bound the main
    path holds generate and generate_stream to on the card)."""
    from pocket_tts_tpu_torch.runtime import engine

    emitted, decoded, allowed, lsb, frame = _fused_against_chunked(cuda_device, fae)
    assert 0 < frame and emitted == allowed
    assert 0 <= decoded - emitted <= engine.SEGMENT_POLL + engine.SEGMENT_MAX_LAG
    assert lsb <= 2
