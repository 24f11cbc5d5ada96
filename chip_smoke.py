"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each raises on failure; the script exits non-zero and prints no
result line):

1. Environment: the card's name and power limit (nvidia-smi), torch and CUDA
   versions.  No CUDA device -> exit 1.
2. Build: every CUDA kernel of the main path, with nvcc, from the sources in
   this checkout (into build/pocket_tts_tpu_torch/).
3. Kernel against plain: ``flow_blocks`` (one cooperative launch per call)
   against its plain PyTorch version at every shape of ``KERNEL_SHAPES``,
   float32 with TF32 off; a lane alone against the same lane inside B=16,
   bit for bit; one call captured in a CUDA graph against eager; then at
   dim 512, depth 6, B in {1, 4, 16}: cold and warm device us from CUDA
   graphs, the bound and roofline share, the plain chain in a CUDA graph as
   the yardstick, and the wrapper's median ms over 100 runs (the method
   of the kernel's earlier rows in PERF.md).
4. Main path: ``TTSModel.load`` of the flagship variant (random weights from
   a seed; bf16 backbone, f32 flow net and codec) with an unreachable EOS
   threshold, ``generate`` of three sentences with the kernel launch count
   checked against frames x lsd_decode_steps, first-chunk latency of
   ``generate_stream``, stream-vs-generate at temp 0, and one ``generate`` at
   the default EOS threshold.
5. Reference: a few frames of the full-width model in float32 on the card
   against the same model on the CPU (plain versions everywhere).
6. Voice: voice-conditioned synthesis on the same model.  A seeded synthetic
   voice (harmonics with vibrato plus noise) written as a 16-bit stereo
   44.1 kHz WAV goes through ``get_voice_state`` (WAV reader, resampler,
   downmix, Mimi encoder, speaker projection, conditioning prefill) on the
   card; the card's conditioning against the CPU's (f32, 2.5 s); the chunked
   encoder (40 s, over the 30 s one-shot limit) against the one-shot encoder
   on the card; ``overflow="compress"`` over the 768-frame budget; a voiced
   ``generate`` with its kernel launch count checked; the ``audio_prompt``
   file round trip; and ``generate_with_pauses`` with continuation.
7. Batch: continuous-batched synthesis.  (a) A full-width float32 model on
   the card, ``ContinuousBatcher(batch_size=4, chunk_frames=8)``, four
   concurrent temp-0 requests (one with ``lsd_decode_steps=2``, one with a
   noise clamp, one with a pause), each against the single stream within
   ``REF_TOL_LSB``.  (b) ``batched_tts(model, batch_size=16,
   chunk_frames=64)`` on the bf16 model: 32 whole-WAV requests through
   ``generate_batch``, lengths, finiteness and the kernel launch count
   (= the sum over dispatches of chunk frames x step ceiling) checked;
   aggregate x-realtime, ``useful_ratio``, the device busy share of a short
   profiled run, and ms per admission.  (c) 8 streams arriving while 8
   multi-segment whole-WAV requests fill the batch: first-chunk p50/p90,
   preemptions, each stream's segments in order.  (d) The CLI as
   subprocesses: ``batch --device cuda`` on a 4-line manifest (one JSONL line
   with a voice WAV) and ``generate --device cuda -o``.

The last two lines are a JSON summary of the kernels and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import dataclasses
import json
import re
import statistics
import subprocess
import sys
import tempfile
import time
import wave
from pathlib import Path

import numpy as np
import torch

TEXT = ("The quick brown fox jumps over the lazy dog near the river bank. "
        "Streaming speech synthesis turns text into audio one frame at a time. "
        "Each frame carries eighty milliseconds of sound.")
KERNEL_TOL = 1e-4  # f32 sums in another order over `depth` chained dim-wide products
# flow_blocks against its plain version, (batch, dim, depth): the flagship at
# the main path's and the batcher's B, B = 3 and B = 113 (the largest B the
# earlier multi-launch design took), the widest dim at depth 1, a shape whose weights stream
# through a ring (dim 1024, depth 6) and the small test config's width
KERNEL_SHAPES = ((1, 512, 6), (4, 512, 6), (16, 512, 6), (3, 512, 6), (113, 512, 6),
                 (16, 1024, 1), (4, 1024, 6), (1, 64, 3), (16, 64, 3))
TIMED_BATCHES = (1, 4, 16)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3, NVIDIA's data sheet
F32_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores
FLUSH_BYTES = 256 << 20  # a write this size evicts the 50 MB L2
REF_TOL_LSB = 2  # int16 LSB: f32 on the card vs f32 on the CPU, after PCM rounding
# voice conditioning, f32 both sides, TF32 off, sums in another order:
# max abs err <= COND_TOL * max(1, max |reference|)
COND_TOL = 1e-4
VOICE_TEXT = "A cloned voice reads this short sentence aloud."
PAUSE_HEAD = "The first half of the line."
PAUSE_TEXT = PAUSE_HEAD + " [pause:500ms] And then the second half."


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def _median_ms(fn, n: int = 100, warmup: int = 10) -> float:
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(n):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def phase_environment() -> str:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible; this script runs only on a GPU",
              file=sys.stderr)
        sys.exit(1)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi)
    kind = torch.cuda.get_device_name(0)
    print(f"env: python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} device {kind} count {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return kind


def phase_build():
    from pocket_tts_tpu_torch.kernels import flow_blocks as fb

    t0 = time.perf_counter()
    path = fb.build()
    print(f"build: {path.name} in {time.perf_counter() - t0:.2f} s")
    # nvcc -Xptxas -v, one line per kernel instantiation <group, float4 chunks per lane>
    entry, spill = "?", ""
    for line in path.with_suffix(".ptxas.txt").read_text().splitlines():
        if "Compiling entry function" in line:
            m = re.search(r"\d([a-z_]+_kernel)ILi(\d+)ELi(\d+)E", line)
            entry = f"{m[1]}<{m[2]}, {m[3]}>" if m else line.strip()
        elif "spill" in line:
            spill = line.strip()
        elif "registers" in line:
            print(f"build: ptxas {entry}: {line.split(':', 1)[-1].strip()}; {spill}")


def _random_blocks(g, dim: int, depth: int, dev) -> dict:
    bound = dim ** -0.5

    def uniform(*shape):
        return (torch.rand(*shape, generator=g) * 2 - 1) * bound

    blocks = {"ada_w": uniform(depth, 3 * dim, dim),
              "ada_b": torch.randn(depth, 3 * dim, generator=g) * 0.1,
              "ln_w": 1 + torch.randn(depth, dim, generator=g) * 0.1,
              "ln_b": torch.randn(depth, dim, generator=g) * 0.1,
              "mlp1_w": uniform(depth, dim, dim),
              "mlp1_b": torch.randn(depth, dim, generator=g) * 0.1,
              "mlp2_w": uniform(depth, dim, dim),
              "mlp2_b": torch.randn(depth, dim, generator=g) * 0.1}
    return {k: v.to(dev) for k, v in blocks.items()}


def _random_inputs(g, batch: int, dim: int, dev):
    sy = torch.nn.functional.silu(torch.randn(batch, dim, generator=g)).to(dev)
    return sy, torch.randn(batch, dim, generator=g).to(dev)


def _capture(fn, reps: int = 1, flush=None) -> torch.cuda.CUDAGraph:
    """A CUDA graph of [flush (if given), fn x reps]."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        if flush is not None:
            flush()
        for _ in range(reps):
            fn()
    return graph


def _replay_us(graph, n: int = 20) -> float:
    """Median device us of one replay of `graph`, CUDA events, n replays."""
    graph.replay()
    times = []
    for _ in range(n):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) * 1e3)
    return statistics.median(times)


def _flow_cost(blocks: dict, batch: int, dim: int) -> tuple[float, str]:
    """(bound us, "bytes" or "operations"): each weight and activation byte
    read once and h written once, over the HBM rate; 2 FLOP per weight per
    lane over the f32 CUDA-core peak."""
    weights = sum(t.numel() for t in blocks.values())
    nbytes = 4 * (weights + 3 * batch * dim)
    depth = blocks["ada_w"].shape[0]
    flops = 2 * batch * depth * 5 * dim * dim
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e6, flops / F32_FLOPS * 1e6
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_kernel(dev) -> dict:
    """flow_blocks against its plain version at every shape of KERNEL_SHAPES,
    a lane alone against the same lane inside B=16 (bit for bit), one call
    in a CUDA graph against eager, and at dim 512 / depth 6 for B in
    TIMED_BATCHES: cold device us (graph of [256 MB write, call] minus the
    write's graph), warm device us (graph of 20 calls / 20), the graph of
    the plain chain (cold and warm) as the yardstick, in turns (plain,
    kernel, kernel, plain), and the wrapper's median ms as PERF.md's earlier rows."""
    from pocket_tts_tpu_torch.kernels import flow_blocks as fb

    g = torch.Generator().manual_seed(0)
    errs = []
    for batch, dim, depth in KERNEL_SHAPES:
        blocks = _random_blocks(g, dim, depth, dev)
        sy, h0 = _random_inputs(g, batch, dim, dev)
        got = fb.flow_blocks(sy, h0, blocks)
        torch.cuda.synchronize()
        ref = fb.flow_blocks_reference(sy, h0, blocks)
        err = (got - ref).abs().max().item()
        _require(bool(torch.isfinite(got).all()), f"flow_blocks {batch}x{dim}x{depth}: non-finite")
        _require(err <= KERNEL_TOL, f"flow_blocks B={batch} dim={dim} depth={depth}: "
                                    f"max abs err {err} > {KERNEL_TOL}")
        plan = fb._plans[(batch, dim, depth, sy.device.index)]
        print(f"kernel flow_blocks B={batch} dim={dim} depth={depth}: max_abs_err {err:.3e} "
              f"(tol {KERNEL_TOL}); plan grid {plan.grid} rows {plan.rows} "
              f"{'resident' if plan.resident else 'streamed'} slots {plan.slots} "
              f"tile {plan.tile} smem {plan.smem} B")
        errs.append(err)

    dim, depth = 512, 6
    blocks = _random_blocks(g, dim, depth, dev)
    sy, h0 = _random_inputs(g, 16, dim, dev)
    batched = fb.flow_blocks(sy, h0, blocks)
    for b in (0, 7, 15):
        alone = fb.flow_blocks(sy[b:b + 1].contiguous(), h0[b:b + 1].contiguous(), blocks)
        _require(torch.equal(alone[0], batched[b]), f"lane {b}: B=1 differs from inside B=16")
    _require(torch.equal(fb.flow_blocks(sy, h0, blocks), batched), "B=16 differs run to run")
    print("kernel flow_blocks: lanes 0, 7, 15 alone (B=1) == the same lanes inside B=16, "
          "bit for bit; B=16 bit-identical run to run")

    holder = {}
    graph = _capture(lambda: holder.__setitem__("out", fb.flow_blocks(sy, h0, blocks)))
    holder["out"].zero_()
    launches = fb.flow_blocks.launches
    graph.replay()
    torch.cuda.synchronize()
    _require(fb.flow_blocks.launches == launches, "a graph replay went through the wrapper")
    _require(torch.equal(holder["out"], batched), "CUDA-graph replay differs from eager")
    print("kernel flow_blocks: one call captured in a CUDA graph (cooperative launch) "
          "replays to the eager result bit for bit")

    flush_buf = torch.empty(FLUSH_BYTES // 4, dtype=torch.float32, device=dev)

    def flush():
        flush_buf.fill_(1.0)

    out = {"max_abs_err": max(errs)}
    for batch in TIMED_BATCHES:
        sy_b, h0_b = _random_inputs(g, batch, dim, dev)

        def kern():
            return fb.flow_blocks(sy_b, h0_b, blocks)

        def plain():
            return fb.flow_blocks_reference(sy_b, h0_b, blocks)

        graphs = {"flush": _capture(flush),
                  "kernel_cold": _capture(kern, flush=flush),
                  "plain_cold": _capture(plain, flush=flush),
                  "kernel_warm": _capture(kern, reps=20),
                  "plain_warm": _capture(plain, reps=20)}
        turns = {k: [] for k in graphs}
        for name in ("flush", "plain_cold", "kernel_cold", "kernel_cold", "plain_cold", "flush",
                     "plain_warm", "kernel_warm", "kernel_warm", "plain_warm"):
            turns[name].append(_replay_us(graphs[name]))
        med = {k: statistics.mean(v) for k, v in turns.items()}
        cold = med["kernel_cold"] - med["flush"]
        plain_cold = med["plain_cold"] - med["flush"]
        warm, plain_warm = med["kernel_warm"] / 20, med["plain_warm"] / 20
        bound_us, bound_by = _flow_cost(blocks, batch, dim)
        ms = _median_ms(kern)
        plain_ms = _median_ms(plain)
        print(f"kernel flow_blocks B={batch} dim={dim} depth={depth}: device cold {cold:.3f} us "
              f"(graph of [256 MB write, call] {med['kernel_cold']:.3f} minus write "
              f"{med['flush']:.3f}), warm {warm:.3f} us (graph of 20 / 20); bound {bound_us:.3f} "
              f"us by {bound_by}, roofline share {bound_us / cold:.4f} cold, "
              f"{bound_us / warm:.4f} warm; yardstick: plain chain in a CUDA graph cold "
              f"{plain_cold:.3f} us, warm {plain_warm:.3f} us; wrapper (median of 100, events) "
              f"kernel {ms:.4f} ms plain {plain_ms:.4f} ms; turns {json.dumps(turns)}")
        out[batch] = {"ms": ms, "plain_ms": plain_ms, "device_us_cold": cold,
                      "device_us_warm": warm, "bound_us": bound_us, "bound_by": bound_by,
                      "roofline_share": bound_us / cold, "graph_plain_us": plain_cold,
                      "graph_plain_us_warm": plain_warm}
    del flush_buf
    torch.cuda.empty_cache()
    return out


def _pcm(a: np.ndarray) -> np.ndarray:
    return np.round(a * 32767.0).astype(np.int64)


def phase_main_path():
    from pocket_tts_tpu_torch import TTSModel
    from pocket_tts_tpu_torch.kernels import flow_blocks as fb

    t0 = time.perf_counter()
    model = TTSModel.load(eos_threshold=float("inf"), device="cuda")
    eng = model.engine
    print(f"load: {time.perf_counter() - t0:.2f} s real_weights={model.has_real_weights} "
          f"backbone={eng.dtype} kv={eng.kv_dtype} codec={eng.codec_dtype} flow=float32 "
          f"max_seq={eng._rcfg.max_seq}")
    _require(eng.device.type == "cuda", f"engine on {eng.device}")
    # warm-up through both entry points on the measured text: the first launch
    # of each kernel and shape pays for lazy module loading and heuristics
    model.generate(TEXT)
    list(model.generate_stream(TEXT))
    torch.cuda.synchronize()

    # the counted run: every flow evaluation on the path must be a kernel launch
    fb.flow_blocks.launches = 0
    eng.frames_decoded = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    audio = model.generate(TEXT)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches, frames = fb.flow_blocks.launches, eng.frames_decoded
    lsd = model.gen.lsd_decode_steps
    _require(frames > 0, "no frames decoded")
    _require(launches == frames * lsd,
             f"flow_blocks launches {launches} != frames {frames} x lsd_decode_steps {lsd}")
    _require(bool(np.isfinite(audio).all()), "non-finite audio")
    _require(audio.size > 0 and audio.size % model.frame_size == 0,
             f"audio length {audio.size} is not a positive multiple of {model.frame_size}")
    _require(float(audio.std()) > 0, "silent audio")
    secs = audio.size / model.sample_rate
    print(f"main path: generate {len(model.split_into_best_sentences(TEXT))} segments, "
          f"{audio.size // model.frame_size} frames emitted, {frames} decoded, "
          f"flow_blocks launches {launches} = frames x {lsd}; {secs:.2f} s audio in "
          f"{dt * 1e3:.1f} ms: x-realtime {secs / dt:.2f}, ms/frame {dt * 1e3 / frames:.3f}")

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    stream = model.generate_stream(TEXT)
    first = next(stream)
    first_ms = (time.perf_counter() - t0) * 1e3  # fetch_one has synchronized
    rest = list(stream)
    print(f"main path: generate_stream first chunk {first.size // model.frame_size} frames "
          f"in {first_ms:.1f} ms, {1 + len(rest)} chunks")

    model.gen = dataclasses.replace(model.gen, temp=0.0)
    a = model.generate(TEXT)
    b = np.concatenate(list(model.generate_stream(TEXT)))
    _require(a.shape == b.shape, f"stream {b.shape} vs generate {a.shape}")
    lsb = int(np.abs(_pcm(a) - _pcm(b)).max())
    _require(lsb <= 2, f"stream vs generate at temp 0 differ by {lsb} int16 LSB")
    print(f"main path: generate_stream == generate at temp 0 within {lsb} int16 LSB (bound 2)")

    model.gen = dataclasses.replace(model.gen, temp=0.7, eos_threshold=-4.0)
    eng.frames_decoded = 0
    c = model.generate(TEXT)
    _require(bool(np.isfinite(c).all()) and c.size % model.frame_size == 0,
             "default-EOS generate: bad audio")
    budget = sum(model.estimate_generation_steps(s)
                 for s in model.split_into_best_sentences(TEXT))
    _require(c.size // model.frame_size <= budget, "default-EOS generate over budget")
    print(f"main path: default EOS threshold -4.0: {c.size // model.frame_size} frames "
          f"emitted of a {budget}-frame budget ({eng.frames_decoded} decoded)")
    return model, launches


def phase_reference():
    """Full-width model, float32 everywhere, a few frames: card vs CPU."""
    from pocket_tts_tpu_torch import config, text, weights
    from pocket_tts_tpu_torch.runtime.engine import Engine, GenParams

    cfg = config.load_variant()
    cfg = dataclasses.replace(cfg, runtime=dataclasses.replace(cfg.runtime,
                                                               compute_dtype="float32"))
    params, _ = weights.load_params(cfg)
    tok = text.load_tokenizer(None)
    prepared, _ = text.prepare_text_prompt("Hello, world.")
    tokens, n = text.tokens_array(tok, prepared)
    gen = GenParams(temp=0.0, eos_threshold=float("inf"))
    outs = []
    for device in ("cuda", "cpu"):
        eng = Engine(cfg, params, device)
        state = eng.prefill_tokens(eng.new_state(), tokens, n)
        _, pcm, _ = eng.decode_frames(state, 4, gen, torch.Generator(device=device))
        outs.append(pcm.cpu().numpy().astype(np.int64))
    lsb = int(np.abs(outs[0] - outs[1]).max())
    _require(outs[0].shape == outs[1].shape == (1, 4 * cfg.mimi.frame_size), "reference shape")
    _require(lsb <= REF_TOL_LSB, f"card vs CPU (f32, 4 frames) differ by {lsb} int16 LSB")
    print(f"reference: full-width f32, 4 frames, card vs CPU plain: max {lsb} int16 LSB "
          f"(bound {REF_TOL_LSB}), audio std {outs[0].std():.1f} LSB")


def _synthetic_voice(seconds: float, sr: int, seed: int) -> np.ndarray:
    """Seeded voice-like signal [2, T]: 8 harmonics of a 140 Hz fundamental
    with 5.5 Hz vibrato, a syllable-rate envelope, and noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * sr)) / sr
    f0 = 140.0 * (1.0 + 0.03 * np.sin(2 * np.pi * 5.5 * t))
    phase = 2 * np.pi * np.cumsum(f0) / sr
    x = sum(np.sin(k * phase) * 0.25 / k for k in range(1, 9))
    x = x * (0.6 + 0.4 * np.sin(2 * np.pi * 3.0 * t)) + 0.02 * rng.standard_normal(t.size)
    return np.stack([x, 0.9 * x + 0.01 * rng.standard_normal(t.size)]).astype(np.float32)


def _cond_err(got: torch.Tensor, ref: torch.Tensor, what: str) -> float:
    _require(got.shape == ref.shape, f"{what}: shape {tuple(got.shape)} vs {tuple(ref.shape)}")
    _require(bool(torch.isfinite(got).all()), f"{what}: non-finite conditioning")
    ref = ref.to(got.device)
    err = (got - ref).abs().max().item()
    bound = COND_TOL * max(1.0, ref.abs().max().item())
    _require(err <= bound, f"{what}: max abs err {err} > {bound}")
    print(f"voice: {what}: max abs err {err:.3e} (bound {bound:.3e})")
    return err


def _timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def phase_voice(model) -> int:
    """Voice-conditioned synthesis on the card; returns the voiced run's
    flow_blocks launch count."""
    from pocket_tts_tpu_torch import audio, config, weights
    from pocket_tts_tpu_torch.kernels import flow_blocks as fb
    from pocket_tts_tpu_torch.models import flow_lm, mimi
    from pocket_tts_tpu_torch.runtime.engine import Engine, GenParams

    eng, sr = model.engine, model.sample_rate
    tmp = tempfile.TemporaryDirectory()
    wav_path = Path(tmp.name) / "voice.wav"
    pcm = (np.clip(_synthetic_voice(10.0, 44100, seed=0), -1, 1) * 32767).astype("<i2")
    with wave.open(str(wav_path), "wb") as f:
        f.setnchannels(2)
        f.setsampwidth(2)
        f.setframerate(44100)
        f.writeframes(pcm.T.tobytes())
    wav24 = audio.convert_audio(*audio.read_wav(wav_path), sr)[0]

    # 1-2. WAV -> voice state on the card
    vs, _ = _timed(lambda: model.get_voice_state(wav_path))
    frames = -(-wav24.size // model.frame_size)
    _require(all(t.is_cuda for t in (vs.kc, vs.vc, vs.pos)), "voice state not on cuda")
    _require(vs.length == frames == int(vs.pos[0]),
             f"voice length {vs.length} (pos {int(vs.pos[0])}) != ceil({wav24.size} / 1920)")
    wav_ms = statistics.median(_timed(lambda: model.get_voice_state(wav_path))[1]
                               for _ in range(5))
    enc_ms = statistics.median(_timed(lambda: model.get_voice_state_from_audio(wav24))[1]
                               for _ in range(5))
    secs = wav24.size / sr
    print(f"voice: 10 s stereo 44.1 kHz WAV -> {vs.length} frames on {vs.kc.device}; "
          f"get_voice_state(wav path) {wav_ms:.1f} ms, encode+prefill {enc_ms:.1f} ms = "
          f"{enc_ms / secs:.2f} ms per second of prompt (median of 5, synchronized)")

    # 3. the card's conditioning against the CPU's, full width, f32
    short = wav24[: int(2.5 * sr)]
    cfg = config.load_variant()
    cpu_eng = Engine(cfg, weights.load_params(cfg)[0], "cpu")
    _cond_err(eng.encode_voice(short)[0], cpu_eng.encode_voice(short)[0],
              "card vs CPU conditioning, 2.5 s prompt")
    del cpu_eng

    # 4. chunked encode (over the one-shot limit) against the one-shot encoder
    rcfg = eng._rcfg
    long40 = _synthetic_voice(40.0, sr, seed=1)[0]
    _require(long40.size > rcfg.encode_seconds_buckets[-1] * sr, "40 s prompt not chunked")
    torch.cuda.reset_peak_memory_stats()
    (cond_c, n40), chunk_ms = _timed(lambda: eng.encode_voice(long40))
    peak_c = torch.cuda.max_memory_allocated() / 2**30
    x = torch.from_numpy(long40).to(eng.device).reshape(1, 1, -1)
    torch.cuda.reset_peak_memory_stats()

    def one_shot():
        lat = mimi.encode_to_latent(eng.params["mimi"], eng.plans, x, block=rcfg.encoder_block)
        return flow_lm.speaker_project(eng.params["flow_lm"], lat.transpose(1, 2))

    cond_o, oneshot_ms = _timed(one_shot)
    peak_o = torch.cuda.max_memory_allocated() / 2**30
    _require(n40 == 500, f"40 s prompt gave {n40} frames")
    _cond_err(cond_c, cond_o, f"chunked ({-(-n40 // rcfg.voice_prompt_chunk_frames)} chunks "
              f"of {rcfg.voice_prompt_chunk_frames} frames) vs one-shot encode, 40 s prompt")
    print(f"voice: 40 s encode: chunked {chunk_ms:.1f} ms (peak {peak_c:.2f} GiB), "
          f"one-shot {oneshot_ms:.1f} ms (peak {peak_o:.2f} GiB)")
    budget = rcfg.max_seq - eng.prompt_reserve
    long64 = _synthetic_voice(64.0, sr, seed=2)[0]
    torch.cuda.reset_peak_memory_stats()
    vs_c, comp_ms = _timed(lambda: model.get_voice_state_from_audio(long64, overflow="compress"))
    _require(vs_c.length == budget == int(vs_c.pos[0]),
             f"compress: length {vs_c.length} != budget {budget}")
    print(f"voice: overflow=compress, 64 s prompt (800 frames) -> {vs_c.length} frames = "
          f"budget in {comp_ms:.1f} ms (peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB)")

    # 5. voiced generate, every flow evaluation a kernel launch
    lsd = model.gen.lsd_decode_steps
    model.gen = GenParams(temp=0.7, eos_threshold=float("inf"), lsd_decode_steps=lsd)
    fb.flow_blocks.launches = 0
    eng.frames_decoded = 0
    audio_v, dt = _timed(lambda: model.generate(TEXT, vs))
    launches, decoded = fb.flow_blocks.launches, eng.frames_decoded
    _require(decoded > 0 and launches == decoded * lsd,
             f"voiced: flow_blocks launches {launches} != frames {decoded} x {lsd}")
    _require(bool(np.isfinite(audio_v).all()) and audio_v.size % model.frame_size == 0,
             "voiced: bad audio")
    _require(float(audio_v.std()) > 0, "voiced: silent audio")
    secs_v = audio_v.size / sr
    print(f"voice: generate(TEXT, voice) {audio_v.size // model.frame_size} frames emitted, "
          f"{decoded} decoded, flow_blocks launches {launches} = frames x {lsd}; "
          f"{secs_v:.2f} s audio in {dt:.1f} ms: x-realtime {secs_v / dt * 1e3:.2f}, "
          f"ms/frame {dt / decoded:.3f}")
    stream = model.generate_stream(TEXT, vs)
    first, first_ms = _timed(lambda: next(stream))
    stream.close()
    print(f"voice: generate_stream first chunk {first.size // model.frame_size} frames "
          f"in {first_ms:.1f} ms")

    model.gen = dataclasses.replace(model.gen, temp=0.0)
    voiced = model.generate(VOICE_TEXT, vs)
    empty = model.generate(VOICE_TEXT)
    _require(voiced.shape == empty.shape, "voiced vs empty: frame budgets differ")
    moved = int(np.abs(_pcm(voiced) - _pcm(empty)).max())
    _require(moved > 2, f"voiced output equals the empty voice's (max {moved} LSB)")
    print(f"voice: temp 0, voiced vs empty voice differ by up to {moved} int16 LSB")

    # 6. audio_prompt file round trip
    prompt = Path(tmp.name) / "voice.safetensors"
    model.save_voice_prompt(wav24, prompt)
    vs_p = model.get_voice_state(str(prompt))
    _require(vs_p.length == vs.length, f"prompt file: length {vs_p.length} != {vs.length}")
    from_file = model.generate(VOICE_TEXT, vs_p)
    _require(from_file.shape == voiced.shape, "prompt file: shape")
    lsb = int(np.abs(_pcm(from_file) - _pcm(voiced)).max())
    _require(lsb <= 2, f"prompt-file voice vs WAV voice differ by {lsb} int16 LSB")
    print(f"voice: save_voice_prompt -> get_voice_state(.safetensors) -> generate == WAV voice "
          f"within {lsb} int16 LSB (bound 2)")

    # 7. pauses with continuation
    head = model.generate(PAUSE_HEAD, vs)
    out = model.generate_with_pauses(PAUSE_TEXT, vs, continuation_frames=8)
    gap = 500 * sr // 1000
    _require(bool(np.isfinite(out).all()), "pauses: non-finite audio")
    lsb = int(np.abs(_pcm(out[:head.size]) - _pcm(head)).max())
    _require(lsb <= 2, f"pauses: first segment differs from its own generate by {lsb} LSB")
    _require(bool(np.all(out[head.size:head.size + gap] == 0.0)), "pauses: silence not zero")
    tail = out.size - head.size - gap
    _require(tail > 0 and tail % model.frame_size == 0,
             f"pauses: {tail} samples after the silence")
    print(f"voice: generate_with_pauses(continuation_frames=8): {head.size} + {gap} zero + "
          f"{tail} samples; silence exact, first segment within {lsb} LSB of its own generate")
    tmp.cleanup()
    return launches


BATCH_SENTENCES = (
    "The morning train left the station exactly on time.",
    "She opened the window and listened to the rain.",
    "Numbers on the screen changed faster than anyone could read them.",
    "A small boat drifted slowly across the quiet lake.",
    "He wrote the letter twice before he finally sent it.",
    "The library stays open late on every Thursday evening.",
    "Bright lights from the city reflected on the dark water.",
    "Our team finished the project two days ahead of schedule.",
)
STREAM_HEAD, STREAM_TAIL = "Streaming arrives under load.", "Then it finishes cleanly."
STREAM_TEXT = f"{STREAM_HEAD} [pause:200ms] {STREAM_TAIL}"


def _budget(model, text: str) -> int:
    """Frames the stop rule emits with EOS disabled: each sentence chunk's
    frame budget (texts here have no comma or ellipsis pauses)."""
    return sum(model.estimate_generation_steps(s) for s in model.split_into_best_sentences(text))


def _device_busy(trace_path: Path) -> tuple[float, list]:
    """(ms the device was busy, top kernels [(name, ms)]) from a chrome trace:
    the union of kernel, memcpy and memset intervals."""
    events = [e for e in json.loads(trace_path.read_text())["traceEvents"]
              if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset") and "dur" in e]
    busy, end = 0.0, float("-inf")
    for start, dur in sorted((float(e["ts"]), float(e["dur"])) for e in events):
        if start + dur > end:
            busy += start + dur - max(start, end)
            end = start + dur
    by_name: dict[str, float] = {}
    for e in events:
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + float(e["dur"]) / 1e3
    return busy / 1e3, sorted(by_name.items(), key=lambda kv: -kv[1])[:5]


def _batch_exactness():
    """(a) float32 lanes of a B=4 batcher against the single stream."""
    from pocket_tts_tpu_torch import config, weights
    from pocket_tts_tpu_torch.kernels import flow_blocks as fb
    from pocket_tts_tpu_torch.runtime.batcher import ContinuousBatcher
    from pocket_tts_tpu_torch.runtime.engine import GenParams
    from pocket_tts_tpu_torch.tts import TTSModel

    cfg = config.load_variant()
    cfg = dataclasses.replace(cfg, runtime=dataclasses.replace(cfg.runtime,
                                                               compute_dtype="float32"))
    base = GenParams(temp=0.0, eos_threshold=float("inf"))
    m32 = TTSModel(cfg, weights.load_params(cfg)[0], gen=base, has_real_weights=False,
                   device="cuda")
    texts = ["Hello there from the first lane.", "Two flow steps in the second lane.",
             "A clamped third lane speaks.", "Fourth lane. [pause:300ms] After the pause."]
    gens = [base, dataclasses.replace(base, lsd_decode_steps=2),
            dataclasses.replace(base, noise_clamp=0.5), base]
    singles = []
    for text, gen in zip(texts, gens):
        m32.gen = gen
        singles.append(m32.generate_with_pauses(text))
    m32.gen = base
    b = ContinuousBatcher(m32, batch_size=4, chunk_frames=8)
    b.start()
    try:
        launches, evals = fb.flow_blocks.launches, b.engine.flow_evals
        results = b.generate_batch(texts, gens=gens)
        launches, evals = fb.flow_blocks.launches - launches, b.engine.flow_evals - evals
    finally:
        b.stop()
    _require(launches == evals > 0, f"f32 batch: launches {launches} != flow evaluations {evals}")
    worst = 0
    for text, got, want in zip(texts, results, singles):
        _require(got.shape == want.shape, f"f32 batch {text!r}: {got.shape} vs {want.shape}")
        worst = max(worst, int(np.abs(_pcm(got) - _pcm(want)).max()))
    _require(worst <= REF_TOL_LSB, f"f32 batch lanes vs single stream: {worst} int16 LSB")
    print(f"batch: f32 full width, B=4 chunk 8, 4 concurrent temp-0 requests (lsd 1/2/1/1, "
          f"clamp -/-/0.5/-, one pause) == single stream within {worst} int16 LSB "
          f"(bound {REF_TOL_LSB}); {launches} flow_blocks launches = flow evaluations")
    del m32, b
    torch.cuda.empty_cache()


def _batch_streaming(b, model, voice=None) -> None:
    """(c) 8 streams arriving while 8 multi-segment whole-WAV requests fill
    the batch."""
    import threading

    hog_text = TEXT
    d0 = b.stats()["dispatches"]
    hogs = [b.submit(hog_text, voice, latency_sensitive=False) for _ in range(8)]
    deadline = time.monotonic() + 120
    while b.stats()["queued_segments"] or b.stats()["dispatches"] == d0:
        _require(time.monotonic() < deadline, f"hogs never filled the batch: {b.stats()}")
        time.sleep(0.005)  # every hog segment admitted and decoding
    pre = b.stats()["preemptions"]
    firsts, outs, errors = [None] * 8, [None] * 8, []

    def arrive(i):
        try:
            t0 = time.perf_counter()
            chunks = []
            for c in b.stream(STREAM_TEXT, voice):
                if not chunks:
                    firsts[i] = (time.perf_counter() - t0) * 1e3
                chunks.append(c)
            outs[i] = chunks
        except Exception as e:  # noqa: BLE001 - reported and failed below
            errors.append(repr(e))

    threads = []
    for i in range(8):
        threads.append(threading.Thread(target=arrive, args=(i,)))
        threads[-1].start()
        time.sleep(0.1)
    for t in threads:
        t.join(timeout=300)
    _require(not errors and not any(t.is_alive() for t in threads), f"streams: {errors}")
    head, tail = _budget(model, STREAM_HEAD), _budget(model, STREAM_TAIL)
    gap = 200 * model.sample_rate // 1000
    fs = model.frame_size
    for chunks in outs:
        audio = np.concatenate(chunks)
        _require(audio.size == (head + tail) * fs + gap,
                 f"stream length {audio.size} != ({head} + {tail}) x {fs} + {gap}")
        _require(bool(np.isfinite(audio).all()) and float(audio[: head * fs].std()) > 0,
                 "stream: bad head audio")
        _require(not audio[head * fs: head * fs + gap].any()
                 and float(audio[head * fs + gap:].std()) > 0,
                 "stream: segments out of order (the pause is not where it belongs)")
    hog_len = _budget(model, hog_text) * fs
    for q in hogs:
        chunks = []
        while isinstance(item := q.get(timeout=300), np.ndarray):
            chunks.append(item)
        _require(sum(c.size for c in chunks) == hog_len, "whole-WAV request under load: length")
    p50, p90 = np.percentile(firsts, 50), np.percentile(firsts, 90)
    print(f"batch: streaming under load (8 arrivals 100 ms apart while 8 two-segment whole-WAV "
          f"requests fill 16 slots): first chunk p50 {p50:.1f} ms p90 {p90:.1f} ms "
          f"(max {max(firsts):.1f}), preemptions {b.stats()['preemptions'] - pre}; every stream "
          f"complete with its pause in place")


def _batch_cli(model) -> None:
    """(d) The CLI's batch and generate commands as subprocesses."""
    import wave as wave_mod

    root = Path(__file__).resolve().parent
    tmp = tempfile.TemporaryDirectory()
    d = Path(tmp.name)
    voice = d / "voice.wav"
    pcm = (np.clip(_synthetic_voice(3.0, 24000, seed=5), -1, 1) * 32767).astype("<i2")
    with wave_mod.open(str(voice), "wb") as f:
        f.setnchannels(2)
        f.setsampwidth(2)
        f.setframerate(24000)
        f.writeframes(pcm.T.tobytes())
    lines = [BATCH_SENTENCES[0], BATCH_SENTENCES[1],
             json.dumps({"text": BATCH_SENTENCES[2], "voice": str(voice), "output": "voiced.wav"}),
             BATCH_SENTENCES[3]]
    (d / "manifest.txt").write_text("\n".join(lines) + "\n", encoding="utf-8")
    names = ["00000.wav", "00001.wav", "voiced.wav", "00003.wav"]
    texts = [BATCH_SENTENCES[i] for i in range(4)]
    common = ["--device", "cuda", "--eos-threshold", "inf", "--quiet"]
    runs = [(["batch", "--manifest", str(d / "manifest.txt"), "--out-dir", str(d / "out")],
             [(d / "out" / n, t) for n, t in zip(names, texts)]),
            (["generate", "--text", TEXT, "-o", str(d / "gen.wav")], [(d / "gen.wav", TEXT)])]
    for args, wavs in runs:
        t0 = time.perf_counter()
        res = subprocess.run([sys.executable, "-m", "pocket_tts_tpu_torch.cli", *args, *common],
                             cwd=root, capture_output=True, text=True, timeout=600)
        dt = time.perf_counter() - t0
        _require(res.returncode == 0, f"cli {args[0]}: exit {res.returncode}\n{res.stderr[-3000:]}")
        _require("device: cuda" in res.stderr, f"cli {args[0]}: no cuda device line")
        for path, text in wavs:
            with wave_mod.open(str(path), "rb") as f:
                got = (f.getframerate(), f.getnchannels(), f.getnframes())
            want = (24000, 1, _budget(model, text) * model.frame_size)
            _require(got == want, f"cli {args[0]} {path.name}: (rate, channels, samples) "
                                  f"{got} != {want}")
        last = [ln for ln in res.stderr.splitlines() if "realtime" in ln]
        print(f"batch: cli {args[0]} --device cuda: exit 0 in {dt:.1f} s, {len(wavs)} WAV(s) "
              f"of the expected lengths; {last[-1].strip() if last else ''}")
    tmp.cleanup()


def phase_batch(model) -> int:
    """Continuous-batched synthesis; returns the flow_blocks launch count of
    the B=16 whole-WAV run."""
    from pocket_tts_tpu_torch.kernels import flow_blocks as fb
    from pocket_tts_tpu_torch.runtime.batcher import batched_tts
    from pocket_tts_tpu_torch.runtime.engine import GenParams

    _batch_exactness()

    # (b) throughput at B=16 on the bf16 model, temp 0.7, EOS disabled
    model.gen = GenParams(temp=0.7, eos_threshold=float("inf"))
    b = batched_tts(model, batch_size=16, chunk_frames=64)
    try:
        t0 = time.perf_counter()
        b.warmup()
        warm_s = time.perf_counter() - t0
        texts = [f"{BATCH_SENTENCES[i % 8]} {BATCH_SENTENCES[(i + 3) % 8]}" for i in range(32)]
        eng = b.engine
        torch.cuda.synchronize()
        fb.flow_blocks.launches = 0
        eng.flow_evals = eng.frames_decoded = 0
        stats0 = b.stats()
        t0 = time.perf_counter()
        results = b.generate_batch(texts)
        wall = time.perf_counter() - t0
        launches, evals = fb.flow_blocks.launches, eng.flow_evals
        st = b.stats()
        _require(launches == evals > 0,
                 f"B=16: flow_blocks launches {launches} != sum of chunk x step ceiling {evals}")
        for text, audio in zip(texts, results):
            want = _budget(model, text) * model.frame_size
            _require(audio.size == want, f"B=16 {text!r}: {audio.size} samples != {want}")
            _require(bool(np.isfinite(audio).all()) and float(audio.std()) > 0,
                     f"B=16 {text!r}: non-finite or silent audio")
        secs = sum(a.size for a in results) / model.sample_rate
        dispatches = st["dispatches"] - stats0["dispatches"]
        useful = st["useful_frames"] - stats0["useful_frames"]
        decoded = st["frames_decoded"] - stats0["frames_decoded"]
        print(f"batch: batched_tts B=16 chunk 64, warmup {warm_s:.2f} s; 32 whole-WAV requests "
              f"via generate_batch: {secs:.2f} s audio in {wall * 1e3:.1f} ms = aggregate "
              f"x-realtime {secs / wall:.2f}; useful_ratio {useful / decoded:.3f} "
              f"({useful} of {decoded} slot-frames), {dispatches} dispatches, "
              f"{st['early_retirements'] - stats0['early_retirements']} early retirements, "
              f"flow_blocks launches {launches} = sum of chunk x step ceiling, "
              f"{eng.frames_decoded} frames dispatched: {wall * 1e3 / eng.frames_decoded:.3f} "
              f"ms per B=16 frame")

        # device busy share of a short run: profiled device time over the
        # wall of the same run unprofiled
        short = [BATCH_SENTENCES[i % 8] for i in range(16)]
        t0 = time.perf_counter()
        b.generate_batch(short)
        short_wall = (time.perf_counter() - t0) * 1e3
        trace = Path(tempfile.mkdtemp()) / "batch_trace.json"
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            b.generate_batch(short)
            prof_wall = (time.perf_counter() - t0) * 1e3
        prof.export_chrome_trace(str(trace))
        busy, top = _device_busy(trace)
        trace.unlink()
        if busy > 0:
            print(f"batch: device busy {busy:.1f} ms over a {short_wall:.1f} ms unprofiled wall "
                  f"(16 one-sentence requests, B=16): busy share {busy / short_wall:.3f} "
                  f"(profiled wall {prof_wall:.1f} ms); top kernels "
                  + ", ".join(f"{n[:40]} {ms:.1f} ms" for n, ms in top))
        else:
            print("batch: device busy share not measured (the trace holds no device events)")

        _batch_streaming(b, model)
    finally:
        b.stop()

    # ms per admission: one fused admit + text prefill, synchronized
    from pocket_tts_tpu_torch import text as text_mod

    prepared, _ = text_mod.prepare_text_prompt(BATCH_SENTENCES[0])
    tokens, n = text_mod.tokens_array(model.tokenizer, prepared)
    state = eng.new_state(16)
    row, vs = eng.pad_token_row(tokens), model.get_voice_state().as_dict()
    times = [_timed(lambda: eng.admit_prefill_slot(state, i % 16, vs, row, n))[1]
             for i in range(21)][1:]
    print(f"batch: admission (voice install + {n}-token text prefill on one lane of 16): "
          f"{statistics.median(times):.2f} ms median of 20, synchronized")
    del state
    _batch_cli(model)
    return launches


def main() -> None:
    kind = phase_environment()
    phase_build()
    dev = torch.device("cuda")
    kern = phase_kernel(dev)
    model, launches = phase_main_path()
    phase_reference()
    voice_launches = phase_voice(model)
    batch_launches = phase_batch(model)
    per_b = {key: {str(b): kern[b][key] for b in TIMED_BATCHES}
             for key in ("device_us_cold", "device_us_warm", "bound_us", "roofline_share",
                         "graph_plain_us", "graph_plain_us_warm")}
    print(json.dumps({"kernels": [{
        "name": "flow_blocks", "route": "cuda",
        "source": "pocket_tts_tpu_torch/csrc/flow_blocks.cu",
        "replaces": "pocket_tts_tpu/ops/pallas/flow_kernel.py:107",
        "launches": launches, "launches_voice": voice_launches,
        "launches_batch": batch_launches,
        "max_abs_err": kern["max_abs_err"],
        "ms": kern[1]["ms"], "plain_ms": kern[1]["plain_ms"],
        "bound_ms": kern[1]["bound_us"] / 1e3, "bound_by": kern[1]["bound_by"],
        "library_ms": None,
        "ms_b4": kern[4]["ms"], "plain_ms_b4": kern[4]["plain_ms"],
        "ms_b16": kern[16]["ms"], "plain_ms_b16": kern[16]["plain_ms"],
        **per_b,
    }]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
