"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each raises on failure; the script exits non-zero and prints no
result line):

1. Environment: the card's name and power limit (nvidia-smi), torch and CUDA
   versions.  No CUDA device -> exit 1.
2. Build: every CUDA kernel of the main path, with nvcc, from the sources in
   this checkout (into build/pocket_tts_tpu_torch/).
3. Kernel against plain: ``flow_blocks`` at flagship dims (dim 512, depth 6,
   B in {1, 16}) against its plain PyTorch version, float32 with TF32 off;
   median times over 100 runs with CUDA events.
4. Main path: ``TTSModel.load`` of the flagship variant (random weights from
   a seed; bf16 backbone, f32 flow net and codec) with an unreachable EOS
   threshold, ``generate`` of three sentences with the kernel launch count
   checked against frames x lsd_decode_steps, first-chunk latency of
   ``generate_stream``, stream-vs-generate at temp 0, and one ``generate`` at
   the default EOS threshold.
5. Reference: a few frames of the full-width model in float32 on the card
   against the same model on the CPU (plain versions everywhere).

The last two lines are a JSON summary of the kernels and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

TEXT = ("The quick brown fox jumps over the lazy dog near the river bank. "
        "Streaming speech synthesis turns text into audio one frame at a time. "
        "Each frame carries eighty milliseconds of sound.")
KERNEL_TOL = 1e-4  # f32 sums in another order over six chained 512-wide products
REF_TOL_LSB = 2  # int16 LSB: f32 on the card vs f32 on the CPU, after PCM rounding


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


def phase_kernel(dev) -> dict:
    from pocket_tts_tpu_torch.kernels import flow_blocks as fb

    g = torch.Generator().manual_seed(0)
    dim, depth = 512, 6
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
    blocks = {k: v.to(dev) for k, v in blocks.items()}
    out = {}
    for batch in (1, 16):
        sy = torch.nn.functional.silu(torch.randn(batch, dim, generator=g)).to(dev)
        h0 = torch.randn(batch, dim, generator=g).to(dev)
        got = fb.flow_blocks(sy, h0, blocks)
        torch.cuda.synchronize()
        ref = fb.flow_blocks_reference(sy, h0, blocks)
        err = (got - ref).abs().max().item()
        _require(bool(torch.isfinite(got).all()), f"flow_blocks B={batch}: non-finite output")
        _require(err <= KERNEL_TOL, f"flow_blocks B={batch}: max abs err {err} > {KERNEL_TOL}")
        ms = _median_ms(lambda: fb.flow_blocks(sy, h0, blocks))
        plain_ms = _median_ms(lambda: fb.flow_blocks_reference(sy, h0, blocks))
        print(f"kernel flow_blocks B={batch} dim={dim} depth={depth}: max_abs_err {err:.3e} "
              f"(tol {KERNEL_TOL}) kernel {ms:.4f} ms plain {plain_ms:.4f} ms "
              f"(median of 100, CUDA events)")
        out[batch] = {"err": err, "ms": ms, "plain_ms": plain_ms}
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
    return launches, audio


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


def main() -> None:
    kind = phase_environment()
    phase_build()
    dev = torch.device("cuda")
    kern = phase_kernel(dev)
    launches, _ = phase_main_path()
    phase_reference()
    print(json.dumps({"kernels": [{
        "name": "flow_blocks", "route": "cuda",
        "source": "pocket_tts_tpu_torch/csrc/flow_blocks.cu",
        "replaces": "pocket_tts_tpu/ops/pallas/flow_kernel.py:107",
        "launches": launches,
        "max_abs_err": max(k["err"] for k in kern.values()),
        "ms": kern[1]["ms"], "plain_ms": kern[1]["plain_ms"],
        "ms_b16": kern[16]["ms"], "plain_ms_b16": kern[16]["plain_ms"],
    }]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
