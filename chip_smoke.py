"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each raises on failure; the script exits non-zero and prints no
result line):

1. Environment: the card's name and power limit (nvidia-smi), torch and CUDA
   versions.  No CUDA device -> exit 1.
2. Build: every CUDA kernel of the main path (flow_blocks, qlinear,
   decode_attention), one nvcc per source started together, from the
   sources in this checkout (into build/pocket_tts_tpu_torch/).
3. Kernel against plain: ``flow_blocks`` (one cooperative launch per call)
   against its plain PyTorch version at every shape of ``KERNEL_SHAPES``,
   float32 with TF32 off; a lane alone against the same lane inside B=16,
   bit for bit; one call captured in a CUDA graph against eager; then at
   dim 512, depth 6, B in {1, 4, 16}: cold and warm device us from CUDA
   graphs, the bound and roofline share, the plain chain in a CUDA graph as
   the yardstick, and the wrapper's median ms over 100 runs (the method
   of the kernel's earlier rows in PERF.md).  Then ``decode_attention``:
   its launch plans at S = 1024, B 1 and 16 (a cluster of one CTA a rank or
   a CTA alone, threads, shared bytes, logical ranks, keys a rank), the
   kernel against its plain version at B in {1, 4, 16}, S = 1024, per-slot
   pos over 0, 1, 511, 1023 and past S (B = 1 also at pos that leave ranks
   idle and on rank edges), for q bf16 on bf16 / e4m3fn / e5m2 caches and q
   f32 on an f32 cache; a lane alone against the same lane in B=16, B=16 in
   clusters of 8 and alone with 1 .. 4 teams against its plan's, and a
   CUDA-graph replay against eager, bit for bit; at B in {1, 16} with every lane at pos 255 / 511 /
   767 (B=16 also at 64 / 128) on bf16 and e4m3fn caches: cold
   and warm device us, the bound (the K/V bytes up to pos), the plain route
   in a CUDA graph and F.scaled_dot_product_attention on the bf16 cache
   (timed only), in turns.
4. Main path: ``TTSModel.load`` of the flagship variant (random weights from
   a seed; bf16 backbone, f32 flow net and codec) with an unreachable EOS
   threshold, ``generate`` of three sentences with the kernel launch count
   checked against frames x lsd_decode_steps, first-chunk latency of
   ``generate_stream``, stream-vs-generate at temp 0, and one ``generate`` at
   the default EOS threshold; a torch.profiler window over a short B=1
   ``generate``: device ms per frame, busy share, launches per frame, the
   top kernels by name, the decode attention kernels' device ms and
   launches per frame.  Every path from here on checks its
   ``decode_attention`` launches against its decoded frames x 6 layers
   (summed over dispatches on the batcher) and prints ``large_t``.
4b. Segment: whole-utterance ``generate`` through ``Engine.decode_segment``
   (``segment_dispatch="auto"``, the default) on the main path's model,
   against a ``segment_dispatch="chunked"`` clone at temp 0.  (a) EOS
   unreachable (threshold 1e9): every segment fused, frames decoded =
   frames emitted, against the chunk schedule's decoded frames.  (b) A
   threshold between two of the first segment's temp-0 EOS logits, crossed
   nearest mid-budget, with the default ``frames_after_eos`` and with 0:
   each segment's n_valid the stop rule's, at most SEGMENT_POLL +
   SEGMENT_MAX_LAG frames decoded past it.  Every run: equal frame counts
   and audio within ``REF_TOL_LSB``, flow_blocks launches = frames decoded x
   lsd_decode_steps and decode_attention launches = frames decoded x layers.
   (d) Wall ms per frame and x-realtime, fused and chunked in turns.  (e) A
   YAML variant (the flagship's file plus a ``segment_buckets`` override) in
   a temporary ./config/ loaded with ``TTSModel.load`` on the card and
   generated in the override's bucket; ``save_checkpoint`` ->
   ``load_with_params`` bit-identical at temp 0; ``mimi.decode_batch``
   against the streaming decode within 2e-4.
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
   aggregate x-realtime, ``useful_ratio``, the profile of a short run (as
   the main path's, per B=16 step), and ms per admission.  (c) 8 streams arriving while 8
   multi-segment whole-WAV requests fill the batch: first-chunk p50/p90,
   preemptions, each stream's segments in order.  (d) The CLI as
   subprocesses: ``batch --device cuda`` on a 4-line manifest (one JSONL line
   with a voice WAV) and ``generate --device cuda -o``.
8. Narrow: int8 / int4 weights, the fp8 KV cache and the mu-law wire at full
   width.  (a) ``qlinear`` against its plain version at M in {1, 4, 16, 32}
   x the frame's (N, K), int8 and int4, bf16 x (tensor cores) and f32 x, an
   odd shape and the stacked in_proj view, each within its stated
   tolerance; each shape's ``launch_plan``; on the tensor-core route a row
   of x alone against the same row inside M=16 and M=32, bit for bit, at the
   three backbone shapes, int8 and int4; on the f32 route the flow net's
   three shapes at M 1 / 16 / 32 and a row alone against M=16 and M=32, bit
   for bit; one call replayed from a CUDA graph against eager.  (b) Cold and warm
   device us of ``qlinear`` (bf16 x) from CUDA graphs as in phase 3, the
   bound and share, the plain version, ``F.linear`` on the unquantized bf16
   weight and ``torch._weight_int8pack_mm`` as yardsticks, and the wrapper's
   median ms; the same for f32 x (the flow net's in_w, final_ada_w and
   final_w at M in {1, 16}) with ``F.linear`` on the f32 weight.  (c) ``quantize_model(bits=8)``: tensors, SNR, the artifact's
   round trip bit for bit and its size.  (d) The int8 and int4 models in
   f32 on the card against the CPU, 4 frames.  (e) ``generate`` on int8,
   int4, int8 + fp8 e4m3 KV and int8 + fp8 + mu-law, with the flow_blocks
   and qlinear launch counts checked (qlinear against the count the shape
   rule predicts for every call the engine made), ms/frame and x-realtime;
   int8 against bf16 at temp 0.  (e2) int8 + fp8 e4m3 with a cloned voice
   and ``continuation_frames=8``: the voice state's bytes unchanged, two
   temp-0 runs bit-identical, launch counts as predicted; and in f32 a
   conditioning prefill plus a continuation prefill into a copy of the
   voice, 4 frames, card vs CPU within ``REF_TOL_LSB``.  (f) mu-law encode
   on the card over every
   int16 value, and mu-law ``generate`` against int16 within one step.  (g)
   ``batched_tts(16, 64)`` on int8 + fp8: 16 requests, launch counts
   checked.  (h) ``quantize --device cuda`` and ``generate --quantized
   --device cuda`` as subprocesses.
9. Serve: the HTTP tier's request layer (``server/app.py``, driven without
   aiohttp, which this machine lacks) in one asyncio loop, on the bf16 model
   behind ``build_state(model, batch_size=16)`` (``start_server``'s batcher
   and warmup).  (a) A lone temp-0 ``/generate`` (and one with lsd_steps 2)
   takes the single stream and equals ``generate_with_pauses`` bit for bit.
   (b) 16 concurrent requests (8 /generate, 4 /stream, 2 OpenAI speech, 2
   with lsd_steps 2 and a noise clamp): at least 15 ride the batcher, every
   body has its frame budget's samples, a batched temp-0 lane correlates
   >= 0.99 with its single stream; wall, aggregate x-realtime, p50/p90 per
   request and the streams' first PCM bytes.  (c) A 3 s base64 voice:
   encoded once, then a cache hit.  (d) Five client errors -> RequestError
   400.  (e) A stream closed after its first chunk cancels its batcher
   request.  (f) /metrics and /health.  (g) 1 lone + 4 concurrent requests
   on the int8 + fp8 model, qlinear launches against the shape rule.
   ``flow_blocks`` launches over the phase equal the engines' flow
   evaluations.
10. Train: fine-tuning and per-slot LoRA at full width, with seeded
   synthetic voices as the training audio.  (a) ``flow_matching_loss`` in
   float32 (TF32 off) at fixed params, batch and draws, with the
   consistency term: the loss, each metric and each gradient leaf on the
   card against the CPU, within ``LOSS_TOL`` / ``GRAD_TOL``.  (b)
   ``flow_blocks`` and ``qlinear`` raise under autograd.  (c) ``finetune``
   on 8 pairs of 2-6 s for 8 steps: the loss at each step, ms per step
   (median, synchronized), peak GiB; ``save_finetuned_params`` ->
   ``apply_adapted`` bit-equal; a temp-0 ``generate`` of the tuned model
   with flow_blocks launches = frames x steps.  (d) The same with
   ``lora_rank=8``: the base params bit-unchanged, the factor artifact's
   round trip.  (e) Two adapters (ranks 2 and 3, the second on two targets)
   and the base on a float32 B=4 ``ContinuousBatcher``: each lane against
   its merged single stream within ``REF_TOL_LSB``.  (f) ``batched_tts(16,
   64)`` on the bf16 model, 16 requests over base / one / two, with and
   without the bank in turns (aggregate x-realtime); then the bank on int8
   + fp8 with the qlinear launches against the shape rule.  (g) ``cli
   finetune --lora-rank 8`` and ``generate --finetuned`` as subprocesses,
   then the request layer with that adapter (on the batcher) and the full
   fine-tune (on its merged model).

11. Mesh: multi-device serving on this card.  (a) ``make_mesh()`` over the
   machine's cards (dp x tp, 1 x 1 on one card) and its shard report; the
   flagship's ``sharding_manifest`` at tp 2 / 4 / 8 over [card] x 8, the
   twelve transformer products of tests/test_sharding.py:182-189 sharded at
   each.  (b) float32 mesh engines on repeated devices against one device on
   the same weights: tp 2 at B = 2 (prefill + 2 chunks, audio within
   ``MESH_LSB``, latents within ``MESH_LATENT_TOL``), and dp 2 x tp 2 at B =
   4 with two requests of other synthetic voices and texts admitted through
   ``admit_prefill_slot`` (each lane within ``MESH_LSB``, the requests
   apart; its launches counted: flow_blocks = frames x steps x dp,
   decode_attention = frames x 6 x dp x tp).  (c) bf16 and int8 engines at tp 2, B = 1: ``qlinear`` on the
   int8 engine's own shards (and int4 at their shapes) and
   ``decode_attention`` on each rank's cache shard (8 heads) against their
   plain versions; the counted run of the mesh path (flow_blocks = frames x
   steps x dp, decode_attention = frames x 6 x dp x tp, qlinear = the shape
   rule's, each rank its shards); two runs bit for bit; the gap to one
   device; ms per frame against one device in turns.  (d) The codec staged on a CUDA stream of
   its own (chunk schedule): ``generate`` and ``generate_stream`` bit for
   bit the unstaged model's, ``generate`` within 1 LSB of the fused segment,
   a profile window with the codec's kernels on a stream of their own, the
   ``profile`` lines of both (device ms, busy share and launches per
   frame), and x-realtime staged and unstaged in turns.  Each kernel's entry of the
   JSON line gains ``launches_mesh``, the counts of (c)'s counted run, and
   flow_blocks' and decode_attention's ``launches_mesh_dp2``, those of (b)'s
   dp 2 x tp 2 run.
12. Mesh training: float32 (TF32 off) at full width on [card] x n.  (a) One
   dp 2 x tp 2 step, full and LoRA (rank 8), on 4 pairs of unequal lengths,
   against the one-device step with the same draws: the loss within
   ``MESH_LOSS_RTOL``, ``grad_norm`` within ``MESH_NORM_RTOL``, each leaf's
   clipped gradient within ``GRAD_TOL``, the params after the step within
   ``MESH_PARAM_TOL`` (tests/test_training.py:338-345).  (b)
   ``finetune(mesh=)`` against ``finetune()`` for ``MESH_TRAIN_STEPS``
   steps, full and LoRA: the per-step losses within ``MESH_LOSS_RTOL``, ms
   per step (median, synchronized) and peak GiB of each, the tuned trees'
   gap, the clone a single-device model.  (c) (a) and (b) launched no hand
   kernel.  (d) The adapter bank on an int8 tp 2 engine (f32 compute), B =
   4, two adapters and the base, admitted with their rows: each lane against
   the one-device bank within ``MESH_LSB`` / ``MESH_LATENT_TOL``; the
   counted run (flow_blocks = frames x steps x dp, decode_attention = frames
   x 6 x dp x tp, qlinear the shape rule's).  (e) The codec staged on a
   stream of its own on a tp 2 B = 1 engine: ``generate`` bit for bit the
   unstaged tp 2 engine's, the codec's kernels on their own stream.  Each
   kernel's entry of the JSON line gains ``launches_mesh_adapters``, the
   counts of (d).

13. The installed port: the port's wheel is built from a copy of this
   checkout's sources (``copy_wheel_sources``; ``pip wheel --no-deps
   --no-build-isolation --no-index``) and installed with ``pip install
   --no-deps --target`` into a temporary site; either pip failing, or no
   ``site/bin/pocket-tts-tpu-torch``, fails the phase.  A subprocess at the
   temporary directory, with the install as its whole PYTHONPATH and a
   fresh XDG_CACHE_HOME, imports the port from the install (its
   ``__file__``, ``BUILD_DIR`` and kernel sources checked), builds the three
   kernels from the install's csrc/ into the fresh cache (timed), runs phase
   4's temp-0 ``generate`` of ``TEXT`` on the same seeded weights and an
   int8 ``generate`` of ``NARROW_TEXT``, each under the launch counters
   (flow_blocks = frames x steps, decode_attention = frames x 6, qlinear on
   int8 only), and finds no jax or pocket_tts_tpu module loaded; meanwhile
   this process repeats phase 4's ``generate`` and makes the same int8
   audio.  Then the installed ``pocket-tts-tpu-torch generate --temperature
   0 --eos-threshold inf`` writes a WAV.  Nothing under the install changed
   and the cache holds the three libraries.  The install's audio and the
   command's WAV against this process's: bit for bit, or the max |diff| in
   int16 LSB beside its own repeat's, within ``REF_TOL_LSB``.  Each
   kernel's entry of the JSON line gains ``launches_installed``.

The last two lines are a JSON summary of the kernels and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import asyncio
import base64
import collections
import contextlib
import dataclasses
import io
import json
import logging
import math
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


def phase_environment() -> tuple[str, str]:
    """(the device's name, nvidia-smi's name and power limit line)."""
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
    return kind, smi


def phase_build():
    """The three kernels' nvcc builds, started together."""
    from concurrent.futures import ThreadPoolExecutor

    from pocket_tts_tpu_torch.kernels import decode_attention as da
    from pocket_tts_tpu_torch.kernels import flow_blocks as fb
    from pocket_tts_tpu_torch.kernels import qlinear as ql

    t0 = time.perf_counter()
    with ThreadPoolExecutor(3) as pool:
        paths = [f.result() for f in [pool.submit(mod.build) for mod in (fb, ql, da)]]
    print(f"build: {', '.join(p.name for p in paths)} in {time.perf_counter() - t0:.2f} s "
          f"(one nvcc per source, in parallel)")
    # nvcc -Xptxas -v, one line per kernel instantiation: flow_chain_kernel<group,
    # float4 chunks per lane>, qlinear_mma_kernel<8-row tiles of x, packed int4>,
    # qlinear_f32_kernel<rows of x, packed int4>, decode_attention_kernel and
    # decode_attention_solo_kernel<q type, cache kind (0 f32, 1 bf16, 2 e4m3, 3 e5m2)>
    for path in paths:
        entry, spill = "?", ""
        for line in path.with_suffix(".ptxas.txt").read_text().splitlines():
            if "Compiling entry function" in line:
                m = (re.search(r"\d([a-z_]+_kernel)ILi(\d+)ELi(\d+)E", line)
                     or re.search(r"\d(qlinear_(?:mma|f32)_kernel)ILi(\d+)ELb(\d)E", line)
                     or re.search(r"\d(decode_attention_(?:solo_)?kernel)I(f|13__nv_bfloat16)"
                                  r"Li(\d)E", line))
                entry = f"{m[1]}<{', '.join(m.groups()[1:])}>" if m else line.strip()
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


# -- phase 3 (b): decode attention ---------------------------------------------

DECODE_SHAPE = (1024, 16, 64)  # S = max_seq, H, D of the flagship's FlowLM
DECODE_BATCHES = (1, 4, 16)
# per-slot pos, cycled over the lanes: 1029 >= S is a full cache
DECODE_POS = (0, 1, 511, 1023, 1029)
# B = 1 also at pos that leave ranks of the cluster idle (one rank busy up
# to pos 127) and on the edges where a rank joins (127 / 128 / 129, 255 /
# 256 / 257, 383 / 384 / 385)
DECODE_POS_B1 = DECODE_POS + (2, 7, 100, 127, 128, 129, 255, 256, 257, 383, 384, 385)
DECODE_TIMED_POS = (255, 511, 767)
DECODE_TIMED_BATCHES = (1, 16)  # the main path's and the batcher's B
DECODE_BATCHER_POS = (64, 128)  # B = 16 also where the batcher's lanes run (pos ~20-170)


# (q dtype, cache dtype): the bf16 model on its bf16 and fp8 caches, the f32 model
DECODE_DTYPES = ((torch.bfloat16, torch.bfloat16), (torch.bfloat16, torch.float8_e4m3fn),
                 (torch.bfloat16, torch.float8_e5m2), (torch.float32, torch.float32))


def _decode_inputs(gd, b: int, q_dtype, kv_dtype, pos_values, dev):
    s, h, d = DECODE_SHAPE
    q = torch.randn(b, 1, h, d, generator=gd, device=dev).to(q_dtype)
    k = torch.randn(b, s, h, d, generator=gd, device=dev).to(kv_dtype)
    v = torch.randn(b, s, h, d, generator=gd, device=dev).to(kv_dtype)
    pos = torch.tensor([pos_values[i % len(pos_values)] for i in range(b)], dtype=torch.int32,
                       device=dev)
    return q, k, v, pos


def _decode_cost(b: int, p: int, q_dtype, kv_dtype) -> tuple[int, int]:
    """(bytes, FLOP) of one call with every lane at pos p: the K and V rows up
    to p read once at storage width, q read and out written once, pos read."""
    s, h, d = DECODE_SHAPE
    n = min(p + 1, s)
    nbytes = 2 * b * n * h * d * kv_dtype.itemsize + 2 * b * h * d * q_dtype.itemsize + 4 * b
    return nbytes, 4 * b * h * n * d


def _decode_bound_catches(da, q, k, v, pos, got, ref, bound, name: str) -> None:
    """The check has teeth: two wrong kernels are outside the bound, the
    plain version without the query's own key on every lane with 1 <= pos <
    S, and the kernel's output scaled by 0.98 on every lane."""
    live = (pos >= 1) & (pos < k.shape[1])
    drop = da.decode_attention_reference(q, k, v, (pos - 1).clamp(min=0))
    scaled = (got.float() * 0.98).to(got.dtype)
    for what, wrong, lanes in (("own key dropped", drop, live),
                               ("scaled by 0.98", scaled, torch.ones_like(live))):
        out = ((wrong.double() - ref.double()).abs() > bound).flatten(1).any(1)
        _require(bool(out[lanes].all()), f"decode_attention {name}: the bound misses a plain "
                                         f"output with the {what} on lanes "
                                         f"{(lanes & ~out).nonzero().flatten().tolist()}")


def _decode_plans(da) -> dict:
    """The launch plan of each (q, cache) dtype pair at the flagship's S, H,
    D at B = 1 and 16, printed with the keys the largest rank takes and the
    ranks with keys at the timed pos."""
    s, h, d = DECODE_SHAPE
    plans = {}
    for q_dtype, kv_dtype in DECODE_DTYPES:
        for b in DECODE_TIMED_BATCHES:
            p = da.launch_plan(b, s, h, d, (q_dtype, kv_dtype))
            split = {pos: [j1 - j0 for j0, j1 in da.rank_split(pos + 1, p.ranks) if j1 > j0]
                     for pos in DECODE_BATCHER_POS + DECODE_TIMED_POS}
            if b == 1:
                _require(p.cluster >= 2, f"decode_attention: clusters of {p.cluster} at S={s}")
            name = f"{str(q_dtype)[6:]}/{str(kv_dtype)[6:]}"
            how = (f"clusters of {p.cluster} CTAs, one a rank" if p.cluster > 1
                   else f"a CTA alone per (b, h) of {p.teams} teams")
            print(f"kernel decode_attention plan B={b} S={s} H={h} D={d} {name}: {how} (grid "
                  f"{p.grid}), {p.threads} threads, {p.smem} bytes of shared memory, "
                  f"{p.ranks} logical ranks of at least {p.min_keys} keys, at most "
                  f"{p.keys_per_rank} keys a rank (ranks with keys x largest: "
                  f"{', '.join(f'{len(v)} x {max(v)} at pos {pos}' for pos, v in split.items())})"
                  + (f", tiles of {p.tile} keys through {p.stages} ring buffers"
                     if p.cluster > 1 else ""))
            plans[f"B={b} {name}"] = {**dataclasses.asdict(p), "rank_keys_at_pos": split}
    return plans


def phase_decode_kernel(dev) -> dict:
    """decode_attention's launch plans at B = 1 and 16 (a cluster of one CTA
    a rank, or a CTA alone, from B x H), then the kernel against its plain version at
    B in DECODE_BATCHES, S = 1024, per-slot pos over DECODE_POS (B = 1: every
    pos of DECODE_POS_B1, ranks idle and rank edges among them), for each
    (q, cache) dtype pair; a lane alone against the same lane inside B=16,
    and B=16 in clusters of 8 and alone with 1 .. 4 teams against its own
    plan (bit for bit); one
    call replayed from a CUDA graph against eager; then at B in
    DECODE_TIMED_BATCHES, every lane at pos 255 / 511 / 767 (B = 16 also at
    the batcher's pos 64 / 128), bf16 and e4m3fn caches: cold and warm
    device us as phase 3, the bound, the plain route in a CUDA graph and, on
    the bf16 cache, F.scaled_dot_product_attention with a boolean mask (timed
    only; the port never calls it), in turns."""
    import torch.nn.functional as F

    from pocket_tts_tpu_torch.kernels import decode_attention as da

    plans = _decode_plans(da)
    gd = torch.Generator(device=dev).manual_seed(0)
    worst, worst_abs, lines = 0.0, 0.0, []
    for b in DECODE_BATCHES:
        for q_dtype, kv_dtype in DECODE_DTYPES:
            errs, bounds = [], []
            for pos_values in ([(p,) for p in DECODE_POS_B1] if b == 1 else [DECODE_POS]):
                q, k, v, pos = _decode_inputs(gd, b, q_dtype, kv_dtype, pos_values, dev)
                got = da.decode_attention(q, k, v, pos)
                torch.cuda.synchronize()
                ref = da.decode_attention_reference(q, k, v, pos)
                bound = da.error_bound(q, k, v, pos, ref)
                diff = (got.double() - ref.double()).abs()
                err, ratio = diff.max().item(), (diff / bound).max().item()
                name = f"B={b} q {str(q_dtype)[6:]} cache {str(kv_dtype)[6:]}"
                _require(bool(torch.isfinite(got).all()) and got.dtype == q_dtype,
                         f"decode_attention {name}: bad output")
                _require(ratio <= 1.0, f"decode_attention {name} pos {pos.tolist()}: max abs err "
                                       f"{err}, {ratio} x its element's error_bound")
                if b == max(DECODE_BATCHES) and q_dtype == torch.bfloat16:
                    _decode_bound_catches(da, q, k, v, pos, got, ref, bound, name)
                errs.append(err)
                bounds.append(bound)
                worst, worst_abs = max(worst, ratio), max(worst_abs, err)
            bound = torch.cat([x.flatten() for x in bounds])
            lines.append(f"B={b} {str(q_dtype)[6:]}/{str(kv_dtype)[6:]} {max(errs):.2e} (bound "
                         f"median {bound.median().item():.2e}, max {bound.max().item():.2e})")
    print("kernel decode_attention vs plain (S=1024 H=16 D=64, per-slot pos over "
          f"{DECODE_POS}, B=1 at each of {DECODE_POS_B1}; each element within its error_bound: "
          "f32 1e-5 max(1, max|out|), bf16 "
          f"derived from the inputs; worst err / bound {worst:.3f}): " + "; ".join(lines))
    print("kernel decode_attention: the bf16 bound at B=16 rejects the plain output with the "
          "query's own key dropped (every lane with 1 <= pos < S) and the kernel's output "
          "scaled by 0.98 (every lane)")

    s, h, d = DECODE_SHAPE
    for kv_dtype in (torch.bfloat16, torch.float8_e4m3fn):
        q, k, v, pos = _decode_inputs(gd, 16, torch.bfloat16, kv_dtype, DECODE_POS, dev)
        batched = da.decode_attention(q, k, v, pos)
        for b in (0, 2, 3, 4, 15):
            alone = da.decode_attention(q[b:b + 1], k[b:b + 1], v[b:b + 1], pos[b:b + 1])
            _require(torch.equal(alone[0], batched[b]),
                     f"decode_attention {kv_dtype}: lane {b} alone differs from inside B=16")
        _require(torch.equal(da.decode_attention(q, k, v, pos), batched), "run to run")
        ranks = da.launch_plan(16, s, h, d, (q.dtype, kv_dtype)).ranks
        schedules = [da.launch_plan(16, s, h, d, (q.dtype, kv_dtype), cluster=ranks)]
        schedules += [da.launch_plan(16, s, h, d, (q.dtype, kv_dtype), cluster=1, teams=t)
                      for t in range(1, min(ranks, da.SOLO_TEAMS) + 1)]
        for plan in schedules:
            _require(torch.equal(da._launch(da._load(), q, k, v, pos, plan), batched),
                     f"decode_attention {kv_dtype}: B=16 on {plan} differs")
    holder = {}
    graph = _capture(lambda: holder.__setitem__("out", da.decode_attention(q, k, v, pos)))
    pos.add_(3)  # pos is read on the device: the replay follows it
    launches = da.decode_attention.launches
    graph.replay()
    torch.cuda.synchronize()
    _require(da.decode_attention.launches == launches, "a graph replay went through the wrapper")
    _require(torch.equal(holder["out"], da.decode_attention(q, k, v, pos)),
             "decode_attention: CUDA-graph replay differs from eager")
    graph.reset()
    print("kernel decode_attention: lanes 0, 2, 3, 4, 15 alone (B=1) == the same lanes inside "
          "B=16 (pos 0, 511, 1023, 1029, 1029), bf16 and e4m3fn caches, bit for bit; B=16 "
          "bit-identical run to run, in clusters of 8 and alone with 1 .. 4 teams; one call captured in a CUDA graph replays to the eager "
          "result after pos moved, bit for bit")

    flush_buf = torch.empty(FLUSH_BYTES // 4, dtype=torch.float32, device=dev)

    def flush():
        flush_buf.fill_(1.0)

    cells, library_error = {}, None
    for b in DECODE_TIMED_BATCHES:
        for kv_dtype in (torch.bfloat16, torch.float8_e4m3fn):
            for p in (DECODE_BATCHER_POS if b > 1 else ()) + DECODE_TIMED_POS:
                q, k, v, pos = _decode_inputs(gd, b, torch.bfloat16, kv_dtype, (p,), dev)
                fns = {"kernel": lambda: da.decode_attention(q, k, v, pos),
                       "plain": lambda: da.decode_attention_reference(q, k, v, pos)}
                if kv_dtype == torch.bfloat16 and library_error is None:
                    mask = (torch.arange(DECODE_SHAPE[0], device=dev)[None, :]
                            <= pos.long()[:, None])[:, None, None, :]
                    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
                    try:
                        F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)
                        fns["sdpa"] = lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                                             attn_mask=mask)
                    except RuntimeError as e:
                        library_error = f"unsupported: {str(e)[:160]}"
                nbytes, flops = _decode_cost(b, p, torch.bfloat16, kv_dtype)
                cells[(b, str(kv_dtype)[6:], p)] = _kernel_turns(fns, flush, nbytes, flops,
                                                                 F32_FLOPS, True)
    del flush_buf
    torch.cuda.empty_cache()
    for (b, kv, p), r in cells.items():
        lib = (f", SDPA bf16 {r['sdpa_cold_us']:.3f}/{r['sdpa_warm_us']:.3f} us, "
               f"{r['library_ms']:.4f} ms" if "sdpa_cold_us" in r
               else f", SDPA {library_error}" if kv == "bfloat16"
               else ", no library call on an fp8 cache")
        print(f"kernel decode_attention B={b} cache {kv} pos {p}: cold {r['kernel_cold_us']:.3f} "
              f"us, warm {r['kernel_warm_us']:.3f} us; bound {r['bound_us']:.3f} us by "
              f"{r['bound_by']}, share {r['share_cold']:.4f} cold / {r['share_warm']:.4f} warm; "
              f"plain route in a CUDA graph {r['plain_cold_us']:.3f}/{r['plain_warm_us']:.3f} "
              f"us; wrapper {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms{lib}")
    return {"worst_err_over_tol": worst, "max_abs_err": worst_abs, "cells": cells,
            "plans": plans}


def _attn_reset() -> None:
    from pocket_tts_tpu_torch.kernels import decode_attention as da

    da.decode_attention.launches = da.decode_attention.large_t = 0


def _attn_check(where: str, frames: int, model) -> dict:
    """decode_attention launches since the last _attn_reset against the
    decoded frames x the backbone's layers (one T = 1 call per layer per
    frame, at any B); prints and returns them with large_t."""
    from pocket_tts_tpu_torch.kernels import decode_attention as da

    layers = model.config.flow_lm.transformer.num_layers
    n, large = da.decode_attention.launches, da.decode_attention.large_t
    _require(frames > 0 and n == frames * layers,
             f"{where}: decode_attention launches {n} != frames {frames} x {layers} layers")
    print(f"{where}: decode_attention launches {n} = {frames} decoded frames x {layers} "
          f"layers; large_t {large} (T > 1 prefills on the plain sdpa)")
    return {"launches": n, "large_t": large}


def _pcm(a: np.ndarray) -> np.ndarray:
    return np.round(a * 32767.0).astype(np.int64)


def phase_main_path(smi: str):
    """The main path at B=1; returns the model, the flow_blocks launches, the
    decode_attention launches, the B=1 profile and the temp-0 ``generate``'s
    audio with its GenParams."""
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

    # the counted run: every flow evaluation on the path must be a kernel launch,
    # and every layer's attention of every frame
    fb.flow_blocks.launches = 0
    _attn_reset()
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
    attn = _attn_check("main path", frames, model)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    stream = model.generate_stream(TEXT)
    first = next(stream)
    first_ms = (time.perf_counter() - t0) * 1e3  # fetch_one has synchronized
    rest = list(stream)
    print(f"main path: generate_stream first chunk {first.size // model.frame_size} frames "
          f"in {first_ms:.1f} ms, {1 + len(rest)} chunks")

    model.gen = dataclasses.replace(model.gen, temp=0.0)
    ref = {"audio": model.generate(TEXT), "gen": model.gen}  # phase 13's reference
    a = ref["audio"]
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

    # the device's busy share and its kernels by name over a short B=1 generate
    saved = model.gen
    model.gen = dataclasses.replace(model.gen, temp=0.7, eos_threshold=float("inf"))
    profile = _kernel_profile(lambda: model.generate(NARROW_TEXT), eng,
                              f"B=1 (generate {NARROW_TEXT!r})", smi)
    model.gen = saved
    return model, launches, attn, profile, ref


# -- phase 4b: the fused segment decode ------------------------------------------

SEGMENT_UNREACHABLE = 1e9  # a finite EOS threshold no logit reaches: the fused path, full budget
DECODE_BATCH_TOL = 2e-4  # Mimi decode, f32 both ways (tests/test_mimi_parity.py)


class _SegmentCalls:
    """Records each ``decode_segment`` call of an engine (wrapping it on the
    instance until ``close``): bucket, max_frames, frames_after_eos, frames
    decoded, n_valid, eos_step."""

    def __init__(self, eng):
        self.eng, self.calls = eng, []
        orig = eng.decode_segment

        def decode_segment(state, gen, generator, **kw):
            frames = eng.frames_decoded
            out = orig(state, gen, generator, **kw)
            self.calls.append({"bucket": kw["bucket"], "mf": kw["max_frames"],
                               "fae": kw["frames_after_eos"],
                               "decoded": eng.frames_decoded - frames, "n_valid": out[2],
                               "eos_step": out[3]})
            return out

        eng.decode_segment = decode_segment

    def close(self):
        del self.eng.decode_segment


def _segment_eos_logits(model, text: str) -> np.ndarray:
    """EOS logits of ``text``'s first segment at temp 0 over its budget,
    from the frame step alone (the same steps generate runs)."""
    from pocket_tts_tpu_torch import text as text_mod
    from pocket_tts_tpu_torch.models import flow_lm, flow_mlp

    eng = model.engine
    first = model.split_into_best_sentences(text)[0]
    prepared, _ = text_mod.prepare_text_prompt(first)
    tokens, n_tokens = text_mod.tokens_array(model.tokenizer, prepared)
    st = eng.prefill_tokens(eng.reset_for_segment(model.get_voice_state().as_dict()), tokens,
                            n_tokens)
    params = eng.params["flow_lm"]
    table = flow_mlp.time_embedding_table(params["flow"], 1)
    zero = torch.zeros(1, eng.ldim, device=eng.device)
    pos, latent, logits = st["pos"], st["latent"], []
    for _ in range(model.estimate_generation_steps(first)):
        latent, logit, _, _, pos = flow_lm.step(params, eng.cfg, st["kc"], st["vc"], pos, latent,
                                                zero, table, 1)
        logits.append(logit[0])
    return torch.stack(logits).float().cpu().numpy()


def _segment_run(model, text: str, fae=None) -> dict:
    """One counted, timed ``generate``: audio, wall ms, frames decoded,
    flow_blocks and decode_attention launches, the decode_segment calls."""
    from pocket_tts_tpu_torch.kernels import decode_attention as da
    from pocket_tts_tpu_torch.kernels import flow_blocks as fb

    eng = model.engine
    calls = _SegmentCalls(eng)
    torch.cuda.synchronize()
    fb.flow_blocks.launches = 0
    _attn_reset()
    eng.frames_decoded = eng.flow_evals = 0
    try:
        audio, ms = _timed(lambda: model.generate(text, frames_after_eos=fae))
    finally:
        calls.close()
    return {"audio": audio, "ms": ms, "frames": audio.size // model.frame_size,
            "decoded": eng.frames_decoded, "flow": fb.flow_blocks.launches,
            "attn": da.decode_attention.launches, "calls": calls.calls}


def _segment_pair(model, chunked, text: str, what: str, fae=None) -> tuple[dict, dict]:
    """The fused run and the chunk schedule's on one text: equal frame
    counts, audio within REF_TOL_LSB, every segment fused, launches = frames
    decoded x steps (flow_blocks) and x layers (decode_attention), at most
    SEGMENT_POLL + SEGMENT_MAX_LAG frames decoded past n_valid per segment,
    n_valid the stop rule's."""
    from pocket_tts_tpu_torch.runtime import engine

    fused, ref = _segment_run(model, text, fae), _segment_run(chunked, text, fae)
    layers = model.config.flow_lm.transformer.num_layers
    lsd = model.gen.lsd_decode_steps
    n_seg = len(model.split_into_best_sentences(text))
    bound = engine.SEGMENT_POLL + engine.SEGMENT_MAX_LAG
    _require(len(fused["calls"]) == n_seg and not ref["calls"],
             f"{what}: {len(fused['calls'])} fused segments of {n_seg}, "
             f"{len(ref['calls'])} on the chunked clone")
    for c in fused["calls"]:
        want = c["mf"] if c["eos_step"] < 0 else min(c["mf"], c["eos_step"] + c["fae"])
        _require(c["n_valid"] == want and 0 <= c["decoded"] - c["n_valid"] <= bound,
                 f"{what}: segment {c} breaks the stop rule or the {bound}-frame bound")
    _require(fused["frames"] == ref["frames"] > 0 and fused["audio"].shape == ref["audio"].shape,
             f"{what}: fused {fused['frames']} frames vs chunked {ref['frames']}")
    lsb = int(np.abs(_pcm(fused["audio"]) - _pcm(ref["audio"])).max())
    _require(lsb <= REF_TOL_LSB, f"{what}: fused vs chunked differ by {lsb} int16 LSB")
    _require(fused["frames"] == sum(c["n_valid"] for c in fused["calls"]),
             f"{what}: emitted {fused['frames']} != the segments' n_valid")
    for r in (fused, ref):
        _require(r["flow"] == r["decoded"] * lsd and r["attn"] == r["decoded"] * layers,
                 f"{what}: launches flow_blocks {r['flow']} / decode_attention {r['attn']} != "
                 f"{r['decoded']} frames x {lsd} / x {layers}")
    over = [c["decoded"] - c["n_valid"] for c in fused["calls"]]
    print(f"segment: {what}: fused {fused['frames']} frames emitted, {fused['decoded']} decoded "
          f"(past n_valid per segment {over}, bound {bound}), buckets "
          f"{[c['bucket'] for c in fused['calls']]}, EOS frames "
          f"{[c['eos_step'] for c in fused['calls']]}; chunked {ref['frames']} emitted, "
          f"{ref['decoded']} decoded; audio within {lsb} int16 LSB (bound {REF_TOL_LSB}); "
          f"flow_blocks {fused['flow']} = decoded x {lsd}, decode_attention {fused['attn']} = "
          f"decoded x {layers}")
    return fused, ref


def _host_waits(run) -> dict:
    """The host's blocking waits on the device (stream, event and device
    synchronizes, as ``torch.profiler`` records the CUDA runtime calls)
    while ``run()`` runs."""
    from torch.profiler import ProfilerActivity, profile

    names = ("cudaStreamSynchronize", "cudaEventSynchronize", "cudaDeviceSynchronize")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    return {e.key: e.count for e in prof.key_averages() if e.key in names}


def _segment_loader(model) -> None:
    """(e) a YAML variant (the flagship's file plus a runtime override) from
    ./config/, loaded and generated on the model's device; a save_checkpoint
    -> load_with_params round trip through ./tts_<variant>.safetensors,
    bit-identical at temp 0; decode_batch against the streaming decode."""
    import os

    from pocket_tts_tpu_torch import TTSModel, config, weights
    from pocket_tts_tpu_torch.models import mimi

    eng, dev = model.engine, model.device
    override = (64, 128, 256, 448, 704)
    base = config.find_config_path(config.DEFAULT_VARIANT).read_text()
    here = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        (Path(tmp) / "config").mkdir()
        (Path(tmp) / "config" / "smoke_variant.yaml").write_text(
            base + f"\nruntime:\n  segment_buckets: {list(override)}  # a runtime override\n")
        os.chdir(tmp)
        try:
            t0 = time.perf_counter()
            variant = TTSModel.load("smoke_variant", temp=0.0, eos_threshold=SEGMENT_UNREACHABLE,
                                    device=dev)
            load_s = time.perf_counter() - t0
            _require(variant.config.runtime.segment_buckets == override
                     and variant.config.flow_lm == model.config.flow_lm
                     and variant.config.mimi == model.config.mimi
                     and not variant.has_real_weights, f"smoke_variant: {variant.config}")
            run = _segment_run(variant, NARROW_TEXT)
            _require([c["bucket"] for c in run["calls"]] == [64]
                     and run["frames"] == _budget(variant, NARROW_TEXT),
                     f"smoke_variant: buckets {[c['bucket'] for c in run['calls']]}")
            print(f"segment: YAML variant from ./config/ (the flagship's file + "
                  f"runtime.segment_buckets {list(override)}) loaded on {variant.device} in "
                  f"{load_s:.2f} s; generate {NARROW_TEXT!r}: {run['frames']} frames in the "
                  f"override's 64-frame bucket (128 without it)")
            del variant

            path = Path(tmp) / "tts_smoke_variant.safetensors"
            t0 = time.perf_counter()
            weights.save_checkpoint(model.params, model.config, path)
            save_s, mib = time.perf_counter() - t0, path.stat().st_size / 2**20
            t0 = time.perf_counter()
            loaded = TTSModel.load_with_params("smoke_variant", temp=0.0,
                                               eos_threshold=SEGMENT_UNREACHABLE, device=dev)
            reload_s = time.perf_counter() - t0
        finally:
            os.chdir(here)
    _require(loaded.has_real_weights, "save_checkpoint: ./tts_smoke_variant.safetensors not read")
    saved, model.gen = model.gen, loaded.gen
    try:
        a, b = model.generate(NARROW_TEXT), loaded.generate(NARROW_TEXT)
    finally:
        model.gen = saved
    _require(a.size > 0 and a.tobytes() == b.tobytes(),
             "save_checkpoint -> load_with_params: temp-0 audio differs")
    print(f"segment: save_checkpoint {mib:.1f} MiB in {save_s:.2f} s -> "
          f"load_with_params in {reload_s:.2f} s: temp-0 generate bit-identical "
          f"({a.size // model.frame_size} frames)")
    del loaded

    plans, params = eng.plans, eng.params["mimi"]
    g = torch.Generator(device=dev).manual_seed(11)
    lat = torch.randn(1, eng.ldim, 100, generator=g, device=dev)
    st = mimi.init_decode_state(plans, 1, eng.codec_dtype, dev)
    parts = []
    for a, b in ((0, 2), (2, 18), (18, 82), (82, 100)):
        y, st = mimi.decode_step(params, plans, st, lat[:, :, a:b])
        parts.append(y)
    stream = torch.cat(parts, -1)
    whole = mimi.decode_batch(params, plans, lat)
    err = (whole - stream).abs().max().item()
    _require(whole.shape == stream.shape == (1, 1, 100 * model.frame_size)
             and err <= DECODE_BATCH_TOL, f"decode_batch vs streaming: {err}")
    print(f"segment: mimi.decode_batch of 100 frames vs the streaming decode (chunks 2 / 16 / "
          f"64 / 18) on {dev}: max {err:.3g} (bound {DECODE_BATCH_TOL})")


def phase_segment(model, smi: str) -> dict:
    """Phase 4b: whole-utterance generate through ``Engine.decode_segment``
    (the default, ``segment_dispatch="auto"``) against the chunk schedule
    (a ``segment_dispatch="chunked"`` clone) at temp 0; returns the
    fused runs' launches."""
    from pocket_tts_tpu_torch import TTSModel
    from pocket_tts_tpu_torch.runtime.engine import GenParams

    t_phase = time.perf_counter()
    saved = model.gen
    cfg = model.config
    # built from the placed weights, which its engine then shares
    chunked = TTSModel(dataclasses.replace(cfg, runtime=dataclasses.replace(
        cfg.runtime, segment_dispatch="chunked")), model.engine.params, gen=model.gen,
        has_real_weights=False, device=model.device)
    out = {"flow": 0, "attn": 0}

    def both(gen):
        model.gen = chunked.gen = gen

    # (a) EOS unreachable: every segment fused, full budget
    both(GenParams(temp=0.0, eos_threshold=SEGMENT_UNREACHABLE))
    fused, ref = _segment_pair(model, chunked, TEXT, "(a) EOS unreachable")
    _require(fused["decoded"] == fused["frames"] == _budget(model, TEXT),
             f"(a): fused decoded {fused['decoded']} != emitted {fused['frames']}")
    print(f"segment: (a) frames decoded {fused['decoded']} = emitted {fused['frames']} on the "
          f"fused path; {ref['decoded']} on the chunk schedule")
    out["flow"] += fused["flow"]
    out["attn"] += fused["attn"]
    turns = {"fused": [fused["ms"]], "chunked": [ref["ms"]]}

    # (b) EOS reachable: a threshold halfway between two of the first
    # segment's temp-0 EOS logits, first crossed nearest mid-budget
    logits = _segment_eos_logits(model, TEXT)
    values = sorted(set(logits.tolist()), reverse=True)
    cands = [((hi + lo) / 2, int(np.argmax(logits > (hi + lo) / 2)))
             for hi, lo in zip(values, values[1:])]
    threshold, frame = min(cands, key=lambda c: abs(c[1] - logits.size // 2))
    print(f"segment: (b) threshold {threshold:.6f}: the first segment's EOS logits cross it "
          f"first at frame {frame} of {logits.size}")
    both(GenParams(temp=0.0, eos_threshold=threshold))
    for fae in (None, 0):
        fused, _ = _segment_pair(model, chunked, TEXT, f"(b) EOS at frame {frame}, "
                                 f"frames_after_eos {'default' if fae is None else fae}", fae)
        _require(fused["calls"][0]["eos_step"] == frame,
                 f"(b): first segment's EOS at {fused['calls'][0]['eos_step']} != {frame}")
        out["flow"] += fused["flow"]
        out["attn"] += fused["attn"]

    # (d) wall time in turns (fused, chunked above; now chunked, fused), EOS unreachable
    both(GenParams(temp=0.0, eos_threshold=SEGMENT_UNREACHABLE))
    for path, m in (("chunked", chunked), ("fused", model)):
        r = _segment_run(m, TEXT)
        turns[path].append(r["ms"])
    frames = _budget(model, TEXT)
    secs = frames * model.frame_size / model.sample_rate
    for path, ms in turns.items():
        print(f"segment: (d) [{smi}] {path}: generate {frames} frames in "
              f"{', '.join(f'{t:.1f}' for t in ms)} ms (turns fused, chunked, chunked, fused): "
              f"ms per emitted frame {', '.join(f'{t / frames:.3f}' for t in ms)}, x-realtime "
              f"{', '.join(f'{secs / (t / 1e3):.2f}' for t in ms)}")
    out["turns_ms"] = turns

    # (c2) no blocking read per frame: the fused run's host waits against the
    # chunk schedule's on the same text (the prefills' waits are common to both)
    from pocket_tts_tpu_torch.runtime import engine

    waits = {path: _host_waits(lambda m=m: m.generate(NARROW_TEXT))
             for path, m in (("fused", model), ("chunked", chunked))}
    n = {path: sum(w.values()) for path, w in waits.items()}
    frames = _budget(model, NARROW_TEXT)
    allowed = n["chunked"] + -(-frames // engine.SEGMENT_MAX_LAG) + 1
    _require(n["chunked"] > 0 and n["fused"] <= allowed,
             f"fused generate waited on the device {n['fused']} times ({waits}) against "
             f"{n['chunked']} on the chunk schedule: more than {allowed}")
    print(f"segment: host waits on the device over a {frames}-frame generate (torch.profiler: "
          f"stream / event / device synchronizes): fused {n['fused']} {waits['fused']}, chunked "
          f"{n['chunked']} {waits['chunked']} (allowed for fused: {allowed})")

    # (e) the loader, decode_batch and save_checkpoint on the card
    model.gen = GenParams(temp=0.0, eos_threshold=SEGMENT_UNREACHABLE)
    _segment_loader(model)
    model.gen = saved
    print(f"segment: flow_blocks launches {out['flow']}, decode_attention launches "
          f"{out['attn']} over the fused runs of (a) and (b); phase took "
          f"{time.perf_counter() - t_phase:.1f} s")
    return out


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


def phase_voice(model) -> tuple[int, dict]:
    """Voice-conditioned synthesis on the card; returns the voiced run's
    flow_blocks and decode_attention launch counts."""
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
    _attn_reset()
    eng.frames_decoded = 0
    audio_v, dt = _timed(lambda: model.generate(TEXT, vs))
    launches, decoded = fb.flow_blocks.launches, eng.frames_decoded
    _require(decoded > 0 and launches == decoded * lsd,
             f"voiced: flow_blocks launches {launches} != frames {decoded} x {lsd}")
    attn = _attn_check("voice", decoded, model)
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
    return launches, attn


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


def _kernel_name(name: str) -> str:
    """A kernel's name without its argument list and namespace noise."""
    name = name.replace("(anonymous namespace)::", "").replace("void ", "")
    return re.sub(r"\(.*", "", name)[:72]


def _kernel_profile(run, eng, what: str, smi: str) -> dict:
    """One torch.profiler window over ``run()``: device busy ms (the union of
    kernel, memcpy and memset intervals in the chrome trace; kernels the
    batcher's thread launches included) and kernel launches per decoded
    frame (a B = 16 step is one frame of 16 lanes), the busy share over the
    wall of the same run unprofiled, and the top kernels by device time."""
    torch.cuda.synchronize()
    frames0, t0 = eng.frames_decoded, time.perf_counter()
    run()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    trace = Path(tempfile.mkdtemp()) / "trace.json"
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    frames1 = eng.frames_decoded
    with torch.profiler.profile(activities=acts) as prof:
        run()
        torch.cuda.synchronize()
    prof.export_chrome_trace(str(trace))
    frames = eng.frames_decoded - frames1
    unprofiled = frames1 - frames0
    _require(frames > 0 and unprofiled > 0, f"profile {what}: {frames} frames profiled")
    events = [e for e in json.loads(trace.read_text())["traceEvents"]
              if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset") and "dur" in e]
    trace.unlink()
    busy, end = 0.0, float("-inf")
    for start, dur in sorted((float(e["ts"]), float(e["dur"])) for e in events):
        if start + dur > end:
            busy += start + dur - max(start, end)
            end = start + dur
    busy /= 1e3
    kernels = [e for e in events if e["cat"] == "kernel"]
    by_name: dict[str, float] = {}
    for e in kernels:
        key = _kernel_name(e["name"])
        by_name[key] = by_name.get(key, 0.0) + float(e["dur"]) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    if not kernels:
        print(f"profile {what}: not measured (the trace holds no device events)")
        return {}
    # decode_attention_kernel (clusters) or decode_attention_solo_kernel
    attn = [float(e["dur"]) / 1e3 for e in kernels if "decode_attention" in e["name"]]
    share = (busy / frames) / (wall / unprofiled)
    print(f"profile {what} [{smi}]: {frames} frames; device busy {busy:.2f} ms = "
          f"{busy / frames:.4f} ms per frame over an unprofiled wall of {wall:.1f} ms for "
          f"{unprofiled} frames ({wall / unprofiled:.3f} ms per frame): busy share "
          f"{share:.3f}; "
          f"{len(kernels) / frames:.1f} kernel launches per frame; top kernels (device ms per "
          f"frame): " + "; ".join(f"{n} {ms / frames:.4f}" for n, ms in top))
    print(f"profile {what} [{smi}]: decode_attention kernels {sum(attn) / frames:.4f} device "
          f"ms per frame, {len(attn) / frames:.2f} launches per frame")
    return {"frames": frames, "busy_ms": busy, "wall_ms": wall, "busy_share": share,
            "launches_per_frame": len(kernels) / frames,
            "top_ms_per_frame": {n: ms / frames for n, ms in top},
            "decode_attention_ms_per_frame": sum(attn) / frames,
            "decode_attention_launches_per_frame": len(attn) / frames}


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


def phase_batch(model, smi: str) -> dict:
    """Continuous-batched synthesis; returns the flow_blocks and
    decode_attention launch counts of the B=16 whole-WAV run and the B=16
    profile."""
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
        _attn_reset()
        eng.flow_evals = eng.frames_decoded = 0
        stats0 = b.stats()
        t0 = time.perf_counter()
        results = b.generate_batch(texts)
        wall = time.perf_counter() - t0
        launches, evals = fb.flow_blocks.launches, eng.flow_evals
        st = b.stats()
        _require(launches == evals > 0,
                 f"B=16: flow_blocks launches {launches} != sum of chunk x step ceiling {evals}")
        attn = _attn_check("batch B=16 (frames summed over dispatches)", eng.frames_decoded,
                           model)
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

        # the device's busy share and its kernels by name over a short run
        short = [BATCH_SENTENCES[i % 8] for i in range(16)]
        profile = _kernel_profile(lambda: b.generate_batch(short), eng,
                                  "B=16 (16 one-sentence requests, batched_tts chunk 64)", smi)

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
    return {"flow_launches": launches, "attn": attn, "profile": profile}


# -- phase 8: narrow storage ---------------------------------------------------

NARROW_TEXT = "Eight bits."  # a 50-frame budget: one 64-frame chunk
BF16_TENSOR_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core peak
# qlinear shapes: M (B) x (N, K) of the decode frame: in_proj as [3E, E], ff1,
# ff2, the input linear
QLINEAR_MS = (1, 4, 16, 32)
QLINEAR_NK = ((3072, 1024), (4096, 1024), (1024, 4096), (1024, 32))
QLINEAR_ODD = (3, 1000, 1002)
# the f32-x route: the flow net's quantized linears (in_w, final_ada_w,
# final_w as N x K) at the main path's and the batcher's B
QLINEAR_F32_NK = ((512, 32), (1024, 512), (32, 512))
QLINEAR_F32_MS = (1, 16)
MULAW_STEP = (1 << 10) / 32767.0  # worst-case companding step, float audio


def _qlinear_tol(dtype, ref: torch.Tensor) -> float:
    """bf16: two bf16 ulps of max|y| (2^(floor(log2 max|y|) - 6)): each side
    rounds its output to bf16 once, and the plain version also rounds each
    dequantized weight to bf16 before its product (and sums in cuBLAS's
    order) where the kernel sums q * x in f32 and applies the scale once.
    f32: 1e-5 max(1, max|y|), sums in another order."""
    top = ref.float().abs().max().item()
    if dtype == torch.bfloat16:
        return 2.0 ** (math.floor(math.log2(max(top, 1e-30))) - 6)
    return 1e-5 * max(1.0, top)


def _qlinear_case(g, m, n, k, bits, dtype, dev):
    from pocket_tts_tpu_torch.ops.qtensor import quantize_array

    w32 = torch.randn(n, k, generator=g) * k ** -0.5
    w = quantize_array(w32, bits=bits).to(dev).to(dtype)
    x = torch.randn(m, k, generator=g).to(dev, dtype)
    return w32, w, x


def _narrow_kernel(dev) -> dict:
    """(a) qlinear against its plain version at every shape, int8 and int4,
    bf16 and f32 x, an odd shape and the stacked in_proj view."""
    from pocket_tts_tpu_torch.kernels import qlinear as ql
    from pocket_tts_tpu_torch.ops.qtensor import quantize_array

    g = torch.Generator().manual_seed(0)
    shapes = [(m, n, k) for m in QLINEAR_MS for n, k in QLINEAR_NK] + [QLINEAR_ODD]
    worst, worst_abs, lines = 0.0, 0.0, []
    for m, n, k in shapes:
        errs = []
        for bits in (8, 4):
            for dtype in (torch.bfloat16, torch.float32):
                _, w, x = _qlinear_case(g, m, n, k, bits, dtype, dev)
                b = (torch.randn(n, generator=g) * 0.1).to(dev, dtype)
                got = ql.qlinear(x, w, b)
                torch.cuda.synchronize()
                ref = ql.qlinear_reference(x, w, b)
                err = (got.float() - ref.float()).abs().max().item()
                tol = _qlinear_tol(dtype, ref)
                _require(bool(torch.isfinite(got).all()) and got.dtype == dtype,
                         f"qlinear {m}x{n}x{k} int{bits} {dtype}: bad output")
                _require(err <= tol, f"qlinear M={m} N={n} K={k} int{bits} {dtype}: "
                                     f"max abs err {err} > {tol}")
                errs.append(f"int{bits}/{str(dtype)[6:]} {err:.2e}<={tol:.2e}")
                worst = max(worst, err / max(tol, 1e-30))
                worst_abs = max(worst_abs, err)
        lines.append(f"{m}x{n}x{k}: " + ", ".join(errs))
    stack = quantize_array(torch.randn(6, 3, 1024, 1024, generator=g) * 0.03, channel_axes=3)
    w = stack.to(dev).to(torch.bfloat16)[2]
    x = torch.randn(1, 1, 1024, generator=g).to(dev, torch.bfloat16)
    got, ref = ql.qlinear(x, w), ql.qlinear_reference(x, w)
    err = (got.float() - ref.float()).abs().max().item()
    _require(got.shape == (1, 1, 3072) and err <= _qlinear_tol(torch.bfloat16, ref),
             f"qlinear stacked in_proj view: {tuple(got.shape)}, err {err}")
    print("narrow: qlinear vs plain (max abs err <= tol, bias added; tol bf16 two ulps of "
          "max|y|, "
          "f32 1e-5 max(1, max|y|)): " + "; ".join(lines)
          + f"; stacked in_proj [6,3,1024,1024][2] as [3072, 1024] bf16 {err:.2e}")
    for n, k in QLINEAR_NK + (QLINEAR_ODD[1:],):
        for packed in (False, True):
            p = ql.launch_plan(1, n, k, packed)
            print(f"narrow: qlinear plan {n}x{k} int{4 if packed else 8}: {p.rows} rows x "
                  f"{p.span} bytes per CTA ({p.tiles_per_cta} tiles, K split {p.k_warps} warps x "
                  f"cluster {p.cluster}, {p.chunks_per_warp} chunks a warp), grid {p.grid}, "
                  f"smem {p.smem} B at M <= 8")

    # a lane alone against the same lane inside M=16 and M=32, bit for bit
    for n, k in QLINEAR_NK[:3]:
        for bits in (8, 4):
            _, w, x = _qlinear_case(g, 32, n, k, bits, torch.bfloat16, dev)
            y16, y32 = ql.qlinear(x[:16], w), ql.qlinear(x, w)
            for r in (0, 7, 15):
                alone = ql.qlinear(x[r:r + 1].contiguous(), w)
                _require(torch.equal(alone[0], y16[r]) and torch.equal(alone[0], y32[r]),
                         f"qlinear {n}x{k} int{bits}: row {r} alone differs from inside M=16/32")
            _require(torch.equal(ql.qlinear(x[:16], w), y16), f"qlinear {n}x{k}: run to run")
    print("narrow: qlinear bf16 rows 0, 7, 15 alone (M=1) == the same rows inside M=16 and "
          "M=32, bit for bit, at in_proj, ff1, ff2, int8 and int4; M=16 bit-identical run to run")

    # the f32 route at the flow net's shapes: against plain at M 1, 16 and 32, and
    # a row alone against the same row inside M=16 and M=32, bit for bit
    f32_lines = []
    for n, k in QLINEAR_F32_NK:
        for bits in (8, 4):
            _, w, x = _qlinear_case(g, 32, n, k, bits, torch.float32, dev)
            bias = (torch.randn(n, generator=g) * 0.1).to(dev)
            ys = {m: ql.qlinear(x[:m].contiguous(), w, bias) for m in (1, 16, 32)}
            torch.cuda.synchronize()
            errs = []
            for m, y in ys.items():
                ref = ql.qlinear_reference(x[:m], w, bias)
                e32 = (y - ref).abs().max().item()
                tol = _qlinear_tol(torch.float32, ref)
                _require(e32 <= tol, f"qlinear f32 M={m} {n}x{k} int{bits}: err {e32} > {tol}")
                errs.append(e32)
                worst, worst_abs = max(worst, e32 / tol), max(worst_abs, e32)
            for r in (0, 7, 15):
                alone = ql.qlinear(x[r:r + 1].contiguous(), w, bias)
                _require(torch.equal(alone[0], ys[16][r]) and torch.equal(alone[0], ys[32][r]),
                         f"qlinear f32 {n}x{k} int{bits}: row {r} alone differs from M=16/32")
            pl = ql.launch_plan_f32(n, k, bits == 4)
            f32_lines.append(f"{n}x{k} int{bits} max err {max(errs):.2e} (plan {pl.warps} warps, "
                             f"K split {pl.k_warps}, {pl.lanes_per_row} lanes a row, "
                             f"{pl.chunks_per_lane} slices a lane, grid {pl.grid})")
    print("narrow: qlinear f32 at the flow net's shapes, M 1/16/32 vs plain (tol 1e-5 max(1, "
          "max|y|)); rows 0, 7, 15 alone == the same rows inside M=16 and M=32, bit for bit: "
          + "; ".join(f32_lines))

    # one call replayed from a CUDA graph (a cluster launch) against eager
    for bits in (8, 4):
        _, w, x = _qlinear_case(g, 16, 1024, 4096, bits, torch.bfloat16, dev)
        eager = ql.qlinear(x, w)
        holder = {}
        graph = _capture(lambda: holder.__setitem__("out", ql.qlinear(x, w)))
        holder["out"].zero_()
        launches = ql.qlinear.launches
        graph.replay()
        torch.cuda.synchronize()
        _require(ql.qlinear.launches == launches, "a qlinear graph replay went through the wrapper")
        _require(torch.equal(holder["out"], eager), f"qlinear int{bits}: graph replay != eager")
    print("narrow: qlinear bf16 M=16 1024x4096 int8 and int4 captured in a CUDA graph replays "
          "to the eager result bit for bit")
    return {"worst_err_over_tol": worst, "max_abs_err": max(worst_abs, err)}


def _kernel_turns(fns: dict, flush, nbytes: int, flops: int, peak: float,
                  times_ms: bool) -> dict:
    """Cold and warm device us of each of ``fns`` (kernel first), in turns
    (each palindrome of turns twice: a cold time is the difference of two
    ~90 us graphs), the bound from ``nbytes`` and ``flops`` at ``peak``, the
    share; with ``times_ms`` the wrapper's, the plain version's and the
    library call's median ms."""
    graphs = {"flush": _capture(flush)}
    for name, fn in fns.items():
        graphs[name + "_cold"] = _capture(fn, flush=flush)
        graphs[name + "_warm"] = _capture(fn, reps=20)
    names = list(fns)
    order = 2 * (["flush"] + [f"{a}_cold" for a in names + names[::-1]] + ["flush"]
                 + [f"{a}_warm" for a in names + names[::-1]])
    turns = {key: [] for key in graphs}
    for key in order:
        turns[key].append(_replay_us(graphs[key]))
    mean = {key: statistics.mean(v) for key, v in turns.items()}
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e6
    t_ops = flops / peak * 1e6
    rec = {f"{a}_cold_us": mean[f"{a}_cold"] - mean["flush"] for a in names}
    rec |= {f"{a}_warm_us": mean[f"{a}_warm"] / 20 for a in names}
    rec |= {"bound_us": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
    rec["share_cold"] = rec["bound_us"] / rec["kernel_cold_us"]
    rec["share_warm"] = rec["bound_us"] / rec["kernel_warm_us"]
    if times_ms:
        rec["ms"] = _median_ms(fns["kernel"])
        rec["plain_ms"] = _median_ms(fns["plain"])
        for lib in ("int8pack", "linear_f32", "sdpa"):
            if lib in fns:
                rec["library_ms"] = _median_ms(fns[lib])
    for graph in graphs.values():
        graph.reset()
    return rec


def _narrow_times(dev) -> dict:
    """(b) cold and warm device us of qlinear at every shape, int8 and int4:
    bf16 x (the backbone's route) with the plain version, F.linear on the
    unquantized bf16 weight and torch._weight_int8pack_mm as yardsticks; f32
    x (the flow net's route: in_w, final_ada_w, final_w) at M in {1, 16}
    with the plain version and F.linear on the f32 weight; the bound; the
    wrapper's median ms."""
    import torch.nn.functional as F

    from pocket_tts_tpu_torch.kernels import qlinear as ql

    flush_buf = torch.empty(FLUSH_BYTES // 4, dtype=torch.float32, device=dev)

    def flush():
        flush_buf.fill_(1.0)

    g = torch.Generator().manual_seed(1)
    out, out_f32, library_error = {}, {}, None
    for bits in (8, 4):
        for n, k in QLINEAR_NK:
            for m in QLINEAR_MS:
                w32, w, x = _qlinear_case(g, m, n, k, bits, torch.bfloat16, dev)
                wbf = w32.to(dev, torch.bfloat16)
                fns = {"kernel": lambda: ql.qlinear(x, w),
                       "plain": lambda: ql.qlinear_reference(x, w),
                       "linear": lambda: F.linear(x, wbf)}
                if bits == 8 and library_error is None:
                    try:
                        pack = torch._weight_int8pack_mm
                        pack(x, w.q, w.scale)
                        fns["int8pack"] = lambda: pack(x, w.q, w.scale)
                    except (RuntimeError, NotImplementedError, AttributeError) as e:
                        library_error = f"unsupported: {type(e).__name__}: {str(e)[:160]}"
                nbytes = w.q.numel() + 2 * (n + m * k + m * n)
                out[(bits, m, n, k)] = _kernel_turns(
                    fns, flush, nbytes, 2 * m * n * k, BF16_TENSOR_FLOPS,
                    m == 1 or (m == 16 and bits == 8))
        for n, k in QLINEAR_F32_NK:
            for m in QLINEAR_F32_MS:
                w32, w, x = _qlinear_case(g, m, n, k, bits, torch.float32, dev)
                wf = w32.to(dev)
                fns = {"kernel": lambda: ql.qlinear(x, w),
                       "plain": lambda: ql.qlinear_reference(x, w),
                       "linear_f32": lambda: F.linear(x, wf)}
                nbytes = w.q.numel() + 4 * (n + m * k + m * n)
                out_f32[(bits, m, n, k)] = _kernel_turns(
                    fns, flush, nbytes, 2 * m * n * k, F32_FLOPS, True)
    del flush_buf
    torch.cuda.empty_cache()
    for (bits, m, n, k), r in out.items():
        lib = (f", int8pack {r['int8pack_cold_us']:.3f}/{r['int8pack_warm_us']:.3f}"
               if "int8pack_cold_us" in r else "")
        ms = (f"; wrapper {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms"
              + (f", int8pack {r['library_ms']:.4f} ms" if "library_ms" in r else "")
              if "ms" in r else "")
        print(f"narrow: qlinear int{bits} M={m} {n}x{k} bf16: cold {r['kernel_cold_us']:.3f} us, "
              f"warm {r['kernel_warm_us']:.3f} us; bound {r['bound_us']:.3f} us by "
              f"{r['bound_by']}, share {r['share_cold']:.4f} cold / {r['share_warm']:.4f} warm; "
              f"yardsticks cold/warm us: plain {r['plain_cold_us']:.3f}/{r['plain_warm_us']:.3f}, "
              f"F.linear bf16 {r['linear_cold_us']:.3f}/{r['linear_warm_us']:.3f}{lib}{ms}")
    for (bits, m, n, k), r in out_f32.items():
        print(f"narrow: qlinear int{bits} M={m} {n}x{k} f32: cold {r['kernel_cold_us']:.3f} us, "
              f"warm {r['kernel_warm_us']:.3f} us; bound {r['bound_us']:.3f} us by "
              f"{r['bound_by']}, share {r['share_cold']:.4f} cold / {r['share_warm']:.4f} warm; "
              f"yardsticks cold/warm us: plain {r['plain_cold_us']:.3f}/{r['plain_warm_us']:.3f}, "
              f"F.linear f32 {r['linear_f32_cold_us']:.3f}/{r['linear_f32_warm_us']:.3f}; "
              f"wrapper {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, F.linear f32 "
              f"{r['library_ms']:.4f} ms")
    print(f"narrow: torch._weight_int8pack_mm on CUDA: {library_error or 'timed above'}")
    return {"per_shape": out, "per_shape_f32": out_f32, "library_error": library_error}


def _flat(tree) -> list:
    from pocket_tts_tpu_torch.runtime.quantize import _flatten_paths

    return _flatten_paths(tree)


def _narrow_artifact(model):
    """(c) quantize_model(bits=8), its SNR, save_quantized -> load_quantized
    bit for bit, and the artifact's bytes against float32."""
    from pocket_tts_tpu_torch.ops.qtensor import QTensor
    from pocket_tts_tpu_torch.runtime.quantize import (
        load_quantized, quantize_model, save_quantized, snr_report)

    t0 = time.perf_counter()
    q8 = quantize_model(model, bits=8)
    quant_s = time.perf_counter() - t0
    snrs = snr_report(model.params, q8.params)
    n_q = sum(isinstance(leaf, QTensor) for _, leaf in _flat(q8.params))
    _require(n_q == len(snrs) > 5 and min(snrs.values()) > 25.0,
             f"quantize_model: {n_q} tensors, min SNR {min(snrs.values())} dB")
    tmp = tempfile.TemporaryDirectory()
    path = Path(tmp.name) / "model.int8.safetensors"
    save_quantized(q8.params, path)
    loaded = dict(_flat(load_quantized(path)))
    ours = dict(_flat(q8.params))
    _require(sorted(loaded) == sorted(ours), "artifact: paths differ")
    for key, leaf in ours.items():
        got = loaded[key]
        same = (torch.equal(got.q, leaf.q) and torch.equal(got.scale, leaf.scale)
                if isinstance(leaf, QTensor) else torch.equal(got, leaf))
        _require(same, f"artifact: {key} differs after the round trip")
    f32_bytes = sum(t.numel() * 4 for _, t in _flat(model.params))
    size = path.stat().st_size
    tmp.cleanup()
    print(f"narrow: quantize_model(bits=8) in {quant_s:.2f} s: {n_q} int8 tensors, SNR dB min "
          f"{min(snrs.values()):.2f} mean {statistics.mean(snrs.values()):.2f}; "
          f"save_quantized -> load_quantized bit-equal; artifact {size / 2**20:.1f} MiB against "
          f"{f32_bytes / 2**20:.1f} MiB float32 ({size / f32_bytes:.3f})")
    return q8


def phase_narrow_reference(model):
    """(d) the int8 and int4 models in float32 on the card (qlinear f32)
    against the same models on the CPU (plain versions), 4 frames."""
    from pocket_tts_tpu_torch import text
    from pocket_tts_tpu_torch.kernels import qlinear as ql
    from pocket_tts_tpu_torch.runtime.engine import Engine, GenParams
    from pocket_tts_tpu_torch.runtime.quantize import quantize_params

    cfg = dataclasses.replace(model.config, runtime=dataclasses.replace(
        model.config.runtime, compute_dtype="float32"))
    prepared, _ = text.prepare_text_prompt("Hello, world.")
    tokens, n = text.tokens_array(model.tokenizer, prepared)
    gen = GenParams(temp=0.0, eos_threshold=float("inf"))
    for bits in (8, 4):
        qparams = quantize_params(model.params, bits)
        outs, launches = [], 0
        for device in ("cuda", "cpu"):
            eng = Engine(cfg, qparams, device)
            before = ql.qlinear.launches
            state = eng.prefill_tokens(eng.new_state(), tokens, n)
            _, pcm, _ = eng.decode_frames(state, 4, gen, torch.Generator(device=device))
            outs.append(pcm.cpu().numpy().astype(np.int64))
            launches += ql.qlinear.launches - before
        lsb = int(np.abs(outs[0] - outs[1]).max())
        _require(outs[0].shape == outs[1].shape == (1, 4 * cfg.mimi.frame_size), "shape")
        _require(launches > 0, f"int{bits} f32 on the card launched no qlinear")
        _require(lsb <= REF_TOL_LSB, f"int{bits} f32 card vs CPU: {lsb} int16 LSB")
        print(f"narrow: int{bits} model in f32, 4 frames, card (qlinear, {launches} launches) "
              f"vs CPU (plain): max {lsb} int16 LSB (bound {REF_TOL_LSB}), audio std "
              f"{outs[0].std():.1f} LSB")


class _ExpectedQlinear:
    """The qlinear launches the shape rule predicts for what an engine runs
    while it is watched: each frame's backbone, input and cond linears (B
    rows), each flow evaluation's in_w, final_ada_w and final_w, each codec
    transformer call of 16 * K * B rows (a fused segment's codec groups
    too), each text prefill of B * bucket
    rows, each conditioning prefill of B * T rows and each voice encode of
    16 * frames * B rows (the codec's transformers run 16 positions per
    frame) when its rows are at most MAX_ROWS.  Counts the engine's calls by wrapping its
    methods (on the instance, until ``close``)."""

    def __init__(self, eng):
        from pocket_tts_tpu_torch.kernels import qlinear as ql
        from pocket_tts_tpu_torch.ops.qtensor import QTensor
        from pocket_tts_tpu_torch.runtime.engine import _bucket

        def layers(tree):
            return sum(v.q.shape[0] for v in tree.values() if isinstance(v, QTensor))

        fl, mm = eng.params["flow_lm"], eng.params["mimi"]
        self.max_rows = ql.MAX_ROWS
        self.backbone = layers(fl["tf"])
        self.frame = self.backbone + sum(isinstance(w, QTensor)
                                         for w in (fl["input_w"], fl["flow"]["cond_w"]))
        self.flow = sum(isinstance(fl["flow"][key], QTensor)
                        for key in ("in_w", "final_ada_w", "final_w"))
        self.codec, self.encoder = (layers(mm[tf]["layers"]) + sum(
            isinstance(w, QTensor) for key, w in mm[tf].items() if key != "layers")
            for tf in ("dec_tf", "enc_tf"))
        self.count = 0
        self.eng = eng
        buckets = eng._rcfg.text_buckets
        self.names = ("decode_frames", "decode_segment", "prefill_tokens",
                      "admit_prefill_slot", "prefill_conditioning", "_encode")
        orig = {name: getattr(eng, name) for name in self.names}

        def decode_frames(state, k, *a, **kw):
            b, evals = state["pos"].shape[0], eng.flow_evals
            out = orig["decode_frames"](state, k, *a, **kw)
            steps = (eng.flow_evals - evals) // k
            if b <= self.max_rows:
                self.count += k * (self.frame + steps * self.flow)
            if 16 * k * b <= self.max_rows:
                self.count += self.codec
            return out

        def decode_segment(state, gen, generator, **kw):
            frames = eng.frames_decoded
            out = orig["decode_segment"](state, gen, generator, **kw)
            self.count += (eng.frames_decoded - frames) * (
                self.frame + gen.lsd_decode_steps * self.flow)
            self.count += self.codec * sum(16 * k <= self.max_rows for _, k in
                                           eng.segment_groups(kw["bucket"], out[2]))
            return out

        def prefill_tokens(state, tokens, n_valid):
            rows = tokens.shape[0] * _bucket(tokens.shape[1], buckets)
            self.count += self.backbone if rows <= self.max_rows else 0
            return orig["prefill_tokens"](state, tokens, n_valid)

        def admit_prefill_slot(state, slot, vs, row, n, **kw):
            self.count += self.backbone if row.shape[1] <= self.max_rows else 0
            return orig["admit_prefill_slot"](state, slot, vs, row, n, **kw)

        def prefill_conditioning(state, cond, n_valid):
            rows = cond.shape[0] * cond.shape[1]
            self.count += self.backbone if rows <= self.max_rows else 0
            return orig["prefill_conditioning"](state, cond, n_valid)

        def _encode(audio):
            frames = -(-audio.shape[-1] // eng.frame_size)
            rows = audio.shape[0] * 16 * frames
            self.count += self.encoder if rows <= self.max_rows else 0
            return orig["_encode"](audio)

        for name, fn in (("decode_frames", decode_frames), ("decode_segment", decode_segment),
                         ("prefill_tokens", prefill_tokens),
                         ("admit_prefill_slot", admit_prefill_slot),
                         ("prefill_conditioning", prefill_conditioning), ("_encode", _encode)):
            setattr(eng, name, fn)

    def close(self):
        for name in self.names:
            delattr(self.eng, name)


def _narrow_generate(model, q8) -> dict:
    """(e) generate on the bf16 model's narrow variants, launch counts checked;
    (f) mu-law encode on the card over every int16 value, and mu-law
    generate against int16 within one companding step."""
    from pocket_tts_tpu_torch import TTSModel
    from pocket_tts_tpu_torch.kernels import flow_blocks as fb
    from pocket_tts_tpu_torch.kernels import qlinear as ql
    from pocket_tts_tpu_torch.ops import mulaw
    from pocket_tts_tpu_torch.runtime.engine import GenParams
    from pocket_tts_tpu_torch.runtime.quantize import quantize_model

    def variant(kv_dtype=None, transport=None, bits=None):
        cfg = TTSModel._apply_config_overrides(model.config, kv_dtype=kv_dtype,
                                               transport_format=transport)
        m = TTSModel(cfg, model.params, gen=model.gen, has_real_weights=False,
                     device=model.device)
        return m if bits is None else quantize_model(m, bits)

    gen = GenParams(temp=0.7, eos_threshold=float("inf"))
    model.gen = q8.gen = gen
    runs = {"int8": q8, "int4": quantize_model(model, 4),
            "int8+fp8": variant("float8_e4m3", bits=8),
            "int8+fp8+mulaw": variant("float8_e4m3", "mulaw", bits=8)}
    frames_budget = _budget(model, NARROW_TEXT)
    out = {}
    for name, m in runs.items():
        m.gen = gen
        m.generate("Warm up.")
        eng = m.engine
        expect = _ExpectedQlinear(eng)
        torch.cuda.synchronize()
        fb.flow_blocks.launches = ql.qlinear.launches = 0
        _attn_reset()
        eng.frames_decoded = eng.flow_evals = 0
        t0 = time.perf_counter()
        audio = m.generate(NARROW_TEXT)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        expect.close()
        frames, evals = eng.frames_decoded, eng.flow_evals
        qn, fn_ = ql.qlinear.launches, fb.flow_blocks.launches
        _require(frames > 0 and fn_ == evals == frames * gen.lsd_decode_steps,
                 f"{name}: flow_blocks launches {fn_} != frames {frames} x steps")
        _require(qn == expect.count > 0, f"{name}: qlinear launches {qn} != expected "
                                         f"{expect.count}")
        attn = _attn_check(f"narrow: generate {name}", frames, m)
        _require(audio.size == frames_budget * model.frame_size
                 and bool(np.isfinite(audio).all()) and float(audio.std()) > 0,
                 f"{name}: bad audio ({audio.size} samples)")
        secs = audio.size / model.sample_rate
        per_frame = expect.frame + gen.lsd_decode_steps * expect.flow
        print(f"narrow: generate {name} (kv {eng.kv_dtype}, wire {eng.wire_dtype}): "
              f"{frames} frames decoded, flow_blocks launches {fn_} = frames x "
              f"{gen.lsd_decode_steps}, qlinear launches {qn} = expected ({per_frame} per frame: "
              f"{expect.backbone} backbone + {expect.frame - expect.backbone} input/cond + "
              f"{expect.flow} flow x {gen.lsd_decode_steps}; plus prefill and codec by the "
              f"shape rule); {dt * 1e3:.1f} ms: ms/frame {dt * 1e3 / frames:.3f}, x-realtime "
              f"{secs / dt:.2f}")
        out[name] = {"ms_per_frame": dt * 1e3 / frames, "x_realtime": secs / dt,
                     "qlinear_launches": qn, "frames": frames, "attn": attn}
    torch.cuda.synchronize()
    fb.flow_blocks.launches = model.engine.frames_decoded = 0
    t0 = time.perf_counter()
    base_audio = model.generate(NARROW_TEXT)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    frames = model.engine.frames_decoded
    print(f"narrow: generate bf16 (same text, same call): {frames} frames, ms/frame "
          f"{dt * 1e3 / frames:.3f}, x-realtime {base_audio.size / model.sample_rate / dt:.2f}")
    out["bf16"] = {"ms_per_frame": dt * 1e3 / frames}

    model.gen = q8.gen = GenParams(temp=0.0, eos_threshold=float("inf"))
    a, b = model.generate(NARROW_TEXT), q8.generate(NARROW_TEXT)
    corr = float(np.corrcoef(a, b)[0, 1])
    _require(a.shape == b.shape and corr > 0.9, f"int8 vs bf16 at temp 0: corr {corr}")
    print(f"narrow: temp 0, int8 vs bf16 audio correlation {corr:.5f}, max |diff| "
          f"{np.abs(a - b).max():.4f}")

    x = torch.arange(-32768, 32768, dtype=torch.int32).to(torch.int16)
    got = mulaw.encode(x.to(model.device)).cpu().numpy()
    _require(np.array_equal(got, mulaw.encode_np(x.numpy())), "mu-law encode on the card")
    mu = variant(transport="mulaw")
    mu.gen = model.gen
    c = mu.generate(NARROW_TEXT)
    err = float(np.abs(c - a).max())
    _require(c.shape == a.shape and err <= MULAW_STEP, f"mu-law generate vs int16: {err}")
    print(f"narrow: mu-law encode on the card == encode_np for all 65536 int16 values; "
          f"mu-law generate vs int16 at temp 0: max {err * 32767:.0f} int16 LSB (bound "
          f"{MULAW_STEP * 32767:.0f}), wire {mu.engine.wire_dtype}")
    model.gen = GenParams(temp=0.7, eos_threshold=float("inf"))
    return out


def _narrow_voice(model, q8fp8) -> dict:
    """(e2) int8 + fp8 e4m3 with a cloned voice and continuation: each later
    segment prefills its tail into a copy of the voice state
    (``_prefill_voice(base=)``, copied as its bytes).  The voice's bytes are
    unchanged after the run, two temp-0 runs give the same audio bit for
    bit, the launch counts are what the shape rule predicts; then a few
    frames of the same int8 + fp8 model in float32 on the card against the
    CPU, after a conditioning prefill and a continuation prefill into a copy
    of the voice."""
    from pocket_tts_tpu_torch import TTSModel, text
    from pocket_tts_tpu_torch.kernels import flow_blocks as fb
    from pocket_tts_tpu_torch.kernels import qlinear as ql
    from pocket_tts_tpu_torch.ops.attention import raw_view
    from pocket_tts_tpu_torch.runtime.engine import GenParams
    from pocket_tts_tpu_torch.runtime.quantize import quantize_params

    sr = model.sample_rate
    wav = _synthetic_voice(3.0, sr, seed=6)[0]
    saved, q8fp8.gen = q8fp8.gen, GenParams(temp=0.0, eos_threshold=float("inf"))
    eng = q8fp8.engine
    vs = q8fp8.get_voice_state_from_audio(wav)
    _require(vs.kc.dtype == torch.float8_e4m3fn, f"voice cache {vs.kc.dtype}")
    before = {name: raw_view(t).clone() for name, t in vs.as_dict().items()}
    runs = []
    for _ in range(2):
        expect = _ExpectedQlinear(eng)
        torch.cuda.synchronize()
        fb.flow_blocks.launches = ql.qlinear.launches = 0
        _attn_reset()
        eng.frames_decoded = eng.flow_evals = 0
        audio, dt = _timed(lambda: q8fp8.generate_with_pauses(PAUSE_TEXT, vs,
                                                              continuation_frames=8))
        expect.close()
        qn, fn_, frames = ql.qlinear.launches, fb.flow_blocks.launches, eng.frames_decoded
        attn = _attn_check("narrow: int8 + fp8 voice, continuation_frames=8", frames, q8fp8)
        _require(frames > 0 and fn_ == eng.flow_evals == frames * q8fp8.gen.lsd_decode_steps,
                 f"fp8 voice: flow_blocks launches {fn_} != frames {frames} x steps")
        _require(qn == expect.count > 0, f"fp8 voice: qlinear launches {qn} != {expect.count}")
        _require(bool(np.isfinite(audio).all()) and float(audio.std()) > 0, "fp8 voice: audio")
        runs.append((audio, qn, fn_, frames, dt))
    q8fp8.gen = saved
    _require(np.array_equal(runs[0][0], runs[1][0]), "fp8 voice: temp-0 runs differ")
    for name, t in vs.as_dict().items():
        _require(torch.equal(raw_view(t), before[name]), f"fp8 voice: voice {name} was written")
    audio, qn, fn_, frames, dt = runs[1]
    print(f"narrow: int8 + fp8 e4m3, cloned 3 s voice, generate_with_pauses(continuation_frames="
          f"8) at temp 0: {audio.size} samples, {frames} frames in {dt:.1f} ms; two runs "
          f"bit-identical; voice state bytes unchanged; flow_blocks launches {fn_} = frames x "
          f"steps, qlinear launches {qn} = expected")

    # float32 compute, int8 weights, fp8 cache: card vs CPU on the same inputs
    cfg = TTSModel._apply_config_overrides(model.config, kv_dtype="float8_e4m3")
    cfg = dataclasses.replace(cfg, runtime=dataclasses.replace(cfg.runtime,
                                                               compute_dtype="float32"))
    qparams = quantize_params(model.params, 8)
    prepared, _ = text.prepare_text_prompt("Hello, world.")
    gen = GenParams(temp=0.0, eos_threshold=float("inf"))
    outs = []
    cond = None
    for device in ("cpu", "cuda"):
        m32 = TTSModel(cfg, qparams, gen=gen, has_real_weights=False, device=device)
        if cond is None:  # one conditioning for both sides (the CPU's)
            cond, n = m32.engine.encode_voice(_synthetic_voice(2.0, sr, seed=7)[0])
        vs32 = m32._prefill_voice(cond[:, :20].to(device), 20)
        snap = {name: raw_view(t).clone() for name, t in vs32.as_dict().items()}
        ext = m32._prefill_voice(cond[:, 20:n].to(device), n - 20, base=vs32)
        _require(all(torch.equal(raw_view(t), snap[name]) for name, t in vs32.as_dict().items()),
                 f"{device}: the continuation prefill wrote the voice state")
        e = m32.engine
        tokens, nt = text.tokens_array(m32.tokenizer, prepared)
        state = e.prefill_tokens(e.reset_for_segment(ext.as_dict()), tokens, nt)
        _, pcm, _ = e.decode_frames(state, 4, gen, torch.Generator(device=device))
        outs.append(pcm.cpu().numpy().astype(np.int64))
    lsb = int(np.abs(outs[0] - outs[1]).max())
    _require(outs[0].shape == outs[1].shape == (1, 4 * cfg.mimi.frame_size), "shape")
    _require(lsb <= REF_TOL_LSB, f"int8 + fp8 + voice f32 card vs CPU: {lsb} int16 LSB")
    print(f"narrow: int8 + fp8 e4m3 in f32, voice of 20 + {n - 20} conditioning frames (the "
          f"second into a copy), 4 frames: card vs CPU max {lsb} int16 LSB (bound "
          f"{REF_TOL_LSB}), audio std {outs[1].std():.1f} LSB")
    return {"qlinear_launches": qn, "lsb_card_vs_cpu": lsb, "attn": attn}


def _narrow_batch(q8fp8) -> dict:
    """(g) batched_tts(16, 64) on the int8 + fp8 model: 16 requests."""
    from pocket_tts_tpu_torch.kernels import flow_blocks as fb
    from pocket_tts_tpu_torch.kernels import qlinear as ql
    from pocket_tts_tpu_torch.runtime.batcher import batched_tts

    b = batched_tts(q8fp8, batch_size=16, chunk_frames=64)
    try:
        b.warmup()
        texts = [BATCH_SENTENCES[i % 8] for i in range(16)]
        eng = b.engine
        expect = _ExpectedQlinear(eng)
        torch.cuda.synchronize()
        fb.flow_blocks.launches = ql.qlinear.launches = 0
        _attn_reset()
        eng.flow_evals = eng.frames_decoded = 0
        t0 = time.perf_counter()
        results = b.generate_batch(texts)
        wall = time.perf_counter() - t0
        expect.close()
        qn, fn_ = ql.qlinear.launches, fb.flow_blocks.launches
    finally:
        b.stop()
    attn = _attn_check("narrow: batch B=16 int8 + fp8 (frames summed over dispatches)",
                       eng.frames_decoded, q8fp8)
    _require(fn_ == eng.flow_evals > 0, f"batch: flow_blocks {fn_} != evals {eng.flow_evals}")
    _require(qn == expect.count > 0, f"batch: qlinear launches {qn} != expected {expect.count}")
    for text, audio in zip(texts, results):
        want = _budget(q8fp8, text) * q8fp8.frame_size
        _require(audio.size == want and bool(np.isfinite(audio).all()) and float(audio.std()) > 0,
                 f"batch {text!r}: {audio.size} samples != {want} or bad audio")
    secs = sum(a.size for a in results) / q8fp8.sample_rate
    print(f"narrow: batched_tts B=16 chunk 64, int8 + fp8 e4m3: 16 requests, {secs:.2f} s audio "
          f"in {wall * 1e3:.1f} ms = aggregate x-realtime {secs / wall:.2f}; "
          f"{eng.frames_decoded} steps of 16 lanes ({wall * 1e3 / eng.frames_decoded:.3f} ms "
          f"per step); flow_blocks launches {fn_} = evaluations, qlinear launches {qn} = "
          f"expected")
    return {"qlinear_launches": qn, "x_realtime": secs / wall, "attn": attn}


def _narrow_cli(model) -> None:
    """(h) the CLI's quantize and generate --quantized as subprocesses."""
    root = Path(__file__).resolve().parent
    tmp = tempfile.TemporaryDirectory()
    d = Path(tmp.name)
    runs = [["quantize", "--device", "cuda", "-o", str(d / "m.int8.safetensors")],
            ["generate", "--quantized", "--device", "cuda", "--eos-threshold", "inf", "--quiet",
             "--text", NARROW_TEXT, "-o", str(d / "q.wav")]]
    for args in runs:
        t0 = time.perf_counter()
        res = subprocess.run([sys.executable, "-m", "pocket_tts_tpu_torch.cli", *args],
                             cwd=root, capture_output=True, text=True, timeout=600)
        dt = time.perf_counter() - t0
        _require(res.returncode == 0, f"cli {args[0]}: exit {res.returncode}\n{res.stderr[-3000:]}")
        _require("device: cuda" in res.stderr, f"cli {args[0]}: no cuda device line")
        said = [ln for ln in res.stderr.splitlines() if "SNR" in ln or "realtime" in ln]
        print(f"narrow: cli {' '.join(args[:2])}: exit 0 in {dt:.1f} s; "
              f"{said[-1].strip() if said else ''}")
    _require((d / "m.int8.safetensors").stat().st_size > 0, "cli quantize wrote nothing")
    with wave.open(str(d / "q.wav"), "rb") as f:
        got = f.getnframes()
    want = _budget(model, NARROW_TEXT) * model.frame_size
    _require(got == want, f"cli generate --quantized: {got} samples != {want}")
    tmp.cleanup()


def phase_narrow(model, dev):
    """Phase 8: narrow storage at full width; returns its numbers and the
    int8 + fp8 e4m3 model."""
    from pocket_tts_tpu_torch.runtime.quantize import quantize_model

    t0 = time.perf_counter()
    out = {"kernel": _narrow_kernel(dev), "times": _narrow_times(dev)}
    q8 = _narrow_artifact(model)
    phase_narrow_reference(model)
    out["generate"] = _narrow_generate(model, q8)
    del q8
    torch.cuda.empty_cache()
    cfg = type(model)._apply_config_overrides(model.config, kv_dtype="float8_e4m3")
    base = type(model)(cfg, model.params, gen=model.gen, has_real_weights=False,
                       device=model.device)
    q8fp8 = quantize_model(base)
    out["voice"] = _narrow_voice(model, q8fp8)
    out["batch"] = _narrow_batch(q8fp8)
    _narrow_cli(model)
    print(f"narrow: phase took {time.perf_counter() - t0:.1f} s")
    return out, q8fp8


# -- phase 9: the serving tier -------------------------------------------------------

SERVE_TEXT = "The server answers a lone request on the single stream."
# the two temp-0 requests among the 16 concurrent ones (texts of their own,
# so the batcher's submissions tell whether each rode it)
EXACT_TEXTS = ("This exact request keeps a lane of its own.",
               "Another exact request is decoded in its own lane.")
CANCEL_TEXT = " ".join(f"Sentence {i} of a stream the client walks away from." for i in range(8))


def _wav_samples(data: bytes) -> np.ndarray:
    """A WAV body -> int16 samples, its format checked: 24 kHz mono int16."""
    with wave.open(io.BytesIO(data), "rb") as f:
        fmt = (f.getframerate(), f.getnchannels(), f.getsampwidth())
        n = f.getnframes()
    _require(fmt == (24000, 1, 2), f"serve: WAV format {fmt}")
    pcm = np.frombuffer(data[44:], "<i2")
    _require(pcm.size == n, f"serve: WAV header says {n} samples, body holds {pcm.size}")
    return pcm


def _pct(values, q) -> float:
    return float(np.percentile(values, q))


class _Submissions:
    """Texts the batcher was handed, by wrapping its ``submit`` on the
    instance (both ``generate`` and ``stream`` go through it)."""

    def __init__(self, batcher):
        self.texts: list[str] = []
        self.batcher = batcher
        orig = batcher.submit

        def submit(text, *a, **kw):
            self.texts.append(text)
            return orig(text, *a, **kw)

        batcher.submit = submit

    def close(self):
        del self.batcher.submit


async def _serve_requests(state, model, budgets: dict, refs: dict) -> dict:
    """(a)-(f) and the burst turns (b2) on one event loop; returns the
    numbers printed."""
    from pocket_tts_tpu_torch.server import app

    b = state.batcher
    fs, sr = model.frame_size, model.sample_rate
    out = {}

    # (a) lone requests: the single stream, bit for bit the library's run
    for key, body in (("lone", {"text": SERVE_TEXT, "temperature": 0}),
                      ("lone_lsd2", {"text": SERVE_TEXT, "temperature": 0, "lsd_steps": 2})):
        sub = b.stats()["requests_submitted"]
        t0 = time.perf_counter()
        wav = await app.generate_wav(state, body)
        wall = time.perf_counter() - t0
        _require(b.stats()["requests_submitted"] == sub, f"serve {key}: rode the batcher")
        got = _wav_samples(wav)
        _require(got.size == budgets[SERVE_TEXT] * fs, f"serve {key}: {got.size} samples")
        _require(wav == refs[key], f"serve {key}: differs from generate_with_pauses at temp 0")
        out[key] = {"wall_ms": wall * 1e3, "x_realtime": got.size / sr / wall}

    # (b) 16 concurrent requests: 8 /generate (two at temp 0), 4 /stream,
    # 2 OpenAI speech, 2 with lsd_steps 2 and a noise clamp
    texts = list(EXACT_TEXTS) + [BATCH_SENTENCES[i % 8] for i in range(2, 16)]
    kinds = ["generate"] * 8 + ["stream"] * 4 + ["speech"] * 2 + ["generate"] * 2
    bodies = [{"text": t} for t in texts]
    bodies[0]["temperature"] = bodies[1]["temperature"] = 0
    for body in bodies[14:]:
        body |= {"lsd_steps": 2, "noise_clamp": 0.5}
    walls, firsts = [None] * 16, []

    async def one(i):
        t0 = time.perf_counter()
        if kinds[i] == "stream":
            chunks = await app.open_stream(state, bodies[i])
            pieces = []
            async for c in chunks:
                if not pieces:
                    firsts.append((time.perf_counter() - t0) * 1e3)
                pieces.append(c)
            pcm = np.frombuffer(b"".join(pieces), "<i2")
        elif kinds[i] == "speech":
            pcm = _wav_samples(await app.generate_wav(state, app.openai_body(
                {"model": "pocket-tts", "input": texts[i], "voice": "alba"})))
        else:
            pcm = _wav_samples(await app.generate_wav(state, bodies[i]))
        walls[i] = (time.perf_counter() - t0) * 1e3
        return pcm

    subs = _Submissions(b)
    t0 = time.perf_counter()
    try:
        pcms = await asyncio.gather(*(one(i) for i in range(16)))
    finally:
        subs.close()
    wall = time.perf_counter() - t0
    _require(len(subs.texts) >= 15, f"serve: {len(subs.texts)} of 16 concurrent requests rode "
                                    "the batcher")
    for text, pcm in zip(texts, pcms):
        _require(pcm.size == budgets[text] * fs, f"serve {text!r}: {pcm.size} samples != "
                                                 f"{budgets[text]} x {fs}")
        _require(float(pcm.astype(np.float32).std()) > 0, f"serve {text!r}: silent")
    # each temp-0 request that rode the batcher (one at least) against its
    # own lone single stream: bf16 lanes drift from B=1
    corrs = [float(np.corrcoef(pcms[i].astype(np.float64), refs[texts[i]].astype(np.float64))[0, 1])
             for i in (0, 1) if texts[i] in subs.texts]
    _require(corrs and min(corrs) >= 0.99, f"serve: batched temp-0 lane vs single stream: {corrs}")
    secs = sum(p.size for p in pcms) / sr
    out["concurrent"] = {"wall_ms": wall * 1e3, "x_realtime": secs / wall,
                         "p50_ms": _pct(walls, 50), "p90_ms": _pct(walls, 90),
                         "first_pcm_p50_ms": _pct(firsts, 50), "first_pcm_p90_ms": _pct(firsts, 90),
                         "batched": len(subs.texts), "corr": corrs}

    # (b2) one burst of 16 /generate, routed (the first takes the single
    # stream) and with the single stream's lock held (all 16 on the
    # batcher), in turns: what the routing policy costs a burst
    burst = [{"text": BATCH_SENTENCES[i % 8]} for i in range(16)]

    async def one_burst(all_batched: bool) -> float:
        sub = b.stats()["requests_submitted"]
        t = time.perf_counter()
        async with state.lock if all_batched else contextlib.nullcontext():
            await asyncio.gather(*(app.generate_wav(state, dict(body)) for body in burst))
        t = (time.perf_counter() - t) * 1e3
        n = b.stats()["requests_submitted"] - sub
        _require(n == 16 if all_batched else n >= 15, f"serve burst: {n} on the batcher")
        return t

    out["burst_ms"] = {"all_batcher": [], "routed": []}
    for all_batched in (True, False, True):
        out["burst_ms"]["all_batcher" if all_batched else "routed"].append(
            await one_burst(all_batched))

    # (c) a 3 s voice as base64 WAV bytes: encoded once, then a cache hit
    pcm = (np.clip(_synthetic_voice(3.0, sr, seed=8), -1, 1) * 32767).astype("<i2")
    buf = io.BytesIO()
    with wave.open(buf, "wb") as f:
        f.setnchannels(2)
        f.setsampwidth(2)
        f.setframerate(sr)
        f.writeframes(pcm.T.tobytes())
    spec = base64.b64encode(buf.getvalue()).decode()
    resolve, times = state.resolve, []

    def timed_resolve(s, **kw):
        t = time.perf_counter()
        vs = resolve(s, **kw)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
        return vs

    state.resolve = timed_resolve
    try:
        lens, voiced = [], []
        for _ in range(2):
            before = len(state.cache)
            voiced.append(_wav_samples(await app.generate_wav(
                state, {"text": VOICE_TEXT, "voice": spec, "temperature": 0})))
            lens.append(len(state.cache) - before)
    finally:
        del state.resolve
    _require(lens == [1, 0], f"serve voice: cache grew by {lens} (want [1, 0])")
    _require(np.array_equal(voiced[0], voiced[1]) and voiced[0].size == budgets[VOICE_TEXT] * fs,
             "serve voice: the cached voice's temp-0 audio differs or is the wrong length")
    out["voice_ms"] = times

    # (d) client errors
    bad = [("missing text", {}), ("lsd_steps 0", {"text": "x", "lsd_steps": 0}),
           ("continuation_frames", {"text": "x", "continuation_frames": "lots"}),
           ("adapter", {"text": "x", "adapter": "spk"}),
           ("voice", {"text": "x", "voice": "no-such-voice"})]
    for name, body in bad:
        for call in (app.generate_wav, app.open_stream):
            try:
                await call(state, body)
            except app.RequestError as e:
                _require(e.status == 400, f"serve {name}: status {e.status}")
            else:
                raise RuntimeError(f"serve {name}: {call.__name__} raised no RequestError")

    # (e) a stream closed after its first chunk retires its batcher request
    cancelled = b.stats()["requests_cancelled"]
    async with state.lock:  # the single stream is busy: the stream rides the batcher
        chunks = await app.open_stream(state, {"text": CANCEL_TEXT})
        await anext(chunks)
        await chunks.aclose()
    deadline = time.monotonic() + 10
    while not b.idle():
        _require(time.monotonic() < deadline, f"serve: batcher not idle 10 s after a cancel: "
                                              f"{b.stats()}")
        await asyncio.sleep(0.01)
    _require(b.stats()["requests_cancelled"] == cancelled + 1, "serve: cancel not counted")

    # (f) metrics and health
    text = app.metrics_text(state)
    done = b.stats()["requests_completed"]
    _require(f"pocket_tts_requests_completed {done}\n" in text, f"serve metrics: {text}")
    health = app.health(state)
    _require(health["status"] == "ok" and "dead" not in health["batcher"]
             and not b.stats()["dead"], f"serve health: {health}")
    out["completed"] = done
    return out


async def _serve_quantized(state, model, budget: int) -> dict:
    """(g) one lone and four concurrent requests on the int8 + fp8 model."""
    from pocket_tts_tpu_torch.server import app

    body = {"text": NARROW_TEXT}
    lone = _wav_samples(await app.generate_wav(state, body))
    t0 = time.perf_counter()
    many = await asyncio.gather(*(app.generate_wav(state, dict(body)) for _ in range(4)))
    wall = time.perf_counter() - t0
    for pcm in [lone] + [_wav_samples(w) for w in many]:
        _require(pcm.size == budget * model.frame_size, f"serve int8+fp8: {pcm.size} samples")
    return {"wall_ms": wall * 1e3}


def phase_serve(model, q8fp8, smi: str) -> dict:
    """Phase 9: the serving tier's request layer (no aiohttp on this
    machine), on the full-width model; returns the launch counts."""
    from pocket_tts_tpu_torch import audio, native
    from pocket_tts_tpu_torch.kernels import flow_blocks as fb
    from pocket_tts_tpu_torch.kernels import qlinear as ql
    from pocket_tts_tpu_torch.runtime.engine import GenParams
    from pocket_tts_tpu_torch.server import app

    t_phase = time.perf_counter()
    lib = native.available()
    model.gen = GenParams(temp=0.7, eos_threshold=float("inf"))
    sr = model.sample_rate
    budgets = {t: _budget(model, t)
               for t in (SERVE_TEXT, VOICE_TEXT) + EXACT_TEXTS + BATCH_SENTENCES}
    # the library's single stream at temp 0, before the counted window
    lone_audio, lib_ms = _timed(lambda: model.with_params(temp=0).generate_with_pauses(SERVE_TEXT))
    refs = {"lone": audio.wav_bytes(lone_audio, sr),
            "lone_lsd2": audio.wav_bytes(model.with_params(
                temp=0, lsd_decode_steps=2).generate_with_pauses(SERVE_TEXT), sr)}
    for text in EXACT_TEXTS:
        refs[text] = (np.clip(model.with_params(temp=0).generate_with_pauses(text), -1, 1)
                      * 32767).astype("<i2")

    torch.cuda.synchronize()
    fb.flow_blocks.launches = ql.qlinear.launches = 0
    _attn_reset()
    evals0, frames0 = model.engine.flow_evals, model.engine.frames_decoded
    t0 = time.perf_counter()
    state = app.build_state(model, batch_size=16)  # start_server's batcher and warmup
    warm_s = time.perf_counter() - t0
    try:
        out = asyncio.run(_serve_requests(state, model, budgets, refs))
    finally:
        state.batcher.stop()
        state.pool.shutdown()
    launches = fb.flow_blocks.launches
    # a new batcher's engine starts from 0 evaluations
    evals = model.engine.flow_evals - evals0 + state.batcher.engine.flow_evals
    _require(launches == evals > 0, f"serve: flow_blocks launches {launches} != the engines' "
                                    f"flow evaluations {evals}")
    _require(ql.qlinear.launches == 0, "serve: qlinear launched on the bf16 model")
    attn = _attn_check("serve (single stream and batcher)", model.engine.frames_decoded
                       - frames0 + state.batcher.engine.frames_decoded, model)

    # (g) the int8 + fp8 model behind its own state
    q8fp8.gen = model.gen
    qstate = app.build_state(q8fp8, batch_size=16)
    qengines = [q8fp8.engine, qstate.batcher.engine]
    expects = [_ExpectedQlinear(e) for e in qengines]
    qevals0 = [e.flow_evals for e in qengines]
    torch.cuda.synchronize()
    fb.flow_blocks.launches = ql.qlinear.launches = 0
    try:
        qout = asyncio.run(_serve_quantized(qstate, q8fp8, _budget(q8fp8, NARROW_TEXT)))
    finally:
        for x in expects:
            x.close()
        qstate.batcher.stop()
        qstate.pool.shutdown()
    qlaunches, qflow = ql.qlinear.launches, fb.flow_blocks.launches
    qevals = sum(e.flow_evals - v for e, v in zip(qengines, qevals0))
    want = sum(x.count for x in expects)
    _require(qlaunches == want > 0, f"serve int8+fp8: qlinear launches {qlaunches} != {want}")
    _require(qflow == qevals > 0, f"serve int8+fp8: flow_blocks {qflow} != evaluations {qevals}")

    lone, con = out["lone"], out["concurrent"]
    secs = time.perf_counter() - t_phase
    print(f"serve [{smi}]: request layer without aiohttp, native audio library "
          f"{'loaded' if lib else 'not loaded (numpy versions)'}; build_state (batched_tts "
          f"B=16 chunk 64 depth 2, warmup) {warm_s:.2f} s")
    print(f"serve [{smi}]: lone /generate temp 0 ({budgets[SERVE_TEXT]} frames, single stream, "
          f"== generate_with_pauses bit for bit; lsd_steps 2 too): {lone['wall_ms']:.1f} ms, "
          f"x-realtime {lone['x_realtime']:.2f} (lsd 2: {out['lone_lsd2']['wall_ms']:.1f} ms); "
          f"the library's generate_with_pauses alone, before the server: {lib_ms:.1f} ms")
    print(f"serve [{smi}]: 16 concurrent (8 /generate, 4 /stream, 2 speech, 2 lsd 2 + clamp), "
          f"{con['batched']} on the batcher: wall {con['wall_ms']:.1f} ms, aggregate x-realtime "
          f"{con['x_realtime']:.2f}, per-request p50 {con['p50_ms']:.1f} / p90 "
          f"{con['p90_ms']:.1f} ms; streams' first PCM bytes p50 {con['first_pcm_p50_ms']:.1f} / "
          f"p90 {con['first_pcm_p90_ms']:.1f} ms; batched temp-0 lane vs its single stream "
          f"corr {', '.join(f'{c:.5f}' for c in con['corr'])}")
    bursts = out["burst_ms"]
    print(f"serve [{smi}]: a burst of 16 /generate in turns (all on the batcher, routed, all on the "
          f"batcher): all on the batcher {', '.join(f'{t:.1f}' for t in bursts['all_batcher'])} ms; "
          f"routed (one on the single stream, 15 on the batcher) "
          f"{', '.join(f'{t:.1f}' for t in bursts['routed'])} ms")
    print(f"serve [{smi}]: 3 s base64 voice: resolve cold {out['voice_ms'][0]:.1f} ms, cached "
          f"{out['voice_ms'][1]:.3f} ms (cache +1 then +0, temp-0 audio equal); 5 client errors x "
          f"2 routes -> RequestError 400; a stream closed after its first chunk cancelled, "
          f"batcher idle; /metrics requests_completed {out['completed']}, /health ok")
    print(f"serve [{smi}]: int8 + fp8 e4m3: 1 lone + 4 concurrent {NARROW_TEXT!r}, 4 in "
          f"{qout['wall_ms']:.1f} ms; qlinear launches {qlaunches} = the shape rule's, "
          f"flow_blocks {qflow} = evaluations")
    print(f"serve [{smi}]: flow_blocks launches {launches} = the engines' flow evaluations; "
          f"phase took {secs:.1f} s")
    return {"flow_launches": launches, "flow_launches_quantized": qflow,
            "qlinear_launches": qlaunches, "attn": attn}




# -- phase 10: fine-tuning and per-slot LoRA ---------------------------------------------

# card vs CPU, float32 with TF32 off, one loss at full width: other summation
# orders over the same products (bounds of the CPU tests against JAX)
LOSS_TOL = 1e-5  # x max(1, |CPU|), the loss and each metric
GRAD_TOL = 1e-4  # x max(1, max |g_CPU|), each gradient leaf
TRAIN_STEPS = 8
TRAIN_TEXT = "A tuned voice reads this line."
ADAPTER_TEXTS = ("The first adapter speaks here.", "The second adapter answers.",
                 "And the base model closes.")


def _train_pairs(sr: int) -> list:
    """8 (text, mono waveform) pairs of 2-6 s, seeded synthetic voices."""
    return [(BATCH_SENTENCES[i], _synthetic_voice(2.0 + 4.0 * i / 7, sr, seed=20 + i).mean(0))
            for i in range(8)]


class _StepLog(logging.Handler):
    """The trainer's per-step log records (loss and the time they were made:
    each record follows a host read of the step's metrics, a synchronize)."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.records: list = []
        self.logger = logging.getLogger("pocket_tts_tpu_torch.training.trainer")
        self.logger.addHandler(self)
        self.level0 = self.logger.level
        self.logger.setLevel(logging.INFO)

    def emit(self, record):
        self.records.append((record.created, record.args))

    def close(self):
        self.logger.removeHandler(self)
        self.logger.setLevel(self.level0)
        super().close()


def _train_card_vs_cpu(model) -> dict:
    """(a) the loss at full width in float32, card against CPU."""
    from pocket_tts_tpu_torch.training import flow_matching_loss, make_batch
    from pocket_tts_tpu_torch.training.loss import sample_draws
    from pocket_tts_tpu_torch.training.trainer import _map

    pairs = _train_pairs(model.sample_rate)[:2]
    batch = make_batch(model, pairs)
    b, tf, ldim = batch["latents"].shape
    draws = sample_draws(torch.Generator().manual_seed(3), b, tf, ldim, torch.device("cpu"),
                         consistency=True)
    out = {}
    for dev in ("cuda", "cpu"):
        params = _map(model.params["flow_lm"],
                      lambda t: t.detach().to(dev, torch.float32, copy=True).requires_grad_(True))
        loss, metrics = flow_matching_loss(params, model.config, batch, draws=draws,
                                           consistency_weight=0.5)
        loss.backward()
        out[dev] = ({k: v.item() for k, v in metrics.items()},
                    {p: t.grad.cpu() for p, t in _flat(params) if t.grad is not None})
        del params, loss
    (mg, gg), (mc, gc) = out["cuda"], out["cpu"]
    worst_m = max(abs(mg[k] - v) / max(1.0, abs(v)) for k, v in mc.items())
    _require(sorted(mg) == sorted(mc) and worst_m <= LOSS_TOL,
             f"train: loss/metrics card vs CPU {mg} vs {mc}")
    _require(sorted(gg) == sorted(gc), "train: gradient leaves differ")
    worst_g = max(float((gg[p] - g).abs().max()) / max(1.0, float(g.abs().max()))
                  for p, g in gc.items())
    _require(worst_g <= GRAD_TOL, f"train: gradient card vs CPU {worst_g} > {GRAD_TOL}")
    print(f"train: flow_matching_loss full width f32 (TF32 off), B={b}, Tf={tf}, consistency "
          f"0.5, fixed draws: card vs CPU loss/metrics max rel err {worst_m:.2e} (bound "
          f"{LOSS_TOL}), {len(gc)} gradient leaves max err / max(1, max|g|) {worst_g:.2e} "
          f"(bound {GRAD_TOL}); metrics {', '.join(f'{k} {v:.4f}' for k, v in mc.items())}")
    return {"loss_err": worst_m, "grad_err": worst_g}


def _train_guard(dev) -> None:
    """(b) both kernels refuse autograd on the card."""
    from pocket_tts_tpu_torch.kernels import flow_blocks as fb
    from pocket_tts_tpu_torch.kernels import qlinear as ql
    from pocket_tts_tpu_torch.ops.qtensor import quantize_array

    g = torch.Generator().manual_seed(0)
    blocks = _random_blocks(g, 512, 6, dev)
    sy, h0 = _random_inputs(g, 2, 512, dev)
    w = quantize_array(torch.randn(1024, 1024, generator=g)).to(dev).to(torch.bfloat16)
    x = torch.randn(1, 1024, generator=g).to(dev, torch.bfloat16)
    for name, call in (("flow_blocks", lambda: fb.flow_blocks(sy, h0.requires_grad_(True),
                                                              blocks)),
                       ("qlinear", lambda: ql.qlinear(x.requires_grad_(True), w))):
        try:
            call()
        except RuntimeError as e:
            _require("no backward" in str(e), f"train: {name} raised {e}")
        else:
            raise RuntimeError(f"train: {name} ran under autograd with an input that "
                               "requires grad")
    print("train: flow_blocks and qlinear raise under autograd (inputs requiring grad) "
          "on the card")


def _finetune_run(model, pairs, smi: str, steps: int = TRAIN_STEPS, where: str = "train",
                  **kw):
    """One ``finetune`` on the card over all ``pairs`` as one batch: (clone,
    per-step losses, ms per step, peak GiB, the peak's GiB above what was
    allocated before the run)."""
    from pocket_tts_tpu_torch.training import finetune

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated() / 2**30
    log = _StepLog()
    try:
        t0 = time.perf_counter()
        tuned = finetune(model, pairs, steps=steps, batch_size=len(pairs), lr=1e-4,
                         log_every=1, seed=0, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        log.close()
    peak = torch.cuda.max_memory_allocated() / 2**30
    _require(len(log.records) == steps, f"{where}: {len(log.records)} logged steps")
    losses = [args[2] for _, args in log.records]
    _require(all(math.isfinite(v) for v in losses), f"{where}: losses {losses}")
    steps_ms = [(b[0] - a[0]) * 1e3 for a, b in zip(log.records, log.records[1:])]
    ms = statistics.median(steps_ms)
    kind = f"LoRA rank {kw['lora_rank']}" if kw.get("lora_rank") else "full"
    mesh = kw.get("mesh")
    on = "one device" if mesh is None else f"dp {mesh.shape['dp']} x tp {mesh.shape['tp']}"
    print(f"{where} [{smi}]: finetune ({kind}, {on}) {len(pairs)} pairs x {steps} steps, batch "
          f"{len(pairs)}, full width: losses {', '.join(f'{v:.4f}' for v in losses)}; ms per "
          f"step {ms:.1f} (median of {len(steps_ms)}, synchronized); peak {peak:.2f} GiB "
          f"({peak - held:.2f} above the {held:.2f} allocated before); {wall:.1f} s in all "
          f"(data prep and the clone included)")
    return tuned, losses, ms, peak, peak - held


def _generate_launches(m, text: str) -> tuple[int, dict]:
    """A temp-0 ``generate`` with EOS off: its flow_blocks launches, checked
    against frames x lsd_decode_steps, and its decode_attention launches."""
    from pocket_tts_tpu_torch.kernels import flow_blocks as fb
    from pocket_tts_tpu_torch.runtime.engine import GenParams

    m.gen = GenParams(temp=0.0, eos_threshold=float("inf"))
    eng = m.engine
    torch.cuda.synchronize()
    fb.flow_blocks.launches = eng.frames_decoded = eng.flow_evals = 0
    _attn_reset()
    audio = m.generate(text)
    n = fb.flow_blocks.launches
    _require(eng.frames_decoded > 0 and n == eng.frames_decoded * m.gen.lsd_decode_steps,
             f"train: generate flow_blocks launches {n} != frames {eng.frames_decoded} x steps")
    _require(audio.size == _budget(m, text) * m.frame_size and bool(np.isfinite(audio).all())
             and float(audio.std()) > 0, f"train: tuned generate: bad audio ({audio.size})")
    return n, _attn_check("train: the tuned model's generate", eng.frames_decoded, m)


def _train_finetunes(model, tmp: Path, smi: str) -> dict:
    """(c) the full fine-tune and (d) the LoRA fine-tune at full width."""
    from pocket_tts_tpu_torch.kernels import qlinear as ql
    from pocket_tts_tpu_torch.training import (
        apply_adapted, load_lora_params, save_finetuned_params, save_lora_params)

    pairs = _train_pairs(model.sample_rate)
    out = {}
    tuned, losses, ms, peak, _ = _finetune_run(model, pairs, smi)
    full = tmp / "full.safetensors"
    save_finetuned_params(tuned.params["flow_lm"], full)
    back = apply_adapted(model, full)
    _require(all(torch.equal(a, b) for (_, a), (_, b) in zip(
        _flat(tuned.params["flow_lm"]), _flat(back.params["flow_lm"]))),
        "train: save_finetuned_params -> apply_adapted is not bit-equal")
    moved = not torch.equal(tuned.params["flow_lm"]["tf"]["ff1"], model.params["flow_lm"]["tf"]["ff1"])
    _require(moved, "train: the full fine-tune moved no weight")
    ql.qlinear.launches = 0
    launches, attn = _generate_launches(back, TRAIN_TEXT)
    _require(ql.qlinear.launches == 0, "train: qlinear launched on a bf16 model")
    print(f"train: save_finetuned_params -> apply_adapted bit-equal; temp-0 generate of the "
          f"tuned model: flow_blocks launches {launches} = frames x 1")
    out["full"] = {"losses": losses, "ms_per_step": ms, "peak_gib": peak,
                   "generate_launches": launches, "attn": attn}
    del tuned, back

    snapshot = {p: t.clone() for p, t in _flat(model.params["flow_lm"])}
    tuned, losses, ms, peak, _ = _finetune_run(model, pairs, smi, lora_rank=8)
    _require(all(torch.equal(snapshot[p], t) for p, t in _flat(model.params["flow_lm"])),
             "train: LoRA fine-tune changed the base params")
    factors, rank, alpha = tuned._lora
    lora = tmp / "lora.safetensors"
    save_lora_params(factors, lora, rank=rank, alpha=alpha)
    got, r2, a2 = load_lora_params(lora)
    _require((r2, a2) == (8, 8.0) and sorted(got) == sorted(factors) and all(
        torch.equal(got[t][k], factors[t][k]) for t in factors for k in ("a", "b")),
        "train: LoRA artifact round trip")
    print(f"train: LoRA base params bit-unchanged; factor artifact {lora.stat().st_size / 2**20:.2f}"
          f" MiB ({full.stat().st_size / 2**20:.1f} MiB full) round-trips bit for bit")
    out["lora"] = {"losses": losses, "ms_per_step": ms, "peak_gib": peak}
    out["paths"] = {"full": full, "lora": lora}
    return out


def _random_adapters(model, tmp: Path) -> dict:
    """Two adapters with non-zero factors: rank 2 on every target, rank 3 on
    in_proj and ff1 only; name -> path."""
    from pocket_tts_tpu_torch.training import init_lora, save_lora_params

    paths = {}
    for name, rank, targets, seed in (("one", 2, None, 31), ("two", 3, ("tf/in_proj", "tf/ff1"), 32)):
        kw = {"targets": targets} if targets else {}
        factors = init_lora(model.params["flow_lm"], rank, seed=seed, **kw)
        g = torch.Generator().manual_seed(seed)
        for f in factors.values():
            f["b"] = torch.randn(f["b"].shape, generator=g) * 0.02
        paths[name] = tmp / f"{name}.lora.safetensors"
        save_lora_params(factors, paths[name], rank=rank, alpha=float(rank))
    return paths


def _bank_exactness(model, paths: dict) -> None:
    """(e) a full-width float32 B=4 batcher with the bank (the model's
    weights): each lane against its merged single stream."""
    from pocket_tts_tpu_torch import config
    from pocket_tts_tpu_torch.kernels import flow_blocks as fb
    from pocket_tts_tpu_torch.runtime.batcher import ContinuousBatcher
    from pocket_tts_tpu_torch.runtime.engine import GenParams
    from pocket_tts_tpu_torch.training import apply_adapted
    from pocket_tts_tpu_torch.training.lora import build_adapter_bank
    from pocket_tts_tpu_torch.tts import TTSModel

    cfg = config.load_variant()
    cfg = dataclasses.replace(cfg, runtime=dataclasses.replace(cfg.runtime,
                                                               compute_dtype="float32"))
    gen = GenParams(temp=0.0, eos_threshold=float("inf"))
    m32 = TTSModel(cfg, model.params, gen=gen, has_real_weights=False, device="cuda")
    names = ["one", "two", None]
    singles = []
    for name, text in zip(names, ADAPTER_TEXTS):
        m = m32 if name is None else apply_adapted(m32, paths[name])
        m.gen = gen
        singles.append(m.generate_with_pauses(text))
        del m
    b = ContinuousBatcher(m32, batch_size=4, chunk_frames=8,
                          adapter_bank=build_adapter_bank({k: str(v) for k, v in paths.items()}))
    b.start()
    try:
        launches, evals = fb.flow_blocks.launches, b.engine.flow_evals
        results = b.generate_batch(list(ADAPTER_TEXTS), adapters=names)
        launches, evals = fb.flow_blocks.launches - launches, b.engine.flow_evals - evals
    finally:
        b.stop()
    _require(launches == evals > 0, f"bank f32: launches {launches} != evaluations {evals}")
    worst = 0
    for name, got, want in zip(names, results, singles):
        _require(got.shape == want.shape, f"bank f32 {name}: {got.shape} vs {want.shape}")
        worst = max(worst, int(np.abs(_pcm(got) - _pcm(want)).max()))
    _require(worst <= REF_TOL_LSB, f"bank f32 lanes vs merged single streams: {worst} LSB")
    apart = int(np.abs(_pcm(singles[0][:singles[2].size]) - _pcm(singles[2][:singles[0].size])).max())
    print(f"train: bank f32 full width, B=4 chunk 8, lanes (one rank 2, two rank 3 on 2 "
          f"targets, base) == their merged single streams within {worst} int16 LSB (bound "
          f"{REF_TOL_LSB}; the adapters move the audio by {apart} LSB); {launches} flow_blocks "
          f"launches = evaluations")
    del m32, b
    torch.cuda.empty_cache()


def _bank_batch(model, paths: dict, smi: str) -> dict:
    """(f) batched_tts(16, 64) on the bf16 model with and without the bank,
    in turns, then with the bank on int8 + fp8 (launch counts checked)."""
    from pocket_tts_tpu_torch.kernels import flow_blocks as fb
    from pocket_tts_tpu_torch.kernels import qlinear as ql
    from pocket_tts_tpu_torch.runtime.batcher import batched_tts
    from pocket_tts_tpu_torch.runtime.engine import GenParams
    from pocket_tts_tpu_torch.training.lora import build_adapter_bank

    bank = build_adapter_bank({k: str(v) for k, v in paths.items()})
    texts = [ADAPTER_TEXTS[i % 3] for i in range(16)]
    names = [(None, "one", "two")[i % 3] for i in range(16)]
    model.gen = GenParams(temp=0.7, eos_threshold=float("inf"))
    banked = batched_tts(model, batch_size=16, chunk_frames=64, adapter_bank=bank)
    plain = batched_tts(model, batch_size=16, chunk_frames=64)
    xrt = {"bank": [], "plain": []}
    try:
        for b in (banked, plain):
            b.warmup()
        for key in ("bank", "plain", "plain", "bank"):
            b = banked if key == "bank" else plain
            eng = b.engine
            torch.cuda.synchronize()
            fb.flow_blocks.launches = ql.qlinear.launches = eng.flow_evals = 0
            t0 = time.perf_counter()
            results = b.generate_batch(texts, adapters=names if key == "bank" else None)
            wall = time.perf_counter() - t0
            _require(fb.flow_blocks.launches == eng.flow_evals > 0,
                     f"bank bf16 {key}: flow_blocks {fb.flow_blocks.launches} != "
                     f"{eng.flow_evals}")
            _require(ql.qlinear.launches == 0, "bank bf16: qlinear launched")
            for text, audio in zip(texts, results):
                _require(audio.size == _budget(model, text) * model.frame_size
                         and bool(np.isfinite(audio).all()) and float(audio.std()) > 0,
                         f"bank bf16 {key} {text!r}: bad audio")
            xrt[key].append(sum(a.size for a in results) / model.sample_rate / wall)
        launches = fb.flow_blocks.launches  # the last (bank) run's
    finally:
        banked.stop()
        plain.stop()
    print(f"train [{smi}]: batched_tts B=16 chunk 64 bf16, 16 requests (5 base / 6 one / 5 "
          f"two) in turns bank, plain, plain, bank: aggregate x-realtime bank "
          f"{', '.join(f'{v:.2f}' for v in xrt['bank'])}, plain (all base, no bank) "
          f"{', '.join(f'{v:.2f}' for v in xrt['plain'])}; flow_blocks launches {launches} = "
          f"evaluations")
    return {"x_realtime": xrt, "flow_launches": launches}


def _bank_quantized(q8fp8, paths: dict, smi: str) -> dict:
    """(f) the bank on int8 + fp8: qlinear launches by the shape rule."""
    from pocket_tts_tpu_torch.kernels import flow_blocks as fb
    from pocket_tts_tpu_torch.kernels import qlinear as ql
    from pocket_tts_tpu_torch.runtime.batcher import batched_tts
    from pocket_tts_tpu_torch.runtime.engine import GenParams
    from pocket_tts_tpu_torch.training.lora import build_adapter_bank

    bank = build_adapter_bank({k: str(v) for k, v in paths.items()})
    texts = [ADAPTER_TEXTS[i % 3] for i in range(16)]
    names = [(None, "one", "two")[i % 3] for i in range(16)]
    q8fp8.gen = GenParams(temp=0.7, eos_threshold=float("inf"))
    b = batched_tts(q8fp8, batch_size=16, chunk_frames=64, adapter_bank=bank)
    try:
        b.warmup()
        eng = b.engine
        expect = _ExpectedQlinear(eng)
        torch.cuda.synchronize()
        fb.flow_blocks.launches = ql.qlinear.launches = eng.flow_evals = 0
        t0 = time.perf_counter()
        results = b.generate_batch(texts, adapters=names)
        wall = time.perf_counter() - t0
        expect.close()
        qn, fn_ = ql.qlinear.launches, fb.flow_blocks.launches
    finally:
        b.stop()
    _require(fn_ == eng.flow_evals > 0, f"bank int8: flow_blocks {fn_} != {eng.flow_evals}")
    _require(qn == expect.count > 0, f"bank int8: qlinear launches {qn} != {expect.count}")
    for text, audio in zip(texts, results):
        _require(audio.size == _budget(q8fp8, text) * q8fp8.frame_size
                 and bool(np.isfinite(audio).all()), f"bank int8 {text!r}: bad audio")
    secs = sum(a.size for a in results) / q8fp8.sample_rate
    print(f"train [{smi}]: bank on int8 + fp8 e4m3, batched_tts B=16 chunk 64, 16 requests: "
          f"aggregate x-realtime {secs / wall:.2f}; flow_blocks {fn_} = evaluations, qlinear "
          f"{qn} = the shape rule's (the deltas are plain products beside the base's)")
    return {"flow_launches": fn_, "qlinear_launches": qn}


def _train_cli(model, tmp: Path) -> Path:
    """(g) ``finetune --lora-rank 8`` and ``generate --finetuned`` as
    subprocesses; returns the adapter they wrote."""
    import wave as wave_mod

    root = Path(__file__).resolve().parent
    lines = []
    for i, (text, wav) in enumerate(_train_pairs(24000)[:4]):
        path = tmp / f"pair{i}.wav"
        with wave_mod.open(str(path), "wb") as f:
            f.setnchannels(1)
            f.setsampwidth(2)
            f.setframerate(24000)
            f.writeframes((np.clip(wav, -1, 1) * 32767).astype("<i2").tobytes())
        lines.append(json.dumps({"text": text, "audio": path.name}))
    (tmp / "pairs.jsonl").write_text("\n".join(lines) + "\n", encoding="utf-8")
    adapter = tmp / "cli.lora.safetensors"
    runs = [["finetune", "--manifest", str(tmp / "pairs.jsonl"), "-o", str(adapter),
             "--lora-rank", "8", "--steps", "2", "--batch-size", "4", "--log-every", "1"],
            ["generate", "--finetuned", str(adapter), "--eos-threshold", "inf", "--quiet",
             "--text", TRAIN_TEXT, "-o", str(tmp / "ft.wav")]]
    for args in runs:
        t0 = time.perf_counter()
        res = subprocess.run([sys.executable, "-m", "pocket_tts_tpu_torch.cli", *args,
                              "--device", "cuda"], cwd=root, capture_output=True, text=True,
                             timeout=600)
        dt = time.perf_counter() - t0
        _require(res.returncode == 0, f"cli {args[0]}: exit {res.returncode}\n{res.stderr[-3000:]}")
        _require("device: cuda" in res.stderr, f"cli {args[0]}: no cuda device line")
        said = [ln for ln in res.stderr.splitlines() if "wrote" in ln or "realtime" in ln]
        print(f"train: cli {args[0]} --device cuda: exit 0 in {dt:.1f} s; "
              f"{said[-1].strip() if said else ''}")
    with wave.open(str(tmp / "ft.wav"), "rb") as f:
        got = f.getnframes()
    want = _budget(model, TRAIN_TEXT) * model.frame_size
    _require(got == want, f"cli generate --finetuned: {got} samples != {want}")
    return adapter


async def _serve_adapters(state, model, budgets: dict) -> int:
    """(g) the bankable adapter on the batcher, the full fine-tune on its
    merged model; returns how many requests rode the batcher."""
    from pocket_tts_tpu_torch.server import app

    subs = _Submissions(state.batcher)
    try:
        async with state.lock:  # the single stream is busy: "lora" rides the batcher
            wav = await app.generate_wav(state, {"text": TRAIN_TEXT, "adapter": "lora"})
        _require(_wav_samples(wav).size == budgets[TRAIN_TEXT] * model.frame_size,
                 "serve adapter lora: wrong length")
        riders = len(subs.texts)
        wav = await app.generate_wav(state, {"text": VOICE_TEXT, "adapter": "full"})
        _require(_wav_samples(wav).size == budgets[VOICE_TEXT] * model.frame_size,
                 "serve adapter full: wrong length")
        chunks = await app.open_stream(state, {"text": VOICE_TEXT, "adapter": "full"})
        pcm = b"".join([c async for c in chunks])
        _require(len(pcm) == 2 * budgets[VOICE_TEXT] * model.frame_size,
                 "serve adapter full stream: wrong length")
    finally:
        subs.close()
    _require(riders == 1 and len(subs.texts) == 1,
             f"serve adapters: {subs.texts} rode the batcher (want the lora request only)")
    return riders


def phase_train(model, q8fp8, smi: str) -> dict:
    """Phase 10: fine-tuning and per-slot LoRA on the card, full width."""
    from pocket_tts_tpu_torch.runtime.engine import GenParams
    from pocket_tts_tpu_torch.server import app

    t_phase = time.perf_counter()
    marks = []

    def mark(name):
        marks.append((name, time.perf_counter()))

    tmp_dir = tempfile.TemporaryDirectory()
    tmp = Path(tmp_dir.name)
    out = {"card_vs_cpu": _train_card_vs_cpu(model)}
    _train_guard(torch.device("cuda"))
    mark("a-b")
    out.update(_train_finetunes(model, tmp, smi))
    mark("c-d")
    paths = _random_adapters(model, tmp)
    _bank_exactness(model, paths)
    mark("e")
    out["bank"] = _bank_batch(model, paths, smi)
    out["bank_quantized"] = _bank_quantized(q8fp8, paths, smi)
    mark("f")
    cli_adapter = _train_cli(model, tmp)
    mark("g cli")

    model.gen = GenParams(temp=0.7, eos_threshold=float("inf"))
    budgets = {t: _budget(model, t) for t in (TRAIN_TEXT, VOICE_TEXT)}
    state = app.build_state(model, batch_size=16, adapters={
        "lora": str(cli_adapter), "full": str(out["paths"]["full"])})
    try:
        _require(state.bankable == frozenset({"lora"}), f"serve adapters: {state.bankable}")
        riders = asyncio.run(_serve_adapters(state, model, budgets))
    finally:
        state.batcher.stop()
        state.pool.shutdown()
    print(f"train: request layer with adapters lora (bankable, {riders} request on the batcher) "
          f"and full (merged LRU: /generate and /stream): bodies of their budgets' lengths")
    tmp_dir.cleanup()
    mark("g serve")
    t, parts = t_phase, []
    for name, at in marks:
        parts.append(f"{name} {at - t:.1f}")
        t = at
    print(f"train: phase took {time.perf_counter() - t_phase:.1f} s ({', '.join(parts)} s)")
    return out


# -- phase 11: multi-device serving, the dp x tp mesh and the staged codec -----------

MESH_SHARDED = (
    "flow_lm/tf/in_proj", "flow_lm/tf/out_proj", "flow_lm/tf/ff1", "flow_lm/tf/ff2",
    "mimi/enc_tf/layers/in_proj", "mimi/enc_tf/layers/out_proj",
    "mimi/enc_tf/layers/ff1", "mimi/enc_tf/layers/ff2",
    "mimi/dec_tf/layers/in_proj", "mimi/dec_tf/layers/out_proj",
    "mimi/dec_tf/layers/ff1", "mimi/dec_tf/layers/ff2")  # tests/test_sharding.py:182-189
MESH_TEXT = "The mesh splits every layer of the backbone over its ranks."
MESH_TEXTS = ("The first admitted request speaks in one voice.", "A second one, another.")
MESH_FRAMES = 8  # frames per chunk of the mesh runs
MESH_LATENT_TOL = (2e-4, 1e-3)  # atol, rtol: f32 latents at full width (test_sharding.py:115)
MESH_LSB = 1  # int16 LSB: f32 sums in another order (tests/test_sharding.py:82-86)
STAGED_TEXT = ("Staging the codec on a stream of its own. "
               "The frames of the next chunk run beside it.")


def _mesh_tokens(model, text: str, batch: int):
    from pocket_tts_tpu_torch import text as text_mod

    prepared, _ = text_mod.prepare_text_prompt(text)
    tokens, n = text_mod.tokens_array(model.tokenizer, prepared)
    return np.tile(tokens, (batch, 1)), n


def _mesh_decode(eng, tokens, n: int, chunks: int, seed: int, state=None):
    """Prefill (unless ``state`` is given) and ``chunks`` x MESH_FRAMES frames
    at temp 0.5 from one seeded generator: (int16 audio [B, T], latents
    [B, ldim] on the host, state)."""
    from pocket_tts_tpu_torch.parallel.mesh import gather
    from pocket_tts_tpu_torch.runtime.engine import GenParams

    st = state if state is not None else eng.prefill_tokens(eng.new_state(), tokens, n)
    gen = torch.Generator(device=eng.device).manual_seed(seed)
    pcm = []
    for _ in range(chunks):
        st, audio, _ = eng.decode_frames(st, MESH_FRAMES, GenParams(
            temp=0.5, eos_threshold=float("inf")), gen)
        pcm.append(audio.cpu().numpy().astype(np.int64))
    return np.concatenate(pcm, 1), gather(st["latent"], "cpu").float().numpy(), st


def _mesh_gap(a, b, la, lb) -> tuple[int, float]:
    _require(a.shape == b.shape, f"mesh: audio {a.shape} vs {b.shape}")
    _require(bool(np.isfinite(la).all()), "mesh: non-finite latents")
    return int(np.abs(a - b).max()), float(np.abs(la - lb).max())


def _mesh_layout(model, dev, smi: str) -> None:
    """(a) make_mesh() over this machine's cards and its shard report; the
    flagship's manifest at tp 2 / 4 / 8 over [card] x 8."""
    from pocket_tts_tpu_torch.parallel import mesh as pm

    m = pm.make_mesh()
    print(f"mesh: make_mesh() over {torch.cuda.device_count()} card(s) [{smi}]: dp "
          f"{m.shape['dp']} x tp {m.shape['tp']}; its shard report:")
    print(pm.format_shard_report(pm.shard_params(model.engine.params, m)))
    for tp in (2, 4, 8):
        man = pm.sharding_manifest(pm.shard_params(
            model.engine.params, pm.make_mesh(8, tp=tp, devices=[dev] * 8)))
        missing = [k for k in MESH_SHARDED if not man[k]["sharded"]]
        _require(not missing, f"mesh: tp {tp}: silently de-sharded: {missing}")
        split = sorted(k for k, v in man.items() if v["sharded"])
        print(f"mesh: manifest at tp {tp} over [{dev}] x 8 (dp {8 // tp}): {len(split)} leaves "
              f"sharded, the twelve transformer products among them; flow_lm/tf/in_proj "
              f"{man['flow_lm/tf/in_proj']['shape']} {man['flow_lm/tf/in_proj']['spec']}, "
              f"ff2 {man['flow_lm/tf/ff2']['spec']}")
    torch.cuda.empty_cache()


def _mesh_f32(model, dev, smi: str) -> dict:
    """(b) f32 mesh engines against single-device engines on the same
    weights: tp 2 at B = 2, and dp 2 x tp 2 at B = 4 with two admitted
    requests of other voices and texts, its launches counted (flow_blocks
    = frames x steps x dp, decode_attention = frames x layers x dp x tp)."""
    from pocket_tts_tpu_torch.kernels import decode_attention as da
    from pocket_tts_tpu_torch.kernels import flow_blocks as fb
    from pocket_tts_tpu_torch.parallel.mesh import make_mesh
    from pocket_tts_tpu_torch.runtime.engine import Engine, GenParams

    cfg = dataclasses.replace(model.config, runtime=dataclasses.replace(
        model.config.runtime, compute_dtype="float32"))
    tokens, n = _mesh_tokens(model, MESH_TEXT, 2)
    out = {}
    ref = _mesh_decode(Engine(cfg, model.params, dev, batch_size=2), tokens, n, 2, 11)
    got = _mesh_decode(Engine(cfg, model.params, batch_size=2,
                              mesh=make_mesh(2, devices=[dev] * 2)), tokens, n, 2, 11)
    lsb, dl = _mesh_gap(got[0], ref[0], got[1], ref[1])
    atol, rtol = MESH_LATENT_TOL
    _require(lsb <= MESH_LSB, f"mesh: f32 tp 2 vs one device: {lsb} int16 LSB")
    _require(bool(np.all(np.abs(got[1] - ref[1]) <= atol + rtol * np.abs(ref[1]))),
             f"mesh: f32 tp 2 latents differ by {dl}")
    print(f"mesh: f32 tp 2 over [{dev}] x 2, B 2, prefill + 2 chunks of {MESH_FRAMES} frames "
          f"at temp 0.5 [{smi}]: audio within {lsb} int16 LSB (bound {MESH_LSB}), latents max "
          f"|diff| {dl:.3e} (atol {atol}, rtol {rtol}) of one device")
    out["tp2"] = {"lsb": lsb, "latent": dl}

    ve = Engine(cfg, model.params, dev)
    voices = []
    for seed in (21, 22):
        wav = _synthetic_voice(3.0, model.sample_rate, seed)[0]
        cond, frames = ve.encode_voice(wav)
        st = ve.prefill_conditioning(ve.new_state(), cond, frames)
        voices.append({k: st[k] for k in ("kc", "vc", "pos")})
    rows = [_mesh_tokens(model, t, 1) for t in MESH_TEXTS]

    def admitted(eng):
        st = eng.new_state()
        for slot, vs, (tok, k) in zip((0, 2), voices, rows):
            st = eng.admit_prefill_slot(st, slot, vs, eng.pad_token_row(tok), k)
        return _mesh_decode(eng, None, 0, 2, 12, state=st)

    ref = admitted(Engine(cfg, model.params, dev, batch_size=4))
    mesh = make_mesh(4, tp=2, devices=[dev] * 4)
    eng = Engine(cfg, model.params, batch_size=4, mesh=mesh)
    fb.flow_blocks.launches = 0
    _attn_reset()
    torch.cuda.synchronize()
    got = admitted(eng)
    torch.cuda.synchronize()
    launches = {"flow_blocks": fb.flow_blocks.launches,
                "decode_attention": da.decode_attention.launches}
    dp, tp, frames = mesh.shape["dp"], mesh.shape["tp"], 2 * MESH_FRAMES
    layers, steps = cfg.flow_lm.transformer.num_layers, GenParams().lsd_decode_steps
    want = {"flow_blocks": frames * steps * dp, "decode_attention": frames * layers * dp * tp}
    _require(launches == want, f"mesh: dp 2 x tp 2 launches {launches}, the rules give {want}")
    lanes = [_mesh_gap(got[0][i], ref[0][i], got[1][i], ref[1][i])[0] for i in range(4)]
    apart = int(np.abs(ref[0][0] - ref[0][2]).max())
    _require(max(lanes) <= MESH_LSB, f"mesh: dp 2 x tp 2 lanes vs one device: {lanes} LSB")
    _require(apart > 1, "mesh: the two admitted requests are the same audio")
    print(f"mesh: f32 dp 2 x tp 2 over [{dev}] x 4, B 4, two admitted requests (slots 0 and 2: "
          f"synthetic voices, other texts), 2 chunks [{smi}]: lanes within {lanes} int16 LSB "
          f"(bound {MESH_LSB}) of one device; the two requests {apart} LSB apart; launches "
          f"flow_blocks {launches['flow_blocks']} = frames x steps x dp, decode_attention "
          f"{launches['decode_attention']} = frames x {layers} x dp x tp")
    out["dp2tp2"] = {"lanes_lsb": lanes, "requests_apart_lsb": apart, "launches": launches}
    del ve, voices
    torch.cuda.empty_cache()
    return out


def _mesh_qcount(view: dict, steps: int, rows: int, frames: int, chunks: int,
                 bucket: int) -> int:
    """qlinear launches the shape rule predicts for one dp group (``rows``
    lanes) over a prefill of ``bucket`` tokens and ``chunks`` chunks of
    MESH_FRAMES frames: each rank launches its shard of a split product."""
    from pocket_tts_tpu_torch.kernels import qlinear as ql
    from pocket_tts_tpu_torch.ops.qtensor import QTensor
    from pocket_tts_tpu_torch.parallel.mesh import Shards

    def count(leaf, stacked: bool) -> int:
        parts = leaf.parts if isinstance(leaf, Shards) else [leaf]
        if not isinstance(parts[0], QTensor):
            return 0
        return len(parts) * (parts[0].q.shape[0] if stacked else 1)

    fl, dec = view["flow_lm"], view["mimi"]["dec_tf"]
    backbone = sum(count(v, True) for v in fl["tf"].values())
    frame = backbone + count(fl["input_w"], False) + count(fl["flow"]["cond_w"], False)
    flow = sum(count(fl["flow"][k], False) for k in ("in_w", "final_ada_w", "final_w"))
    codec = sum(count(v, True) for v in dec["layers"].values()) + sum(
        count(v, False) for k, v in dec.items() if k != "layers")
    n = backbone if rows * bucket <= ql.MAX_ROWS else 0
    n += frames * (frame + steps * flow) if rows <= ql.MAX_ROWS else 0
    return n + (chunks * codec if 16 * MESH_FRAMES * rows <= ql.MAX_ROWS else 0)


def _mesh_kernels(eng_q8, eng_bf16, st_bf16, dev, smi: str) -> dict:
    """(c) the kernels at the shard shapes the tp 2 engines give them, against
    their plain versions: qlinear on the int8 engine's own shards (and int4
    at the same shapes), decode attention on the bf16 engine's cache shards
    (8 of 16 heads each)."""
    from pocket_tts_tpu_torch.kernels import decode_attention as da
    from pocket_tts_tpu_torch.kernels import qlinear as ql
    from pocket_tts_tpu_torch.parallel.mesh import gather

    g = torch.Generator().manual_seed(13)
    tf = eng_q8._views[0]["flow_lm"]["tf"]
    worst, shapes = 0.0, []
    for name in ("in_proj", "ff1", "ff2"):
        for r, part in enumerate(tf[name].parts):
            w = part[0]  # layer 0 of rank r's shard
            n, k = ql.as_matrix(w).shape
            cases = [(w, 8)] + [(_qlinear_case(g, 1, n, k, 4, torch.bfloat16, dev)[1], 4)]
            for wq, bits in cases:
                for m in (1, 4):
                    x = torch.randn(m, k, generator=g).to(dev, torch.bfloat16)
                    got, ref = ql.qlinear(x, wq), ql.qlinear_reference(x, wq)
                    tol = _qlinear_tol(torch.bfloat16, ref)
                    err = (got.float() - ref.float()).abs().max().item()
                    _require(err <= tol, f"mesh: qlinear {name} rank {r} int{bits} M={m} "
                                         f"{n}x{k}: err {err} > {tol}")
                    worst = max(worst, err / tol)
            shapes.append(f"{name} {n}x{k}")
    pos = gather(st_bf16["pos"], dev)
    d_worst = 0.0
    for r, (kc, vc) in enumerate(zip(st_bf16["kc"].blocks[0], st_bf16["vc"].blocks[0])):
        b, _, h, d = kc[0].shape
        q = torch.randn(b, 1, h, d, generator=g).to(dev, torch.bfloat16)
        got = da.decode_attention(q, kc[0], vc[0], pos)
        ref = da.decode_attention_reference(q, kc[0], vc[0], pos)
        bound = da.error_bound(q, kc[0], vc[0], pos, ref)
        over = ((got.float() - ref.float()).abs() / bound).max().item()
        _require(over <= 1.0, f"mesh: decode_attention rank {r} H={h}: err / bound {over}")
        d_worst = max(d_worst, over)
    print(f"mesh: kernels at the tp 2 shard shapes [{smi}]: qlinear (bf16 x, the int8 engine's "
          f"own shards and int4 at their shapes, M 1 / 4) {', '.join(sorted(set(shapes)))}: "
          f"worst err / tol {worst:.3f}; decode_attention on each rank's cache shard (H 8, "
          f"pos {int(pos[0])}): worst err / bound {d_worst:.3f}")
    return {"qlinear_worst_err_over_tol": worst, "decode_attention_worst_err_over_bound": d_worst}


def _mesh_narrow(model, dev, smi: str) -> dict:
    """(c) bf16 and int8 engines at tp 2 (B = 1, the single stream's shape):
    the kernels at their shard shapes, the counted run of the mesh path,
    two runs bit for bit, the gap to one device, ms per frame against one
    device in turns."""
    from pocket_tts_tpu_torch.kernels import decode_attention as da
    from pocket_tts_tpu_torch.kernels import flow_blocks as fb
    from pocket_tts_tpu_torch.kernels import qlinear as ql
    from pocket_tts_tpu_torch.parallel import mesh as pm
    from pocket_tts_tpu_torch.runtime.engine import Engine, GenParams, _bucket
    from pocket_tts_tpu_torch.runtime.quantize import quantize_params

    cfg = model.config
    tokens, n = _mesh_tokens(model, MESH_TEXT, 1)
    bucket = _bucket(tokens.shape[1], cfg.runtime.text_buckets)
    mesh = pm.make_mesh(2, devices=[dev] * 2)
    qparams = quantize_params(model.params, 8)
    engines = {"bf16": (Engine(cfg, model.params, dev), Engine(cfg, model.params, mesh=mesh)),
               "int8": (Engine(cfg, qparams, dev), Engine(cfg, qparams, mesh=mesh))}
    runs = {kind: [_mesh_decode(e, tokens, n, 2, 14) for e in pair]
            for kind, pair in engines.items()}
    out = {"kernels": _mesh_kernels(engines["int8"][1], engines["bf16"][1],
                                    runs["bf16"][1][2], dev, smi)}

    # the counted run of the mesh path: the int8 engine at tp 2
    eng = engines["int8"][1]
    chunks, frames = 2, 2 * MESH_FRAMES
    fb.flow_blocks.launches = 0
    _attn_reset()
    ql.qlinear.launches = 0
    torch.cuda.synchronize()
    again = _mesh_decode(eng, tokens, n, chunks, 14)
    torch.cuda.synchronize()
    launches = {"flow_blocks": fb.flow_blocks.launches,
                "decode_attention": da.decode_attention.launches,
                "qlinear": ql.qlinear.launches}
    dp, tp = mesh.shape["dp"], mesh.shape["tp"]
    layers, steps = cfg.flow_lm.transformer.num_layers, GenParams().lsd_decode_steps
    want = {"flow_blocks": frames * steps * dp, "decode_attention": frames * layers * dp * tp,
            "qlinear": _mesh_qcount(eng._views[0], steps, 1, frames, chunks, bucket)}
    _require(launches == want, f"mesh: launches {launches}, the rules give {want}")
    _require(np.array_equal(again[0], runs["int8"][1][0]), "mesh: int8 tp 2 runs differ")
    print(f"mesh: counted run, int8 engine at tp 2 (B 1, {frames} frames) [{smi}]: "
          f"flow_blocks {launches['flow_blocks']} = frames x steps x dp; decode_attention "
          f"{launches['decode_attention']} = frames x {layers} x dp x tp (large_t "
          f"{da.decode_attention.large_t}); qlinear {launches['qlinear']} = the shape rule's "
          f"(each rank its shards)")
    out["launches"] = launches

    for kind, (one, sharded) in engines.items():
        b = _mesh_decode(sharded, tokens, n, 2, 14)
        _require(np.array_equal(b[0], runs[kind][1][0]), f"mesh: {kind} tp 2 runs differ")
        lsb, dl = _mesh_gap(runs[kind][1][0], runs[kind][0][0], runs[kind][1][1],
                            runs[kind][0][1])
        times = {"one": [], "tp2": []}
        for which in ("one", "tp2", "tp2", "one"):
            e = one if which == "one" else sharded
            st = e.prefill_tokens(e.new_state(), tokens, n)
            _, ms = _timed(lambda: _mesh_decode(e, None, 0, 2, 15, state=st))
            times[which].append(ms / frames)
        print(f"mesh: {kind} tp 2 vs one device, B 1, 2 chunks of {MESH_FRAMES} frames "
              f"[{smi}]: two runs bit-identical; gap to one device (partial sums added in "
              f"f32) {lsb} int16 LSB, latents max |diff| {dl:.3e}; ms per frame "
              f"one device {times['one'][0]:.3f} / {times['one'][1]:.3f}, tp 2 "
              f"{times['tp2'][0]:.3f} / {times['tp2'][1]:.3f} (in turns)")
        out[kind] = {"gap": {"lsb": lsb, "latent": dl}, "ms_per_frame": times}
    del engines, runs, qparams
    torch.cuda.empty_cache()
    return out


def _staged_streams(m, where: str) -> tuple[dict, str, dict]:
    """One profiled short ``generate`` of a staged model: (kernel names by
    stream, the one stream of the frames' kernels, the codec's streams and
    their kernels); fails unless the codec's kernels ran apart."""
    by_stream = _stream_kernels(lambda: m.generate(NARROW_TEXT))
    ar = {s for s, names in by_stream.items()
          if any("flow_chain" in x or "decode_attention" in x for x in names)}
    codec = {s: names for s, names in by_stream.items() if s not in ar}
    _require(len(ar) == 1 and codec, f"{where}: frame kernels on streams {ar}, others on "
                                     f"{sorted(codec)}")
    return by_stream, ar.pop(), codec


def _stream_kernels(run) -> dict:
    """Kernel names by CUDA stream over one torch.profiler window of run()."""
    trace = Path(tempfile.mkdtemp()) / "trace.json"
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        run()
        torch.cuda.synchronize()
    prof.export_chrome_trace(str(trace))
    by_stream: dict = {}
    for e in json.loads(trace.read_text())["traceEvents"]:
        if e.get("cat") == "kernel":
            sid = e.get("args", {}).get("stream", e.get("tid"))
            by_stream.setdefault(sid, []).append(_kernel_name(e["name"]))
    trace.unlink()
    return by_stream


def _mesh_staged(model, dev, smi: str) -> dict:
    """(d) the codec staged on a CUDA stream of its own on this card, chunk
    schedule: generate and generate_stream bit for bit the unstaged model's,
    generate within 1 LSB of the default fused segment; a profile window
    with the codec's kernels on a stream of their own; x-realtime in turns."""
    from pocket_tts_tpu_torch import TTSModel

    gen = dataclasses.replace(model.gen, temp=0.7, eos_threshold=SEGMENT_UNREACHABLE)
    chunked = dataclasses.replace(model.config, runtime=dataclasses.replace(
        model.config.runtime, segment_dispatch="chunked"))

    def make(cfg):
        return TTSModel(cfg, model.params, gen=gen, has_real_weights=False, device=dev)

    plain, staged, fused = make(chunked), make(chunked), make(model.config)
    staged.engine.enable_staged_codec(dev)
    a, b, c = (m.generate(STAGED_TEXT) for m in (plain, staged, fused))
    _require(a.size > 0 and np.array_equal(a, b), "mesh: staged generate differs from unstaged")
    lsb = int(np.abs(_pcm(b) - _pcm(c)).max()) if b.shape == c.shape else None
    _require(lsb is not None and lsb <= 1, f"mesh: staged vs fused generate: {lsb} LSB")
    s1, s2 = (np.concatenate(list(m.generate_stream(STAGED_TEXT))) for m in (plain, staged))
    _require(np.array_equal(s1, s2), "mesh: staged generate_stream differs from unstaged")
    by_stream, ar, codec = _staged_streams(staged, "mesh: staged profile")
    top = collections.Counter(x for names in codec.values() for x in names).most_common(3)
    print(f"mesh: staged codec on one card [{smi}]: generate and generate_stream bit-identical "
          f"to unstaged (chunk schedule); generate within {lsb} int16 LSB of the fused segment; "
          f"profile of a short generate: the frames' kernels on stream {ar} "
          f"({len(by_stream[ar])} launches), the codec's on stream(s) "
          f"{sorted(codec)} ({sum(len(v) for v in codec.values())} launches; top "
          f"{', '.join(f'{x} x{k}' for x, k in top)})")
    # the device's side of both: ms and launches per frame, busy share
    profiles = {which: _kernel_profile(lambda m=m: m.generate(STAGED_TEXT), m.engine,
                                       f"mesh (d) {which}", smi)
                for which, m in (("unstaged", plain), ("staged", staged))}
    xrt = {"unstaged": [], "staged": []}
    for which in ("unstaged", "staged", "staged", "unstaged"):
        m = plain if which == "unstaged" else staged
        audio, ms = _timed(lambda: m.generate(STAGED_TEXT))
        xrt[which].append(audio.size / model.sample_rate / (ms / 1e3))
    print(f"mesh: staged x-realtime {xrt['staged'][0]:.2f} / {xrt['staged'][1]:.2f}, unstaged "
          f"{xrt['unstaged'][0]:.2f} / {xrt['unstaged'][1]:.2f} (in turns, chunk schedule, "
          f"{a.size // model.frame_size} frames) [{smi}]")
    return {"staged_vs_fused_lsb": lsb, "x_realtime": xrt, "profiles": profiles,
            "codec_launches": sum(len(v) for v in codec.values())}


def phase_mesh(model, dev, smi: str) -> dict:
    """Phase 11: the dp x tp mesh and the staged codec on this card."""
    t0 = time.perf_counter()
    _mesh_layout(model, dev, smi)
    out = {"f32": _mesh_f32(model, dev, smi), "narrow": _mesh_narrow(model, dev, smi),
           "staged": _mesh_staged(model, dev, smi)}
    print(f"mesh: phase took {time.perf_counter() - t0:.1f} s")
    return out


# -- phase 12: training on the mesh; the bank and the staged codec on a mesh engine -----

# a sharded step against the one-device step (tests/test_training.py:338-345)
MESH_LOSS_RTOL = 2e-4
MESH_PARAM_TOL = (2e-4, 2e-3)  # atol, rtol: params after a step
MESH_NORM_RTOL = 1e-5  # grad_norm: each logical element counted once
MESH_TRAIN_STEPS = 4
MESH_BANK_LANES = ("one", "two", None, "one")


def _hand_launches() -> dict:
    from pocket_tts_tpu_torch.kernels import decode_attention as da
    from pocket_tts_tpu_torch.kernels import flow_blocks as fb
    from pocket_tts_tpu_torch.kernels import qlinear as ql

    return {"flow_blocks": fb.flow_blocks.launches, "qlinear": ql.qlinear.launches,
            "decode_attention": da.decode_attention.launches}


def _zero_launches() -> None:
    from pocket_tts_tpu_torch.kernels import flow_blocks as fb
    from pocket_tts_tpu_torch.kernels import qlinear as ql

    fb.flow_blocks.launches = ql.qlinear.launches = 0
    _attn_reset()


def _master_grads(params) -> dict:
    """path -> the whole (clipped) gradient of a leaf: a placed leaf's
    masters' gradients joined on tp."""
    from pocket_tts_tpu_torch.parallel.mesh import Trainable

    out = {}
    for path, leaf in _flat(params):
        if isinstance(leaf, Trainable):
            grads = [m.grad for m in leaf.blocks[0]]
            out[path] = (torch.cat(grads, dim=leaf.spec.index("tp")) if leaf.tp_split
                         else grads[0])
        else:
            out[path] = leaf.grad
    return out


def _mesh_train_step(model, dev, smi: str) -> dict:
    """(a) one dp 2 x tp 2 step, full and LoRA, on 4 pairs of unequal lengths
    against the one-device step, float32, the same draws."""
    from pocket_tts_tpu_torch import training
    from pocket_tts_tpu_torch.parallel import mesh as pm
    from pocket_tts_tpu_torch.training.loss import sample_draws
    from pocket_tts_tpu_torch.training.trainer import _map

    pairs = _train_pairs(model.sample_rate)[:4]
    batch = training.make_batch(model, pairs)
    b, tf, ldim = batch["latents"].shape
    draws = sample_draws(torch.Generator().manual_seed(5), b, tf, ldim, torch.device("cpu"))
    flow_lm = _map(model.params["flow_lm"],
                   lambda t: t.detach().to(dev, torch.float32, copy=True))
    mesh = pm.make_mesh(4, tp=2, devices=[dev] * 4)
    opt = training.make_optimizer(1e-4)
    out = {}
    for kind in ("full", "lora"):
        runs = []
        for placed in (False, True):
            mb = training.shard_batch(batch, mesh) if placed else batch
            if kind == "full":
                p = pm.shard_trainable(flow_lm, mesh) if placed else _map(flow_lm, torch.clone)
                p, _, m = training.make_train_step(model.config, opt)(p, opt.init(p), mb,
                                                                      draws=draws)
            else:
                base = pm.shard_params(flow_lm, mesh) if placed else flow_lm
                p = training.init_lora(flow_lm, 8, seed=0)
                p = pm.shard_trainable(p, mesh) if placed else p
                step = training.make_lora_train_step(model.config, opt, alpha=8.0, rank=8)
                p, _, m = step(p, opt.init(p), base, mb, draws=draws)
            grads = _master_grads(p)
            runs.append(({k: v.item() for k, v in m.items()},
                         {k: v.detach() for k, v in _flat(pm.gather(p, dev))}, grads))
        (m1, p1, g1), (m2, p2, g2) = runs
        loss_err = abs(m2["loss"] - m1["loss"]) / abs(m1["loss"])
        norm_err = abs(m2["grad_norm"] - m1["grad_norm"]) / m1["grad_norm"]
        metric_err = max(abs(m2[k] - v) / max(1.0, abs(v)) for k, v in m1.items())
        _require(sorted(g1) == sorted(g2) == sorted(p1) == sorted(p2),
                 f"mesh train {kind}: leaves differ")
        grad_err = max(float((g2[k] - g).abs().max()) / max(1.0, float(g.abs().max()))
                       for k, g in g1.items())
        atol, rtol = MESH_PARAM_TOL
        over = max(float(((p2[k] - v).abs() - (atol + rtol * v.abs())).max())
                   for k, v in p1.items())
        moved = kind == "lora" or any(not torch.equal(p1[k], v) for k, v in _flat(flow_lm))
        _require(loss_err <= MESH_LOSS_RTOL, f"mesh train {kind}: loss rel err {loss_err}")
        _require(norm_err <= MESH_NORM_RTOL, f"mesh train {kind}: grad_norm rel err {norm_err}")
        _require(grad_err <= GRAD_TOL, f"mesh train {kind}: gradient err {grad_err}")
        _require(over <= 0, f"mesh train {kind}: params after the step over the bound by {over}")
        _require(moved, "mesh train full: the step moved nothing")
        print(f"mesh train [{smi}]: one {kind} step at full width, f32 (TF32 off), B={b} "
              f"(4 pairs of 2.0-3.7 s, latent_valid {batch['latent_valid'].tolist()}), dp 2 x "
              f"tp 2 over [{dev}] x 4 vs one device, the same draws: loss rel err "
              f"{loss_err:.2e} (bound {MESH_LOSS_RTOL}), metrics max rel err {metric_err:.2e}, "
              f"grad_norm rel err {norm_err:.2e} (bound {MESH_NORM_RTOL}), {len(g1)} leaves' "
              f"clipped gradients err / max(1, max|g|) {grad_err:.2e} (bound {GRAD_TOL}), params "
              f"after the step within atol {atol} + rtol {rtol} (worst margin {over:.2e})")
        out[kind] = {"loss_rel_err": loss_err, "grad_norm_rel_err": norm_err,
                     "grad_err": grad_err, "metric_rel_err": metric_err}
    del flow_lm
    torch.cuda.empty_cache()
    return out


def _mesh_finetunes(model, dev, smi: str) -> dict:
    """(b) ``finetune(mesh=)`` against ``finetune()`` for MESH_TRAIN_STEPS
    steps, full and LoRA: the per-step losses, ms per step, peak GiB; the
    clone is a single-device model."""
    from pocket_tts_tpu_torch.parallel.mesh import make_mesh

    pairs = _train_pairs(model.sample_rate)[:4]
    mesh = make_mesh(4, tp=2, devices=[dev] * 4)
    out = {}
    for kind, kw in (("full", {}), ("lora", {"lora_rank": 8})):
        runs = {}
        for where, m in (("one", None), ("dp2tp2", mesh)):
            tuned, losses, ms, peak, added = _finetune_run(
                model, pairs, smi, steps=MESH_TRAIN_STEPS, where="mesh train", mesh=m, **kw)
            _require(tuned.engine.mesh is None and tuned.device == model.device,
                     f"mesh train {kind}: the clone is not a single-device model")
            runs[where] = {"losses": losses, "ms_per_step": ms, "peak_gib": peak,
                           "added_gib": added, "flow_lm": dict(_flat(tuned.params["flow_lm"]))}
            del tuned
        one, sh = runs["one"], runs["dp2tp2"]
        worst = max(abs(a - b) / abs(b) for a, b in zip(sh["losses"], one["losses"]))
        _require(worst <= MESH_LOSS_RTOL, f"mesh train {kind}: finetune losses {sh['losses']} "
                                          f"vs {one['losses']}")
        atol, rtol = MESH_PARAM_TOL
        diff = max(float((sh["flow_lm"][k] - v).abs().max()) for k, v in one["flow_lm"].items())
        outside = sum(int(((sh["flow_lm"][k] - v).abs() > atol + rtol * v.abs()).sum())
                      for k, v in one["flow_lm"].items())
        total = sum(v.numel() for v in one["flow_lm"].values())
        print(f"mesh train [{smi}]: finetune {kind} x {MESH_TRAIN_STEPS} steps, dp 2 x tp 2 vs "
              f"one device: losses max rel err {worst:.2e} (bound {MESH_LOSS_RTOL}); ms per step "
              f"{sh['ms_per_step']:.1f} vs {one['ms_per_step']:.1f}; peak {sh['peak_gib']:.2f} "
              f"vs {one['peak_gib']:.2f} GiB ({sh['added_gib']:.2f} vs {one['added_gib']:.2f} "
              f"above what was held before); tuned FlowLM max |diff| {diff:.3e}, {outside} of "
              f"{total} elements past atol {atol} + rtol {rtol} (Adam's first steps divide "
              f"each gradient by its own size)")
        out[kind] = {"loss_rel_err": worst, "tuned_max_diff": diff, "tuned_outside": outside,
                     **{f"{k}_{w}": runs[w][k] for w in runs
                        for k in ("ms_per_step", "peak_gib", "added_gib")}}
    torch.cuda.empty_cache()
    return out


def _mesh_bank(model, dev, paths: dict, smi: str) -> dict:
    """(d) the bank on an int8 tp 2 engine (float32 compute), B = 4: four
    lanes (adapters one / two / base / one) admitted with their rows, 2
    chunks at temp 0.5, against the one-device bank engine; the counted run
    of the mesh path."""
    from pocket_tts_tpu_torch.kernels.qlinear import MAX_ROWS
    from pocket_tts_tpu_torch.parallel import mesh as pm
    from pocket_tts_tpu_torch.runtime.engine import Engine, GenParams, _bucket
    from pocket_tts_tpu_torch.runtime.quantize import quantize_params
    from pocket_tts_tpu_torch.training.lora import build_adapter_bank

    cfg = dataclasses.replace(model.config, runtime=dataclasses.replace(
        model.config.runtime, compute_dtype="float32"))
    qparams = quantize_params(model.params, 8)
    bank = build_adapter_bank({k: str(v) for k, v in paths.items()})
    rows = np.stack([bank.row(n) for n in MESH_BANK_LANES])
    texts = [_mesh_tokens(model, t, 1) for t in ADAPTER_TEXTS + (MESH_TEXTS[0],)]
    mesh = pm.make_mesh(2, devices=[dev] * 2)

    def run(eng):
        eng.set_adapter_bank(bank)
        empty = {k: v for k, v in Engine(cfg, qparams, dev).new_state(1).items()
                 if k in ("kc", "vc", "pos")}
        st = eng.new_state()
        for i, (tok, n) in enumerate(texts):
            st = eng.admit_prefill_slot(st, i, empty, eng.pad_token_row(tok), n,
                                        lora_row=rows[i])
        gen, pcm = torch.Generator(device=dev).manual_seed(16), []
        for _ in range(2):
            st, audio, _ = eng.decode_frames(st, MESH_FRAMES, GenParams(
                temp=0.5, eos_threshold=float("inf")), gen, lora_w=rows)
            pcm.append(audio.cpu().numpy().astype(np.int64))
        return np.concatenate(pcm, 1), pm.gather(st["latent"], "cpu").float().numpy()

    ref = run(Engine(cfg, qparams, dev, batch_size=4))
    eng = Engine(cfg, qparams, batch_size=4, mesh=mesh)
    torch.cuda.synchronize()
    _zero_launches()
    got = run(eng)
    torch.cuda.synchronize()
    launches = _hand_launches()
    dp, tp, frames = mesh.shape["dp"], mesh.shape["tp"], 2 * MESH_FRAMES
    layers, steps = cfg.flow_lm.transformer.num_layers, GenParams().lsd_decode_steps
    view = eng._views[0]
    backbone = _mesh_qcount(view, 0, 1, 0, 0, 1)  # one prefill's backbone products
    admit = sum(backbone for tok, _ in texts
                if _bucket(tok.shape[1], cfg.runtime.text_buckets) <= MAX_ROWS)
    want = {"flow_blocks": frames * steps * dp, "decode_attention": frames * layers * dp * tp,
            "qlinear": admit + _mesh_qcount(view, steps, 4 // dp, frames, 2,
                                            MAX_ROWS + 1)}
    _require(launches == want, f"mesh bank: launches {launches}, the rules give {want}")
    lanes = [_mesh_gap(got[0][i], ref[0][i], got[1][i], ref[1][i]) for i in range(4)]
    atol, rtol = MESH_LATENT_TOL
    _require(max(lsb for lsb, _ in lanes) <= MESH_LSB, f"mesh bank: lanes {lanes} LSB")
    _require(bool(np.all(np.abs(got[1] - ref[1]) <= atol + rtol * np.abs(ref[1]))),
             f"mesh bank: latents {[dl for _, dl in lanes]}")
    apart = int(np.abs(ref[0][0] - ref[0][2]).max())
    _require(apart > 1, "mesh bank: adapter one and the base give the same audio")
    print(f"mesh bank [{smi}]: int8 engine (f32 compute) at tp 2 over [{dev}] x 2, B 4 (one / two "
          f"/ base / one), admitted with their rows, 2 chunks of {MESH_FRAMES} frames at temp 0.5 "
          f"vs the one-device bank: lanes within {[lsb for lsb, _ in lanes]} int16 LSB (bound "
          f"{MESH_LSB}), latents max |diff| {max(dl for _, dl in lanes):.3e} (atol {atol}, rtol "
          f"{rtol}); adapter one {apart} LSB from the base; launches flow_blocks "
          f"{launches['flow_blocks']} = frames x steps x dp, decode_attention "
          f"{launches['decode_attention']} = frames x {layers} x dp x tp, qlinear "
          f"{launches['qlinear']} = the shape rule's (each rank its shards)")
    del eng, qparams
    torch.cuda.empty_cache()
    return {"launches": launches, "lanes": lanes, "apart_lsb": apart}


def _mesh_train_staged(model, dev, smi: str) -> dict:
    """(e) the codec staged on a stream of its own on a tp 2 engine, B = 1:
    generate bit for bit the unstaged tp 2 engine's chunk schedule; the
    codec's kernels on a stream of their own."""
    from pocket_tts_tpu_torch import TTSModel
    from pocket_tts_tpu_torch.parallel.mesh import make_mesh
    from pocket_tts_tpu_torch.runtime.engine import Engine

    gen = dataclasses.replace(model.gen, temp=0.7, eos_threshold=SEGMENT_UNREACHABLE)
    cfg = dataclasses.replace(model.config, runtime=dataclasses.replace(
        model.config.runtime, segment_dispatch="chunked"))
    mesh = make_mesh(2, devices=[dev] * 2)
    models = []
    for staged in (False, True):
        m = TTSModel(cfg, model.params, gen=gen, has_real_weights=False, device=dev)
        m.engine = Engine(cfg, model.params, mesh=mesh)
        if staged:
            m.engine.enable_staged_codec(dev)
        models.append(m)
    plain, staged = models
    a, b = plain.generate(STAGED_TEXT), staged.generate(STAGED_TEXT)
    _require(a.size > 0 and np.array_equal(a, b), "mesh staged: tp 2 staged generate differs "
                                                  "from unstaged")
    _, ar, codec = _staged_streams(staged, "mesh staged")
    n_codec = sum(len(v) for v in codec.values())
    print(f"mesh staged [{smi}]: tp 2 engine over [{dev}] x 2, B 1, the codec staged on a "
          f"stream of its own: generate ({a.size // model.frame_size} frames, chunk schedule) "
          f"bit for bit the unstaged tp 2 engine's; profile of a short generate: the frames' "
          f"kernels on stream {ar}, the codec's {n_codec} on {sorted(codec)}")
    del models, plain, staged
    torch.cuda.empty_cache()
    return {"codec_launches": n_codec}


def phase_mesh_train(model, dev, smi: str) -> dict:
    """Phase 12: training on the mesh, then the bank and the staged codec on
    mesh engines, on this card."""
    t0 = time.perf_counter()
    tmp_dir = tempfile.TemporaryDirectory()
    torch.cuda.synchronize()
    _zero_launches()
    out = {"step": _mesh_train_step(model, dev, smi), "finetune": _mesh_finetunes(model, dev, smi)}
    torch.cuda.synchronize()
    launches = _hand_launches()
    _require(not any(launches.values()), f"mesh train: hand kernels launched {launches}")
    print(f"mesh train: (a) and (b) launched no hand kernel ({launches}): the loss runs the "
          f"plain flow chain under autograd, teacher forcing T > 1, float weights")
    out["bank"] = _mesh_bank(model, dev, _random_adapters(model, Path(tmp_dir.name)), smi)
    out["staged"] = _mesh_train_staged(model, dev, smi)
    tmp_dir.cleanup()
    print(f"mesh train: phase took {time.perf_counter() - t0:.1f} s")
    return out


# -- phase 13: the installed port ------------------------------------------------------

# what `pip wheel` of a checkout reads: the packaging files, the native audio
# source that setup.py compiles, and the two packages
WHEEL_SOURCES = ("pyproject.toml", "setup.py", "README.md", "native", "pocket_tts_tpu",
                 "pocket_tts_tpu_torch")


def copy_wheel_sources(dst: Path) -> None:
    """WHEEL_SOURCES of this checkout copied into ``dst``, without bytecode or
    build outputs, for ``pip wheel`` to build from (it writes ``build/`` and an
    egg-info into the tree it reads).  tests/test_torch_install.py builds its
    wheel from the same copy."""
    import shutil

    root = Path(__file__).resolve().parent
    skip = shutil.ignore_patterns("__pycache__", "*.pyc", "*.so", "build", "*.egg-info")
    dst.mkdir(parents=True)
    for name in WHEEL_SOURCES:
        if (root / name).is_dir():
            shutil.copytree(root / name, dst / name, ignore=skip)
        else:
            shutil.copy2(root / name, dst / name)


# Run in a fresh interpreter at the temporary directory, with the install as
# the whole PYTHONPATH; argv: site, the expected kernel build directory, the
# checkout, the output directory, TEXT, NARROW_TEXT.  Builds the three
# libraries from the install's csrc/ (timed), then runs the main path at
# temp 0 and an int8 generate under the launch counters.  The last line is
# JSON.
_INSTALLED = r"""
import dataclasses, json, sys, time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
site, build_dir, root, out_dir = (Path(p) for p in sys.argv[1:5])
text, narrow_text = sys.argv[5:7]
assert root not in {Path(p or ".").resolve() for p in sys.path}, sys.path
import numpy as np
import torch
import pocket_tts_tpu_torch as port
from pocket_tts_tpu_torch.kernels import build, decode_attention as da, flow_blocks as fb
from pocket_tts_tpu_torch.kernels import qlinear as ql
from pocket_tts_tpu_torch.runtime.quantize import quantize_model
assert Path(port.__file__).is_relative_to(site), port.__file__
assert build.BUILD_DIR == build_dir, (build.BUILD_DIR, build_dir)
mods = {"flow_blocks": fb, "qlinear": ql, "decode_attention": da}
assert all(m.SOURCE.is_file() and m.SOURCE.is_relative_to(site) for m in mods.values())
t0 = time.perf_counter()
with ThreadPoolExecutor(3) as pool:
    libs = dict(zip(mods, pool.map(lambda m: str(m.build()), mods.values())))
out = {"file": port.__file__, "build_s": time.perf_counter() - t0, "libs": libs}
torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False  # as phase 1
model = port.TTSModel.load(eos_threshold=float("inf"), device="cuda")
model.gen = dataclasses.replace(model.gen, temp=0.0)


def counted(m, text, stem):
    fb.flow_blocks.launches = ql.qlinear.launches = da.decode_attention.launches = 0
    m.engine.frames_decoded = 0
    torch.cuda.synchronize()
    wav = m.generate(text)
    torch.cuda.synchronize()
    np.save(out_dir / f"{stem}.npy", wav)
    return {"frames": m.engine.frames_decoded, "flow_blocks": fb.flow_blocks.launches,
            "qlinear": ql.qlinear.launches, "decode_attention": da.decode_attention.launches,
            "lsd": m.gen.lsd_decode_steps, "layers": m.config.flow_lm.transformer.num_layers}


out["main"] = counted(model, text, "installed")
out["int8"] = counted(quantize_model(model, bits=8), narrow_text, "installed_int8")
out["foreign"] = sorted(m for m in sys.modules
                        if m.split(".")[0] in ("jax", "jaxlib", "pocket_tts_tpu"))
print(json.dumps(out))
"""


def _site_files(site: Path) -> dict:
    return {p.relative_to(site).as_posix(): (p.stat().st_size, p.stat().st_mtime_ns)
            for p in site.rglob("*") if p.is_file()}


def _install(tmp: Path) -> Path:
    """The port's wheel built from a copy of this checkout and installed into
    tmp/site with ``pip install --target``; returns the installed command."""
    copy_wheel_sources(tmp / "src")
    pip = [sys.executable, "-m", "pip", "--disable-pip-version-check", "--no-cache-dir"]
    t0 = time.perf_counter()
    res = subprocess.run([*pip, "wheel", str(tmp / "src"), "--no-deps", "--no-build-isolation",
                          "--no-index", "-w", str(tmp / "dist")], cwd=tmp, capture_output=True,
                         text=True, timeout=600)
    _require(res.returncode == 0, f"installed: pip wheel exit {res.returncode}\n"
                                  f"{res.stdout[-2000:]}\n{res.stderr[-3000:]}")
    (wheel,) = (tmp / "dist").glob("*.whl")
    print(f"installed: pip wheel {wheel.name} ({wheel.stat().st_size / 1e3:.1f} kB) in "
          f"{time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    res = subprocess.run([*pip, "install", "--no-deps", "--no-index", "--target",
                          str(tmp / "site"), str(wheel)], cwd=tmp, capture_output=True,
                         text=True, timeout=600)
    _require(res.returncode == 0, f"installed: pip install exit {res.returncode}\n"
                                  f"{res.stdout[-2000:]}\n{res.stderr[-3000:]}")
    script = tmp / "site" / "bin" / "pocket-tts-tpu-torch"
    _require(script.is_file(), "installed: pip install --target put no pocket-tts-tpu-torch "
                               "in site/bin")
    print(f"installed: pip install --target site in {time.perf_counter() - t0:.2f} s")
    return script


def phase_installed(model, ref: dict, smi: str) -> dict:
    """The port installed from its wheel into a temporary directory; from
    there, in fresh processes with the install as the whole PYTHONPATH, its
    kernels built into a fresh cache, phase 4's main path, an int8
    ``generate`` and the installed command, against this checkout's audio."""
    import os

    from pocket_tts_tpu_torch import audio as audio_io
    from pocket_tts_tpu_torch.runtime.quantize import quantize_model

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="installed_port_") as name:
        tmp = Path(name)
        site, build_dir = tmp / "site", tmp / "cache" / "pocket_tts_tpu_torch" / "kernels"
        script = _install(tmp)
        before = _site_files(site)
        env = {**{k: v for k, v in os.environ.items() if k != "PYTHONPATH"},
               "PYTHONPATH": str(site), "XDG_CACHE_HOME": str(tmp / "cache")}
        proc = subprocess.Popen([sys.executable, "-c", _INSTALLED, str(site), str(build_dir),
                                 str(Path(__file__).resolve().parent), str(tmp), TEXT,
                                 NARROW_TEXT], cwd=tmp, env=env, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
        saved = model.gen
        try:  # this checkout's audio while the install builds its kernels
            model.gen = ref["gen"]
            repeat = model.generate(TEXT)
            tree_int8 = quantize_model(model, bits=8).generate(NARROW_TEXT)
            out, err = proc.communicate(timeout=900)
        finally:
            model.gen = saved
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        torch.cuda.empty_cache()
        _require(proc.returncode == 0,
                 f"installed: exit {proc.returncode}\n{out[-2000:]}\n{err[-4000:]}")
        run = json.loads(out.strip().splitlines()[-1])
        for kernel, lib in run["libs"].items():
            _require(Path(lib).parent == build_dir, f"installed: {kernel} built at {lib}")
        print(f"installed: {smi}: {', '.join(Path(p).name for p in run['libs'].values())} "
              f"built from site/pocket_tts_tpu_torch/csrc into cache/pocket_tts_tpu_torch/"
              f"kernels in {run['build_s']:.2f} s (one nvcc per source, in parallel)")
        _require(not run["foreign"], f"installed: jax / the JAX package loaded: {run['foreign']}")
        for what, r in (("main", run["main"]), ("int8", run["int8"])):
            _require(r["frames"] > 0 and r["flow_blocks"] == r["frames"] * r["lsd"],
                     f"installed {what}: flow_blocks launches {r['flow_blocks']} != frames "
                     f"{r['frames']} x {r['lsd']}")
            _require(r["decode_attention"] == r["frames"] * r["layers"],
                     f"installed {what}: decode_attention launches {r['decode_attention']} != "
                     f"frames {r['frames']} x {r['layers']} layers")
        _require(run["int8"]["qlinear"] > 0, "installed int8: qlinear never launched")
        _require(run["main"]["qlinear"] == 0, "installed main path: qlinear launched on bf16")
        print(f"installed: {run['file']} (PYTHONPATH=site, cwd tmp, no jax / pocket_tts_tpu "
              f"module loaded); main path {run['main']['frames']} frames: flow_blocks "
              f"{run['main']['flow_blocks']}, decode_attention "
              f"{run['main']['decode_attention']}, qlinear 0; int8 {run['int8']['frames']} "
              f"frames: flow_blocks {run['int8']['flow_blocks']}, decode_attention "
              f"{run['int8']['decode_attention']}, qlinear {run['int8']['qlinear']}")
        cli = subprocess.run([str(script), "generate", "--temperature", "0", "--eos-threshold",
                              "inf", "--text", TEXT, "-o", str(tmp / "cli.wav"), "--quiet"],
                             cwd=tmp, env=env, capture_output=True, text=True, timeout=600)
        _require(cli.returncode == 0,
                 f"installed cli: exit {cli.returncode}\n{cli.stderr[-3000:]}")
        _require("device: cuda" in cli.stderr, "installed cli: no cuda device line")
        print(f"installed: site/bin/{script.name} generate --temperature 0 --eos-threshold inf: "
              f"exit 0")
        _require(_site_files(site) == before, "installed: files under site changed")
        cache = sorted(p.name for p in (tmp / "cache").rglob("*") if p.is_file())
        _require({n for n in cache if n.endswith(".so")}
                 == {Path(p).name for p in run["libs"].values()},
                 f"installed: the cache holds {cache}")
        print(f"installed: nothing written under site ({len(before)} files unchanged); "
              f"the cache holds {', '.join(cache)}")
        got = {"generate": (np.load(tmp / "installed.npy"), ref["audio"]),
               "int8 generate": (np.load(tmp / "installed_int8.npy"), tree_int8),
               "cli": (_wav_samples((tmp / "cli.wav").read_bytes()), ref["audio"])}

    def pcm(a: np.ndarray) -> np.ndarray:  # float audio as the CLI writes it; a WAV's as read
        if a.dtype == np.int16:
            return a.astype(np.int64)
        return np.frombuffer(audio_io.pcm_i16_le_bytes(a), "<i2").astype(np.int64)

    def gap(a, b) -> int:
        _require(a.shape == b.shape, f"installed: {a.shape} samples against {b.shape}")
        return int(np.abs(pcm(a) - pcm(b)).max()) if a.size else 0

    own = gap(ref["audio"], repeat)
    result = {"build_s": run["build_s"], "own_repeat_lsb": own,
              "launches": {k: run["main"][k] for k in ("flow_blocks", "decode_attention")}
              | {"qlinear": run["int8"]["qlinear"]}}
    # bit for bit: the float32 audio of the installed runs, the CLI's int16 WAV
    for what, (a, want) in got.items():
        lsb = gap(a, want)
        same = bool(np.array_equal(a, want)) if a.dtype == want.dtype else lsb == 0
        _require(lsb <= REF_TOL_LSB, f"installed {what}: {lsb} int16 LSB from this checkout's")
        result[what] = {"bit_equal": same, "max_lsb": lsb}
        print(f"installed: {what} from the install against this checkout's: "
              f"{'bit for bit' if same else f'max |diff| {lsb} int16 LSB'} (this checkout's "
              f"own repeat of phase 4's generate: {own} LSB; bound {REF_TOL_LSB})")
    print(f"installed: phase took {time.perf_counter() - t0:.1f} s")
    return result


def _qlinear_entry(narrow: dict, serve: dict, train: dict) -> dict:
    """The kernels line's qlinear entry: the main-path numbers at B = 1 on ff1
    (int8, 4096 x 1024, bf16 x), and every timed shape cold and warm."""
    times = narrow["times"]
    main = times["per_shape"][(8, 1, 4096, 1024)]
    shapes = {f"int{bits}_m{m}_{n}x{k}": {key: r[key] for key in (
        "kernel_cold_us", "kernel_warm_us", "bound_us", "share_cold", "plain_cold_us",
        "linear_cold_us", "linear_warm_us") + (("int8pack_cold_us", "int8pack_warm_us")
                                              if "int8pack_cold_us" in r else ())}
        for (bits, m, n, k), r in times["per_shape"].items()}
    shapes_f32 = {f"int{bits}_m{m}_{n}x{k}": {key: r[key] for key in (
        "kernel_cold_us", "kernel_warm_us", "bound_us", "bound_by", "share_cold",
        "plain_cold_us", "linear_f32_cold_us", "linear_f32_warm_us", "ms", "plain_ms",
        "library_ms")} for (bits, m, n, k), r in times["per_shape_f32"].items()}
    gen = narrow["generate"]
    return {
        "name": "qlinear", "route": "cuda", "source": "pocket_tts_tpu_torch/csrc/qlinear.cu",
        "replaces": "pocket_tts_tpu/ops/qtensor.py:61",
        "replaces_note": "QTensor.dequant, fused by XLA into the consuming matmul; "
                         "no Pallas kernel",
        "launches": gen["int8"]["qlinear_launches"],
        "launches_int4": gen["int4"]["qlinear_launches"],
        "launches_batch": narrow["batch"]["qlinear_launches"],
        "launches_fp8_voice": narrow["voice"]["qlinear_launches"],
        "launches_serve": serve["qlinear_launches"],
        "launches_train_generate": 0,  # the tuned bf16 model (checked in phase 10)
        "launches_adapters": 0,  # the bank on the bf16 model (checked in phase 10)
        "launches_adapters_quantized": train["bank_quantized"]["qlinear_launches"],
        "max_abs_err_over_tol": narrow["kernel"]["worst_err_over_tol"],
        "max_abs_err": narrow["kernel"]["max_abs_err"],
        "ms": main["ms"], "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_us"] / 1e3, "bound_by": main["bound_by"],
        "library_ms": main.get("library_ms"),
        "library_error": times["library_error"],
        "ms_per_frame": {k: v["ms_per_frame"] for k, v in gen.items()},
        "shapes": shapes,
        "shapes_f32": shapes_f32,
    }


def _decode_entry(dec: dict, attn: dict, profiles: dict, launches_segment: int) -> dict:
    """The kernels line's decode_attention entry: the main path's numbers at
    B = 1 on the bf16 cache at pos 511, every timed cell, the launches and
    large_t of every path, and the two profiles."""
    main = dec["cells"][(1, "bfloat16", 511)]
    keys = ("kernel_cold_us", "kernel_warm_us", "bound_us", "bound_by", "share_cold",
            "plain_cold_us", "plain_warm_us", "sdpa_cold_us", "sdpa_warm_us", "ms", "plain_ms",
            "library_ms")
    cells = {f"b{b}_{kv}_pos{p}": {key: r[key] for key in keys if key in r}
             for (b, kv, p), r in dec["cells"].items()}
    return {
        "name": "decode_attention", "route": "cuda",
        "source": "pocket_tts_tpu_torch/csrc/decode_attention.cu",
        "replaces": "pocket_tts_tpu/ops/attention.py:28",
        "replaces_note": "XLA's fusion of the K/V convert into the attention dot (_sdpa, "
                         "reached from causal_cache_attention at :82-100); no Pallas kernel",
        **{("launches" if path == "main" else f"launches_{path}"): a["launches"]
           for path, a in attn.items()},
        "launches_segment": launches_segment,
        "large_t": {path: a["large_t"] for path, a in attn.items()},
        "max_abs_err": dec["max_abs_err"], "max_abs_err_over_tol": dec["worst_err_over_tol"],
        "ms": main["ms"], "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_us"] / 1e3, "bound_by": main["bound_by"],
        "library_ms": main.get("library_ms"),
        "cells": cells,
        "plans": dec["plans"],
        "profiles": profiles,
    }


def main() -> None:
    kind, smi = phase_environment()
    phase_build()
    dev = torch.device("cuda")
    kern = phase_kernel(dev)
    dec = phase_decode_kernel(dev)
    model, launches, attn_main, profile_b1, ref = phase_main_path(smi)
    segment = phase_segment(model, smi)
    phase_reference()
    voice_launches, attn_voice = phase_voice(model)
    batch = phase_batch(model, smi)
    batch_launches = batch["flow_launches"]
    narrow, q8fp8 = phase_narrow(model, dev)
    serve = phase_serve(model, q8fp8, smi)
    train = phase_train(model, q8fp8, smi)
    mesh = phase_mesh(model, dev, smi)
    mesh_launches, mesh_dp2 = mesh["narrow"]["launches"], mesh["f32"]["dp2tp2"]["launches"]
    mesh_bank = phase_mesh_train(model, dev, smi)["bank"]["launches"]
    installed = phase_installed(model, ref, smi)["launches"]
    per_b = {key: {str(b): kern[b][key] for b in TIMED_BATCHES}
             for key in ("device_us_cold", "device_us_warm", "bound_us", "roofline_share",
                         "graph_plain_us", "graph_plain_us_warm")}
    print(json.dumps({"kernels": [{
        "name": "flow_blocks", "route": "cuda",
        "source": "pocket_tts_tpu_torch/csrc/flow_blocks.cu",
        "replaces": "pocket_tts_tpu/ops/pallas/flow_kernel.py:107",
        "launches": launches, "launches_segment": segment["flow"],
        "launches_voice": voice_launches,
        "launches_batch": batch_launches,
        "launches_serve": serve["flow_launches"],
        "launches_serve_quantized": serve["flow_launches_quantized"],
        "launches_train_generate": train["full"]["generate_launches"],
        "launches_adapters": train["bank"]["flow_launches"],
        "launches_adapters_quantized": train["bank_quantized"]["flow_launches"],
        "launches_mesh": mesh_launches["flow_blocks"],
        "launches_mesh_dp2": mesh_dp2["flow_blocks"],
        "launches_mesh_adapters": mesh_bank["flow_blocks"],
        "launches_installed": installed["flow_blocks"],
        "max_abs_err": kern["max_abs_err"],
        "ms": kern[1]["ms"], "plain_ms": kern[1]["plain_ms"],
        "bound_ms": kern[1]["bound_us"] / 1e3, "bound_by": kern[1]["bound_by"],
        "library_ms": None,
        "ms_b4": kern[4]["ms"], "plain_ms_b4": kern[4]["plain_ms"],
        "ms_b16": kern[16]["ms"], "plain_ms_b16": kern[16]["plain_ms"],
        **per_b,
    }, {**_qlinear_entry(narrow, serve, train), "launches_mesh": mesh_launches["qlinear"],
        "launches_mesh_adapters": mesh_bank["qlinear"],
        "launches_installed": installed["qlinear"]},
        {**_decode_entry(dec, {
        "main": attn_main, "voice": attn_voice, "batch": batch["attn"],
        "narrow": narrow["generate"]["int8+fp8"]["attn"], "fp8_voice": narrow["voice"]["attn"],
        "narrow_batch": narrow["batch"]["attn"], "serve": serve["attn"],
        "train_generate": train["full"]["attn"]},
        {"b1": profile_b1, "b16": batch["profile"]}, segment["attn"]),
         "launches_mesh": mesh_launches["decode_attention"],
         "launches_mesh_dp2": mesh_dp2["decode_attention"],
         "launches_mesh_adapters": mesh_bank["decode_attention"],
         "launches_installed": installed["decode_attention"]}]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
