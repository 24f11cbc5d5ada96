"""Decode attention variants timed in turns in one process, on the card.

    python scripts/decode_attention_ab.py [--baseline DIR] [--profile] [--out FILE]

needs an NVIDIA H100 and nvcc.  Every variant runs on the same inputs, q
[B, 1, 16, 64] bf16 against bf16 and e4m3fn caches [B, 1024, 16, 64], every
lane at one pos, at B 1 / 4 / 8 / 16 and pos 64 / 128 (the batcher's lanes) and
255 / 511 / 767:

* ``plan``: the kernel at its own launch_plan;
* ``c8`` or ``c1``: the other schedule (a cluster of one CTA a rank, or a
  CTA alone per (b, h)), and ``c1t1`` .. ``c1t3``: a CTA alone of 1 .. 3
  teams instead of 4; each must equal ``plan`` bit for bit;
* ``mk32``, ``mk64``: at least 32 / 64 keys a logical rank instead of 128;
* ``base``: with ``--baseline DIR``, the decode attention of another tree of
  this repo (for example an earlier commit unpacked by ``git archive``),
  built from its own source.

Each output is held against the plain version within ``error_bound``.  Cold
and warm device us come from chip_smoke.py's ``_kernel_turns`` (CUDA graphs
in turns, L2 flushed for cold).  ``--profile`` adds chip_smoke.py's B=1
profile window (a 64-frame ``generate``) and its B=16 window (16
one-sentence requests, batched_tts chunk 64), flagship widths, random
weights, each run four times, this kernel and the baseline's in turns
(this, base, base, this), and reports the decode attention kernels' device
ms per frame in each.  The numbers go to
stdout and, as JSON, to ``--out``.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from pocket_tts_tpu_torch.kernels import decode_attention as da  # noqa: E402

S, H, D = cs.DECODE_SHAPE
BATCHES = (1, 4, 8, 16)
POS = (64, 128, 255, 511, 767)
CACHES = (torch.bfloat16, torch.float8_e4m3fn)


def load_baseline(tree: Path):
    """The decode attention module of another tree, built from that tree's
    source (the build names a library by its source's hash)."""
    path = tree / "pocket_tts_tpu_torch" / "kernels" / "decode_attention.py"
    spec = importlib.util.spec_from_file_location("baseline_decode_attention", path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    mod.SOURCE = tree / "pocket_tts_tpu_torch" / "csrc" / "decode_attention.cu"
    return mod


def variants(b: int, kv) -> dict:
    """name -> plan of this kernel for one cell."""
    dtypes = (torch.bfloat16, kv)
    plan = da.launch_plan(b, S, H, D, dtypes)
    other = 1 if plan.cluster > 1 else plan.ranks
    out = {"plan": plan, f"c{other}": da.launch_plan(b, S, H, D, dtypes, cluster=other)}
    for t in range(1, min(plan.ranks, da.SOLO_TEAMS)):
        out[f"c1t{t}"] = da.launch_plan(b, S, H, D, dtypes, cluster=1, teams=t)
    for mk in (32, 64):
        out[f"mk{mk}"] = da.launch_plan(b, S, H, D, dtypes, min_keys=mk)
    return out


def time_cells(dev, base) -> dict:
    gd = torch.Generator(device=dev).manual_seed(0)
    flush_buf = torch.empty(cs.FLUSH_BYTES // 4, dtype=torch.float32, device=dev)

    def flush():
        flush_buf.fill_(1.0)

    cells = {}
    for b in BATCHES:
        for kv in CACHES:
            plans = variants(b, kv)
            for p in POS:
                q, k, v, pos = cs._decode_inputs(gd, b, torch.bfloat16, kv, (p,), dev)
                ref = da.decode_attention_reference(q, k, v, pos)
                bound = da.error_bound(q, k, v, pos, ref)
                lib = da._load()
                fns = {name: (lambda plan=plan: da._launch(lib, q, k, v, pos, plan))
                       for name, plan in plans.items()}
                if base is not None:
                    fns["base"] = lambda: base.decode_attention(q, k, v, pos)
                outs = {name: fn() for name, fn in fns.items()}
                torch.cuda.synchronize()
                for name, got in outs.items():
                    ok = bool(((got.double() - ref.double()).abs() <= bound).all())
                    if not ok:
                        raise RuntimeError(f"B={b} {kv} pos {p} {name}: outside error_bound")
                    if name.startswith("c") and not torch.equal(got, outs["plan"]):
                        raise RuntimeError(f"B={b} {kv} pos {p} {name}: not bit-identical "
                                           f"to the plan's schedule")
                # "kernel" first: _kernel_turns reads its share from it
                turns = {"kernel": fns.pop("plan"), **fns}
                nbytes, flops = cs._decode_cost(b, p, torch.bfloat16, kv)
                rec = cs._kernel_turns(turns, flush, nbytes, flops, cs.F32_FLOPS, False)
                cluster = plans["plan"].cluster
                line = "; ".join(
                    f"{'plan c' + str(cluster) if n == 'kernel' else n} "
                    f"{rec[n + '_cold_us']:.3f}/{rec[n + '_warm_us']:.3f}" for n in turns)
                print(f"B={b} cache {str(kv)[6:]} pos {p}: bound {rec['bound_us']:.3f} us; "
                      f"cold/warm us: {line}", flush=True)
                cells[f"B={b} {str(kv)[6:]} pos {p}"] = {**rec, "cluster": cluster}
    del flush_buf
    torch.cuda.empty_cache()
    return cells


def profile_windows(base, smi: str) -> list:
    """The B=1 and the B=16 profile windows of chip_smoke.py, each four
    times: this kernel, the baseline's, the baseline's, this kernel."""
    from pocket_tts_tpu_torch import TTSModel
    from pocket_tts_tpu_torch.ops import attention
    from pocket_tts_tpu_torch.runtime.batcher import batched_tts
    from pocket_tts_tpu_torch.runtime.engine import GenParams

    model = TTSModel.load(eos_threshold=float("inf"), device="cuda")
    model.gen = GenParams(temp=0.7, eos_threshold=float("inf"))
    ours = attention.decode_attention
    short = [cs.BATCH_SENTENCES[i % 8] for i in range(16)]
    out = []
    try:
        for name in ("this", "base", "base", "this"):
            attention.decode_attention = ours if name == "this" else base.decode_attention
            model.generate(cs.NARROW_TEXT)  # the variant's first launch outside the window
            prof = cs._kernel_profile(lambda: model.generate(cs.NARROW_TEXT), model.engine,
                                      f"B=1 window, {name} kernel", smi)
            out.append({"window": "B=1", "kernel": name, **prof})
        b = batched_tts(model, batch_size=16, chunk_frames=64)
        try:
            b.warmup()
            for name in ("this", "base", "base", "this"):
                attention.decode_attention = ours if name == "this" else base.decode_attention
                b.generate_batch(short[:2])
                prof = cs._kernel_profile(lambda: b.generate_batch(short), b.engine,
                                          f"B=16 window, {name} kernel", smi)
                out.append({"window": "B=16", "kernel": name, **prof})
        finally:
            b.stop()
    finally:
        attention.decode_attention = ours
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", type=Path, help="root of another tree of this repo")
    ap.add_argument("--profile", action="store_true", help="the B=16 profile windows")
    ap.add_argument("--out", type=Path, help="JSON of every number")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("decode_attention_ab: needs an NVIDIA GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    print(f"decode_attention_ab [{smi}]", flush=True)
    base = load_baseline(args.baseline.resolve()) if args.baseline else None
    result = {"card": smi, "cells": time_cells(torch.device("cuda"), base)}
    if args.profile:
        if base is None:
            raise SystemExit("decode_attention_ab: --profile needs --baseline")
        result["profiles"] = profile_windows(base, smi)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(result, indent=1, default=str))


if __name__ == "__main__":
    main()
