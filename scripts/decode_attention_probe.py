"""Where the time goes inside ``decode_attention`` on the card.

    python scripts/decode_attention_probe.py

needs an NVIDIA H100 and nvcc.  It builds ``csrc/decode_attention.cu`` with
``DA_PROBE`` defined, so that thread 0 of each CTA writes ``clock64()`` at
each of the kernel's ``DA_MARK`` phase boundaries into a device array (and
``%globaltimer`` at entry), launches that library directly (the shipped one
and the launch counters are untouched) at S = 1024, H = 16, D = 64, bf16 q
and cache, every lane at one pos, after a few warm-up calls, and prints per
phase the median and largest SM cycles over the CTAs with keys, each CTA's
cycles from entry to exit and the spread of the CTAs' start times.  The
marks are in the cluster kernel: B = 16 runs in the clusters of 8 that B
= 1 uses.
Each output is checked against the plain version.
"""

from __future__ import annotations

import ctypes
import hashlib
import statistics
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from pocket_tts_tpu_torch.kernels import build as build_mod  # noqa: E402
from pocket_tts_tpu_torch.kernels import decode_attention as da  # noqa: E402

MAX_CTAS = 8192  # kProbeCtas
SLOTS = 12  # clock64 at marks 0 .. 10, then %globaltimer at entry
# the phase that ends at mark k (k = 1 .. 10); mark 0 is the kernel's entry
PHASES = ("pos read, split", "copies issued", "K lands", "logits", "max exchanged",
          "sums exchanged, p", "V lands", "V rows pushed", "rows landed", "combine, exit")
# (B, pos, cluster: None for the plan's own); the marks are in the cluster
# kernel's path of two ranks or more (pos >= 128), so B = 16 runs in
# clusters of 8 (its plan, a CTA alone, has no phases to mark)
CASES = ((1, 255, None), (1, 767, None), (16, 255, 8), (16, 767, 8))


def probe_source(source: Path) -> str:
    """A translation unit that compiles ``source`` with its probe marks on;
    the source's hash in it renames the build when the kernel changes."""
    digest = hashlib.sha256(source.read_bytes()).hexdigest()[:16]
    return f'#define DA_PROBE 1\n// {digest}\n#include "{source.resolve()}"\n'


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("decode_attention_probe: needs an NVIDIA GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    build_mod.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    path = build_mod.BUILD_DIR / "decode_attention_probe.cu"
    path.write_text(probe_source(da.SOURCE))
    lib = da._bind(ctypes.CDLL(str(build_mod.build(path, "decode_attention_probe"))))
    lib.pt_probe_read.argtypes = [ctypes.c_void_p]
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    s, h, d = 1024, 16, 64
    print(f"decode_attention_probe [{smi}]: SM cycles per phase, thread 0 of each CTA")
    for b, p, cluster in CASES:
        q = torch.randn(b, 1, h, d, generator=g, device=dev).bfloat16()
        k, v = (torch.randn(b, s, h, d, generator=g, device=dev).bfloat16() for _ in range(2))
        pos = torch.full((b,), p, dtype=torch.int32, device=dev)
        plan = da.launch_plan(b, s, h, d, (q.dtype, k.dtype), cluster=cluster)
        for _ in range(5):
            out = da._launch(lib, q, k, v, pos, plan)
        torch.cuda.synchronize()
        buf = (ctypes.c_ulonglong * (MAX_CTAS * SLOTS))()
        if lib.pt_probe_read(ctypes.addressof(buf)) != 0:
            raise RuntimeError("decode_attention_probe: reading the records failed")
        ref = da.decode_attention_reference(q, k, v, pos)
        if not ((out.double() - ref.double()).abs() <= da.error_bound(q, k, v, pos, ref)).all():
            raise RuntimeError("decode_attention_probe: the instrumented kernel is wrong")
        rows = [buf[c * SLOTS:(c + 1) * SLOTS] for c in range(plan.grid)]
        rows = [r for r in rows if r[10]]  # the CTAs with keys
        starts = [r[SLOTS - 1] for r in rows]
        life = [r[10] - r[0] for r in rows]
        phases = "; ".join(f"{name} {statistics.median(r[i + 1] - r[i] for r in rows):.0f}/"
                           f"{max(r[i + 1] - r[i] for r in rows)}"
                           for i, name in enumerate(PHASES))
        print(f"B={b} pos {p} cluster {plan.cluster}: {len(rows)} of {plan.grid} CTAs with "
              f"keys, starts spread over {(max(starts) - min(starts)) / 1e3:.3f} us; entry to "
              f"exit median {statistics.median(life):.0f}, max {max(life)}; median/max per "
              f"phase: {phases}")


if __name__ == "__main__":
    main()
