"""The gap of a bf16 tp mesh to one device, with the partial sums of the
row-parallel products added in float32 and in bfloat16, on the card.

    python scripts/mesh_accum_probe.py [--out FILE]

needs a CUDA card and nvcc.  The flagship variant at full width with random
weights (``TTSModel.load``, as chip_smoke.py), bf16 engines: one device,
and meshes of tp 2 and tp 4 over the one card repeated.  Each runs
chip_smoke.py phase 11's decode (prefill and 2 chunks of 8 frames at temp
0.5 from one seeded generator); for each mesh and each choice the script
prints the int16 LSB and latent max |diff| to one device, beside the card's
name and power limit.  Float32 is ``parallel.mesh.reduce_sum`` as it ships;
the bfloat16 choice is put in ``models.transformer``'s place of it for its
runs only.  Each run is repeated and must equal its first bit for bit.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from pocket_tts_tpu_torch import TTSModel  # noqa: E402
from pocket_tts_tpu_torch.models import transformer  # noqa: E402
from pocket_tts_tpu_torch.parallel.mesh import make_mesh, reduce_sum  # noqa: E402
from pocket_tts_tpu_torch.runtime.engine import Engine  # noqa: E402


def reduce_sum_own_dtype(parts: list, device: torch.device) -> torch.Tensor:
    """``reduce_sum`` with the partials added in their own dtype, in rank order."""
    out = parts[0].to(device, non_blocking=True)
    for p in parts[1:]:
        out = out + p.to(device, non_blocking=True)
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", help="also write the gaps as JSON here")
    args = ap.parse_args()
    _, smi = cs.phase_environment()
    cs.phase_build()
    dev = torch.device("cuda")
    model = TTSModel.load(eos_threshold=float("inf"), device="cuda")
    tokens, n = cs._mesh_tokens(model, cs.MESH_TEXT, 1)
    one = cs._mesh_decode(Engine(model.config, model.params, dev), tokens, n, 2, 14)
    gaps = {}
    for tp in (2, 4):
        eng = Engine(model.config, model.params, mesh=make_mesh(tp, tp=tp, devices=[dev] * tp))
        for name, fn in (("f32", reduce_sum), ("bf16", reduce_sum_own_dtype)):
            transformer.reduce_sum = fn
            try:
                runs = [cs._mesh_decode(eng, tokens, n, 2, 14) for _ in range(2)]
            finally:
                transformer.reduce_sum = reduce_sum
            cs._require(np.array_equal(runs[0][0], runs[1][0]), f"tp {tp} {name}: runs differ")
            lsb, dl = cs._mesh_gap(runs[0][0], one[0], runs[0][1], one[1])
            gaps[f"tp{tp}_{name}"] = {"lsb": lsb, "latent": dl}
            print(f"accum: bf16 tp {tp} over [{dev}] x {tp}, B 1, 2 chunks of "
                  f"{cs.MESH_FRAMES} frames, partial sums in {name} [{smi}]: {lsb} int16 LSB, "
                  f"latents max |diff| {dl:.3e} to one device (two runs bit-identical)")
        del eng
        torch.cuda.empty_cache()
    print(json.dumps({"smi": smi, "gaps": gaps}))
    if args.out:
        Path(args.out).write_text(json.dumps({"smi": smi, "gaps": gaps}, indent=1))


if __name__ == "__main__":
    main()
