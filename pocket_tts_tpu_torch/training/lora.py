"""LoRA adapters and the per-slot adapter bank (port of
``pocket_tts_tpu/training/lora.py``).

Low-Rank Adaptation (Hu et al., arXiv 2106.09685): a weight ``W [out, in]``
is served as ``W + (alpha / r) B @ A``, with ``A [r, in]`` drawn from
N(0, 1/r) and ``B [out, r]`` zero at init (an exact no-op).  Stacked layer
weights carry their leading axes as batch dims of the factors.  Only the
factors train; the artifact holds only them.

The :class:`AdapterBank` stacks N adapters for per-slot batched serving:
each batch lane mixes its adapter's delta into the backbone products
(``models.transformer._lora_pair``), so requests for different adapters
share one decode loop.  The artifacts are the JAX package's, read and written
by either package.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from pocket_tts_tpu_torch import weights as weights_mod
from pocket_tts_tpu_torch.ops.qtensor import QTensor, map_with_path
from pocket_tts_tpu_torch.parallel.mesh import Sharded, replicas
from pocket_tts_tpu_torch.runtime.quantize import _flatten_paths

# Backbone attention + FFN matrices: paths into params["flow_lm"], exact match
LORA_DEFAULT_TARGETS = ("tf/in_proj", "tf/out_proj", "tf/ff1", "tf/ff2")

LORA_FORMAT = "pocket-tts-tpu-lora"


def init_lora(params: dict, rank: int, *, targets: tuple[str, ...] = LORA_DEFAULT_TARGETS,
              seed: int = 0) -> dict:
    """Factor tree ``{path: {"a": [*lead, r, in], "b": [*lead, out, r]}}``
    over ``params`` (a FlowLM subtree), on the targets' device in float32.
    ``a`` comes from ``np.random.default_rng(seed)`` in target order, bit for
    bit the JAX package's; ``b`` is zero."""
    if rank < 1:
        raise ValueError(f"LoRA rank must be >= 1, got {rank}")
    available = dict(_flatten_paths(params))
    missing = [t for t in targets if t not in available]
    if missing:
        raise ValueError(f"LoRA targets not in params: {missing}; "
                         f"known paths include {sorted(available)[:8]}...")
    rng = np.random.default_rng(seed)
    lora: dict = {}
    for path in targets:
        w = available[path]
        if w.ndim < 2:
            raise ValueError(f"LoRA target {path} is not a matrix: {tuple(w.shape)}")
        *lead, out, inn = w.shape
        a = rng.normal(0.0, 1.0 / rank, size=(*lead, rank, inn))
        lora[path] = {"a": torch.tensor(a, dtype=torch.float32, device=w.device),
                      "b": torch.zeros((*lead, out, rank), dtype=torch.float32, device=w.device)}
    return lora


def lora_delta(factors: dict, scale: float) -> torch.Tensor:
    """``scale * B @ A`` with the leading layer axes as batch dims."""
    return scale * torch.einsum("...or,...ri->...oi", factors["b"].float(), factors["a"].float())


def _merge_placed(w: Sharded, factors: dict, scale: float) -> Sharded:
    """A base leaf placed on a mesh plus ``scale * B @ A``: each block adds
    its cut of the delta, computed from the factors' copies in its dp group
    (:func:`mesh.replicas`) moved to the block's device.  A block split on
    the output rows (column-parallel in_proj / ff1) takes its rows of B, one
    split on the input columns (row-parallel out_proj / ff2) its columns of
    A, one split on a leading axis its slice of both."""
    a_all, b_all = (replicas(factors[k]) for k in ("a", "b"))
    tp = w.mesh.shape["tp"]
    rows = []
    for g, blocks in enumerate(w.blocks):
        a_g, b_g = (f.group(g) if isinstance(f, Sharded) else f for f in (a_all, b_all))
        merged = []
        for r, blk in enumerate(blocks):
            a, b = a_g, b_g
            for d, axis in enumerate(w.spec):
                if axis != "tp" or tp == 1:
                    continue
                if d == len(w.spec) - 1:
                    a = a.chunk(tp, dim=-1)[r]
                elif d == len(w.spec) - 2:
                    b = b.chunk(tp, dim=-2)[r]
                else:
                    a, b = a.chunk(tp, dim=d)[r], b.chunk(tp, dim=d)[r]
            delta = lora_delta({"a": a.to(blk.device), "b": b.to(blk.device)}, scale)
            merged.append((blk.float() + delta).to(blk.dtype))
        rows.append(merged)
    return Sharded(w.spec, rows, w.mesh)


def merge_lora(params: dict, lora: dict, *, alpha: float, rank: int) -> dict:
    """Base + deltas in float32, cast back to each leaf's dtype; the tree has
    ``params``' structure and untargeted leaves are the same tensors.  A
    base placed on a mesh (``mesh.shard_params``; the factors placed by
    ``mesh.shard_trainable``, replicated) merges block by block
    (:func:`_merge_placed`).  A quantized (QTensor) target raises
    ValueError: merge into the float checkpoint, then quantize."""
    scale = alpha / rank
    flat = dict(_flatten_paths(params))
    for path in lora:
        if isinstance(flat.get(path), QTensor):
            raise ValueError(f"merge_lora: {path} is quantized; LoRA merges into a float "
                             "checkpoint (apply the adapter before quantizing)")
    merged = {path: _merge_placed(flat[path], f, scale) if isinstance(flat[path], Sharded)
              else (flat[path].float() + lora_delta(f, scale).to(flat[path].device)
                    ).to(flat[path].dtype) for path, f in lora.items()}
    # no recursive closure here: its reference cycle would hold each step's
    # merged copies (and their graphs) until the garbage collector runs
    return map_with_path(params, lambda path, leaf: merged.get(path, leaf))


def make_lora_train_step(cfg, optimizer, *, alpha: float, rank: int, eos_weight: float = 1.0,
                         consistency_weight: float = 0.0):
    """A LoRA update step ``train_step(lora, opt_state, base, batch,
    generator=None, *, draws=None) -> (lora, opt_state, metrics)``:
    gradients flow through the merge into the factors only, and the frozen
    ``base`` is never written.  ``opt_state`` is ``optimizer.init(lora)``.
    On a mesh ``base`` is placed by ``mesh.shard_params``, ``lora`` by
    ``mesh.shard_trainable`` (replicated: each factor's gradient reaches its
    one master) and the batch by ``trainer.shard_batch``."""
    from pocket_tts_tpu_torch.training.loss import flow_matching_loss
    from pocket_tts_tpu_torch.training.trainer import _update

    def train_step(lora: dict, opt_state, base: dict, batch: dict,
                   generator: torch.Generator | None = None, *, draws: dict | None = None):
        def loss_fn():
            return flow_matching_loss(merge_lora(base, lora, alpha=alpha, rank=rank), cfg,
                                      batch, generator, draws=draws, eos_weight=eos_weight,
                                      consistency_weight=consistency_weight)

        return lora, opt_state, _update(opt_state, loss_fn)

    return train_step


# -- adapter artifacts ----------------------------------------------------------


def save_lora_params(lora: dict, path, *, rank: int, alpha: float) -> None:
    """Write a factor tree as ``<target>/a`` and ``<target>/b`` float32
    tensors, with metadata ``format``, ``rank`` and ``alpha`` (``repr``)."""
    tensors = {}
    for tpath, f in lora.items():
        tensors[f"{tpath}/a"] = f["a"].detach().float().cpu().numpy()
        tensors[f"{tpath}/b"] = f["b"].detach().float().cpu().numpy()
    weights_mod.write_safetensors(tensors, path, metadata={
        "format": LORA_FORMAT, "rank": str(rank), "alpha": repr(float(alpha))})


def load_lora_params(path) -> tuple[dict, int, float]:
    """``(factor tree of CPU tensors, rank, alpha)`` from a saved adapter."""
    tensors, meta = weights_mod.read_safetensors(path, with_metadata=True)
    if meta.get("format") != LORA_FORMAT:
        raise ValueError(f"{path} is not a {LORA_FORMAT} adapter")
    rank, alpha = int(meta["rank"]), float(meta["alpha"])
    lora: dict = {}
    for k, arr in tensors.items():
        tpath, leaf = k.rsplit("/", 1)
        lora.setdefault(tpath, {})[leaf] = torch.from_numpy(np.asarray(arr, np.float32))
    for tpath, fac in lora.items():
        if set(fac) != {"a", "b"}:
            raise ValueError(f"{path}: target {tpath} missing a/b factors")
    return lora, rank, alpha


# -- the adapter bank -----------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class AdapterBank:
    """N LoRA adapters stacked for per-slot batched serving:
    ``stacks[target] = {"a": [L, N, (3,) r, in], "b": [L, N, (3,) out, r]}``
    (layer axis first, adapter axis second; float32 CPU tensors, placed on
    the device by ``Engine.set_adapter_bank``), ``scales[n] = alpha / rank``.
    Ranks are zero-padded to the largest; an adapter without a target holds
    zeros there.  Each lane selects its adapter with ``row(name)``."""

    names: tuple[str, ...]
    stacks: dict
    scales: np.ndarray

    # the only targets the batched delta path applies (transformer._qkv /
    # _post_attn): an adapter on any other leaf would be dropped silently
    SUPPORTED_TARGETS = frozenset(LORA_DEFAULT_TARGETS)

    @property
    def n(self) -> int:
        return len(self.names)

    def row(self, name: str | None) -> np.ndarray:
        """Per-slot mixing row [N]: one-hot x (alpha / rank); zeros = base."""
        w = np.zeros((self.n,), np.float32)
        if name is not None:
            try:
                i = self.names.index(name)
            except ValueError:
                raise KeyError(f"adapter {name!r} not in bank {self.names}") from None
            w[i] = self.scales[i]
        return w


def bankable_lora_targets(keys) -> bool:
    """True when every factor key (``<target>/a`` / ``<target>/b``) names a
    target of the batched delta path."""
    return all(k.rsplit("/", 1)[0] in AdapterBank.SUPPORTED_TARGETS for k in keys)


def build_adapter_bank(adapters: dict[str, str]) -> AdapterBank:
    """Load LoRA artifacts (name -> path) and stack them.  Raises ValueError
    for a non-LoRA artifact or a target outside the backbone delta path
    (such adapters keep the merged single-stream path)."""
    if not adapters:
        raise ValueError("adapter bank needs at least one adapter")
    loaded = {}
    for name, path in adapters.items():
        lora, rank, alpha = load_lora_params(path)
        bad = sorted(set(lora) - AdapterBank.SUPPORTED_TARGETS)
        if bad:
            raise ValueError(
                f"adapter {name!r}: targets {bad} are outside the batched delta path "
                f"({sorted(AdapterBank.SUPPORTED_TARGETS)}); such adapters must keep the "
                "merged single-stream path")
        loaded[name] = (lora, rank, alpha)
    names = tuple(loaded)
    r_max = max(rank for _, rank, _ in loaded.values())
    targets = sorted({t for lora, _, _ in loaded.values() for t in lora})
    stacks: dict = {}
    for tpath in targets:
        ref = next(lora[tpath] for lora, _, _ in loaded.values() if tpath in lora)
        a_parts, b_parts = [], []
        for name in names:
            fac = loaded[name][0].get(tpath)
            # an adapter without this target: a zero delta
            a = torch.zeros_like(ref["a"]) if fac is None else fac["a"]
            b = torch.zeros_like(ref["b"]) if fac is None else fac["b"]
            pad = r_max - a.shape[-2]  # zero rank padding leaves the delta unchanged
            a_parts.append(torch.nn.functional.pad(a, (0, 0, 0, pad)))
            b_parts.append(torch.nn.functional.pad(b, (0, pad)))
        stacks[tpath[len("tf/"):]] = {"a": torch.stack(a_parts, dim=1).float(),
                                      "b": torch.stack(b_parts, dim=1).float()}
    scales = np.asarray([alpha / rank for _, rank, alpha in loaded.values()], np.float32)
    return AdapterBank(names=names, stacks=stacks, scales=scales)


def apply_lora(model, path):
    """A clone of ``model`` with the adapter merged into its FlowLM (the plain
    dense path, no per-step adapter cost)."""
    from pocket_tts_tpu_torch.training.trainer import _adapted_clone

    lora, rank, alpha = load_lora_params(path)
    return _adapted_clone(model, merge_lora(model.params["flow_lm"], lora, alpha=alpha,
                                            rank=rank))

