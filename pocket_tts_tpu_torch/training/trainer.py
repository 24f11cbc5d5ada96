"""Fine-tune driver (port of ``pocket_tts_tpu/training/trainer.py``): the
optimizer, the train step, ``finetune`` and the fine-tuned checkpoint
artifact.

The step updates the FlowLM subtree only (backbone, flow head, text
embedding, EOS head); the Mimi codec stays frozen.  Training runs in float32
on the model's device, on copies of ``model.params["flow_lm"]`` (never the
engine's bf16 placement), or on a dp x tp mesh (``parallel/mesh.py``): the
params placed by ``mesh.shard_trainable`` (one float32 master per logical
block), the batch split over dp by :func:`shard_batch`, and backward adding
every replica's gradient into its master.  The optimizer is optax's
``chain(clip_by_global_norm(clip), adamw(schedule, weight_decay))`` written
over ``torch.optim.AdamW``: the global-norm clip as optax computes it, and
the schedule's rate set before each step (optax evaluates it at the count of
updates made so far, so a warmup schedule's first rate is 0).
"""

from __future__ import annotations

import logging
import math
import time

import numpy as np
import torch

from pocket_tts_tpu_torch import weights as weights_mod
from pocket_tts_tpu_torch.config import Config
from pocket_tts_tpu_torch.ops.qtensor import QTensor
from pocket_tts_tpu_torch.parallel.mesh import (
    Mesh,
    Spec,
    _place,
    gather,
    masters,
    shard_params,
    shard_trainable,
)
from pocket_tts_tpu_torch.runtime.engine import Engine, _map
from pocket_tts_tpu_torch.runtime.quantize import _flatten_paths, _unflatten_paths
from pocket_tts_tpu_torch.training.data import make_batch
from pocket_tts_tpu_torch.training.loss import flow_matching_loss

logger = logging.getLogger(__name__)

FINETUNED_FORMAT = "pocket-tts-tpu-finetuned"


def _schedule(lr: float, warmup_steps: int, total_steps: int | None):
    """count -> learning rate: optax's ``warmup_cosine_decay_schedule(0, lr,
    max(1, warmup), max(total, warmup + 1))`` with ``total_steps``, else
    ``linear_schedule(0, lr, warmup)`` with a warmup, else ``lr``."""
    if total_steps is not None:
        warm = max(1, warmup_steps)
        decay = max(total_steps, warmup_steps + 1) - warm

        def sched(count: int) -> float:
            if count < warm:
                return -lr * (1 - count / warm) + lr
            k = min(count - warm, decay)
            return lr * (0.5 * (1 + math.cos(math.pi * k / decay)))
        return sched
    if warmup_steps:
        return lambda count: -lr * (1 - min(count, warmup_steps) / warmup_steps) + lr
    return lambda count: lr


class Optimizer:
    """What ``make_optimizer`` returns: ``init(params)`` gives the state (an
    :class:`OptState`) for a param tree, whose float leaves train (on a mesh
    the masters of ``mesh.shard_trainable``'s leaves)."""

    def __init__(self, lr: float, weight_decay: float, clip_norm: float,
                 warmup_steps: int, total_steps: int | None):
        self.schedule = _schedule(lr, warmup_steps, total_steps)
        self.weight_decay = weight_decay
        self.clip_norm = clip_norm

    def init(self, params: dict) -> "OptState":
        return OptState(self, masters(params))


class OptState:
    """AdamW over a list of leaves (made trainable here): betas 0.9 / 0.999,
    eps 1e-8, weight decay on every leaf (optax's unmasked ``adamw``)."""

    def __init__(self, opt: Optimizer, leaves: list[torch.Tensor]):
        self.opt = opt
        self.leaves = [t.requires_grad_(True) for t in leaves]
        self.count = 0
        self.adamw = torch.optim.AdamW(self.leaves, lr=opt.schedule(0), betas=(0.9, 0.999),
                                       eps=1e-8, weight_decay=opt.weight_decay)

    @torch.no_grad()
    def step(self) -> torch.Tensor:
        """Clip the gradients by their global norm, then one AdamW step at the
        schedule's rate; returns the norm before clipping (on the first
        leaf's device; each leaf's squares are summed where it lies).  A leaf
        the loss does not reach has a zero gradient (optax still decays
        it)."""
        grads = []
        for t in self.leaves:
            if t.grad is None:
                t.grad = torch.zeros_like(t)
            grads.append(t.grad)
        dev = grads[0].device
        norm = torch.stack([g.square().sum().to(dev) for g in grads]).sum().sqrt()
        keep = norm < self.opt.clip_norm
        for g in grads:
            n, k = norm.to(g.device), keep.to(g.device)
            g.copy_(torch.where(k, g, g / n * self.opt.clip_norm))
        self.adamw.param_groups[0]["lr"] = self.opt.schedule(self.count)
        self.adamw.step()
        self.count += 1
        return norm


def make_optimizer(lr: float = 1e-4, *, weight_decay: float = 0.01, clip_norm: float = 1.0,
                   warmup_steps: int = 0, total_steps: int | None = None) -> Optimizer:
    """AdamW + global-norm clipping; linear warmup into cosine decay when
    ``total_steps`` is given, a linear warmup alone or a constant rate
    otherwise."""
    return Optimizer(lr, weight_decay, clip_norm, warmup_steps, total_steps)


def _update(opt_state: OptState, loss_fn) -> dict:
    """Backward of ``loss_fn() -> (loss, metrics)`` into the state's leaves,
    then one optimizer step; the detached metrics plus ``grad_norm``."""
    opt_state.adamw.zero_grad(set_to_none=True)
    with torch.enable_grad():
        loss, metrics = loss_fn()
        loss.backward()
    out = {k: v.detach() for k, v in metrics.items()}
    out["grad_norm"] = opt_state.step()
    return out


def make_train_step(cfg: Config, optimizer: Optimizer, *, eos_weight: float = 1.0,
                    consistency_weight: float = 0.0):
    """``train_step(params, opt_state, batch, generator=None, *, draws=None)
    -> (params, opt_state, metrics)`` over the FlowLM subtree, updated in
    place (``opt_state = optimizer.init(params)``).  ``draws``: the loss's
    pre-sampled noise, else drawn from ``generator``."""

    def train_step(params: dict, opt_state: OptState, batch: dict,
                   generator: torch.Generator | None = None, *, draws: dict | None = None):
        metrics = _update(opt_state, lambda: flow_matching_loss(
            params, cfg, batch, generator, draws=draws, eos_weight=eos_weight,
            consistency_weight=consistency_weight))
        return params, opt_state, metrics

    return train_step


def shard_batch(batch: dict, mesh: Mesh) -> dict:
    """Place every batch leaf (numpy array or tensor) with its leading (batch)
    axis split over the mesh's ``dp`` axis: group g gets lanes ``[g B/dp,
    (g+1) B/dp)``, a tensor of its own on the group's lead device.  A batch
    that ``dp`` does not divide raises."""
    dp = mesh.shape["dp"]
    out = {}
    for k, v in batch.items():
        t = v if torch.is_tensor(v) else torch.from_numpy(np.ascontiguousarray(v))
        if t.shape[0] % dp:
            raise ValueError(f"shard_batch: {k} has {t.shape[0]} lanes, not a multiple of the "
                             f"mesh's dp {dp}")
        out[k] = _place(t, Spec("dp", *([None] * (t.dim() - 1))), mesh, every_device=False)
    return out


def _refuse_quantized(params: dict, what: str) -> None:
    quantized = [p for p, leaf in _flatten_paths(params) if isinstance(leaf, QTensor)]
    if quantized:
        raise ValueError(f"{what}: the model is quantized ({quantized[0]} is a QTensor); "
                         "fine-tune the float checkpoint, then quantize")


def _adapted_clone(model, flow_lm: dict):
    """A clone of ``model`` running ``flow_lm`` (float32 CPU tensors, or
    tensors on any device) on a fresh ``Engine`` on the model's device, which
    shares the base engine's placed codec.  Voice states are KV snapshots
    through the backbone, so the clone gets no voice state of the base's: the
    one shared holder is the empty voice, a zero cache of the same capacity
    and KV dtype with no backbone work in it."""
    flow_lm = _map(flow_lm, lambda t: t.detach().cpu() if torch.is_tensor(t) else t)
    clone = object.__new__(type(model))
    clone.__dict__.update(model.__dict__)
    clone.params = {**model.params, "flow_lm": flow_lm}
    clone.engine = Engine(model.config, {"flow_lm": flow_lm, "mimi": model.engine.params["mimi"]},
                          model.device, batch_size=model.engine.batch)
    if model.engine._codec_device is not None:  # the source model's staged codec
        clone.engine.enable_staged_codec(model.engine._codec_device)
    clone._rng = torch.Generator().set_state(model._rng.get_state())
    return clone


def finetune(model, pairs: list, *, steps: int = 200, batch_size: int | None = None,
             lr: float = 1e-4, weight_decay: float = 0.01, clip_norm: float = 1.0,
             warmup_steps: int = 0, eos_weight: float = 1.0, consistency_weight: float = 0.0,
             voice_wav: np.ndarray | None = None, max_tokens: int | None = None, seed: int = 0,
             log_every: int = 25, mesh=None, lora_rank: int = 0, lora_alpha: float | None = None,
             lora_targets: tuple[str, ...] | None = None):
    """Fine-tune ``model`` on (text, waveform) pairs on its device, or on
    ``mesh``; returns a single-device clone (on the model's device) running
    the tuned FlowLM, with ``_finetune_metrics`` (the last logged step's)
    and, for LoRA, ``_lora = (factors on the CPU, rank, alpha)``.

    All examples are padded to one global batch; minibatches are row slices
    of it in the order of ``np.random.default_rng(seed)`` (the JAX package's
    permutations), wrapping around.  ``lora_rank > 0`` trains rank-r factors
    over ``lora_targets`` only (base frozen) and merges them into the clone.
    The loss's noise comes from a ``torch.Generator`` seeded with ``seed``
    (on the mesh's lead device: a mesh step sees the one-device draws).
    With a ``mesh`` the float32 params (LoRA: the base) are placed on it
    (``shard_trainable``; the base by ``shard_params``, the factors
    replicated), every minibatch by :func:`shard_batch`, and the tuned tree
    is gathered onto the model's device at the end.  A quantized model is
    refused."""
    _refuse_quantized(model.params["flow_lm"], "finetune")
    full = make_batch(model, pairs, voice_wav=voice_wav, max_tokens=max_tokens)
    n = len(pairs)
    bsz = min(batch_size or n, n)
    optimizer = make_optimizer(lr, weight_decay=weight_decay, clip_norm=clip_norm,
                               warmup_steps=warmup_steps, total_steps=steps)
    dev = model.device
    f32 = _map(model.params["flow_lm"], lambda t: t.detach().to(dev, torch.float32, copy=True))
    use_lora = lora_rank > 0
    if use_lora:
        from pocket_tts_tpu_torch.training.lora import (
            LORA_DEFAULT_TARGETS, init_lora, make_lora_train_step, merge_lora)

        alpha = float(lora_alpha if lora_alpha is not None else lora_rank)
        targets = tuple(lora_targets or LORA_DEFAULT_TARGETS)
        base, params = f32, init_lora(f32, lora_rank, targets=targets, seed=seed)
        if mesh is not None:
            base, params = shard_params(f32, mesh), shard_trainable(params, mesh)
        step_fn = make_lora_train_step(model.config, optimizer, alpha=alpha, rank=lora_rank,
                                       eos_weight=eos_weight,
                                       consistency_weight=consistency_weight)
    else:
        params = f32 if mesh is None else shard_trainable(f32, mesh)
        step_fn = make_train_step(model.config, optimizer, eos_weight=eos_weight,
                                  consistency_weight=consistency_weight)
    del f32  # on a mesh its placed copies replace it
    opt_state = optimizer.init(params)

    rng = np.random.default_rng(seed)
    generator = torch.Generator(device=dev if mesh is None else mesh.lead(0)).manual_seed(seed)
    order = rng.permutation(n)
    cursor = 0
    t0 = time.time()
    last: dict = {}
    for step in range(steps):
        if cursor + bsz > n:
            order = rng.permutation(n)
            cursor = 0
        idx = order[cursor:cursor + bsz]
        cursor += bsz
        mb = {k: torch.from_numpy(np.asarray(v)[idx]) for k, v in full.items()}
        mb = {k: v.to(dev) for k, v in mb.items()} if mesh is None else shard_batch(mb, mesh)
        if use_lora:
            params, opt_state, metrics = step_fn(params, opt_state, base, mb, generator)
        else:
            params, opt_state, metrics = step_fn(params, opt_state, mb, generator)
        if log_every and (step % log_every == 0 or step == steps - 1):
            last = {k: float(v) for k, v in metrics.items()}
            logger.info("step %d/%d loss %.4f (flow %.4f eos %.4f) grad %.3f [%.1fs]",
                        step + 1, steps, last["loss"], last["flow_mse"], last["eos_bce"],
                        last["grad_norm"], time.time() - t0)

    with torch.no_grad():
        tuned = merge_lora(base, params, alpha=alpha, rank=lora_rank) if use_lora else params
        clone = _adapted_clone(model, tuned if mesh is None else gather(tuned, dev))
    clone._finetune_metrics = last
    if use_lora:
        clone._lora = (_map(gather(params, "cpu"), torch.Tensor.detach), lora_rank, alpha)
    return clone


# -- fine-tuned checkpoint artifacts ------------------------------------------------------


def save_finetuned_params(params: dict, path) -> None:
    """Write a trained FlowLM subtree (``model.params["flow_lm"]``) as
    float32 tensors under their paths, metadata ``format``."""
    tensors = {name: leaf.detach().float().cpu().numpy() for name, leaf in _flatten_paths(params)}
    weights_mod.write_safetensors(tensors, path, metadata={"format": FINETUNED_FORMAT})


def load_finetuned_params(path) -> dict:
    """A :func:`save_finetuned_params` artifact (this package's or the JAX
    package's) -> the FlowLM subtree of float32 CPU tensors."""
    tensors, meta = weights_mod.read_safetensors(path, with_metadata=True)
    if meta.get("format") != FINETUNED_FORMAT:
        raise ValueError(f"{path} is not a {FINETUNED_FORMAT} checkpoint")
    return _unflatten_paths({k: torch.from_numpy(np.asarray(v, np.float32))
                             for k, v in tensors.items()})


def apply_adapted(model, path):
    """Load either artifact kind by its ``format`` metadata: a full
    fine-tuned FlowLM (:func:`save_finetuned_params`) or a LoRA adapter
    (``lora.save_lora_params``)."""
    from pocket_tts_tpu_torch.training.lora import LORA_FORMAT, apply_lora

    fmt = weights_mod.read_safetensors_header(path)[1].get("format")
    if fmt == FINETUNED_FORMAT:
        return apply_finetuned(model, path)
    if fmt == LORA_FORMAT:
        return apply_lora(model, path)
    raise ValueError(f"{path}: unknown checkpoint format {fmt!r} (expected "
                     f"{FINETUNED_FORMAT} or {LORA_FORMAT})")


def apply_finetuned(model, path):
    """A clone of ``model`` running a saved fine-tuned FlowLM."""
    return _adapted_clone(model, load_finetuned_params(path))
