"""Device mesh, sharding rules and the tensor-parallel reduction (port of
``pocket_tts_tpu/parallel/mesh.py``).

The JAX package runs a mesh as one controller over many devices and lets
GSPMD insert the collectives.  The port keeps one process and one host loop:
a sharded leaf holds one contiguous tensor per block, each on its own device,
the models run each tp rank's share of a layer in turn, and the partial sums
of a row-parallel product are added on the group's lead device in rank order
(:func:`reduce_sum`).  There is no process group and no NCCL: several NCCL
ranks cannot share one card, and one process is JAX's single controller.

Axes:
  dp — data parallel over the serving batch: group g owns lanes
       ``[g B/dp, (g+1) B/dp)`` and runs them on its own devices.
  tp — tensor parallel (Megatron): in_proj and ff1 column-split, out_proj
       and ff2 row-split (one reduction each per layer), and the KV caches
       split on heads.

A mesh may repeat a device (``[cpu] * 8``, or ``[cuda:0] * n`` on one card):
the sharded code then runs as on distinct devices, and every copy between
ranks is a no-op.
"""

from __future__ import annotations

import numpy as np
import torch

from pocket_tts_tpu_torch.ops.qtensor import QTensor, map_with_path
from pocket_tts_tpu_torch.ops.sdpa import FP8_DTYPES

class Spec(tuple):
    """A partition spec: one mesh axis name (or None) per array dim, printed
    as JAX's ``PartitionSpec``."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        inner = ", ".join(repr(a) for a in self)
        return f"PartitionSpec({inner}{',' if len(self) == 1 else ''})"

    __str__ = __repr__


class Mesh:
    """A ``[dp, tp]`` array of ``torch.device`` (``devices``); ``shape`` is
    ``{"dp": dp, "tp": tp}``.  Group g's devices are ``devices[g]``, its lead
    (rank 0) ``devices[g, 0]``."""

    def __init__(self, devices: np.ndarray):
        if devices.ndim != 2 or devices.size == 0:
            raise ValueError(f"Mesh: devices must be a non-empty [dp, tp] array, got shape "
                             f"{devices.shape}")
        self.devices = devices
        self.shape = {"dp": devices.shape[0], "tp": devices.shape[1]}

    def lead(self, g: int) -> torch.device:
        return self.devices[g, 0]

    def __repr__(self) -> str:
        return (f"Mesh(dp={self.shape['dp']}, tp={self.shape['tp']}, "
                f"devices={[str(d) for d in self.devices.ravel()]})")


def make_mesh(n_devices: int | None = None, tp: int | None = None,
              devices: list | None = None) -> Mesh:
    """A dp x tp mesh over ``devices`` (default: every visible CUDA device;
    with none visible this raises, it never falls back to the CPU), cut to
    the first ``n_devices``.  ``tp`` defaults to the first of 4, 2, 8 that
    divides the device count (it divides the FFN hidden and the head count),
    else 1.  ``devices`` may repeat a device."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no CUDA device is visible; pass devices= (for "
                               "example [torch.device('cpu')] * 8) for a mesh of other devices")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    if n_devices:
        if n_devices > len(devices):
            raise ValueError(f"make_mesh: {n_devices} devices asked, {len(devices)} given")
        devices = devices[:n_devices]
    n = len(devices)
    if tp is None:
        tp = next((c for c in (4, 2, 8) if n % c == 0), 1)
    if tp < 1 or n % tp:
        raise ValueError(f"make_mesh: tp={tp} does not divide {n} devices")
    arr = np.empty(n, dtype=object)
    arr[:] = devices
    return Mesh(arr.reshape(n // tp, tp))


def _path_name(path) -> str:
    return path if isinstance(path, str) else "/".join(str(k) for k in path)


def param_sharding_rules(path, leaf=None) -> Spec:
    """The spec of a parameter leaf (``path``: its key path, a tuple of names
    or "a/b/c").  Megatron per transformer layer, two reductions in all:
    in_proj [L, 3, E, E] column-parallel on dim 2 (head-major: E = H x D
    with heads leading, so a tp block is whole heads, as the head-split KV
    caches); out_proj [L, E, E] row-parallel on the contraction dim; ff1
    [L, F, E] column-parallel, ff2 [L, E, F] row-parallel.  Everything else
    (norms, convs, embeddings, heads, the flow net) is small: replicated."""
    name = _path_name(path)
    if name.endswith("in_proj"):
        return Spec(None, None, "tp", None)
    if name.endswith("out_proj"):
        return Spec(None, None, "tp")
    if name.endswith("ff1"):
        return Spec(None, "tp", None)
    if name.endswith("ff2"):
        return Spec(None, None, "tp")
    return Spec()


def state_sharding_rules(path) -> Spec:
    """Generation state: lanes split over dp; the KV caches (and the Mimi
    decoder's KV tails, whose names also end in kc / vc) [L, B, S, H, D]
    also over heads on tp."""
    name = _path_name(path)
    if name.endswith("kc") or name.endswith("vc"):
        return Spec(None, "dp", None, "tp", None)
    if name.endswith("pos"):
        return Spec("dp")
    if name.endswith("latent"):
        return Spec("dp", None)
    return Spec("dp")  # Mimi conv states [B, C, T]


def _fit_spec(spec, shape: tuple, mesh: Mesh) -> Spec:
    """Trim a spec to the array's rank and drop each axis that does not
    divide its dim (e.g. the Mimi decoder has fewer heads than tp)."""
    out = []
    for i, axis in enumerate(tuple(spec)[: len(shape)]):
        if axis is not None and shape[i] % mesh.shape[axis] != 0:
            axis = None
        out.append(axis)
    return Spec(*out)


def _raw(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.uint8) if t.dtype in FP8_DTYPES else t


class Shards:
    """One dp group's view of a leaf split on tp: ``parts[r]`` (a tensor or
    a QTensor) on rank r's device, the leaf's blocks along axis ``dim``."""

    def __init__(self, parts: list, dim: int):
        self.parts = list(parts)
        self.dim = dim

    def __len__(self) -> int:
        return len(self.parts)

    def __getitem__(self, idx: int) -> "Shards":
        """Index a leading (layer) axis of every part."""
        if self.dim == 0:
            raise IndexError("Shards: the split axis cannot be indexed")
        return Shards([p[idx] for p in self.parts], self.dim - 1)

    @property
    def devices(self) -> list:
        return [p.device for p in self.parts]

    @property
    def shape(self) -> tuple:
        s = list(self.parts[0].shape)
        s[self.dim] *= len(self.parts)
        return tuple(s)


class Sharded:
    """A leaf placed on a mesh: its ``spec`` (after :func:`_fit_spec`), and
    ``blocks[g]``, the pieces of dp group g: one per tp rank, on
    ``mesh.devices[g, r]``, when the spec splits tp or the leaf is a
    parameter (a replicated parameter is on every device of the mesh), else
    one on the group's lead device.  Pieces of one index on one device are
    one tensor, so a repeated device holds one copy.  ``shape`` / ``dtype``
    are the whole leaf's."""

    def __init__(self, spec: Spec, blocks: list, mesh: Mesh):
        self.spec = spec
        self.blocks = blocks
        self.mesh = mesh
        first = blocks[0][0]
        s = list(first.shape)
        for i, axis in enumerate(spec):
            if axis is not None:
                s[i] *= mesh.shape[axis]
        self.shape = tuple(s)
        self.dtype = first.dtype

    @property
    def itemsize(self) -> int:
        return self.dtype.itemsize

    @property
    def sharded(self) -> bool:
        """Actually distributed: the spec names a mesh axis of size > 1."""
        return any(a is not None and self.mesh.shape[a] > 1 for a in self.spec)

    @property
    def tp_split(self) -> bool:
        return "tp" in self.spec and self.mesh.shape["tp"] > 1

    def group(self, g: int):
        """Group g's view: :class:`Shards` when split on tp, else the piece on
        the group's lead device."""
        parts = self.blocks[g]
        return Shards(parts, self.spec.index("tp")) if self.tp_split else parts[0]


class Trainable(Sharded):
    """A trainable parameter leaf on a mesh (:func:`shard_trainable`): only
    group 0's blocks, the float32 masters, each its own leaf tensor (one per
    tp rank on that rank's device when split on tp, else one on the lead
    device).  The optimizer updates the masters; :func:`replicas` builds
    every other group's copies from them."""

    def replicas(self) -> Sharded:
        """The leaf with every dp group: group 0 the masters, group g's block
        r ``master_r.to(devices[g, r])``, a differentiable copy (the master
        itself on a repeated device), so backward adds each replica's
        gradient into its master: the gradient all-reduce of data
        parallelism."""
        devs = self.mesh.devices
        rows = [self.blocks[0]] + [[m.to(devs[g, r]) for r, m in enumerate(self.blocks[0])]
                                   for g in range(1, self.mesh.shape["dp"])]
        return Sharded(self.spec, rows, self.mesh)


def _own(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """A contiguous copy of ``t`` on ``device`` in an allocation of its own
    (an fp8 tensor copied as its bytes)."""
    out = torch.empty(t.shape, dtype=t.dtype, device=device)
    _raw(out).copy_(_raw(t))
    return out


def _split_packed(q: torch.Tensor, idx: int, n: int) -> torch.Tensor:
    """Block ``idx`` of ``n`` along the logical last axis of packed int4
    ``q`` (byte j holds element j in its low nibble and j + d/2 in its high
    one), repacked the same way; an odd block width keeps int8 storage at
    the int4 levels, as ``quantize_array`` does."""
    vals = torch.cat([q & 0xF, q >> 4], dim=-1)
    k = vals.shape[-1] // n
    blk = vals.narrow(-1, idx * k, k)
    if k % 2:
        return blk.to(torch.int8) - 8
    return blk[..., : k // 2] | (blk[..., k // 2:] << 4)


def _place(t: torch.Tensor, spec: Spec, mesh: Mesh, *, every_device: bool,
           packed: bool = False) -> Sharded:
    whole = all(a is None or mesh.shape[a] == 1 for a in spec)
    per_rank = every_device or "tp" in spec
    made: dict = {}
    blocks = []
    for g in range(mesh.shape["dp"]):
        row = []
        for r in range(mesh.shape["tp"] if per_rank else 1):
            dev = mesh.devices[g, r]
            index = {"dp": g, "tp": r}
            key = (str(dev),) + tuple(index[a] for a in spec if a is not None)
            if key not in made:
                if whole and every_device:  # a parameter is kept where it already lies
                    made[key] = t.to(dev).contiguous()
                else:
                    blk = t
                    for d, axis in enumerate(spec):
                        if axis is None:
                            continue
                        n = mesh.shape[axis]
                        if packed and d == t.dim() - 1:
                            blk = _split_packed(blk, index[axis], n)
                        else:
                            size = t.shape[d] // n
                            blk = blk.narrow(d, index[axis] * size, size)
                    made[key] = _own(blk, dev)
            row.append(made[key])
        blocks.append(row)
    return Sharded(spec, blocks, mesh)


def shard_params(params: dict, mesh: Mesh) -> dict:
    """Place a parameter tree on ``mesh`` by :func:`param_sharding_rules`.
    A QTensor's ``q`` takes its leaf's rule; its per-channel scale covers
    q's leading axes, so its spec is the rule cut to its rank: the
    column-parallel in_proj / ff1 split their scales, the row-parallel ff2
    keeps its whole.  A packed int4 ``q`` split on its last axis is split on
    its logical elements and each block repacked."""

    def put(name, leaf):
        if isinstance(leaf, QTensor):
            spec = _fit_spec(param_sharding_rules(name), leaf.q.shape, mesh)
            s_spec = _fit_spec(spec[: leaf.scale.dim()], leaf.scale.shape, mesh)
            return QTensor(_place(leaf.q, spec, mesh, every_device=True, packed=leaf.packed),
                           _place(leaf.scale, s_spec, mesh, every_device=True))
        if torch.is_tensor(leaf):
            spec = _fit_spec(param_sharding_rules(name), leaf.shape, mesh)
            return _place(leaf, spec, mesh, every_device=True)
        return leaf

    return map_with_path(params, put)


def shard_trainable(params: dict, mesh: Mesh) -> dict:
    """Place a float parameter tree for training by
    :func:`param_sharding_rules`: each leaf a :class:`Trainable` holding one
    float32 master per logical block (a tp-split leaf one per rank, on that
    rank's device in group 0; a replicated leaf one, on the lead device), a
    fresh allocation each.  The optimizer's leaves are :func:`masters`, so a
    replicated leaf counts once in the global-norm clip and cannot drift
    apart between devices.  A QTensor raises (quantized weights do not
    train)."""
    first = Mesh(mesh.devices[:1])

    def put(name, leaf):
        if isinstance(leaf, QTensor):
            raise ValueError(f"shard_trainable: {name} is quantized")
        spec = _fit_spec(param_sharding_rules(name), leaf.shape, mesh)
        placed = _place(leaf.detach().float(), spec, first, every_device=False)
        return Trainable(spec, placed.blocks, mesh)

    return map_with_path(params, put)


def replicas(tree):
    """``tree`` with each :class:`Trainable` leaf replaced by its
    :meth:`Trainable.replicas` (every group's copies, built under autograd
    from the masters); other leaves as they are."""
    return map_with_path(tree, lambda _, leaf: leaf.replicas()
                         if isinstance(leaf, Trainable) else leaf)


def masters(tree) -> list[torch.Tensor]:
    """The tensors an optimizer updates: each :class:`Trainable` leaf's
    masters, each unplaced tensor itself, in tree order.  Any other placed
    leaf raises: its replicas would count in the norm once per device."""
    out = []

    def visit(name, leaf):
        if isinstance(leaf, Trainable):
            out.extend(leaf.blocks[0])
        elif isinstance(leaf, Sharded):
            raise ValueError(f"masters: {name} is placed by shard_params; place trainable "
                             "params with shard_trainable")
        else:
            out.append(leaf)
        return leaf

    map_with_path(tree, visit)
    return out


def shard_state(state: dict, mesh: Mesh) -> dict:
    """Place a generation state on ``mesh`` by :func:`state_sharding_rules`:
    every block is its own allocation (a cache shard is never a view of the
    whole cache); a leaf not split on tp lives on its group's lead device."""
    return map_with_path(state, lambda name, leaf: _place(
        leaf, _fit_spec(state_sharding_rules(name), leaf.shape, mesh), mesh,
        every_device=False))


def group_view(tree, g: int):
    """dp group g's view of a placed tree: each leaf split on tp becomes a
    :class:`Shards` (a split QTensor one of per-rank QTensors), every other
    leaf the tensor on the group's lead device."""

    def view(_, leaf):
        if isinstance(leaf, Sharded):
            return leaf.group(g)
        if isinstance(leaf, QTensor) and isinstance(leaf.q, Sharded):
            q, s = leaf.q, leaf.scale
            if q.tp_split:
                return Shards([QTensor(qp, sp) for qp, sp in zip(q.blocks[g], s.blocks[g])],
                              q.spec.index("tp"))
            return QTensor(q.blocks[g][0], s.blocks[g][0])
        return leaf

    return map_with_path(tree, view)


def join_groups(like, views: list):
    """The placed tree of ``like``'s structure and specs whose group g is
    ``views[g]`` (group views after a step that replaced state tensors)."""
    if isinstance(like, dict):
        return {k: join_groups(like[k], [v[k] for v in views]) for k in like}
    if isinstance(like, list):
        return [join_groups(x, [v[i] for v in views]) for i, x in enumerate(like)]
    if isinstance(like, Sharded):
        return Sharded(like.spec, [v.parts if isinstance(v, Shards) else [v] for v in views],
                       like.mesh)
    return like


def gather(tree, device: torch.device | str):
    """A placed state tree (or leaf) gathered whole onto ``device``: blocks
    joined along tp, then along dp; an unplaced tensor is moved there."""

    def whole(_, leaf):
        if not isinstance(leaf, Sharded):  # a whole tensor already
            return _raw(leaf).to(device).view(leaf.dtype) if torch.is_tensor(leaf) else leaf
        rows = []
        for parts in leaf.blocks:
            if "tp" in leaf.spec:
                parts = [_raw(p).to(device) for p in parts]
                rows.append(torch.cat(parts, dim=leaf.spec.index("tp")))
            else:
                rows.append(_raw(parts[0]).to(device))
        out = torch.cat(rows, dim=leaf.spec.index("dp")) if "dp" in leaf.spec else rows[0]
        return out.view(leaf.dtype) if leaf.dtype in FP8_DTYPES else out

    return map_with_path(tree, whole) if isinstance(tree, (dict, list)) else whole("", tree)


def reduce_sum(parts: list, device: torch.device) -> torch.Tensor:
    """The sum of ``parts`` (one shape, on any devices) on ``device``, added
    in rank order, ``((p0 + p1) + p2) + ...``, in float32 and cast back to
    the parts' dtype; a single part (a product not split) is returned as it
    is.  Each part is copied with ``non_blocking=True`` (a no-op where it
    already lies on ``device``)."""
    if len(parts) == 1:
        return parts[0].to(device, non_blocking=True)
    out = parts[0].to(device=device, dtype=torch.float32, non_blocking=True)
    for p in parts[1:]:
        out = out + p.to(device=device, dtype=torch.float32, non_blocking=True)
    return out.to(parts[0].dtype)


def sharding_manifest(tree) -> dict[str, dict]:
    """name -> {shape, itemsize, spec, sharded} for every leaf of a placed
    tree (a QTensor's ``q`` and scale as ``name/0`` and ``name/1``, JAX's
    names).  ``sharded`` is True only when the leaf is actually distributed:
    :func:`_fit_spec` drops an axis that does not divide its dim by design,
    so a config change could quietly de-shard a product with no numerical
    signal; this manifest is what the tests check."""
    out = {}

    def visit(name, leaf):
        if isinstance(leaf, QTensor):
            visit(f"{name}/0", leaf.q)
            visit(f"{name}/1", leaf.scale)
            return leaf
        if isinstance(leaf, Sharded):
            out[name] = {"shape": leaf.shape, "itemsize": leaf.itemsize, "spec": str(leaf.spec),
                         "sharded": leaf.sharded}
        elif torch.is_tensor(leaf):
            out[name] = {"shape": tuple(leaf.shape), "itemsize": leaf.dtype.itemsize,
                         "spec": None, "sharded": False}
        return leaf

    map_with_path(tree, visit)
    return out


def format_shard_report(tree, min_bytes: int = 1 << 20) -> str:
    """Sharded leaves and replicated leaves of at least ``min_bytes`` (those
    a silent de-shard would matter for), one line each."""
    lines = []
    for name, info in sorted(sharding_manifest(tree).items()):
        nbytes = int(np.prod(info["shape"])) * info["itemsize"]
        if info["sharded"]:
            lines.append(f"  sharded    {name} {info['shape']} {info['spec']}")
        elif nbytes >= min_bytes:
            lines.append(f"  REPLICATED {name} {info['shape']} ({nbytes >> 20} MiB)")
    return "\n".join(lines) or "  (nothing sharded)"
