"""Flow block chain: the Hopper port of the Pallas TPU kernel
``pocket_tts_tpu/ops/pallas/flow_kernel.py`` (``flow_blocks``).

``flow_blocks(sy, h0, blocks)`` runs the ``depth`` stacked AdaLN ResBlocks of
the SimpleMLPAdaLN flow net.  On CUDA tensors it launches the hand-written
kernel in ``csrc/flow_blocks.cu`` (built with ``nvcc`` for ``sm_90a`` at first
use into ``build/pocket_tts_tpu_torch/`` and loaded with ``ctypes``), or
raises.  On CPU tensors it runs :func:`flow_blocks_reference`, the plain
PyTorch version of the same function.

Each call is one persistent cooperative CUDA launch.  :func:`launch_plan`
sizes it in Python, so the CPU tests can check it: grid, rows per CTA,
resident or streamed weight slices, the modulation ring, batch group and
tile, shared memory.  ``flow_blocks.launches`` counts the launches made
through the wrapper, one per call.
"""

from __future__ import annotations

import ctypes
import dataclasses
import threading
from pathlib import Path

import torch
import torch.nn.functional as F

from pocket_tts_tpu_torch.kernels import build as build_mod
from pocket_tts_tpu_torch.ops.norms import layer_norm

SOURCE = build_mod.PKG / "csrc" / "flow_blocks.cu"

BLOCK_KEYS = ("ada_w", "ada_b", "ln_w", "ln_b", "mlp1_w", "mlp1_b", "mlp2_w", "mlp2_b")
MAX_DIM = 1024  # kMaxChunks * 128 in the kernel
MAX_GROUP = 8  # batch lanes a warp task applies one row to: 1, 2, 4 or 8
CHUNK_ROWS = 8  # modulation rows per ring chunk (kWarps, one row per warp)
MAX_RING = 4  # slots of a streamed ring (chain slices, modulation chunks)
MAX_SMEM_BYTES = 232_448  # shared memory one CTA may use on Hopper (227 KB)
SM_SMEM_BYTES = 233_472  # shared memory of one SM (228 KB), 1 KB reserved per CTA

_lock = threading.Lock()
_count_lock = threading.Lock()  # launches come from several threads of a server
_lib = None
_plans: dict = {}
_checked: dict = {}  # id()s of validated stacked block tensors -> (tensors, device, dims)


def build() -> Path:
    """Compile ``csrc/flow_blocks.cu`` (see :func:`kernels.build.build`)."""
    return build_mod.build(SOURCE, "flow_blocks")


def _load():
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            fn = lib.pt_flow_blocks_f32
            fn.argtypes = [ctypes.c_void_p] * 14 + [ctypes.c_int] * 11 + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
            occ = lib.pt_flow_blocks_occupancy
            occ.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)]
            occ.restype = ctypes.c_int
            _lib = lib
    return _lib


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    """One cooperative launch: ``grid`` CTAs of 256 threads; CTA c owns rows
    ``[c * rows, min((c + 1) * rows, dim))`` of every chain stage (mlp1, mlp2
    of each block); ``slots`` row slices in shared memory (``stages`` = all
    resident, fewer = a ring refilled as stages are consumed); CTA c owns
    modulation rows ``[c * mrows, (c + 1) * mrows)`` of each block's ``3 *
    dim`` (``mrows`` a multiple of 4), streamed through ``mslots`` chunks of
    :data:`CHUNK_ROWS` rows and their biases; a warp applies a row to
    ``group`` lanes at once; the batch is staged ``tile`` lanes (a multiple
    of ``group``) at a time; ``smem`` bytes of shared memory per CTA."""

    grid: int
    rows: int
    slots: int
    stages: int
    mrows: int
    mslots: int
    group: int
    tile: int
    smem: int

    @property
    def resident(self) -> bool:
        return self.slots == self.stages


def _bar_bytes(slots: int) -> int:
    return (slots * 8 + 15) // 16 * 16


def launch_plan(batch: int, dim: int, depth: int, sms: int,
                blocks_per_sm: int = 1) -> LaunchPlan:
    """The launch of one call on a card with ``sms`` SMs holding
    ``blocks_per_sm`` CTAs each.  The group is the batch rounded up to a power
    of two, at most 8.  Weight slices stay resident when all ``2 * depth`` of
    them fit beside a modulation ring of 2 chunks and one group of staged
    lanes; the ring then deepens (up to two blocks' chunks) as far as a tile
    of up to 16 lanes leaves room.  Else a ring of at most :data:`MAX_RING`
    slices streams them, the two rings as deep as fit together (the shallower
    of the two as deep as it can be).  The batch tile takes the rest of the
    shared memory; each staged lane holds z or u and silu(y).  Raises
    ValueError if nothing fits."""
    if batch < 1 or depth < 1 or dim < 4 or sms < 1 or blocks_per_sm < 1:
        raise ValueError(f"flow_blocks: no launch for batch={batch} dim={dim} depth={depth} "
                         f"sms={sms} blocks_per_sm={blocks_per_sm}")
    limit = min(MAX_SMEM_BYTES, SM_SMEM_BYTES // blocks_per_sm - 1024)
    grid = min(sms * blocks_per_sm, dim)
    rows = -(-dim // grid)
    stages = 2 * depth
    mrows = -(-3 * dim // (4 * grid)) * 4  # a multiple of 4: 16-byte aligned bias copies
    per_block = -(-mrows // CHUNK_ROWS)  # modulation chunks per CTA and block
    row_bytes, lane_bytes = dim * 4, 2 * dim * 4
    chunk_bytes = CHUNK_ROWS * (dim + 1) * 4  # rows and their biases
    group = min(MAX_GROUP, 1 << (batch - 1).bit_length())

    def weights(slots: int, mslots: int) -> int:
        return _bar_bytes(slots + mslots) + slots * rows * row_bytes + mslots * chunk_bytes

    mslots = min(2, per_block)
    if weights(stages, mslots) + group * lane_bytes <= limit:
        slots = stages
        tile_want = min(-(-batch // group) * group, max(group, 16))
        deeper = [m for m in range(mslots + 1, 2 * per_block + 1)
                  if weights(stages, m) + tile_want * lane_bytes <= limit]
        mslots = max(deeper, default=mslots)
    else:  # the deepest pair of rings that fits, the shallower of the two first
        fits = [(s, m) for m in range(min(MAX_RING, 2 * per_block), 0, -1)
                for s in range(min(MAX_RING, stages - 1), 0, -1)
                if weights(s, m) + group * lane_bytes <= limit]
        if not fits:
            raise ValueError(f"flow_blocks: a {rows}-row slice of dim {dim} does not fit in "
                             f"{limit} bytes of shared memory ({sms} SMs)")
        slots, mslots = max(fits, key=lambda sm: (min(sm), sum(sm)))
    used = weights(slots, mslots)
    tile = min(-(-batch // group) * group, (limit - used) // lane_bytes // group * group)
    return LaunchPlan(grid, rows, slots, stages, mrows, mslots, group, tile,
                      used + tile * lane_bytes)


def _plan_for(batch: int, dim: int, depth: int, device: torch.device, lib) -> LaunchPlan:
    """:func:`launch_plan` for this card, at the occupancy the kernel reaches
    with the plan's shared memory (cached per shape and device)."""
    key = (batch, dim, depth, device.index)
    plan = _plans.get(key)
    if plan is None:
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        plan = launch_plan(batch, dim, depth, sms)
        occ = ctypes.c_int(0)
        with torch.cuda.device(device):
            err = lib.pt_flow_blocks_occupancy(plan.group, dim, plan.smem, ctypes.byref(occ))
        if err != 0 or occ.value < 1:
            raise RuntimeError(f"flow_blocks: no CTA of {plan.smem} bytes of shared memory "
                               f"fits on an SM (error {err}, occupancy {occ.value})")
        if occ.value > 1:
            plan = launch_plan(batch, dim, depth, sms, occ.value)
        _plans[key] = plan
    return plan


def flow_blocks_reference(sy: torch.Tensor, h0: torch.Tensor, blocks: dict) -> torch.Tensor:
    """Plain PyTorch version: the same ResBlock chain, one block at a time."""
    h = h0.float()
    dim = h.shape[-1]
    for i in range(blocks["ada_w"].shape[0]):
        mod = sy @ blocks["ada_w"][i].T + blocks["ada_b"][i]
        shift, scale, gate = mod.split(dim, dim=-1)
        z = layer_norm(h, blocks["ln_w"][i], blocks["ln_b"][i], eps=1e-6)
        z = z * (1 + scale) + shift
        z = F.silu(z @ blocks["mlp1_w"][i].T + blocks["mlp1_b"][i])
        z = z @ blocks["mlp2_w"][i].T + blocks["mlp2_b"][i]
        h = h + gate * z
    return h


def _check_tensor(name: str, t: torch.Tensor, device: torch.device, shape: tuple) -> None:
    if t.device != device:
        raise ValueError(f"flow_blocks: {name} on {t.device}, sy on {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"flow_blocks: {name} is {t.dtype}; the kernel takes float32 only")
    if tuple(t.shape) != shape:
        raise ValueError(f"flow_blocks: {name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"flow_blocks: {name} must be contiguous and 16-byte aligned")


def _check_blocks(blocks: dict, device: torch.device) -> tuple[int, int]:
    """(dim, depth) of the stacked params, validated once per set of tensors
    (keyed by their ids; the cache holds the tensors, so no id is reused)."""
    tensors = tuple(blocks[k] for k in BLOCK_KEYS)
    key = tuple(map(id, tensors))
    hit = _checked.get(key)
    if hit is not None and hit[1] == device:
        return hit[2]
    depth, _, dim = blocks["ada_w"].shape
    shapes = {"ada_w": (depth, 3 * dim, dim), "ada_b": (depth, 3 * dim),
              "ln_w": (depth, dim), "ln_b": (depth, dim),
              "mlp1_w": (depth, dim, dim), "mlp1_b": (depth, dim),
              "mlp2_w": (depth, dim, dim), "mlp2_b": (depth, dim)}
    for k, t in zip(BLOCK_KEYS, tensors):
        _check_tensor(k, t, device, shapes[k])
    if depth < 1 or dim % 4 or dim > MAX_DIM:
        raise ValueError(f"flow_blocks: unsupported depth={depth} dim={dim} "
                         f"(dim must be a multiple of 4, at most {MAX_DIM})")
    if len(_checked) >= 16:
        _checked.pop(next(iter(_checked)))
    _checked[key] = (tensors, device, (dim, depth))
    return dim, depth


def _check(sy: torch.Tensor, h0: torch.Tensor, blocks: dict) -> tuple[int, int, int]:
    """(batch, dim, depth), or raise for what the kernel cannot take: device,
    dtype, shape, contiguity, 16-byte alignment."""
    dim, depth = _check_blocks(blocks, sy.device)
    batch = sy.shape[0]
    for name, t in (("sy", sy), ("h0", h0)):
        _check_tensor(name, t, sy.device, (batch, dim))
    if batch < 1:
        raise ValueError(f"flow_blocks: unsupported batch={batch}")
    return batch, dim, depth


def flow_blocks(sy: torch.Tensor, h0: torch.Tensor, blocks: dict) -> torch.Tensor:
    """Run the stacked ResBlock chain.

    sy: silu(y) [B, dim] (y is shared across blocks); h0: input-projection
    output [B, dim]; blocks: stacked params [depth, ...].  Returns h [B, dim] f32.
    """
    if sy.device.type == "cpu":
        return flow_blocks_reference(sy, h0, blocks)
    if sy.device.type != "cuda":
        raise ValueError(f"flow_blocks: unsupported device {sy.device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (sy, h0, *blocks.values())):
        # the launch goes through raw pointers: its output has no grad_fn
        raise RuntimeError("flow_blocks: the CUDA kernel has no backward; under autograd call "
                           "the plain chain, kernels.flow_blocks.flow_blocks_reference")
    batch, dim, depth = _check(sy, h0, blocks)
    lib = _load()
    plan = _plan_for(batch, dim, depth, sy.device, lib)
    out = torch.empty_like(h0)
    # mod [depth, B, 3 dim], u [B, dim] and the grid barrier's words (zeroed by the C entry)
    n_mod = depth * 3 * batch * dim
    scratch = torch.empty(n_mod + batch * dim + 4, dtype=torch.float32, device=sy.device)
    mod, u, bar = scratch[:n_mod], scratch[n_mod:-4], scratch[-4:]
    with torch.cuda.device(sy.device):
        stream = torch.cuda.current_stream(sy.device).cuda_stream
        err = lib.pt_flow_blocks_f32(
            sy.data_ptr(), h0.data_ptr(), *(blocks[k].data_ptr() for k in BLOCK_KEYS),
            mod.data_ptr(), u.data_ptr(), out.data_ptr(), bar.data_ptr(), batch, dim, depth,
            plan.grid, plan.rows, plan.slots, plan.mrows, plan.mslots, plan.group, plan.tile,
            plan.smem, stream)
    if err != 0:
        raise RuntimeError(f"flow_blocks: CUDA launch failed with error {err} "
                           f"(batch={batch} dim={dim} depth={depth} {plan})")
    with _count_lock:
        flow_blocks.launches += 1
    return out


flow_blocks.launches = 0
