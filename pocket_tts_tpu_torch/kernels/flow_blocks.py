"""Flow block chain: the Hopper port of the Pallas TPU kernel
``pocket_tts_tpu/ops/pallas/flow_kernel.py`` (``flow_blocks``).

``flow_blocks(sy, h0, blocks)`` runs the ``depth`` stacked AdaLN ResBlocks of
the SimpleMLPAdaLN flow net.  On CUDA tensors it launches the hand-written
kernel in ``csrc/flow_blocks.cu`` (built with ``nvcc`` for ``sm_90a`` at first
use into ``build/pocket_tts_tpu_torch/`` and loaded with ``ctypes``), or
raises.  On CPU tensors it runs :func:`flow_blocks_reference`, the plain
PyTorch version of the same function.

``flow_blocks.launches`` counts the kernel launches made through the wrapper
(one per call, each call being 1 + 2 * depth CUDA launches on one stream).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch
import torch.nn.functional as F

from pocket_tts_tpu_torch.ops.norms import layer_norm

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "flow_blocks.cu"
BUILD_DIR = _PKG.parent / "build" / "pocket_tts_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

BLOCK_KEYS = ("ada_w", "ada_b", "ln_w", "ln_b", "mlp1_w", "mlp1_b", "mlp2_w", "mlp2_b")
MAX_DIM = 1024  # kMaxChunks * 128 in the kernel
MAX_SMEM_BYTES = 227 * 1024  # per-CTA shared memory on Hopper (z holds batch * dim f32)

_lock = threading.Lock()
_lib = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): "
                       "cannot build the flow_blocks CUDA kernel")


def build() -> Path:
    """Compile ``csrc/flow_blocks.cu`` into a shared library named by the
    source's hash (a changed source never reuses a stale build).  Raises if
    ``nvcc`` is missing or fails."""
    src = SOURCE.read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib_path = BUILD_DIR / f"libflow_blocks_{digest}.so"
    if lib_path.exists():
        return lib_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{' '.join(cmd)}\n"
                           f"{res.stdout}\n{res.stderr}")
    os.replace(tmp, lib_path)
    return lib_path


def _load():
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            fn = lib.pt_flow_blocks_f32
            fn.argtypes = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
            _lib = lib
    return _lib


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


def _check(sy: torch.Tensor, h0: torch.Tensor, blocks: dict) -> tuple[int, int, int]:
    depth, _, dim = blocks["ada_w"].shape
    batch = sy.shape[0]
    shapes = {"ada_w": (depth, 3 * dim, dim), "ada_b": (depth, 3 * dim),
              "ln_w": (depth, dim), "ln_b": (depth, dim),
              "mlp1_w": (depth, dim, dim), "mlp1_b": (depth, dim),
              "mlp2_w": (depth, dim, dim), "mlp2_b": (depth, dim)}
    named = {"sy": (sy, (batch, dim)), "h0": (h0, (batch, dim)),
             **{k: (blocks[k], shapes[k]) for k in BLOCK_KEYS}}
    for name, (t, shape) in named.items():
        if t.device != sy.device:
            raise ValueError(f"flow_blocks: {name} on {t.device}, sy on {sy.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"flow_blocks: {name} is {t.dtype}; the kernel takes float32 only")
        if tuple(t.shape) != shape:
            raise ValueError(f"flow_blocks: {name} has shape {tuple(t.shape)}, expected {shape}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"flow_blocks: {name} must be contiguous and 16-byte aligned")
    if depth < 1 or batch < 1 or dim % 4 or dim > MAX_DIM:
        raise ValueError(f"flow_blocks: unsupported depth={depth} batch={batch} dim={dim} "
                         f"(dim must be a multiple of 4, at most {MAX_DIM})")
    if batch * dim * 4 > MAX_SMEM_BYTES:
        raise ValueError(f"flow_blocks: batch {batch} x dim {dim} exceeds shared memory")
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
    batch, dim, depth = _check(sy, h0, blocks)
    lib = _load()
    out = torch.empty_like(h0)
    mod = torch.empty((depth, batch, 3 * dim), dtype=torch.float32, device=sy.device)
    u = torch.empty((batch, dim), dtype=torch.float32, device=sy.device)
    with torch.cuda.device(sy.device):
        stream = torch.cuda.current_stream(sy.device).cuda_stream
        err = lib.pt_flow_blocks_f32(
            sy.data_ptr(), h0.data_ptr(), *(blocks[k].data_ptr() for k in BLOCK_KEYS),
            mod.data_ptr(), u.data_ptr(), out.data_ptr(), batch, dim, depth, stream)
    if err != 0:
        raise RuntimeError(f"flow_blocks: CUDA launch failed with error {err} "
                           f"(batch={batch} dim={dim} depth={depth})")
    flow_blocks.launches += 1
    return out


flow_blocks.launches = 0
