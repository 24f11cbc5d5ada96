"""Routed experts of the LFM2-MoE backbone (``models/lfm2.py``): the
hand-written Hopper kernels of ``csrc/moe.cu`` and their plain versions.

No TPU kernel stands behind them: the JAX package has no mixture of
experts.  They were added because a layer's expert bank (32 experts of
3 x 2048 x 1792 bf16 weights, 705 MB) cannot be read whole per token, and
PyTorch has no operator that applies per-token chosen weights in place
without a host-side grouping (``nonzero``, per-expert counts) that would stop
the frame loop on the device.

* :func:`route` (``moe_router_kernel``, one CTA a token): the router's
  logits in float32, sigmoid scores, the top ``k`` of score + ``expert_bias``
  (ties to the lower id), the chosen scores normalised to sum 1
  (``norm_topk_prob``, with LFM2's 1e-6 in the denominator) times
  ``routed_scaling_factor``; it adds each valid token's picks to a device
  counter of routed slots per expert (``slots``).
* :func:`experts`: ``moe_up_kernel`` (gate and up rows of each chosen expert
  against its token, SwiGLU, into a float32 scratch of [tokens x k, F]) then
  ``moe_down_kernel`` (each output row: the weighted sum over a token's k
  experts, in ascending expert id, rounded once into x's dtype).  Both read
  the experts' weights in place from the [E, ...] bank by the ids the router
  left on the device.  One token a launch (a B = 1 frame) is the
  ``<true>`` instantiation, which takes its k experts straight from the ids;
  more tokens (prefill, batched lanes) the ``<false>`` one, in which every
  CTA groups the slots by expert, so an expert's rows are read once a CTA
  for all the tokens routed to it.  No shape and no launch depends on the
  routing, nothing is read back by the host, and a token's output does not
  depend on the other tokens.

CPU tensors run the plain versions (:func:`route_reference`,
:func:`experts_reference`); a CUDA call the kernels cannot take raises.
``route.launches`` / ``experts.launches`` count the kernel launches (the
experts' two a call).
"""

from __future__ import annotations

import ctypes
import threading

import torch
import torch.nn.functional as F

from pocket_tts_tpu_torch.kernels import build as build_mod

SOURCE = build_mod.PKG / "csrc" / "moe.cu"
WARPS = 8  # rows of the weights a CTA takes, one a warp (kWarps)
CHUNK = 256  # elements of a row that one pass of a warp reads (32 lanes x 8 bf16)
MAX_EXPERTS = 64  # kMaxExperts
MAX_TOPK = 8  # kMaxTopk
MAX_SLOTS = 2048  # token x k slots a grouped launch sorts (kMaxSlots)
MAX_TOKENS = 512  # tokens a grouped launch accumulates (kMaxTokens)
NORM_EPS = 1e-6  # in the denominator of the normalised top-k weights, as LFM2's router

_lock = threading.Lock()
_count_lock = threading.Lock()
_lib = None


def build():
    """Compile ``csrc/moe.cu`` (see :func:`kernels.build.build`)."""
    return build_mod.build(SOURCE, "moe")


def _load():
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
            lib.pt_moe_route.argtypes = [p, ctypes.c_longlong, i, p, p, p, p, p, p, i, i, i, i,
                                         i, f, p]
            lib.pt_moe_experts.argtypes = [p, ctypes.c_longlong, p, p, p, p, p, p, i, i, i, i,
                                           i, p]
            lib.pt_moe_route.restype = lib.pt_moe_experts.restype = ctypes.c_int
            _lib = lib
    return _lib


def _count(fn, n: int) -> None:
    with _count_lock:
        fn.launches += n


# -- plain versions --------------------------------------------------------------------


def route_reference(x: torch.Tensor, router_w: torch.Tensor, bias: torch.Tensor | None,
                    topk: int, norm_topk: bool = True, scale: float = 1.0,
                    slots: torch.Tensor | None = None, valid: torch.Tensor | None = None
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """(ids int32 [M, k], weights float32 [M, k]) of tokens ``x`` [M, K] for
    ``router_w`` [E, K]: sigmoid scores in float32, the top k of score +
    ``bias``, the chosen scores normalised and scaled.  ``slots`` [E]: adds
    each token's picks, tokens where ``valid`` [M] is False left out."""
    scores = torch.sigmoid(x.float() @ router_w.float().T)
    ids = (scores if bias is None else scores + bias.float()).topk(topk, dim=-1).indices
    w = scores.gather(-1, ids)
    if norm_topk:
        w = w / (w.sum(-1, keepdim=True) + NORM_EPS)
    if slots is not None:
        ones = torch.ones_like(ids, dtype=slots.dtype)
        if valid is not None:
            ones = ones * valid.to(slots.dtype)[:, None]
        slots.index_add_(0, ids.flatten(), ones.flatten())
    return ids.int(), w * scale


def experts_reference(x: torch.Tensor, ids: torch.Tensor, w: torch.Tensor, up: torch.Tensor,
                      down: torch.Tensor) -> torch.Tensor:
    """sum_j w[m, j] * down[e] @ (silu(gate[e] @ x[m]) * (up[e] @ x[m])), e =
    ids[m, j], for x [M, K], the bank ``up`` [E, 2F, K] (gate rows, then up
    rows) and ``down`` [E, K, F]; float32 inside, x's dtype out.  The chosen
    experts' weights are gathered per token (no data-dependent shape)."""
    f = up.shape[1] // 2
    idx = ids.long()
    hu = torch.einsum("mk,mjok->mjo", x.float(), up[idx].float())
    h = F.silu(hu[..., :f]) * hu[..., f:]
    y = torch.einsum("mjf,mjof->mjo", h, down[idx].float())
    return (w.float()[..., None] * y).sum(1).to(x.dtype)


# -- kernels ---------------------------------------------------------------------------


def _refuse(what: str):
    raise ValueError(f"moe: {what}")


def route(x: torch.Tensor, router_w: torch.Tensor, bias: torch.Tensor | None, topk: int,
          norm_topk: bool = True, scale: float = 1.0, slots: torch.Tensor | None = None,
          valid: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`route_reference` (CPU) or ``moe_router_kernel`` (CUDA: x
    bfloat16 or float32 [M, K] with K % 4 == 0 and unit stride, ``router_w``
    float32 [E, K] contiguous, E <= 64, k <= 8, ``slots`` int64 [E],
    ``valid`` bool [M])."""
    if x.device.type == "cpu":
        return route_reference(x, router_w, bias, topk, norm_topk, scale, slots, valid)
    m, k_dim = x.shape
    e = router_w.shape[0]
    if not (x.dtype in (torch.bfloat16, torch.float32) and x.stride(1) == 1 and k_dim % 4 == 0
            and x.stride(0) % 4 == 0 and x.data_ptr() % 16 == 0):
        _refuse(f"route takes x bf16 / f32 [M, K] in 16-byte aligned rows of K % 4 == 0, got "
                f"{x.dtype} {tuple(x.shape)} strides {x.stride()}")
    if not (router_w.dtype == torch.float32 and router_w.is_contiguous()
            and router_w.shape == (e, k_dim) and 1 <= topk <= min(e, MAX_TOPK)
            and e <= MAX_EXPERTS):
        _refuse(f"route takes a float32 [E <= {MAX_EXPERTS}, K] router and k <= {MAX_TOPK}")
    for name, t, dt in (("bias", bias, torch.float32), ("slots", slots, torch.int64),
                        ("valid", valid, torch.bool)):
        if t is not None and not (t.dtype == dt and t.is_contiguous() and t.device == x.device):
            _refuse(f"{name} must be a contiguous {dt} tensor on {x.device}")
    ids = torch.empty((m, topk), dtype=torch.int32, device=x.device)
    w = torch.empty((m, topk), dtype=torch.float32, device=x.device)
    if m:
        with torch.cuda.device(x.device):
            err = _load().pt_moe_route(
                x.data_ptr(), x.stride(0), int(x.dtype == torch.bfloat16), router_w.data_ptr(),
                0 if bias is None else bias.data_ptr(), ids.data_ptr(), w.data_ptr(),
                0 if slots is None else slots.data_ptr(), 0 if valid is None else
                valid.data_ptr(), m, k_dim, e, topk, int(norm_topk), float(scale),
                torch.cuda.current_stream(x.device).cuda_stream)
        if err:
            raise RuntimeError(f"moe: router launch failed with CUDA error {err}")
        _count(route, 1)
    return ids, w


route.launches = 0


def experts(x: torch.Tensor, ids: torch.Tensor, w: torch.Tensor, up: torch.Tensor,
            down: torch.Tensor) -> torch.Tensor:
    """:func:`experts_reference` (CPU) or ``moe_up_kernel`` +
    ``moe_down_kernel`` (CUDA: x bf16 [M, K] with unit stride, ``up`` bf16
    [E, 2F, K] and ``down`` bf16 [E, K, F] contiguous, K and F multiples of
    256, ids int32 / w float32 [M, k] contiguous).  Tokens past
    :data:`MAX_TOKENS` or k x tokens past :data:`MAX_SLOTS` go in blocks of
    rows, one pair of launches each."""
    if x.device.type == "cpu":
        return experts_reference(x, ids, w, up, down)
    m, k_dim = x.shape
    e, two_f, _ = up.shape
    f, topk = two_f // 2, ids.shape[1]
    if not (x.dtype == torch.bfloat16 and up.dtype == down.dtype == torch.bfloat16
            and x.stride(1) == 1 and x.stride(0) % 8 == 0 and x.data_ptr() % 16 == 0):
        _refuse(f"experts take bf16 x [M, K] (unit stride, rows 16-byte aligned) and bf16 "
                f"banks, got x {x.dtype} {x.stride()}, banks {up.dtype} / {down.dtype}")
    if not (up.is_contiguous() and down.is_contiguous() and up.shape == (e, 2 * f, k_dim)
            and down.shape == (e, k_dim, f) and k_dim % CHUNK == 0 and f % CHUNK == 0
            and e <= MAX_EXPERTS):
        _refuse(f"experts take banks up [E, 2F, K], down [E, K, F], K and F multiples of "
                f"{CHUNK}, E <= {MAX_EXPERTS}; got {tuple(up.shape)} / {tuple(down.shape)}")
    if not (ids.dtype == torch.int32 and w.dtype == torch.float32 and ids.is_contiguous()
            and w.is_contiguous() and ids.shape == w.shape == (m, topk) and topk <= MAX_TOPK):
        _refuse(f"experts take ids int32 / w float32 [M, k <= {MAX_TOPK}]")
    y = torch.empty((m, k_dim), dtype=x.dtype, device=x.device)
    block = min(MAX_TOKENS, MAX_SLOTS // topk)
    h = torch.empty((min(m, block) * topk, f), dtype=torch.float32, device=x.device)
    lib, launches = _load(), 0
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        for r0 in range(0, m, block):
            r1 = min(m, r0 + block)
            err = lib.pt_moe_experts(
                x[r0:r1].data_ptr(), x.stride(0), ids[r0:r1].data_ptr(), w[r0:r1].data_ptr(),
                up.data_ptr(), down.data_ptr(), h.data_ptr(), y[r0:r1].data_ptr(), r1 - r0,
                k_dim, f, e, topk, stream)
            if err:
                raise RuntimeError(f"moe: expert launches failed with CUDA error {err} (M={m} "
                                   f"K={k_dim} F={f} E={e} k={topk})")
            launches += 2
    _count(experts, launches)
    return y


experts.launches = 0
