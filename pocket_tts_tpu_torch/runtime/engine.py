"""Generation engine around the model (port of
``pocket_tts_tpu/runtime/engine.py``, single-stream and batched).

* One state dict (FlowLM KV cache + cursor, previous latent, Mimi decode
  state) threads through everything; the cache is updated in place.
* ``decode_frames(K)`` runs K FlowLM frames in a Python loop, then ONE
  grouped Mimi decode over the K latents, and converts to int16 PCM — the
  grouping of the JAX package's ``_codec_impl``.  ``pos`` stays a device
  int32 [B] tensor: nothing in the frame loop waits for the device; the host
  reads audio and EOS flags once per chunk.  Per-slot temperature, EOS
  threshold, LSD step count and noise clamp vectors serve the continuous
  batcher (``runtime/batcher.py``).
* ``decode_segment`` decodes a whole B = 1 segment with the EOS stop rule:
  the host frame loop stops on EOS flags it reads asynchronously, then the
  codec runs in groups of 64 frames up to the last emitted one.
* Spans (``utils.span``): ``engine.frames`` around the frame loops of
  ``decode_frames`` and ``decode_segment`` (n: the frames added to
  ``frames_decoded``), ``engine.codec`` around their codec decodes (n: the
  frames decoded).
* ``admit_slot`` / ``admit_prefill_slot`` install a voice snapshot into one
  lane of a batched state and prefill that lane's text, writing that lane
  only, in place.
* Text prefill is bucketed on length (right-padded; padded positions are
  never written to the cache).
* Voice prompts go through the Mimi encoder and the speaker projection
  (``encode_voice``) and are prefilled as conditioning
  (``prefill_conditioning``), unpadded.
* Per-slot LoRA (``set_adapter_bank``): ``decode_frames(lora_w=)`` and
  ``admit_prefill_slot(lora_row=)`` mix each lane's adapter delta into the
  backbone products (on a mesh each tp rank its cut of the factors);
  without them the plain path runs.
* Narrow storage: int8 / int4 ``QTensor`` weights (scales cast to each
  leaf's dtype, ``q`` never), an fp8 KV cache (``kv_dtype``), and the mu-law
  wire (``transport_format="mulaw"``: encoded on the device, decoded on the
  host).
* Multi-device (``mesh=``, ``parallel/mesh.py``): params and state are
  placed by the sharding rules; dp group g runs lanes ``[g B/dp, (g+1)
  B/dp)`` on its own devices, each layer split over its tp ranks.  One host
  loop enqueues every group's launches in turn.
* The staged codec (``enable_staged_codec``): the Mimi decode of each chunk
  runs on another device, or on a CUDA stream of its own on the engine's
  device, chained to the frames by an event and one copy of the latents;
  on a mesh engine (B = 1) the frames run on the mesh and the codec on its
  own mesh of the engine's tp ranks, all on the codec's device.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import logging

import numpy as np
import torch

from pocket_tts_tpu_torch import utils
from pocket_tts_tpu_torch.config import Config
from pocket_tts_tpu_torch.models import flow_lm, flow_mlp, mimi, transformer
from pocket_tts_tpu_torch.models.mimi import MimiPlans
from pocket_tts_tpu_torch.ops import mulaw
from pocket_tts_tpu_torch.ops.attention import raw_view
from pocket_tts_tpu_torch.ops.conv import pad_for_frame
from pocket_tts_tpu_torch.ops.qtensor import QTensor, map_with_path
from pocket_tts_tpu_torch.parallel.mesh import (
    Mesh,
    Shards,
    gather,
    group_view,
    join_groups,
    shard_params,
    shard_state,
)

logger = logging.getLogger(__name__)

# decode_segment's host stop: every SEGMENT_POLL frames the loop enqueues a
# copy of the device's eos_step into pinned memory and records an event; it
# reads a copy once its event is done, and waits on the oldest unread copy
# when SEGMENT_MAX_LAG frames have been enqueued after it.  So at most
# SEGMENT_POLL + SEGMENT_MAX_LAG frames are computed past the stop.
SEGMENT_POLL = 4
SEGMENT_MAX_LAG = 12
# frames per codec decode of a fused segment (the JAX package's group)
CODEC_GROUP = 64


def _bucket(n: int, buckets: tuple[int, ...]) -> int:
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(f"{n} exceeds largest bucket {buckets[-1]}")


@dataclasses.dataclass
class GenParams:
    """Per-request generation knobs, validated at construction."""

    temp: float = 0.7
    lsd_decode_steps: int = 1
    noise_clamp: float | None = None
    eos_threshold: float = -4.0

    def __post_init__(self):
        if self.lsd_decode_steps < 1:
            raise ValueError(f"lsd_decode_steps must be >= 1, got {self.lsd_decode_steps}")
        if not self.temp >= 0.0:  # also rejects NaN
            raise ValueError(f"temp must be >= 0, got {self.temp}")
        if self.noise_clamp is not None:
            if self.noise_clamp != self.noise_clamp:
                raise ValueError("noise_clamp must not be NaN")
            if self.noise_clamp < 0:  # "< 0 = unclamped", the repo-wide convention
                self.noise_clamp = None


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(v, fn) for v in tree]
    return fn(tree)


def _clone(t: torch.Tensor) -> torch.Tensor:
    """A copy of a cache tensor (an fp8 one copied as its bytes)."""
    return raw_view(t).clone().view(t.dtype)


def _map2(dst, src, fn):
    """``fn(dst_leaf, src_leaf)`` over two trees of one structure."""
    if isinstance(dst, dict):
        for k in dst:
            _map2(dst[k], src[k], fn)
    elif isinstance(dst, list):
        for d, s in zip(dst, src):
            _map2(d, s, fn)
    else:
        fn(dst, src)


def _moved(w, device: torch.device):
    """A weight of a group view (a tensor, a QTensor, or ``Shards`` of
    either) with every piece on ``device``."""
    if isinstance(w, Shards):
        return Shards([p.to(device) for p in w.parts], w.dim)
    return w.to(device)


def place_params(params: dict, device: torch.device, dtype: torch.dtype,
                 codec_dtype: torch.dtype) -> dict:
    """Move params to ``device``: the backbone, input linear and text
    embedding go to ``dtype`` (bf16 on CUDA: they are the bytes streamed per
    frame), the codec to ``codec_dtype``.  The flow net, the output norm /
    EOS head and the latent statistics stay float32.  A QTensor moves its
    ``q`` as stored and casts its scale to the leaf's dtype.  The flow
    chain's stacked QTensor blocks are dequantized here, once, into the
    float32 stacks ``flow_blocks`` takes (the JAX package dequantizes them
    before every call, to the same values).
    Tensors already on ``device`` in their dtype are kept, not copied, so
    engines built from one placed dict share its tensors."""
    def cast(dt):
        def leaf(t):
            if isinstance(t, QTensor):
                return QTensor(t.q.to(device).contiguous(),
                               t.scale.to(device=device, dtype=dt).contiguous())
            return t.to(device=device, dtype=dt).contiguous()
        return leaf

    narrow = ("tf", "input_w", "text_embed")
    fl = {k: _map(v, cast(dtype if k in narrow else torch.float32))
          for k, v in params["flow_lm"].items()}
    fl["flow"]["blocks"] = {k: v.dequant() if isinstance(v, QTensor) else v
                            for k, v in fl["flow"]["blocks"].items()}
    return {"flow_lm": fl, "mimi": _map(params["mimi"], cast(codec_dtype))}


class Engine:
    """Generation for one (config, device, batch size).  ``params`` may be
    another engine's placed params: they are then shared, not copied.

    ``device`` defaults to ``cuda``.  With a ``mesh`` the engine's device is
    the mesh's ``[0, 0]`` (a ``device`` that differs raises), ``batch_size``
    must be a multiple of its dp, and the params are placed by
    ``shard_params``; ``new_state`` gives a sharded state."""

    def __init__(self, cfg: Config, params: dict, device: torch.device | str | None = None,
                 batch_size: int = 1, mesh: Mesh | None = None):
        self.cfg = cfg
        self.mesh = mesh
        if mesh is not None:
            lead = mesh.devices[0, 0]
            if device is not None and torch.device(device) != lead:
                raise ValueError(f"Engine: device {device} is not the mesh's first device {lead}")
            if batch_size % mesh.shape["dp"]:
                raise ValueError(f"Engine: batch_size {batch_size} is not a multiple of the "
                                 f"mesh's dp {mesh.shape['dp']}")
            device = lead
        self.device = torch.device("cuda" if device is None else device)
        self.batch = batch_size
        self.plans = MimiPlans(cfg.mimi)
        rcfg = cfg.runtime
        self._tcfg = cfg.flow_lm.transformer
        self._rcfg = rcfg
        self.ldim = cfg.mimi.quantizer.dimension
        self.frame_size = cfg.mimi.frame_size
        dt = rcfg.compute_dtype
        if dt == "auto":
            dt = "bfloat16" if self.device.type == "cuda" else "float32"
        self.dtype = getattr(torch, dt)
        kdt = dt if rcfg.kv_dtype == "auto" else rcfg.kv_dtype
        # finite-only e4m3 ("fn"), as the JAX package
        self.kv_dtype = {"float8_e4m3": torch.float8_e4m3fn,
                         "float8_e5m2": torch.float8_e5m2}.get(kdt) or getattr(torch, kdt)
        self.transport = rcfg.transport_format
        # The codec (decoder and voice encoder) runs in float32 on every
        # device: in bf16 its audio output keeps 8 mantissa bits (up to 64
        # int16 LSB at half scale), and the chunk grouping alone moved
        # samples by 32 LSB between generate and generate_stream on an H100;
        # in float32 they agree within 2 LSB.
        self.codec_dtype = torch.float32
        self.params = place_params(params, self.device, self.dtype, self.codec_dtype)
        # each dp group's params (group_view of the sharded tree on a mesh;
        # one device is one group) and its lead device
        self._views, self._leads = [self.params], [self.device]
        if mesh is not None:
            self.params = shard_params(self.params, mesh)
            self._views = [group_view(self.params, g) for g in range(mesh.shape["dp"])]
            self._leads = [mesh.lead(g) for g in range(mesh.shape["dp"])]
        # autoregressive frames computed by decode_frames (overshoot included),
        # and the flow-net evaluations they ran (each one flow_blocks call)
        self.frames_decoded = 0
        self.flow_evals = 0
        self._fresh_mimi1 = None  # read-only fresh B = 1 codec state (admission)
        self.adapter_bank = None  # set_adapter_bank
        self._lora_stacks = None
        # the staged codec (enable_staged_codec): its device, its Mimi params
        # there, its CUDA stream, and on a mesh the codec's own mesh (the
        # engine's tp ranks, each on the codec's device)
        self._codec_device = None
        self._mimi_params_staged = None
        self._codec_stream = None
        self._codec_mesh = None

    def set_adapter_bank(self, bank) -> None:
        """Attach a ``training.lora.AdapterBank``: its stacked factors are
        placed once in float32, for each dp group one dict per tp rank on
        that rank's device (one dict on one device).  A product split on tp
        gets its rank's cut: the column-parallel in_proj / ff1 their output
        rows of ``b`` (in_proj's of each of q, k, v), the row-parallel
        out_proj / ff2 their input columns of ``a``, whose deltas are
        partials that the layer's ``reduce_sum`` adds, since ``sum_r (x_r
        A_r^T) B^T = (x A^T) B^T``.  Dispatches opt in with a per-slot row
        (``decode_frames(lora_w=)``, ``admit_prefill_slot(lora_row=)``);
        those without one keep the plain path."""
        self.adapter_bank = bank
        stacks = {k: {n: torch.as_tensor(t).float() for n, t in f.items()}
                  for k, f in bank.stacks.items()}
        self._lora_stacks = [self._bank_ranks(stacks, g) for g in range(len(self._views))]

    def _bank_ranks(self, stacks: dict, g: int) -> list[dict]:
        """Dp group ``g``'s bank: one dict of factor stacks per tp rank of the
        group's products (the lead alone for a product not split)."""
        tf = self._views[g]["flow_lm"]["tf"]
        ranks = []
        for r in range(len(self.mesh.devices[g]) if self.mesh is not None else 1):
            rank = {}
            for name, f in stacks.items():
                w, a, b = tf[name], f["a"], f["b"]
                if isinstance(w, Shards):  # split on its rows (-2) or its columns (-1)
                    if w.dim - len(w.shape) == -2:
                        b = b.chunk(len(w), dim=-2)[r]
                    else:
                        a = a.chunk(len(w), dim=-1)[r]
                    dev = w.devices[r]
                elif r == 0:
                    dev = self._leads[g]
                else:
                    continue
                rank[name] = {"a": a.to(dev).contiguous(), "b": b.to(dev).contiguous()}
            ranks.append(rank)
        return ranks

    def _lora(self, rows, what: str):
        """(each dp group's bank, rows [B, N] on the device) for a dispatch
        with adapter rows."""
        if self._lora_stacks is None:
            raise ValueError(f"{what} requires set_adapter_bank() first")
        return self._lora_stacks, self.put(rows, torch.float32)

    # -- state -------------------------------------------------------------

    def _fresh_decode_state(self, batch: int = 1) -> dict:
        bos = self._views[0]["flow_lm"]["bos_emb"]
        return {"latent": bos.expand(batch, self.ldim).clone(),
                "mimi": self._fresh_mimi(batch)}

    def _fresh_mimi(self, batch: int) -> dict:
        """A fresh codec state, on the codec's device (made on the codec's
        stream, which alone reads it, and on a mesh placed on the codec's
        mesh) when the codec is staged."""
        if self._codec_device is None:
            return mimi.init_decode_state(self.plans, batch, self.codec_dtype, self.device)
        with (contextlib.nullcontext() if self._codec_stream is None
              else torch.cuda.stream(self._codec_stream)):
            st = mimi.init_decode_state(self.plans, batch, self.codec_dtype, self._codec_device)
            return st if self._codec_mesh is None else shard_state(st, self._codec_mesh)

    def new_state(self, batch: int | None = None) -> dict:
        """Empty state of ``batch`` lanes (default: the engine's batch size):
        zero cache, cursor 0; placed by ``shard_state`` on a mesh."""
        batch = batch or self.batch
        tcfg = self._tcfg
        kc, vc = transformer.init_cache(tcfg.num_layers, batch, self._rcfg.max_seq,
                                        tcfg.num_heads, tcfg.head_dim, self.kv_dtype,
                                        self.device)
        state = {"kc": kc, "vc": vc,
                 "pos": torch.zeros((batch,), dtype=torch.int32, device=self.device),
                 **self._fresh_decode_state(batch)}
        return state if self.mesh is None else self._shard(state)

    def _shard(self, state: dict) -> dict:
        """``state`` placed on the mesh; a staged codec's state stays on the
        codec's mesh, where ``_fresh_mimi`` placed it."""
        if state["pos"].shape[0] % self.mesh.shape["dp"]:
            raise ValueError(f"a state of {state['pos'].shape[0]} lanes on a mesh of dp "
                             f"{self.mesh.shape['dp']}")
        if self._codec_mesh is None:
            return shard_state(state, self.mesh)
        frames = shard_state({k: v for k, v in state.items() if k != "mimi"}, self.mesh)
        return {**frames, "mimi": state["mimi"]}

    def _groups(self, state: dict) -> list[dict]:
        """Each dp group's view of a state (its tp-split caches as Shards); on
        one device a shallow copy of the state, the one group."""
        if self.mesh is None:
            return [dict(state)]
        return [group_view(state, g) for g in range(self.mesh.shape["dp"])]

    def _join(self, state: dict, views: list[dict]) -> dict:
        """The state of ``state``'s placement whose group g is ``views[g]``."""
        return views[0] if self.mesh is None else join_groups(state, views)

    def _slot(self, state: dict, slot: int) -> tuple[int, slice]:
        """(group, lane within the group) of lane ``slot`` of ``state``."""
        lanes = state["pos"].shape[0]
        if not 0 <= slot < lanes:
            raise ValueError(f"slot {slot} outside the state's {lanes} lanes")
        per_group = lanes // len(self._leads)
        return slot // per_group, slice(slot % per_group, slot % per_group + 1)

    def _on_device(self, parts: list[torch.Tensor]) -> torch.Tensor:
        """The groups' outputs joined on the engine's device (one as it is)."""
        if len(parts) == 1:
            return parts[0]
        return torch.cat([p.to(self.device, non_blocking=True) for p in parts])

    def put(self, arr, dtype: torch.dtype) -> torch.Tensor:
        """Host array (or a tensor already on the device) -> tensor on the
        device.  On CUDA a host array is staged in pinned memory and its copy
        enqueued without waiting: a pageable or blocking copy would wait for
        every chunk already in flight."""
        if torch.is_tensor(arr):
            return arr.to(device=self.device, dtype=dtype)
        t = torch.as_tensor(np.asarray(arr), dtype=dtype)
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t

    def reset_for_segment(self, voice_state: dict) -> dict:
        """Per-segment restart from a voice state: the FlowLM cache is COPIED
        from the voice snapshot (decoding writes in place and must never touch
        the shared snapshot); latent and Mimi decoder start fresh, the Mimi
        state on the codec's device when it is staged.  On a mesh the copy is
        the snapshot placed by ``shard_state`` (a sharded snapshot is gathered
        first)."""
        if self.mesh is not None:
            vs = gather({k: voice_state[k] for k in ("kc", "vc", "pos")}, self.device)
            return self._shard({**vs, **self._fresh_decode_state(vs["pos"].shape[0])})
        return {"kc": _clone(voice_state["kc"]), "vc": _clone(voice_state["vc"]),
                "pos": voice_state["pos"].clone(), **self._fresh_decode_state()}

    # -- slot admission (continuous batching) --------------------------------

    def admit_slot(self, state: dict, slot: int, voice_state: dict) -> dict:
        """Install a B = 1 voice snapshot (kc, vc, pos) into lane ``slot`` of a
        batched state and reset that lane's latent and Mimi decoder.  Every
        write is in place and touches that lane only; on one stream it runs
        after the chunks already enqueued, which read the lane's old data.
        On a mesh the slot is lane ``slot % (B / dp)`` of group ``slot //
        (B / dp)``, and the unsharded snapshot's heads are copied to the
        ranks slice by slice."""
        if self._fresh_mimi1 is None:
            self._fresh_mimi1 = mimi.init_decode_state(self.plans, 1, self.codec_dtype,
                                                       self.device)
        g, lane = self._slot(state, slot)
        view = self._groups(state)[g]

        def install(dst, src: torch.Tensor, lane_axis: int) -> None:
            """``src`` into ``dst``'s lane (an fp8 cache as its bytes); each
            rank of a cache split on heads takes its heads of ``src``."""
            pairs = [(dst, src)]
            if isinstance(dst, Shards):
                pairs = zip(dst.parts, [_clone(p) for p in src.chunk(len(dst), dim=dst.dim)])
            for d, piece in pairs:
                raw_view(d).narrow(lane_axis, lane.start, 1).copy_(raw_view(piece),
                                                                   non_blocking=True)

        for name in ("kc", "vc"):  # [L, B, ...]
            install(view[name], voice_state[name], 1)
        install(view["pos"], voice_state["pos"], 0)
        install(view["latent"], self._views[g]["flow_lm"]["bos_emb"], 0)
        fresh, dec = self._fresh_mimi1, view["mimi"]
        for name in ("kc", "vc"):
            install(dec[name], fresh[name], 1)
        for name in ("up", "pos", "dec"):
            _map2(dec[name], fresh[name], lambda dst, src: install(dst, src, 0))
        return state

    def pad_token_row(self, tokens: np.ndarray) -> torch.Tensor:
        """[1, n] int32 -> [1, bucket] host row for ``admit_prefill_slot``
        (pinned on CUDA, so its upload at admission is enqueued, not waited
        for).  Safe from any thread."""
        bucket = _bucket(tokens.shape[1], self._rcfg.text_buckets)
        padded = torch.zeros((1, bucket), dtype=torch.int32)
        padded[:, : tokens.shape[1]] = torch.from_numpy(np.asarray(tokens, np.int32))
        return padded.pin_memory() if self.device.type == "cuda" else padded

    def admit_prefill_slot(self, state: dict, slot: int, voice_state: dict,
                           tokens_row: torch.Tensor, n_tokens: int,
                           lora_row: np.ndarray | None = None) -> dict:
        """``admit_slot`` plus this lane's text prefill at B = 1, on the
        lane's view of the batched cache (the prefill writes through the view
        into the shared buffer).  ``tokens_row``: from ``pad_token_row``.
        ``lora_row`` [N]: the lane's adapter row (its prefill runs through
        that adapter; needs ``set_adapter_bank``)."""
        lora, lora_w = (None, None) if lora_row is None else self._lora(
            np.asarray(lora_row, np.float32).reshape(1, -1), "lora_row")
        state = self.admit_slot(state, slot, voice_state)
        g, lane = self._slot(state, slot)
        view, params, dev = self._groups(state)[g], self._views[g]["flow_lm"], self._leads[g]

        def cut(c):  # the lane's view of a cache, on every rank when split on heads
            return Shards([p[:, lane] for p in c.parts], c.dim) if isinstance(
                c, Shards) else c[:, lane]

        emb = flow_lm.embed_text(params, tokens_row.to(dev, non_blocking=True))
        t_valid = torch.full((1,), n_tokens, dtype=torch.int32, device=dev)
        _, _, new_pos = flow_lm.prefill(params, self.cfg, cut(view["kc"]), cut(view["vc"]),
                                        view["pos"][lane], emb, t_valid,
                                        None if lora is None else lora[g], lora_w)
        view["pos"][lane].copy_(new_pos)
        return state

    # -- prefill -----------------------------------------------------------

    def _prefill(self, state: dict, emb: torch.Tensor, t_valid: torch.Tensor) -> dict:
        """``flow_lm.prefill`` of ``emb`` [B, T, E] (``t_valid`` [B]), each dp
        group's lanes on its own devices."""
        views = self._groups(state)
        per_group = emb.shape[0] // len(views)
        for g, v in enumerate(views):
            lanes, dev = slice(g * per_group, (g + 1) * per_group), self._leads[g]
            v["kc"], v["vc"], v["pos"] = flow_lm.prefill(
                self._views[g]["flow_lm"], self.cfg, v["kc"], v["vc"], v["pos"],
                emb[lanes].to(dev, non_blocking=True), t_valid[lanes].to(dev, non_blocking=True))
        return self._join(state, views)

    def prefill_tokens(self, state: dict, tokens: np.ndarray,
                       n_valid: int | np.ndarray | list) -> dict:
        """Prefill ``tokens`` [B, n] (right-padded to a text bucket).
        ``n_valid`` is one count for every lane or a per-lane [B] vector; a
        lane with 0 valid tokens writes nothing and keeps its position.
        Adapter rows never reach this prefill: a batched adapter request
        prefills through ``admit_prefill_slot``, and a voice state for one
        through the adapter's merged model."""
        b = tokens.shape[0]
        bucket = _bucket(tokens.shape[1], self._rcfg.text_buckets)
        padded = np.zeros((b, bucket), np.int32)
        padded[:, : tokens.shape[1]] = tokens
        emb = flow_lm.embed_text(self._views[0]["flow_lm"], self.put(padded, torch.int32))
        counts = np.asarray(n_valid, np.int32)
        if counts.ndim == 0:
            counts = np.full((b,), counts, np.int32)
        elif counts.shape != (b,):
            raise ValueError(f"prefill_tokens: n_valid of shape {counts.shape} for {b} lanes")
        return self._prefill(state, emb, self.put(counts, torch.int32))

    def prefill_conditioning(self, state: dict, cond: torch.Tensor, n_valid: int) -> dict:
        """Prefill the first ``n_valid`` frames of speaker conditioning
        ``cond`` [B, T, d_model] (float32; cast here to the backbone dtype)."""
        b = cond.shape[0]
        t_valid = torch.full((b,), n_valid, dtype=torch.int32, device=self.device)
        return self._prefill(state, cond.to(self.device, self.dtype), t_valid)

    # -- voice encoding ----------------------------------------------------

    @property
    def prompt_reserve(self) -> int:
        """Cache positions held back from voice conditioning: room for a text
        segment plus a typical generated segment (~15 s)."""
        return max(self._rcfg.text_buckets) + 192

    def _encode(self, audio: torch.Tensor) -> torch.Tensor:
        params = self._views[0]  # on a mesh: dp group 0, its tp ranks
        lat = mimi.encode_to_latent(params["mimi"], self.plans, audio,
                                    block=self._rcfg.encoder_block)
        return flow_lm.speaker_project(params["flow_lm"], lat.transpose(1, 2))

    def encode_voice(self, audio, cap: bool = True) -> tuple[torch.Tensor, int]:
        """24 kHz mono waveform [T] or [1, T] -> (conditioning
        [1, n_frames, d_model] float32 on the device, n_frames), with
        n_frames = ceil(T / 1920).

        Prompts up to the largest ``encode_seconds_buckets`` entry run one
        batch encode of the frame-padded waveform; longer ones run
        ``mimi.encode_step`` over ``voice_prompt_chunk_frames``-frame chunks
        with carried state, which bounds the encoder's memory.  Unlike the
        JAX package, nothing is padded to a bucket: the encoder is causal, so
        padding changed no valid frame there, and here the output holds
        exactly the valid frames.

        ``cap`` truncates the prompt to the cache budget (``max_seq`` minus
        ``prompt_reserve``) with a warning; ``cap=False`` encodes it whole."""
        audio = torch.as_tensor(np.asarray(audio, np.float32).reshape(1, 1, -1))
        max_frames = self._rcfg.max_seq - self.prompt_reserve
        if max_frames <= 0:
            raise ValueError(
                f"max_seq={self._rcfg.max_seq} leaves no room for voice prompts after "
                f"the generation reserve ({self.prompt_reserve} frames)")
        if cap and audio.shape[-1] > max_frames * self.frame_size:
            logger.warning("voice prompt %0.1f s exceeds the cache budget (%d frames); "
                           "truncating", audio.shape[-1] / self.cfg.mimi.sample_rate,
                           max_frames)
            audio = audio[..., : max_frames * self.frame_size]
        n_frames = -(-audio.shape[-1] // self.frame_size)
        audio = audio.to(device=self.device, dtype=self.codec_dtype)
        one_shot = int(self._rcfg.encode_seconds_buckets[-1] * self.cfg.mimi.sample_rate)
        if audio.shape[-1] <= one_shot:
            return self._encode(audio), n_frames
        return self._encode_chunked(audio), n_frames

    def _encode_chunked(self, audio: torch.Tensor) -> torch.Tensor:
        audio = pad_for_frame(audio, self.frame_size)
        samples = max(1, self._rcfg.voice_prompt_chunk_frames) * self.frame_size
        state = mimi.init_encode_state(self.plans, 1, self.codec_dtype, self.device)
        params, conds = self._views[0], []
        for start in range(0, audio.shape[-1], samples):
            lat, state = mimi.encode_step(params["mimi"], self.plans, state,
                                          audio[..., start:start + samples])
            conds.append(flow_lm.speaker_project(params["flow_lm"], lat.transpose(1, 2)))
        return torch.cat(conds, dim=1)

    # -- decode ------------------------------------------------------------

    def _pcm16(self, audio: torch.Tensor) -> torch.Tensor:
        """Codec output [B, 1, T] -> wire samples [B, T]: int16 PCM (clip to
        [-1, 1], scale by 32767, truncate toward zero), companded to uint8
        mu-law on the device when ``transport_format="mulaw"``."""
        a = audio[:, 0, :].float()
        pcm = (a.clamp(-1.0, 1.0) * 32767.0).to(torch.int16)
        return mulaw.encode(pcm) if self.transport == "mulaw" else pcm

    @property
    def wire_dtype(self) -> torch.dtype:
        return torch.uint8 if self.transport == "mulaw" else torch.int16

    def wire_to_float(self, arr) -> np.ndarray:
        """Fetched wire samples -> float32 in [-1, 1] (host side)."""
        a = np.asarray(arr)
        if self.transport == "mulaw":
            a = mulaw.decode(a)
        return a.astype(np.float32) / 32767.0

    def decode_frames(self, state: dict, n_frames: int, gen: GenParams,
                      generator: torch.Generator, *, temps=None, eos_thresholds=None,
                      lsd_vec: np.ndarray | None = None, clamp_vec=None,
                      lora_w=None) -> tuple[dict, torch.Tensor, torch.Tensor]:
        """K = ``n_frames`` autoregressive frames + one grouped codec decode.

        Every frame attends over the whole cache (masked past ``pos``), so a
        frame's arithmetic does not depend on how frames are grouped into
        chunks.  Returns (state, int16 audio [B, K * 1920], is_eos [B, K]),
        both fresh tensors on the device (never views of the state); on a mesh
        both on the engine's device (the mesh's first), the lanes of every dp
        group joined.  With a staged codec the audio is on the codec's device,
        ready for that device's current stream.

        ``temps`` / ``eos_thresholds``: optional per-slot [B] vectors (host
        arrays or device tensors) in place of ``gen``'s.  ``lsd_vec`` (host
        [B] ints, each >= 1) / ``clamp_vec`` ([B]; < 0 unclamped, 0 a hard
        zero): per-slot step counts and noise clamps, run as masked Euler
        steps up to the batch maximum (the output does not depend on it).
        ``lora_w`` [B, N]: per-slot adapter rows (needs ``set_adapter_bank``;
        a zero row is the base model)."""
        params = self._views[0]["flow_lm"]
        b = state["pos"].shape[0]
        lora, lora_w = (None, None) if lora_w is None else self._lora(lora_w, "lora_w")
        temp = gen.temp if temps is None else self.put(temps, torch.float32)
        eos_th = (gen.eos_threshold if eos_thresholds is None
                  else self.put(eos_thresholds, torch.float32)[:, None])
        if lsd_vec is not None or clamp_vec is not None:
            lsd = np.asarray(np.full((b,), gen.lsd_decode_steps) if lsd_vec is None
                             else lsd_vec, np.int64)
            if np.any(lsd < 1):
                # 0 would index the tables at -1 and emit raw noise as the latent
                raise ValueError(f"lsd_vec entries must be >= 1, got {lsd}")
            if clamp_vec is None:
                clamp_vec = np.full((b,), -1.0 if gen.noise_clamp is None else gen.noise_clamp)
            steps, clamped = int(lsd.max()), "vec"
            lsd_t = self.put(lsd, torch.int64)
            clamp = self.put(clamp_vec, torch.float32)
            tables = flow_mlp.time_embedding_tables(params["flow"], steps)
            table = tables[lsd_t - 1].transpose(0, 1)  # [steps, B, dim]
        else:
            steps, clamped, lsd_t, clamp = gen.lsd_decode_steps, None, None, gen.noise_clamp
            table = flow_mlp.time_embedding_table(params["flow"], steps)

        # each dp group (one on a single device) runs its lanes on its own
        # devices, the groups in turn; every frame's noise is one [B, ldim]
        # draw, split by group, so a mesh's lanes get the single device's draws
        views = self._groups(state)
        per_group = b // len(views)
        lanes = [slice(g * per_group, (g + 1) * per_group) for g in range(len(views))]
        per_lane = lsd_t is not None  # the [steps, B, dim] table of per-slot step counts
        tables = [(table[:, ln] if per_lane else table).to(d, non_blocking=True)
                  for ln, d in zip(lanes, self._leads)]
        lsds = [lsd_t[ln].to(d, non_blocking=True) if per_lane else None
                for ln, d in zip(lanes, self._leads)]
        lora_ws = [None if lora_w is None else lora_w[ln].to(d, non_blocking=True)
                   for ln, d in zip(lanes, self._leads)]
        latents, eos_logits = [[] for _ in views], [[] for _ in views]
        with utils.span("engine.frames", n_frames):
            for _ in range(n_frames):
                noise = flow_lm.sample_noise(generator, (b, self.ldim), temp, clamp, self.device,
                                             clamped=clamped)
                for g, v in enumerate(views):
                    v["latent"], eos_logit, _, _, v["pos"] = flow_lm.step(
                        self._views[g]["flow_lm"], self.cfg, v["kc"], v["vc"], v["pos"],
                        v["latent"], noise[lanes[g]].to(self._leads[g], non_blocking=True),
                        tables[g], steps, lsd_vec=lsds[g],
                        lora=None if lora is None else lora[g], lora_w=lora_ws[g])
                    latents[g].append(v["latent"])
                    eos_logits[g].append(eos_logit)
        audio = []
        with utils.span("engine.codec", n_frames):
            for g, v in enumerate(views):
                denorm = flow_lm.denormalize(self._views[g]["flow_lm"],
                                             torch.stack(latents[g], dim=1))  # [B, K, ldim]
                pcm, v["mimi"] = self._codec(g, v["mimi"], denorm)
                audio.append(pcm)
        self.frames_decoded += n_frames
        self.flow_evals += n_frames * steps
        is_eos = self._on_device([torch.stack(e, dim=-1) for e in eos_logits]) > eos_th
        return self._join(state, views), self._on_device(audio), is_eos

    def _codec(self, g: int, mimi_state: dict,
               denorm: torch.Tensor) -> tuple[torch.Tensor, dict]:
        """Dp group ``g``'s grouped Mimi decode of ``denorm`` [B, K, ldim] ->
        (wire audio [B, K * 1920], next codec state); on the staged codec's
        device and stream when it is staged (:meth:`enable_staged_codec`)."""
        if self._codec_device is None:
            audio, mimi_state = mimi.decode_step(self._views[g]["mimi"], self.plans, mimi_state,
                                                 denorm.transpose(1, 2))
            return self._pcm16(audio), mimi_state
        stream = self._codec_stream
        if stream is None:  # a CPU codec device: one stream of work
            lat = denorm.to(self._codec_device)
            audio, mimi_state = mimi.decode_step(self._mimi_params_staged, self.plans,
                                                 mimi_state, lat.transpose(1, 2))
            return self._pcm16(audio), mimi_state
        # the codec waits for the frames enqueued so far and decodes on its own
        # stream; the codec device's current stream, where the caller reads
        # the audio, then waits for the codec.  On another card the frames'
        # stream does not wait, so the next chunk's frames overlap this codec.
        stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(stream):
            lat = denorm.to(self._codec_device, non_blocking=True)
            if lat is denorm:  # read on the codec stream: not reused before it is done
                denorm.record_stream(stream)
            audio, mimi_state = mimi.decode_step(self._mimi_params_staged, self.plans,
                                                 mimi_state, lat.transpose(1, 2))
            pcm = self._pcm16(audio)
        reader = torch.cuda.current_stream(self._codec_device)
        reader.wait_stream(stream)
        pcm.record_stream(reader)
        return pcm, mimi_state

    def enable_staged_codec(self, codec_device: torch.device | str) -> None:
        """Stage parallelism: the frames on this engine's device, the Mimi
        codec on ``codec_device`` (the port of the JAX package's two-device
        pipeline).  Each ``decode_frames`` chunk's latents [B, K, 32] go to the
        codec after an event; the codec's Mimi params are placed there once,
        and ``reset_for_segment`` places each fresh Mimi state there.  The
        codec runs on a CUDA stream of its own; the codec device's current
        stream waits for it, so the audio is read as any other tensor.  On
        another card chunk N's codec overlaps chunk N+1's frames; on the
        engine's own card the stream keeps the codec's kernels apart and the
        next chunk's frames wait for it.

        On a mesh (dp 1, since the batch is 1) the frames run on the mesh and
        the codec runs the mesh's codec program, its tp ranks all on
        ``codec_device`` (the codec's own mesh: the same products and
        reductions in the same order), so its audio equals the unstaged mesh
        engine's.

        Single-stream engines only: the continuous batcher keeps the one
        program (its admission writes the Mimi state beside the cache).  The
        audio equals the unstaged chunk schedule's op for op."""
        if self.batch != 1:
            raise ValueError("staged codec supports batch_size=1 engines; the continuous "
                             "batcher keeps the fused program")
        dev = torch.device(codec_device)
        if dev.type != self.device.type:
            raise ValueError(f"staged codec: codec device {dev} and engine device {self.device} "
                             f"are of different types")
        self._codec_device = dev
        self._mimi_params_staged = map_with_path(self._views[0]["mimi"],
                                                 lambda _, w: _moved(w, dev))
        self._codec_stream = torch.cuda.Stream(dev) if dev.type == "cuda" else None
        if self.mesh is not None:
            devs = np.empty(self.mesh.devices.shape, dtype=object)
            devs.fill(dev)
            self._codec_mesh = Mesh(devs)

    def segment_bucket(self, max_frames: int) -> int | None:
        """The smallest ``segment_buckets`` entry covering ``max_frames``
        (None: too big for ``decode_segment``; callers take the chunk
        schedule)."""
        return next((b for b in self._rcfg.segment_buckets if max_frames <= b), None)

    @staticmethod
    def segment_groups(bucket: int, n_valid: int) -> list[tuple[int, int]]:
        """(first frame, frames) of each codec decode ``decode_segment`` runs:
        groups of ``min(CODEC_GROUP, bucket)`` frames that start below
        ``n_valid``, the last one cut at ``n_valid``."""
        group = min(CODEC_GROUP, bucket)
        return [(g, min(group, n_valid - g)) for g in range(0, n_valid, group)]

    def decode_segment(self, state: dict, gen: GenParams, generator: torch.Generator, *,
                       max_frames: int, frames_after_eos: int, bucket: int
                       ) -> tuple[dict, torch.Tensor, int, int]:
        """A whole B = 1 segment with the EOS stop rule: frames until
        ``n_valid = min(max_frames, eos_step + frames_after_eos)``, then the
        codec over those frames only.

        ``eos_step`` is the first frame whose EOS logit is above
        ``gen.eos_threshold``; it lives on the device and each frame updates
        it with ``torch.where``, so the frame loop never waits for the
        device.  The host learns it through ``_EosWatch``: on CUDA from a copy
        every ``SEGMENT_POLL`` frames, read once its event is done, which
        bounds the frames computed past the stop at ``SEGMENT_POLL +
        SEGMENT_MAX_LAG``; on the CPU it reads every frame (a read there waits
        for nothing), so the loop stops where the JAX package's while_loop
        does: at ``n_valid``, or at ``eos_step + 1`` when
        ``frames_after_eos`` is 0.  Frames past the stop count in
        ``frames_decoded`` / ``flow_evals`` and are never decoded by the
        codec.  The noise is one draw per frame from ``generator``, as in
        ``decode_frames``, so both paths agree at any temperature.

        The latents are denormalized and decoded in ``segment_groups``: the
        last group is decoded as it is, cut at ``n_valid`` (the codec is
        causal, so frames past ``n_valid`` change no emitted sample).
        ``bucket`` (at least ``max_frames``) sizes the latent buffer and the
        group.  Returns (state, wire audio [1, n_valid * 1920], n_valid,
        eos_step or -1), the two counts on the host."""
        if state["pos"].shape[0] != 1:
            raise ValueError("decode_segment decodes one lane (B = 1)")
        if not 0 < max_frames <= bucket:
            raise ValueError(f"decode_segment: max_frames {max_frames} outside (0, {bucket}]")
        if self._codec_device is not None:
            raise ValueError("decode_segment: a staged codec runs the chunk schedule "
                             "(decode_frames)")
        # on a mesh (dp 1 at B = 1): the one group's view, its layers split on tp
        view = self._groups(state)[0]
        params, mimi_params = self._views[0]["flow_lm"], self._views[0]["mimi"]
        steps = gen.lsd_decode_steps
        table = flow_mlp.time_embedding_table(params["flow"], steps)
        kc, vc, pos, latent = view["kc"], view["vc"], view["pos"], view["latent"]
        latents = torch.empty((bucket, 1, self.ldim), dtype=torch.float32, device=self.device)
        eos_step = torch.full((), -1, dtype=torch.int32, device=self.device)
        watch = _EosWatch(self.device, bucket, max_frames, frames_after_eos)
        i = 0
        with utils.span("engine.frames") as span:
            while i < watch.stop:
                noise = flow_lm.sample_noise(generator, (1, self.ldim), gen.temp,
                                             gen.noise_clamp, self.device)
                latent, eos_logit, _, _, pos = flow_lm.step(params, self.cfg, kc, vc, pos,
                                                            latent, noise, table, steps)
                latents[i].copy_(latent)
                eos_step = torch.where((eos_logit[0] > gen.eos_threshold) & (eos_step < 0), i,
                                       eos_step)
                i += 1
                watch.after_frame(i, eos_step)
            span.n = i
        n_valid = watch.finish(i, eos_step)
        self.frames_decoded += i
        self.flow_evals += i * steps
        lat_bct = flow_lm.denormalize(params, latents[:n_valid]).permute(1, 2, 0)  # [1, ldim, n]
        mimi_state, pcm = view["mimi"], []
        with utils.span("engine.codec", n_valid):
            for g, k in self.segment_groups(bucket, n_valid):
                audio, mimi_state = mimi.decode_step(mimi_params, self.plans, mimi_state,
                                                     lat_bct[:, :, g:g + k])
                pcm.append(self._pcm16(audio))
        audio = (torch.cat(pcm, dim=1) if pcm
                 else torch.zeros((1, 0), dtype=self.wire_dtype, device=self.device))
        new_state = {"kc": kc, "vc": vc, "pos": pos, "latent": latent, "mimi": mimi_state}
        return self._join(state, [new_state]), audio, n_valid, watch.eos_step

    def chunk_schedule(self, max_frames: int, low_latency: bool = True) -> list[int]:
        """Decode chunk sizes covering ``max_frames`` (the tail may overshoot;
        the host truncates).  ``low_latency``: warm-up ramp for fast first
        audio, then the largest chunk; otherwise the largest chunk from the
        start, with the tail right-sized."""
        schedule = list(self._rcfg.decode_chunks)
        out, total = [], 0
        i = len(schedule) - 1 if not low_latency else 0
        while total < max_frames:
            c = schedule[min(i, len(schedule) - 1)]
            remaining = max_frames - total
            if c > remaining:
                c = next(s for s in schedule if s >= remaining)
            out.append(c)
            total += c
            i += 1
        return out


class _EosWatch:
    """The host side of ``decode_segment``'s stop rule: which frame the loop
    stops at (``stop``) and the first EOS frame it has read (``eos_step``,
    -1 until one is read).

    ``after_frame(i, eos_step)`` runs after the i-th frame is enqueued.  Every
    ``poll`` frames (``SEGMENT_POLL`` on CUDA, 1 on the CPU) it enqueues a
    copy of the device's ``eos_step`` into a pinned host buffer and, on CUDA,
    records an event.  Copies are read in order: each as soon as its event is
    done, and the oldest one with a wait once ``SEGMENT_MAX_LAG`` frames have
    been enqueued after it.  The first copy that shows EOS at frame e is taken
    at most ``poll`` frames after e and read at most ``SEGMENT_MAX_LAG``
    frames after that, so the loop computes at most ``poll + SEGMENT_MAX_LAG``
    frames past ``min(max_frames, e + frames_after_eos)``.  ``event``:
    the event type (``torch.cuda.Event``; None on the CPU, where a copy is
    complete when ``copy_`` returns)."""

    def __init__(self, device: torch.device, bucket: int, max_frames: int,
                 frames_after_eos: int, *, poll: int | None = None, event=None):
        cuda = device.type == "cuda"
        self.poll = poll or (SEGMENT_POLL if cuda else 1)
        self.event = event or (torch.cuda.Event if cuda else None)
        self.host = torch.empty((bucket // self.poll + 1,), dtype=torch.int32, pin_memory=cuda)
        self.unread: collections.deque = collections.deque()  # (frames, slot, event)
        self.stop = max_frames
        self.max_frames = max_frames
        self.fae = frames_after_eos
        self.eos_step = -1

    def after_frame(self, i: int, eos_step: torch.Tensor) -> None:
        if self.eos_step >= 0:
            return
        if i % self.poll == 0:
            slot = i // self.poll
            self.host[slot].copy_(eos_step, non_blocking=True)
            ev = None
            if self.event is not None:
                ev = self.event()
                ev.record()
            self.unread.append((i, slot, ev))
        while self.unread and self.eos_step < 0:
            at, slot, ev = self.unread[0]
            if ev is not None and not ev.query():
                if i - at < SEGMENT_MAX_LAG:
                    return
                ev.synchronize()
            self.unread.popleft()
            self._read(int(self.host[slot]))

    def _read(self, e: int) -> None:
        if e >= 0:
            self.eos_step = e
            self.stop = min(self.max_frames, e + self.fae)
            self.unread.clear()

    def finish(self, i: int, eos_step: torch.Tensor) -> int:
        """``n_valid`` after the loop has computed ``i`` frames.  An EOS not
        read yet is read from the device here: one wait, after the last
        frame.  With ``frames_after_eos`` 0 the EOS frame itself was computed
        before the stop could show, and ``n_valid`` is clamped below it."""
        if self.eos_step < 0:
            self._read(int(eos_step))
        return i if self.eos_step < 0 else self.stop
