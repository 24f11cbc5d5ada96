"""Fine-tune data preparation: (text, audio) pairs -> training batches (port
of ``pocket_tts_tpu/training/data.py``).

The checkpoint's Mimi has no encode-side 32-dim bottleneck: the quantizer
only carries the decode projection 32 -> 512.  Targets are its
least-squares preimage, ``z32 = pinv(W) @ encode_to_latent(audio)``,
normalized to the FlowLM's output space, ``(z32 - emb_mean) / emb_std``.
The encoder runs on the model's device; batches come back as host numpy.
"""

from __future__ import annotations

import numpy as np
import torch

from pocket_tts_tpu_torch.models import mimi
from pocket_tts_tpu_torch.ops.qtensor import QTensor


def latent_preimage_matrix(params: dict) -> np.ndarray:
    """[32, 512] pseudo-inverse of the quantizer's output projection (a
    quantized one is dequantized first)."""
    w = params["mimi"]["quantizer_w"]
    if isinstance(w, QTensor):
        w = w.dequant()
    w = w.detach().float().cpu().numpy()[:, :, 0]  # [512, 32]
    return np.linalg.pinv(w)


def _frame_batch(model, wavs: list[np.ndarray]) -> tuple[torch.Tensor, list[int]]:
    """Waveforms -> [B, 1, frames * frame_size] zero-padded on the device,
    and each one's frame count (a partial frame rounds up)."""
    frame = model.engine.frame_size
    frames = [max(1, int(np.ceil(len(w) / frame))) for w in wavs]
    batch = np.zeros((len(wavs), 1, max(frames) * frame), np.float32)
    for i, w in enumerate(wavs):
        batch[i, 0, : len(w)] = np.asarray(w, np.float32)
    eng = model.engine
    return torch.from_numpy(batch).to(eng.device, eng.codec_dtype), frames


@torch.no_grad()
def encode_latent_targets(model, wavs: list[np.ndarray]) -> tuple[np.ndarray, np.ndarray]:
    """Mono float32 waveforms at ``model.sample_rate`` -> (normalized target
    latents [B, Tf_max, 32] float32, latent_valid [B] int32)."""
    eng = model.engine
    audio, frames = _frame_batch(model, wavs)
    pinv = torch.from_numpy(latent_preimage_matrix(model.params)).to(eng.device)
    z512 = mimi.encode_to_latent(eng.params["mimi"], eng.plans, audio)
    z32 = torch.einsum("bct,lc->btl", z512.float(), pinv)
    fl = eng.params["flow_lm"]
    latents = (z32 - fl["emb_mean"].float()) / fl["emb_std"].float()
    return latents.cpu().numpy(), np.asarray(frames, np.int32)


@torch.no_grad()
def encode_voice_conditioning(model, wav: np.ndarray) -> np.ndarray:
    """Voice-prompt latents [1, Tv, 512] (the speaker projection's input, as
    ``get_voice_state`` conditions)."""
    eng = model.engine
    audio, _ = _frame_batch(model, [wav])
    z512 = mimi.encode_to_latent(eng.params["mimi"], eng.plans, audio)
    return z512.float().transpose(1, 2).cpu().numpy()


def make_batch(model, pairs: list[tuple[str, np.ndarray]], *, voice_wav: np.ndarray | None = None,
               max_tokens: int | None = None) -> dict:
    """(text, waveform) pairs -> a training batch of host numpy arrays.
    ``voice_wav`` prepends one shared voice prompt's conditioning to every
    example; ``max_tokens`` clips each text."""
    token_lists = [model.tokenizer.encode(t) for t, _ in pairs]
    if max_tokens is not None:
        token_lists = [ids[:max_tokens] for ids in token_lists]
    tt = max(1, max(len(ids) for ids in token_lists))
    tokens = np.zeros((len(pairs), tt), np.int32)
    token_valid = np.zeros((len(pairs),), np.int32)
    for i, ids in enumerate(token_lists):
        tokens[i, : len(ids)] = ids
        token_valid[i] = len(ids)
    latents, latent_valid = encode_latent_targets(model, [w for _, w in pairs])
    batch = {"tokens": tokens, "token_valid": token_valid, "latents": latents,
             "latent_valid": latent_valid}
    if voice_wav is not None:
        voice = encode_voice_conditioning(model, voice_wav)
        batch["voice_latents"] = np.broadcast_to(voice, (len(pairs), *voice.shape[1:])).copy()
    return batch
