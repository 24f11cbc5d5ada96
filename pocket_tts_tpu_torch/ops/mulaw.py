"""G.711 mu-law transport codec for the device -> host audio wire (port of
``pocket_tts_tpu/ops/mulaw.py``).

``transport_format="mulaw"`` compands the int16 PCM to 8 bits on the device
(:func:`encode`, a handful of int32 elementwise ops), which halves the bytes
each chunk's fetch moves; the host decodes with a 256-entry table
(:func:`decode`).  ~35-38 dB SNR on speech; the float32 API is unchanged apart
from the companding.
"""

from __future__ import annotations

import numpy as np
import torch

_BIAS = 0x84  # 132
_CLIP = 32635


def encode(pcm16: torch.Tensor) -> torch.Tensor:
    """int16 PCM -> uint8 mu-law (G.711), elementwise, on the tensor's device.
    The exponent is the position of the highest set bit of |x| + BIAS above
    bit 7, counted with integer compares."""
    x = pcm16.to(torch.int32)
    sign = (x < 0).to(torch.int32) << 7
    mag = x.abs().clamp(0, _CLIP) + _BIAS  # [132, 32767]
    e = (mag >= (1 << 8)).to(torch.int32)
    for k in range(9, 15):
        e += (mag >= (1 << k)).to(torch.int32)
    mant = (mag >> (e + 3)) & 0x0F
    return (~(sign | (e << 4) | mant) & 0xFF).to(torch.uint8)


def _decode_table() -> np.ndarray:
    """256-entry mu-law -> int16 table (the midpoint of each encode step)."""
    u = ~np.arange(256, dtype=np.int32) & 0xFF
    sign = (u & 0x80) != 0
    e = (u >> 4) & 0x07
    mant = u & 0x0F
    mag = ((mant << 3) + (1 << 7) + (1 << 2) << e) - _BIAS
    return np.where(sign, -mag, mag).astype(np.int16)


DECODE_TABLE = _decode_table()


def decode(u8: np.ndarray) -> np.ndarray:
    """uint8 mu-law -> int16 PCM by table lookup (host side, numpy)."""
    return DECODE_TABLE[np.asarray(u8, dtype=np.uint8)]


def encode_np(pcm16: np.ndarray) -> np.ndarray:
    """numpy mirror of :func:`encode` (tests, host-side tools)."""
    x = np.asarray(pcm16, dtype=np.int32)
    sign = np.where(x < 0, 0x80, 0)
    mag = np.clip(np.abs(x), 0, _CLIP) + _BIAS
    e = sum((mag >= (1 << k)).astype(np.int32) for k in range(8, 15))
    mant = (mag >> (e + 3)) & 0x0F
    return (~(sign | (e << 4) | mant) & 0xFF).astype(np.uint8)
