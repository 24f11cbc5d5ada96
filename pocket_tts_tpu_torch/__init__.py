"""PyTorch/CUDA port of pocket-tts-tpu: streaming text-to-speech on one
NVIDIA GPU, with the flow block chain, decode attention and the quantized
linear as hand-written Hopper kernels."""

from pocket_tts_tpu_torch.config import (
    DEFAULT_EOS_THRESHOLD,
    DEFAULT_LSD_DECODE_STEPS,
    DEFAULT_NOISE_CLAMP,
    DEFAULT_TEMPERATURE,
    DEFAULT_VARIANT,
    Config,
    load_config,
    load_variant,
)
from pocket_tts_tpu_torch.tts import TTSModel, VoiceState

__version__ = "0.1.0"

__all__ = ["DEFAULT_EOS_THRESHOLD", "DEFAULT_LSD_DECODE_STEPS", "DEFAULT_NOISE_CLAMP",
           "DEFAULT_TEMPERATURE", "DEFAULT_VARIANT", "Config", "TTSModel", "VoiceState",
           "__version__", "load_config", "load_variant"]
