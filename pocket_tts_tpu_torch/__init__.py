"""PyTorch/CUDA port of pocket-tts-tpu: streaming text-to-speech on one
NVIDIA GPU, with the flow block chain as a hand-written Hopper kernel."""

from pocket_tts_tpu_torch.tts import TTSModel

__all__ = ["TTSModel"]
