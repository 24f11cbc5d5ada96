"""The system under test for a configuration with LFM2-MoE as the FlowLM
backbone: ``pocket_tts_tpu_torch`` built from the configuration file through
the port's own config (``config_from_dict``, its ``flow_lm.backbone`` read
from the file's top-level keys, the model's config.json) and the
benchmark's seeded weights.  Everything after the build is the flagship
system's (``pocket_tts_torch.py``)."""

from __future__ import annotations

from systems.pocket_tts_torch import free, gen_params, greedy, voice_state  # noqa: F401


def port_config(cfg: dict):
    """The port's Config; a program without the hybrid backbone (an older
    checkout, whose config would drop it unread) raises RuntimeError."""
    from pocket_tts_tpu_torch.config import config_from_dict

    backbone = {"kind": cfg["model_type"],
                **{k: v for k, v in cfg.items() if not isinstance(v, (dict, str))}}
    out = config_from_dict({"flow_lm": {**cfg["flow_lm"], "backbone": backbone},
                            "mimi": cfg["mimi"], "runtime": cfg["runtime"]})
    if getattr(out.flow_lm, "backbone", None) is None:
        raise RuntimeError(f"this pocket_tts_tpu_torch has no {cfg['model_type']} FlowLM "
                           "backbone")
    return out


def build(cfg: dict, weights: dict, device, seed: int):
    """A ``TTSModel`` on ``weights``."""
    from pocket_tts_tpu_torch.tts import TTSModel

    return TTSModel(port_config(cfg), weights, gen=gen_params(cfg), has_real_weights=False,
                    device=device, seed=seed % (2 ** 63))
