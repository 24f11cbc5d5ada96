"""The port against FROZEN fixtures from the original PyTorch model
(tests/golden/parity_small.npz): the oracle's state dicts load through the
port's converters, and the Mimi batch encode, the Mimi streaming decode and
the FlowLM trajectory must match the oracle's outputs — the bounds of
tests/test_frozen_parity.py (2e-4 Mimi latents and audio, 5e-4 FlowLM
latents and EOS logits).  This ties the port to the
original model, not only to the JAX package."""

import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

from pocket_tts_tpu_torch import weights
from pocket_tts_tpu_torch.config import Config, MimiConfig, config_from_dict
from pocket_tts_tpu_torch.models import flow_lm, flow_mlp, mimi, transformer
from tests.parity_configs import FLOW_CFG, SMALL_MIMI

torch.set_num_threads(1)
FIXTURE = Path(__file__).parent / "golden" / "parity_small.npz"


@pytest.fixture(scope="module")
def fx():
    return np.load(FIXTURE)


def _sub(fx, prefix: str) -> dict:
    return {k[len(prefix):]: fx[k] for k in fx.files if k.startswith(prefix)}


def maxdiff(a, b):
    return float(np.max(np.abs(np.asarray(a) - np.asarray(b))))


def _mimi_params(fx):
    plans = mimi.MimiPlans(config_from_dict(dataclasses.asdict(SMALL_MIMI), MimiConfig))
    sd = {f"mimi.{k}": v for k, v in _sub(fx, "mimi_sd.").items()}
    return plans, weights.convert_mimi(sd, plans)


def test_mimi_encode_matches_frozen_oracle(fx):
    plans, p = _mimi_params(fx)
    got = mimi.encode_to_latent(p, plans, torch.from_numpy(fx["mimi_audio"]), block=16)
    ref = fx["mimi_ref_latent"]
    assert got.shape == ref.shape
    assert maxdiff(got.numpy(), ref) < 2e-4


def test_mimi_streaming_decode_matches_frozen_oracle(fx):
    plans, p = _mimi_params(fx)
    latents = fx["mimi_dec_latents"]
    st = mimi.init_decode_state(plans, 1)
    gots = []
    for i in range(latents.shape[-1]):
        y, st = mimi.decode_step(p, plans, st, torch.from_numpy(latents[..., i:i + 1]))
        gots.append(y.numpy())
    got = np.concatenate(gots, -1)
    ref = fx["mimi_ref_audio"]
    assert got.shape == ref.shape
    assert maxdiff(got, ref) < 2e-4


def test_flow_lm_trajectory_matches_frozen_oracle(fx):
    cfg = config_from_dict(dataclasses.asdict(FLOW_CFG), Config)
    tcfg = cfg.flow_lm.transformer
    p = weights.convert_flow_lm(_sub(fx, "flow_sd."), cfg)
    kc, vc = transformer.init_cache(tcfg.num_layers, 1, 64, tcfg.num_heads, tcfg.head_dim)
    pos = torch.zeros((1,), dtype=torch.int32)
    kc, vc, pos = flow_lm.prefill(p, cfg, kc, vc, pos, torch.from_numpy(fx["flow_cond"]),
                                  torch.tensor([6], dtype=torch.int32))
    emb = flow_lm.embed_text(p, torch.from_numpy(fx["flow_tokens"]))
    kc, vc, pos = flow_lm.prefill(p, cfg, kc, vc, pos, emb,
                                  torch.tensor([4], dtype=torch.int32))

    table = flow_mlp.time_embedding_table(p["flow"], 2)
    latent = p["bos_emb"].expand(1, 16)
    noise = torch.zeros((1, 16))
    got_latents, got_eos = [], []
    for _ in range(fx["flow_ref_latents"].shape[0]):
        latent, eos_logit, kc, vc, pos = flow_lm.step(p, cfg, kc, vc, pos, latent, noise,
                                                      table, lsd_decode_steps=2)
        got_latents.append(latent.numpy())
        got_eos.append(float(eos_logit[0]))

    assert maxdiff(np.concatenate(got_latents, 0), fx["flow_ref_latents"]) < 5e-4
    assert maxdiff(np.asarray(got_eos), fx["flow_ref_eos"]) < 5e-4
