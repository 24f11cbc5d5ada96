"""Fine-tuning (port of ``pocket_tts_tpu/training``): a flow-matching
fine-tune of the FlowLM against (text, audio) pairs with the Mimi codec
frozen (``loss``), its data preparation (``data``), the optimizer, step and
artifacts (``trainer``), and LoRA adapters with the per-slot adapter bank
(``lora``).  On a dp x tp mesh the batch is split by ``shard_batch`` and
``finetune(mesh=)`` trains on the mesh (``parallel/mesh.py``)."""

from pocket_tts_tpu_torch.training.data import (
    encode_latent_targets,
    latent_preimage_matrix,
    make_batch,
)
from pocket_tts_tpu_torch.training.loss import flow_matching_loss
from pocket_tts_tpu_torch.training.lora import (
    apply_lora,
    init_lora,
    load_lora_params,
    make_lora_train_step,
    merge_lora,
    save_lora_params,
)
from pocket_tts_tpu_torch.training.trainer import (
    apply_adapted,
    apply_finetuned,
    finetune,
    load_finetuned_params,
    make_optimizer,
    make_train_step,
    save_finetuned_params,
    shard_batch,
)

__all__ = [
    "encode_latent_targets",
    "latent_preimage_matrix",
    "make_batch",
    "flow_matching_loss",
    "make_optimizer",
    "make_train_step",
    "finetune",
    "shard_batch",
    "apply_adapted",
    "apply_finetuned",
    "save_finetuned_params",
    "load_finetuned_params",
    "init_lora",
    "merge_lora",
    "make_lora_train_step",
    "apply_lora",
    "save_lora_params",
    "load_lora_params",
]
