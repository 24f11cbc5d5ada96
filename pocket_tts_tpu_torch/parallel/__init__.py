"""Multi-device serving and training: the dp x tp mesh (``mesh.py``)."""

from pocket_tts_tpu_torch.parallel.mesh import (
    Mesh,
    Shards,
    Sharded,
    Spec,
    Trainable,
    format_shard_report,
    make_mesh,
    masters,
    param_sharding_rules,
    reduce_sum,
    replicas,
    shard_params,
    shard_state,
    shard_trainable,
    sharding_manifest,
    state_sharding_rules,
)

__all__ = ["Mesh", "Shards", "Sharded", "Spec", "Trainable", "format_shard_report",
           "make_mesh", "masters", "param_sharding_rules", "reduce_sum", "replicas",
           "shard_params", "shard_state", "shard_trainable", "sharding_manifest",
           "state_sharding_rules"]
