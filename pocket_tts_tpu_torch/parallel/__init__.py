"""Multi-device serving: the dp x tp mesh (``mesh.py``)."""

from pocket_tts_tpu_torch.parallel.mesh import (
    Mesh,
    Shards,
    Sharded,
    Spec,
    format_shard_report,
    make_mesh,
    param_sharding_rules,
    reduce_sum,
    shard_params,
    shard_state,
    sharding_manifest,
    state_sharding_rules,
)

__all__ = ["Mesh", "Shards", "Sharded", "Spec", "format_shard_report", "make_mesh",
           "param_sharding_rules", "reduce_sum", "shard_params", "shard_state",
           "sharding_manifest", "state_sharding_rules"]
