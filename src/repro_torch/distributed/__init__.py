"""Checkpointing, elastic recovery and sharding rules (the port of
``repro.distributed``)."""
from .checkpoint import (
    CheckpointManager,
    latest_step,
    restore_checkpoint,
    save_checkpoint,
)
from .elastic import reshard, run_with_recovery
from .sharding import (
    MeshAxes,
    batch_spec,
    index_shard_specs,
    lm_param_spec,
    mlp_param_spec,
    opt_state_specs,
    param_specs,
    zero1_specs,
)

__all__ = ["CheckpointManager", "MeshAxes", "batch_spec",
           "index_shard_specs", "latest_step", "lm_param_spec",
           "mlp_param_spec", "opt_state_specs", "param_specs", "reshard",
           "restore_checkpoint", "run_with_recovery", "save_checkpoint",
           "zero1_specs"]
