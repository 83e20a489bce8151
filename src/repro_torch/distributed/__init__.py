"""Distributed runtime of the port (twin of ``repro.distributed``):
sharding rules, train/serve steps, PP, elastic, straggler mitigation,
gradient compression.

`make_train_step` / `init_train_state` (`repro_torch.distributed.trainstep`)
train any decoder LM on one card or, on a `torch.distributed` mesh
(`repro_torch.launch.mesh`), sharded by the rules of
`repro_torch.distributed.sharding`; `activations` and `fsdp` hold the
layouts the layers compute in on a mesh, `pipeline` the GPipe schedule,
`elastic` recovery onto another mesh, `compression` the int8 gradient
transform and `compressed_psum`.  `StragglerMonitor` (a copy of the
reference's ``repro.distributed.straggler``) plans weighted microbatches
over data-parallel groups from the paper's §3.1.1 model
(`repro_torch.core.distributed_model`); it is numpy only.
"""
from repro_torch.distributed.sharding import (
    VARIANTS, batch_pspec, cache_shardings, input_shardings, param_pspec,
    shard_params,
)
from repro_torch.distributed.straggler import StragglerMonitor
from repro_torch.distributed.trainstep import (
    TrainState, init_train_state, make_serve_step, make_train_step,
)

__all__ = [
    "VARIANTS", "param_pspec", "shard_params", "input_shardings",
    "cache_shardings", "batch_pspec", "TrainState", "init_train_state",
    "make_train_step", "make_serve_step", "StragglerMonitor",
]
