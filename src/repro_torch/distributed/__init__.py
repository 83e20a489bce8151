"""Distributed runtime of the port: the train and serve steps on one card,
gradient compression and straggler mitigation.

`make_train_step` / `init_train_state` (`repro_torch.distributed.trainstep`)
train any decoder LM on one card; `compress_grads` is its int8 gradient
transform with error feedback.  `StragglerMonitor` (a copy of the
reference's ``repro.distributed.straggler``) plans weighted microbatches
over data-parallel groups from the paper's §3.1.1 model
(`repro_torch.core.distributed_model`); it is numpy only.  The rest of the
reference's ``repro.distributed`` (sharding rules, FSDP, pipeline,
activations, elastic, ``compressed_psum``) waits for the port's
multi-device slice.
"""
from repro_torch.distributed.straggler import StragglerMonitor
from repro_torch.distributed.trainstep import (
    TrainState, init_train_state, make_serve_step, make_train_step,
)

__all__ = ["StragglerMonitor", "TrainState", "init_train_state",
           "make_train_step", "make_serve_step"]
