"""Distributed runtime of the port: so far only straggler mitigation.

`StragglerMonitor` (a copy of the reference's
``repro.distributed.straggler``) plans weighted microbatches over
data-parallel groups from the paper's §3.1.1 model
(`repro_torch.core.distributed_model`).  It is numpy only and needs no
card or process group.  The rest of the reference's
``repro.distributed`` is not ported yet: the train step and gradient
compression are ROADMAP A.4 (LM training on one card), the sharding
rules, FSDP, pipeline, activation and elastic modules A.5
(multi-device).
"""
from repro_torch.distributed.straggler import StragglerMonitor

__all__ = ["StragglerMonitor"]
