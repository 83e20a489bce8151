"""Elastic scaling + fault recovery orchestration (twin of
``repro.distributed.elastic``).

Recovery contract (1000+-node posture):
  * any step's data batch is a pure function of (seed, step) — no data
    state to restore;
  * checkpoints are atomic and carry mesh metadata;
  * on restart, `recover()` picks a mesh for the surviving device count
    (`elastic_mesh_shape`), reshards the checkpoint onto it, and resumes
    from the recorded step;
  * batch shards that no longer divide evenly fall back to replication
    (input_shardings handles it).

The device count is the default process group's world size (one process
per card, ``torchrun``); every rank calls `recover`.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional, Tuple

import torch.distributed as dist

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.distributed.sharding import shard_params
from repro_torch.launch.mesh import elastic_mesh_shape, make_mesh, mesh_shape
from repro_torch.utils.logging import get_logger

log = get_logger("repro.elastic")


@dataclass
class RecoveryPlan:
    mesh: Any
    step: int
    resumed: bool


def plan_mesh(n_devices: Optional[int] = None, *, model_parallel: int = 16,
              pods: int = 1, device_type: str = "cuda"):
    n = n_devices if n_devices is not None else dist.get_world_size()
    shape, axes = elastic_mesh_shape(n, model_parallel=model_parallel, pods=pods)
    return make_mesh(shape, axes, device_type)


def recover(ckpt: CheckpointManager, target_state, *, mesh=None,
            variant: str = "tp") -> Tuple[Any, RecoveryPlan]:
    """Restore the latest valid checkpoint onto `mesh` (or a planned one).

    `target_state` is a tree of tensors giving the expected structure
    (from init).  Returns (state, plan): every leaf of one or more dims a
    DTensor laid out by `shard_params` on the mesh.  plan.resumed=False
    when no checkpoint exists.
    """
    mesh = mesh if mesh is not None else plan_mesh()
    step = ckpt.latest_step()
    if step is None:
        log.info("no checkpoint found; cold start on mesh %s", mesh_shape(mesh))
        return target_state, RecoveryPlan(mesh, 0, False)
    shardings = shard_params(target_state, mesh, variant)
    state, meta = ckpt.restore(step, target=target_state, shardings=shardings)
    old_mesh = meta.get("mesh_shape")
    if old_mesh and tuple(old_mesh) != tuple(mesh_shape(mesh)):
        log.info("elastic reshard: checkpoint mesh %s → current %s",
                 old_mesh, mesh_shape(mesh))
    log.info("resumed from step %d", meta["step"])
    return state, RecoveryPlan(mesh, int(meta["step"]), True)
