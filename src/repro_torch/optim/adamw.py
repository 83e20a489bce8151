"""AdamW with decoupled weight decay and global-norm clipping (twin of
``repro.optim.adamw``).

The same update as the reference: gradients in float32, clipped to a
global norm of ``max_grad_norm``; β = (0.9, 0.95); bias correction at
``step + 1`` in float32; weight decay on every leaf (the reference
excludes none).  Moments are float32 tensors keyed by the parameters'
paths (`repro_torch.utils.tree.flatten_with_paths`).

What differs, and why: the reference returns new arrays from donated
buffers; here `adamw_update` writes the parameters and both moments in
place under `torch.no_grad()`, which is what the donation buys it, and
clips one leaf at a time (the reference's ``clip_by_global_norm``
product, g · min(1, max_norm / norm)), so no second copy of every
gradient is held.  The returned state holds the same moment tensors and
a new step.

On a mesh the parameters, their gradients and both moments are DTensors
with the parameters' placements: the update runs on each leaf's local
shard, and the clip's norm is taken over every shard (`global_norm`).
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Tuple

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.launch.mesh import axis_info
from repro_torch.obs.tracing import train_span
from repro_torch.utils.tree import flatten_with_paths

Tensor = torch.Tensor
Params = Any


class AdamWState(NamedTuple):
    step: Tensor                 # 0-d int32
    mu: Dict[str, Tensor]
    nu: Dict[str, Tensor]


def adamw_init(params: Params) -> AdamWState:
    flat = flatten_with_paths(params)
    zeros = {k: torch.zeros_like(p, dtype=torch.float32, requires_grad=False)
             for k, p in flat.items()}
    device = next(iter(flat.values())).device if flat else None
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=device),
                      mu=zeros, nu={k: torch.zeros_like(z) for k, z in zeros.items()})


def _local(t: Tensor) -> Tensor:
    """A DTensor's local shard (a view of its storage), else ``t``."""
    return t.to_local() if isinstance(t, DTensor) else t


def global_norm(tree: Any) -> Tensor:
    """sqrt of the sum over leaves (in path order) of each leaf's float32
    sum of squares.

    DTensor leaves (a sharded train state) count every element once, over
    all shards: the local sums of leaves laid out alike are added, then
    summed over the mesh axes that shard them, never over the axes that
    replicate them."""
    leaves, groups = [], {}
    for x in flatten_with_paths(tree).values():
        sq = torch.sum(torch.square(_local(x).float()))
        if isinstance(x, DTensor):
            key = (x.device_mesh, tuple(x.placements))
            groups[key] = groups[key] + sq if key in groups else sq
        else:
            leaves.append(sq)
    for (mesh, placements), sq in groups.items():
        for name, pl in zip(mesh.mesh_dim_names, placements):
            group, n, _ = axis_info(mesh, name)
            if pl.is_shard() and n > 1:
                sq = sq.clone()
                dist.all_reduce(sq, group=group)
        leaves.append(sq)
    return torch.sqrt(sum(leaves))


@torch.no_grad()
def adamw_update(
    grads: Dict[str, Tensor],
    state: AdamWState,
    params: Params,
    *,
    lr: Tensor,
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.1,
    max_grad_norm: float = 1.0,
) -> Tuple[Params, AdamWState, Dict[str, Tensor]]:
    """One AdamW step: ``params`` (a `Params` module or a tree of tensors)
    and the moments are updated in place; ``grads`` holds one tensor per
    parameter path."""
    flat = flatten_with_paths(params)
    if set(grads) != set(flat):
        raise KeyError(f"grads and params differ: "
                       f"{sorted(set(grads) ^ set(flat))[:5]}")
    grads = {k: g.float() for k, g in grads.items()}
    gnorm = global_norm(grads)
    scale = torch.clamp(max_grad_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    step = state.step + 1
    stepf = step.float()
    # The β tensors are copied from host scalars, from pageable memory:
    # the host waits for the card here (span ``train.sync``).
    with train_span("train.sync"):
        b1t = torch.tensor(b1, dtype=torch.float32, device=stepf.device)
        b2t = torch.tensor(b2, dtype=torch.float32, device=stepf.device)
    bc1 = 1 - torch.pow(b1t, stepf)
    bc2 = 1 - torch.pow(b2t, stepf)
    for k, p in flat.items():
        # Each leaf's shard on its own: the update is elementwise.
        p = _local(p)
        g, m, v = _local(grads[k]) * scale, _local(state.mu[k]), _local(state.nu[k])
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * g * g)
        u = (m / bc1) / (torch.sqrt(v / bc2) + eps)
        p32 = p.float()
        u = u + weight_decay * p32
        p.copy_((p32 - lr * u).to(p.dtype))
    return params, AdamWState(step, state.mu, state.nu), {"grad_norm": gnorm}
