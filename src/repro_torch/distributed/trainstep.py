"""Train and serve steps (twin of ``repro.distributed.trainstep``).

`make_train_step` builds the step for any decoder `Model`:
  * the loss and its gradient by autograd (the reference's
    ``jax.value_and_grad``); on the card every attention's and expert
    matmul's backward is a hand-written kernel (`repro_torch.kernels`),
    and each layer is recomputed in the backward (remat, as the
    reference's ``jax.checkpoint``);
  * microbatch accumulation: the batch is cut into ``microbatches`` equal
    parts along its first axis, the parts' gradients summed in float32 and
    divided by their number, the loss likewise; the metrics are then only
    ``loss``, ``lr`` and ``grad_norm``, as the reference's scan returns no
    per-microbatch metrics;
  * optional int8 gradient compression with error feedback;
  * AdamW at `linear_warmup_cosine` of the step *before* its increment,
    parameters and moments updated in place (the reference's donated
    buffers).

The state's parameters must require gradients (`init_train_state` turns
that on).

On a mesh (``mesh=``, or the ambient one of
`repro_torch.launch.mesh.use_mesh`) the step runs under it, one process
per rank: a state of plain tensors is first sharded by the variant's
rules (`shard_train_state`: parameters and both moments become DTensors
with the rules' placements); each rank takes its rows of the whole batch
over the data axes (`sharding.local_batch`); the layers gather their
leaves (`fsdp.gather_layer`), whose gradients come back averaged over the
data axes and cut to each leaf's shard; AdamW updates each shard and
clips by the norm over all of them; the reported loss and metrics are
the mean over the data axes.  Compression is not run on a mesh: its
int8 scale is a maximum over the whole leaf.

Spans (`repro_torch.obs.tracing`): a step is traced into ``obs``'s
tracer (default: `repro_torch.obs.default()`) while a torch.profiler
session records, or always when that tracer is enabled: ``train.step``
around the step, ``train.forward`` (the loss), ``train.backward``
(autograd, with every recompute and ``.bwd`` span of the model under
it), ``train.optimizer`` (the rate's schedule and `adamw_update`, whose
one wait for the card is ``train.sync``), one trace id a step.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch

import torch.distributed as dist

from repro_torch.distributed.compression import (
    CompressionState, compress_grads, compression_init,
)
from repro_torch.distributed.sharding import distribute_params, local_batch, shard_params
from repro_torch.launch.mesh import ambient_mesh, data_axes, use_mesh
from repro_torch.obs import default as default_obs
from repro_torch.obs.tracing import train_span, train_step as traced_step
from repro_torch.optim.adamw import AdamWState, adamw_init, adamw_update
from repro_torch.optim.schedules import linear_warmup_cosine
from repro_torch.utils.device import DeviceLike
from repro_torch.utils.tree import flatten_with_paths

Tensor = torch.Tensor
Params = Any


class TrainState(NamedTuple):
    params: Params
    opt: AdamWState
    comp: Optional[CompressionState]
    step: Tensor                  # 0-d int32


def trainable(params: Params) -> Params:
    """Turn ``requires_grad`` on for every floating leaf of ``params``."""
    for leaf in flatten_with_paths(params).values():
        if leaf.is_floating_point():
            leaf.requires_grad_(True)
    return params


def init_train_state(model, seed: int, *, compression: bool = False,
                     device: DeviceLike = "cuda") -> TrainState:
    """The model's own init from ``seed`` on ``device``, trainable, with
    zero AdamW moments (and compression residuals) and step 0."""
    return train_state_for(trainable(model.init(seed, device=device)),
                           compression=compression)


def train_state_for(params: Params, *, compression: bool = False) -> TrainState:
    """A fresh train state around existing (trainable) parameters."""
    opt = adamw_init(params)
    return TrainState(params=params, opt=opt,
                      comp=compression_init(params) if compression else None,
                      step=torch.zeros((), dtype=torch.int32, device=opt.step.device))


def _is_sharded(params: Params) -> bool:
    from torch.distributed.tensor import DTensor

    return any(isinstance(p, DTensor) for p in flatten_with_paths(params).values())


def shard_train_state(state: TrainState, mesh, variant: str = "tp") -> TrainState:
    """``state`` on ``mesh``, in place: its parameters made DTensors by the
    variant's rules (`distribute_params`), its AdamW moments DTensors with
    the same placements (each whole moment freed as its shard replaces
    it).  Every rank must hold the same whole state."""
    from torch.distributed.tensor import distribute_tensor

    if state.comp is not None:
        raise ValueError("gradient compression is not run on a mesh")
    shardings = shard_params(state.params, mesh, variant)
    distribute_params(state.params, mesh, variant, shardings)
    for moments in (state.opt.mu, state.opt.nu):
        for k, v in moments.items():
            moments[k] = distribute_tensor(v, mesh, shardings[k].placements)
    return state


def _data_mean(x: Tensor, mesh) -> Tensor:
    """The mean over the mesh's data axes of a per-rank value."""
    for name in data_axes(mesh):
        n = mesh.size(mesh.mesh_dim_names.index(name))
        if n > 1:
            x = x.clone()
            dist.all_reduce(x, group=mesh.get_group(name))
            x = x / n
    return x


def _split(batch: Dict[str, Tensor], n: int):
    for key, x in batch.items():
        if x.shape[0] % n:
            raise ValueError(f"batch {key!r} of {x.shape[0]} rows does not split "
                             f"into {n} microbatches")
    parts = {key: x.chunk(n) for key, x in batch.items()}
    return [{key: parts[key][i] for key in batch} for i in range(n)]


def make_train_step(
    model,
    *,
    base_lr: float = 3e-4,
    warmup_steps: int = 100,
    total_steps: int = 10000,
    weight_decay: float = 0.1,
    microbatches: int = 1,
    compression: bool = False,
    mesh=None,
    variant: str = "tp",
    obs=None,
) -> Callable[[TrainState, Dict[str, Any]], Tuple[TrainState, Dict[str, Any]]]:
    """The step; on ``mesh`` (default: the ambient mesh when the step
    runs) with the ``variant``'s rules, its spans into ``obs``'s tracer
    (see the module docstring)."""
    tracer = (obs if obs is not None else default_obs()).tracer

    def value_and_grad(params, leaves, batch):
        with train_span("train.forward"):
            loss, metrics = model.loss(params, batch)
        with train_span("train.backward"):
            grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
            grads = {k: torch.zeros_like(p) if g is None else g
                     for (k, p), g in zip(leaves.items(), grads)}
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads

    def train_step(state: TrainState, batch: Dict[str, Any]):
        on = mesh if mesh is not None else ambient_mesh()
        if on is None:
            return _step(state, batch)
        if compression:
            raise ValueError("gradient compression is not run on a mesh")
        if not _is_sharded(state.params):
            shard_train_state(state, on, variant)
        with use_mesh(on):
            state, metrics = _step(state, local_batch(batch, on))
        return state, {k: _data_mean(v, on) if k in ("loss", "nll", "aux") else v
                       for k, v in metrics.items()}

    def _step(state: TrainState, batch: Dict[str, Any]):
        with traced_step(tracer):
            return _step_body(state, batch)

    def _step_body(state: TrainState, batch: Dict[str, Any]):
        leaves = flatten_with_paths(state.params)
        if not all(p.requires_grad for p in leaves.values()):
            raise ValueError("the state's parameters do not require gradients "
                             "(build the state with init_train_state)")
        if microbatches > 1:
            grads = {k: torch.zeros_like(p, dtype=torch.float32)
                     for k, p in leaves.items()}
            loss_sum = torch.zeros((), dtype=torch.float32, device=state.step.device)
            for mb in _split(batch, microbatches):
                loss, _, g = value_and_grad(state.params, leaves, mb)
                for k, gk in g.items():
                    grads[k].add_(gk.float())
                loss_sum = loss_sum + loss
                del g
            grads = {k: g / microbatches for k, g in grads.items()}
            loss = loss_sum / microbatches
            metrics: Dict[str, Tensor] = {}
        else:
            loss, metrics, grads = value_and_grad(state.params, leaves, batch)

        comp_state = state.comp
        if compression and comp_state is not None:
            grads, comp_state = compress_grads(grads, comp_state)

        with train_span("train.optimizer"):
            lr = linear_warmup_cosine(state.step, base_lr=base_lr,
                                      warmup_steps=warmup_steps,
                                      total_steps=total_steps)
            new_params, new_opt, opt_metrics = adamw_update(
                grads, state.opt, state.params, lr=lr, weight_decay=weight_decay)
        new_state = TrainState(new_params, new_opt, comp_state, state.step + 1)
        out_metrics = {"loss": loss, "lr": lr, **opt_metrics, **metrics}
        return new_state, out_metrics

    return train_step


def make_serve_step(model) -> Callable:
    """Single decode step: (params, batch, cache) → (logits, cache)."""
    def serve_step(params, batch, cache):
        with torch.no_grad():
            return model.decode_step(params, batch, cache)
    return serve_step
