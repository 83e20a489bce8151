"""Train and serve steps on one card (twin of
``repro.distributed.trainstep``).

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
that on).  There is no mesh: the reference's sharding constraints are the
identity on one device, and its deferred cross-device reduction waits for
the port's multi-device slice.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.distributed.compression import (
    CompressionState, compress_grads, compression_init,
)
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
) -> Callable[[TrainState, Dict[str, Any]], Tuple[TrainState, Dict[str, Any]]]:

    def value_and_grad(params, leaves, batch):
        loss, metrics = model.loss(params, batch)
        grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
        grads = {k: torch.zeros_like(p) if g is None else g
                 for (k, p), g in zip(leaves.items(), grads)}
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads

    def train_step(state: TrainState, batch: Dict[str, Any]):
        leaves = flatten_with_paths(state.params)
        if not all(p.requires_grad for p in leaves.values()):
            raise ValueError("the state's parameters do not require gradients "
                             "(build the state with init_train_state)")
        if microbatches > 1:
            grads = {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
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
