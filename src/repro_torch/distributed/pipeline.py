"""Pipeline parallelism: GPipe-style microbatching over a `pipe` mesh axis
(twin of ``repro.distributed.pipeline``).

Stages hold contiguous layer slices; activations flow stage→stage around
a ring by point-to-point send/recv (the reference's ``jax.lax.ppermute``).
The schedule runs M + S − 1 ticks (M microbatches, S stages): each tick,
every stage processes the microbatch it holds and passes the result
forward — the standard bubble of (S−1)/(M+S−1).

One process per rank of the axis, as the reference's shard_map body:
every rank is given the whole stacked ``stage_params`` and the whole
``x_micro`` and takes its own stage's slice.  Forward only, as the
reference uses it.

Used as an OPTIONAL parallelism mode (``--pipeline-stages``): the
baseline dry-run meshes use DP×TP where the per-layer weights fit; PP
becomes necessary when a single layer's weights exceed HBM or for
latency-bound decode — both noted in DESIGN.md §5.
"""
from __future__ import annotations

from typing import Any, Callable

import torch
import torch.distributed as dist

Params = Any
Tensor = torch.Tensor


def _map(fn: Callable[[Tensor], Tensor], tree: Params) -> Params:
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def _first_leaf(tree: Params) -> Tensor:
    if isinstance(tree, dict):
        return _first_leaf(next(iter(tree.values())))
    if isinstance(tree, (list, tuple)):
        return _first_leaf(tree[0])
    return tree


def pipeline_forward(
    layer_fn: Callable[[Params, Tensor], Tensor],
    stage_params: Params,
    x_micro: Tensor,
    *,
    mesh,
    axis: str = "pipe",
) -> Tensor:
    """Run microbatches through pipeline stages, one stage per rank of
    ``axis``.

    stage_params: tree with leading [stages, layers_per_stage, ...]
    x_micro: (microbatches, mb_size, seq, d) activations (already embedded)
    Returns activations after all stages, same shape, on every rank.
    """
    dim = mesh.mesh_dim_names.index(axis)
    n_stages = mesh.size(dim)
    stage = mesh.get_local_rank(axis)
    group = mesh.get_group(axis)
    params_local = _map(lambda a: a[stage], stage_params)
    m = x_micro.shape[0]
    n_ticks = m + n_stages - 1
    layers = _first_leaf(params_local).shape[0]
    ring_next = dist.get_global_rank(group, (stage + 1) % n_stages)
    ring_prev = dist.get_global_rank(group, (stage - 1) % n_stages)

    def run_stage(act: Tensor) -> Tensor:
        for i in range(layers):
            act = layer_fn(_map(lambda a: a[i], params_local), act)
        return act

    buf = torch.zeros_like(x_micro[0])
    outputs = torch.zeros_like(x_micro)
    for t in range(n_ticks):
        # Stage 0 ingests microbatch t (when valid); others use buf.
        inp = x_micro[t if t < m else 0] if stage == 0 else buf
        out = run_stage(inp)
        # Last stage records its finished microbatch (t - S + 1).
        done = t - (n_stages - 1)
        if stage == n_stages - 1 and done >= 0:
            outputs[done] = out
        # Forward permute (ring): stage i → i+1.
        if n_stages > 1:
            buf = torch.empty_like(out)
            reqs = dist.batch_isend_irecv([
                dist.P2POp(dist.isend, out.contiguous(), ring_next, group),
                dist.P2POp(dist.irecv, buf, ring_prev, group)])
            for req in reqs:
                req.wait()
        else:
            buf = out
    # Only the last stage holds real outputs: broadcast them.
    if n_stages > 1:
        dist.broadcast(outputs, src=dist.get_global_rank(group, n_stages - 1),
                       group=group)
    return outputs


def split_layers_to_stages(layer_params: Params, n_stages: int) -> Params:
    """[L, ...] stacked layers → [S, L/S, ...]."""
    def reshape(a):
        l = a.shape[0]
        assert l % n_stages == 0, (l, n_stages)
        return a.reshape((n_stages, l // n_stages) + tuple(a.shape[1:]))
    return _map(reshape, layer_params)


def pipeline_bubble_fraction(n_stages: int, n_micro: int) -> float:
    """Analytical bubble overhead (S−1)/(M+S−1) — the §Perf napkin."""
    return (n_stages - 1) / (n_micro + n_stages - 1)
