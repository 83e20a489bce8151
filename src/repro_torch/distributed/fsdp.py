"""FSDP (ZeRO-3) per-layer gather (twin of ``repro.distributed.fsdp``).

The reference keeps stacked weights fsdp-sharded in HBM and, inside the
scan body, casts the layer slice to the compute dtype and constrains it
to the TP layout, forcing a PER-LAYER all-gather; `pin_layer_stack`
stops GSPMD from hoisting that gather out of the loop.

Here a layer's leaves are `Params` tensors, DTensors once
`repro_torch.distributed.sharding.distribute_params` has put them on a
mesh, and the layers compute on plain tensors (see
`repro_torch.distributed.activations`).  So `gather_layer` is where a
layer's DTensors become the tensors its layers compute on, one layer at
a time (inside the layer's remat, so the backward gathers again rather
than keeping the layer whole):

  * a dim sharded over a data axis (the fsdp variant's rows) is
    all-gathered; its gradient is summed over that axis, divided by its
    size (the batch mean of the ranks' losses) and cut back to the shard;
  * a leaf replicated over a data axis keeps its values; its gradient is
    averaged over the axis the same way;
  * a dim sharded over `model` stays cut: the layers compute on this
    rank's block (column- and row-cut dense kernels, the vocab-cut
    embedding, the GMM's expert stacks; see
    `repro_torch.distributed.activations`), and its gradient is the
    block's own.  The `ParamView` the layers get says which dim of each
    leaf is cut (`ParamView.cut`).

With ``cfg.fsdp_gather`` each floating leaf is first cast to the compute
dtype, as the reference's, so the gather moves half the bytes at
bfloat16.  Without an ambient mesh and without ``fsdp_gather`` both
functions return their input.  `local_params` does the same for the
leaves outside the layer stacks (embedding, final norm, head), without
the cast: the reference gathers only its layers.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.distributed as dist
from torch import nn

from repro_torch.distributed.activations import all_gather
from repro_torch.launch.mesh import ambient_mesh, axis_info, data_axes

Tensor = torch.Tensor

class _GatherShard(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group, n, r):
        ctx.args = (dim, group, n, r)
        return all_gather(x, dim, group, n)

    @staticmethod
    def backward(ctx, g):
        dim, group, n, r = ctx.args
        g = g.contiguous().clone()
        dist.all_reduce(g, group=group)
        return (g / n).chunk(n, dim=dim)[r].contiguous(), None, None, None, None


class _MeanGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n):
        ctx.args = (group, n)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        group, n = ctx.args
        g = g.contiguous().clone()
        dist.all_reduce(g, group=group)
        return g / n, None, None


def _is_dtensor(t: Any) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor)


def _tree(node) -> Dict[str, Any]:
    """One layer's leaves as nested dicts; a layer stack (a list) stays
    as it is."""
    from repro_torch.models.layers import ParamView

    if isinstance(node, ParamView):
        return node._tree
    out: Dict[str, Any] = dict(node._parameters)
    for name, mod in node._modules.items():
        out[name] = mod if isinstance(mod, nn.ModuleList) else _tree(mod)
    return out


def _walk(tree: Dict[str, Any], fn, prefix: str = "") -> Dict[str, Any]:
    out = {}
    for name, node in tree.items():
        path = f"{prefix}/{name}" if prefix else name
        if isinstance(node, dict):
            out[name] = _walk(node, fn, path)
        elif isinstance(node, torch.Tensor):
            out[name] = fn(path, node)
        else:
            out[name] = node
    return out


def _model_cut(leaf: Any) -> Optional[int]:
    """The dim of a DTensor leaf sharded over a `model` axis of more than
    one rank, else None."""
    mesh = leaf.device_mesh
    for name, pl in zip(mesh.mesh_dim_names, leaf.placements):
        if name == "model" and pl.is_shard() and axis_info(mesh, name)[1] > 1:
            return pl.dim
    return None


def _cuts(tree: Dict[str, Any], old: Dict[str, Any]) -> Dict[str, Any]:
    """`ParamView`'s cut tree of ``tree``: each DTensor leaf's model-cut
    dim, and the entries of ``old`` (the cut tree of a view already made
    local) elsewhere."""
    out: Dict[str, Any] = {}
    for name, node in tree.items():
        if isinstance(node, dict):
            sub = _cuts(node, old.get(name) or {})
            if sub:
                out[name] = sub
        elif _is_dtensor(node):
            if _model_cut(node) is not None:
                out[name] = _model_cut(node)
        elif name in old:
            out[name] = old[name]
    return out


def _leaves(tree: Dict[str, Any]):
    for node in tree.values():
        if isinstance(node, dict):
            yield from _leaves(node)
        elif isinstance(node, torch.Tensor):
            yield node


def local_compute(leaf: Tensor, cast: Optional[torch.dtype] = None) -> Tensor:
    """A DTensor leaf as the plain tensor the layers compute on (see the
    module docstring), cast to ``cast`` before any gather when given; the
    gradient reaching it is its shard's."""
    mesh = leaf.device_mesh
    batch = data_axes(mesh)
    x = leaf.to_local()
    if cast is not None and x.is_floating_point() and x.dtype != cast:
        x = x.to(cast)
    for name, pl in zip(mesh.mesh_dim_names, leaf.placements):
        group, n, r = axis_info(mesh, name)
        if n == 1 or name not in batch:
            continue                      # nothing to gather, nothing to average
        if pl.is_shard():
            x = _GatherShard.apply(x, pl.dim, group, n, r)
        else:
            x = _MeanGrad.apply(x, group, n)
    return x


def local_params(params: Any, cast: Optional[torch.dtype] = None) -> Any:
    """``params`` (a `Params` or `ParamView` subtree) with every DTensor
    leaf made the plain tensor the layers compute on (`local_compute`)
    and, with ``cast``, every floating leaf first cast to it; ``params``
    itself when there is nothing to do.  Layer stacks (lists) are kept
    as they are."""
    from repro_torch.models.layers import ParamView

    if cast is None and ambient_mesh() is None:
        return params
    tree = _tree(params)
    if cast is None and not any(_is_dtensor(t) for t in _leaves(tree)):
        return params

    def one(path: str, leaf: Tensor) -> Tensor:
        if _is_dtensor(leaf):
            return local_compute(leaf, cast)
        if cast is not None and leaf.is_floating_point() and leaf.dtype != cast:
            return leaf.to(cast)
        return leaf

    old = params._cut if isinstance(params, ParamView) else {}
    return ParamView(_walk(tree, one), _cuts(tree, old))


def gather_layer(layer_params: Any, cfg) -> Any:
    """Gather the fsdp (data) dim of one layer's params, keep TP dims."""
    from repro_torch.models.layers import dtype_of

    fsdp = getattr(cfg, "fsdp_gather", False)
    return local_params(layer_params, dtype_of(cfg) if fsdp else None)


def pin_layer_stack(stacked_params: Any, cfg) -> Any:
    """Pin each layer's weights to their fsdp spec before the layer loop.

    In the reference, without this the replicated spec `gather_layer`
    puts on the per-iteration slice back-propagates through the loop's
    dynamic-slice and GSPMD gathers the WHOLE stack outside the loop.
    Here it redistributes each DTensor leaf stored in another layout
    (the tp variant) to the fsdp placements (`DTensor.redistribute`, a
    local cut whose gradient is gathered back), so `gather_layer`
    gathers one layer's rows at a time.
    """
    if not getattr(cfg, "fsdp_gather", False):
        return stacked_params
    from repro_torch.distributed.sharding import shard_params
    from repro_torch.models.layers import ParamView

    out = []
    for lp in stacked_params:
        tree = _tree(lp)
        leaves = [t for t in _leaves(tree) if _is_dtensor(t)]
        if not leaves:
            out.append(lp)
            continue
        specs = shard_params(lp, leaves[0].device_mesh, "fsdp")

        def pin(path: str, leaf: Tensor, specs=specs) -> Tensor:
            if not _is_dtensor(leaf):
                return leaf
            want = specs[path].placements
            return leaf if tuple(leaf.placements) == want else \
                leaf.redistribute(leaf.device_mesh, want)

        out.append(ParamView(_walk(tree, pin)))
    return out


__all__ = ["gather_layer", "pin_layer_stack", "local_params", "local_compute"]
