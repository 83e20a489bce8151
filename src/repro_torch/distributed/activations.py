"""Mesh-aware activation layouts (twin of ``repro.distributed.activations``):
safe no-ops off-mesh.

The reference's helpers put ``with_sharding_constraint`` on traced
arrays and let GSPMD place the collectives.  The port's layers compute
on plain tensors, one process per rank, laid out as the reference's
shard_map bodies are: the batch is this rank's rows over the data axes
(`repro_torch.distributed.sharding.local_batch`), and everything else
is whole on every rank of the `model` axis unless one of the helpers
below cuts it.  The rule that keeps the gradients right: a tensor that
is whole on the model axis is the same on all its ranks, and so is its
gradient.  Every cut therefore comes with its adjoint:

  * `model_shard` takes this rank's block along a dim (the gradient is
    gathered back whole);
  * `model_whole` gathers the blocks whole (the gradient is cut back to
    this rank's block);
  * `model_select` takes this rank's entries along a dim by index (the
    gradient is scattered into zeros and summed over the axis);
  * `model_sum` sums a partial value over the axis (the gradient passes
    through);
  * `model_copy` hands a whole tensor to a product with this rank's
    block of a weight (the value passes through, the gradient, a part
    on each rank, is summed over the axis).

The weights a layer computes with keep their `model` cut
(`repro_torch.distributed.fsdp.local_compute`), so the dense products
are Megatron's: a column-cut kernel gives this rank's output columns
(`model_copy` in front), a row-cut kernel takes this rank's input
columns and its partial product is summed (`model_sum`); the vocab-cut
embedding is looked up by `vocab_parallel_embedding` and gives this
rank's block of the logits (`repro_torch.models.layers`).

`constrain` applies a spec's `model` entries to a local tensor with
`model_shard` when the ambient mesh (`repro_torch.launch.mesh.use_mesh`)
has the spec's axes; its data axes are already local.  `constrain_seq`
holds a layer's (b, s, d) input sharded over `model` along s, so remat
keeps 1/m of it (`unshard_seq` gathers it whole inside the layer);
`constrain_logits` cuts the logits' vocab over `model`, and
`vocab_parallel_cross_entropy` reads the loss from the cut.

The kernels take their local shards here too: `attention_heads` gives a
prefill attention this rank's query heads over `model` (the column-cut
q projection's, or a cut of whole heads) and the K/V heads those
queries read, `model_shard` the GMM's expert buffer (the MoE layer's
expert stacks stay cut over `model`), and `heads_local` the SSD scan's
heads.  On one device, or an axis of size 1, each helper returns its
input.
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.distributed.sharding import PartitionSpec as P
from repro_torch.launch.mesh import ambient_mesh, axis_info, data_axes

Tensor = torch.Tensor
U = P.UNCONSTRAINED


def _mesh_axes() -> tuple:
    mesh = ambient_mesh()
    return tuple(mesh.mesh_dim_names) if mesh is not None else ()


def _axes_of(spec: P) -> set:
    out = set()
    for part in spec:
        if part is None or part is U:
            continue
        if isinstance(part, (tuple, list)):
            out.update(part)
        else:
            out.add(part)
    return out


def _axis(name: str) -> Optional[Tuple[Any, int, int]]:
    """(group, size, rank) of the ambient mesh's axis ``name``, or None
    when there is no such axis."""
    mesh = ambient_mesh()
    if mesh is None or name not in mesh.mesh_dim_names:
        return None
    return axis_info(mesh, name)


def _model() -> Optional[Tuple[Any, int, int]]:
    """The `model` axis when it has more than one rank, else None."""
    ax = _axis("model")
    return ax if ax is not None and ax[1] > 1 else None


def all_gather(x: Tensor, dim: int, group, n: int) -> Tensor:
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


class _Shard(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group, n, r):
        ctx.args = (dim, group, n)
        return x.chunk(n, dim=dim)[r].contiguous()

    @staticmethod
    def backward(ctx, g):
        dim, group, n = ctx.args
        return all_gather(g, dim, group, n), None, None, None, None


class _Whole(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group, n, r):
        ctx.args = (dim, n, r)
        return all_gather(x, dim, group, n)

    @staticmethod
    def backward(ctx, g):
        dim, n, r = ctx.args
        return g.chunk(n, dim=dim)[r].contiguous(), None, None, None, None


class _Select(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, index, group):
        ctx.args = (dim, index, group, x.shape)
        return x.index_select(dim, index)

    @staticmethod
    def backward(ctx, g):
        dim, index, group, shape = ctx.args
        out = torch.zeros(shape, dtype=g.dtype, device=g.device)
        # One entry at a time, in the index's order: a rank whose query
        # heads straddle kv groups reads a kv head twice, and one
        # `index_add_` over the whole index would sum the repeats in the
        # order its atomic adds land on the card.
        for j in range(index.numel()):
            out.index_add_(dim, index[j:j + 1], g.narrow(dim, j, 1))
        dist.all_reduce(out, group=group)
        return out, None, None, None


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _Sum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, scale):
        ctx.scale = scale
        y = x.contiguous().clone()
        dist.all_reduce(y, group=group)
        return y * scale if scale != 1.0 else y

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def model_shard(x: Tensor, dim: int) -> Tensor:
    """This rank's block of ``x`` along ``dim`` over `model`."""
    ax = _model()
    if ax is None:
        return x
    group, n, r = ax
    return _Shard.apply(x, dim % x.dim(), group, n, r)


def model_whole(x: Tensor, dim: int) -> Tensor:
    """The `model` axis's blocks of ``x`` along ``dim``, gathered whole."""
    ax = _model()
    if ax is None:
        return x
    group, n, r = ax
    return _Whole.apply(x, dim % x.dim(), group, n, r)


def model_select(x: Tensor, dim: int, index: Tensor) -> Tensor:
    """This rank's entries ``index`` of ``x`` along ``dim`` (``index``
    differs between the ranks of `model`)."""
    ax = _model()
    if ax is None:
        return x
    return _Select.apply(x, dim % x.dim(), index, ax[0])


def model_sum(x: Tensor) -> Tensor:
    """The sum over `model` of a value each rank holds part of."""
    ax = _model()
    if ax is None:
        return x
    return _Sum.apply(x, ax[0], 1.0)


def model_max(x: Tensor) -> Tensor:
    """The elementwise maximum over `model` of a value each rank holds a
    part of (no gradient: a softmax's shift)."""
    ax = _model()
    if ax is None:
        return x
    y = x.detach().contiguous().clone()
    dist.all_reduce(y, op=dist.ReduceOp.MAX, group=ax[0])
    return y


def model_copy(x: Tensor) -> Tensor:
    """``x`` (whole on `model`) as the input of a product with this
    rank's block of a weight: the gradient, each rank's part, is summed
    over the axis."""
    ax = _model()
    if ax is None:
        return x
    return _Copy.apply(x, ax[0])


def model_size() -> int:
    """The size of the ambient mesh's `model` axis (1 without one)."""
    ax = _model()
    return 1 if ax is None else ax[1]


def heads_split(heads: int) -> bool:
    """Whether ``heads`` heads are cut over `model`, whole heads a rank."""
    n = model_size()
    return n > 1 and heads % n == 0


def vocab_parallel_embedding(table: Tensor, ids: Tensor) -> Tensor:
    """Rows ``ids`` of an embedding whose vocab is cut over `model`
    (``table`` is this rank's block): each rank looks up the ids in its
    block, zeros elsewhere, and the rows are summed over the axis."""
    _, _, r = _model()
    width = table.shape[0]
    local = ids.long() - r * width
    inside = (local >= 0) & (local < width)
    rows = torch.nn.functional.embedding(local.clamp(0, width - 1), table)
    return model_sum(rows * inside[..., None].to(rows.dtype))


def batch_mean(x: Tensor) -> Tensor:
    """The mean over the data axes of a statistic of each rank's rows
    (the MoE balance terms, which the reference takes over the whole
    batch).  Its gradient passes through: the train step averages the
    ranks' gradients, which divides it as the mean did."""
    mesh = ambient_mesh()
    for name in data_axes(mesh) if mesh is not None else ():
        group, n, _ = axis_info(mesh, name)
        if n > 1:
            x = _Sum.apply(x, group, 1.0 / n)
    return x


# ---------------------------------------------------------------------------
# The reference's constraints
# ---------------------------------------------------------------------------

def constrain(x: Tensor, spec: P) -> Tensor:
    """The spec applied to a local tensor iff the ambient mesh has the
    spec's axes: each dim it puts on `model` is cut to this rank's block
    (when it divides); dims on data axes are already local."""
    axes = _mesh_axes()
    if not axes or not _axes_of(spec).issubset(axes):
        return x
    ax = _model()
    for dim, part in enumerate(spec):
        if ax is not None and part == "model" and x.shape[dim] % ax[1] == 0:
            x = model_shard(x, dim)
    return x


def constrain_seq(x: Tensor, cfg) -> Tensor:
    """Sequence parallelism: (b, s, d) activations sharded s→model."""
    if not getattr(cfg, "seq_shard", False):
        return x
    return constrain(x, P(U, "model", U))


def unshard_seq(x: Tensor, seq: int) -> Tensor:
    """``x`` whole along its sequence dim of ``seq`` rows again (the
    inverse of `constrain_seq` inside a layer)."""
    return x if x.shape[1] == seq else model_whole(x, 1)


def constrain_logits(logits: Tensor, vocab: Optional[int] = None) -> Tensor:
    """Pin logits to (batch over data axes, ..., vocab over model).

    Without the explicit batch pin, GSPMD trades the batch sharding away
    when it introduces the vocab sharding and the per-microbatch logits
    replicate across the data axis (measured 0.6 GB f32 × live copies on
    qwen2-72b).  Here the batch is local already, and the vocab is cut
    to this rank's block when it divides the axis (the loss then reads
    it with `vocab_parallel_cross_entropy`).  Logits narrower than
    ``vocab`` are cut already (a vocab-cut head's) and are returned as
    they are.
    """
    axes = _mesh_axes()
    batch = tuple(a for a in ("pod", "data") if a in axes)
    if not batch or "model" not in axes or \
            (vocab is not None and logits.shape[-1] != vocab):
        return logits
    spec = P(batch, *([U] * (logits.ndim - 2) + ["model"]))
    return constrain(logits, spec)


def vocab_parallel_cross_entropy(logits: Tensor, labels: Tensor) -> Tensor:
    """Mean token NLL of logits cut over `model` along the vocab (this
    rank's block of ``logits.shape[-1]`` entries): the max, the sum of
    exponentials and the gold logit are combined over the axis."""
    group, n, r = _model()
    width = logits.shape[-1]
    gmax = logits.detach().amax(dim=-1)
    dist.all_reduce(gmax, op=dist.ReduceOp.MAX, group=group)
    sumexp = model_sum(torch.exp(logits - gmax[..., None]).sum(dim=-1))
    logz = torch.log(sumexp) + gmax
    local = labels.long() - r * width
    inside = (local >= 0) & (local < width)
    gold = logits.gather(-1, local.clamp(0, width - 1)[..., None])[..., 0]
    gold = model_sum(torch.where(inside, gold, torch.zeros_like(gold)))
    return torch.mean(logz - gold)


# ---------------------------------------------------------------------------
# Kernels on local shards
# ---------------------------------------------------------------------------

def attention_heads(q: Tensor, k: Tensor, v: Tensor,
                    heads: Optional[Tuple[int, int]] = None
                    ) -> Optional[Tuple[Tensor, Tensor, Tensor]]:
    """(q, k, v) of this rank's query heads over `model` and the K/V heads
    they read, or None when the heads stay whole (no model axis, or a
    head count that does not divide it).

    q is (b, sq, h, d), k and v (b, skv, kvh, d); ``heads`` gives the
    global (h, kvh) when q, or k and v, may hold this rank's heads
    already (a column-cut projection's: `heads_split`), else q, k and v
    are whole.  Query head i reads kv head i // (h / kvh) by its GLOBAL
    index.  Local K/V heads (kvh divides the axis) are the ones this
    rank's queries read.  From whole K/V, when this rank's heads cover
    whole kv groups, or lie inside one, the kernel's own grouping of the
    local heads reads the right kv heads; otherwise each local query
    head gets its own copy of its kv head."""
    ax = _model()
    h, kvh = heads if heads is not None else (q.shape[2], k.shape[2])
    if ax is None or h % ax[1]:
        return None
    _, n, r = ax
    q = model_shard(q, 2) if q.shape[2] == h else q
    if k.shape[2] != kvh:
        return q, k, v
    hl, g = h // n, h // kvh
    first = r * hl
    if hl % g == 0 or g % hl == 0:
        index = torch.arange(first // g, (first + hl - 1) // g + 1, device=k.device)
    else:
        index = torch.arange(first, first + hl, device=k.device) // g
    return q, model_select(k, 2, index), model_select(v, 2, index)


def cache_layout(cache_leaf) -> Optional[Tuple[str, int]]:
    """How a decode cache leaf (a DTensor of `sharding.cache_shardings`,
    (n, b, s, kvh, hd)) is cut over a `model` axis of more than one rank:
    ("heads", rank) or ("seq", first position of this rank's block), or
    None (whole on `model`, or not a DTensor)."""
    from torch.distributed.tensor import DTensor

    if not isinstance(cache_leaf, DTensor):
        return None
    mesh = cache_leaf.device_mesh
    for name, pl in zip(mesh.mesh_dim_names, cache_leaf.placements):
        if name != "model" or not pl.is_shard() or axis_info(mesh, name)[1] == 1:
            continue
        r = axis_info(mesh, name)[2]
        if pl.dim == 3:
            return "heads", r
        if pl.dim == 2:
            return "seq", r * cache_leaf.to_local().shape[2]
    return None


def heads_local(x: Tensor, dim: int, heads: int) -> Tensor:
    """This rank's heads of ``x`` along ``dim`` when ``heads`` divides
    the model axis, else ``x``."""
    ax = _model()
    return x if ax is None or heads % ax[1] else model_shard(x, dim)


def heads_whole(x: Tensor, dim: int, heads: int) -> Tensor:
    """The inverse of `heads_local`."""
    return x if x.shape[dim] == heads else model_whole(x, dim)
