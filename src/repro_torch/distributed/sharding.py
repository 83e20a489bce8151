"""Sharding rules: parameter/input PartitionSpecs per architecture family
(twin of ``repro.distributed.sharding``).

Rules are keyed by parameter *path* (joined tree keys) and applied to
the trees the models build.  `VARIANTS` exposes alternative rule sets —
the §Perf hillclimb lever: changing a variant re-shards the whole model.

Baseline ("tp"):
  * vocab/embedding sharded over `model`;
  * attention QKV column-sharded, O row-sharded (Megatron TP);
  * MLP gate/up column-, down row-sharded;
  * MoE experts sharded over `model` (EP);
  * Mamba in_proj column-, out_proj row-sharded;
  * batch over (`pod`, `data`).

"fsdp" additionally shards the *row* dim of large matrices over `data`
(ZeRO-3-style), trading all-gathers for memory.

The rule tables, `_stacked_lead`, `_BASE_NDIM`, `param_pspec` and the
divisibility rule of `shard_params` are the reference's, with
`PartitionSpec` the port's own stand-in for jax's.  The reference stacks
a layer stack on leading scan axes; the port holds one tensor per layer
(``layers/0/attn/k/kernel``), so `_stacked_lead` gives 0 on its leaves
and the same regexes match.

What a spec becomes here: `NamedSharding.placements` turns it into
`torch.distributed.tensor` placements, one per mesh axis (`Shard(d)`
where the spec puts that axis on tensor dim d, else `Replicate()`), and
`distribute_params` makes every leaf of a `Params` tree a DTensor with
them (`distribute_tensor`).  A spec that puts a tuple of axes on one dim
(the batch over ``("pod", "data")``) shards it over them in order, as
jax does.
"""
from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.launch.mesh import axis_sizes
from repro_torch.utils.tree import flatten_with_paths

Array = Any


class _Unconstrained:
    def __repr__(self) -> str:
        return "UNCONSTRAINED"


class PartitionSpec(tuple):
    """One entry per tensor dim: None (replicated), an axis name, or a
    tuple of axis names — the port's stand-in for jax's PartitionSpec
    (which, like it, stores a 1-tuple of names as the name)."""

    UNCONSTRAINED = _Unconstrained()

    def __new__(cls, *parts):
        return super().__new__(cls, (p[0] if isinstance(p, tuple) and len(p) == 1 else p
                                     for p in parts))

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


def _axes_of_part(part) -> Tuple[str, ...]:
    if part is None or part is P.UNCONSTRAINED:
        return ()
    return tuple(part) if isinstance(part, (tuple, list)) else (part,)


@dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (jax's NamedSharding)."""

    mesh: Any
    spec: PartitionSpec

    @property
    def placements(self) -> tuple:
        """One `torch.distributed.tensor` placement per mesh axis."""
        from torch.distributed.tensor import Replicate, Shard

        where = {}
        for dim, part in enumerate(self.spec):
            for ax in _axes_of_part(part):
                where[ax] = dim
        return tuple(Shard(where[ax]) if ax in where else Replicate()
                     for ax in self.mesh.mesh_dim_names)

    def local(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's block of the whole tensor ``x``."""
        for dim, part in enumerate(self.spec):
            axes = _axes_of_part(part)
            if not axes:
                continue
            n, idx = 1, 0
            for ax in axes:
                size = self.mesh.size(self.mesh.mesh_dim_names.index(ax))
                idx = idx * size + self.mesh.get_local_rank(ax)
                n *= size
            x = x.chunk(n, dim=dim)[idx]
        return x


def _data_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.mesh_dim_names)


# ---------------------------------------------------------------------------
# Rule tables: list of (path_regex, spec_fn(leaf_ndim, stacked) -> P)
# `stacked` = number of leading scan axes to leave unsharded.
# ---------------------------------------------------------------------------

def _tp_rules(model_axis: str = "model", fsdp_axis: Optional[str] = None):
    m = model_axis
    f = fsdp_axis

    def col(nd, lead):  # (..., d_in, d_out) → shard d_out over model
        return P(*([None] * lead + [f] + [m])) if nd - lead == 2 else \
            P(*([None] * (nd - 1) + [m]))

    def row(nd, lead):  # (..., d_in, d_out) → shard d_in over model
        return P(*([None] * lead + [m] + [f])) if nd - lead == 2 else \
            P(*([None] * lead + [m] + [None] * (nd - lead - 1)))

    def vocab(nd, lead):
        # (vocab, d): vocab over model, d over fsdp.  Bisected against
        # d-sharded layouts (EXPERIMENTS §Perf): vocab-sharded keeps the
        # LM-head logits naturally vocab-sharded (20.1 GB temp on
        # qwen2-72b train) while d-sharding forces transpose/gather
        # repartitions (37–103 GB).
        return P(*([None] * lead + [m, f]))

    def expert_col(nd, lead, shape=None):
        # (e, d, f) / (e, f, d): experts over model; for LARGE expert
        # stacks ALSO shard the contraction dim over data (2-D expert
        # sharding).  At 128 experts × 16-way model, 1-D leaves 29 GB
        # bf16/chip on qwen3-moe serving; but the 2-D layout costs
        # resharding collectives, so small expert stacks (granite,
        # measured 14→27 GB regression) stay 1-D.
        second = f
        if shape is not None and f is None:
            stack_bytes_per_chip = 2 * int(np.prod(shape)) / 16
            if stack_bytes_per_chip > 1e9:
                second = "data"
        return P(*([None] * lead + [m, second, None]))

    def bias_col(nd, lead):
        return P(*([None] * (nd - 1) + [m]))

    def repl(nd, lead):
        return P(*([None] * nd))

    return [
        (r"embedding$", vocab),
        (r"attn/(q|k|v)/kernel$", col),
        (r"attn/(q|k|v)/bias$", bias_col),
        (r"attn/o/kernel$", row),
        (r"attn/o/bias$", repl),
        (r"xattn/(q|k|v)/kernel$", col),
        (r"xattn/o/kernel$", row),
        (r"mlp/(gate|up)/kernel$", col),
        (r"mlp/(gate|up)/bias$", bias_col),
        (r"mlp/down/kernel$", row),
        (r"mlp/down/bias$", repl),
        (r"mlp/router/kernel$", repl),
        (r"mlp/(gate|up)$", expert_col),          # MoE (e, d, f)
        (r"mlp/down$", expert_col),               # (e, f, d): same pattern
        (r"in_proj/kernel$", col),
        (r"out_proj/kernel$", row),
        (r"conv_w$", repl),
        (r"(A_log|D|dt_bias|conv_b)$", repl),
        (r"(scale|gate)$", repl),
        (r"dec_pos$", repl),
        (r".*", repl),
    ]


VARIANTS: Dict[str, Callable] = {
    "tp": lambda: _tp_rules("model", None),
    "fsdp": lambda: _tp_rules("model", "data"),
}


def _stacked_lead(path: str, ndim: int, base_ndim: int) -> int:
    """Leading scan axes = actual ndim − the layer-local ndim."""
    return max(0, ndim - base_ndim)


_BASE_NDIM = {
    r"embedding$": 2, r"kernel$": 2, r"bias$": 1, r"scale$": 1,
    r"mlp/(gate|up|down)$": 3,  # MoE expert tensors
    r"conv_w$": 2, r"conv_b$": 1, r"A_log$": 1, r"D$": 1, r"dt_bias$": 1,
    r"gate$": 1, r"dec_pos$": 2,
}


def _base_ndim(path: str) -> int:
    for pat, nd in _BASE_NDIM.items():
        if re.search(pat, path):
            return nd
    return 2


def param_pspec(path: str, leaf, variant: str = "tp") -> P:
    rules = VARIANTS[variant]()
    ndim = len(leaf.shape)
    lead = _stacked_lead(path, ndim, _base_ndim(path))
    for pat, fn in rules:
        if re.search(pat, path):
            try:
                spec = fn(ndim, lead, leaf.shape)
            except TypeError:
                spec = fn(ndim, lead)
            # Trim/extend to leaf rank.
            parts = list(spec) + [None] * ndim
            return P(*parts[:ndim])
    return P(*([None] * ndim))


def shard_params(params_shape, mesh, variant: str = "tp") -> Dict[str, NamedSharding]:
    """Tree of tensors (a `Params` module, or anything
    `flatten_with_paths` walks) → {path: NamedSharding}.

    Specs are validated against leaf shapes: a dim whose size does not
    divide the mesh axis is left unsharded (robust default — the
    hillclimb promotes better layouts explicitly), and so is a dim whose
    axis the mesh lacks (a `model` rule on a data-only mesh).
    """
    sizes = axis_sizes(mesh)

    def spec_for(path, leaf):
        spec = param_pspec(path, leaf, variant)
        fixed = []
        for dim, ax in zip(leaf.shape, spec):
            if ax is None or not set(_axes_of_part(ax)) <= set(sizes):
                fixed.append(None)
                continue
            size = int(np.prod([sizes[a] for a in (ax if isinstance(ax, tuple) else (ax,))]))
            fixed.append(ax if dim % size == 0 else None)
        return NamedSharding(mesh, P(*fixed))

    return {path: spec_for(path, leaf)
            for path, leaf in flatten_with_paths(params_shape).items()}


def distribute_params(params, mesh, variant: str = "tp",
                      shardings: Optional[Dict[str, NamedSharding]] = None):
    """Make every leaf of the `Params` module ``params`` a DTensor on
    ``mesh`` with `shard_params`'s placements (in place; each leaf keeps
    its ``requires_grad``).  Every rank must hold the same whole values:
    `distribute_tensor` takes them from rank 0."""
    from torch import nn
    from torch.distributed.tensor import DTensor, distribute_tensor

    shardings = shardings or shard_params(params, mesh, variant)
    for mod_name, mod in params.named_modules():
        for name, p in list(mod._parameters.items()):
            path = f"{mod_name}.{name}".lstrip(".").replace(".", "/")
            whole = p.detach().full_tensor() if isinstance(p, DTensor) else p.detach()
            mod._parameters[name] = nn.Parameter(
                distribute_tensor(whole, mesh, shardings[path].placements),
                requires_grad=p.requires_grad)
    return params


def batch_pspec(mesh, *, shard_batch: bool = True) -> P:
    da = _data_axes(mesh)
    return P(da if (da and shard_batch) else None)


def input_shardings(specs: Dict[str, Any], mesh, global_batch: int
                    ) -> Dict[str, NamedSharding]:
    """NamedShardings for a batch dict: batch dim over (pod, data) when
    divisible, replicated otherwise (the long_500k b=1 case)."""
    da = _data_axes(mesh)
    sizes = axis_sizes(mesh)
    dsize = int(np.prod([sizes[a] for a in da])) if da else 1
    shard = bool(da) and global_batch % dsize == 0

    def one(leaf):
        nd = len(leaf.shape)
        spec = [da if shard else None] + [None] * (nd - 1)
        return NamedSharding(mesh, P(*spec))

    return {k: one(v) for k, v in specs.items()}


def local_batch(batch: Dict[str, torch.Tensor], mesh) -> Dict[str, torch.Tensor]:
    """This rank's rows of a whole batch, by `input_shardings`."""
    first = next(iter(batch.values()))
    sh = input_shardings(batch, mesh, int(first.shape[0]))
    return {k: sh[k].local(v) for k, v in batch.items()}


def cache_shardings(cache_shape, mesh) -> Dict[str, NamedSharding]:
    """KV/state cache layout for decode, {path: NamedSharding}.

    * batch (axis 1 of the (L, b, ...) stacks) shards over (pod, data);
    * KV caches (L, b, s, kvh, hd): kv-heads shard over `model` when the
      head count divides it; otherwise the SEQUENCE dim shards over
      `model` (sequence-parallel decode — attention's softmax reductions
      become cross-chip partial reductions, which GSPMD lowers to
      all-reduces; the memory win makes 32k–512k caches fit);
    * Mamba state caches (L, b, h, p, n) shard SSM heads over `model`.
    """
    sizes = axis_sizes(mesh)
    da = _data_axes(mesh)
    dsize = int(np.prod([sizes[a] for a in da])) if da else 1
    msize = sizes.get("model", 1)

    def one(leaf):
        nd = len(leaf.shape)
        spec = [None] * nd
        if nd >= 2 and da and leaf.shape[1] % dsize == 0:
            spec[1] = da
        if nd == 5:
            if leaf.shape[3] % msize == 0:            # kv/ssm heads
                spec[3] = "model"
            elif leaf.shape[2] % msize == 0 and leaf.shape[2] >= msize:
                spec[2] = "model"                      # sequence-parallel
        elif nd == 4 and leaf.shape[2] % msize == 0 and leaf.shape[2] >= msize:
            # mamba conv cache (L, b, w-1, conv_ch): shard channels.
            if leaf.shape[3] % msize == 0:
                spec[3] = "model"
        return NamedSharding(mesh, P(*spec))

    return {path: one(leaf) for path, leaf in flatten_with_paths(cache_shape).items()}


def local_cache(cache: Any) -> Any:
    """A decode cache tree (dicts of tensors, None) with each DTensor leaf
    (`cache_shardings`' layout) replaced by this rank's local tensor, a
    view: writes into it reach the DTensor."""
    from torch.distributed.tensor import DTensor

    if isinstance(cache, dict):
        return {k: local_cache(v) for k, v in cache.items()}
    return cache.to_local() if isinstance(cache, DTensor) else cache
