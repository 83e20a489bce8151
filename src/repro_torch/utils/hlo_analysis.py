"""Collective and byte accounting of one traced step (twin of
``repro.utils.hlo_analysis``).

The reference parses XLA's compiled HLO text: ``cost_analysis()`` gives
per-device FLOPs and bytes but not collective traffic, so it sums the
result shapes of every collective instruction.  Torch has no HLO.  Here
the same record is read from the ops a step issues while it runs:
`collect_collective_stats` is a `TorchDispatchMode` that, inside its
``with`` block, sees every ATen op, every ``c10d.*`` collective (the
process-group calls of ``torch.distributed``) and every
``_c10d_functional.*`` one (DTensor's redistributions, ``full_tensor``
among them), on real tensors or on fake ones over a fake process group
(`repro_torch.launch.dryrun`).  Ops on DTensors are let through to
DTensor first (``NotImplemented``), so the mode counts the local ops and
the collectives they lower to, per device.

Each collective is recorded under one of the reference's five kinds
(`COLLECTIVE_KINDS`) with the reference's byte rule, its result bytes.
Approximation notes (the reference's, which carry over):
  * for all-reduce / reduce-scatter the result bytes equal the
    per-device payload contribution;
  * for all-gather the result is the *gathered* tensor; per-link traffic
    of a ring all-gather of result size R over k devices is R·(k-1)/k ≈ R,
    so result bytes are a tight upper bound;
  * for all-to-all / collective-permute result bytes equal the per-device
    send volume.

The mapping of the calls that have no XLA collective of their own name:
  * ``send`` / ``isend`` (the pipeline's ring, the reference's
    ``ppermute``) is a collective-permute of its payload, the per-device
    send volume; ``recv_`` / ``irecv`` is the receiving half of the same
    permute, counted neither in bytes nor in calls (its bytes are its
    sender's);
  * ``broadcast`` (the pipeline's last stage to all, which the reference
    writes as a masked ``psum``) is an all-reduce of the tensor;
  * a functional collective is counted once, at its issue, never at its
    ``wait_tensor``.
A collective op outside the table raises (`UnmappedCollective`), so no
collective is dropped silently.

The same mode counts every ATen op by name (`count_op`) and sums the
operand and result bytes of every op that is not a view
(``bytes_accessed``), the counterpart of XLA's ``bytes accessed``.  It
is an upper bound in eager mode: nothing is fused, so every
intermediate is written and read again.  ``prim`` ops read metadata and
move no bytes: a fake tensor answers ``.device`` through
``prim.device``, which a real tensor never dispatches, so counting them
would make a traced step read more than the same step run for real.

`cpu_bf16_upcast_bytes` measures an artifact of XLA:CPU's bfloat16
emulation (an f32 copy of every bf16 dot operand).  Torch has no such
emulation, so it is 0 here.

A deliberate departure: XLA counts a scanned layer's body once (the
reference's roofline reads per-iteration figures).  The port runs its
layers as a Python loop, and this mode counts every collective and
product each executed layer issues, so the two packages' figures are not
comparable one for one.
"""
from __future__ import annotations

from collections import Counter
from dataclasses import dataclass, field
from typing import Any, Dict, List, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

COLLECTIVE_KINDS = (
    "all-gather",
    "all-reduce",
    "reduce-scatter",
    "all-to-all",
    "collective-permute",
)


@dataclass
class CollectiveStats:
    """Per-kind collective byte totals + op counts for one HLO module."""

    bytes_by_kind: Dict[str, int] = field(default_factory=dict)
    count_by_kind: Dict[str, int] = field(default_factory=dict)
    instances: List[Tuple[str, int]] = field(default_factory=list)

    @property
    def total_bytes(self) -> int:
        return sum(self.bytes_by_kind.values())

    @property
    def total_count(self) -> int:
        return sum(self.count_by_kind.values())

    def summary(self) -> Dict[str, Dict[str, int]]:
        return {
            k: {"bytes": self.bytes_by_kind.get(k, 0), "count": self.count_by_kind.get(k, 0)}
            for k in sorted(self.bytes_by_kind)
        }


class UnmappedCollective(RuntimeError):
    """A ``c10d`` or ``_c10d_functional`` op with no entry in the table."""


# (namespace, op name) → (kind, where its result is: "out" the op's
# return value, "arg0" its first argument (in-place ops and the
# output-buffer c10d calls), None for an op that moves no bytes of its
# own).  c10d ops return (tensors, work) or a work object, so their
# results are their output arguments.
_FUNCTIONAL = {
    "all_reduce": ("all-reduce", "out"),
    "all_reduce_": ("all-reduce", "out"),
    "all_reduce_coalesced": ("all-reduce", "out"),
    "all_reduce_coalesced_": ("all-reduce", "out"),
    "all_gather_into_tensor": ("all-gather", "out"),
    "all_gather_into_tensor_out": ("all-gather", "out"),
    "all_gather_into_tensor_coalesced": ("all-gather", "out"),
    "reduce_scatter_tensor": ("reduce-scatter", "out"),
    "reduce_scatter_tensor_coalesced": ("reduce-scatter", "out"),
    "reduce_scatter_tensor_out": ("reduce-scatter", "out"),
    "all_to_all_single": ("all-to-all", "out"),
    "isend": ("collective-permute", "arg0"),
    "irecv": ("collective-permute", None),
    "broadcast": ("all-reduce", "out"),
    "broadcast_": ("all-reduce", "out"),
}
_C10D = {
    "allreduce_": ("all-reduce", "arg0"),
    "allreduce_coalesced_": ("all-reduce", "arg0"),
    "broadcast_": ("all-reduce", "arg0"),
    "allgather_": ("all-gather", "arg0"),
    "_allgather_base_": ("all-gather", "arg0"),
    "allgather_into_tensor_coalesced_": ("all-gather", "arg0"),
    "allgather_coalesced_": ("all-gather", "arg0"),
    "reduce_scatter_": ("reduce-scatter", "arg0"),
    "_reduce_scatter_base_": ("reduce-scatter", "arg0"),
    "reduce_scatter_tensor_coalesced_": ("reduce-scatter", "arg0"),
    "alltoall_": ("all-to-all", "arg0"),
    "alltoall_base_": ("all-to-all", "arg0"),
    "send": ("collective-permute", "arg0"),
    "recv_": ("collective-permute", None),
    "recv_any_source_": ("collective-permute", None),
}
_TABLES = {
    "_c10d_functional": _FUNCTIONAL,
    "_c10d_functional_autograd": _FUNCTIONAL,
    "c10d": _C10D,
}
# Ops of those namespaces that are not collectives: the wait of a
# functional collective (counted at its issue), the autograd wrapper of
# its result, and the process group's own bookkeeping.  Everything else
# there (``reduce_``, ``gather_``, ``scatter_``, ``batch_p2p_ops``) has no
# kind of the five and raises.
_NOT_COLLECTIVES = {"wait_tensor", "_wrap_tensor_autograd", "barrier",
                    "monitored_barrier_", "check_for_nan"}


def _tensor_bytes(tree: Any) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def dtensor_types(types) -> bool:
    """Whether a dispatch mode's ``types`` hold a DTensor (the mode then
    returns ``NotImplemented``, so DTensor runs its local ops first)."""
    from torch.distributed.tensor import DTensor

    return any(issubclass(t, DTensor) for t in types)


def collective_kind(func) -> Tuple[str, Any]:
    """(kind, where its result is) of a collective op; raises
    `UnmappedCollective` for a collective the table lacks."""
    ns, name = func.namespace, func._opname
    entry = _TABLES[ns].get(name)
    if entry is None:
        raise UnmappedCollective(f"{ns}.{name} maps to no collective kind "
                                 f"({', '.join(COLLECTIVE_KINDS)})")
    return entry


class CollectiveTrace(TorchDispatchMode):
    """The dispatch mode of `collect_collective_stats`: ``stats`` (the
    collectives), ``op_counts`` (ATen ops by name, e.g. ``"mm"``) and
    ``bytes_accessed`` (operand and result bytes of every op but views,
    waits and ``prim`` metadata reads)."""

    def __init__(self) -> None:
        super().__init__()
        self.stats = CollectiveStats()
        self.op_counts: Counter = Counter()
        self.bytes_accessed = 0

    def _record(self, func, args, kwargs, out) -> None:
        ns = func.namespace
        name = func._opname
        if ns in _TABLES and name not in _NOT_COLLECTIVES:
            kind, where = collective_kind(func)
            if where is None:
                return
            nbytes = _tensor_bytes(out if where == "out" else
                                   (args[0] if args else next(iter(kwargs.values()))))
            self.stats.bytes_by_kind[kind] = self.stats.bytes_by_kind.get(kind, 0) + nbytes
            self.stats.count_by_kind[kind] = self.stats.count_by_kind.get(kind, 0) + 1
            self.stats.instances.append((kind, nbytes))
        if ns == "aten":
            self.op_counts[name] += 1
        if ns != "prim" and not func.is_view and name not in _NOT_COLLECTIVES:
            self.bytes_accessed += _tensor_bytes((args, kwargs, out))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if dtensor_types(types):
            return NotImplemented           # DTensor desugars first
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self._record(func, args, kwargs, out)
        return out


def collect_collective_stats() -> CollectiveTrace:
    """A `TorchDispatchMode` to run a step under: ``with
    collect_collective_stats() as trace: step(...)``, then
    ``trace.stats`` (a `CollectiveStats`), ``trace.bytes_accessed`` and
    `count_op`."""
    return CollectiveTrace()


def count_op(trace: CollectiveTrace, opcode: str) -> int:
    """Calls of the ATen op ``opcode`` (e.g. ``'mm'``, ``'bmm'``) in the
    trace."""
    return int(trace.op_counts.get(opcode, 0))


def cpu_bf16_upcast_bytes(trace: Any = None) -> int:
    """0: XLA:CPU's bf16→f32 emulation buffers, which the reference
    subtracts from its host dry run, do not exist in torch."""
    return 0


__all__ = ["COLLECTIVE_KINDS", "CollectiveStats", "CollectiveTrace",
           "UnmappedCollective", "collect_collective_stats", "collective_kind",
           "count_op", "cpu_bf16_upcast_bytes"]
