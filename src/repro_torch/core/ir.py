"""Operation-graph IR — the unit of latency prediction (paper §4).

The paper predicts end-to-end inference latency by decomposing a model
file's computational graph into *operations* and predicting each one's
latency from its configuration parameters (paper Table 3).  `OpGraph` is
that computational graph: nodes are operations, edges are tensors.

Two frontends produce `OpGraph`s:
  * `repro.core.nas_space` / `repro.core.realworld` — conv-net builders
    (the paper's NAS space and real-world architectures);
  * `repro.core.graph_capture` — jaxpr tracing of LM-family models.

Two backends consume them:
  * `repro.core.executor` — turns graphs into jitted JAX callables for
    wall-clock profiling on the CPU device;
  * `repro_torch.core.cost_model` — analytical roofline costs (H100 by default).
"""
from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass, field, replace
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

# ---------------------------------------------------------------------------
# Op types.
#
# Conv-space ops follow the paper's Table 3 categories exactly; LM-space op
# types extend the same machinery (features in repro.core.features).
# ---------------------------------------------------------------------------

CONV_OPS = (
    "conv2d",            # standard convolution (group==1)
    "grouped_conv2d",    # optimized single-kernel grouped convolution
    "winograd_conv2d",   # Winograd F(2x2, 3x3) kernel (selected, §3.2.2)
    "dwconv2d",          # depthwise convolution
)

ELEMENTWISE_TYPES = (
    # Paper Alg. C.1 Line 23 "linkable" op types.
    "activation", "copy", "add", "sub", "mul", "div", "exp", "log", "sqrt",
    "square", "abs", "neg", "pow", "equal", "greater", "less", "maximum",
    "minimum",
)

OP_TYPES = CONV_OPS + (
    "fully_connected",
    "mean",              # spatial mean (global average pool / SE squeeze)
    "pool_avg",
    "pool_max",
    "concat",
    "split",
    "pad",
    "elementwise",       # generic element-wise (params['ew_kind'] in ELEMENTWISE_TYPES)
    "activation",        # separate activation node (TFLite composite acts)
    "channel_shuffle",
    "resize",            # spatial up/down-sample (encoder-decoder skeletons)
    # --- LM-family op types (TPU extension) ---
    "matmul",            # generic (batched) matmul / dot_general
    "attention",         # full self-attention (naive)
    "flash_attention",   # selected fused attention kernel
    "window_attention",  # sliding-window attention (gemma2 local layers)
    "norm",              # rmsnorm / layernorm
    "rope",
    "embedding",         # gather
    "softmax_xent",      # loss
    "moe_gmm",           # grouped expert matmul
    "ssd_scan",          # Mamba2 state-space scan
    "elementwise_lm",    # fused vector ops in LM graphs
    "collective",        # all_reduce / all_gather / ... (distributed graphs)
)


@dataclass(frozen=True)
class TensorInfo:
    """Shape+dtype of one edge of the graph."""

    shape: Tuple[int, ...]
    dtype: str = "float32"

    @property
    def size(self) -> int:
        n = 1
        for d in self.shape:
            n *= int(d)
        return n

    @property
    def nbytes(self) -> int:
        return self.size * np.dtype(self.dtype).itemsize


@dataclass(frozen=True)
class OpNode:
    """One operation of the computational graph.

    ``params`` holds the op-type-specific configuration from which latency
    features are derived (kernel size, stride, channels, group count, ...).
    ``fused`` lists op types that were merged into this node by the kernel
    fusion pass (paper Alg. C.1) — they execute inside this node's kernel.
    """

    op_id: int
    op_type: str
    inputs: Tuple[int, ...]
    outputs: Tuple[int, ...]
    params: Tuple[Tuple[str, Any], ...] = ()
    fused: Tuple[str, ...] = ()

    def param(self, key: str, default: Any = None) -> Any:
        for k, v in self.params:
            if k == key:
                return v
        return default

    @property
    def params_dict(self) -> Dict[str, Any]:
        return dict(self.params)

    def with_type(self, op_type: str) -> "OpNode":
        return replace(self, op_type=op_type)

    def with_fused(self, extra: Sequence[str]) -> "OpNode":
        return replace(self, fused=self.fused + tuple(extra))


def make_params(d: Dict[str, Any]) -> Tuple[Tuple[str, Any], ...]:
    return tuple(sorted(d.items()))


class OpGraph:
    """A DAG of operations over tensors.

    Tensors are integer ids; `tensors[tid]` gives shape/dtype.  Node order
    in ``self.nodes`` is a valid topological order (builders append in
    execution order; `validate()` checks this).
    """

    def __init__(self, name: str = "graph"):
        self.name = name
        self.nodes: List[OpNode] = []
        self.tensors: Dict[int, TensorInfo] = {}
        self.input_ids: List[int] = []
        self.output_ids: List[int] = []
        self._next_tensor = 0
        self._next_op = 0
        # Lazily-built adjacency index (node count when built, consumers
        # by tensor id, producer by tensor id); None until first query.
        self._adj: Optional[Tuple[int, Dict[int, List[OpNode]], Dict[int, OpNode]]] = None
        # Memoized fingerprint, guarded by (nodes, tensors, outputs) counts
        # so builder-style direct appends are caught like in _adjacency.
        self._fp: Optional[Tuple[Tuple[int, int, int], str]] = None

    # -- construction -------------------------------------------------------
    def add_tensor(self, shape: Sequence[int], dtype: str = "float32") -> int:
        tid = self._next_tensor
        self._next_tensor += 1
        self.tensors[tid] = TensorInfo(tuple(int(s) for s in shape), dtype)
        return tid

    def add_input(self, shape: Sequence[int], dtype: str = "float32") -> int:
        tid = self.add_tensor(shape, dtype)
        self.input_ids.append(tid)
        return tid

    def add_op(
        self,
        op_type: str,
        inputs: Sequence[int],
        out_shapes: Sequence[Sequence[int]],
        params: Optional[Dict[str, Any]] = None,
        out_dtype: str = "float32",
    ) -> List[int]:
        if op_type not in OP_TYPES:
            raise ValueError(f"unknown op_type {op_type!r}")
        outs = [self.add_tensor(s, out_dtype) for s in out_shapes]
        p = dict(params or {})
        # Build-time arity: fusion may append extra operands later; executors
        # need to know how many inputs the *base* op consumes.
        p.setdefault("n_inputs", len(tuple(inputs)))
        node = OpNode(
            op_id=self._next_op,
            op_type=op_type,
            inputs=tuple(inputs),
            outputs=tuple(outs),
            params=make_params(p),
        )
        self._next_op += 1
        self.nodes.append(node)
        self._adj = None
        return outs

    def mark_output(self, tid: int) -> None:
        self.output_ids.append(tid)

    # -- queries ------------------------------------------------------------
    def _adjacency(self) -> Tuple[Dict[int, List[OpNode]], Dict[int, OpNode]]:
        """Consumers/producer maps, rebuilt when ``nodes`` grows.

        The node-count guard also covers builders (fusion, selection,
        from_json) that append to ``nodes`` directly after construction.
        """
        if self._adj is None or self._adj[0] != len(self.nodes):
            cons: Dict[int, List[OpNode]] = {}
            prod: Dict[int, OpNode] = {}
            for n in self.nodes:
                for t in n.inputs:
                    lst = cons.setdefault(t, [])
                    if not lst or lst[-1] is not n:   # one entry per node
                        lst.append(n)
                for t in n.outputs:
                    prod[t] = n
            self._adj = (len(self.nodes), cons, prod)
        return self._adj[1], self._adj[2]

    def consumers(self, tid: int) -> List[OpNode]:
        return list(self._adjacency()[0].get(tid, ()))

    def producer(self, tid: int) -> Optional[OpNode]:
        return self._adjacency()[1].get(tid)

    def tensor(self, tid: int) -> TensorInfo:
        return self.tensors[tid]

    def validate(self) -> None:
        """Check topological order + dangling references."""
        ready = set(self.input_ids)
        for n in self.nodes:
            for t in n.inputs:
                if t not in ready:
                    raise ValueError(
                        f"{self.name}: op {n.op_id}({n.op_type}) consumes tensor "
                        f"{t} before it is produced"
                    )
            for t in n.outputs:
                if t in ready:
                    raise ValueError(f"{self.name}: tensor {t} produced twice")
                if t not in self.tensors:
                    raise ValueError(f"{self.name}: missing TensorInfo for {t}")
                ready.add(t)
        for t in self.output_ids:
            if t not in ready:
                raise ValueError(f"{self.name}: graph output {t} never produced")

    def num_ops(self) -> int:
        return len(self.nodes)

    def op_type_counts(self) -> Dict[str, int]:
        counts: Dict[str, int] = {}
        for n in self.nodes:
            counts[n.op_type] = counts.get(n.op_type, 0) + 1
        return counts

    # -- serialization ------------------------------------------------------
    def to_json(self) -> Dict[str, Any]:
        return {
            "name": self.name,
            "nodes": [
                {
                    "op_id": n.op_id,
                    "op_type": n.op_type,
                    "inputs": list(n.inputs),
                    "outputs": list(n.outputs),
                    "params": [list(p) for p in n.params],
                    "fused": list(n.fused),
                }
                for n in self.nodes
            ],
            "tensors": {
                str(t): {"shape": list(info.shape), "dtype": info.dtype}
                for t, info in self.tensors.items()
            },
            "inputs": list(self.input_ids),
            "outputs": list(self.output_ids),
        }

    @classmethod
    def from_json(cls, d: Dict[str, Any]) -> "OpGraph":
        g = cls(d["name"])
        for t, info in d["tensors"].items():
            g.tensors[int(t)] = TensorInfo(tuple(info["shape"]), info["dtype"])
        g._next_tensor = max(g.tensors, default=-1) + 1
        for nd in d["nodes"]:
            g.nodes.append(
                OpNode(
                    op_id=nd["op_id"],
                    op_type=nd["op_type"],
                    inputs=tuple(nd["inputs"]),
                    outputs=tuple(nd["outputs"]),
                    params=tuple((k, v) for k, v in nd["params"]),
                    fused=tuple(nd["fused"]),
                )
            )
        g._next_op = max((n.op_id for n in g.nodes), default=-1) + 1
        g.input_ids = list(d["inputs"])
        g.output_ids = list(d["outputs"])
        return g

    def fingerprint(self) -> str:
        """Content hash of the graph (cached — LRU lookups re-query it)."""
        guard = (len(self.nodes), len(self.tensors), len(self.output_ids))
        if self._fp is None or self._fp[0] != guard:
            blob = json.dumps(self.to_json(), sort_keys=True).encode()
            self._fp = (guard, hashlib.sha256(blob).hexdigest()[:16])
        return self._fp[1]


def op_signature(graph: OpGraph, node: OpNode) -> str:
    """Canonical dedup key for 'same op config' (profiling cache key).

    Two ops with identical type, params, input shapes and dtypes have
    identical latency distributions — the paper profiles unique configs.
    """
    in_shapes = [list(graph.tensors[t].shape) + [graph.tensors[t].dtype] for t in node.inputs]
    out_shapes = [list(graph.tensors[t].shape) for t in node.outputs]
    blob = json.dumps(
        {
            "t": node.op_type,
            "p": [list(p) for p in node.params],
            "i": in_shapes,
            "o": out_shapes,
            "f": sorted(node.fused),
        },
        sort_keys=True,
    )
    return hashlib.sha256(blob.encode()).hexdigest()[:20]
