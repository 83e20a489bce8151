"""Kernel-fusion simulator — faithful port of paper Algorithm C.1.

TFLite's GPU delegate merges an op into its successor when (paper §3.2.1):
  (1) the first op has exactly one output tensor            [Alg C.1 L5]
  (2) that tensor has exactly one consumer in the graph     [L14]
  (3) the consumer uses it as its FIRST input               [L14, k==0]
      and produces a single output                          [L21]
  (4) the consumer has a "linkable" (element-wise) type     [L23]

The merged kernel count drives latency prediction on devices that fuse
(the paper shows >45% kernel reduction, ~1.22x e2e speedup).

We return a new graph of *fusion groups*: each group node keeps the
non-elementwise "anchor" op type and records the element-wise ops that
ride along in ``fused``.  Group count == number of dispatched kernels.

Multi-edge consumers (diamond collapse)
---------------------------------------
Rule (2) counts consumer *nodes*, not edges.  A consumer that reads
``out_t`` at several operand positions — which the pass itself creates
when it collapses a diamond ``A → {B, C} → add`` into a single
elementwise node with inputs ``(A_out, A_out)`` — is ONE consumer, and
fusion proceeds when its first use is position 0 (rule 3).  Every
occurrence of ``out_t`` is dropped from the merged node's inputs (the
value is produced inside the kernel now); dropped binary operands are
recorded by suffixing the fused kind with ``@self``, which the executor
resolves to the kernel's base output.  That is exact when the producer
had no fused tail of its own at merge time — the canonical diamond —
and a documented approximation for deeper self-referential stacks.
The k==0 first-use rule still applies: a consumer whose *first* read of
``out_t`` is not operand 0 blocks fusion (asserted by regression test).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence, Set, Tuple

from repro_torch.core.ir import ELEMENTWISE_TYPES, OpGraph, OpNode

# Paper Alg. C.1 Line 23: op types that can be fused into a producer.
LINKABLE_TYPES: Tuple[str, ...] = ELEMENTWISE_TYPES

# Element-wise kinds that consume a second operand.  Only these can carry
# the "@self" duplicate-operand marker (see module docstring).
BINARY_EW_KINDS: Tuple[str, ...] = (
    "add", "sub", "mul", "div", "maximum", "minimum", "pow",
    "equal", "greater", "less",
)


def strip_self(kind: str) -> str:
    """Fused kind without the ``@self`` duplicate-operand marker."""
    return kind.split("@", 1)[0]


def is_linkable(node: OpNode) -> bool:
    """IsLinkable(node) — Alg. C.1 L21-25."""
    if len(node.outputs) != 1:          # L21-22
        return False
    if node.op_type == "elementwise":
        kind = node.param("ew_kind", "add")
        return kind in LINKABLE_TYPES   # L23
    if node.op_type == "activation":
        return True                      # ACTIVATION ∈ L23 list
    if node.op_type == "elementwise_lm":
        return True                      # LM-graph analogue
    return False


@dataclass
class FusionGroup:
    """One dispatched kernel after fusion: anchor op + linked element-wise ops."""

    anchor: OpNode
    members: List[OpNode]

    @property
    def op_ids(self) -> List[int]:
        return [m.op_id for m in self.members]


def fuse_graph(graph: OpGraph) -> Tuple[List[FusionGroup], OpGraph]:
    """Run Alg. C.1 over ``graph``.

    Returns (groups, fused_graph) where ``fused_graph`` has one node per
    group (anchor type, with ``fused`` listing merged element-wise kinds)
    — the graph on which per-kernel latency predictors operate.
    """
    merged_into: Dict[int, int] = {}   # op_id -> group leader op_id
    group_members: Dict[int, List[OpNode]] = {n.op_id: [n] for n in graph.nodes}

    # MergeNodes(nodes) — Alg. C.1 L1-20.  We iterate to a fixpoint because
    # TFLite applies the pass until no merge happens (chains of element-wise
    # ops collapse into one kernel).
    alive: List[OpNode] = list(graph.nodes)
    graph_outputs = set(graph.output_ids)
    changed = True
    while changed:
        changed = False
        removed: Set[int] = set()
        new_alive: List[OpNode] = []
        ready_tensors: Set[int] = set(graph.input_ids)
        # Per-pass consumer index (tid → [(op_id, node, input position)]),
        # replacing the former O(N) scan per node: each pass is O(N + E).
        # Built from the pass's start-of-pass `alive` snapshot, exactly the
        # list the removed scan iterated.
        consumers: Dict[int, List[Tuple[int, OpNode, int]]] = {}
        for n in alive:
            for k, src in enumerate(n.inputs):
                consumers.setdefault(src, []).append((n.op_id, n, k))
        for cur in alive:
            if cur.op_id in removed:
                continue
            for t in cur.outputs:                      # L3-4
                ready_tensors.add(t)
            if len(cur.outputs) != 1:                  # L5-6
                new_alive.append(cur)
                continue
            out_t = cur.outputs[0]
            if out_t in graph_outputs:
                # Graph outputs must materialize; cannot be fused away.
                new_alive.append(cur)
                continue
            # L7-13: find candidate consumers and the first input position
            # each uses.  Deduplicated per consumer *node*: the pass's own
            # diamond collapses produce nodes that read out_t at several
            # positions, and counting per edge mistook them for fan-out > 1
            # and silently refused to fuse (see module docstring).
            cand: Dict[int, Tuple[OpNode, int]] = {}
            for oid, nxt, k in consumers.get(out_t, ()):
                if oid == cur.op_id or oid in removed:
                    continue
                if oid not in cand:          # k ascending per node → first use
                    cand[oid] = (nxt, k)
            if len(cand) != 1:                           # L14-15
                new_alive.append(cur)
                continue
            nxt, cand_index = next(iter(cand.values()))
            if cand_index != 0:                          # L14-15, k==0
                new_alive.append(cur)
                continue
            # L17: next input must be ready and next must be linkable.
            # Extension to the paper's letter: ALL of nxt's operands must
            # already be produced at cur's position, or the fused kernel
            # would consume a tensor computed later (TFLite gets this for
            # free from its serialized execution order; our builders can
            # emit residual shortcuts after the main branch).
            others_ready = all(t in ready_tensors for t in nxt.inputs)
            if nxt.inputs[0] in ready_tensors and others_ready and is_linkable(nxt):
                # L18: Merge(cur, nxt) — nxt's compute rides in cur's kernel.
                leader = merged_into.get(cur.op_id, cur.op_id)
                merged_into[nxt.op_id] = leader
                group_members[leader].extend(group_members.pop(nxt.op_id))
                # Rewire: cur adopts nxt's outputs and extra inputs.  Every
                # occurrence of out_t is dropped (produced inside the kernel
                # now); dropped binary operands get the "@self" marker.
                if nxt.op_type == "elementwise":
                    own_kind = nxt.param("ew_kind", "add")
                elif nxt.op_type == "activation":
                    own_kind = nxt.param("act", "relu")
                else:
                    own_kind = nxt.op_type
                n_base = nxt.param("n_inputs", 1)
                if (own_kind in BINARY_EW_KINDS
                        and any(t == out_t for t in nxt.inputs[1:n_base])):
                    own_kind = own_kind + "@self"
                tail_kinds: List[str] = []
                ei = n_base                 # next extra-operand position
                for kind in nxt.fused:
                    if strip_self(kind) in BINARY_EW_KINDS and kind == strip_self(kind):
                        if ei < len(nxt.inputs) and nxt.inputs[ei] == out_t:
                            kind = kind + "@self"
                        ei += 1
                    tail_kinds.append(kind)
                cur = OpNode(
                    op_id=cur.op_id,
                    op_type=cur.op_type,
                    inputs=cur.inputs + tuple(
                        t for t in nxt.inputs[1:] if t != out_t),
                    outputs=nxt.outputs,
                    params=cur.params,
                    fused=cur.fused + (own_kind,) + tuple(tail_kinds),
                )
                removed.add(nxt.op_id)
                changed = True
            new_alive.append(cur)
        alive = [n for n in new_alive if n.op_id not in removed]

    groups = [FusionGroup(anchor=n, members=group_members[merged_into.get(n.op_id, n.op_id)])
              for n in alive]

    fused = OpGraph(graph.name + ":fused")
    fused.tensors = dict(graph.tensors)
    fused._next_tensor = graph._next_tensor
    fused.input_ids = list(graph.input_ids)
    fused.output_ids = list(graph.output_ids)
    fused.nodes = list(alive)
    fused._next_op = graph._next_op
    return groups, fused


def kernel_count(graph: OpGraph) -> int:
    """Number of dispatched kernels after fusion."""
    groups, _ = fuse_graph(graph)
    return len(groups)
