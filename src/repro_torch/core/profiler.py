"""Wall-clock profiling of op graphs on the card (paper §4.3.1).

The twin of the reference profiler (``repro.core.profiler``): the same
cache → store → measure bookkeeping and adaptive inner loop, over the
torch executor and `repro_torch.utils.timing` (which synchronizes the
card before reading the clock).  It writes the same `ProfileStore`
JSONL schema, so stores and banks move between the two packages.

A `ProfileSession` measures
  * per-op latency (cached by op signature — the paper profiles unique
    configurations; dispatch amortized like its 256-kernel batches), and
  * end-to-end latency (sequential dispatch, so framework overhead is
    included — the T_overhead of §4.2 is estimated from the gap).

Device settings play the role of the paper's 72 scenarios:
  dtype ∈ {float32, int8}  ×  executor mode ∈ {op_by_op (CPU-like),
  fused_groups (GPU-delegate-like), whole_jit (the whole graph as one
  unit: one CUDA-graph replay on the card)}  ×  simulated worker
  profiles (multi-core composition happens in `distributed_model`, from
  these single-worker measurements — same structure as the paper's
  per-core measurements).  Under ``whole_jit`` ops are still measured one
  by one; only the end-to-end time runs through the captured graph.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.executor import GraphExecutor, make_array, op_builder
from repro_torch.core.features import featurize, graph_features
from repro_torch.core.ir import OpGraph, OpNode, op_signature
from repro_torch.utils.device import DeviceLike, resolve_device
from repro_torch.utils.logging import get_logger
from repro_torch.utils.lru import LRUCache
from repro_torch.utils.timing import time_callable

log = get_logger("repro.profiler")


@dataclass(frozen=True)
class DeviceSetting:
    """One measurement scenario (paper's device × setting grid).

    ``device`` is a physical-device identity tag.  It defaults to empty —
    the single-device keys (`"dtype/mode"`) every store/hub was built
    with stay unchanged — and is set by the cross-device transfer layer
    (`repro_torch.transfer`) so banks for a *target* device coexist in one hub
    with the profiled source device's banks.
    """

    name: str
    dtype: str = "float32"         # float32 | int8
    mode: str = "op_by_op"         # op_by_op (CPU) | fused_groups (GPU-like) | whole_jit
    device: str = ""               # physical-device tag ("" = the local device)

    def __post_init__(self) -> None:
        # The tag is embedded in store/hub keys and bank *filenames*
        # ("tag:dtype/mode" → "bank__tag:dtype__mode__family.json"), so
        # the delimiters those schemes split on must not appear in it.
        if "/" in self.device or "__" in self.device or ":" in self.device:
            raise ValueError(
                f"DeviceSetting.device {self.device!r} must not contain "
                f"'/', ':' or '__' (they delimit setting keys and bank "
                f"filenames)")

    @property
    def is_gpu_like(self) -> bool:
        return self.mode == "fused_groups"


DEFAULT_SETTINGS = (
    DeviceSetting("cpu_f32", "float32", "op_by_op"),
    DeviceSetting("cpu_int8", "int8", "op_by_op"),
    DeviceSetting("gpu_f32", "float32", "fused_groups"),
)


def latency_axis(setting: DeviceSetting) -> str:
    """In-process latency-cache prefix: device tag + dtype.

    Mirrors the store's `op_axis` (which lives in the pipeline layer):
    measurements for a tagged device must never alias the local
    device's, even inside one session.  Compiled-callable caches stay
    dtype-keyed — built fns are identical across device tags.
    """
    return f"{setting.device}:{setting.dtype}" if setting.device else setting.dtype


@dataclass
class OpRecord:
    signature: str
    op_type: str
    feature_names: List[str]
    features: List[float]
    latency_s: float
    fused: List[str] = field(default_factory=list)

    def to_json(self) -> Dict[str, Any]:
        return {
            "sig": self.signature, "type": self.op_type,
            "names": self.feature_names, "x": self.features,
            "y": self.latency_s, "fused": self.fused,
        }

    @classmethod
    def from_json(cls, d: Dict[str, Any]) -> "OpRecord":
        return cls(d["sig"], d["type"], d["names"], d["x"], d["y"], d.get("fused", []))


@dataclass
class ArchRecord:
    name: str
    e2e_s: float
    op_sum_s: float
    num_ops: int
    num_kernels: int
    ops: List[OpRecord]

    def to_json(self) -> Dict[str, Any]:
        return {
            "name": self.name, "e2e": self.e2e_s, "op_sum": self.op_sum_s,
            "num_ops": self.num_ops, "num_kernels": self.num_kernels,
            "ops": [o.to_json() for o in self.ops],
        }

    @classmethod
    def from_json(cls, d: Dict[str, Any]) -> "ArchRecord":
        return cls(d["name"], d["e2e"], d["op_sum"], d["num_ops"],
                   d["num_kernels"], [OpRecord.from_json(o) for o in d["ops"]])


class ProfileSession:
    """Shares built callables + per-signature latencies across graphs.

    ``device`` is where ops run and are timed: the card by default, the
    host only for an explicit ``device="cpu"`` (tests).

    ``store`` (a `repro.pipeline.ProfileStore`, duck-typed so core stays
    independent of the pipeline layer) makes the session read-through /
    write-back persistent: op latencies and whole-graph records found in
    the store are returned without touching the device, and every new
    measurement is written back.  ``measured_ops`` counts actual timing
    runs — on a warm store it stays at zero.
    """

    def __init__(self, *, warmup: int = 1, inner: int = 4, repeats: int = 3,
                 e2e_inner: int = 2, e2e_repeats: int = 3,
                 store: Optional[Any] = None, fn_cache_size: int = 256,
                 latency_transform: Optional[Callable[[str, float], float]] = None,
                 on_measure: Optional[Callable[..., Any]] = None,
                 device: DeviceLike = "cuda"):
        self.device = resolve_device(device)
        # Built callables are bounded (LRU): each pins its weights on the
        # device.  Latencies are scalars — they stay unbounded.
        self.fn_cache: Dict[str, Callable] = LRUCache(fn_cache_size)
        self.latency_cache: Dict[str, float] = {}
        self.warmup, self.inner, self.repeats = warmup, inner, repeats
        self.e2e_inner, self.e2e_repeats = e2e_inner, e2e_repeats
        self.store = store
        # Optional (kind, seconds) → seconds map applied to every raw
        # measurement, where kind is the op type or "e2e".  Lets a
        # *real-measurement* session stand in for a differently-scaled
        # device without touching the timing methodology (store-replayed
        # synthetic devices instead override the _time_* hooks below).
        self.latency_transform = latency_transform
        # Optional hook fired once per *fresh* op measurement (cache and
        # store hits don't fire) with
        # ``(setting, op_type, (feature_names, feature_vals), latency_s)``
        # — how `repro_torch.obs.attach_session_drift` taps the profiler to
        # feed the predicted-vs-observed drift monitor.  Hook failures
        # never poison the measurement path.
        self.on_measure = on_measure
        self.measured_ops = 0
        self.measured_graphs = 0

    def stats(self) -> Dict[str, int]:
        """Session counters + cache occupancy (serving/ops introspection)."""
        return {
            "measured_ops": self.measured_ops,
            "measured_graphs": self.measured_graphs,
            "fn_cache_size": len(self.fn_cache),
            "fn_cache_capacity": self.fn_cache.maxsize,
            "latency_cache_size": len(self.latency_cache),
        }

    # -- per-op ---------------------------------------------------------------
    def _op_inputs(self, graph: OpGraph, node: OpNode, dtype: str) -> List[Any]:
        arrs = []
        for i, t in enumerate(node.inputs):
            info = graph.tensor(t)
            dt = "int8" if dtype == "int8" else info.dtype
            arrs.append(torch.from_numpy(
                make_array(info.shape, dt, seed=17 + i, scale=1.0)
            ).to(self.device))
        return arrs

    def measure_op(self, graph: OpGraph, node: OpNode, setting: DeviceSetting,
                   features: Optional[Tuple[List[str], np.ndarray]] = None) -> float:
        """Measure one op (or serve it from cache/store).

        ``features`` — precomputed ``(names, vector)`` for the node
        (e.g. from `graph_features`); without it the node is featurized
        here when a store write needs it.
        """
        return self._serve_op_latency(
            setting, op_signature(graph, node), node.op_type, node.fused,
            lambda: (features if features is not None
                     else featurize(graph, node)),
            lambda: self._time_op(graph, node, setting))

    def _serve_op_latency(self, setting: DeviceSetting, base_sig: str,
                          op_type: str, fused: Sequence[str],
                          get_features: Callable[[], Tuple],
                          produce: Callable[[], float]) -> float:
        """Cache → store read-through → ``produce()`` → count + write-back.

        The one place measurement bookkeeping lives: `measure_op` and
        record-level entry points (replay sessions' ``measure_record``)
        share it, so budget counting and store semantics cannot drift.
        """
        sig = latency_axis(setting) + ":" + base_sig
        if sig in self.latency_cache:
            return self.latency_cache[sig]
        if self.store is not None:
            rec = self.store.get_op(setting, base_sig)
            if rec is not None:
                self.latency_cache[sig] = rec.latency_s
                return rec.latency_s
        lat = produce()
        if self.latency_transform is not None:
            lat = float(self.latency_transform(op_type, lat))
        self.latency_cache[sig] = lat
        self.measured_ops += 1
        feats: Optional[Tuple] = None
        if self.store is not None:
            feats = get_features()
            names, vals = feats
            self.store.put_op(setting, OpRecord(
                signature=base_sig, op_type=op_type,
                feature_names=list(names),
                features=[float(v) for v in vals],
                latency_s=lat, fused=list(fused)))
        if self.on_measure is not None:
            try:
                self.on_measure(setting, op_type,
                                feats if feats is not None else get_features(),
                                lat)
            except Exception:                 # pragma: no cover - defensive
                log.exception("on_measure hook failed (ignored)")
        return lat

    def _time_op(self, graph: OpGraph, node: OpNode,
                 setting: DeviceSetting) -> float:
        """Raw wall-clock measurement of one op (override point: replay /
        simulated sessions substitute a latency source without touching
        the caching, counting, and store write-back in `measure_op`)."""
        sig = setting.dtype + ":" + op_signature(graph, node)
        fn = self.fn_cache.get(sig)
        if fn is None:
            fn, _ = op_builder(setting.dtype)(graph, node, self.device)
            self.fn_cache[sig] = fn
        args = self._op_inputs(graph, node, setting.dtype)
        # Adaptive amortization (paper §4.3.1 dispatches the same kernel
        # 256×): size the inner loop so each repeat spans >=1.5 ms, which
        # keeps measurement noise on µs-scale ops bounded.
        est = time_callable(fn, args, warmup=self.warmup, inner=2, repeats=1)
        inner = int(np.clip(np.ceil(1.5e-3 / max(est, 1e-7)), self.inner, 256))
        return time_callable(fn, args, warmup=0, inner=inner,
                             repeats=self.repeats)

    # -- whole graph ------------------------------------------------------------
    def _prepare_exec(self, graph: OpGraph, setting: DeviceSetting
                      ) -> Tuple[OpGraph, Optional[GraphExecutor]]:
        """(exec graph, runner) for one profiling pass (override point)."""
        # The LRU bound is for *cross-suite* growth; within one graph it
        # must hold every node's built fn at once (GraphExecutor fills
        # it up front, measure_op reads it back) or eviction would force
        # a rebuild per evicted op.  Grow capacity to the largest graph
        # profiled so far.
        self.fn_cache.maxsize = max(self.fn_cache.maxsize, len(graph.nodes))
        ex = GraphExecutor(graph, mode=setting.mode, dtype=setting.dtype,
                           fn_cache=self.fn_cache, device=self.device)
        return ex.exec_graph, ex

    def _time_e2e(self, runner: Optional[GraphExecutor], g: OpGraph,
                  setting: DeviceSetting, ops: Sequence[OpRecord]) -> float:
        """End-to-end latency of one prepared graph (override point)."""
        inputs = runner.example_inputs()
        # CPU-like settings: strictly sequential (TFLite interpreter).
        # GPU-like settings: stream dispatch (CUDA stream queue).
        sync = not setting.is_gpu_like
        return time_callable(lambda *a: runner(*a, sync_per_op=sync), inputs,
                             warmup=1, inner=self.e2e_inner,
                             repeats=self.e2e_repeats)

    def profile_graph(self, graph: OpGraph, setting: DeviceSetting) -> ArchRecord:
        if self.store is not None:
            cached = self.store.get_arch(setting, graph.fingerprint())
            if cached is not None:
                # Hydrate the in-process cache so sibling graphs sharing
                # signatures also skip measurement.
                for op in cached.ops:
                    self.latency_cache.setdefault(
                        latency_axis(setting) + ":" + op.signature,
                        op.latency_s)
                return cached
        g, runner = self._prepare_exec(graph, setting)
        # Featurize the exec graph once (cached by fingerprint); each
        # node's vector is shared between the store write in measure_op
        # and the OpRecord here (they used to be computed twice).
        # Profiled graphs are long-lived (training suites, verification
        # targets) — pin them so population-scale candidate scoring
        # can't evict their entries.
        gf = graph_features(g, pin=True)
        ops: List[OpRecord] = []
        for k, node in enumerate(g.nodes):
            names, vals = gf.node_names(k), gf.node_features(k)
            lat = self.measure_op(g, node, setting, features=(names, vals))
            ops.append(OpRecord(
                signature=op_signature(g, node),
                op_type=node.op_type,
                feature_names=list(names),
                features=[float(v) for v in vals],
                latency_s=lat,
                fused=list(node.fused),
            ))
        e2e = self._time_e2e(runner, g, setting, ops)
        if self.latency_transform is not None:
            e2e = float(self.latency_transform("e2e", e2e))
        rec = ArchRecord(
            name=graph.name,
            e2e_s=e2e,
            op_sum_s=float(sum(o.latency_s for o in ops)),
            num_ops=graph.num_ops(),
            num_kernels=len(g.nodes),
            ops=ops,
        )
        self.measured_graphs += 1
        if self.store is not None:
            self.store.put_arch(setting, graph.fingerprint(), rec)
        return rec

    def profile_suite(self, graphs: Sequence[OpGraph], setting: DeviceSetting,
                      progress_every: int = 10) -> List[ArchRecord]:
        out = []
        t0 = time.time()
        for i, g in enumerate(graphs):
            out.append(self.profile_graph(g, setting))
            if (i + 1) % progress_every == 0:
                log.info("[%s] profiled %d/%d archs (%.0fs, %d unique ops)",
                         setting.name, i + 1, len(graphs), time.time() - t0,
                         len(self.latency_cache))
        return out
