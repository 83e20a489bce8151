"""`LatencyService` — the single path from graphs to predicted latencies.

    service = LatencyService.build(train_graphs, setting,
                                   store="reports/profile_store.jsonl")
    report = service.predict_e2e(graph, setting)   # PredictionReport

Composes the paper's §4.2 formula through a trained `PredictorHub`
bank, with two serving-oriented layers on top:

  * a graph-fingerprint LRU cache — repeated queries for the same
    architecture (NAS loops re-scoring candidates, serving admission
    control) skip featurization and prediction entirely;
  * batched multi-graph queries — `predict_batch` pulls each uncached
    graph's `GraphFeatures` (featurized once per fingerprint, process-
    wide), groups matrices by op type, and calls each per-type
    predictor once over the whole batch; RF/GBDT run their flattened
    struct-of-arrays ensembles (docs/PIPELINE.md "Prediction fast
    path") instead of per-row node walks.

GPU-like settings (``fused_groups``) are predicted on the fused graph,
mirroring how they were profiled.

One service can serve many devices: banks registered in the hub under
device-tagged setting keys (`repro_torch.transfer`'s calibrated target banks)
resolve through the same ``predict_e2e(graph, setting)`` call — the
setting's key picks the bank, and reports/caches are keyed per device.

The service is thread-safe: the report cache, hit/miss/backend
counters, and the per-call backend swap are all guarded, so server
threads can hammer ``predict_e2e``/``predict_batch`` concurrently
without lost cache entries or cross-wired counters.  The predictor math
itself runs outside the cache lock — concurrent fresh queries for the
*same* graph may both compute, but they compute the same
(deterministic) report, so last-write-wins insertion is benign.

Port notes (twin of the reference's ``repro.pipeline.service``): the
service serves on ``device`` — the card unless ``device="cpu"`` — and
its device tier is ``"cuda"`` (the fused CUDA kernel, one launch per op
type per flush) or ``"torch"`` on the host.  Counters live in the
`repro_torch.obs` registry under the reference's names, and the spans
are the reference's; a span's ``backend`` attribute holds the port's
tier names (``cuda``, ``torch``, ``numpy``, ``direct``).
"""
from __future__ import annotations

import threading
from collections import OrderedDict
from dataclasses import dataclass, replace
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.core.composition import PredictorBank
from repro_torch.core.features import graph_features
from repro_torch.core.predictors.flat import (DEVICE_TIERS, device_tier,
                                              resolve_backend)
from repro_torch.core.fusion import fuse_graph
from repro_torch.core.ir import OpGraph
from repro_torch.core.profiler import DeviceSetting, ProfileSession
from repro_torch.kernels.tree_gather import residency_counters
from repro_torch.obs import Observability
from repro_torch.pipeline.hub import PredictorHub
from repro_torch.pipeline.store import ProfileStore, setting_key
from repro_torch.utils.device import DeviceLike, resolve_device
from repro_torch.utils.logging import get_logger

log = get_logger("repro.pipeline.service")


@dataclass(frozen=True)
class PredictionReport:
    """One end-to-end prediction with its per-op breakdown."""

    graph_name: str
    fingerprint: str
    setting: str                       # "dtype/mode" key
    predictor: str                     # family the bank was trained with
    e2e_s: float
    per_op: Tuple[Tuple[str, float], ...]   # (op_type, seconds) per kernel
    overhead_s: float
    num_ops: int
    num_kernels: int
    from_cache: bool = False
    # Which generation of the bank answered (PredictorHub epoch stamped
    # at train/register/swap_bank) — under a live rollover, in-flight
    # flushes report the old epoch, post-swap admissions the new one.
    bank_epoch: int = 0

    def to_json(self) -> Dict[str, Any]:
        return {
            "graph": self.graph_name, "fp": self.fingerprint,
            "setting": self.setting, "predictor": self.predictor,
            "e2e_s": self.e2e_s, "overhead_s": self.overhead_s,
            "num_ops": self.num_ops, "num_kernels": self.num_kernels,
            "per_op": [list(p) for p in self.per_op],
            "from_cache": self.from_cache,
            "bank_epoch": self.bank_epoch,
        }

    @classmethod
    def from_json(cls, d: Dict[str, Any]) -> "PredictionReport":
        """Inverse of `to_json` — the RPC wire format round-trips reports
        bit-exactly (floats survive json; see tests/test_rpc.py)."""
        return cls(
            graph_name=d["graph"], fingerprint=d["fp"],
            setting=d["setting"], predictor=d["predictor"],
            e2e_s=float(d["e2e_s"]),
            per_op=tuple((str(t), float(v)) for t, v in d["per_op"]),
            overhead_s=float(d["overhead_s"]),
            num_ops=int(d["num_ops"]), num_kernels=int(d["num_kernels"]),
            from_cache=bool(d.get("from_cache", False)),
            bank_epoch=int(d.get("bank_epoch", 0)),
        )


class LatencyService:
    """Facade over ProfileStore → PredictorHub → composed prediction."""

    def __init__(self, hub: PredictorHub, *,
                 default_setting: Optional[DeviceSetting] = None,
                 predictor: str = "gbdt", cache_size: int = 1024,
                 inference_backend: str = "auto",
                 obs: Optional[Observability] = None,
                 device: DeviceLike = "cuda"):
        self.device = resolve_device(device)
        self.hub = hub
        self.default_setting = default_setting
        self.predictor = predictor
        self.cache_size = int(cache_size)
        # Tree-traversal backend for batched queries: "auto" picks numpy
        # vs the device tier of ``device`` per call by row×tree slot
        # count (`repro_torch.core.predictors.flat.resolve_backend`).
        # Which backend each per-type call actually took is recorded in
        # ``backend_runs`` (see `stats`).
        self.inference_backend = inference_backend
        # Counters live in the obs registry (share one bundle across
        # service/batcher/server for whole-system snapshots); the
        # `backend_runs`/`cache_hits`/... properties below are views.
        self.obs = obs or Observability.quiet()
        self._oid = self.obs.instance("service")
        reg = self.obs.registry
        for name in ("service_predict_batch_calls_total",
                     "service_cache_hits_total",
                     "service_cache_misses_total",
                     "service_device_fused_runs_total",
                     "service_backend_runs_total"):
            reg.counter(name)
        self._cache: "OrderedDict[Tuple[str, str, str], PredictionReport]" = OrderedDict()
        self._hub_version = hub.version
        # Guards the report cache + every counter (reentrant: _insert
        # runs under predict_batch's critical section too).
        self._lock = threading.RLock()
        # Fallback for `_run_model`'s backend swap when a model predates
        # the per-model `backend_swap_lock` (stubs, hand-built doubles).
        self._backend_lock = threading.Lock()
        # Populated by `build`; optional otherwise.
        self.store: Optional[ProfileStore] = None
        self.session: Optional[ProfileSession] = None

    # -- registry-backed counters --------------------------------------------
    def _inc(self, name: str, value: int = 1, **labels: Any) -> None:
        self.obs.registry.inc(name, value, service=self._oid, **labels)

    def _cnt(self, name: str) -> int:
        return int(self.obs.registry.get(name, service=self._oid))

    @property
    def predict_batch_calls(self) -> int:
        return self._cnt("service_predict_batch_calls_total")

    @property
    def cache_hits(self) -> int:
        return self._cnt("service_cache_hits_total")

    @property
    def cache_misses(self) -> int:
        return self._cnt("service_cache_misses_total")

    @property
    def device_fused_runs(self) -> int:
        return self._cnt("service_device_fused_runs_total")

    @property
    def backend_runs(self) -> Dict[str, int]:
        vals = self.obs.registry.labeled_values(
            "service_backend_runs_total", "backend", service=self._oid)
        return {k: int(v) for k, v in vals.items()}

    # -- construction --------------------------------------------------------
    @classmethod
    def build(
        cls,
        graphs: Sequence[OpGraph],
        setting: DeviceSetting,
        *,
        store: Union[ProfileStore, str, None] = None,
        session: Optional[ProfileSession] = None,
        predictor: str = "gbdt",
        hparams: Optional[Dict[str, Any]] = None,
        overhead_model: str = "affine",
        train_graphs: Optional[Sequence[OpGraph]] = None,
        hub_root: Optional[str] = None,
        cache_size: int = 1024,
        device: DeviceLike = "cuda",
    ) -> "LatencyService":
        """Profile ``graphs`` through a store-backed session, train a bank,
        and return a ready-to-serve service.

        Profiling is incremental: signatures already in ``store`` are not
        re-measured, so repeated builds (new scenarios, extra graphs)
        only pay for what is new.  ``train_graphs`` (default: ``graphs``)
        selects, by fingerprint, which profiled graphs the bank trains
        on — pass a subset to hold out test architectures.  Profiling
        and serving both run on ``device``.
        """
        if session is not None and session.store is not None:
            store = session.store    # the session's store is authoritative
        elif isinstance(store, str):
            store = ProfileStore(store)
        elif store is None:
            store = ProfileStore()
        if session is None:
            session = ProfileSession(store=store, device=device)
        else:
            session.store = store
        session.profile_suite(graphs, setting)
        hub = PredictorHub(hub_root, device=device)
        fps = [g.fingerprint() for g in (train_graphs if train_graphs is not None
                                         else graphs)]
        hub.train(store, setting, predictor, hparams=hparams,
                  overhead_model=overhead_model, fingerprints=fps)
        svc = cls(hub, default_setting=setting, predictor=predictor,
                  cache_size=cache_size, device=device)
        svc.store = store
        svc.session = session
        return svc

    # -- prediction ----------------------------------------------------------
    def _resolve(self, setting: Optional[DeviceSetting]) -> DeviceSetting:
        setting = setting or self.default_setting
        if setting is None:
            raise ValueError("no DeviceSetting given and no default set")
        return setting

    def _bank(self, setting: DeviceSetting, family: str
              ) -> Tuple[PredictorBank, int]:
        """(bank, epoch) snapshot — a flush holds this pair for its whole
        lifetime, so a concurrent `swap_bank` never splits a batch
        across bank generations."""
        bank, epoch = self.hub.get_with_epoch(setting, family)
        if bank is None:
            raise KeyError(
                f"no trained bank for ({setting_key(setting)}, {family}) — "
                f"call PredictorHub.train or LatencyService.build first")
        return bank, epoch

    def predict_e2e(self, graph: OpGraph,
                    setting: Optional[DeviceSetting] = None,
                    predictor: Optional[str] = None) -> PredictionReport:
        """Predicted end-to-end latency of one graph (LRU-cached)."""
        return self.predict_batch([graph], setting, predictor)[0]

    def predict_batch(self, graphs: Sequence[OpGraph],
                      setting: Optional[DeviceSetting] = None,
                      predictor: Optional[str] = None) -> List[PredictionReport]:
        """Batched query: one predictor call per op type across all graphs."""
        setting = self._resolve(setting)
        family = predictor or self.predictor
        skey = setting_key(setting)
        out: List[Optional[PredictionReport]] = [None] * len(graphs)
        fresh: List[Tuple[int, str, OpGraph]] = []   # (position, fp, graph)
        # Fingerprinting mutates the graph's memo slot — do it outside
        # the lock (graphs are caller-owned; the cache/counters aren't).
        fps = [g.fingerprint() for g in graphs]
        span = self.obs.tracer.start_span(
            "service.predict_batch",
            attrs={"setting": skey, "family": family, "graphs": len(graphs)})
        with self._lock:
            self._inc("service_predict_batch_calls_total")
            if self._hub_version != self.hub.version:   # bank(s) retrained
                self._cache.clear()
                self._hub_version = self.hub.version
            bank_version = self._hub_version    # the version we compute with
            for i, g in enumerate(graphs):
                fp = fps[i]
                ck = (fp, skey, family)
                hit = self._cache.get(ck)
                if hit is not None:
                    self._cache.move_to_end(ck)
                    self._inc("service_cache_hits_total")
                    out[i] = replace(hit, from_cache=True)
                else:
                    self._inc("service_cache_misses_total")
                    fresh.append((i, fp, g))
        span.set_attr("fresh", len(fresh))
        if not fresh:
            span.end()
            return out  # type: ignore[return-value]
        try:
            return self._predict_fresh(setting, family, skey, out, fresh,
                                       bank_version, span)
        except BaseException:
            span.end("error")
            raise

    def _predict_fresh(self, setting: DeviceSetting, family: str, skey: str,
                       out: List[Optional[PredictionReport]],
                       fresh: List[Tuple[int, str, OpGraph]],
                       bank_version: int, span: Any
                       ) -> List[PredictionReport]:
        """The uncached tail of `predict_batch` (split out so the span
        around it ends exactly once on every exit path)."""
        bank, bank_epoch = self._bank(setting, family)
        # Fused-mode scenarios are profiled (and therefore predicted) on
        # the fused graph — same rewrite GraphExecutor applies.
        exec_graphs = []
        for i, fp, g in fresh:
            exec_graphs.append(fuse_graph(g)[1] if setting.is_gpu_like else g)

        # Gather feature matrices grouped by op type across every fresh
        # graph.  `graph_features` memoizes per fingerprint, so a graph
        # the process has seen before (NAS re-scoring after a cache
        # clear, retraining) contributes without re-running featurizers.
        gfs: Dict[str, List[Any]] = {}          # op_type → GraphFeatures refs
        slots: Dict[str, List[Tuple[int, int]]] = {}  # op_type → (fresh idx, node idx)
        for j, g in enumerate(exec_graphs):
            gf = graph_features(g)
            for op_type in gf.matrix:
                gfs.setdefault(op_type, []).append(gf)
                slots.setdefault(op_type, []).extend(
                    (j, int(k)) for k in gf.index[op_type])

        # One predictor call per op type; unseen types contribute 0
        # (same fallback as PredictorBank.predict_op).  `_run_model`
        # assembles the batch matrix itself — float32 straight to the
        # device for the fused path, float64 for the host path — so the
        # precision of the backend it resolves is what gets built.
        per_op: List[List[Optional[Tuple[str, float]]]] = [
            [None] * len(g.nodes) for g in exec_graphs]
        for op_type, group in gfs.items():
            model = bank.predictors.get(op_type)
            if model is None:
                preds = np.zeros(len(slots[op_type]))
            else:
                preds = self._run_model(model, group, op_type)  # clamped ≥ 0
            for (j, k), p in zip(slots[op_type], preds):
                per_op[j][k] = (op_type, float(p))

        for (i, fp, g), eg, ops in zip(fresh, exec_graphs, per_op):
            overhead = bank.overhead + bank.overhead_per_kernel * len(eg.nodes)
            total = overhead + bank.op_sum_scale * sum(p for _, p in ops)
            report = PredictionReport(
                graph_name=g.name, fingerprint=fp, setting=skey,
                predictor=family, e2e_s=float(total),
                per_op=tuple(ops), overhead_s=float(overhead),
                num_ops=g.num_ops(), num_kernels=len(eg.nodes),
                bank_epoch=bank_epoch,
            )
            with self._lock:
                # Don't poison a cache another thread just cleared on a
                # retrain: this report was computed against the bank
                # version snapshotted above, so it only enters the cache
                # while that version is still current.
                if self._hub_version == bank_version:
                    self._insert((fp, skey, family), report)
            out[i] = report
        span.end()
        return out  # type: ignore[return-value]

    def cache_peek(self, graph: OpGraph,
                   setting: Optional[DeviceSetting] = None,
                   predictor: Optional[str] = None
                   ) -> Optional[PredictionReport]:
        """Cached report for one graph, or None — without computing.

        The RPC batcher's admission short-circuit: a hit is answered
        before the request ever enqueues (and counts as a cache hit); a
        miss counts nothing here — the flush's `predict_batch` will
        account for it exactly once.
        """
        setting = self._resolve(setting)
        ck = (graph.fingerprint(), setting_key(setting),
              predictor or self.predictor)
        with self._lock:
            if self._hub_version != self.hub.version:
                self._cache.clear()
                self._hub_version = self.hub.version
            hit = self._cache.get(ck)
            if hit is None:
                return None
            self._cache.move_to_end(ck)
            self._inc("service_cache_hits_total")
            return replace(hit, from_cache=True)

    def predict_multi(self, graphs: Sequence[OpGraph],
                      settings: Sequence[DeviceSetting],
                      predictor: Optional[str] = None
                      ) -> Dict[str, List[PredictionReport]]:
        """One batched query per device setting over the same graphs.

        The multi-device NAS constraint check: each setting resolves to
        its own bank (transfer-registered target devices included) and
        costs exactly one `predict_batch` call; featurization is shared
        across settings through the fingerprint cache.  Keys are the
        settings' canonical `setting_key` strings.
        """
        out: Dict[str, List[PredictionReport]] = {}
        for s in settings:
            out[setting_key(s)] = self.predict_batch(graphs, s, predictor)
        return out

    # -- model dispatch ------------------------------------------------------
    def _run_model(self, model, x, op_type: Optional[str] = None
                   ) -> np.ndarray:
        """One per-op-type predictor call, with the backend heuristic.

        ``x`` is either a ready float64 matrix (direct callers, tests)
        or the flush's list of `GraphFeatures` for ``op_type`` — the
        latter lets this method build the batch in the precision the
        resolved backend wants: float32 fed straight to the device for
        the fused path, float64 for the host path, never both.

        Tree-ensemble models (or calibrated wrappers around them) run
        under this service's ``inference_backend`` policy; the resolved
        backend is tallied in ``backend_runs`` so benchmarks can assert
        which path population-scale scoring actually took.
        """
        group = None if isinstance(x, np.ndarray) else x

        def host_x() -> np.ndarray:
            if group is None:
                return x
            ms = [gf.matrix[op_type] for gf in group]
            return ms[0] if len(ms) == 1 else np.concatenate(ms, axis=0)

        # `tree_model()` sees through wrappers (calibrated transfer
        # predictors); non-tree families and stub models go direct.
        flat_model = model.tree_model() if hasattr(model, "tree_model") \
            else None
        if flat_model is None:
            self._inc("service_backend_runs_total", backend="direct")
            self.obs.tracer.event("service.kernel",
                                  attrs={"op_type": op_type or "",
                                         "backend": "direct"})
            return model.predict(host_x())
        n_rows = (len(x) if group is None
                  else sum(len(gf.matrix[op_type]) for gf in group))
        backend = resolve_backend(self.inference_backend,
                                  n_rows * flat_model.flat().n_trees,
                                  self.device)
        span = self.obs.tracer.start_span(
            "service.kernel", attrs={"op_type": op_type or "",
                                     "backend": backend, "rows": n_rows})
        # Device tiers on an unwrapped tree model take the fused path:
        # standardize → traverse → reduce → clamp in one kernel launch
        # on the resident bank, fed float32 feature matrices with no
        # host float64 bounce.  No backend-knob swap is involved, so
        # concurrent flushes of the same model don't serialize here.
        # (Calibrated wrappers still resolve device tiers — their inner
        # traversal goes through the swap path below, on the card the
        # leaves kernel, and benefits from bank residency, just not from
        # fusion.)
        red_fn = getattr(model, "_device_reduction", None)
        if (backend in ("cuda", "torch") and group is not None
                and flat_model is model
                and red_fn is not None and red_fn() is not None):
            ms = [gf.matrix32(op_type) for gf in group]
            x32 = ms[0] if len(ms) == 1 else np.concatenate(ms, axis=0)
            dev = (self.device if backend == device_tier(self.device)
                   else DEVICE_TIERS[backend])
            try:
                preds = model.predict_on_device(x32, device=dev)
            except BaseException:
                span.end("error")
                raise
            self._inc("service_backend_runs_total", backend=backend)
            self._inc("service_device_fused_runs_total")
            span.set_attr("fused", True)
            span.end()
            return preds
        # The knob is model state shared by every thread serving this
        # bank — swap, predict, and restore as one atomic section.  The
        # lock lives on the model (calibrated wrappers across settings
        # can share one underlying flat model), so threads serving
        # *different* models still predict in parallel.
        xh = host_x()
        swap_lock = getattr(flat_model, "backend_swap_lock",
                            self._backend_lock)
        try:
            with swap_lock:
                prev = flat_model.inference_backend
                flat_model.inference_backend = backend
                try:
                    preds = model.predict(xh)
                finally:
                    flat_model.inference_backend = prev
        except BaseException:
            span.end("error")
            raise
        self._inc("service_backend_runs_total", backend=backend)
        span.end()
        return preds

    # -- introspection -------------------------------------------------------
    def bank_epochs(self) -> Dict[str, Dict[str, int]]:
        """Per-bank rollover epochs (`PredictorHub.epochs`) — surfaced
        through the RPC ``health`` endpoint so a fleet can verify a
        `swap_bank` actually landed on every serving worker."""
        return self.hub.epochs()

    def available(self) -> List[Tuple[str, str]]:
        """(setting key, family) of every in-memory bank — the scenarios
        this service can answer for right now (transfer-registered
        target devices included)."""
        return sorted(self.hub.banks)

    # -- cache ---------------------------------------------------------------
    def _insert(self, key: Tuple[str, str, str], report: PredictionReport) -> None:
        # Caller holds self._lock: the insert + eviction loop must be
        # atomic (two racing evictors can pop an already-empty head).
        self._cache[key] = report
        self._cache.move_to_end(key)
        while len(self._cache) > self.cache_size:
            self._cache.popitem(last=False)

    def cache_info(self) -> Dict[str, int]:
        with self._lock:
            return {"size": len(self._cache), "capacity": self.cache_size,
                    "hits": self.cache_hits, "misses": self.cache_misses}

    def backend_run_counts(self) -> Dict[str, int]:
        """Snapshot of ``backend_runs`` — cheap enough for the RPC
        batcher to diff around every flush (per-flush attribution)."""
        with self._lock:
            return dict(self.backend_runs)

    def device_residency(self) -> Dict[str, Any]:
        """What is resident on the device right now, plus lifetime
        upload totals.  Never forces an upload: banks that have not been
        queried through a device tier report nothing."""
        resident = {"banks": 0, "bytes": 0, "bank_uploads": 0,
                    "inputs_staged": 0, "sharded_banks": 0}
        for bank in list(self.hub.banks.values()):
            for model in bank.predictors.values():
                tm = model.tree_model() if hasattr(model, "tree_model") \
                    else None
                st = tm.device_stats() if (
                    tm is not None and hasattr(tm, "device_stats")) else None
                if st is None:
                    continue
                resident["banks"] += 1
                resident["bytes"] += st["nbytes"]
                resident["bank_uploads"] += st["uploads"]
                resident["inputs_staged"] += st["inputs_staged"]
                resident["sharded_banks"] += int(st["sharded"])
        out: Dict[str, Any] = dict(resident)
        out["lifetime"] = residency_counters()
        return out

    def stats(self) -> Dict[str, Any]:
        """Cache counters + which tree backend batched queries ran on
        (one consistent snapshot — the lock is reentrant, so nesting
        `cache_info` keeps the two views in one critical section)."""
        with self._lock:
            out = {
                **self.cache_info(),
                "predict_batch_calls": self.predict_batch_calls,
                "inference_backend": self.inference_backend,
                "backend_runs": dict(self.backend_runs),
                "device_fused_runs": self.device_fused_runs,
                "hub_epoch": self.hub.epoch,
            }
        # Outside the counter lock: walks hub banks (its own structures).
        out["device_residency"] = self.device_residency()
        return out

    def clear_cache(self) -> None:
        with self._lock:
            self._cache.clear()
