"""Flattened (struct-of-arrays) tree ensembles — the compiled fast path.

A fitted `RegressionTree` stores `_Node` dataclasses; predicting walks
them one Python hop at a time per row.  `FlatEnsemble` compiles one or
more trees into five contiguous arrays

    feature[j]    split feature of node j, or -1 for a leaf
    threshold[j]  split threshold (x[f] <= thr goes left)
    left[j]       absolute child index (leaves self-loop: left == right == j)
    right[j]
    value[j]      leaf prediction

with one root index per tree, so batched traversal advances every
(row × tree) slot together with vectorized gathers.  Leaf self-loops
make each step idempotent — a slot that reached its leaf stays there —
so ``max_depth`` fixed passes replace per-slot active bookkeeping and
the same property drives the fixed-depth device tiers
(`repro_torch.kernels.tree_gather`).

The traversal's hot layout is precomputed once per ensemble: `intp`
indices (numpy fancy indexing converts anything else per call) and an
interleaved ``children[2j], children[2j+1]`` array so the child step is
a single gather ``children[2·node + (x > thr)]``.

The numpy backend is bit-identical to the node-walk oracle: identical
float64 comparisons route to identical leaves holding identical values.
The device tiers run in float32 on a resident `CudaBank`: ``"cuda"`` is
the hand-written kernels on the card, ``"torch"`` the plain torch
version of the same traversal on a CPU bank (tests only).
"""
from __future__ import annotations

import threading
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np

# rows × trees below which backend="auto" stays on the numpy host tier.
# 0 = always the device tier: chip_smoke.py's `auto_curve` (the fused
# path with its upload and download, as serving pays it, against numpy
# over 2^10 … 2^22 slots) puts the card ahead at every point, from its
# smallest, 900 slots (0.11–0.23 ms against numpy's 0.24–0.60 ms over
# four runs on an NVIDIA H100 80GB HBM3, 700 W), so there is no crossover
# to set.  No threshold measured for the reference's TPU tiers is carried
# over.
AUTO_DEVICE_MIN_SLOTS = 0

# Concrete tree backends and the device each one's bank lives on.
DEVICE_TIERS = {"cuda": "cuda", "torch": "cpu"}


def device_tier(device) -> str:
    """The device tier that serves a bank on ``device``: the CUDA
    kernels on the card, the plain torch version on the host."""
    import torch

    return "cuda" if torch.device(device).type == "cuda" else "torch"


def resolve_backend(backend: str, n_slots: int, device="cuda") -> str:
    """Concrete backend for a query of ``n_slots`` row×tree slots.

    The one place the "auto" heuristic lives: `FlatEnsemble.predict_trees`
    and batch-serving layers that want to *record* which backend a call
    will take (`LatencyService.stats`) resolve through it, so the
    threshold cannot drift between decision and bookkeeping.

    "auto" picks numpy below `AUTO_DEVICE_MIN_SLOTS`, and otherwise the
    device tier of ``device`` (the bank's device): "cuda" or "torch".
    """
    if backend == "auto":
        if n_slots < AUTO_DEVICE_MIN_SLOTS:
            return "numpy"
        return device_tier(device)
    if backend not in ("numpy", "torch", "cuda"):
        raise ValueError(f"unknown tree backend {backend!r}")
    return backend


class FlatEnsemble:
    """Struct-of-arrays form of a bank of regression trees."""

    __slots__ = ("feature", "threshold", "left", "right", "value", "roots",
                 "max_depth", "_fclamp", "_children", "_roots_ip",
                 "_device_bank")

    def __init__(self, feature: np.ndarray, threshold: np.ndarray,
                 left: np.ndarray, right: np.ndarray, value: np.ndarray,
                 roots: np.ndarray, max_depth: int):
        self.feature = feature
        self.threshold = threshold
        self.left = left
        self.right = right
        self.value = value
        self.roots = roots
        self.max_depth = int(max_depth)
        # Hot traversal layout (see module docstring).
        self._fclamp = np.maximum(feature, 0).astype(np.intp)
        children = np.empty(2 * len(feature), dtype=np.intp)
        children[0::2] = left
        children[1::2] = right
        self._children = children
        self._roots_ip = roots.astype(np.intp)
        # Lazy persistent device residency (kernels.tree_gather.CudaBank):
        # uploaded once, reused across flushes, dies with this ensemble —
        # retrain/bank-swap rebuilds the FlatEnsemble, which IS the
        # invalidation.
        self._device_bank: Optional[Any] = None

    @property
    def n_trees(self) -> int:
        return len(self.roots)

    @property
    def n_nodes(self) -> int:
        return len(self.feature)

    # -- construction ---------------------------------------------------------
    @classmethod
    def from_trees(cls, trees: Sequence) -> "FlatEnsemble":
        """Flatten fitted trees (anything with a `_Node`-style `.nodes`)."""
        if not trees:
            raise ValueError("cannot flatten an empty tree list")
        total = sum(len(t.nodes) for t in trees)
        if total == 0:
            raise ValueError("cannot flatten unfitted trees (no nodes)")
        feature = np.full(total, -1, dtype=np.int32)
        threshold = np.zeros(total, dtype=np.float64)
        left = np.zeros(total, dtype=np.int32)
        right = np.zeros(total, dtype=np.int32)
        value = np.zeros(total, dtype=np.float64)
        roots = np.zeros(len(trees), dtype=np.int32)
        off = 0
        for ti, tree in enumerate(trees):
            if not tree.nodes:
                raise ValueError("cannot flatten an unfitted tree")
            roots[ti] = off            # _build always creates the root first
            for i, nd in enumerate(tree.nodes):
                j = off + i
                if nd.is_leaf:
                    left[j] = right[j] = j
                    value[j] = nd.value
                else:
                    feature[j] = nd.feature
                    threshold[j] = nd.threshold
                    left[j] = off + nd.left
                    right[j] = off + nd.right
            off += len(tree.nodes)
        return cls(feature, threshold, left, right, value, roots,
                   max_depth=cls._measure_depth(feature, left, right, roots))

    @staticmethod
    def _measure_depth(feature: np.ndarray, left: np.ndarray,
                       right: np.ndarray, roots: np.ndarray) -> int:
        depth = 0
        frontier = roots[feature[roots] >= 0]
        while frontier.size:
            frontier = np.concatenate([left[frontier], right[frontier]])
            frontier = frontier[feature[frontier] >= 0]
            depth += 1
        return depth

    # -- device residency -----------------------------------------------------
    def device_bank(self, device="cuda", devices=None):
        """This ensemble's resident `CudaBank` on ``device`` (uploaded on
        first use; a request for another device re-uploads there).  A
        ``devices`` list (re)builds it sharded over those devices; without
        one, the resident bank is kept as it was built, and a new bank
        takes `CudaBank.from_flat`'s default (`flush_mesh`); a list of
        fewer than two devices means unsharded."""
        from repro_torch.kernels.tree_gather import CudaBank
        from repro_torch.utils.device import resolve_device

        dev = resolve_device(device)
        db = self._device_bank
        want = None if devices is None or len(devices) < 2 else \
            [resolve_device(d) for d in devices]
        if db is None or db.device != dev or (devices is not None and db.devices != want):
            db = self._device_bank = CudaBank.from_flat(self, dev, devices)
        return db

    # -- prediction -----------------------------------------------------------
    def predict_trees(self, x: np.ndarray, backend: str = "numpy") -> np.ndarray:
        """Leaf value of every tree for every row → (n_rows, n_trees).

        ``backend``: "numpy" (default, bit-exact float64), "cuda" (the
        CUDA kernel on a bank resident on the card), "torch" (the plain
        torch traversal on a host bank), or "auto" (tiered by
        `resolve_backend` on the device of the resident bank, the card
        when none is resident yet).
        """
        x = np.ascontiguousarray(x, dtype=np.float64)
        if x.ndim != 2:
            raise ValueError(f"X must be 2-D, got {x.shape}")
        if backend == "auto":
            db = self._device_bank
            backend = resolve_backend("auto", x.shape[0] * self.n_trees,
                                      db.device if db is not None else "cuda")
        if backend in DEVICE_TIERS:
            from repro_torch.kernels.tree_gather import predict_trees_device
            return predict_trees_device(self, x, DEVICE_TIERS[backend])
        if backend != "numpy":
            raise ValueError(f"unknown tree backend {backend!r}")
        return self._predict_trees_np(x)

    def _predict_trees_np(self, x: np.ndarray) -> np.ndarray:
        n, d = x.shape
        t = self.n_trees
        nid = np.tile(self._roots_ip, n)              # slot s = (row s//t, tree s%t)
        base = np.repeat(np.arange(n, dtype=np.intp) * d, t)
        xf = x.ravel()
        thr, children, f = self.threshold, self._children, self._fclamp
        for _ in range(self.max_depth):
            xv = xf[base + f[nid]]
            nid = children[2 * nid + (xv > thr[nid])]
        return self.value[nid].reshape(n, t)


class FlattenedTreeModel:
    """Lazy-flattening state shared by the tree-ensemble predictors.

    Subclasses own ``self.trees`` (fitted `RegressionTree`s); the mixin
    owns the compiled `FlatEnsemble` and the runtime backend knob.
    Call `_init_flat()` from ``__init__`` and `_invalidate_flat()`
    whenever ``trees`` is replaced (fit, deserialization).
    """

    trees: Sequence

    def _init_flat(self) -> None:
        self._flat: Optional[FlatEnsemble] = None
        # Runtime knob (not serialized model state): numpy | torch | cuda
        # | auto.
        self.inference_backend = "numpy"
        # Serializes swap-predict-restore of the knob by batch servers
        # (`LatencyService._run_model`): per model, so two threads
        # serving *different* banks still predict in parallel.
        self.backend_swap_lock = threading.Lock()
        # Resident (mean, std) device pair for the fused path; rebuilt
        # lazily after any invalidation (refit changes the scaler too)
        # or when the bank moves to another device.
        self._device_scaler: Optional[Tuple] = None

    def _invalidate_flat(self) -> None:
        self._flat = None          # drops the CudaBank riding on it
        self._device_scaler = None

    def flat(self) -> FlatEnsemble:
        """All trees compiled into one contiguous node bank (lazy)."""
        if self._flat is None:
            self._flat = FlatEnsemble.from_trees(self.trees)
        return self._flat

    def finalize(self):
        if self.trees:
            self.flat()
        return self

    # -- device-resident fused scoring ---------------------------------------
    def _device_reduction(self) -> Optional[Tuple[str, float, float]]:
        """``(kind, scale, bias)`` describing how per-tree leaf values
        become the model's prediction, or None when the subclass has no
        device-expressible reduction (falls back to the host path).

        GBDT: ``("sum", learning_rate, f0)``; RF: ``("mean", 1.0, 0.0)``.
        """
        return None

    def predict_on_device(self, x: np.ndarray, device="cuda") -> np.ndarray:
        """Raw (unstandardized) float32 features → clamped predictions,
        with standardize/traverse/reduce all on ``device`` (no float64
        (rows × trees) bounce through the host).  On the card this is one
        launch of the fused CUDA kernel; on the host, its plain torch
        version.  Float32 end-to-end; `LatencyService` only routes here
        when `resolve_backend` already picked a device tier.
        """
        red = self._device_reduction()
        if red is None:
            raise NotImplementedError(
                f"{type(self).__name__} has no device reduction")
        from repro_torch.kernels import tree_gather as tg

        flat = self.flat()
        db = flat.device_bank(device)
        sc = self._device_scaler
        if sc is None or sc[0].device != db.device:
            sc = self._device_scaler = tg.to_device_scaler(self.scaler,
                                                           db.device)
        return tg.fused_predict(flat, sc, red, x, device=db.device)

    def device_stats(self) -> Optional[Dict[str, Any]]:
        """Residency snapshot of this model's bank, or None if nothing
        is resident (never forces an upload)."""
        flat = self._flat
        db = flat._device_bank if flat is not None else None
        return db.stats() if db is not None else None
