"""Device-resident tree-ensemble scoring (counterpart of the reference's
``repro.kernels.tree_gather``).

Batched tree traversal is a pure gather workload: every (row × tree)
slot holds a node id, and one step gathers (feature, threshold, child)
for all slots at once.  Because leaves self-loop (`left == right ==
self` in `FlatEnsemble`), the update is idempotent, so a fixed number of
``max_depth`` rounds needs no active mask.

Residency (`CudaBank`): the flattened struct-of-arrays bank is uploaded
to the device ONCE per `FlatEnsemble` and reused across every later
flush — it lives on `flat._device_bank` until the ensemble itself is
invalidated (retrain / bank swap), so a serving process pays the
host→device transfer of the trees exactly once.  Inputs are staged
through the same layer as float32.

Dispatch: a bank on the card runs the hand-written CUDA kernels
(`repro_torch.kernels.tree_gather_cuda`); a bank on the host runs the
plain torch versions below (`gather_leaves_plain`, `fused_plain`), which
the tests hold against the reference.  There is no fallback from one to
the other: a CUDA bank launches the kernel or raises.

Precision: float32 throughout, with the reference device tiers' compare
form (``xv <= thr``), so leaves match the reference's jax and Pallas
tiers bit for bit; near-tie rows can route differently from the float64
numpy tier, as in the reference.

Sharding (the reference's mesh flush): a bank built over several
devices (``devices``; None means `repro_torch.launch.mesh.flush_mesh`,
the local cards when there are more than one, and a list of fewer than
two devices means unsharded) is copied once to each
distinct one, and a flush of at least `SHARD_MIN_ROWS` rows is padded
with zero rows to a multiple of the device count, split in row order
(`ShardedRows`), run shard by shard on each shard's device (one kernel
launch per shard on the card, with the unsharded flush's launch plan, so
each row is computed as it would be unsharded), and reassembled in row
order with the pad sliced off.  Smaller flushes take the unsharded
route.  Listing one card several times (``[cuda:0] * 4``) runs every
shard there: the analogue of the reference forcing several host devices.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels._build import refuse_dtensor, refuse_grad
from repro_torch.utils.device import DeviceLike, resolve_device

Tensor = torch.Tensor

# Why the tree kernels refuse a gradient on the card (`_build.refuse_grad`).
_NO_TREE_GRAD = "no training slice of the port runs it"

# Lifetime counters (survive bank invalidation — `CudaBank` instances die
# with their FlatEnsemble, these do not).  `LatencyService.stats()`
# reports both views: what is resident now and what was ever uploaded.
_COUNTERS = {"banks_built": 0, "bank_bytes": 0, "inputs_staged": 0,
             "input_bytes": 0}
_COUNTERS_LOCK = threading.Lock()

# Flushes below this many rows skip sharding: the split and reassembly
# cost more than the per-device win on small batches.
SHARD_MIN_ROWS = 1024


@dataclass
class ShardedRows:
    """A staged flush split by rows: ``shards[i]`` on ``shards[i].device``,
    in row order, padded with zero rows to equal parts; ``rows`` is the
    flush's own row count."""

    shards: List[Tensor]
    rows: int


def residency_counters() -> Dict[str, int]:
    """Process-lifetime upload totals (includes invalidated banks)."""
    with _COUNTERS_LOCK:
        return dict(_COUNTERS)


def _count(**deltas: int) -> None:
    with _COUNTERS_LOCK:
        for k, v in deltas.items():
            _COUNTERS[k] += v


# -- plain torch versions (CPU banks; the kernels' parity oracle) -------------

def gather_leaves_plain(feature: Tensor, threshold: Tensor, left: Tensor,
                        right: Tensor, value: Tensor, roots: Tensor,
                        x: Tensor, *, depth: int) -> Tensor:
    """(rows, trees) float32 leaf values — twin of the reference's
    ``_traverse_core``: ``depth`` rounds of gathers, ``xv <= thr``."""
    n = x.shape[0]
    feature, left, right = feature.long(), left.long(), right.long()
    nid = roots.long().unsqueeze(0).expand(n, -1)          # (rows, trees)
    for _ in range(depth):
        xv = torch.gather(x, 1, feature[nid])               # x[row, f[slot]]
        nid = torch.where(xv <= threshold[nid], left[nid], right[nid])
    return value[nid]


def fused_plain(feature: Tensor, threshold: Tensor, left: Tensor,
                right: Tensor, value: Tensor, roots: Tensor, mean: Tensor,
                std: Tensor, scale: float, bias: float, x: Tensor, *,
                depth: int, kind: str) -> Tensor:
    """standardize → traverse → reduce → clamp — twin of the reference's
    ``_fused_core``; ``kind`` is "sum" (GBDT) or "mean" (RF)."""
    xs = (x - mean) / std
    vals = gather_leaves_plain(feature, threshold, left, right, value, roots,
                               xs, depth=depth)
    red = vals.sum(dim=1) if kind == "sum" else vals.mean(dim=1)
    # float32 scalars filled on the device (no host→device copy, which
    # would wait for the stream).
    s = torch.full((), scale, dtype=torch.float32, device=x.device)
    b = torch.full((), bias, dtype=torch.float32, device=x.device)
    return torch.clamp_min(b + s * red, 0.0)


def complete_layout(feature: Tensor, threshold: Tensor, left: Tensor,
                    right: Tensor, value: Tensor, roots: Tensor, *,
                    depth: int) -> Tuple[Tensor, Tensor]:
    """The bank as complete level-order trees of ``depth`` levels, the
    layout of the kernels' ``staged`` route.

    Returns ``(nodes, leaves)``: ``nodes`` (trees · (2^depth − 1), 2) int32
    rows of {feature, threshold bits}, tree t's internal node i at
    ``t·(2^depth − 1) + i``, whose children are 2i + 1 (``x <= thr``) and
    2i + 2; ``leaves`` (trees · 2^depth,) float32, tree t's leaf j at
    ``t·2^depth + j``.  Position p holds the node that ``depth`` rounds of
    the packed walk reach by p's path, so a leaf above the last level
    (self-looped) fills its whole subtree: every route of the complete
    walk ends on the value the packed walk ends on, bit for bit, for any
    input (ties and NaN included).  Built with gathers on the arrays'
    device; ``feature`` must already be clamped to valid indices."""
    n_trees = roots.shape[0]
    left, right = left.long(), right.long()
    nid = roots.long().unsqueeze(1)                       # (trees, 1): level 0
    feats, thrs = [], []
    for _ in range(depth):
        feats.append(feature[nid])
        thrs.append(threshold[nid])
        nid = torch.stack([left[nid], right[nid]], dim=2).reshape(n_trees, -1)
    nodes = torch.stack([torch.cat(feats, dim=1).to(torch.int32),
                         torch.cat(thrs, dim=1).to(torch.float32).view(torch.int32)],
                        dim=2).reshape(-1, 2).contiguous()
    return nodes, value[nid].to(torch.float32).reshape(-1).contiguous()


def packed_layout(feature: Tensor, threshold: Tensor, left: Tensor,
                  right: Tensor, value: Tensor, roots: Tensor) -> Tensor:
    """(n_nodes, 4) int32 rows of {feature, threshold bits, left, right}:
    the node layout of the kernels' ``packed`` route (``value`` and
    ``roots`` are read as they are)."""
    return torch.stack([feature, threshold.view(torch.int32), left, right],
                       dim=1).contiguous()


class CudaBank:
    """One `FlatEnsemble`'s arrays resident on a device (the card by
    default).

    Built lazily by `FlatEnsemble.device_bank()` and cached on the
    ensemble, so the host→device transfer happens once per trained
    ensemble; retrain/bank swap drops the FlatEnsemble and this bank
    with it.  Besides the reference's five node arrays and roots, a bank
    on the card keeps the kernels' layouts, built on the device from the
    uploaded arrays (not a second upload): when the trees are shallow
    enough to be kept complete (`tree_gather_cuda.has_complete`),
    ``cnodes`` and ``cleaves`` from `complete_layout` for the ``staged``
    route, else ``nodes``, (n_nodes, 4) int32 rows of {feature,
    threshold bits, left, right} for the ``packed`` route.
    """

    __slots__ = ("device", "n_nodes", "n_trees", "n_features", "depth",
                 "feature", "threshold", "left", "right", "value", "roots",
                 "nodes", "cnodes", "cleaves", "nbytes", "uploads",
                 "inputs_staged", "input_bytes", "devices", "replicas", "_lock")

    def __init__(self, device: torch.device) -> None:
        self.device = device
        self.nodes = None
        self.cnodes = None
        self.cleaves = None
        self.devices: Optional[List[torch.device]] = None
        self.replicas: Dict[torch.device, "CudaBank"] = {}
        self.uploads = 0
        self.inputs_staged = 0
        self.input_bytes = 0
        self._lock = threading.Lock()

    @classmethod
    def from_flat(cls, flat, device: DeviceLike = "cuda",
                  devices: Optional[Sequence[DeviceLike]] = None) -> "CudaBank":
        """Upload ``flat``'s arrays to ``device``; with ``devices`` (a list
        of more than one device) copy the bank once to each distinct one
        for sharded flushes (see the module docstring).  ``devices=None``
        means `flush_mesh()` for a bank on the card and unsharded for a
        bank on the host."""
        db = cls(resolve_device(device))
        db.n_nodes = flat.n_nodes
        db.n_trees = flat.n_trees
        db.depth = max(1, flat.max_depth)
        db.n_features = int(flat.feature.max()) + 1 if flat.n_nodes else 0
        # Leaves carry feature = -1; clamp to 0 so the gather stays
        # in-bounds (self-looped slots ignore the compare).
        host = (np.maximum(flat.feature, 0).astype(np.int32),
                flat.threshold.astype(np.float32),
                flat.left.astype(np.int32),
                flat.right.astype(np.int32),
                flat.value.astype(np.float32),
                flat.roots.astype(np.int32))
        db._place(tuple(torch.from_numpy(a).to(db.device) for a in host))
        db.nbytes = sum(a.nbytes for a in host)
        db.uploads = 1
        _count(banks_built=1, bank_bytes=db.nbytes)
        if devices is None:
            from repro_torch.launch.mesh import flush_mesh
            devices = flush_mesh() if db.device.type == "cuda" else None
        if devices is not None and len(devices) > 1:
            db.devices = [resolve_device(d) for d in devices]
            for dev in dict.fromkeys(db.devices):
                if dev != db.device:
                    db.replicas[dev] = db._copy_to(dev)
        return db

    def _place(self, arrays: Tuple[Tensor, ...]) -> None:
        """Take the node arrays (on ``self.device``) and build the
        kernels' layouts from them on the card."""
        (self.feature, self.threshold, self.left, self.right, self.value,
         self.roots) = arrays
        if self.device.type == "cuda":
            from repro_torch.kernels.tree_gather_cuda import has_complete
            if has_complete(self.n_trees, self.depth):
                self.cnodes, self.cleaves = complete_layout(*self.bank_args,
                                                            depth=self.depth)
            else:
                self.nodes = packed_layout(*self.bank_args)

    def _copy_to(self, device: torch.device) -> "CudaBank":
        """This bank copied device to device (not a second host upload)."""
        rep = CudaBank(device)
        rep.n_nodes, rep.n_trees, rep.depth = self.n_nodes, self.n_trees, self.depth
        rep.n_features, rep.nbytes = self.n_features, self.nbytes
        rep._place(tuple(t.to(device) for t in self.bank_args))
        return rep

    def _on(self, device: torch.device) -> "CudaBank":
        return self if device == self.device else self.replicas[device]

    @property
    def bank_args(self) -> Tuple[Tensor, ...]:
        return (self.feature, self.threshold, self.left, self.right,
                self.value, self.roots)

    # -- input staging --------------------------------------------------------
    def stage_input(self, x: np.ndarray, *, sharded: bool = True):
        """Host rows → contiguous float32 tensor on the bank's device, or,
        on a sharded bank for a flush of at least `SHARD_MIN_ROWS` rows,
        `ShardedRows` (padded to a device multiple, split in row order)."""
        x32 = np.ascontiguousarray(x, dtype=np.float32)
        if x32.ndim != 2:
            raise ValueError(f"X must be 2-D, got {x32.shape}")
        rows = len(x32)
        devices = self.devices if (sharded and rows >= SHARD_MIN_ROWS) else None
        if devices is not None:
            pad = (-rows) % len(devices)
            if pad:
                x32 = np.concatenate([x32, np.zeros((pad, x32.shape[1]), np.float32)])
            parts = np.split(x32, len(devices))
            xd = ShardedRows([torch.from_numpy(p).to(d) for p, d in zip(parts, devices)],
                             rows)
        else:
            xd = torch.from_numpy(x32).to(self.device)
        with self._lock:
            self.inputs_staged += 1
            self.input_bytes += x32.nbytes
        _count(inputs_staged=1, input_bytes=x32.nbytes)
        return xd

    def _reassemble(self, outs: Sequence[Tensor], rows: int) -> Tensor:
        return torch.cat([o.to(self.device) for o in outs])[:rows]

    # -- traversal dispatch ---------------------------------------------------
    def gather_leaves(self, xd, whole_rows: Optional[int] = None) -> Tensor:
        """(rows, trees) leaf values for staged rows ``xd``.  A shard of a
        flush of ``whole_rows`` rows launches with the whole flush's plan
        (`tree_gather_cuda.plan_for`), so sharding changes no bit."""
        if isinstance(xd, ShardedRows):
            return self._reassemble([self._on(x.device).gather_leaves(x, xd.rows)
                                     for x in xd.shards], xd.rows)
        refuse_dtensor("tree_gather_leaves", xd)
        if self.device.type == "cuda":
            from repro_torch.kernels.tree_gather_cuda import gather_leaves_cuda
            refuse_grad("tree_gather_leaves", _NO_TREE_GRAD, xd)
            return gather_leaves_cuda(self, xd, whole_rows)
        return gather_leaves_plain(*self.bank_args, xd, depth=self.depth)

    def fused(self, mean: Tensor, std: Tensor, scale: float, bias: float,
              xd, kind: str, whole_rows: Optional[int] = None) -> Tensor:
        """standardize → traverse → reduce → clamp: one kernel on the card
        (one per shard for `ShardedRows`, each with the whole flush's plan,
        as in `gather_leaves`)."""
        if isinstance(xd, ShardedRows):
            return self._reassemble(
                [self._on(x.device).fused(mean.to(x.device), std.to(x.device),
                                          scale, bias, x, kind, xd.rows)
                 for x in xd.shards], xd.rows)
        refuse_dtensor("tree_predict_fused", mean, std, xd)
        if self.device.type == "cuda":
            from repro_torch.kernels.tree_gather_cuda import fused_predict_cuda
            refuse_grad("tree_predict_fused", _NO_TREE_GRAD, mean, std, xd)
            return fused_predict_cuda(self, mean, std, scale, bias, xd, kind,
                                      whole_rows)
        return fused_plain(*self.bank_args, mean, std, scale, bias, xd,
                           depth=self.depth, kind=kind)

    # -- introspection --------------------------------------------------------
    def stats(self) -> Dict[str, Any]:
        return {"nbytes": int(self.nbytes), "n_nodes": int(self.n_nodes),
                "n_trees": int(self.n_trees), "uploads": int(self.uploads),
                "inputs_staged": int(self.inputs_staged),
                "input_bytes": int(self.input_bytes),
                "sharded": self.devices is not None,
                "shard_devices": [str(d) for d in self.devices or ()],
                "replicas": len(self.replicas)}


# -- public entry points ------------------------------------------------------

def predict_trees_device(flat, x: np.ndarray, device: DeviceLike = "cuda"
                         ) -> np.ndarray:
    """(n_rows, n_trees) float64 leaf values from ``flat``'s resident
    bank on ``device`` (kernel on the card, plain torch on the host)."""
    db = flat.device_bank(device)
    out = db.gather_leaves(db.stage_input(x))
    return out.cpu().numpy().astype(np.float64)


def to_device_scaler(scaler, device: DeviceLike = "cuda") -> Tuple[Tensor, Tensor]:
    """(mean, std) as resident float32 tensors (cached by the model)."""
    dev = resolve_device(device)
    return (torch.from_numpy(scaler.mean.astype(np.float32)).to(dev),
            torch.from_numpy(scaler.std.astype(np.float32)).to(dev))


def fused_predict(flat, device_scaler: Tuple[Tensor, Tensor],
                  reduction: Tuple, x: np.ndarray,
                  device: DeviceLike = "cuda") -> np.ndarray:
    """Whole per-op-type predict on the device: raw float32 features in,
    clamped latencies out.

    ``reduction`` is the model's ``(kind, scale, bias)`` — GBDT is
    ``("sum", learning_rate, f0)``, RF is ``("mean", 1.0, 0.0)`` — so
    standardization, traversal, the stage/tree reduction, and the ≥0
    clamp run as one kernel launch on the card instead of bouncing a
    (rows × trees) matrix back through the host.
    """
    kind, scale, bias = reduction
    mean, std = device_scaler
    db = flat.device_bank(device)
    out = db.fused(mean, std, scale, bias, db.stage_input(x), kind)
    return out.cpu().numpy().astype(np.float64)
