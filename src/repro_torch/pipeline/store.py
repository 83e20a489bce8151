"""Persistent profile store — the disk layer under `ProfileSession`.

The paper's central cost is profiling: measuring every unique op config
on-device is what makes latency datasets expensive (§4.3).  The store
persists those measurements as JSON-lines so re-profiling across
processes, runs, and scenarios is incremental: a warm store performs
zero new measurements for already-profiled signatures.

Two record kinds share one append-only ``.jsonl`` file:

  {"kind": "op",   "axis": "<dtype>", "sig": ..., "type": ...,
   "names": [...], "x": [...], "y": ..., "fused": [...]}
  {"kind": "arch", "setting": "<dtype>/<mode>", "fp": "<fingerprint>",
   "arch": {ArchRecord.to_json()}}

One store file describes ONE physical device (the paper keeps per-phone
datasets); keys capture the parts of a `DeviceSetting` that change what
executes on it, not the setting's display name.  Op records are keyed by
``op_signature × dtype`` ("axis"): executor mode changes *which* graph is
executed (fusion rewrites nodes, which changes their signatures), not the
latency of a given kernel, so float32 measurements are shared between
op_by_op and fused_groups scenarios — the same sharing
`ProfileSession.latency_cache` always did in-process.  Arch records
(end-to-end latency) are keyed by ``dtype/mode``.  Settings for a second
physical device must carry a distinct ``DeviceSetting.device`` tag —
the tag prefixes both keys, so tagged target-device measurements (the
transfer layer) can share a file without aliasing; untagged settings
for different devices must keep separate files.

Appends are flushed per record; on load, the last line for a key wins,
so interrupted runs at worst lose the final record.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.profiler import ArchRecord, DeviceSetting, OpRecord
from repro_torch.utils.logging import get_logger

log = get_logger("repro.pipeline.store")


def op_axis(setting: DeviceSetting) -> str:
    """Projection of a DeviceSetting onto what per-op latency depends on.

    The optional ``setting.device`` tag prefixes the axis so measurements
    for a *different physical device* (transfer targets) never alias the
    local device's records, even when they share a store file.
    """
    device = getattr(setting, "device", "")
    return f"{device}:{setting.dtype}" if device else setting.dtype


def setting_key(setting: DeviceSetting) -> str:
    """Canonical key for end-to-end scenarios (device × dtype × mode).

    Deliberately excludes ``setting.name`` — a display label doesn't
    change what runs.  ``setting.device`` (physical-device identity) is
    included when set, so hubs and services can serve several devices;
    with the default empty tag the key stays the historical
    ``"dtype/mode"``.
    """
    base = f"{setting.dtype}/{setting.mode}"
    device = getattr(setting, "device", "")
    return f"{device}:{base}" if device else base


class ProfileStore:
    """Measurement cache keyed by ``op_signature × DeviceSetting``.

    ``path=None`` gives a purely in-memory store (same API, no
    persistence) — useful for tests and one-shot scripts.
    """

    def __init__(self, path: Optional[str] = None):
        self.path = path
        self._ops: Dict[Tuple[str, str], OpRecord] = {}     # (axis, sig) → rec
        self._archs: Dict[Tuple[str, str], ArchRecord] = {}  # (setting, fp) → rec
        self.hits = 0
        self.misses = 0
        self._fh = None
        # Lines currently on disk (records + duplicates + malformed) —
        # the append-only file grows past the deduped in-memory maps
        # whenever runs overlap or crash mid-write; `compact` reclaims it.
        self._file_lines = 0
        if path and os.path.exists(path):
            self._load(path)

    # -- persistence ---------------------------------------------------------
    def _load(self, path: str) -> None:
        n_bad = 0
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                self._file_lines += 1
                try:
                    d = json.loads(line)
                    if d["kind"] == "op":
                        rec = OpRecord(d["sig"], d["type"], d["names"], d["x"],
                                       d["y"], d.get("fused", []))
                        self._ops[(d["axis"], d["sig"])] = rec
                    elif d["kind"] == "arch":
                        self._archs[(d["setting"], d["fp"])] = \
                            ArchRecord.from_json(d["arch"])
                except (KeyError, ValueError, TypeError):
                    n_bad += 1
        if n_bad:
            log.warning("%s: skipped %d malformed lines", path, n_bad)
        log.info("loaded store %s: %d op records, %d arch records",
                 path, len(self._ops), len(self._archs))

    def _append(self, d: Dict[str, Any]) -> None:
        if not self.path:
            return
        if self._fh is None:
            os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
            self._fh = open(self.path, "a")
        self._fh.write(json.dumps(d) + "\n")
        self._fh.flush()
        self._file_lines += 1

    def compact(self) -> Dict[str, int]:
        """Rewrite the backing ``.jsonl`` with one line per live record.

        The file is append-only; last-line-wins on load means duplicate
        keys (overlapping runs, crashed writers, hand-merged files) cost
        disk and load time but never correctness.  Compaction writes the
        deduped in-memory state to a temp file and atomically replaces
        the original.  If another writer appended lines since this store
        loaded (on-disk line count ≠ ours), the file is re-read first so
        their records are merged, not clobbered.  Returns
        ``{"kept", "dropped"}`` line counts.
        """
        if not self.path:
            return {"kept": len(self._ops) + len(self._archs), "dropped": 0}
        self.close()
        if os.path.exists(self.path):
            with open(self.path) as f:
                n_disk = sum(1 for line in f if line.strip())
            if n_disk != self._file_lines:
                log.info("compact: %s changed under us (%d vs %d lines); "
                         "merging before rewrite", self.path, n_disk,
                         self._file_lines)
                self._file_lines = 0
                self._load(self.path)
        kept = len(self._ops) + len(self._archs)
        dropped = max(0, self._file_lines - kept)
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            for (axis, _), rec in sorted(self._ops.items(), key=lambda kv: kv[0]):
                f.write(json.dumps({"kind": "op", "axis": axis,
                                    **rec.to_json()}) + "\n")
            for (sk, fp), rec in sorted(self._archs.items(), key=lambda kv: kv[0]):
                f.write(json.dumps({"kind": "arch", "setting": sk, "fp": fp,
                                    "arch": rec.to_json()}) + "\n")
        os.replace(tmp, self.path)
        self._file_lines = kept
        if dropped:
            log.info("compacted %s: kept %d records, dropped %d stale lines",
                     self.path, kept, dropped)
        return {"kept": kept, "dropped": dropped}

    def flush(self) -> None:
        if self._fh is not None:
            self._fh.flush()

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    def __enter__(self) -> "ProfileStore":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- op records ----------------------------------------------------------
    def get_op(self, setting: DeviceSetting, signature: str) -> Optional[OpRecord]:
        rec = self._ops.get((op_axis(setting), signature))
        if rec is None:
            self.misses += 1
        else:
            self.hits += 1
        return rec

    def put_op(self, setting: DeviceSetting, rec: OpRecord) -> None:
        key = (op_axis(setting), rec.signature)
        if key in self._ops:
            return
        self._ops[key] = rec
        self._append({"kind": "op", "axis": key[0], **rec.to_json()})

    # -- arch records --------------------------------------------------------
    def get_arch(self, setting: DeviceSetting, fingerprint: str) -> Optional[ArchRecord]:
        rec = self._archs.get((setting_key(setting), fingerprint))
        if rec is None:
            self.misses += 1
        else:
            self.hits += 1
        return rec

    def put_arch(self, setting: DeviceSetting, fingerprint: str,
                 rec: ArchRecord) -> None:
        key = (setting_key(setting), fingerprint)
        if key in self._archs:
            return
        self._archs[key] = rec
        self._append({"kind": "arch", "setting": key[0], "fp": fingerprint,
                      "arch": rec.to_json()})

    # -- training views ------------------------------------------------------
    def arch_records(self, setting: DeviceSetting,
                     fingerprints: Optional[Sequence[str]] = None
                     ) -> List[ArchRecord]:
        """Arch records for one scenario, optionally restricted to the given
        graph fingerprints (graph *names* are not unique across configs in a
        persistent store — e.g. `nas_0` exists at every resolution)."""
        sk = setting_key(setting)
        items = sorted(self._archs.items(), key=lambda kv: kv[0])
        if fingerprints is None:
            return [r for (k, _), r in items if k == sk]
        wanted = set(fingerprints)
        return [r for (k, fp), r in items if k == sk and fp in wanted]

    def op_table(self, setting: DeviceSetting, op_type: str
                 ) -> Tuple[np.ndarray, np.ndarray]:
        """(X, y) of every stored op of one type on this setting's axis."""
        axis = op_axis(setting)
        xs, ys = [], []
        for (a, _), rec in sorted(self._ops.items(), key=lambda kv: kv[0]):
            if a == axis and rec.op_type == op_type:
                xs.append(rec.features)
                ys.append(rec.latency_s)
        if not xs:
            return np.zeros((0, 0)), np.zeros((0,))
        return np.asarray(xs, dtype=np.float64), np.asarray(ys, dtype=np.float64)

    def op_types(self, setting: DeviceSetting) -> List[str]:
        axis = op_axis(setting)
        return sorted({r.op_type for (a, _), r in self._ops.items() if a == axis})

    def op_records(self, setting: DeviceSetting) -> List[OpRecord]:
        """Every stored op record on this setting's axis, sorted by
        signature (deterministic order — the transfer sampler's input)."""
        axis = op_axis(setting)
        return [rec for (a, sig), rec in
                sorted(self._ops.items(), key=lambda kv: kv[0]) if a == axis]

    # -- stats ---------------------------------------------------------------
    def __len__(self) -> int:
        return len(self._ops)

    def stats(self) -> Dict[str, int]:
        return {"op_records": len(self._ops), "arch_records": len(self._archs),
                "file_lines": self._file_lines,
                "hits": self.hits, "misses": self.misses}
