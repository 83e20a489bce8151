"""What every driver shares: finding a cell and its files by name, the
table of peaks, the profiler's trace reduced to device time, and the
result line.

Everything that belongs to one configuration, traffic mix, driver,
reference, work count or per-layer metric is a file of its own, found by
the name that `BENCHMARK.json` and the cell's file give:

    configs/<config>.json      the sizes as run, with source and cuts
    traffic/<mix>.json         parameters of the one token generator
    workloads/<cell>.json      config, traffic, driver, job, limits
    drivers/<driver>.py        ``run(cell, seed, seconds, trace, device)``
    reference/<family>.py      the plain float32 reference of a family
    counts/<name>.py           operations and bytes of a model or an op
    metrics/<a>/<b>.py         the reader of per-layer metric ``a.b``
"""
from __future__ import annotations

import bisect
import importlib
import importlib.util
import json
import math
import sys
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple

ROOT = Path(__file__).resolve().parent
REPO = ROOT.parent

# Top-level module names that may not be loaded in a run's process: JAX
# and the JAX package the port was made from.  Compared whole, so
# `repro_torch` (the port) is not among them.
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load_json(kind: str, name: str, root: Path = ROOT) -> Dict[str, Any]:
    path = root / kind / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1] if kind.endswith('s') else kind} "
                                f"named {name!r} ({path})")
    return json.loads(path.read_text())


@dataclass
class Cell:
    """A cell with its configuration and traffic mix loaded."""

    name: str
    spec: Dict[str, Any]
    config: Dict[str, Any]
    traffic: Dict[str, Any]

    @property
    def driver(self) -> str:
        return self.spec["driver"]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    spec = load_json("workloads", name, root)
    return Cell(name, spec, load_json("configs", spec["config"], root),
                load_json("traffic", spec["traffic"], root))


def module(kind: str, name: str):
    """``portbench.<kind>.<name>`` (a driver, a reference, a count)."""
    return importlib.import_module(f"portbench.{kind}.{name}")


def metric_readers(root: Path = ROOT) -> Dict[str, Any]:
    """Every per-layer metric reader: ``metrics/a/b.py`` is metric
    ``a.b``; each module has ``UNIT`` and ``read(ctx)``, which returns a
    number or None where the run gives it nothing to read."""
    readers = {}
    for path in sorted((root / "metrics").rglob("*.py")):
        if path.name == "__init__.py":
            continue
        name = ".".join(path.relative_to(root / "metrics").with_suffix("").parts)
        spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        readers[name] = mod
    return readers


def peaks(root: Path = ROOT) -> Dict[str, float]:
    return json.loads((root / "peaks.json").read_text())


def forbidden_modules() -> List[str]:
    """Forbidden top-level names found in ``sys.modules``."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


# ---------------------------------------------------------------------------
# The profiler's trace
# ---------------------------------------------------------------------------

@dataclass
class OpCall:
    name: str
    input_shapes: List[Any]
    device_us: float


@dataclass
class Trace:
    """A profiled stretch of steps: device intervals (µs, the profiler's
    clock), the CPU ops with their input shapes and the device time of
    the kernels they launched, and the host's wall time of the stretch."""

    window_s: float
    steps: int
    device: List[Tuple[str, float, float]] = field(default_factory=list)
    ops: List[OpCall] = field(default_factory=list)
    host: List[Tuple[str, float, float]] = field(default_factory=list)

    def busy_intervals(self) -> List[Tuple[float, float]]:
        """The union of the device's intervals, in order."""
        merged: List[List[float]] = []
        for _, s, e in sorted(self.device, key=lambda t: t[1]):
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return [(s, e) for s, e in merged]

    def busy_s(self) -> float:
        return math.fsum(e - s for s, e in self.busy_intervals()) / 1e6

    def calls(self, op: str) -> List[OpCall]:
        return [c for c in self.ops if c.name == op]

    def breakdown(self, top: int = 10) -> Dict[str, List[List[Any]]]:
        """The device operations that took most time, and the longest idle
        gaps between device intervals, each named by the innermost host
        event running at the gap's middle."""
        by_name: Dict[str, float] = {}
        for name, s, e in self.device:
            by_name[name] = by_name.get(name, 0.0) + (e - s)
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        busy = self.busy_intervals()
        gaps = sorted(((b[0] - a[1], (a[1] + b[0]) / 2) for a, b in zip(busy, busy[1:])),
                      reverse=True)[:top]
        host = sorted(self.host, key=lambda t: t[1])
        starts = [s for _, s, _ in host]
        named = []
        for length, mid in gaps:
            inner = None
            for name, s, e in host[:bisect.bisect_right(starts, mid)]:
                if e >= mid and (inner is None or s >= inner[1]):
                    inner = (name, s)
            named.append([inner[0] if inner else "no host event", length / 1e6])
        return {"device_ops": [[n[:120], us / 1e6] for n, us in ops],
                "idle_gaps": named}


def trace_from_profile(prof, window_s: float, steps: int) -> Trace:
    """A `Trace` from a finished `torch.profiler.profile`."""
    from torch.autograd import DeviceType

    tr = Trace(window_s=window_s, steps=steps)
    for e in prof.events():
        if getattr(e, "is_user_annotation", False) or e.name.startswith("portbench."):
            # A `record_function` span also appears on the device's timeline
            # (from its first kernel to its last): host spans only.
            if e.device_type != DeviceType.CUDA:
                tr.host.append((e.name, e.time_range.start, e.time_range.end))
            continue
        if e.device_type == DeviceType.CUDA:
            tr.device.append((e.name, e.time_range.start, e.time_range.end))
        else:
            tr.ops.append(OpCall(e.name, list(e.input_shapes or []),
                                 float(e.device_time_total)))
            tr.host.append((e.name, e.time_range.start, e.time_range.end))
    return tr


# ---------------------------------------------------------------------------
# What the per-layer readers read
# ---------------------------------------------------------------------------

@dataclass
class Context:
    """A run's readings, handed to every per-layer metric reader."""

    cell: Cell
    window_steps: int
    window_s: float
    step_ms: List[float]
    trace: Optional[Trace]
    peaks: Dict[str, float]

    def count(self, name: str):
        return module("counts", name)


def read_metrics(ctx: Context, readers: Dict[str, Any]) -> Dict[str, Dict[str, Any]]:
    out = {}
    for name, mod in readers.items():
        value = mod.read(ctx)
        if value is not None:
            out[name] = {"value": value, "unit": mod.UNIT}
    return out


# ---------------------------------------------------------------------------
# The result
# ---------------------------------------------------------------------------

def least_time_s(flops: float, nbytes: float, pk: Dict[str, float],
                 flops_key: str) -> float:
    """The roofline's least time: the larger of operations over the peak
    rate and bytes over the memory's peak bandwidth."""
    return max(flops / pk[flops_key], nbytes / pk["hbm_bytes_per_s"])


def emit(result: Dict[str, Any], checks: Dict[str, Dict[str, float]]) -> None:
    """The checks as the last lines of standard error, then the result as
    the last line of standard output, its checks under the last key."""
    for name, c in checks.items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps({**result, "checks": checks}), flush=True)


def leaf_gap(program: float, reference: float, floor: float = 0.0) -> float:
    """|program − reference| over max(|reference|, floor); inf where the
    program's number is not finite or the denominator is 0 and they
    differ."""
    den = max(abs(reference), floor)
    gap = abs(program - reference) / den if den > 0 else (0.0 if program == reference
                                                          else math.inf)
    return gap if math.isfinite(gap) else math.inf


def relative_gap(program: Sequence[float], reference: Sequence[float],
                 floor: float = 0.0) -> Tuple[float, int]:
    """The worst `leaf_gap` and its index (-1 for none)."""
    worst, at = 0.0, -1
    for i, (p, r) in enumerate(zip(program, reference)):
        gap = leaf_gap(p, r, floor)
        if gap > worst:
            worst, at = gap, i
    return worst, at
