"""The training driver: one card trains a configuration with the port's
own step, and the first steps are checked against the plain reference.

Set-up (counted in ``setup_s``, from the process's start): the port's
`build_model`; the benchmark's weights from the seed on the card
(`reference/<family>.py` ``groups``, `_plain.weights`) made into the port's `Params`
and a `TrainState` (`train_state_for(trainable(params))`); the port's
`make_train_step`; then the job's first `CHECK_STEPS` steps through the
same step function and the same feed the window uses (they also warm up
every shape and build the kernels).  Their readings are taken as they
happen, on the card and without waiting for it: each step's loss, every
leaf's AdamW first moment after step 1 (which holds the clipped gradient
as the optimizer got it, times 1 − β1) and every leaf's change from the
seed's weights after the last of them.

The window (set-up's objects frozen out of Python's collector): whole
steps back to back, a fresh batch each, until ``seconds`` have passed on
the host's clock, then one synchronize; the rate is all the window's
tokens over all its time.  The feed copies each batch from pinned
memory without waiting, so no step waits for the host but where the
port's own step does.  With ``trace`` each window step is timed by CUDA
events, and after the window `TRACE_STEPS` more run under
`torch.profiler` for the per-layer metrics.

Then the peak memory is read, the port's state freed, and the reference
trains the same weights on the same batches for the same steps in
float32; `compare` holds the readings to the cell's limits.
"""
from __future__ import annotations

import gc
import math
import statistics
import sys
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from portbench import core
from portbench.reference import _plain
from portbench.traffic import TokenTraffic

Tensor = torch.Tensor
Step = Callable[[Any, Dict[str, Tensor]], Tuple[Any, Dict[str, Tensor]]]

CHECK_STEPS = 3     # steps read for `correct`, before the window
TRACE_STEPS = 2     # steps profiled after the window with ``--trace 1``


class Feed:
    """The cell's batches on the device: step i's batch of the traffic
    mix, copied from pinned host memory without waiting for the card."""

    def __init__(self, cell: core.Cell, seed: int, device: torch.device):
        self.traffic = TokenTraffic(cell.traffic, cell.config["arch"]["vocab_size"], seed)
        self.device = device

    def __call__(self, step: int) -> Dict[str, Tensor]:
        out = {}
        for key, arr in self.traffic.batch_at(step).items():
            t = torch.from_numpy(arr)
            if self.device.type == "cuda":
                t = t.pin_memory()
            out[key] = t.to(self.device, non_blocking=True)
        return out


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def build(cell: core.Cell, seed: int, device: torch.device):
    """The port's model, a train state around the benchmark's weights, and
    the port's step for the cell's job."""
    from repro_torch.configs.base import ArchConfig
    from repro_torch.distributed.trainstep import (
        make_train_step, train_state_for, trainable,
    )
    from repro_torch.models import build_model
    from repro_torch.models.layers import Params

    arch, job = cell.config["arch"], cell.spec["job"]
    model = build_model(ArchConfig(**arch))
    ref = core.module("reference", arch["family"])
    tree = _plain.weights(ref.groups(arch), seed, device)
    state = train_state_for(trainable(Params(tree)))
    step = make_train_step(model, base_lr=job["base_lr"], warmup_steps=job["warmup_steps"],
                           total_steps=job["total_steps"],
                           weight_decay=job["weight_decay"])
    return model, state, step


def check_steps(cell: core.Cell, seed: int, state, step: Step, feed: Feed):
    """The job's first steps and their readings (tensors on the card; see
    the module docstring).  Returns (state, readings)."""
    from repro_torch.utils.tree import flatten_with_paths

    arch = cell.config["arch"]
    losses: List[Tensor] = []
    grad_norms = None
    for i in range(CHECK_STEPS):
        state, metrics = step(state, feed(i))
        losses.append(metrics["loss"].detach().float())
        if i == 0:
            grad_norms = {k: torch.linalg.vector_norm(m.float()) / (1 - _plain.B1)
                          for k, m in state.opt.mu.items()}
    ref = core.module("reference", arch["family"])
    now = flatten_with_paths(state.params)
    change = {}
    for start in _plain.weights_by_group(ref.groups(arch), seed, feed.device):
        change.update({k: torch.linalg.vector_norm(now[k].detach().float() - v)
                       for k, v in start.items()})
        del start
    return state, {"losses": losses, "grad_norms": grad_norms, "change_norms": change}


def _floats(readings: Dict[str, Any]) -> Dict[str, Any]:
    return {"losses": [float(x) for x in readings["losses"]],
            "grad_norms": {k: float(v) for k, v in readings["grad_norms"].items()},
            "change_norms": {k: float(v) for k, v in readings["change_norms"].items()}}


def reference_readings(cell: core.Cell, seed: int, device: torch.device,
                       prec: str = "float32", rows: Optional[slice] = None) -> Dict[str, Any]:
    """The reference's readings for the same weights and batches (in
    ``prec``: the control is ``"fp8"``; ``rows`` keeps those rows of each
    batch, a planted fault)."""
    arch = cell.config["arch"]
    ref = core.module("reference", arch["family"])
    _plain.precise()
    feed = Feed(cell, seed, device)
    batches = [feed(i) for i in range(CHECK_STEPS)]
    if rows is not None:
        batches = [{k: v[rows] for k, v in b.items()} for b in batches]
    p = _plain.Prec(prec)
    return _plain.train_readings(lambda tree, b: ref.loss(tree, b, arch, p),
                                 ref.groups(arch), seed, device, batches, cell.spec["job"])


def gaps(program: Dict[str, Any], reference: Dict[str, Any]) -> Dict[str, Any]:
    """Every number a cell may hold to a limit, and the leaves where the
    worst ones are:
    ``loss_gap``: the worst step's |loss − reference| / |reference|;
    ``grad_norm_gap``: the worst leaf's gap between the program's and the
    reference's norms of the first clipped gradient, over the larger of
    that leaf's reference norm and the median leaf's;
    ``grad_norm_gap_median``: the median leaf's such gap;
    ``change_gap``: the worst leaf's gap of the change after the check
    steps, over the leaves whose reference gradient is at least 1/1000 of
    the median leaf's (a leaf the loss leaves still moves by round-off
    alone)."""
    rg, rc = reference["grad_norms"], reference["change_norms"]
    keys = sorted(rg)
    med_g = statistics.median(rg.values())
    per_leaf = [core.leaf_gap(program["grad_norms"][k], rg[k], med_g) for k in keys]
    grad, at_g = core.relative_gap([program["grad_norms"][k] for k in keys],
                                   [rg[k] for k in keys], med_g)
    moved = [k for k in keys if rg[k] >= 1e-3 * med_g]
    change, at_c = core.relative_gap([program["change_norms"][k] for k in moved],
                                     [rc[k] for k in moved],
                                     statistics.median(rc[k] for k in moved))
    return {"loss_gap": core.relative_gap(program["losses"], reference["losses"])[0],
            "grad_norm_gap": grad, "grad_norm_gap_median": statistics.median(per_leaf),
            "change_gap": change, "grad_worst_leaf": keys[at_g] if at_g >= 0 else None,
            "change_worst_leaf": moved[at_c] if at_c >= 0 else None}


def compare(program: Dict[str, Any], reference: Dict[str, Any],
            limits: Dict[str, float]) -> Dict[str, Dict[str, float]]:
    """The numbers of `gaps` that the cell's ``limits`` name, each with its
    limit."""
    g = gaps(program, reference)
    return {k: {"value": g[k], "limit": v} for k, v in limits.items()}


def _profile_steps(state, step: Step, feed: Feed, first: int, n: int):
    from torch.profiler import ProfilerActivity, profile, record_function

    _sync(feed.device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        t0 = time.perf_counter()
        for i in range(first, first + n):
            with record_function("portbench.batch"):
                batch = feed(i)
            with record_function("portbench.step"):
                state, _ = step(state, batch)
        _sync(feed.device)
        window_s = time.perf_counter() - t0
    tr = core.trace_from_profile(prof, window_s, n)
    ops: Dict[str, List[float]] = {}
    for c in tr.ops:
        if c.name.startswith("repro_torch::"):
            ops.setdefault(c.name, []).append(c.device_us)
    for name, us in sorted(ops.items()):
        print(f"trace {name}: {len(us)} calls, {sum(us) / 1e3:.3f} device ms",
              file=sys.stderr)
    return state, tr


def run(cell: core.Cell, seed: int, seconds: float, trace: bool, device: torch.device,
        t_start: float, wrap: Optional[Callable[[Step], Step]] = None
        ) -> Tuple[Dict[str, Any], Dict[str, Dict[str, float]]]:
    """One run of the cell; returns (the result line, the checks).
    ``wrap`` plants a fault in the port's step (tests)."""
    t_run = time.perf_counter()
    model, state, step = build(cell, seed, device)
    if wrap is not None:
        step = wrap(step)
    feed = Feed(cell, seed, device)
    _sync(device)
    t_built = time.perf_counter()
    state, readings = check_steps(cell, seed, state, step, feed)
    _sync(device)
    # Set-up's objects (modules, the model, its weights) go to Python's
    # permanent generation, so the window's collections scan only what the
    # window allocates.  Otherwise a full collection scans them all once or
    # twice a window, 0.1-0.25 s each on Mamba2's host, and the step it
    # stalls (the port syncs the host in every step) runs that much longer.
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - t_start
    phases = (f"process start to the driver {t_run - t_start:.3f} s, build "
              f"{t_built - t_run:.3f} s, check steps {t_start + setup_s - t_built:.3f} s")

    first = CHECK_STEPS
    cuda = device.type == "cuda"
    losses, marks = [], []
    n = 0
    t0 = time.perf_counter()
    while True:
        batch = feed(first + n)
        if trace and cuda:
            marks.append(torch.cuda.Event(enable_timing=True))
            marks[-1].record()
        state, metrics = step(state, batch)
        losses.append(metrics["loss"].detach())
        n += 1
        if time.perf_counter() - t0 >= seconds:
            break
    if trace and cuda:
        marks.append(torch.cuda.Event(enable_timing=True))
        marks[-1].record()
    _sync(device)
    window_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0

    prof_trace = None
    if trace:
        state, prof_trace = _profile_steps(state, step, feed, first + n, TRACE_STEPS)
    gc.unfreeze()
    failed = int((~torch.isfinite(torch.stack(losses))).sum())
    program = _floats(readings)
    del state, step, model, metrics, readings, losses, batch
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    checks = compare(program, reference_readings(cell, seed, device),
                     cell.spec["limits"])
    print(f"times: setup {setup_s:.3f} s ({phases}), window {window_s:.3f} s ({n} steps), "
          f"reference {time.perf_counter() - t_ref:.3f} s", file=sys.stderr)
    checks["failed_steps"] = {"value": failed, "limit": 0}
    correct = all(c["value"] <= c["limit"] for c in checks.values())

    tokens = feed.traffic.tokens_per_step
    dev = {"platform": "gpu" if cuda else device.type,
           "kind": torch.cuda.get_device_name(device) if cuda else device.type,
           "count": 1, "memory_peak_bytes": peak}
    result: Dict[str, Any] = {"correct": correct, "attempted": n, "failed": failed}
    if trace:
        step_ms = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
        ctx = core.Context(cell, n, window_s, step_ms, prof_trace, core.peaks())
        result["metrics"] = core.read_metrics(ctx, core.metric_readers())
        dev.update(busy_s=prof_trace.busy_s(), window_s=prof_trace.window_s)
        result["device"] = dev
        result["breakdown"] = prof_trace.breakdown()
    else:
        result["metrics"] = {
            "train_tokens_per_s": {"value": n * tokens / window_s, "unit": "tokens/s"},
            "peak_mem_gib": {"value": peak / 2 ** 30, "unit": "GiB"},
            "setup_s": {"value": setup_s, "unit": "s"},
        }
        result["device"] = dev
    return result, checks
