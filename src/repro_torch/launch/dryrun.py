"""Multi-pod dry run: trace every (arch × shape × mesh) cell on fake
tensors (twin of ``repro.launch.dryrun``).

For each cell this script
  1. brings up a fake process group of 256 or 512 ranks (a
     ``torch.distributed`` group whose collectives move no bytes) and the
     production mesh on it (`make_production_mesh`), on device type
     ``cuda`` unless the caller passes ``cpu``;
  2. builds the model, its parameters (bfloat16 for inference, as
     deployments serve them), the `TrainState`, the decode cache and the
     inputs (`Model.input_specs`) as fake tensors under
     `torch._subclasses.fake_tensor.FakeTensorMode`: nothing is allocated
     on any device;
  3. shards them by the rules of `repro_torch.distributed.sharding`
     (`resolve_variant`) and runs one `make_train_step` step (16
     microbatches when the batch divides), one prefill forward returning
     the last position's logits, or one `decode_step`, as rank 0;
  4. records, per device: FLOPs (`torch.utils.flop_counter.FlopCounterMode`;
     the hand-written kernels count through their ops' FLOP formulas),
     bytes accessed and per-kind collective bytes
     (`repro_torch.utils.hlo_analysis`), and memory: the arguments (rank
     0's local shards of state and inputs), the outputs, the bytes the
     step updates in place (the reference's donated buffers), the traced
     peak less the arguments (``temp_bytes``, `LiveBytes`) and no code.

`run_cell(..., fake=False)` runs the same step for real on the mesh's
devices (a real process group: NCCL on the card, gloo on the host), or
on one device without a mesh (``mesh=None``), and on the card adds
``max_memory_allocated``, the step's ms and the card's name and power
limit.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-72b \\
      --shape train_4k --mesh single --out reports/dryrun_torch.json
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both
  (add ``--device cpu`` on a host without a card)

What differs from the reference: its figures are XLA's for one compiled
program (a scanned layer's body counted once, fusion applied); these are
the ops one eager step issues, every layer's and every microbatch's
(`repro_torch.utils.hlo_analysis`), so the two are not comparable one for
one.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import subprocess
import time
import traceback
import weakref
from typing import Any, Dict, Iterator, Optional

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch.configs import ARCHS, INPUT_SHAPES, InputShape, get_arch, shape_applicable
from repro_torch.distributed.sharding import cache_shardings, distribute_params, local_batch
from repro_torch.distributed.trainstep import (
    make_train_step, shard_train_state, train_state_for, trainable,
)
from repro_torch.launch.mesh import make_production_mesh, use_mesh
from repro_torch.models import build_model
from repro_torch.models.layers import is_fake
from repro_torch.utils.hlo_analysis import (
    collect_collective_stats, cpu_bf16_upcast_bytes, dtensor_types,
)
from repro_torch.utils.logging import get_logger
from repro_torch.utils.tree import flatten_with_paths

log = get_logger("repro_torch.dryrun")

# The card the thresholds below are set for: an NVIDIA H100 80GB HBM3.
CARD_BYTES = 80e9
# The reference's reasoning, on a 16 GB chip: at 16-way tensor
# parallelism a parameter's float32 value, gradient and two AdamW moments
# (16 bytes) put N bytes of state on each chip, and it switched to ZeRO-3
# at N = 15e9, 15/16 of the chip.  The same fraction of 80 GB:
FSDP_PARAM_THRESHOLD = 75e9   # parameters; larger trains use ZeRO-3 per-layer gather
# Serving: it streamed weights when the bfloat16 weights per chip at
# 16-way TP passed 6 GB, 0.375 of the 16 GB chip (leaving the rest to a
# 32k KV cache and activations).  The same fraction of 80 GB:
SERVE_STREAM_THRESHOLD = 30e9  # bf16 param bytes per card at 16-way TP


def resolve_variant(cfg, shape, variant: str) -> str:
    """'auto' → fsdp for big-model training and weight-streamed serving.

    The reference's rule with thresholds for an 80 GB card (above): fsdp
    trains a model of at least `FSDP_PARAM_THRESHOLD` parameters, and a
    decode cell streams its weights (fsdp + per-layer gather) when its
    bfloat16 weights at 16-way TP pass `SERVE_STREAM_THRESHOLD` bytes a
    card; prefill is compute-bound and stays on tp.
    """
    if variant != "auto":
        return variant
    if shape.kind == "train":
        return "fsdp" if cfg.num_params() >= FSDP_PARAM_THRESHOLD else "tp"
    if shape.is_decode and cfg.num_params() * 2 / 16 > SERVE_STREAM_THRESHOLD:
        return "fsdp"
    return "tp"


# ---------------------------------------------------------------------------
# Fake process groups
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def fake_world(world_size: int) -> Iterator[None]:
    """A fake default process group of ``world_size`` ranks, this process
    rank 0, destroyed on exit.  Process-global: run it in a process of its
    own (or after every real group is gone)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a process group is initialised already; the fake "
                           "world needs a process of its own")
    dist.init_process_group("fake", store=FakeStore(), world_size=world_size, rank=0)
    try:
        yield
    finally:
        dist.destroy_process_group()


def mesh_record(mesh) -> Dict[str, int]:
    if mesh is None:
        return {}
    return {name: int(mesh.size(i)) for i, name in enumerate(mesh.mesh_dim_names)}


# ---------------------------------------------------------------------------
# Memory
# ---------------------------------------------------------------------------

class LiveBytes(TorchDispatchMode):
    """Bytes of the storages that ops allocate inside the block, live and
    at their peak: an op's output storage that none of its inputs holds
    (views and in-place results hold an input's) is counted once, when it
    appears, and leaves the count when it is freed.  DTensor ops are
    counted as the local ops they run.  The same on fake and real tensors,
    and blind to memory a kernel allocates inside an op (its scratch)."""

    def __init__(self) -> None:
        super().__init__()
        self.live = 0
        self.peak = 0
        self._seen: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()

    def _free(self, nbytes: int) -> None:
        self.live -= nbytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if dtensor_types(types):
            return NotImplemented
        out = func(*args, **(kwargs or {}))
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        if not outs:
            return out
        held = {t.untyped_storage()._cdata for t in tree_leaves((args, kwargs))
                if isinstance(t, torch.Tensor)}
        for t in outs:
            st = t.untyped_storage()
            if st._cdata in held or st in self._seen:
                continue
            nbytes = st.nbytes()
            self._seen[st] = nbytes
            weakref.finalize(st, self._free, nbytes)
            self.live += nbytes
        self.peak = max(self.peak, self.live)
        return out


def _local(t: torch.Tensor) -> torch.Tensor:
    from torch.distributed.tensor import DTensor

    return t._local_tensor if isinstance(t, DTensor) else t


def _tensors(tree) -> list:
    """Every tensor of ``tree`` (a `Params`, a `TrainState`, dicts, lists
    and tuples of them), each once."""
    seen, out = set(), []
    for t in flatten_with_paths(tree).values():
        if isinstance(t, torch.Tensor) and id(t) not in seen:
            seen.add(id(t))
            out.append(t)
    return out


def local_bytes(tree) -> int:
    """Bytes of the local shards of every tensor in ``tree``."""
    return sum(_local(t).numel() * _local(t).element_size() for t in _tensors(tree))


def _versions(tree) -> list:
    return [(_local(t), _local(t)._version) for t in _tensors(tree)]


def _updated_bytes(before: list) -> int:
    """Bytes of the argument tensors the step wrote in place (their
    version counters moved)."""
    return sum(t.numel() * t.element_size() for t, v in before if t._version != v)


# ---------------------------------------------------------------------------
# One cell
# ---------------------------------------------------------------------------

def _cast_inference(params) -> None:
    """Inference deployments serve bf16 weights (half the memory)."""
    with torch.no_grad():
        for mod in params.modules():
            for name, p in list(mod._parameters.items()):
                if p is not None and p.is_floating_point():
                    mod._parameters[name] = torch.nn.Parameter(
                        p.to(torch.bfloat16), requires_grad=False)


def _inputs(specs: Dict[str, Any], device) -> Dict[str, torch.Tensor]:
    return {k: torch.zeros(s.shape, dtype=s.dtype, device=device)
            for k, s in specs.items()}


def _shard_cache(cache, mesh):
    """Every tensor of a decode cache tree a DTensor with `cache_shardings`'
    placements (keyed by the same paths as `flatten_with_paths`)."""
    from torch.distributed.tensor import distribute_tensor

    shardings = cache_shardings(cache, mesh)

    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, f"{path}/{k}" if path else str(k)) for k, v in node.items()}
        if isinstance(node, torch.Tensor):
            return distribute_tensor(node, mesh, shardings[path].placements)
        return node

    return walk(cache, "")


def _clone(tree):
    """A copy of every tensor of ``tree`` (a step without donation writes
    new buffers)."""
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not hasattr(tree, "_fields"):
        return type(tree)(_clone(v) for v in tree)
    return tree.clone() if isinstance(tree, torch.Tensor) else tree


def _card_info() -> Dict[str, str]:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        out = []
    return {"card": torch.cuda.get_device_name(0),
            "nvidia_smi": out[0] if out else "not read"}


def run_cell(arch: str, shape_name: str, mesh, *, variant: str = "auto",
             donate: bool = True, cfg_override=None,
             shape_override: Optional[InputShape] = None, fake: bool = True,
             device: str = "cuda") -> Dict[str, Any]:
    """Trace (``fake``) or run one cell; return the roofline record.

    ``mesh`` is a `DeviceMesh` over the current process group (fake or
    real) or None for one device without a mesh; ``device`` is where the
    tensors live (``cuda`` or ``cpu``).  ``shape_override`` replaces the
    named shape (a reduced cell)."""
    cfg = cfg_override if cfg_override is not None else get_arch(arch)
    shape = shape_override if shape_override is not None else INPUT_SHAPES[shape_name]
    variant = resolve_variant(cfg, shape, variant)
    rec: Dict[str, Any] = {
        "arch": arch, "shape": shape_name, "mesh": mesh_record(mesh),
        "variant": variant, "ok": False, "mode": "fake" if fake else "real",
    }
    ok, why = shape_applicable(cfg, shape)
    if not ok:
        rec["skipped"] = why
        return rec
    if variant == "fsdp" and mesh is not None:
        # ZeRO-3 per-layer gather; sequence-parallel activations only for
        # training (decode activations are (b, 1, d): nothing to shard).
        cfg = dataclasses.replace(cfg, fsdp_gather=True,
                                  seq_shard=(shape.kind == "train"))
    on_card = torch.device(device).type == "cuda" and not fake
    t0 = time.time()
    try:
        with (torch._subclasses.fake_tensor.FakeTensorMode() if fake
              else contextlib.nullcontext()):
            base = torch.cuda.memory_allocated() if on_card else 0
            run, args, mb = _build_step(cfg, shape, mesh, variant, donate, device)
            if mb:
                rec["microbatches"] = mb
            argument_bytes = local_bytes(args)
            before = _versions(args)
            rec["lower_s"] = round(time.time() - t0, 1)
            if on_card:
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
            from torch.utils.flop_counter import FlopCounterMode

            t1 = time.time()
            with FlopCounterMode(display=False) as flops, \
                    collect_collective_stats() as trace, LiveBytes() as live:
                out = run()
            if on_card:
                torch.cuda.synchronize()
            rec["compile_s"] = round(time.time() - t1, 1)
            rec["memory"] = {
                "argument_bytes": int(argument_bytes),
                "output_bytes": int(local_bytes(out)),
                "temp_bytes": int(live.peak),
                "alias_bytes": int(_updated_bytes(before)),
                "code_bytes": 0,
            }
            rec["peak_bytes"] = int(argument_bytes + live.peak)
            rec["cost"] = {"flops_per_device": float(flops.get_total_flops()),
                           "bytes_per_device": float(trace.bytes_accessed)}
            rec["collectives"] = trace.stats.summary()
            rec["collective_bytes"] = int(trace.stats.total_bytes)
            rec["cpu_upcast_bytes"] = int(cpu_bf16_upcast_bytes(trace))
            if on_card:
                rec["max_memory_allocated"] = int(torch.cuda.max_memory_allocated())
                rec["allocated_before_build"] = int(base)
                del out
                torch.cuda.synchronize()
                t2 = time.perf_counter()
                out = run()
                torch.cuda.synchronize()
                rec["step_ms"] = (time.perf_counter() - t2) * 1e3
                rec.update(_card_info())
            rec["loss"] = _loss_of(out)
        rec["ok"] = True
    except Exception as e:  # noqa: BLE001 — cell failures are data
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
        log.error("cell %s × %s failed: %s", arch, shape_name, rec["error"])
    return rec


def _loss_of(out) -> Optional[float]:
    """The train step's loss on real tensors (None when traced or not a
    train step)."""
    if not (isinstance(out, tuple) and len(out) == 2 and isinstance(out[1], dict)
            and "loss" in out[1]):
        return None
    loss = out[1]["loss"]
    return None if is_fake(loss) else float(loss)


def _build_step(cfg, shape, mesh, variant: str, donate: bool, device):
    """(run, arguments, microbatches) of one cell: ``run()`` is the step
    the record reads, ``arguments`` what it takes (state or parameters,
    the local inputs, the cache)."""
    model = build_model(cfg)
    params = model.init(0, device=device)
    batch = _inputs(model.input_specs(shape), device)
    if shape.kind == "train":
        state = train_state_for(trainable(params))
        if mesh is not None:
            shard_train_state(state, mesh, variant)
        # Gradient accumulation: 16 microbatches bound live activations to
        # one per-device row, as the reference's.  The port splits each
        # rank's rows, so a mesh with more than global/16 data ranks (the
        # multi-pod mesh at train_4k) takes one row a microbatch.
        mb = 16 if shape.global_batch % 16 == 0 else 1
        if mesh is not None:
            rows = next(iter(local_batch(batch, mesh).values())).shape[0]
            mb = min(mb, rows) if rows % min(mb, rows) == 0 else 1
        step = make_train_step(model, microbatches=mb, mesh=mesh, variant=variant)
        local = local_batch(batch, mesh) if mesh is not None else batch

        def run():
            return step(state if donate else _clone(state), batch)

        return run, (state, local), mb
    _cast_inference(params)
    if mesh is not None:
        distribute_params(params, mesh, variant)
        batch = local_batch(batch, mesh)
    if shape.kind == "prefill":
        # The LAST position's logits (serving samples the first new token;
        # all positions' logits would be b·s·vocab float32).
        def run():
            with torch.no_grad(), (use_mesh(mesh) if mesh is not None
                                   else contextlib.nullcontext()):
                return model.forward(params, batch)[:, -1]

        return run, (params, batch), 0
    cache = model.init_cache(shape.global_batch, shape.seq_len, device=device)
    if mesh is not None:
        cache = _shard_cache(cache, mesh)

    def run():
        with torch.no_grad(), (use_mesh(mesh) if mesh is not None
                               else contextlib.nullcontext()):
            return model.decode_step(params, batch, cache if donate else _clone(cache))

    return run, (params, batch, cache), 0


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default=None, help="architecture id (default: all)")
    ap.add_argument("--shape", default=None, help="input shape (default: all)")
    ap.add_argument("--mesh", choices=("single", "multi", "both"), default="both")
    ap.add_argument("--variant", default="auto",
                    help="sharding rule variant (auto|tp|fsdp)")
    ap.add_argument("--out", default="reports/dryrun_torch.json")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="device type of the fake tensors and the mesh (cuda|cpu)")
    args = ap.parse_args(argv)

    archs = [args.arch] if args.arch else sorted(ARCHS)
    shapes = [args.shape] if args.shape else list(INPUT_SHAPES)
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]

    results = []
    existing: Dict[Any, Any] = {}
    if os.path.exists(args.out):
        with open(args.out) as f:
            for r in json.load(f).get("cells", []):
                key = (r["arch"], r["shape"], json.dumps(r["mesh"]))
                existing[key] = r

    for multi_pod in meshes:
        with fake_world(512 if multi_pod else 256):
            mesh = make_production_mesh(multi_pod=multi_pod, device_type=args.device)
            log.info("=== mesh %s ===", mesh_record(mesh))
            for arch in archs:
                for shape in shapes:
                    key = (arch, shape, json.dumps(mesh_record(mesh)))
                    if key in existing and existing[key].get("ok"):
                        log.info("cached ok: %s × %s", arch, shape)
                        results.append(existing[key])
                        continue
                    t0 = time.time()
                    rec = run_cell(arch, shape, mesh, variant=args.variant,
                                   device=args.device)
                    results.append(rec)
                    status = "ok" if rec["ok"] else rec.get("skipped", rec.get("error", "?"))[:80]
                    log.info("%s × %s [%s]: %s (%.0fs)", arch, shape,
                             "multi" if multi_pod else "single", status,
                             time.time() - t0)
                    # Incremental save (long runs survive interruption).
                    _save(args.out, results, existing)
    _save(args.out, results, existing)
    n_ok = sum(1 for r in results if r.get("ok"))
    n_skip = sum(1 for r in results if "skipped" in r)
    log.info("dry-run complete: %d ok, %d skipped, %d failed",
             n_ok, n_skip, len(results) - n_ok - n_skip)


def _save(path: str, results, existing) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    merged: Dict[Any, Any] = dict(existing)
    for r in results:
        key = (r["arch"], r["shape"], json.dumps(r["mesh"]))
        merged[key] = r
    with open(path + ".tmp", "w") as f:
        json.dump({"cells": list(merged.values())}, f, indent=1)
    os.replace(path + ".tmp", path)


if __name__ == "__main__":
    main()
