#!/usr/bin/env python3
"""Three readings of the port's training steps on one NVIDIA H100, for
whichever `repro_torch` is first on the path (``PYTHONPATH=src`` for this
tree, or the ``src`` of another tree unpacked beside it):

    python3 probe_train_repeat.py measure out.json
    python3 probe_train_repeat.py diagnose out.json
    python3 probe_train_repeat.py sharded out.json

``measure``: Granite-MoE 1B at full width and depth through chip_smoke's
`train_model` (`TRAIN_SHAPE`, 8 steps, the launch gates, one profiled
step, then the repeat: the model rebuilt from seed 0 and its first 3
steps taken again).  Writes its line: median step ms, peak memory, the
profiled step's device-busy ms and torch's gather, scatter and index
kernels (``indexing_kernels_ms``), and ``repeat`` (not gated here).

``diagnose``: one training step of Granite and of each model of
chip_smoke's `TRAIN_MODELS` (their configs, shapes and rates) under
``torch.use_deterministic_algorithms(True, warn_only=True)``, with
``CUBLAS_WORKSPACE_CONFIG=:4096:8`` set in this process alone.  Two
records per model: the warnings torch raises (ops with no deterministic
implementation on the card), and, through a `TorchDispatchMode`, every
call of an op whose CUDA kernel adds or writes into shared elements in
an order that can change (`ACCUMULATING`), with whether its index
repeats.  The second is needed because in deterministic mode torch swaps
those ops for sorted versions without a warning.  A diagnostic only: the
port runs neither setting anywhere else.

``sharded``: where the world-size-1 sharded Granite step's loss parts
from the unsharded one's.  Granite at full width and depth, `TRAIN_SHAPE`,
`SHARDED_STEPS` steps from seed 0 on the same batches, with bfloat16 and
with float32 compute (TF32 off in both), four ways (`SHARDED_RUNS`):
unsharded; on a world-size-1 NCCL (1, 1) mesh under chip_smoke's
`SHARDED_VARIANT` with fsdp_gather and seq_shard, as its `sharded_train`;
on the mesh with seq_shard alone; and without a mesh with fsdp_gather
alone (its cast of every floating leaf to the compute dtype, nothing
gathered).  Each run's losses and its largest relative loss difference
from the unsharded run of its type.

Prints the card line (``nvidia-smi --query-gpu=name,power.limit``) and
one JSON line per model.
"""
from __future__ import annotations

import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

# aten ops (overload packets) whose CUDA kernels accumulate or write with
# atomics or unordered stores into elements that several inputs share,
# and where their index sits: (argument position, dim position or None
# for a flat index).
ACCUMULATING = {
    "scatter_add": (2, 1), "scatter_add_": (2, 1),
    "scatter_reduce": (2, 1), "scatter_reduce_": (2, 1),
    "scatter": (2, 1), "scatter_": (2, 1),
    "index_add": (2, 1), "index_add_": (2, 1),
    "index_copy": (2, 1), "index_copy_": (2, 1),
    "index_put": (1, None), "index_put_": (1, None), "_index_put_impl_": (1, None),
    "put_": (1, None),
    "embedding_dense_backward": (1, None), "embedding_backward": (1, None),
    "_embedding_bag_backward": (1, None),
}


def _repeats(index, dim) -> bool:
    """Whether ``index`` names one element twice: along ``dim`` for a
    scatter-style index, over all its entries for a flat one."""
    import torch

    if isinstance(index, (list, tuple)):
        parts = [t for t in index if isinstance(t, torch.Tensor)]
        if len(parts) != 1:
            return True
        index = parts[0]
    if index.dtype == torch.bool:
        return False
    if dim is None or index.dim() == 1:
        flat = index.reshape(-1)
        return bool(flat.numel() != torch.unique(flat).numel())
    srt = index.movedim(dim, -1).sort(dim=-1).values
    return bool((srt[..., 1:] == srt[..., :-1]).any())


def _logger():
    """A dispatch mode that counts the `ACCUMULATING` calls by op, dtype
    and whether their index repeats (or their accumulate flag is off)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Log(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.calls = {}

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            name = func.overloadpacket.__name__
            if name in ACCUMULATING:
                pos, dimpos = ACCUMULATING[name]
                index = args[pos] if len(args) > pos else None
                dim = args[dimpos] if dimpos is not None else None
                repeats = _repeats(index, dim) if index is not None else None
                if name.startswith("scatter_reduce"):
                    name += f"[{args[4] if len(args) > 4 else kwargs.get('reduce')}]"
                if "index_put" in name or name == "put_":
                    acc = args[3] if len(args) > 3 else kwargs.get("accumulate", False)
                    name += f"[accumulate={bool(acc)}]"
                dtype = next((str(a.dtype) for a in args
                              if hasattr(a, "dtype") and a.is_floating_point()), "")
                key = f"{name} {dtype} index_repeats={repeats}"
                self.calls[key] = self.calls.get(key, 0) + 1
            return func(*args, **kwargs)

    return Log()


def _models():
    import dataclasses

    import chip_smoke as cs
    from repro_torch.configs import get_arch

    yield get_arch(cs.LM_ARCH), cs.TRAIN_SHAPE, cs.TRAIN_KW["base_lr"]
    for arch, (over, shape, _, lr) in cs.TRAIN_MODELS.items():
        yield dataclasses.replace(get_arch(arch), **over), shape, lr


def diagnose(device) -> list:
    import gc
    import warnings

    import torch

    import chip_smoke as cs
    from repro_torch.distributed import init_train_state, make_train_step
    from repro_torch.models import build_model

    torch.use_deterministic_algorithms(True, warn_only=True)
    rows = []
    for cfg, (b, s), lr in _models():
        model = build_model(cfg)
        state = init_train_state(model, 0, device=device)
        cs._set_gates(state.params, cfg, cs.ZOO_GATE)
        step = make_train_step(model, **dict(cs.TRAIN_KW, base_lr=lr))
        batch = cs._torch_batch(cs._train_data(cfg, b, s, seed=0).batch_at(0), device)
        log = _logger()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            with log:
                state, metrics = step(state, batch)
                loss = float(metrics["loss"])
        warned = sorted({str(w.message).split("\n")[0][:300] for w in caught})
        row = {"arch": cfg.name, "tokens": [b, s], "loss": loss,
               "nondeterministic_warnings": warned, "accumulating_calls": log.calls}
        print(json.dumps(row), flush=True)
        rows.append(row)
        del state, step, model, batch
        gc.collect()
        torch.cuda.empty_cache()
    return rows


def measure(device) -> list:
    import chip_smoke as cs
    from repro_torch.configs import get_arch

    row = cs.train_model(get_arch(cs.LM_ARCH), cs.TRAIN_SHAPE, device)
    keep = ("arch", "tokens", "losses", "grad_norms", "median_step_ms", "peak_memory_gb",
            "step_s", "repeat")
    out = {k: row[k] for k in keep}
    prof = row["profile"]
    out.update(device_busy_ms=prof["device_busy_ms"], wall_ms=prof["wall_ms"],
               indexing_kernels_ms=prof["indexing_kernels_ms"],
               top_kernels_ms=prof["top_kernels_ms"])
    print(json.dumps(out), flush=True)
    return [out]


# ``sharded``: steps a run, and the runs: (name, config fields, on the mesh).
SHARDED_STEPS = 3
SHARDED_RUNS = (("unsharded", {}, False),
                ("mesh_fsdp_gather_seq_shard", {"fsdp_gather": True, "seq_shard": True}, True),
                ("mesh_seq_shard", {"seq_shard": True}, True),
                ("fsdp_gather_cast_only", {"fsdp_gather": True}, False))


def sharded(device) -> list:
    import dataclasses
    import gc

    import torch
    import torch.distributed as dist

    import chip_smoke as cs
    from repro_torch.configs import get_arch
    from repro_torch.distributed import init_train_state, make_train_step
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import build_model

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    b, s = cs.TRAIN_SHAPE
    store = cs._nccl_world_of_one(device)
    rows = []
    try:
        mesh = make_mesh((1, 1), ("data", "model"))
        for dtype in ("float32", "bfloat16"):
            base = dataclasses.replace(get_arch(cs.LM_ARCH), compute_dtype=dtype)
            data = cs._train_data(base, b, s, seed=0)
            first = None
            for name, fields, on_mesh in SHARDED_RUNS:
                cfg = dataclasses.replace(base, **fields)
                model = build_model(cfg)
                state = init_train_state(model, 0, device=device)
                kw = dict(mesh=mesh, variant=cs.SHARDED_VARIANT) if on_mesh else {}
                step = make_train_step(model, **kw, **dict(cs.TRAIN_KW,
                                                            total_steps=SHARDED_STEPS))
                losses = []
                for i in range(SHARDED_STEPS):
                    state, metrics = step(state, cs._torch_batch(data.batch_at(i), device))
                    losses.append(float(metrics["loss"]))
                first = first or losses
                row = {"compute_dtype": dtype, "run": name, "tokens": [b, s],
                       "losses": losses, "bit_equal": losses == first,
                       "max_rel_loss_diff": max(abs(a - w) / abs(w)
                                                for a, w in zip(losses, first))}
                print(json.dumps(row), flush=True)
                rows.append(row)
                del state, step, model
                gc.collect()
                torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
        if os.path.exists(store):
            os.unlink(store)
    return rows


def main(argv) -> int:
    mode, path = argv[1], Path(argv[2])
    if mode == "diagnose":
        os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    import torch

    import chip_smoke as cs

    if not torch.cuda.is_available():
        print("probe_train_repeat: needs a CUDA card", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    torch.empty(1, device=device)   # the allocator, before its peak is reset
    card = cs.card_line()
    print(f"card: {card}", flush=True)
    from repro_torch.kernels import _build

    _build.build_all([lib for m in cs.kernel_modules()
                      for lib in getattr(m, "LIBRARIES", (m.LIBRARY,))])
    t0 = time.perf_counter()
    rows = {"diagnose": diagnose, "measure": measure, "sharded": sharded}[mode](device)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps({"card": card, "mode": mode,
                                "repro_torch": str(Path(__import__("repro_torch").__file__)
                                                   .parent),
                                "seconds": time.perf_counter() - t0, "rows": rows},
                               indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
