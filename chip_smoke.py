#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`src/repro_torch`) on one NVIDIA H100.

    python3 chip_smoke.py            # from the repository root, one card

Phases; each one fails the run on error, and a failed run prints no
result line:

  1. Card and build — the card's name and power limit (nvidia-smi) and
     the nvcc build of ``src/repro_torch/kernels/csrc/tree_gather.cu``.
  2. Kernel parity — both kernels against their plain torch versions on
     the card, at 32,768 rows × 20 features, on a GBDT bank (150 stages,
     depth 4: the bank sits in shared memory) and on a depth-14 random
     forest too large for shared memory (the bank stays in global
     memory).  Leaves bit-equal; fused predictions within the summation
     bound stated in `fused_tolerance`.
  3. Main path — profile 40 NAS graphs at 224×224 on the card, train a
     GBDT bank on 32, score the 8 held out (e2e MAPE through the fused
     kernel, per-op MAPE through the leaves kernel), then answer a
     1,024-graph `predict_batch`, a cached `predict_e2e` and a 256-graph
     `predict_batch`.  Launch counts are zeroed just before and read just
     after; every tree model must have run on "cuda".
  4. Times at the main path's shapes — kernel, plain version and numpy
     host tier; the bound from bytes moved at 3.35 TB/s (and operations
     at 67 TFLOP/s float32); launches per `predict_batch`; and a
     numpy-vs-kernel curve over 2^10 … 2^22 slots for the future
     ``AUTO_DEVICE_MIN_SLOTS``.  No single PyTorch call computes a tree
     traversal, so ``library_ms`` is null.

The last two lines are the kernels' JSON record and
``{"ok": true, "device": {...}}``.  Without CUDA, or when run from a
directory that does not hold ``src/repro_torch``, it exits non-zero.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PEAK_BYTES_PER_S = 3.35e12          # H100 SXM HBM3
PEAK_F32_OPS_PER_S = 67e12          # H100 SXM float32, outside the tensor cores
U32 = 2.0 ** -24                    # float32 unit roundoff
N_FEATURES = 20
PARITY_ROWS = 32768
KERNEL_SOURCE = "src/repro_torch/kernels/csrc/tree_gather.cu"
REPLACES = "src/repro/kernels/tree_gather_pallas.py:57"


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


# Cycles of the sleep kernel queued ahead of a timed loop (about 0.1 s at
# the H100's boost clock): the host queues every launch of the loop while
# the card sleeps, so the events time the launches back to back on the
# card and not the host's Python between them.
SLEEP_CYCLES = 200_000_000


def cuda_ms(fn, iters: int = 50, warmup: int = 5) -> dict:
    """Per-call milliseconds of ``fn`` measured two ways (CUDA events):
    ``device`` — launches queued behind a sleep kernel, so the card runs
    them back to back; ``host`` — each call issued and the loop
    synchronized, so the host's own cost per call is included."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    host = (time.perf_counter() - t0) / iters * 1e3
    slept, start, end = (torch.cuda.Event(enable_timing=True) for _ in range(3))
    slept.record()
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    end.record()
    queued_ms = (time.perf_counter() - t0) * 1e3
    end.synchronize()
    if queued_ms >= slept.elapsed_time(start):
        # The host fell behind the sleep: gaps would inflate the time.
        raise AssertionError(f"timing loop not hidden behind the sleep "
                             f"({queued_ms:.1f} ms to queue)")
    return {"device": start.elapsed_time(end) / iters, "host": host}


def host_ms(fn, repeats: int = 3) -> float:
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best * 1e3


def bound(bytes_moved: float, ops: float) -> tuple:
    """(ms, "bytes" | "operations"): the larger of the two floor times."""
    t_bytes = bytes_moved / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def traffic(db, rows: int, d: int, fused: bool) -> tuple:
    """(bytes, operations) one launch needs: x read once, the output
    written once, the bank (and mean/std) read once; one compare per
    slot and round, one add per slot, subtract + divide per feature."""
    slots = rows * db.n_trees
    nbytes = rows * d * 4 + db.n_nodes * 20 + db.n_trees * 4
    ops = slots * db.depth
    if fused:
        nbytes += rows * 4 + 2 * d * 4
        ops += slots + 2 * rows * d
    else:
        nbytes += slots * 4
    return nbytes, ops


def fused_tolerance(leaves, pred, scale: float, kind: str):
    """Per-row bound on |kernel − plain| for the fused prediction.

    Both compute the same float32 leaves; only the order of the
    reduction over T trees differs.  Any two summation orders of T terms
    differ by at most 2·(T−1)·u·Σ|leaf| (u = 2^-24); the scale, the mean's
    division and the bias add round once each (≤ 4u·|pred| together).
    """
    t = leaves.shape[1]
    s = leaves.abs().sum(dim=1).double()
    if kind == "mean":
        s = s / t
    return 2 * t * U32 * abs(scale) * s + 4 * U32 * pred.abs().double() + 1e-30


# -- phase 2 ------------------------------------------------------------------

def _regression_data(rng, n: int):
    import numpy as np

    x = np.abs(rng.standard_normal((n, N_FEATURES))) * np.linspace(1, 50, N_FEATURES)
    y = 1e-5 * (x @ rng.random(N_FEATURES)) * (1 + 0.1 * rng.standard_normal(n))
    return x, np.abs(y) + 1e-6


def parity_models(seed: int = 0):
    """A GBDT at the default bank's size and a depth-14 random forest."""
    import numpy as np
    from repro_torch.core.dataset import FAST_HPARAMS
    from repro_torch.core.predictors import GBDTPredictor, RandomForestPredictor

    rng = np.random.default_rng(seed)
    gbdt = GBDTPredictor(**FAST_HPARAMS["gbdt"]).fit(*_regression_data(rng, 2000))
    rf = RandomForestPredictor(n_trees=10, max_depth=14).fit(
        *_regression_data(rng, 4000))
    return [("gbdt_150x4", gbdt, True), ("rf_10x14", rf, False)]


def check_parity(name: str, model, in_smem: bool, device, rows: int = PARITY_ROWS,
                 seed: int = 1) -> dict:
    """Both kernels vs their plain versions on one bank; raises on mismatch."""
    import numpy as np
    import torch
    from repro_torch.kernels import tree_gather as tg
    from repro_torch.kernels import tree_gather_cuda as tgc

    rng = np.random.default_rng(seed)
    raw = np.abs(rng.standard_normal((rows, N_FEATURES))) * np.linspace(1, 50, N_FEATURES)
    db = model.flat().device_bank(device)
    plan = tgc._plan(db, rows, N_FEATURES)
    if bool(plan["bank_in_smem"]) != in_smem:
        raise AssertionError(f"{name}: bank of {db.n_nodes} nodes expected "
                             f"{'in' if in_smem else 'outside'} shared memory")
    xs = torch.from_numpy(model.scaler.transform(raw).astype(np.float32)).to(db.device)
    xr = torch.from_numpy(raw.astype(np.float32)).to(db.device)
    mean, std = tg.to_device_scaler(model.scaler, db.device)
    kind, scale, bias = model._device_reduction()

    before = tgc.launch_counts()
    leaves_k = tgc.gather_leaves_cuda(db, xs)
    fused_k = tgc.fused_predict_cuda(db, mean, std, scale, bias, xr, kind)
    fused_k2 = tgc.fused_predict_cuda(db, mean, std, scale, bias, xr, kind)
    torch.cuda.synchronize()
    after = tgc.launch_counts()
    if after["tree_gather_leaves"] - before["tree_gather_leaves"] != 1 or \
            after["tree_predict_fused"] - before["tree_predict_fused"] != 2:
        raise AssertionError(f"{name}: launch counters did not advance: {before} → {after}")

    leaves_p = tg.gather_leaves_plain(*db.bank_args, xs, depth=db.depth)
    if not torch.equal(leaves_k, leaves_p):
        n_bad = int((leaves_k != leaves_p).sum())
        raise AssertionError(f"{name}: {n_bad} leaves differ from the plain version")
    fused_p = tg.fused_plain(*db.bank_args, mean, std, scale, bias, xr,
                             depth=db.depth, kind=kind)
    leaves_std = tg.gather_leaves_plain(*db.bank_args, (xr - mean) / std,
                                        depth=db.depth)
    tol = fused_tolerance(leaves_std, fused_p, scale, kind)
    err = (fused_k.double() - fused_p.double()).abs()
    if not bool((err <= tol).all()):
        raise AssertionError(f"{name}: fused kernel off by {float(err.max())} "
                             f"(bound {float(tol[err.argmax()])})")
    if not torch.equal(fused_k, fused_k2):
        raise AssertionError(f"{name}: fused kernel is not repeatable")
    res = {"bank": name, "nodes": db.n_nodes, "trees": db.n_trees,
           "depth": db.depth, "bank_in_smem": bool(plan["bank_in_smem"]),
           "rows": rows, "leaves_bit_equal": True,
           "fused_max_abs_err": float(err.max()),
           "fused_max_err_over_bound": float((err / tol).max())}
    log("parity " + json.dumps(res))
    return res


# -- phase 3 ------------------------------------------------------------------

def per_type_matrices(graphs, op_types, f32: bool):
    """op type → feature rows of every (fused) graph, in serving order."""
    import numpy as np
    from repro_torch.core.features import graph_features
    from repro_torch.core.fusion import fuse_graph

    mats = {t: [] for t in op_types}
    for g in graphs:
        gf = graph_features(fuse_graph(g)[1])
        for t in op_types:
            if t in gf.matrix:
                mats[t].append(gf.matrix32(t) if f32 else gf.matrix[t])
    return {t: np.concatenate(m, axis=0) for t, m in mats.items() if m}


def per_op_mape(bank, graphs, store, setting) -> dict:
    """Per-op-type MAPE of held-out graphs through `Predictor.predict`
    (``inference_backend="auto"`` → the leaves kernel on the card)."""
    import numpy as np
    from repro_torch.core.composition import mape
    from repro_torch.core.features import graph_features
    from repro_torch.core.fusion import fuse_graph

    truth = {}
    for g in graphs:
        rec = store.get_arch(setting, g.fingerprint())
        gf = graph_features(fuse_graph(g)[1])
        for t, idx in gf.index.items():
            truth.setdefault(t, []).extend(rec.ops[k].latency_s for k in idx)
    xs = per_type_matrices(graphs, bank.predictors, f32=False)
    out = {}
    for t, x in xs.items():
        model = bank.predictors[t]
        model.inference_backend = "auto"
        out[t] = mape(truth[t], model.predict(x))
        model.inference_backend = "numpy"
    return out


def run_main_path(device, n_graphs: int = 40, n_train: int = 32,
                  resolution: int = 224, population: int = 1024,
                  second: int = 256) -> dict:
    """Profile → train → serve through the port's entry points."""
    import numpy as np
    from repro_torch.core.composition import PredictorBank, mape
    from repro_torch.core.dataset import synthetic_graphs
    from repro_torch.core.features import graph_features
    from repro_torch.core.fusion import fuse_graph
    from repro_torch.core.predictors.flat import device_tier
    from repro_torch.core.profiler import DeviceSetting, ProfileSession
    from repro_torch.kernels import tree_gather_cuda as tgc
    from repro_torch.pipeline import LatencyService, PredictorHub, ProfileStore

    setting = DeviceSetting("h100_f32", "float32", "fused_groups", device="h100")
    graphs = synthetic_graphs(n_graphs, resolution=resolution)
    pop = synthetic_graphs(population, resolution=resolution, seed0=10_000)
    pop2 = synthetic_graphs(second, resolution=resolution, seed0=20_000)
    train, held = graphs[:n_train], graphs[n_train:]

    tgc.reset_launch_counts()
    store = ProfileStore()
    session = ProfileSession(store=store, device=device)
    t0 = time.perf_counter()
    session.profile_suite(graphs, setting)
    profile_s = time.perf_counter() - t0

    hub = PredictorHub()
    t0 = time.perf_counter()
    bank = hub.train(store, setting, "gbdt",
                     fingerprints=[g.fingerprint() for g in train])
    train_s = time.perf_counter() - t0
    svc = LatencyService(hub, default_setting=setting, predictor="gbdt",
                         device=device)

    held_reports = svc.predict_batch(held)
    measured = [store.get_arch(setting, g.fingerprint()).e2e_s for g in held]
    e2e_mape = mape(measured, [r.e2e_s for r in held_reports])
    op_mape = per_op_mape(bank, held, store, setting)

    launches0 = tgc.launch_counts()
    t0 = time.perf_counter()
    reports = svc.predict_batch(pop)
    batch_s = time.perf_counter() - t0
    launches1 = tgc.launch_counts()
    hit = svc.predict_e2e(pop[0])
    t0 = time.perf_counter()
    reports2 = svc.predict_batch(pop2)
    batch2_s = time.perf_counter() - t0
    counts = tgc.launch_counts()
    stats = svc.stats()

    # The host's share of a cold predict_batch: fingerprint, fuse and
    # featurize graphs the process has not seen.
    cold = synthetic_graphs(population, resolution=resolution, seed0=30_000)
    t0 = time.perf_counter()
    for g in cold:
        g.fingerprint()
        graph_features(fuse_graph(g)[1])
    featurize_s = time.perf_counter() - t0

    # What came out, and how it was served.
    for rs, n in ((reports, population), (reports2, second)):
        if len(rs) != n:
            raise AssertionError(f"predict_batch returned {len(rs)} reports for {n}")
        vals = np.array([r.e2e_s for r in rs] + [p for r in rs for _, p in r.per_op])
        if not np.isfinite(vals).all():
            raise AssertionError("non-finite prediction")
        if any(p < 0 for r in rs for _, p in r.per_op):
            raise AssertionError("negative per-op prediction")
    if not hit.from_cache or hit.e2e_s != reports[0].e2e_s:
        raise AssertionError("repeat predict_e2e was not a cache hit")
    runs, tier = stats["backend_runs"], device_tier(device)
    if set(runs) != {tier} or stats["device_fused_runs"] != runs[tier]:
        raise AssertionError(f"tree models did not all run on {tier}: {runs}, "
                             f"fused {stats['device_fused_runs']}")
    if counts["tree_predict_fused"] != stats["device_fused_runs"]:
        raise AssertionError(f"fused launches {counts} != fused runs "
                             f"{stats['device_fused_runs']}")
    if counts["tree_gather_leaves"] == 0:
        raise AssertionError("the leaves kernel was never launched")
    res = stats["device_residency"]
    if not res["bank_uploads"] == res["banks"] == len(bank.predictors):
        raise AssertionError(f"banks uploaded more than once: {res}")

    # Held against the plain torch tier on the host on a small input: the
    # same bank (rebuilt from its JSON) scores the held-out graphs.
    cpu_hub = PredictorHub()
    cpu_hub.register(setting, "gbdt", PredictorBank.from_json(bank.to_json()))
    ref = LatencyService(cpu_hub, default_setting=setting, device="cpu")
    ref_reports = ref.predict_batch(held)
    ref_runs = ref.stats()["backend_runs"]
    if set(ref_runs) != {"torch"}:
        raise AssertionError(f"host reference did not run the torch tier: {ref_runs}")
    rel = max(abs(a.e2e_s - b.e2e_s) / abs(b.e2e_s)
              for a, b in zip(held_reports, ref_reports))
    if rel > 1e-5:   # same f32 leaves; per-type sums differ only in order
        raise AssertionError(f"card vs host torch tier: rel diff {rel}")

    out = {"profile_s": profile_s, "train_s": train_s,
           "measured_ops": session.measured_ops, "graphs": n_graphs,
           "op_types": sorted(bank.predictors), "e2e_mape_held_out": e2e_mape,
           "per_op_mape_held_out": op_mape,
           "predict_batch_1024_s": batch_s, "predict_batch_256_s": batch2_s,
           "host_featurize_1024_cold_s": featurize_s,
           "launches_per_predict_batch_1024": {
               k: launches1[k] - launches0[k] for k in launches1},
           "launches": counts, "backend_runs": runs,
           "device_fused_runs": stats["device_fused_runs"],
           "bank_uploads": res["bank_uploads"], "banks": res["banks"],
           "held_out_rel_diff_vs_host_torch": rel}
    log("main_path " + json.dumps(out))
    return {"summary": out, "bank": bank, "held": held, "population": pop}


# -- phase 4 ------------------------------------------------------------------

def _timed(op_type: str, db, rows: int, d: int, fused: bool, kernel, plain,
           numpy_tier, err: float) -> dict:
    """One op type's row of the timing table (device and host times)."""
    from repro_torch.kernels import tree_gather_cuda as tgc

    # The plain version issues tens of launches a call: 3 calls keep the
    # queued loop inside CUDA's launch queue while the card sleeps.
    k, p = cuda_ms(kernel), cuda_ms(plain, iters=3, warmup=2)
    b_ms, b_by = bound(*traffic(db, rows, d, fused))
    return {"op_type": op_type, "rows": rows, "trees": db.n_trees,
            "nodes": db.n_nodes,
            "bank_in_smem": bool(tgc._plan(db, rows, d)["bank_in_smem"]),
            "max_abs_err": err, "ms": k["device"], "host_ms": k["host"],
            "plain_ms": p["device"], "plain_host_ms": p["host"],
            "numpy_ms": host_ms(numpy_tier), "bound_ms": b_ms, "bound_by": b_by}


def time_kernels(bank, held, population, device) -> dict:
    """Kernel vs plain vs numpy at the shapes the main path launched:
    the fused kernel at the 1,024-graph population's rows per op type,
    the leaves kernel at the held-out evaluation's (and, for reference,
    at the population's)."""
    import numpy as np
    import torch
    from repro_torch.kernels import tree_gather as tg
    from repro_torch.kernels import tree_gather_cuda as tgc

    out = {"tree_predict_fused": [], "tree_gather_leaves": [],
           "tree_gather_leaves@population": []}
    pop32 = per_type_matrices(population, bank.predictors, f32=True)
    pop64 = per_type_matrices(population, bank.predictors, f32=False)
    for t, xr_h in pop32.items():
        model = bank.predictors[t]
        model.inference_backend = "numpy"
        db = model.flat().device_bank(device)
        mean, std = tg.to_device_scaler(model.scaler, db.device)
        kind, scale, bias = model._device_reduction()
        xr = torch.from_numpy(xr_h).to(db.device)
        k = tgc.fused_predict_cuda(db, mean, std, scale, bias, xr, kind)
        p = tg.fused_plain(*db.bank_args, mean, std, scale, bias, xr,
                           depth=db.depth, kind=kind)
        leaves = tg.gather_leaves_plain(*db.bank_args, (xr - mean) / std,
                                        depth=db.depth)
        err = (k.double() - p.double()).abs()
        if not bool((err <= fused_tolerance(leaves, p, scale, kind)).all()):
            raise AssertionError(f"fused kernel off on {t}: {float(err.max())}")
        out["tree_predict_fused"].append(_timed(
            t, db, *xr.shape, True,
            lambda: tgc.fused_predict_cuda(db, mean, std, scale, bias, xr, kind),
            lambda: tg.fused_plain(*db.bank_args, mean, std, scale, bias, xr,
                                   depth=db.depth, kind=kind),
            lambda: model.predict(pop64[t]), float(err.max())))
    held64 = per_type_matrices(held, bank.predictors, f32=False)
    for key, mats in (("tree_gather_leaves", held64),
                      ("tree_gather_leaves@population", pop64)):
        for t, x in mats.items():
            model = bank.predictors[t]
            db = model.flat().device_bank(device)
            x_std = model.scaler.transform(x)
            xs = torch.from_numpy(x_std.astype(np.float32)).to(db.device)
            if not torch.equal(tgc.gather_leaves_cuda(db, xs),
                               tg.gather_leaves_plain(*db.bank_args, xs,
                                                      depth=db.depth)):
                raise AssertionError(f"leaves kernel differs on {t}")
            out[key].append(_timed(
                t, db, *xs.shape, False,
                lambda: tgc.gather_leaves_cuda(db, xs),
                lambda: tg.gather_leaves_plain(*db.bank_args, xs, depth=db.depth),
                lambda: model.flat().predict_trees(x_std, backend="numpy"), 0.0))
    for key, rows in out.items():
        for r in rows:
            log(f"time {key} " + json.dumps(r))
    return out


def auto_curve(model, device) -> list:
    """numpy host tier vs the fused device path (upload + kernel +
    download, as serving pays it) over 2^10 … 2^22 row×tree slots."""
    import numpy as np
    import torch

    rng = np.random.default_rng(2)
    t = model.flat().n_trees
    d = len(model.scaler.mean)
    model.inference_backend = "numpy"
    points = []
    for p in range(10, 23, 2):
        rows = max(1, (1 << p) // t)
        x = np.abs(rng.standard_normal((rows, d))) * (np.abs(model.scaler.mean) + 1)
        x32 = x.astype(np.float32)
        x64 = x32.astype(np.float64)

        def dev():
            model.predict_on_device(x32, device=device)
            torch.cuda.synchronize()

        pt = {"slots": rows * t, "rows": rows,
              "numpy_ms": host_ms(lambda: model.predict(x64)),
              "cuda_path_ms": host_ms(dev, repeats=5)}
        points.append(pt)
        log("auto_curve " + json.dumps(pt))
    return points


def summarize(rows: list, launches: int, parity_err: float) -> dict:
    tot = {k: math.fsum(r[k] for r in rows) for k in ("ms", "plain_ms", "bound_ms")}
    ops_bound = any(r["bound_by"] == "operations" for r in rows)
    return {"launches": launches,
            "max_abs_err": max([parity_err] + [r["max_abs_err"] for r in rows]),
            "ms": tot["ms"], "plain_ms": tot["plain_ms"],
            "bound_ms": tot["bound_ms"],
            "bound_by": "operations" if ops_bound else "bytes",
            "library_ms": None}


def main() -> int:
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc" / "tree_gather.cu").exists():
        print("chip_smoke: src/repro_torch is not beside this script", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 3
    sys.path.insert(0, str(ROOT / "src"))
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    phase = "card"
    try:
        card = card_line()
        log(f"card: {card}")
        log(f"torch {torch.__version__} cuda {torch.version.cuda} "
            f"python {sys.version.split()[0]}")
        phase = "build"
        from repro_torch.kernels import tree_gather_cuda as tgc

        tgc.load_library()
        log(f"build: {tgc.BUILD_INFO['path']} in {tgc.BUILD_INFO['seconds']:.2f} s")
        for line in tgc.BUILD_INFO["ptxas"].splitlines():
            if "registers" in line or "Compiling entry" in line:
                log("ptxas: " + line.strip())

        phase = "parity"
        parity = [check_parity(n, m, s, device) for n, m, s in parity_models()]

        phase = "main path"
        main_path = run_main_path(device)
        summary = main_path["summary"]

        phase = "times"
        timed = time_kernels(main_path["bank"], main_path["held"],
                             main_path["population"], device)
        preds = main_path["bank"].predictors
        curve = auto_curve(preds.get("conv2d") or next(iter(preds.values())),
                           device)
        log("auto_curve_summary " + json.dumps(
            [(p["slots"], p["numpy_ms"], p["cuda_path_ms"]) for p in curve]))
        log("library_ms: null — no single PyTorch call computes a tree-ensemble "
            "traversal")

        parity_err = max(p["fused_max_abs_err"] for p in parity)
        kernels = []
        for name in ("tree_gather_leaves", "tree_predict_fused"):
            entry = {"name": name, "route": "cuda", "source": KERNEL_SOURCE,
                     "replaces": REPLACES}
            entry.update(summarize(timed[name], summary["launches"][name],
                                   parity_err if name == "tree_predict_fused" else 0.0))
            kernels.append(entry)
        log(f"card: {card_line()}")
        log(json.dumps({"kernels": kernels}))
    except Exception:
        traceback.print_exc()
        print(f"chip_smoke: FAIL in phase {phase}", file=sys.stderr)
        return 1
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
