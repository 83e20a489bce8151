#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`src/repro_torch`) on one NVIDIA H100.

    python3 chip_smoke.py            # from the repository root, one card

Phases; each one fails the run on error, and a failed run prints no
result line:

  1. Card and build — the card's name and power limit (nvidia-smi) and
     the nvcc build of the seven sources under
     ``src/repro_torch/kernels/csrc/`` (one nvcc each, started together):
     seconds, registers, spills and shared memory per kernel, and the
     int8 GEMM's ``IMMA`` instructions in its SASS (none fails the run).
  2. Kernel parity on the card, each kernel against its plain torch
     version:
       * tree kernels at 32,768 rows × 20 features, on a GBDT bank (150
         stages, depth 4: kept complete, the ``staged`` route) and on a
         depth-14 random forest (the ``packed`` route).  Leaves
         bit-equal; fused predictions within the summation bound stated
         in `fused_tolerance` and repeatable; each launch on its route;
       * int8 GEMM bit-equal at m = 1, at the main path's largest FC,
         1×1 and k×k convolution shapes, at shapes that are not
         multiples of the tile, on the split-k route (`SPLIT_K_SHAPES`)
         and with A row-strided as the executor's im2col gives it, each
         also repeatable;
       * Winograd within `WINO_TOL` of its plain version and within
         `DIRECT_TOL` of ``F.conv2d`` (TF32 off) at the four study shapes
         and at odd H and W;
       * the int8 float round trips on all 256 int8 values, card against
         host, and the int8 executor on 2 graphs at 224×224, card against
         host: exact, unless a transcendental kind differs on the card;
       * flash attention (`FLASH_CASES`: the Granite forward's shape,
         float32, non-causal, ragged s, d = 128, the Zamba2 forward's
         MHA shape, and the LM zoo's: gemma2's local (window 4,096) and
         global layers with the softcap of 50 at 6,144 tokens, a ragged
         window of 100 in both types, the VLM's and Whisper's
         cross-attention (sq != skv), Whisper's encoder, and the VLM's
         and Whisper's causal self-attention at their training shapes)
         and the MoE
         GMM (`GMM_CASES`: the decode and prefill shapes, float32,
         ragged) within `LM_TOL`, bfloat16 flash also row by row within
         `FLASH_ROW_TOL`; each softcap case's q is scaled so that the
         plain version without the softcap, or with it after the log2(e)
         fold, fails those gates (gated);
         the flash backward kernel (dq, dk, dv) against
         `flash_attention_backward_plain` at `FLASH_BWD_CASES` (gemma2's
         global and local training calls with their softcap and window,
         windows of 100 with an offset, on both routes, and every
         attention call of the VLM's and Whisper's training steps; the
         forward's
         log-sum-exp within `LSE_TOL` of its plain version, its output
         bit-equal to the inference forward's) and the GMM's
         autograd at `GMM_BWD_CASES` against the plain version's, within
         `LM_TOL`, bfloat16 flash rows within `FLASH_ROW_TOL` of their
         floored max (`FLASH_BWD_ROW_FLOOR`);
         bfloat16 on the tensor-core kernels and float32 on the CUDA-core
         ones (each wrapper's per-route count);
         reduced Granite-MoE and Qwen2 in float32 on the card against the
         port on the host within `HOST_TOL`;
       * the SSD scan (`SSD_CASES`: both SSM path shapes, a ragged shape,
         one chunk, bfloat16) bit-equal to its plain version; its backward
         (`SSD_BWD_CASES`: Mamba2's and Zamba2's training calls, one
         chunk, a ragged shape on the scalar route, a nonzero g_final,
         bfloat16) with ds bit-equal to `ssd_scan_backward_plain`, ddecay
         within its worst-case sum ceiling (`ddecay_tolerance`) and within
         DDECAY_SIGMAS·sqrt(P·N)·u·Σ|x| of the float64 sum (`ddecay_gates`),
         both repeatable;
         reduced Mamba2 and a 5-layer Zamba2 (two groups and a tail) in
         float32 on the card against the port on the host within
         `HOST_TOL`.
  3. Paths, each with every launch count zeroed just before it and read
     just after:
       * float32 (`fused_groups`): profile 40 NAS graphs at 224×224, train
         a GBDT bank on 32, score the 8 held out (e2e MAPE through the
         fused kernel, per-op MAPE through the leaves kernel), then answer
         a 1,024-graph `predict_batch`, a cached `predict_e2e` and a
         256-graph `predict_batch`; every tree model must run on "cuda";
         the parity banks and this path together take every route of
         the tree kernels' plan;
       * int8 (`op_by_op`): the same through the int8 executor, whose FC
         and dense convolutions run the int8 GEMM kernel, every one of its
         routes taken (one pass and split k; A by cp.async and by words);
       * the transfer path: the int8 setting onboarded as a new device
         from K measurements (`run_transfer_path`).  A float32
         ``op_by_op`` source is profiled on the card (40 graphs, a store
         of its own) with a GBDT bank on the 32 training graphs; at each
         K of `TRANSFER_BUDGETS` `TransferEngine` measures at most K
         sampled ops through a fresh int8 `ProfileSession` on the card
         (the int8 GEMM launched; ratio-scaled composition) and the
         calibrated bank scores the 8 held-out graphs through the leaves
         kernel: finite and > 0, only the ``cuda`` tier; held-out e2e MAPE
         against the int8 main path's measurements, beside that path's
         fully trained bank, reported.  Then one service with an
         `Observability` bundle holds both banks: a `LatencyScorer` with
         budgets on both settings over 64 fresh graphs (one
         `predict_batch` per setting, the fused kernel for the source, the
         leaves kernel for the target, the target's median budget leaves
         some but not all feasible, one ``service.predict_batch`` span per
         call and one ``service.kernel`` span per ``cuda`` run, none in
         error), and the drift monitor fed by a second target session
         measuring the held-out graphs' ops (one observation per op with a
         predictor);
       * the paper method path (`run_paper_method_path`), over the
         transfer path's float32 ``op_by_op`` store and the int8 main
         path's store: the 40 graphs profiled under ``whole_jit`` in
         float32 and int8 (ops served from those stores, e2e through one
         CUDA-graph replay); each graph's ``whole_jit`` outputs against
         ``op_by_op`` within tests/test_torch_executor.py's bound
         (bit-equality reported), the kernels' launch counts equal to
         captured × replays (the int8 GEMM in every int8 graph), e2e of
         ``op_by_op`` (sync per op), ``fused_groups`` and ``whole_jit``,
         capture time, the graph's kernel nodes against its ops and the
         phase's peak memory; the Fig. 8 Winograd graphs held the same
         way.  Then each op type's measured latency over its H100
         roofline label (`core/cost_model.py`; float32 at 67 TFLOP/s) and
         `graph_cost` against measured e2e; then the paper's §3.1.1
         multi-worker model over the float32 store's op latencies
         (speedup at 1–4 workers, equal against weighted split for a
         fast and a slow worker, a `StragglerMonitor` seeded from the
         float32 GBDT bank's predictions): a model composing one card's
         measurements, not a measurement of several workers;
       * the real-world path: the real-world suite (37 graphs of 16
         architectures at 224×224) profiled into the float32 store (only
         new signatures measured); banks of all four families (lasso,
         rf, gbdt, MLP; `FAST_HPARAMS`) trained on the 32 training graphs,
         lasso's ISTA and the MLP on the card; `evaluate_bank` on the 8
         held-out and the real-world graphs (tree banks through the
         leaves kernel); e2e MAPE per family and set, reported; a lasso
         solve at a fixed α and the MLP's forward held against the port
         on the host (`LASSO_ALPHA`, `MLP_PREDICT_TOL`);
       * the search path: `SearchEngine` (`SEARCH_CONFIG`, the NAS
         example's search at 224) over one `LatencyService` on the card
         holding both GBDT banks, budgets 0.8 × the median training e2e:
         with the float32 budget, then with both; one `predict_batch` per
         setting per scoring round, the fused kernel launched; a rerun
         and a run checkpointed at generation 4 and resumed give the same
         front; the front measured on the card (`SearchReport.verify`);
       * the RPC path (`run_rpc_path`): a `LatencyRPCServer` on 127.0.0.1
         over one service on the card holding both GBDT banks
         (`BatchPolicy()`, `MonotonicClock`); 16 `LatencyClient` threads,
         half on each setting, send 64 fresh graphs at 224 each, one at a
         time, cold then warm: every request answered exactly once, each
         report within twice the fused kernel's bound of a direct
         `predict_batch` (`report_tolerances`), only ``cuda`` flushes, the
         warm pass answered from the cache with no flush and no launch; the
         cold pass under torch.profiler for the device-busy share.  A
         launch made to fail on the flush thread must come back as a typed
         ``internal`` error, and the search path's front is served per
         setting.  Then tests/test_autopilot.py's mid-flood rollover at full
         width: a float32 ``op_by_op`` source profiled by its seeded cost
         model (not the card's timings, whose noise the drift gate would
         read) with a GBDT bank trained on the card onboards a
         synthetic target, the autopilot behind the server recalibrates its
         drifted replay while 8 clients send 256 requests (all answered,
         epochs within the swap), the loop steps on until it has acted and
         stayed quiet (drift then below 1.0), and fresh graphs after the
         swap run the
         leaves kernel on a bank uploaded once.  Last, a seeded `FaultPlan`
         at the flush and dispatch sites against retrying clients: all 256
         answered, the injected tally equal to the plan's schedule, the
         retries equal to the faults the clients saw;
       * kernel selection: Alg. C.2 for Mali G76 rewrites the 40 graphs;
         those with a Winograd op are profiled on the float32 store (only
         the new ops are measured, through the Winograd kernel), then the
         paper's Fig. 8 study times the Winograd op against the direct
         ``conv2d`` op through ``GraphExecutor(op_by_op)``;
       * the LM serving path: Granite-MoE 1B at full width and 6 of 24
         layers (`LM_DEPTH`) from
         the port's own init (seed 0); forward/decode consistency first
         (`check_prefill_decode`, not counted), then `Model.forward` on
         4 × 1,024 tokens (6 flash and 18 GMM launches) and a 4-slot
         `ServeEngine` answering 8 requests of 16 new tokens (18 GMM
         launches per decode step), every one on the bfloat16 tensor-core
         route, its steps counted in an `Observability` registry
         (``serve_steps_total`` and the ``serve_step_duration`` count equal
         the engine's steps); then a forward and decode steps under torch.profiler for
         the time split, the flash and GMM shares and the idle share;
       * the SSM and hybrid path: Mamba2 2.7B, then Zamba2 1.2B, at full
         width and 4 of 64 and 8 of 38 layers (`SSM_DEPTH`) from the
         port's own init (seed 0), each with
         its counts zeroed: decode/forward consistency at 512 tokens
         first (float32 gated at `CONSISTENCY_TOL`, bfloat16 read; not
         counted), `Model.forward` on 2 × 4,096 tokens (4 ssd_scan
         launches for Mamba2; 8 and 1 flash launches for Zamba2) and a
         4-slot `ServeEngine` answering 8 (Mamba2) or 4 (Zamba2)
         requests; then each model's forward and one decode step under
         torch.profiler with the ssd_scan (and, for Zamba2, the flash)
         share of device time;
       * the LM zoo path (`run_lm_zoo_path`): gemma2-27b (4 of 46 layers),
         llama-3.2-vision-90b (5 of 100: 1 group, gates at `ZOO_GATE`)
         and whisper-large-v3 (8 of 32 encoder and 8 of 32 decoder layers)
         at full width from the port's
         own init, one after another, each printed with its ``reduced``
         depth and peak memory: the reduced model in float32 on the card
         against the host (`HOST_TOL`); decode against forward at 128
         tokens (and the reduced gemma2 at 160, past its window of 64);
         `Model.forward` (gemma2 1 × 6,144 tokens, the VLM 1 × 2,048 over
         1,600 vision embeddings, Whisper 2 × 1,500 frames and 2 × 448
         tokens) with 4 / 5 / 24 flash launches, all on the bfloat16
         tensor-core route; a 4-slot `ServeEngine` answering 8 requests
         (0 / 1 / 8 flash launches a decode step); then a profiled
         forward and decode step (device time, flash share, idle share);
       * the serving driver (`run_serve_driver_path`): `repro_torch.launch.
         serve.main` for granite-moe-1b-a400m at full size and
         `serve.serve` for whisper-large-v3 and the VLM at the zoo's cuts,
         with the reference driver's defaults (8 requests of 16 tokens,
         16 new, 4 slots), counts zeroed before each: 8 of 8 answered,
         the ``served`` line's tokens/s, launches a decode step gated
         (GMM 72 / flash 8 / flash 1), flash on the tensor-core route;
       * the LM training path (`run_lm_train_path`): granite-moe-1b-a400m
         at full width and depth (1.33 B parameters, float32 parameters
         and AdamW state, bfloat16 compute, remat) trained 8 steps on
         `SyntheticLMData(seed=0)` batches of 4 × 1,024 tokens: finite
         losses and grad norms, the last quarter's mean loss below the
         first step's, launches a step gated (flash forward 48, backward
         24, GMM 144 + 144, all on the tensor-core routes), no plain
         version called; step ms, tokens/s, peak memory and a profiled
         step (device busy, idle share, top kernels).  Then, the same way
         with the counts zeroed before each (`TRAIN_MODELS`),
         mamba2-2.7b and zamba2-1.2b at full width and 16 of 64 and 14
         of 38 layers (4 × 1,024 tokens: the scan 2 and its backward 1 a layer;
         Zamba2's shared block flash 4 and backward 2 a step) and
         gemma2-27b at full
         width and 2 of 46 layers (1 × 4,608 tokens, its window and
         softcaps: flash 4 and backward 2 a step), whisper-large-v3 at
         the zoo's depth (4 × 448 tokens over 4 × 1,500 frames: flash 48
         and backward 24 a step) and llama-3.2-vision-90b at full width and
         one self and one cross layer (2 × 2,048 tokens over 2 × 1,600
         vision embeddings, gates at `ZOO_GATE`: flash 4 and backward 2),
         each freed before the next.  Every one of these runs repeats:
         the model rebuilt from the same seed takes its first 3 steps
         again on the same batches, and the losses, grad norms and every
         parameter leaf's checksum must be bit-equal to the first run's
         (``repeat`` in its line).  Then Granite at 2 of 24 layers in
         float32: one train step
         on the card against the host (`HOST_TOL`, AdamW's
         noise-normalized elements excepted, `NOISE_SHARE`),
         microbatches=2 against the halves' mean gradient, two compressed
         steps, a checkpoint at step 2 restored bit for bit into a fresh
         state and continued beside the uninterrupted run; the same one
         step for the reduced VLM (gates 0.7) and Whisper, reduced Mamba2
         and the 5-layer Zamba2; and gradients
         through Winograd and the tree kernels, which must raise (they
         have no backward).
     After the multi-device path: the dry run (`run_dryrun_path`):
     qwen2-72b × decode_32k traced on fake CUDA tensors over a fake
     group of 256 ranks on the (16, 16) mesh through ``python -m
     repro_torch.launch.dryrun`` (its record and seconds printed), and
     Granite at full width and 12 of 24 layers on 16 × 1,024 tokens in
     16 microbatches traced in fake mode, both in child processes started
     once the kernels are built (`DryrunTraces`), then Granite run on
     the card (FLOPs and argument bytes equal, traced peak within 15% of
     ``max_memory_allocated``, loss finite); a ``step_prediction`` line
     for each of the two records (`step_prediction`: the analytic
     step-cost model of `repro_torch.launch.roofline` beside the traced
     counts, and for Granite its predicted step, which must not exceed the
     measured one) and the predictor twin
     ``examples/torch/predict_tpu_step.py``'s lines for qwen2-72b; and the
     examples (`run_examples_path`): ``examples/torch/quickstart.py``'s
     ``main`` on the card, cold, its tree-kernel launches gated.
  4. Times at the paths' shapes — kernel (with its launch plan for the
     int8 GEMM, Winograd and the tree kernels), plain version, library call where one exists (``torch._int_mm``, ``F.conv2d``,
     ``F.scaled_dot_product_attention``, ``torch.bmm``; none for the tree
     kernels and the SSD scan and its backward; SDPA's backward for the
     flash backward; ``torch.bmm`` for the GMM's two backward
     products) and the bound from
     bytes at 3.35 TB/s or operations (67 TFLOP/s float32, 989 TFLOP/s
     bfloat16 and 1,979 TOP/s int8 on the tensor cores); the GMM's decode
     shapes also with a cold L2 (weights rotated over 4 sets); for the tree
     kernels also the numpy host tier and a numpy-vs-kernel curve over
     2^10 … 2^22 slots.

The last two lines are the kernels' JSON record and
``{"ok": true, "device": {...}}``.  Without CUDA, or when run from a
directory that does not hold ``src/repro_torch``, it exits non-zero.
"""
from __future__ import annotations

import contextlib
import itertools
import json
import logging
import math
import os
import re
import subprocess
import sys
import tempfile
import threading
import time
import traceback
import weakref
from pathlib import Path
from typing import NamedTuple

ROOT = Path(__file__).resolve().parent
PEAK_BYTES_PER_S = 3.35e12          # H100 SXM HBM3
PEAK_F32_OPS_PER_S = 67e12          # H100 SXM float32, outside the tensor cores
PEAK_INT8_OPS_PER_S = 1979e12       # H100 SXM int8, dense tensor cores
PEAK_BF16_OPS_PER_S = 989e12        # H100 SXM bfloat16, dense tensor cores
U32 = 2.0 ** -24                    # float32 unit roundoff
N_FEATURES = 20
PARITY_ROWS = 32768
CSRC = "src/repro_torch/kernels/csrc/"
SOURCES = {"tree_gather_leaves": CSRC + "tree_gather.cu",
           "tree_predict_fused": CSRC + "tree_gather.cu",
           "int8_matmul": CSRC + "int8_matmul.cu",
           "winograd_conv2d": CSRC + "winograd_conv.cu",
           "flash_attention": CSRC + "flash_attention.cu",
           "flash_attention_backward": CSRC + "flash_attention_bwd.cu",
           "moe_gmm": CSRC + "moe_gmm.cu",
           "ssd_scan": CSRC + "ssd_scan.cu",
           "ssd_scan_backward": CSRC + "ssd_scan.cu",
           "ssd_intra": CSRC + "ssd_intra.cu",
           "ssd_intra_backward": CSRC + "ssd_intra.cu"}
REPLACES = {"tree_gather_leaves": "src/repro/kernels/tree_gather_pallas.py:57",
            "tree_predict_fused": "src/repro/kernels/tree_gather_pallas.py:57",
            "int8_matmul": "src/repro/kernels/int8_matmul.py:27",
            "winograd_conv2d": "src/repro/kernels/winograd_conv.py:58",
            "flash_attention": "src/repro/kernels/flash_attention.py:33",
            # No Pallas kernel: XLA's gradient of the reference's attention.
            "flash_attention_backward": "src/repro/models/attention.py:61",
            "moe_gmm": "src/repro/kernels/moe_gmm.py:25",
            "ssd_scan": "src/repro/kernels/ssd_scan.py:29",
            # No Pallas kernel: XLA's gradient of the reference's lax.scan.
            "ssd_scan_backward": "src/repro/models/ssm.py:114",
            # No Pallas kernel: the reference's intra-chunk einsums (and
            # XLA's gradient of them).
            "ssd_intra": "src/repro/models/ssm.py:90",
            "ssd_intra_backward": "src/repro/models/ssm.py:90"}
# The int8 executor's requantize multiplier (ACT·WEIGHT/ACT), the GEMMs' scale.
INT8_SCALE = 4.0 / 127.0 * (0.4 / 127.0) / (4.0 / 127.0)
# Winograd against its plain version: float32 summation order only;
# against a direct convolution: the transforms round at other places.
WINO_TOL = 1e-5                     # × max |plain|
DIRECT_TOL = 1e-4                   # × max |direct|
# The paper's Fig. 8 shapes at its 224 scale (bench_kernel_selection's
# ResNet convolutions) and the one NAS op Alg. C.2 selects for Mali.
STUDY_SHAPES = {"resnet_conv1_64x56": (64, 64, 56),
                "resnet_conv2_128x28": (128, 128, 28),
                "resnet_conv3_256x14": (256, 256, 14),
                "nas_79x77_56": (79, 77, 56)}


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


def bound(bytes_moved: float, ops: float,
          peak_ops: float = PEAK_F32_OPS_PER_S) -> tuple:
    """(ms, "bytes" | "operations"): the larger of the two floor times."""
    t_bytes = bytes_moved / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / peak_ops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def traffic(db, rows: int, d: int, fused: bool) -> tuple:
    """(bytes, operations) one launch needs: x read once, the output
    written once, the bank (and mean/std) read once, in the layout the
    launch reads (complete: `tree_gather_cuda.complete_bytes`; packed:
    16-byte nodes, 4-byte values and roots); one compare per slot and
    round, one add per slot, subtract + divide per feature."""
    from repro_torch.kernels import tree_gather_cuda as tgc

    slots = rows * db.n_trees
    bank = (tgc.complete_bytes(db.n_trees, db.depth) if db.cnodes is not None
            else db.n_nodes * 20 + db.n_trees * 4)
    nbytes = rows * d * 4 + bank
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
    return [("gbdt_150x4", gbdt, "staged"), ("rf_10x14", rf, "packed")]


def check_parity(name: str, model, route: str, device, rows: int = PARITY_ROWS,
                 seed: int = 1) -> dict:
    """Both kernels vs their plain versions on one bank, every launch on
    ``route``; raises on mismatch."""
    import numpy as np
    import torch
    from repro_torch.kernels import tree_gather as tg
    from repro_torch.kernels import tree_gather_cuda as tgc

    rng = np.random.default_rng(seed)
    raw = np.abs(rng.standard_normal((rows, N_FEATURES))) * np.linspace(1, 50, N_FEATURES)
    db = model.flat().device_bank(device)
    plans = {k: tgc.plan_for(db, rows, N_FEATURES, fused=k == "fused")
             for k in ("leaves", "fused")}
    if {p.route for p in plans.values()} != {route}:
        raise AssertionError(f"{name}: bank of {db.n_trees} trees of depth "
                             f"{db.depth} expected on the {route} route: {plans}")
    xs = torch.from_numpy(model.scaler.transform(raw).astype(np.float32)).to(db.device)
    xr = torch.from_numpy(raw.astype(np.float32)).to(db.device)
    mean, std = tg.to_device_scaler(model.scaler, db.device)
    kind, scale, bias = model._device_reduction()

    before, routes0 = tgc.launch_counts(), tgc.route_counts()
    leaves_k = tgc.gather_leaves_cuda(db, xs)
    fused_k = tgc.fused_predict_cuda(db, mean, std, scale, bias, xr, kind)
    fused_k2 = tgc.fused_predict_cuda(db, mean, std, scale, bias, xr, kind)
    torch.cuda.synchronize()
    after, routes1 = tgc.launch_counts(), tgc.route_counts()
    if after["tree_gather_leaves"] - before["tree_gather_leaves"] != 1 or \
            after["tree_predict_fused"] - before["tree_predict_fused"] != 2:
        raise AssertionError(f"{name}: launch counters did not advance: {before} → {after}")
    routes = {k: routes1[k] - routes0[k] for k in routes1}
    if routes[route] != 3 or sum(routes.values()) != 3:
        raise AssertionError(f"{name}: launches by route {routes}, all 3 expected on {route}")

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
           "depth": db.depth, "route": route,
           "threads_a_row": {k: p.groups for k, p in plans.items()},
           "routes": routes, "rows": rows, "leaves_bit_equal": True,
           "fused_max_abs_err": float(err.max()),
           "fused_max_err_over_bound": float((err / tol).max())}
    log("parity " + json.dumps(res))
    return res


def gemm_shapes(graph) -> list:
    """(op, m, k, n, patches) of every int8 GEMM call one forward pass of
    ``graph`` makes: each fully_connected and each convolution with one
    group (an im2col'd k×k convolution has k = kh·kw·C; a depthwise
    convolution has as many groups as input channels).  ``patches``: A is
    gathered by the executor's im2col into rows aligned to 16 bytes (a
    k×k or strided convolution), else A is the contiguous input."""
    out = []
    for node in graph.nodes:
        p = node.params_dict
        x = graph.tensor(node.inputs[0]).shape
        y = graph.tensor(node.outputs[0]).shape
        groups = x[-1] if node.op_type == "dwconv2d" else p.get("groups", 1)
        if node.op_type == "fully_connected":
            out.append((node.op_type, int(math.prod(x[:-1])), x[-1], y[-1], False))
        elif node.op_type in ("conv2d", "grouped_conv2d", "winograd_conv2d",
                              "dwconv2d") and groups == 1:
            kk = p.get("kernel_h", 1) * p.get("kernel_w", 1)
            out.append((node.op_type, y[0] * y[1] * y[2], kk * x[-1], y[-1],
                        kk > 1 or p.get("stride", 1) > 1))
    return out


def _int8_operands(m, k, n, device, seed, patches=False):
    """A, the (k, n) weight, its packed form and an int32 bias.  With
    ``patches`` A is an (m, k) view of an (m, k rounded up to 16) buffer,
    as the executor's im2col gives it."""
    import numpy as np
    import torch
    from repro_torch.kernels import int8_matmul as im

    rng = np.random.default_rng(seed)
    a = torch.from_numpy(rng.integers(-127, 128, (m, k)).astype(np.int8)).to(device)
    b = torch.from_numpy(rng.integers(-127, 128, (k, n)).astype(np.int8)).to(device)
    bias = torch.from_numpy(rng.integers(-4096, 4096, n).astype(np.int32)).to(device)
    if patches:                      # pad bytes set, as they are never read as values
        buf = torch.full((m, -(-k // 16) * 16), 7, dtype=torch.int8, device=device)
        buf[:, :k] = a
        a = buf[:, :k]
    return a, b, im.pack_weight(b), bias


def int8_route(m, k, n, a) -> str:
    """The int8 GEMM's plan and A route for these operands, as a label."""
    from repro_torch.kernels import int8_matmul_cuda as imc

    pl = imc.plan(m, n, k)
    return f"{pl.bm}x{pl.bn} split {pl.splits} ({pl.blocks} blocks) {imc.a_route(a)}"


def _int8_bound(m, k, n) -> tuple:
    return bound(m * k + k * n + 4 * n + 4 * m * n, 2 * m * n * k, PEAK_INT8_OPS_PER_S)


def _int_mm_operands(a, b, device) -> tuple:
    """``torch._int_mm``'s operands for A·B: zero-padded to multiples of 32,
    the second column-major (cuBLASLt refuses many other shapes)."""
    import torch

    (m, k), n = a.shape, b.shape[1]
    mp, kp, n_p = (-(-x // 32) * 32 for x in (m, k, n))
    ap = torch.zeros((mp, kp), dtype=torch.int8, device=device)
    bp = torch.zeros((n_p, kp), dtype=torch.int8, device=device)
    ap[:m, :k] = a
    bp[:n, :k] = b.t()
    return ap, bp.t(), [mp, kp, n_p]


# The int8 GEMM's split-k route at the int8 path's FC and its slowest
# convolution, and that convolution's patches with a padded row stride.
SPLIT_K_SHAPES = {"split_k_fc": (1, 1580, 1000), "split_k_conv": (784, 441, 38)}


def check_int8_gemm(graphs, device) -> dict:
    """int8 GEMM vs its plain version, bit for bit, at m = 1, at the main
    path's largest FC, 1×1 and k×k shapes, at ragged shapes, on the
    split-k route and with A row-strided as the executor's im2col gives
    it; the split-k and strided cases also against a second call."""
    import torch
    from repro_torch.kernels import int8_matmul as im
    from repro_torch.kernels import int8_matmul_cuda as imc

    shapes = {s[:4] for g in graphs for s in gemm_shapes(g)}
    fc = [s for s in shapes if s[0] == "fully_connected"]
    conv = [s for s in shapes if s[0] != "fully_connected"]
    pick = {"largest_fc": max(fc, key=lambda s: s[2] * s[3]),
            "largest_conv": max(conv, key=lambda s: s[1] * s[2] * s[3]),
            "largest_m": max(conv, key=lambda s: (s[1], s[2] * s[3])),
            "largest_k": max(conv, key=lambda s: (s[2], s[1])),
            "m1": (None, 1, 63, 252), "ragged_a": (None, 130, 27, 77),
            "ragged_b": (None, 7, 1477, 13), "ragged_c": (None, 4099, 131, 65)}
    pick.update({label: (None, *mkn) for label, mkn in SPLIT_K_SHAPES.items()})
    pick["padded_lda"] = (None, *SPLIT_K_SHAPES["split_k_conv"])
    scale = im.out_scale(INT8_SCALE, 1.0)
    rows = []
    for i, (label, (_, m, k, n)) in enumerate(sorted(pick.items())):
        a, _, bt, bias = _int8_operands(m, k, n, device, seed=i,
                                        patches=label == "padded_lda")
        before = imc.launch_counts()["int8_matmul"]
        routes = imc.route_counts()
        got = imc.int8_matmul_cuda(a, bt, scale, bias)
        got0 = imc.int8_matmul_cuda(a, bt, scale)
        again = imc.int8_matmul_cuda(a, bt, scale, bias)
        torch.cuda.synchronize()
        if imc.launch_counts()["int8_matmul"] != before + 3:
            raise AssertionError("int8_matmul launch counter did not advance")
        route = {"split_k_fc": "split_k", "split_k_conv": "split_k",
                 "padded_lda": "a_cp_async"}.get(label)
        if route and imc.route_counts()[route] != routes[route] + 3:
            raise AssertionError(f"int8 GEMM {label}: the {route} route was not taken")
        for out, b_ in ((got, bias), (got0, None)):
            want = im.int8_matmul_plain(a, bt, scale, b_)
            if not torch.equal(out, want):
                n_bad = int((out != want).sum())
                raise AssertionError(f"int8 GEMM {label} (m={m}, k={k}, n={n}): "
                                     f"{n_bad} outputs differ from the plain version")
        if not torch.equal(got, again):
            raise AssertionError(f"int8 GEMM {label}: a second call differs")
        rows.append({"shape": label, "m": m, "k": k, "n": n, "bit_equal": True,
                     "route": int8_route(m, k, n, a)})
    log("parity int8_matmul " + json.dumps(rows))
    return {"shapes": rows, "max_abs_err": 0.0}


def check_winograd(device) -> dict:
    """Winograd kernel vs its plain version (within WINO_TOL) and the whole
    op vs F.conv2d with TF32 off (within DIRECT_TOL)."""
    import numpy as np
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels import winograd_conv as wc
    from repro_torch.kernels import winograd_conv_cuda as wcc

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    shapes = [(1, hw, hw, ci, co) for ci, co, hw in STUDY_SHAPES.values()]
    shapes += [(1, 55, 57, 16, 24), (2, 7, 9, 8, 5), (1, 1, 1, 3, 2)]
    rows, worst = [], 0.0
    for i, (b, h, w, c, k) in enumerate(shapes):
        rng = np.random.default_rng(100 + i)
        x = torch.from_numpy(rng.standard_normal((b, h, w, c)).astype(np.float32)).to(device)
        wt = torch.from_numpy((rng.standard_normal((3, 3, c, k)) * 0.1)
                              .astype(np.float32)).to(device)
        u = wc.transform_weights(wt)
        tiles = ref.extract_winograd_tiles(x).reshape(-1, 16, c).contiguous()
        got = wcc.winograd_tiles_cuda(tiles, u)
        plain = wc.winograd_tiles_plain(tiles, u)
        y = wc.winograd_conv2d(x, u)
        direct = ref.winograd_conv_ref(x, wt)
        torch.cuda.synchronize()
        err = float((got - plain).abs().max())
        rel = err / float(plain.abs().max())
        rel_direct = float((y - direct).abs().max()) / float(direct.abs().max())
        if not rel <= WINO_TOL:
            raise AssertionError(f"Winograd {(b, h, w, c, k)}: {rel} × max off "
                                 f"its plain version (> {WINO_TOL})")
        if not rel_direct <= DIRECT_TOL:
            raise AssertionError(f"Winograd {(b, h, w, c, k)}: {rel_direct} × max "
                                 f"off F.conv2d (> {DIRECT_TOL})")
        if not torch.equal(got, wcc.winograd_tiles_cuda(tiles, u)):
            raise AssertionError("Winograd kernel is not repeatable")
        worst = max(worst, err)
        rows.append({"shape": [b, h, w, c, k], "max_abs_err": err,
                     "err_over_max": rel, "vs_conv2d_over_max": rel_direct})
    log("parity winograd_conv2d " + json.dumps(rows))
    return {"shapes": rows, "max_abs_err": worst}


def check_int8_round_trips(device) -> dict:
    """Each unary float round trip on all 256 int8 values, card vs host:
    the number of values that differ, per kind.  Only transcendental kinds
    may differ, and by one step."""
    import torch
    from repro_torch.quant import int8 as q8

    q = torch.arange(-128, 128, dtype=torch.int32).to(torch.int8)
    diffs = {}
    for kind in sorted(q8._FLOAT_UNARY):
        d = (q8._lut_roundtrip(q.to(device), kind).cpu().int()
             - q8._lut_roundtrip(q, kind).int()).abs()
        diffs[kind] = int((d > 0).sum())
        if d.max() > (1 if kind in q8.TRANSCENDENTAL else 0):
            raise AssertionError(f"int8 {kind} round trip: card and host differ "
                                 f"by {int(d.max())} steps")
    log("parity int8_round_trips_values_differing " + json.dumps(diffs))
    return diffs


def check_int8_executor(graphs, device, lut_diffs: dict) -> dict:
    """The int8 executor, card against host port, on whole graphs: equal,
    unless the graph uses a kind whose round trip differs on the card.
    The GEMM launches once per dense op."""
    import torch
    from repro_torch.core.executor import GraphExecutor
    from repro_torch.kernels import int8_matmul_cuda as imc

    rows = []
    for g in graphs:
        kinds = {n.params_dict.get(k) for n in g.nodes for k in ("act", "ew_kind")}
        kinds |= {f.split("@")[0] for n in g.nodes for f in n.fused}
        loose = sorted(k for k in kinds if lut_diffs.get(k))
        dev = GraphExecutor(g, "op_by_op", dtype="int8", device=device)
        host = GraphExecutor(g, "op_by_op", dtype="int8", device="cpu")
        imc.reset_launch_counts()
        got = dev(*dev.example_inputs())
        torch.cuda.synchronize()
        launches = imc.launch_counts()["int8_matmul"]
        if launches != len(gemm_shapes(g)):
            raise AssertionError(f"{g.name}: {launches} GEMM launches for "
                                 f"{len(gemm_shapes(g))} dense ops")
        want = host(*host.example_inputs())
        n_diff, max_diff = 0, 0
        for a, b in zip(got, want):
            if a.dtype != torch.int8 or a.shape != b.shape:
                raise AssertionError(f"{g.name}: int8 output {a.dtype} {tuple(a.shape)}")
            d = (a.cpu().int() - b.int()).abs()
            n_diff += int((d > 0).sum())
            max_diff = max(max_diff, int(d.max()))
        if n_diff and not loose:
            raise AssertionError(f"{g.name}: {n_diff} int8 outputs differ card vs host")
        rows.append({"graph": g.name, "ops": len(g.nodes), "gemm_launches": launches,
                     "outputs_differing": n_diff, "max_step_diff": max_diff,
                     "kinds_differing_on_card": loose})
    log("parity int8_executor " + json.dumps(rows))
    return {"graphs": rows}


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


def kernel_modules():
    from repro_torch.kernels import (flash_attention_cuda, int8_matmul_cuda,
                                     moe_gmm_cuda, ssd_intra_cuda, ssd_scan_cuda,
                                     tree_gather_cuda, winograd_conv_cuda)

    return (tree_gather_cuda, int8_matmul_cuda, winograd_conv_cuda,
            flash_attention_cuda, moe_gmm_cuda, ssd_scan_cuda, ssd_intra_cuda)


def reset_counts() -> None:
    for m in kernel_modules():
        m.reset_launch_counts()


def read_counts() -> dict:
    out = {}
    for m in kernel_modules():
        out.update(m.launch_counts())
    return out


def read_routes() -> dict:
    """Launches by route since the counts were last zeroed: both tree
    kernels together by bank route (``staged``, ``packed``); flash (forward
    and backward) and the GMM by kernel (bfloat16 tensor cores, float32
    CUDA cores); the int8 GEMM by k route and by A route (each launch
    counts in both); Winograd by block tile."""
    from repro_torch.kernels import (flash_attention_cuda, int8_matmul_cuda,
                                     moe_gmm_cuda, tree_gather_cuda,
                                     winograd_conv_cuda)

    return {"tree_gather": tree_gather_cuda.route_counts(),
            "flash_attention": flash_attention_cuda.route_counts(),
            "flash_attention_backward": flash_attention_cuda.bwd_route_counts(),
            "moe_gmm": moe_gmm_cuda.route_counts(),
            "int8_matmul": int8_matmul_cuda.route_counts(),
            "winograd_conv2d": winograd_conv_cuda.route_counts()}


def run_main_path(device, setting, graphs, pop, pop2, n_train: int = 32) -> dict:
    """Profile → train → serve through the port's entry points, every
    launch count zeroed just before and read just after."""
    import numpy as np
    from repro_torch.core.composition import PredictorBank, mape
    from repro_torch.core.predictors.flat import device_tier
    from repro_torch.core.profiler import ProfileSession
    from repro_torch.pipeline import LatencyService, PredictorHub, ProfileStore

    train, held = graphs[:n_train], graphs[n_train:]

    reset_counts()
    store = ProfileStore()
    session = ProfileSession(store=store, device=device)
    t0 = time.perf_counter()
    session.profile_suite(graphs, setting)
    profile_s = time.perf_counter() - t0
    profile_counts = read_counts()
    profile_routes = read_routes()

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

    launches0 = read_counts()
    t0 = time.perf_counter()
    reports = svc.predict_batch(pop)
    batch_s = time.perf_counter() - t0
    launches1 = read_counts()
    hit = svc.predict_e2e(pop[0])
    t0 = time.perf_counter()
    reports2 = svc.predict_batch(pop2)
    batch2_s = time.perf_counter() - t0
    counts = read_counts()
    tree_routes = read_routes()["tree_gather"]
    stats = svc.stats()

    # What came out, and how it was served.
    for rs, n in ((reports, len(pop)), (reports2, len(pop2))):
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
    if sum(tree_routes.values()) != counts["tree_gather_leaves"] + \
            counts["tree_predict_fused"]:
        raise AssertionError(f"tree launches by route {tree_routes} do not add up "
                             f"to the launches {counts}")
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

    out = {"setting": f"{setting.name} ({setting.dtype}/{setting.mode})",
           "profile_s": profile_s, "train_s": train_s,
           "measured_ops": session.measured_ops, "graphs": len(graphs),
           "op_types": sorted(bank.predictors), "e2e_mape_held_out": e2e_mape,
           "per_op_mape_held_out": op_mape,
           "predict_batch_1024_s": batch_s, "predict_batch_256_s": batch2_s,
           "launches_per_predict_batch_1024": {
               k: launches1[k] - launches0[k] for k in launches1},
           "launches_while_profiling": profile_counts,
           "routes_while_profiling": {k: profile_routes[k]
                                      for k in ("int8_matmul", "winograd_conv2d")},
           "launches": counts, "tree_routes": tree_routes, "backend_runs": runs,
           "device_fused_runs": stats["device_fused_runs"],
           "bank_uploads": res["bank_uploads"], "banks": res["banks"],
           "held_out_rel_diff_vs_host_torch": rel}
    log("main_path " + json.dumps(out))
    return {"summary": out, "bank": bank, "held": held, "store": store}


def cold_featurize_s(graphs) -> float:
    """The host's share of a cold predict_batch: fingerprint, fuse and
    featurize graphs the process has not seen."""
    from repro_torch.core.features import graph_features
    from repro_torch.core.fusion import fuse_graph

    t0 = time.perf_counter()
    for g in graphs:
        g.fingerprint()
        graph_features(fuse_graph(g)[1])
    return time.perf_counter() - t0


def _conv_graph(c_in, c_out, hw, winograd=False):
    """One 3×3 stride-1 convolution (bench_kernel_selection's graph)."""
    from repro_torch.core.ir import OpGraph

    g = OpGraph("sel")
    x0 = g.add_input((1, hw, hw, c_in))
    (c1,) = g.add_op("winograd_conv2d" if winograd else "conv2d", [x0],
                     [(1, hw, hw, c_out)],
                     {"kernel_h": 3, "kernel_w": 3, "stride": 1, "groups": 1})
    g.mark_output(c1)
    return g


def run_selection_path(device, setting, graphs, store) -> dict:
    """Alg. C.2 (Mali G76) over the main path's graphs; the graphs it
    gives a Winograd op are profiled on the float32 store, then the Fig. 8
    study times Winograd against the direct conv op."""
    from repro_torch.core.executor import GraphExecutor
    from repro_torch.core.fusion import fuse_graph
    from repro_torch.core.ir import op_signature
    from repro_torch.core.profiler import ProfileSession
    from repro_torch.core.selection import apply_selection, check_winograd, get_device
    from repro_torch.utils.timing import time_callable

    mali = get_device("mali_g76")
    selected = [apply_selection(g, mali) for g in graphs]
    wino = [g for g in selected
            if any(n.op_type == "winograd_conv2d" for n in g.nodes)]
    if not wino:
        raise AssertionError("Alg. C.2 selected no Winograd op")
    execs = [fuse_graph(g)[1] for g in wino]
    new_sigs = {op_signature(e, n) for e in execs for n in e.nodes
                if n.op_type == "winograd_conv2d"}
    reset_counts()
    session = ProfileSession(store=store, device=device)
    t0 = time.perf_counter()
    recs = session.profile_suite(wino, setting)
    profile_s = time.perf_counter() - t0
    counts = read_counts()
    routes = read_routes()["winograd_conv2d"]
    if counts["winograd_conv2d"] == 0:
        raise AssertionError("the Winograd kernel was never launched")
    if sum(routes.values()) != counts["winograd_conv2d"]:
        raise AssertionError(f"Winograd routes {routes} for {counts['winograd_conv2d']} calls")
    wino_ms = [o.latency_s * 1e3 for r in recs for o in r.ops
               if o.op_type == "winograd_conv2d"]
    if not all(math.isfinite(v) and v > 0 for v in wino_ms):
        raise AssertionError(f"bad Winograd op latencies {wino_ms}")

    study = []
    for name, (c_in, c_out, hw) in STUDY_SHAPES.items():
        row = {"name": name}
        for kind, wg in (("winograd_us", True), ("conv2d_us", False)):
            ex = GraphExecutor(_conv_graph(c_in, c_out, hw, wg), "op_by_op",
                               device=device)
            row[kind] = 1e6 * time_callable(
                lambda *a: ex(*a, sync_per_op=True), ex.example_inputs(),
                warmup=2, inner=8, repeats=3)
        g = _conv_graph(c_in, c_out, hw)
        row["direct_over_winograd"] = row["conv2d_us"] / row["winograd_us"]
        row["select_mali"] = check_winograd(mali, g.nodes[0], g)
        row["select_adreno"] = check_winograd(get_device("adreno640"),
                                              g.nodes[0], g)
        study.append(row)
        log("fig8 " + json.dumps(row))
    out = {"graphs_with_winograd": len(wino), "winograd_signatures": len(new_sigs),
           "measured_ops": session.measured_ops, "profile_s": profile_s,
           "winograd_op_ms": wino_ms, "launches": counts, "winograd_routes": routes}
    if session.measured_ops > len(new_sigs):
        raise AssertionError(f"profiled {session.measured_ops} ops; only the "
                             f"{len(new_sigs)} Winograd ops were new")
    log("selection_path " + json.dumps(out))
    return {"summary": out, "study": study, "graphs": wino}


# -- the real-world path and the search path ---------------------------------------

FAMILIES = ("lasso", "rf", "gbdt", "mlp")
# Card against host, at the CPU tests' tolerances (tests/test_torch_predictors.py):
# the lasso solve at a fixed α within one float32 rounding of the iterate's
# scale a step; the MLP forward within MLP_PREDICT_TOL × max |prediction|.
LASSO_ALPHA = 1e-3
MLP_PREDICT_TOL = 1e-5
# The NAS example's search (examples/nas_latency_search.py) at the paper's
# resolution; budgets 0.8 × the median measured e2e of each setting's
# training graphs, as that example sets them.
SEARCH_CONFIG = dict(population_size=32, generations=8, children_per_gen=24,
                     seed=0, quality="flops", front_capacity=6, resolution=224)
BUDGET_FRACTION = 0.8
CHECKPOINT_GEN = 4


def _dataset(store, setting, graphs):
    from repro_torch.core.dataset import LatencyDataset
    from repro_torch.pipeline import setting_key

    return LatencyDataset(setting_key(setting), store.arch_records(
        setting, fingerprints=[g.fingerprint() for g in graphs]))


def check_lasso_and_mlp_on_host(mlp_bank, ds, device) -> dict:
    """The largest op type's training table: a lasso solve at a fixed α
    and the trained MLP's forward, card against the port on the host."""
    import numpy as np
    from repro_torch.core.predictors import LassoPredictor, load_predictor

    tables = ds.op_tables()
    op_type = max(tables, key=lambda t: len(tables[t][1]))
    x, y = tables[op_type]
    card = LassoPredictor(alpha=LASSO_ALPHA, device=device).fit(x, y)
    host = LassoPredictor(alpha=LASSO_ALPHA, device="cpu").fit(x, y)
    lasso_err = float(np.abs(card.w - host.w).max())
    lasso_tol = card.iters * U32 * max(1.0, float(np.abs(host.w).max()))
    if card.fit_device.type != device.type or not lasso_err <= lasso_tol:
        raise AssertionError(f"lasso on {card.fit_device} vs host: {lasso_err} "
                             f"> {lasso_tol}")
    mlp = mlp_bank.predictors[op_type]
    got = mlp.predict(x)
    want = load_predictor(mlp.to_json(), device="cpu").predict(x)
    mlp_err = float(np.abs(got - want).max())
    mlp_tol = MLP_PREDICT_TOL * float(np.abs(want).max())
    if not mlp_err <= mlp_tol:
        raise AssertionError(f"MLP forward on {mlp.device} vs host: {mlp_err} > {mlp_tol}")
    return {"op_type": op_type, "rows": len(y), "lasso_max_abs_err": lasso_err,
            "lasso_tol": lasso_tol, "mlp_max_abs_err": mlp_err, "mlp_tol": mlp_tol}


def run_realworld_path(device, setting, graphs, store, n_train: int = 32,
                       resolution: int = 224) -> dict:
    """Profile the real-world suite into the float32 store, train all four
    families on the main path's 32 training graphs, and score the held-out
    synthetic graphs and the real-world graphs with `evaluate_bank` (tree
    banks through the leaves kernel, the MLP on the card)."""
    import numpy as np
    from repro_torch.core.dataset import evaluate_bank, realworld_graphs
    from repro_torch.core.fusion import fuse_graph
    from repro_torch.core.ir import op_signature
    from repro_torch.core.predictors.flat import device_tier
    from repro_torch.core.profiler import ProfileSession
    from repro_torch.core.realworld import REALWORLD
    from repro_torch.pipeline import PredictorHub

    rw = realworld_graphs(resolution=resolution)
    train, held = graphs[:n_train], graphs[n_train:]
    sigs = {op_signature(e, n) for e in (fuse_graph(g)[1] for g in rw) for n in e.nodes}
    new_sigs = {sg for sg in sigs if store.get_op(setting, sg) is None}
    reset_counts()
    session = ProfileSession(store=store, device=device)
    t0 = time.perf_counter()
    session.profile_suite(rw, setting)
    profile_s = time.perf_counter() - t0
    if session.measured_ops > len(new_sigs):
        raise AssertionError(f"profiled {session.measured_ops} ops; only "
                             f"{len(new_sigs)} real-world signatures were new")

    hub = PredictorHub(device=device)
    banks, train_s = {}, {}
    for family in FAMILIES:
        t0 = time.perf_counter()
        banks[family] = hub.train(store, setting, family,
                                  fingerprints=[g.fingerprint() for g in train])
        train_s[family] = time.perf_counter() - t0
    op_types = sorted(banks["gbdt"].predictors)
    for family, bank in banks.items():
        if sorted(bank.predictors) != op_types:
            raise AssertionError(f"{family} bank covers {sorted(bank.predictors)}, "
                                 f"gbdt {op_types}")
    fit_devices = {f: sorted({str(m.fit_device) for m in banks[f].predictors.values()})
                   for f in ("lasso", "mlp")}
    for family, devs in fit_devices.items():
        if {d.split(":")[0] for d in devs} != {device.type}:
            raise AssertionError(f"{family} trained on {devs}, not {device.type}")
    for t, m in banks["lasso"].predictors.items():
        if (m.feature_weights < 0).any():
            raise AssertionError(f"negative lasso feature weight for {t}")

    sets = {"held_out": _dataset(store, setting, held),
            "realworld": _dataset(store, setting, rw)}
    if len(sets["realworld"].archs) != len(rw):
        raise AssertionError("a real-world graph has no arch record")
    tier = device_tier(device)
    per_type = per_type_matrices(held + rw, op_types, f32=False)
    reports, launches = {}, {}
    for family, bank in banks.items():
        trees = [m for m in bank.predictors.values() if m.tree_model() is not None]
        for m in trees:
            m.inference_backend = tier
        reset_counts()
        for name, ds in sets.items():
            rep = evaluate_bank(ds, bank, list(range(len(ds.archs))))
            if not np.isfinite(rep["y_pred"]).all():
                raise AssertionError(f"{family}: non-finite e2e prediction on {name}")
            reports[(family, name)] = rep
        for t, x in per_type.items():
            p = bank.predictors[t].predict(x)
            if not (np.isfinite(p).all() and (p >= 0).all()):
                raise AssertionError(f"{family}/{t}: prediction not finite and >= 0")
        launches[family] = read_counts()
        for m in trees:
            m.inference_backend = "numpy"
        if trees and launches[family]["tree_gather_leaves"] == 0:
            raise AssertionError(f"{family}: the leaves kernel was never launched")
    on_host = check_lasso_and_mlp_on_host(banks["mlp"], _dataset(store, setting, train),
                                          device)

    per_family = {}
    for family in FAMILIES:
        row = {"train_s": train_s[family],
               "e2e_mape_held_out": reports[(family, "held_out")]["e2e_mape"],
               "e2e_mape_realworld": reports[(family, "realworld")]["e2e_mape"],
               "leaves_launches": launches[family]["tree_gather_leaves"]}
        if family in fit_devices:
            row["fit_device"] = fit_devices[family]
        per_family[family] = row
        log(f"realworld_family {family} " + json.dumps(row))
    out = {"graphs": len(rw), "architectures": len(REALWORLD.names()),
           "new_signatures": len(new_sigs), "measured_ops": session.measured_ops,
           "profile_s": profile_s, "op_types": op_types, "per_family": per_family,
           "card_vs_host": on_host}
    log("realworld_path " + json.dumps(out))
    return {"summary": out, "banks": banks}


@contextlib.contextmanager
def timed_calls(module, *names):
    """Seconds spent in ``module``'s functions ``names`` while the block
    runs, from any thread (each one patched for the block)."""
    spent, lock = [0.0], threading.Lock()
    originals = {n: getattr(module, n) for n in names}

    def timed(fn):
        def call(*a, **k):
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                with lock:
                    spent[0] += time.perf_counter() - t0
        return call

    for n, fn in originals.items():
        setattr(module, n, timed(fn))
    try:
        yield spent
    finally:
        for n, fn in originals.items():
            setattr(module, n, fn)


def timed_featurization():
    """Seconds `predict_batch` spends fusing and featurizing graphs on the
    host (the service module's two calls, timed while the block runs)."""
    from repro_torch.pipeline import service

    return timed_calls(service, "fuse_graph", "graph_features")


def run_search_path(device, settings: dict, graphs, n_train: int = 32) -> dict:
    """`SearchEngine` over one `LatencyService` on the card holding the
    float32 and int8 GBDT banks of the main paths: with the float32
    budget, then with both; a rerun and a checkpoint/resume of the second;
    the front verified by measurement on the card."""
    import numpy as np
    from repro_torch.core.profiler import ProfileSession
    from repro_torch.pipeline import LatencyService, PredictorHub
    from repro_torch.search import DeviceBudget, SearchConfig, SearchEngine

    hub = PredictorHub(device=device)
    budgets = []
    for setting, (bank, store) in settings.items():
        hub.register(setting, "gbdt", bank)
        e2e = [store.get_arch(setting, g.fingerprint()).e2e_s for g in graphs[:n_train]]
        budgets.append(DeviceBudget(setting, BUDGET_FRACTION * float(np.median(e2e))))
    primary = budgets[0].setting
    cfg = SearchConfig(**SEARCH_CONFIG)

    def service():
        return LatencyService(hub, default_setting=primary, predictor="gbdt",
                              device=device)

    def search(bs, svc, label):
        reset_counts()
        with timed_featurization() as spent:
            rep = SearchEngine(svc, bs, cfg).run()
        counts = read_counts()
        rounds = sum(1 for st in rep.stats if st.new_scored > 0)
        promised = rounds * len(bs)
        stats = svc.stats()
        if not rep.predict_batch_calls == svc.predict_batch_calls == promised:
            raise AssertionError(
                f"{label}: predict_batch calls {rep.predict_batch_calls} (report), "
                f"{svc.predict_batch_calls} (service); promised {rounds} rounds × "
                f"{len(bs)} settings = {promised}")
        if counts["tree_predict_fused"] == 0:
            raise AssertionError(f"{label}: the fused kernel was never launched")
        if counts["tree_predict_fused"] != stats["device_fused_runs"]:
            raise AssertionError(f"{label}: fused launches {counts['tree_predict_fused']}"
                                 f" != fused runs {stats['device_fused_runs']}")
        if not rep.front:
            raise AssertionError(f"{label}: empty front")
        row = {"budgets_s": {b.key: b.budget_s for b in bs},
               "generations": rep.generations, "wall_s": rep.wall_time_s,
               "s_per_generation": rep.wall_time_s / rep.generations,
               "candidates_scored": rep.candidates_scored,
               "scoring_rounds": rounds, "predict_batch_calls": rep.predict_batch_calls,
               "fused_launches": counts["tree_predict_fused"],
               "fused_launches_per_round_and_setting": counts["tree_predict_fused"]
               / promised,
               "backend_runs": stats["backend_runs"],
               "featurize_s": spent[0], "featurize_share": spent[0] / rep.wall_time_s,
               "front_size": len(rep.front)}
        log(f"search {label} " + json.dumps(row))
        return rep, row

    f32_rep, f32_row = search(budgets[:1], service(), "f32")
    both_rep, both_row = search(budgets, service(), "both")
    again, _ = search(budgets, service(), "rerun")
    if again.front_json() != both_rep.front_json():
        raise AssertionError("a rerun of the search gave another front")
    svc = service()
    eng = SearchEngine(svc, budgets, cfg)
    for _ in range(CHECKPOINT_GEN):
        eng.step()
    with tempfile.TemporaryDirectory() as tmp:
        path = eng.save(os.path.join(tmp, "search.json"))
        resumed = SearchEngine.load(path, svc).run()
    if resumed.front_json() != both_rep.front_json():
        raise AssertionError("a search resumed at generation "
                             f"{CHECKPOINT_GEN} gave another front")

    session = ProfileSession(device=device)
    t0 = time.perf_counter()
    verified = both_rep.verify(session, primary)
    verify_s = time.perf_counter() - t0
    if not verified["n_verified"] == len(both_rep.front) == session.measured_graphs:
        raise AssertionError(f"verified {verified['n_verified']} of "
                             f"{len(both_rep.front)} front members, measured "
                             f"{session.measured_graphs} graphs")
    out = {"f32": f32_row, "both": both_row, "rerun_equal": True,
           "resumed_at": CHECKPOINT_GEN, "resume_equal": True,
           "verify": {"setting": verified["setting"], "n_verified": verified["n_verified"],
                      "mape": verified["mape"], "seconds": verify_s,
                      "rows": verified["rows"]}}
    log("search_path " + json.dumps(out))
    return {"summary": out, "report": both_rep, "budgets": budgets}


# -- the transfer path (a second device setting from K measurements) -------------

TRANSFER_BUDGETS = (16, 64)
SCORER_GRAPHS = 64


def run_transfer_path(device, target, graphs, oracle, n_train: int = 32,
                      resolution: int = 224) -> dict:
    """Onboard ``target`` (the int8 ``op_by_op`` setting, treated as a new
    device) from K measurements on the card and serve it.

    The source is a float32 ``op_by_op`` setting, profiled on the card into
    a store of its own (its signatures are those of the unfused graph, the
    int8 target's too) with a GBDT bank on the training graphs.  For each K
    of `TRANSFER_BUDGETS`, `TransferEngine` samples K source ops, measures
    them on the card through a fresh `ProfileSession` with an empty store
    (the int8 GEMM runs) located in the training graphs (``probe_graphs``;
    the engine samples from a store of their records only, so no pick is
    skipped), and registers a calibrated bank in a hub of its own; the held-out
    graphs are scored with it (the leaves kernel: a calibrated tree bank
    takes the swap path) against ``oracle``, the int8 main path, whose
    bank was trained on fully profiled int8 data and whose measured
    held-out e2e are the truth.  Then one `LatencyService` with an
    `Observability` bundle holds both banks: a `LatencyScorer` with
    budgets on both settings over `SCORER_GRAPHS` fresh graphs, its spans
    read back; and the drift monitor fed by a second fresh target session
    measuring the held-out graphs' ops.  Every launch count is zeroed just
    before each step and read just after it."""
    import numpy as np
    from repro_torch.core.composition import mape
    from repro_torch.core.dataset import synthetic_graphs
    from repro_torch.core.features import graph_features
    from repro_torch.core.ir import op_signature
    from repro_torch.core.predictors.flat import device_tier
    from repro_torch.core.profiler import DeviceSetting, ProfileSession
    from repro_torch.obs import Observability, attach_session_drift
    from repro_torch.pipeline import LatencyService, PredictorHub, ProfileStore
    from repro_torch.pipeline.store import setting_key
    from repro_torch.quant.int8 import uses_int8_gemm
    from repro_torch.search import DeviceBudget, LatencyScorer
    from repro_torch.transfer import TransferEngine

    source = DeviceSetting("h100_f32_op", "float32", "op_by_op", device="h100")
    train, held = graphs[:n_train], graphs[n_train:]
    tier = device_tier(device)
    launches = {}

    reset_counts()
    src_store = ProfileStore()
    t0 = time.perf_counter()
    ProfileSession(store=src_store, device=device).profile_suite(graphs, source)
    source_profile_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    src_bank = PredictorHub(device=device).train(
        src_store, source, "gbdt", fingerprints=[g.fingerprint() for g in train])
    source_train_s = time.perf_counter() - t0
    launches["source_profile_and_train"] = read_counts()

    # The engine samples from a store of the probe (training) graphs'
    # records only, so every pick can be measured there.
    probe_store = ProfileStore()
    for g in train:
        rec = src_store.get_arch(source, g.fingerprint())
        probe_store.put_arch(source, g.fingerprint(), rec)
        for op in rec.ops:
            probe_store.put_op(source, op)
    # Which signatures the int8 setting runs as one int8 GEMM.
    gemm_route = {op_signature(g, n): uses_int8_gemm(g, n) for g in train for n in g.nodes}

    o_store = oracle["store"]
    truth = [o_store.get_arch(target, g.fingerprint()).e2e_s for g in held]
    oracle_ops = sum(len(o_store.get_arch(target, g.fingerprint()).ops) for g in train)
    rows, hubs = [], {}
    for k in TRANSFER_BUDGETS:
        hub = PredictorHub(device=device)
        hub.register(source, "gbdt", src_bank)
        session = ProfileSession(store=ProfileStore(), device=device)
        engine = TransferEngine(source, target, family="gbdt", seed=0,
                                probe_graphs=train)
        reset_counts()
        t0 = time.perf_counter()
        result = engine.adapt(probe_store, hub, session, k)
        adapt_s = time.perf_counter() - t0
        measuring = read_counts()
        skipped = len(result.plan.records) - result.n_op_measurements
        gemm_ops = sum(gemm_route[r.signature] for r in session.store.op_records(target))
        if not result.n_measurements <= k or \
                session.measured_ops + session.measured_graphs > k:
            raise AssertionError(f"K={k}: {result.n_measurements} measurements, "
                                 f"session {session.stats()}")
        if result.composition != "ratio-scaled" or session.measured_graphs != 0:
            raise AssertionError(f"K={k}: composition {result.composition}, "
                                 f"{session.measured_graphs} graphs measured")
        if skipped:
            raise AssertionError(f"K={k}: {skipped} sampled ops lie outside the "
                                 f"probe graphs")
        if not 0 < gemm_ops <= measuring["int8_matmul"]:
            raise AssertionError(f"K={k}: {measuring['int8_matmul']} int8 GEMM launches "
                                 f"while measuring {gemm_ops} GEMM-route ops (needs "
                                 f"0 < ops <= launches)")
        svc = LatencyService(hub, predictor="gbdt", device=device)
        reset_counts()
        reports = svc.predict_batch(held, target)
        scoring = read_counts()
        stats = svc.stats()
        vals = np.array([r.e2e_s for r in reports]
                        + [p for r in reports for _, p in r.per_op])
        if not (np.isfinite(vals).all() and min(r.e2e_s for r in reports) > 0):
            raise AssertionError(f"K={k}: predictions not finite and > 0")
        if set(stats["backend_runs"]) != {tier} or stats["device_fused_runs"] != 0:
            raise AssertionError(f"K={k}: the calibrated bank ran on "
                                 f"{stats['backend_runs']}, fused "
                                 f"{stats['device_fused_runs']}")
        if scoring["tree_gather_leaves"] == 0:
            raise AssertionError(f"K={k}: the leaves kernel was never launched")
        row = {"k": k, "result": result.to_json(), "adapt_s": adapt_s,
               "measured_ops": session.measured_ops,
               "measured_graphs": session.measured_graphs,
               # Sampled from the probe (training) graphs' records: 0.
               "sampled_not_in_probe_graphs": skipped,
               "measured_gemm_route_ops": gemm_ops,
               "e2e_mape_held_out": mape(truth, [r.e2e_s for r in reports]),
               "oracle_e2e_mape_held_out": oracle["summary"]["e2e_mape_held_out"],
               "oracle_trained_on_ops": oracle_ops,
               "oracle_measured_ops": oracle["summary"]["measured_ops"],
               "launches_while_measuring": measuring,
               "launches_while_scoring": scoring,
               "backend_runs": stats["backend_runs"]}
        log("transfer " + json.dumps(row))
        rows.append(row)
        hubs[k] = hub
        launches[f"adapt_k{k}"], launches[f"score_k{k}"] = measuring, scoring

    # Multi-device scoring through one observed service: source + target.
    bundle = Observability(seed=0)
    svc = LatencyService(hubs[TRANSFER_BUDGETS[-1]], default_setting=source,
                         predictor="gbdt", obs=bundle, device=device)
    fresh = synthetic_graphs(SCORER_GRAPHS, resolution=resolution, seed0=40_000)
    loose = LatencyScorer(svc, [DeviceBudget(source, 1e9), DeviceBudget(target, 1e9)])
    reset_counts()
    lats = loose.score(fresh)
    scorer = read_counts()
    launches["scorer"] = scorer
    skeys = {setting_key(source), setting_key(target)}
    if set(lats) != skeys or svc.predict_batch_calls != 2 or \
            not loose.feasible_mask(lats).all():
        raise AssertionError(f"scorer keys {sorted(lats)}, "
                             f"{svc.predict_batch_calls} predict_batch calls")
    t_med = float(np.median(lats[setting_key(target)]))
    tight = LatencyScorer(svc, [DeviceBudget(source, 1e9), DeviceBudget(target, t_med)])
    feasible = int(tight.feasible_mask(lats).sum())
    if not 0 < feasible < SCORER_GRAPHS:
        raise AssertionError(f"target budget at its median left {feasible} of "
                             f"{SCORER_GRAPHS} feasible")
    if scorer["tree_predict_fused"] == 0 or scorer["tree_gather_leaves"] == 0:
        raise AssertionError(f"scorer launches {scorer}: the source bank takes "
                             f"the fused kernel, the calibrated bank the leaves")
    stats = svc.stats()
    spans = bundle.tracer.export()
    n_batch = sum(1 for sp in spans if sp["name"] == "service.predict_batch")
    n_kernel = sum(1 for sp in spans if sp["name"] == "service.kernel"
                   and sp["attrs"].get("backend") == tier)
    errors = [sp for sp in spans if sp["status"] == "error"]
    if n_batch != stats["predict_batch_calls"] or \
            n_kernel != stats["backend_runs"].get(tier, 0) or errors:
        raise AssertionError(f"spans: {n_batch} predict_batch for "
                             f"{stats['predict_batch_calls']} calls, {n_kernel} "
                             f"{tier} kernel spans for {stats['backend_runs']}, "
                             f"{len(errors)} ended in error")

    # The drift monitor fed by a second fresh target session on the card.
    tbank = hubs[TRANSFER_BUDGETS[-1]].get(target, "gbdt")
    drift_sess = ProfileSession(store=ProfileStore(), device=device)
    attach_session_drift(drift_sess, svc, bundle.drift)
    reset_counts()
    with_predictor, seen = 0, set()
    for g in held:
        gf = graph_features(g)
        for j, node in enumerate(g.nodes):
            drift_sess.measure_op(g, node, target,
                                  features=(gf.node_names(j), gf.node_features(j)))
            sig = op_signature(g, node)
            if sig not in seen:
                seen.add(sig)
                with_predictor += int(node.op_type in tbank.predictors)
    launches["drift"] = read_counts()
    drift = bundle.drift.snapshot()
    if drift_sess.measured_ops != len(seen) or drift["observations"] != with_predictor:
        raise AssertionError(f"drift observed {drift['observations']} of "
                             f"{with_predictor} ops with a predictor "
                             f"({drift_sess.measured_ops} measured)")
    out = {"source": f"{source.name} ({setting_key(source)})",
           "target": f"{target.name} ({setting_key(target)})",
           "source_profile_s": source_profile_s, "source_train_s": source_train_s,
           "source_measured_ops": len(src_store.op_records(source)),
           "budgets": [{k: r[k] for k in ("k", "adapt_s", "measured_ops",
                                           "e2e_mape_held_out")} for r in rows],
           "oracle_e2e_mape_held_out": oracle["summary"]["e2e_mape_held_out"],
           "oracle_trained_on_ops": oracle_ops,
           "scorer": {"graphs": SCORER_GRAPHS, "keys": sorted(lats),
                      "predict_batch_calls": stats["predict_batch_calls"],
                      "target_median_s": t_med, "feasible_at_median": feasible,
                      "backend_runs": stats["backend_runs"],
                      "device_fused_runs": stats["device_fused_runs"],
                      "spans_predict_batch": n_batch, "spans_kernel": n_kernel},
           "drift": {"measured_ops": drift_sess.measured_ops,
                     "observations": drift["observations"],
                     "score": drift["score"],
                     "worst_cells": bundle.drift.worst_cells(3)},
           "launches": launches}
    log("transfer_drift " + json.dumps(drift))
    log("transfer_path " + json.dumps(out))
    return {"summary": out, "source": source, "store": src_store, "bank": src_bank}


# -- the paper method path (whole-graph mode, roofline labels, multi-worker) --------

WHOLE_RTOL, WHOLE_ATOL = 1e-5, 1e-6  # tests/test_torch_executor.py's `_close_graph`
WORKER_COUNTS = (1, 2, 3, 4)
FAST_SLOW = (1.0, 0.4)               # bench_multicore's heterogeneous pair
STRAGGLER_GROUPS, STRAGGLER_SLOWDOWN, MICROBATCHES = 4, 1.6, 16
CU_GRAPH_NODE_TYPES = {0: "kernel", 1: "memcpy", 2: "memset", 3: "host",
                       4: "graph", 5: "empty"}


def _spread(xs) -> dict:
    """Median and quartiles."""
    import numpy as np

    return {"q1": float(np.percentile(xs, 25)), "median": float(np.median(xs)),
            "q3": float(np.percentile(xs, 75)), "n": len(xs)}


def graph_node_counts(cuda_graph) -> dict:
    """Nodes of a captured `torch.cuda.CUDAGraph` (kept as a template) by
    type, read through the driver API (cuGraphGetNodes, cuGraphNodeGetType)."""
    import ctypes

    cu = ctypes.CDLL("libcuda.so.1")
    cu.cuGraphGetNodes.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                   ctypes.POINTER(ctypes.c_size_t)]
    cu.cuGraphNodeGetType.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)]
    handle = ctypes.c_void_p(cuda_graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    if cu.cuGraphGetNodes(handle, None, ctypes.byref(n)) != 0:
        raise AssertionError("cuGraphGetNodes failed")
    nodes = (ctypes.c_void_p * n.value)()
    if cu.cuGraphGetNodes(handle, nodes, ctypes.byref(n)) != 0:
        raise AssertionError("cuGraphGetNodes failed")
    out = {"total": n.value}
    kind = ctypes.c_int(0)
    for node in nodes:
        if cu.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind)) != 0:
            raise AssertionError("cuGraphNodeGetType failed")
        name = CU_GRAPH_NODE_TYPES.get(kind.value, f"type{kind.value}")
        out[name] = out.get(name, 0) + 1
    return out


def _close_outputs(got, want) -> tuple:
    """(bit-equal, within the CPU test's bound): |got − want| ≤ RTOL·|want|
    + ATOL·max(1, max|want|) element by element, per output."""
    import torch

    equal, close = True, True
    for o, w in zip(got, want):
        if o.shape != w.shape or o.dtype != w.dtype:
            return False, False
        equal &= bool(torch.equal(o, w))
        w64, o64 = w.double(), o.double()
        scale = max(1.0, float(w64.abs().max()))
        close &= bool(((o64 - w64).abs()
                       <= WHOLE_RTOL * w64.abs() + WHOLE_ATOL * scale).all())
    return equal, close


def _whole_vs_eager(g, dtype, device, fn_cache, timed: bool) -> dict:
    """One graph through ``whole_jit`` against ``op_by_op`` on the same
    inputs: the outputs compared, the graph's captured launches counted at
    each replay (the counts read before and after the replays), and, when
    ``timed``, e2e of the three modes as the profiler times it."""
    import torch
    from repro_torch.core.executor import GraphExecutor
    from repro_torch.utils.timing import time_callable

    ex_op = GraphExecutor(g, "op_by_op", dtype, fn_cache=fn_cache, device=device)
    ex_wj = GraphExecutor(g, "whole_jit", dtype, fn_cache=fn_cache, device=device)
    ins = ex_op.example_inputs()
    want = ex_op(*ins, sync_per_op=True)
    t0 = time.perf_counter()
    got = ex_wj(*ins)
    torch.cuda.synchronize()
    first_call_s = time.perf_counter() - t0
    equal, close = _close_outputs(got, want)
    (whole,) = ex_wj.whole_graphs.values()
    captured = whole.kernel_launches()
    before, r0 = read_counts(), whole.replays
    e2e = {"whole_jit": time_callable(lambda *a: ex_wj(*a), ins, warmup=1,
                                      inner=2, repeats=3)}
    replays = whole.replays - r0
    counts = {k: n - before[k] for k, n in read_counts().items()}
    want_counts = {k: captured.get(k, 0) * replays for k in counts}
    if counts != want_counts:
        raise AssertionError(f"{g.name} ({dtype}): {counts} launches in "
                             f"{replays} replays, captured {captured}")
    if timed:
        ex_fg = GraphExecutor(g, "fused_groups", dtype, fn_cache=fn_cache,
                              device=device)
        e2e["op_by_op"] = time_callable(lambda *a: ex_op(*a, sync_per_op=True),
                                        ins, warmup=1, inner=2, repeats=3)
        e2e["fused_groups"] = time_callable(lambda *a: ex_fg(*a), ins,
                                            warmup=1, inner=2, repeats=3)
    return {"graph": g.name, "ops": len(g.nodes), "equal": equal, "close": close,
            "captured": captured, "replays": replays, "capture_s": whole.capture_s,
            "first_call_s": first_call_s, "nodes": graph_node_counts(whole.graph),
            "e2e_s": e2e, "graph_ref": weakref.ref(whole.graph)}


def run_whole_graph_mode(device, settings: dict, graphs) -> dict:
    """Part 1: the 40 graphs profiled under ``whole_jit`` in float32 and
    int8 (ops served from the stores that hold them, e2e through one
    CUDA-graph replay), then each graph's ``whole_jit`` outputs against
    ``op_by_op`` with launch counts gated at captured × replays, e2e of the
    three modes, and the selection path's Winograd graphs held the same
    way."""
    import torch
    from repro_torch.core.profiler import DeviceSetting, ProfileSession
    from repro_torch.pipeline.store import setting_key

    out = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    for dtype, (op_setting, store) in settings.items():
        whole = DeviceSetting(f"h100_{'f32' if dtype == 'float32' else dtype}_whole",
                              dtype, "whole_jit", device="h100")
        session = ProfileSession(store=store, device=device, fn_cache_size=4096)
        before = read_counts()
        t0 = time.perf_counter()
        recs = session.profile_suite(graphs, whole)
        profile_s = time.perf_counter() - t0
        profiling = {k: n - before[k] for k, n in read_counts().items()}
        e2e_prof = [r.e2e_s for r in recs]
        if session.measured_graphs != len(graphs) or session.measured_ops != 0:
            raise AssertionError(f"{dtype} whole_jit profile: {session.stats()} "
                                 f"(ops are served from the {op_setting.name} store)")
        if not all(math.isfinite(e) and e > 0 for e in e2e_prof) or \
                any(r.num_kernels != len(g.nodes) for r, g in zip(recs, graphs)) or \
                store.get_arch(whole, graphs[0].fingerprint()) is None:
            raise AssertionError(f"{dtype} whole_jit records wrong")
        if dtype == "int8" and profiling["int8_matmul"] == 0:
            raise AssertionError("the int8 GEMM was never launched while "
                                 "profiling int8 whole_jit")
        rows = [_whole_vs_eager(g, dtype, device, session.fn_cache, True)
                for g in graphs]
        measured = {"measured_graphs": session.measured_graphs,
                    "measured_ops": session.measured_ops}
        del session                 # its built ops and their weights
        if not all(r["close"] for r in rows):
            bad = [r["graph"] for r in rows if not r["close"]]
            raise AssertionError(f"{dtype}: whole_jit outside the bound of "
                                 f"op_by_op on {bad}")
        if dtype == "int8" and not all(r["captured"].get("int8_matmul", 0) > 0
                                       for r in rows):
            raise AssertionError("an int8 graph captured no int8 GEMM launch")
        # Each graph goes with its executor when `_whole_vs_eager` returns.
        alive = sum(r.pop("graph_ref")() is not None for r in rows)
        if alive:
            raise AssertionError(f"{dtype}: {alive} captured graphs outlived "
                                 f"their executors")
        kernel_nodes = [r["nodes"].get("kernel", 0) for r in rows]
        summary = {
            "setting": f"{whole.name} ({setting_key(whole)})",
            "profile_s": profile_s, **measured,
            "launches_while_profiling": profiling,
            "bit_equal_graphs": sum(r["equal"] for r in rows),
            "within_bound_graphs": sum(r["close"] for r in rows), "graphs": len(rows),
            "graphs_alive_after": alive,
            "memory_mib_after": torch.cuda.memory_allocated() / 2**20,
            "captured_launches": {k: sum(r["captured"].get(k, 0) for r in rows)
                                  for k in sorted({k for r in rows for k in r["captured"]})},
            "replays": sum(r["replays"] for r in rows),
            "e2e_ms": {m: _spread([1e3 * r["e2e_s"][m] for r in rows])
                       for m in ("op_by_op", "fused_groups", "whole_jit")},
            "e2e_ms_profiled_whole_jit": _spread([1e3 * e for e in e2e_prof]),
            "op_by_op_over_whole_jit": _spread(
                [r["e2e_s"]["op_by_op"] / r["e2e_s"]["whole_jit"] for r in rows]),
            "fused_groups_over_whole_jit": _spread(
                [r["e2e_s"]["fused_groups"] / r["e2e_s"]["whole_jit"] for r in rows]),
            "capture_ms": _spread([1e3 * r["capture_s"] for r in rows]),
            "ops": _spread([r["ops"] for r in rows]),
            "kernel_nodes": _spread(kernel_nodes),
            "kernel_nodes_over_ops": _spread(
                [n / r["ops"] for n, r in zip(kernel_nodes, rows)]),
            "other_nodes": {k: sum(r["nodes"].get(k, 0) for r in rows)
                            for k in sorted({k for r in rows for k in r["nodes"]})
                            if k not in ("kernel", "total")}}
        log(f"whole_jit {dtype} " + json.dumps(summary))
        out[dtype] = summary
    wino = []
    for name, (c_in, c_out, hw) in STUDY_SHAPES.items():
        r = _whole_vs_eager(_conv_graph(c_in, c_out, hw, winograd=True), "float32",
                            device, None, False)
        r.pop("graph_ref")
        if not r["close"] or r["captured"].get("winograd_conv2d") != 1:
            raise AssertionError(f"Winograd graph {name} under whole_jit: {r}")
        wino.append({"name": name, "equal": r["equal"], "captured": r["captured"],
                     "replays": r["replays"], "nodes": r["nodes"],
                     "e2e_ms": 1e3 * r["e2e_s"]["whole_jit"]})
    log("whole_jit winograd " + json.dumps(wino))
    torch.cuda.synchronize()
    out["winograd"] = wino
    out["peak_memory_mib"] = torch.cuda.max_memory_allocated() / 2**20
    out["memory_mib_before_after"] = [mem0 / 2**20,
                                      torch.cuda.memory_allocated() / 2**20]
    log("whole_jit_memory " + json.dumps({k: out[k] for k in
                                          ("peak_memory_mib",
                                           "memory_mib_before_after")}))
    return out


def run_roofline_labels(settings: dict, graphs) -> dict:
    """Part 2: measured op latency over its H100 roofline label, by op type
    and setting, and `graph_cost` against the measured ``op_by_op`` e2e.
    float32 labels take 67 TFLOP/s (TF32 is off); int8 the s8 tensor-core
    rate.  The measured floor of the float32 store is printed beside the
    cost model's per-kernel overhead."""
    import dataclasses
    import numpy as np
    from repro_torch.core import cost_model
    from repro_torch.core.ir import op_signature
    from repro_torch.core.selection import get_device

    h100 = get_device("h100")
    devices = {"float32": dataclasses.replace(h100, peak_flops=PEAK_F32_OPS_PER_S),
               "int8": h100}
    out = {}
    for dtype, (setting, store) in settings.items():
        dev = devices[dtype]
        by_type = {}
        for g in graphs:
            for node in g.nodes:
                rec = store.get_op(setting, op_signature(g, node))
                label = cost_model.op_cost(g, node, dev, dtype=dtype)
                t = by_type.setdefault(node.op_type, {"ratio": [], "label_us": [],
                                                      "measured_us": [],
                                                      "compute": 0, "memory": 0})
                t["ratio"].append(rec.latency_s / label.total_s)
                t["label_us"].append(1e6 * label.total_s)
                t["measured_us"].append(1e6 * rec.latency_s)
                t[label.bound] += 1
        rows = {k: {"measured_over_label": float(np.median(v["ratio"])),
                    "label_us": float(np.median(v["label_us"])),
                    "measured_us": float(np.median(v["measured_us"])),
                    "bound": "compute" if v["compute"] > v["memory"] else "memory",
                    "compute_bound_ops": v["compute"], "memory_bound_ops": v["memory"]}
                for k, v in sorted(by_type.items())}
        e2e = [store.get_arch(setting, g.fingerprint()).e2e_s for g in graphs]
        cost = [cost_model.graph_cost(g, dev, dtype=dtype)["latency_s"] for g in graphs]
        # The floor: the least op latency the profiler read, over the op
        # types that launch a kernel (a split returns views of its input).
        floors = {}
        for r in store.op_records(setting):
            floors[r.op_type] = min(floors.get(r.op_type, math.inf), r.latency_s)
        floor = min(v for k, v in floors.items() if k != "split")
        summary = {"setting": setting.name, "device": dev.name,
                   "peak_flops": dev.peak_int8_flops if dtype == "int8" else dev.peak_flops,
                   "hbm_bw": dev.hbm_bw,
                   "kernel_overhead_s": cost_model.kernel_overhead(dev),
                   "measured_floor_s": floor, "floor_s_by_type": floors,
                   "note": "labels count 2 bytes a parameter (the reference's "
                           "count) and derate peaks by 0.85",
                   "by_type": rows,
                   "e2e_over_graph_cost": _spread([m / c for m, c in zip(e2e, cost)]),
                   "graph_cost_ms": _spread([1e3 * c for c in cost]),
                   "e2e_ms": _spread([1e3 * m for m in e2e])}
        if not all(math.isfinite(r["measured_over_label"]) and r["measured_over_label"] > 0
                   for r in rows.values()):
            raise AssertionError(f"{dtype} roofline ratios not finite and > 0")
        log(f"roofline {dtype} " + json.dumps(summary))
        out[dtype] = summary
    return out


def run_multiworker(device, source, store, bank, graphs, sync_overhead: float) -> dict:
    """Part 3: the paper's §3.1.1 model composing the float32 ``op_by_op``
    store's single-card op latencies (bench_multicore's recipe) and a
    `StragglerMonitor` seeded from the float32 GBDT bank's predicted e2e
    (bench_heterogeneity's), with ``sync_overhead`` the per-kernel floor
    measured on the card.  One card: a model, not a measurement of
    several workers."""
    import numpy as np
    from repro_torch.core.distributed_model import (Worker, graph_latency_multiworker,
                                                    speedup_curve)
    from repro_torch.distributed import StragglerMonitor
    from repro_torch.pipeline import LatencyService, PredictorHub

    ops = [[(o.op_type, o.latency_s) for o in store.get_arch(source, g.fingerprint()).ops]
           for g in graphs]
    curves = [speedup_curve(o, WORKER_COUNTS, sync_overhead=sync_overhead) for o in ops]
    fast, slow = FAST_SLOW
    pair = [Worker("fast", fast, sync_overhead), Worker("slow", slow, sync_overhead)]
    alone = [graph_latency_multiworker(o, [Worker("fast", fast)]) for o in ops]
    equal = [graph_latency_multiworker(o, pair, policy="equal") for o in ops]
    weighted = [graph_latency_multiworker(o, pair, policy="weighted") for o in ops]

    hub = PredictorHub(device=device)
    hub.register(source, "gbdt", bank)
    reports = LatencyService(hub, predictor="gbdt", device=device).predict_batch(
        graphs, source)
    base = float(np.median([r.e2e_s for r in reports]))
    predicted = [base] * (STRAGGLER_GROUPS - 1) + [STRAGGLER_SLOWDOWN * base]
    mon = StragglerMonitor(n_groups=STRAGGLER_GROUPS)
    mon.seed_from_predictions(predicted)
    plan = mon.microbatch_plan(MICROBATCHES)
    speedup = mon.predicted_speedup(MICROBATCHES)
    if mon.degraded_groups() != [STRAGGLER_GROUPS - 1] or sum(plan) != MICROBATCHES \
            or plan[-1] >= plan[0] or not speedup > 1.0:
        raise AssertionError(f"straggler plan {plan}, degraded "
                             f"{mon.degraded_groups()}, speedup {speedup}")
    out = {"model": "the paper's §3.1.1 model composing single-card measurements "
                    "(one card: not a measurement of several workers)",
           "sync_overhead_s": sync_overhead, "graphs": len(ops),
           "speedup": {k: _spread([c[k] for c in curves]) for k in WORKER_COUNTS},
           "equal_split_over_fast_alone": _spread([e / a for e, a in zip(equal, alone)]),
           "weighted_split_over_fast_alone": _spread(
               [w / a for w, a in zip(weighted, alone)]),
           "straggler": {"predicted_e2e_s": predicted, "degraded": mon.degraded_groups(),
                         "microbatches": plan, "equal_over_weighted": speedup}}
    log("multiworker " + json.dumps(out))
    return out


def run_paper_method_path(device, transfer: dict, int8, main_i8: dict, graphs) -> dict:
    """The paper's whole-graph mode, roofline labels and multi-worker
    composition on the card, over the transfer path's float32 ``op_by_op``
    store and the int8 main path's store."""
    settings = {"float32": (transfer["source"], transfer["store"]),
                "int8": (int8, main_i8["store"])}
    reset_counts()
    whole = run_whole_graph_mode(device, settings, graphs)
    roofline = run_roofline_labels(settings, graphs)
    multi = run_multiworker(device, transfer["source"], transfer["store"],
                            transfer["bank"], graphs,
                            roofline["float32"]["measured_floor_s"])
    launches = read_counts()
    log("paper_method_path " + json.dumps({"launches": launches}))
    if launches["int8_matmul"] == 0 or launches["winograd_conv2d"] == 0 or \
            launches["tree_predict_fused"] == 0:
        raise AssertionError(f"paper method path launches {launches}")
    return {"whole_jit": whole, "roofline": roofline, "multiworker": multi,
            "launches": launches}


# -- the RPC path (the serving layer in front of the card) -----------------------------

RPC_CLIENTS = 16                    # client threads, half on each setting
RPC_PER_CLIENT = 64                 # requests a client sends, one at a time
FLOOD_THREADS, FLOOD_PER = 8, 32    # tests/test_autopilot.py's flood, at 32 a thread
FLOOD_PROBE = 16                    # fresh graphs sent to the target after the swap
# After the flood the control loop keeps stepping until it has acted and
# then taken no action for QUIET_ROUNDS rounds (> the alert's sustain of
# 3 plus the cooldown of 4), at most SETTLE_ROUNDS rounds.
QUIET_ROUNDS, SETTLE_ROUNDS = 8, 96
CHAOS_THREADS, CHAOS_PER = 8, 32
CHAOS_SEED = 97
# The float64 composition of a report sums its per-op predictions in the
# same order on both sides, so e2e differs only by the per-op differences
# (each within the fused kernel's bound) and the rounding of ~30 float64
# adds (≤ 30 · 2^-53 of |e2e|).
E2E_F64_SLACK = 1e-12               # × |e2e|


def report_tolerances(bank, setting, graphs, device) -> list:
    """Per node of each graph's executed graph: the bound on |a − b| for
    two fused-kernel predictions of that node made in different flushes.
    Each is within `fused_tolerance` of the plain version (only the order
    of the sum over trees depends on the rows a launch holds), so two are
    within twice that.  Ops without a predictor predict 0 on both sides."""
    import numpy as np
    import torch
    from repro_torch.core.features import graph_features
    from repro_torch.core.fusion import fuse_graph
    from repro_torch.kernels import tree_gather as tg

    egs = [fuse_graph(g)[1] if setting.is_gpu_like else g for g in graphs]
    gfs = [graph_features(eg) for eg in egs]
    tols = [np.zeros(len(eg.nodes)) for eg in egs]
    for op_type, model in bank.predictors.items():
        rows = [(j, gf.matrix32(op_type), gf.index[op_type])
                for j, gf in enumerate(gfs) if op_type in gf.matrix]
        if not rows:
            continue
        x = torch.from_numpy(np.concatenate([m for _, m, _ in rows])).to(device)
        db = model.flat().device_bank(device)
        mean, std = tg.to_device_scaler(model.scaler, device)
        kind, scale, bias = model._device_reduction()
        pred = tg.fused_plain(*db.bank_args, mean, std, scale, bias, x,
                              depth=db.depth, kind=kind)
        leaves = tg.gather_leaves_plain(*db.bank_args, (x - mean) / std, depth=db.depth)
        tol = 2 * fused_tolerance(leaves, pred, scale, kind).cpu().numpy()
        off = 0
        for j, m, idx in rows:
            tols[j][np.asarray(idx)] = tol[off:off + len(m)]
            off += len(m)
    return tols


def check_reports(reports, direct, tols, op_sum_scale: float, label: str) -> float:
    """Each report against the direct `predict_batch` of the same graph:
    per op within its bound, e2e within their sum; returns the largest
    e2e difference over its bound."""
    worst = 0.0
    for r, d, tol in zip(reports, direct, tols):
        if r.fingerprint != d.fingerprint or [t for t, _ in r.per_op] != \
                [t for t, _ in d.per_op]:
            raise AssertionError(f"{label}: report for {r.graph_name} is cross-wired")
        diff = [abs(a - b) for (_, a), (_, b) in zip(r.per_op, d.per_op)]
        if any(x > t for x, t in zip(diff, tol)):
            raise AssertionError(f"{label}: {r.graph_name} per-op off by {max(diff)}")
        bound = op_sum_scale * math.fsum(tol) + E2E_F64_SLACK * abs(d.e2e_s)
        err = abs(r.e2e_s - d.e2e_s)
        if err > bound:
            raise AssertionError(f"{label}: {r.graph_name} e2e off by {err} "
                                 f"(bound {bound})")
        worst = max(worst, err / bound if bound else 0.0)
    return worst


def _flood(host: str, port: int, jobs: list, retry_seed=None) -> dict:
    """One `LatencyClient` thread per job list, each sending its
    ``(index, graph, setting)`` requests one at a time; raises the first
    error a thread met.  Returns the reports by index, every request's
    latency, the clients' retries and the epochs the reports carried."""
    from repro_torch.rpc import LatencyClient, RetryPolicy

    reports, lat, errs, retries, epochs = {}, [], [], [], set()

    def worker(t, todo):
        retry = None if retry_seed is None else RetryPolicy(
            max_attempts=12, base_delay_s=0.002, max_delay_s=0.05, deadline_s=120.0,
            seed=retry_seed + t)
        try:
            with LatencyClient(host, port, timeout=120.0, retry=retry) as c:
                for i, g, setting in todo:
                    t0 = time.perf_counter()
                    rep = c.predict_e2e(g, setting)
                    lat.append(time.perf_counter() - t0)
                    reports[i] = rep
                    epochs.add(rep.bank_epoch)
                retries.append(c.retries)
        except Exception as exc:            # raised below, after the join
            errs.append(exc)

    threads = [threading.Thread(target=worker, args=(t, todo), name=f"client-{t}")
               for t, todo in enumerate(jobs)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    if any(t.is_alive() for t in threads):
        raise AssertionError("an RPC client thread did not finish in 600 s")
    if errs:
        raise errs[0]
    return {"reports": reports, "latency_s": lat, "retries": sum(retries),
            "epochs": epochs}


def _quantiles(xs) -> dict:
    import numpy as np

    return {"p50": float(np.percentile(xs, 50)), "p99": float(np.percentile(xs, 99))}


def _device_busy_ms(prof) -> float:
    from torch.autograd import DeviceType

    return math.fsum(e.time_range.elapsed_us() for e in prof.events()
                     if e.device_type == DeviceType.CUDA) / 1e3


def check_flush_thread_error(host: str, port: int, server) -> dict:
    """A kernel launch that fails on the flush thread raises there, and the
    flush fails its request with a typed ``internal`` error: the fused
    kernel's plan is given 1 MiB of shared memory (the card grants at most
    227 KiB), so its launch returns an error before anything runs."""
    import dataclasses

    from repro_torch.core.dataset import synthetic_graphs
    from repro_torch.kernels import tree_gather_cuda as tgc
    from repro_torch.rpc import LatencyClient, protocol

    graph = synthetic_graphs(1, resolution=224, seed0=70_000)[0]
    real = tgc.plan_for
    failed0 = server.batcher.failed
    err = None
    tgc.plan_for = lambda *a, **k: dataclasses.replace(real(*a, **k), smem_bytes=1 << 20)
    try:
        with LatencyClient(host, port, timeout=60.0) as c:
            try:
                c.predict_e2e(graph)
            except protocol.RPCError as exc:
                err = exc
    finally:
        tgc.plan_for = real
    if err is None:
        raise AssertionError("a failing launch on the flush thread was answered")
    if err.code != protocol.E_INTERNAL or "tree_predict_fused launch failed" not in \
            err.message or server.batcher.failed != failed0 + 1:
        raise AssertionError(f"flush-thread launch error surfaced as {err.code}: "
                             f"{err.message}")
    with LatencyClient(host, port, timeout=60.0) as c:
        again = c.predict_e2e(graph)
    if again.from_cache or not again.e2e_s > 0:
        raise AssertionError("the request after the failed flush was not served")
    return {"code": err.code, "message": err.message[:160]}


def rpc_search_front(host: str, port: int, search) -> dict:
    """The search path's front served through ``search_front``: per
    setting, all of it, then the members within that setting's budget."""
    from repro_torch.rpc import LatencyClient

    members = search["report"].to_json()["front"]
    out = {}
    with LatencyClient(host, port, timeout=60.0) as c:
        for b in search["budgets"]:
            everything = c.search_front(setting=b.setting)
            got = c.search_front(setting=b.setting, budget_s=b.budget_s)
            want = sorted((m for m in members if m["latencies"][b.key] <= b.budget_s),
                          key=lambda m: (-m["quality"], m["digest"]))
            if everything["total"] != len(members) or not members or \
                    [m["digest"] for m in got["members"]] != [m["digest"] for m in want]:
                raise AssertionError(f"search_front {b.key}: {got['total']} members "
                                     f"within budget, {len(want)} expected")
            out[b.key] = {"budget_s": b.budget_s, "front": everything["total"],
                          "within_budget": got["total"]}
    return out


def _rpc_service(device, banks: dict, bundle):
    """One service on ``device`` holding each setting's GBDT bank, its
    default the first setting."""
    from repro_torch.pipeline import LatencyService, PredictorHub

    hub = PredictorHub(device=device)
    for setting, bank in banks.items():
        hub.register(setting, "gbdt", bank)
    return LatencyService(hub, default_setting=next(iter(banks)), predictor="gbdt",
                          obs=bundle, device=device)


def rpc_throughput(device, banks: dict, search) -> dict:
    """16 clients, one request at a time each, half on each setting, cold
    then warm, through a TCP server over one service on the card; then a
    failing launch on the flush thread, and the search front per setting."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.dataset import synthetic_graphs
    from repro_torch.core.ir import OpGraph
    from repro_torch.core.predictors.flat import device_tier
    from repro_torch.obs import Observability
    from repro_torch.pipeline import LatencyService
    from repro_torch.pipeline.store import setting_key
    from repro_torch.rpc import BatchPolicy, LatencyRPCServer, MonotonicClock
    from repro_torch.rpc import client as rpc_client
    from repro_torch.rpc import server as rpc_server

    settings = list(banks)
    bundle = Observability.quiet()
    svc = _rpc_service(device, banks, bundle)
    flushes = []                    # (setting key, size, seconds) per predict_batch
    real = svc.predict_batch

    def timed_flush(graphs, setting=None, predictor=None):
        t0 = time.perf_counter()
        try:
            return real(graphs, setting, predictor)
        finally:
            flushes.append((setting_key(setting or settings[0]), len(graphs),
                            time.perf_counter() - t0))

    svc.predict_batch = timed_flush
    n = RPC_CLIENTS * RPC_PER_CLIENT
    graphs = synthetic_graphs(n, resolution=224, seed0=40_000)
    jobs = [[(t * RPC_PER_CLIENT + i, graphs[t * RPC_PER_CLIENT + i],
              settings[t % len(settings)]) for i in range(RPC_PER_CLIENT)]
            for t in range(RPC_CLIENTS)]
    server = LatencyRPCServer(svc, policy=BatchPolicy(), clock=MonotonicClock(),
                              obs=bundle, search_report=search["report"])
    host, port = server.start()
    passes = {}
    try:
        for label in ("cold", "warm"):
            st0, n_flush0, fused0 = server.batcher.stats(), len(flushes), svc.device_fused_runs
            reset_counts()
            with contextlib.ExitStack() as stack:
                # Host seconds inside each group of calls, from every thread
                # (the interpreter lock serializes them, and a call waiting
                # for it counts its wait).
                feat = stack.enter_context(timed_featurization())
                server_wire = stack.enter_context(timed_calls(
                    rpc_server, "decode_request", "graph_from_wire", "encode_response"))
                client_wire = stack.enter_context(timed_calls(
                    rpc_client, "encode_request", "decode_response", "report_from_json"))
                to_json = stack.enter_context(timed_calls(OpGraph, "to_json"))
                fingerprint = stack.enter_context(timed_calls(OpGraph, "fingerprint"))
                prof = stack.enter_context(profile(activities=[ProfilerActivity.CUDA])) \
                    if label == "cold" else None
                t0 = time.perf_counter()
                out = _flood(host, port, jobs)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            counts = read_counts()
            st = server.batcher.stats()
            delta = {k: st[k] - st0[k] for k in ("submitted", "answered", "failed",
                                                  "rejected", "short_circuits", "batches")}
            mine = flushes[n_flush0:]
            row = {"requests": n, "wall_s": wall, "requests_per_s": n / wall,
                   "client_latency_s": _quantiles(out["latency_s"]), **delta,
                   "launches": counts,
                   "device_fused_runs": svc.device_fused_runs - fused0,
                   "featurize_s": feat[0], "server_wire_s": server_wire[0],
                   "client_wire_s": client_wire[0],
                   "graph_to_json_s": to_json[0], "fingerprint_s": fingerprint[0],
                   "flushes": len(mine)}
            if mine:
                row.update(mean_flush_size=n / len(mine),
                           flush_size_max=max(f[1] for f in mine),
                           flush_s=_quantiles([f[2] for f in mine]),
                           flush_s_total=math.fsum(f[2] for f in mine),
                           flushes_by_setting={k: sum(1 for f in mine if f[0] == k)
                                               for k in sorted({f[0] for f in mine})},
                           fused_launches_per_flush=counts["tree_predict_fused"] / len(mine))
            if prof is not None:
                busy = _device_busy_ms(prof)
                row.update(device_busy_ms=busy, device_busy_share=busy / (wall * 1e3))
            passes[label] = (row, out)
            log(f"rpc {label} " + json.dumps(row))
        cold, warm = passes["cold"][0], passes["warm"][0]
        for label, row, short in (("cold", cold, 0), ("warm", warm, n)):
            if not row["submitted"] == row["answered"] == n or row["failed"] or \
                    row["rejected"] or row["short_circuits"] != short:
                raise AssertionError(f"rpc {label}: not every request answered exactly "
                                     f"once: {row}")
        if cold["launches"]["tree_predict_fused"] == 0 or \
                cold["launches"]["tree_predict_fused"] != cold["device_fused_runs"] or \
                any(v for k, v in cold["launches"].items() if k != "tree_predict_fused"):
            raise AssertionError(f"rpc cold: launches {cold['launches']}, fused runs "
                                 f"{cold['device_fused_runs']}")
        backends, tier = server.batcher.flush_backends, device_tier(device)
        if set(backends) != {tier} or backends[tier] != cold["device_fused_runs"]:
            raise AssertionError(f"rpc: flushes ran on {backends}")
        if warm["batches"] or warm["flushes"] or any(warm["launches"].values()):
            raise AssertionError(f"rpc warm: {warm['batches']} flushes, launches "
                                 f"{warm['launches']}")
        cold_reps, warm_reps = passes["cold"][1]["reports"], passes["warm"][1]["reports"]
        if any(not warm_reps[i].from_cache or warm_reps[i].e2e_s != cold_reps[i].e2e_s
               for i in range(n)):
            raise AssertionError("rpc warm: a report was not the cold one from the cache")
        flush_error = check_flush_thread_error(host, port, server)
        front = rpc_search_front(host, port, search)
    finally:
        server.stop()

    # Each report against a direct predict_batch of its setting's graphs.
    direct_svc = LatencyService(svc.hub, default_setting=settings[0], predictor="gbdt",
                                device=device)
    worst = {}
    for k, setting in enumerate(settings):
        idx = [i for t in range(k, RPC_CLIENTS, len(settings)) for i, _, _ in jobs[t]]
        gs = [graphs[i] for i in idx]
        direct = direct_svc.predict_batch(gs, setting)
        tols = report_tolerances(banks[setting], setting, gs, device)
        worst[setting_key(setting)] = check_reports(
            [cold_reps[i] for i in idx], direct, tols, banks[setting].op_sum_scale,
            f"rpc {setting_key(setting)}")
    return {"cold": cold, "warm": warm, "flush_backends": backends,
            "e2e_err_over_bound": worst, "flush_thread_error": flush_error,
            "search_front": front}


def rpc_rollover(device, graphs) -> dict:
    """tests/test_autopilot.py::TestMidFloodRollover on the card at full
    width: a float32 ``op_by_op`` source profiled, as there, by the seeded
    `CostModelProfileSession` over ``graphs`` (40 at 224), with a GBDT bank
    trained on the card, onboards a synthetic target, whose drifted replay
    the autopilot behind the server recalibrates and rolls over while 8
    clients flood the target.  The source is not the card's own timings:
    a timed store gives each op type's drift cell the bank's error on a
    few records, which varies from run to run (the one ``pool_avg`` record
    read 0.19 to 0.95 of the threshold on the undrifted device in seven
    runs, and 1.02 after its recalibration in an eighth), so the gate
    below would read the card's timing noise and not the control loop.
    The reference stops stepping at the first action; here the loop steps
    on until it has acted and then stayed quiet for `QUIET_ROUNDS` rounds.
    There the op types the last action recalibrated must read a drift
    below 1.0, and the score must be below the one that fired the first
    action.  The
    score over every op type is reported beside its floor: the same
    observations of the undrifted device against the bank before any
    drift (an op type the loop does not target keeps the source bank's
    own bias).  Then fresh graphs go to the target through the new bank."""
    import numpy as np
    from repro_torch.core.dataset import synthetic_graphs
    from repro_torch.core.profiler import DeviceSetting
    from repro_torch.obs import (AlertEngine, AlertRule, AutopilotConfig, DriftMonitor,
                                 MetricsTimeline, Observability, RecalibrationAutopilot,
                                 attach_session_drift)
    from repro_torch.pipeline import LatencyService, PredictorHub, ProfileStore
    from repro_torch.pipeline.store import setting_key
    from repro_torch.rpc import BatchPolicy, LatencyClient, LatencyRPCServer, ManualClock
    from repro_torch.transfer import (CostModelProfileSession, ReplayProfileSession,
                                      SyntheticDevice, TransferEngine)

    src = DeviceSetting("model_f32", "float32", "op_by_op", device="costmodel")
    tgt = DeviceSetting("edge_f32", "float32", "op_by_op", device="edge0")
    edge = SyntheticDevice("edge0", seed=7, noise=0.05, curvature=0.1)
    store = ProfileStore()
    CostModelProfileSession(store=store, seed=1).profile_suite(graphs, src)
    hub = PredictorHub(device=device)
    hub.train(store, src, "gbdt")
    TransferEngine(src, tgt, family="gbdt", seed=0).adapt(
        store, hub, ReplayProfileSession(store, edge, src), 32)
    clock = ManualClock()
    bundle = Observability(clock=clock, seed=9, drift_threshold=0.5, drift_min_count=4)
    svc = LatencyService(hub, default_setting=src, predictor="gbdt", obs=bundle,
                         device=device)
    tl = MetricsTimeline(clock=clock, interval=1, capacity=256)
    tl.track("drift_score", bundle.drift.score)
    eng = AlertEngine(tl, [AlertRule("drift", series="drift_score", threshold=1.0,
                                     sustain=3)], obs=bundle)
    drifted = edge.warp_shift(scale=2.4, seed_offset=3)
    ap = RecalibrationAutopilot(bundle, eng, hub, store, src,
                                config=AutopilotConfig(budget_k=48, cooldown=4.0, seed=0))
    ap.register_device(tgt, lambda: ReplayProfileSession(store, drifted, src))
    epoch0 = hub.epoch_of(tgt, "gbdt")
    records = store.op_records(src)[:48]
    floor = DriftMonitor(threshold=0.5, min_count=4)
    for _ in range(QUIET_ROUNDS):
        sess = ReplayProfileSession(store, edge, src)
        attach_session_drift(sess, svc, floor)
        for rec in records:
            sess.measure_record(rec, tgt)
    trigger = []                    # the drift score when the first action fired

    def observe_round():
        sess = ReplayProfileSession(store, drifted, src)
        attach_session_drift(sess, svc, bundle.drift)
        for rec in records:
            sess.measure_record(rec, tgt)
        clock.advance(1)
        before = bundle.drift.score()
        ap.step()
        if ap.actions and not trigger:
            trigger.append(before)

    server = LatencyRPCServer(svc, obs=bundle, autopilot=ap, policy=BatchPolicy(
        max_batch=8, max_wait_ticks=5, max_queue=1024))
    host, port = server.start()
    jobs = [[(t * FLOOD_PER + i, graphs[(t + i) % len(graphs)], tgt)
             for i in range(FLOOD_PER)] for t in range(FLOOD_THREADS)]
    rounds, result, failure = 0, {}, []

    def run_flood():
        try:
            result.update(_flood(host, port, jobs))
        except Exception as exc:            # raised below, after the join
            failure.append(exc)

    reset_counts()
    t0 = time.perf_counter()
    try:
        flood = threading.Thread(target=run_flood, name="rpc-flood")
        flood.start()
        # Drive the control loop from this thread while the flood runs.
        while flood.is_alive() and time.perf_counter() - t0 < 600:
            observe_round()
            rounds += 1
        flood.join(timeout=600)
        if flood.is_alive():
            raise AssertionError("the mid-flood rollover's clients did not finish")
        if failure:
            raise failure[0]
        flood_s = time.perf_counter() - t0
        drift_after_flood, actions_during_flood = bundle.drift.score(), len(ap.actions)
        quiet = 0
        for _ in range(SETTLE_ROUNDS):
            if ap.actions and quiet >= QUIET_ROUNDS:
                break
            n_actions = len(ap.actions)
            observe_round()
            rounds += 1
            quiet = quiet + 1 if len(ap.actions) == n_actions else 0
        flood_counts = read_counts()
        with LatencyClient(host, port, timeout=60.0) as probe:
            snap = probe.metrics()["snapshot"]
            health = probe.health()
            reset_counts()
            fresh = synthetic_graphs(FLOOD_PROBE, resolution=224, seed0=60_000)
            after = probe.predict_pipelined(fresh, tgt)
            probe_counts = read_counts()
    finally:
        server.stop()
    epoch1 = hub.epoch_of(tgt, "gbdt")
    c = snap["counters"]
    total = {k: int(sum(c.get(f"rpc_batcher_{k}_total", {}).values()))
             for k in ("submitted", "answered", "failed", "rejected", "short_circuits")}
    n = FLOOD_THREADS * FLOOD_PER
    drift = bundle.drift.score()
    focus = {t: bundle.drift.score(setting_key(tgt), t)
             for t in (ap.actions[-1]["focus_op_types"] if ap.actions else ())}
    if not ap.actions or quiet < QUIET_ROUNDS or epoch1 <= epoch0 or \
            not max(focus.values()) < 1.0 or not drift < trigger[0]:
        raise AssertionError(f"rollover: {len(ap.actions)} actions, {quiet} quiet rounds "
                             f"at the end, epoch {epoch0} → {epoch1}, drift {drift} "
                             f"(fired at {trigger}), recalibrated types {focus}: "
                             f"{bundle.drift.worst_cells(3)}; "
                             f"{[e['kind'] for e in ap.audit.events()]}")
    if not all(epoch0 <= e <= epoch1 for e in result["epochs"]):
        raise AssertionError(f"rollover: epochs {sorted(result['epochs'])} outside "
                             f"[{epoch0}, {epoch1}]")
    if not total["submitted"] == total["answered"] == n or total["failed"] or \
            total["rejected"]:
        raise AssertionError(f"rollover: requests not conserved: {total}")
    if any(r.bank_epoch != epoch1 for r in after) or \
            probe_counts["tree_gather_leaves"] == 0 or probe_counts["tree_predict_fused"]:
        raise AssertionError(f"rollover: the new bank served {probe_counts}, epochs "
                             f"{sorted({r.bank_epoch for r in after})}")
    uploads = {}
    for op_type, model in hub.get(tgt, "gbdt").predictors.items():
        st = model.tree_model().device_stats()
        if st is not None:
            uploads[op_type] = st["uploads"]
    if not uploads or set(uploads.values()) != {1}:
        raise AssertionError(f"rollover: the new bank's uploads {uploads}")
    vals = np.array([r.e2e_s for r in list(result["reports"].values()) + after])
    if not (np.isfinite(vals).all() and vals.min() > 0):
        raise AssertionError("rollover: predictions not finite and > 0")
    out = {"requests": n, "flood_s": flood_s, "control_rounds": rounds,
           "actions_during_flood": actions_during_flood,
           "drift_after_flood": drift_after_flood,
           "actions": [dict(a) for a in ap.actions], "epochs": [epoch0, epoch1],
           "epochs_seen": sorted(result["epochs"]), "drift_fired_at": trigger[0],
           "drift_score": drift, "drift_recalibrated_types": focus,
           "drift_floor_undrifted": floor.score(),
           "worst_cells": bundle.drift.worst_cells(3),
           "floor_worst_cells": floor.worst_cells(3),
           **total, "launches_during_flood": flood_counts, "probe_graphs": FLOOD_PROBE,
           "launches_after_swap": probe_counts, "new_bank_uploads": uploads,
           "client_latency_s": _quantiles(result["latency_s"]),
           "health_status": health["status"],
           "audit": [e["kind"] for e in ap.audit.events()]}
    log("rpc_rollover " + json.dumps(out))
    return out


def rpc_chaos(device, banks: dict) -> dict:
    """A seeded `FaultPlan` at the flush and dispatch sites over 256 fresh
    requests from 8 clients with a `RetryPolicy`: every request settles
    exactly once, the injected tally is the plan's schedule, and the
    retries are exactly the faults the clients saw."""
    import numpy as np
    from repro_torch.core.dataset import synthetic_graphs
    from repro_torch.obs import Observability
    from repro_torch.rpc import (BatchPolicy, FaultPlan, FaultSpec, LatencyRPCServer,
                                 protocol)

    settings = list(banks)
    bundle = Observability.quiet()
    svc = _rpc_service(device, banks, bundle)
    plan = FaultPlan(CHAOS_SEED, [
        FaultSpec(site="flush", kind="error", rate=0.1, code=protocol.E_UNAVAILABLE,
                  message="injected flush fault"),
        FaultSpec(site="flush", kind="wedge", rate=0.1),
        FaultSpec(site="dispatch", kind="error", rate=0.1, code=protocol.E_UNAVAILABLE,
                  message="injected dispatch fault")])
    server = LatencyRPCServer(svc, chaos=plan, obs=bundle, policy=BatchPolicy(
        max_batch=8, max_wait_ticks=2, max_queue=4096))
    host, port = server.start()
    n = CHAOS_THREADS * CHAOS_PER
    graphs = synthetic_graphs(n, resolution=224, seed0=50_000)
    jobs = [[(t * CHAOS_PER + i, graphs[t * CHAOS_PER + i], settings[t % len(settings)])
             for i in range(CHAOS_PER)] for t in range(CHAOS_THREADS)]
    reset_counts()
    t0 = time.perf_counter()
    try:
        out = _flood(host, port, jobs, retry_seed=0)
        wall = time.perf_counter() - t0
        st = server.batcher.stats()
    finally:
        server.stop()
    counts = read_counts()
    injected = plan.injected()
    schedule = {}
    for site in ("flush", "dispatch"):
        kinds = plan.schedule(site, plan.events(site))
        for kind in sorted({k for k in kinds if k is not None}):
            schedule[f"{site}/{kind}"] = kinds.count(kind)
    reps = out["reports"]
    if len(reps) != n or any(reps[i].fingerprint != graphs[i].fingerprint()
                             for i in range(n)):
        raise AssertionError(f"chaos: {len(reps)} of {n} requests answered")
    if st["answered"] != n or st["submitted"] != st["answered"] + st["failed"] or \
            st["queued"] or st["rejected"]:
        raise AssertionError(f"chaos: not every request settled exactly once: {st}")
    if injected != schedule or not injected:
        raise AssertionError(f"chaos: injected {injected}, the plan's schedule {schedule}")
    if st["wedged_flushes"] != injected.get("flush/wedge", 0) or \
            out["retries"] != injected.get("dispatch/error", 0) + st["failed"]:
        raise AssertionError(f"chaos: {out['retries']} retries for "
                             f"{injected.get('dispatch/error', 0)} dispatch faults and "
                             f"{st['failed']} failed requests; wedged "
                             f"{st['wedged_flushes']}")
    vals = np.array([r.e2e_s for r in reps.values()])
    if not (np.isfinite(vals).all() and vals.min() > 0) or counts["tree_predict_fused"] == 0:
        raise AssertionError(f"chaos: predictions or launches wrong: {counts}")
    row = {"requests": n, "wall_s": wall, "seed": CHAOS_SEED, "injected": injected,
           "events": {s: plan.events(s) for s in ("flush", "dispatch")},
           "retries": out["retries"], "submitted": st["submitted"],
           "answered": st["answered"], "failed": st["failed"],
           "wedged_flushes": st["wedged_flushes"], "batches": st["batches"],
           "flush_backends": st["flush_backends"], "launches": counts,
           "client_latency_s": _quantiles(out["latency_s"])}
    log("rpc_chaos " + json.dumps(row))
    return row


def run_rpc_path(device, banks: dict, search, graphs) -> dict:
    """The serving layer on the card: throughput (then a failing launch on
    the flush thread and the search front), the mid-flood rollover behind
    the autopilot, and chaos; every launch count zeroed just before each
    step and read just after it."""
    throughput = rpc_throughput(device, banks, search)
    rollover = rpc_rollover(device, graphs)
    chaos = rpc_chaos(device, banks)
    out = {"cold_requests_per_s": throughput["cold"]["requests_per_s"],
           "warm_requests_per_s": throughput["warm"]["requests_per_s"],
           **{k: throughput[k] for k in ("e2e_err_over_bound", "flush_backends",
                                         "search_front", "flush_thread_error")},
           "rollover": {k: rollover[k] for k in ("actions", "epochs",
                                                  "launches_after_swap")},
           "chaos": {k: chaos[k] for k in ("injected", "retries", "failed")}}
    log("rpc_path " + json.dumps(out))
    return out


# -- the LM serving path (Granite-MoE) -------------------------------------------

LM_ARCH = "granite-moe-1b-a400m"
# Flash and GMM kernels against their plain versions, max |err| over
# max |plain|: float32, the order of float32 sums; bfloat16, one rounding
# of the float32 result (a bfloat16 step is 2^-8 relative), and in flash
# the probabilities' rounding to bfloat16 before P·V (2^-9 relative; the
# CPU emulation in tests/test_torch_flash_attention.py bounds both at
# 5e-3).
LM_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
# Beside it, bfloat16 flash row by row: max |err| of each query row over
# max |plain| of that row.  A causal row n averages n values, so its
# outputs shrink as 1/sqrt(n) and the whole-output scale, set by the first
# rows, would let a fault in the late key tiles pass.  Kernel and plain
# version differ by at most one bfloat16 step of each element, at most
# 2^-7 of the row's largest value (7.8e-3, what the card reads); the limit
# allows two steps and no more.
FLASH_ROW_TOL = 1.6e-2
# Decode against forward, last-position logits (float32 compute and cache).
CONSISTENCY_TOL = 2e-2
# The full-width LM on the card against the port on the host, reduced size.
HOST_TOL = 1e-4
FORWARD_SHAPE = (4, 1024)           # (batch, tokens) of the timed forward
# The LM path's Granite at full width and a quarter of its depth: its
# decode steps are host-bound (97 ms a call at 24 layers), and the
# serving driver's `main` serves Granite at full depth after it.
LM_DEPTH = {"num_layers": 6}


class FlashCase(NamedTuple):
    """q (b, s, h, d) over k, v (b, skv or s, kvh, d)."""
    label: str
    b: int
    s: int
    h: int
    kvh: int
    d: int
    causal: bool
    dtype: str
    skv: int = 0                    # 0: s keys
    window: int = 0
    softcap: float = 0.0
    q_scale: float = 1.0            # q's standard deviation (k and v: 1)
    q_offset: int = 0               # the causal diagonal's shift

    @property
    def keys(self) -> int:
        return self.skv or self.s


FLASH_CASES = [FlashCase(*c) for c in (
    ("forward", 4, 1024, 16, 8, 64, True, "bfloat16"),
    ("forward_f32", 4, 1024, 16, 8, 64, True, "float32"),
    ("non_causal", 2, 512, 16, 8, 64, False, "bfloat16"),
    ("ragged", 2, 1000, 16, 8, 64, True, "bfloat16"),
    ("ragged_f32", 1, 1000, 16, 8, 64, True, "float32"),
    ("d128_one_kv_head", 1, 333, 8, 1, 128, True, "float32"),
    ("zamba2_forward", 2, 4096, 32, 32, 64, True, "bfloat16"),
    # The LM zoo's attention calls (`run_lm_zoo_path`): gemma2's local and
    # global layers at its forward's 6,144 tokens (window 4,096, softcap
    # 50), a window of 100 (not a multiple of the 64-key tile: late rows of
    # a query tile start on wholly hidden key tiles) on both routes, the
    # VLM's cross-attention over 1,600 vision embeddings, Whisper's
    # encoder and its decode step's cross-attention over 1,500 frames; then
    # the training calls that no zoo forward makes: Whisper's encoder at
    # the training batch of 4 and its decoder's cross-attention, 448 queries
    # over 1,500 frames (non-causal, sq < skv, a partial last 64-key tile).
    # gemma2's q has standard deviation 8, so its scores (sd 8) reach the
    # softcap's bend: a kernel without the softcap, or with it applied
    # after the log2(e) fold, moves the output well past the tolerances
    # (`check_flash` gates that for every softcap case).
    ("gemma2_local", 1, 6144, 32, 16, 128, True, "bfloat16", 0, 4096, 50.0, 8.0),
    ("gemma2_global", 1, 6144, 32, 16, 128, True, "bfloat16", 0, 0, 50.0, 8.0),
    ("window_ragged_f32", 1, 1000, 8, 4, 64, True, "float32", 0, 100, 5.0),
    ("window_ragged", 2, 1000, 16, 8, 64, True, "bfloat16", 0, 100, 0.0),
    ("vlm_cross", 2, 2048, 64, 8, 128, False, "bfloat16", 1600),
    ("whisper_encoder", 2, 1500, 20, 20, 64, False, "bfloat16"),
    ("whisper_cross_decode", 4, 1, 20, 20, 64, False, "bfloat16", 1500),
    ("whisper_encoder_train", 4, 1500, 20, 20, 64, False, "bfloat16"),
    ("whisper_cross", 4, 448, 20, 20, 64, False, "bfloat16", 1500),
    # Head dims the training path does not take, on the backward's
    # bfloat16 instances too: 128, and 16 with queries that continue 128
    # cached keys (q_offset, sq != skv).
    ("d128_bf16", 2, 1000, 16, 4, 128, True, "bfloat16"),
    ("d16_offset", 2, 200, 8, 2, 16, True, "bfloat16", 328, 0, 0.0, 1.0, 128),
    # The backward's masks on the float32 route at gemma2's local call, and
    # a small window (and a softcap) with an offset over 128 cached keys
    # on both routes.
    ("gemma2_local_f32", 1, 6144, 32, 16, 128, True, "float32", 0, 4096, 50.0, 8.0),
    ("window_offset", 2, 200, 8, 2, 64, True, "bfloat16", 328, 100, 5.0, 2.0, 128),
    ("window_offset_f32", 2, 200, 8, 2, 64, True, "float32", 328, 100, 5.0, 2.0, 128),
    # The training path's causal self-attention calls of the VLM's self
    # layer (2 × 2,048 tokens, GQA 64/8, d 128) and of Whisper's decoder
    # (4 × 448 tokens, d 64).
    ("vlm_self", 2, 2048, 64, 8, 128, True, "bfloat16"),
    ("whisper_self", 4, 448, 20, 20, 64, True, "bfloat16"))]
# The flash cases `time_flash` times: the Granite, Zamba2 and zoo forwards'
# shapes, and Whisper's training cross-attention.
FLASH_TIMED = ("forward", "forward_f32", "zamba2_forward", "gemma2_local",
               "gemma2_global", "whisper_encoder", "vlm_cross", "whisper_cross")
GMM_CASES = [                       # (label, e, rows, d, f, dtype)
    ("decode", 32, 32, 1024, 512, "bfloat16"),
    ("decode_down", 32, 32, 512, 1024, "bfloat16"),
    ("prefill", 32, 1280, 1024, 512, "bfloat16"),
    ("prefill_down", 32, 1280, 512, 1024, "bfloat16"),
    ("decode_f32", 32, 32, 1024, 512, "float32"),
    ("prefill_f32", 32, 1280, 1024, 512, "float32"),
    ("ragged", 5, 77, 300, 129, "bfloat16"),
    ("ragged_f32", 3, 33, 70, 17, "float32")]


def _randn(shape, seed, device, dtype, scale=1.0):
    import numpy as np
    import torch

    a = np.random.default_rng(seed).standard_normal(shape) * scale
    return torch.from_numpy(a.astype(np.float32)).to(device, getattr(torch, dtype))


def _rel_check(label, got, want, tol) -> tuple:
    import torch

    if got.dtype != want.dtype or got.shape != want.shape:
        raise AssertionError(f"{label}: {got.dtype} {tuple(got.shape)} against "
                             f"{want.dtype} {tuple(want.shape)}")
    err = float((got.float() - want.float()).abs().max())
    rel = err / max(float(want.float().abs().max()), 1e-30)
    if not (rel <= tol and bool(torch.isfinite(got).all())):
        raise AssertionError(f"{label}: {rel} × max off its plain version (> {tol})")
    return err, rel


def _row_check(label, got, want, tol) -> float:
    """Max over rows (all but the last axis) of the row's max |err| over
    its max |plain|; raises past ``tol``."""
    g, w = got.float(), want.float()
    rel = float(((g - w).abs().amax(-1) / w.abs().amax(-1).clamp_min(1e-30)).max())
    if not rel <= tol:
        raise AssertionError(f"{label}: a row {rel} × its max off its plain "
                             f"version (> {tol})")
    return rel


def flash_pairs(s: int, skv: int, causal: bool, window: int = 0) -> int:
    """(query, key) pairs of one head that the causal mask and the window
    keep (the kernel's q_offset is 0 on these paths)."""
    import numpy as np

    i = np.arange(s, dtype=np.int64)
    hi = np.minimum(i, skv - 1) if causal else np.full(s, skv - 1)
    lo = np.maximum(0, i - window + 1) if window else np.zeros(s, np.int64)
    return int(np.maximum(0, hi - lo + 1).sum())


def _flash_bound(b, s, h, kvh, d, causal, dtype, skv=0, window=0) -> tuple:
    """q, k, v read once and o written once, against 4·d operations for
    each (query, key) pair the masks keep, at the type's rate."""
    skv = skv or s
    pairs = b * h * flash_pairs(s, skv, causal, window)
    bf16 = dtype == "bfloat16"
    return bound((2 if bf16 else 4) * (2 * b * s * h * d + 2 * b * skv * kvh * d),
                 4 * d * pairs, PEAK_BF16_OPS_PER_S if bf16 else PEAK_F32_OPS_PER_S)


def _gmm_bound(e, n, d, f, dtype) -> tuple:
    """x and w read once and the output written once, against
    2·e·rows·d·f operations at the type's rate (bfloat16 on the tensor
    cores, float32 outside them)."""
    bf16 = dtype == "bfloat16"
    return bound((2 if bf16 else 4) * (e * n * d + e * d * f + e * n * f),
                 2 * e * n * d * f, PEAK_BF16_OPS_PER_S if bf16 else PEAK_F32_OPS_PER_S)


def _flash_inputs(b, s, h, kvh, d, dtype, device, seed, skv=0, q_scale=1.0):
    return (_randn((b, s, h, d), seed, device, dtype, q_scale),
            _randn((b, skv or s, kvh, d), seed + 1, device, dtype),
            _randn((b, skv or s, kvh, d), seed + 2, device, dtype))


def _flash_kw(c: FlashCase) -> dict:
    return {"causal": c.causal, "window": c.window, "softcap": c.softcap,
            "q_offset": c.q_offset}


def _gmm_inputs(e, rows, d, f, dtype, device, seed):
    return (_randn((e, rows, d), seed, device, dtype),
            _randn((e, d, f), seed + 1, device, dtype, 1.0 / math.sqrt(d)))


def _check_route(label, module, before: dict, dtype, launches: int,
                 counts=None) -> None:
    """The launches went to the kernel of ``dtype``'s route (bfloat16: the
    tensor cores; float32: the CUDA cores) and to no other; ``counts``
    reads them (the module's `route_counts` unless given)."""
    route = module.ROUTES[dtype][1]
    now = (counts or module.route_counts)()
    moved = {r: now[r] - before[r] for r in now}
    if moved != {r: launches if r == route else 0 for r in now}:
        raise AssertionError(f"{label}: launches by route {moved}, expected "
                             f"{launches} on {route}")


# The flash backward's kernels, longest name first (a stem is a prefix of
# its bfloat16 twin's).
FLASH_BWD_KERNELS = ("flash_bwd_dkdv_bf16_mma", "flash_bwd_dq_bf16_mma",
                     "flash_bwd_dkdv", "flash_bwd_dq")


# The bfloat16 pair's template flags (window, cap) → the instance's label.
BWD_MASKS = {("0", "0"): "", ("1", "0"): ", window", ("0", "1"): ", cap",
             ("1", "1"): ", window, cap"}


def bwd_instance(mangled: str) -> str:
    """``flash_bwd_dq_bf16_mma<64>`` (``<64, window, cap>`` and so on with
    its mask flags) or ``flash_bwd_dq<float, 64>`` for a mangled backward
    kernel instance (a length-prefixed name, then its template arguments
    ``I[f]Li<D>E[Lb<window>ELb<cap>E]``); the mangled name itself for any
    other kernel."""
    for stem in FLASH_BWD_KERNELS:
        at = mangled.find(f"{len(stem)}{stem}I")
        if at >= 0:
            m = re.match(r"I(f?)Li(\d+)E(?:Lb([01])ELb([01])E)?",
                         mangled[at + len(str(len(stem))) + len(stem):])
            if m:
                masks = BWD_MASKS[(m.group(3), m.group(4))] if m.group(3) else ""
                return f"{stem}<{'float, ' if m.group(1) else ''}{m.group(2)}{masks}>"
    return mangled


def flash_bwd_registers() -> dict:
    """Registers and spill bytes of each flash backward instance, from the
    build's ptxas report (`_build.ptxas_report`); raises if a bfloat16
    instance spills, or if the library was built here and its report
    lacks one.  Empty when the library was built by an earlier process."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention_cuda as fac

    info = _build.BUILD_INFO.get(fac.BWD_LIBRARY.name, {})
    out = {bwd_instance(k): r for k, r in _build.ptxas_report(info.get("ptxas", "")).items()}
    if info.get("seconds", 0.0) > 0:
        want = {f"{stem}<{d}{masks}>" for stem in FLASH_BWD_KERNELS
                if stem.endswith("_mma") for d in fac.HEAD_DIMS
                for masks in BWD_MASKS.values()}
        if not want <= set(out):
            raise AssertionError(f"ptxas report lacks {sorted(want - set(out))}")
    spilled = {k: r for k, r in out.items() if k.split("<")[0].endswith("_bf16_mma")
               and (r["spill_stores"] or r["spill_loads"])}
    if spilled:
        raise AssertionError(f"bfloat16 flash backward instances spill: {spilled}")
    return out


def log_bf16_smem() -> None:
    """Dynamic shared memory of the bfloat16 kernels' instances (ptxas
    reports static shared memory only); for the flash backward also every
    instance's registers and spills (`flash_bwd_registers`)."""
    from repro_torch.kernels import flash_attention_cuda as fac
    from repro_torch.kernels import moe_gmm_cuda as gmmc

    fl, gl = fac.LIBRARY.load(), gmmc.LIBRARY.load()
    log("smem flash_fwd_bf16_mma by head dim " + json.dumps(
        {d: fl.flash_attention_bf16_smem_bytes(d) for d in fac.HEAD_DIMS}))
    bl = fac.BWD_LIBRARY.load()
    log("smem flash_bwd_dq / flash_bwd_dkdv by head dim " + json.dumps(
        {"float32": {d: bl.flash_attention_bwd_smem_bytes(d) for d in fac.HEAD_DIMS},
         "bfloat16": {d: [bl.flash_attention_bwd_bf16_smem_bytes(d, pass_)
                          for pass_ in (0, 1)] for d in fac.HEAD_DIMS},
         "registers_and_spills": flash_bwd_registers()}))
    log("smem moe_gmm_mma_kernel by rows " + json.dumps(
        {"<=64": gl.moe_gmm_bf16_smem_bytes(64), ">64": gl.moe_gmm_bf16_smem_bytes(65)}))


def sass_opcodes(library: str, opcode: str) -> int:
    """Instructions named ``opcode`` (as ``IMMA.16832.S8.S8``) in the SASS
    of a built library, by ``cuobjdump -sass`` beside nvcc."""
    from repro_torch.kernels import _build

    tool = Path(_build._nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(tool), "-sass", _build.BUILD_INFO[library]["path"]],
                          capture_output=True, text=True, check=True, timeout=120).stdout
    return sum(1 for line in sass.splitlines()
               if any(w.split(".")[0] == opcode for w in line.split()))


def softcap_sensitivity(c: FlashCase, q, k, v, want) -> dict:
    """The plain version without the softcap, and with it applied after
    the bfloat16 kernel's log2(e) fold (a softcap of cap·ln 2 in natural
    units), against ``want``: each must fail the case's gates, so that a
    kernel making either mistake could not pass them.  Raises if one
    would pass."""
    from repro_torch.kernels import flash_attention as fa

    out = {}
    for key, cap in (("softcap_off", 0.0), ("softcap_after_fold", c.softcap * math.log(2))):
        wrong = fa.flash_attention_plain(q, k, v, causal=c.causal, window=c.window,
                                         softcap=cap).float()
        w = want.float()
        rel = float((wrong - w).abs().max() / w.abs().max())
        row = float(((wrong - w).abs().amax(-1) / w.abs().amax(-1).clamp_min(1e-30)).max())
        caught = rel > LM_TOL[c.dtype] or (c.dtype == "bfloat16" and row > FLASH_ROW_TOL)
        if not caught:
            raise AssertionError(f"flash {c.label}: {key} moves the output by {rel} "
                                 f"(a row by {row}), inside the gates")
        out[key] = {"err_over_max": rel, "row_err_over_max": row}
        del wrong
    return out


def check_flash(device) -> dict:
    """Flash kernel vs its plain version at the Granite forward's shape and
    around it (float32, non-causal, ragged s, d = 128 with one kv head),
    at the Zamba2 forward's (32 heads MHA over 4,096 tokens) and at the LM
    zoo's (window, softcap, cross-attention with sq != skv)."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_attention_cuda as fac

    rows, worst = [], 0.0
    for i, c in enumerate(FLASH_CASES):
        label, dtype, kw = c.label, c.dtype, _flash_kw(c)
        q, k, v = _flash_inputs(c.b, c.s, c.h, c.kvh, c.d, dtype, device,
                                seed=300 + 3 * i, skv=c.skv, q_scale=c.q_scale)
        before = fac.launch_counts()["flash_attention"]
        routes = fac.route_counts()
        got = fac.flash_attention_cuda(q, k, v, **kw)
        again = fac.flash_attention_cuda(q, k, v, **kw)
        torch.cuda.synchronize()
        if fac.launch_counts()["flash_attention"] != before + 2:
            raise AssertionError("flash_attention launch counter did not advance")
        _check_route(f"flash {label}", fac, routes, q.dtype, 2)
        want = fa.flash_attention_plain(q, k, v, **kw)
        err, rel = _rel_check(f"flash {label}", got, want, LM_TOL[dtype])
        row = {"case": label, "shape": [c.b, c.s, c.h, c.kvh, c.d], "skv": c.keys,
               "causal": c.causal, "q_offset": c.q_offset, "window": c.window,
               "softcap": c.softcap,
               "dtype": dtype, "max_abs_err": err, "err_over_max": rel,
               "tol": LM_TOL[dtype]}
        if dtype == "bfloat16":
            row["row_err_over_max"] = _row_check(f"flash {label}", got, want,
                                                 FLASH_ROW_TOL)
            row["row_tol"] = FLASH_ROW_TOL
        if c.softcap:
            row.update(softcap_sensitivity(c, q, k, v, want))
        if not torch.equal(got, again):
            raise AssertionError("flash kernel is not repeatable")
        del q, k, v, got, again, want
        torch.cuda.empty_cache()
        worst = max(worst, err)
        rows.append(row)
    log("parity flash_attention " + json.dumps(rows))
    return {"cases": rows, "max_abs_err": worst}


def check_gmm(device) -> dict:
    """GMM kernel vs its plain version at the decode and prefill shapes of
    the serving path and at a ragged shape."""
    import torch
    from repro_torch.kernels import moe_gmm as gmm
    from repro_torch.kernels import moe_gmm_cuda as gmmc

    torch.backends.cuda.matmul.allow_tf32 = False
    rows, worst = [], 0.0
    for i, (label, e, n, d, f, dtype) in enumerate(GMM_CASES):
        x, w = _gmm_inputs(e, n, d, f, dtype, device, seed=400 + 2 * i)
        before = gmmc.launch_counts()["moe_gmm"]
        routes = gmmc.route_counts()
        got = gmmc.moe_gmm_cuda(x, w)
        torch.cuda.synchronize()
        if gmmc.launch_counts()["moe_gmm"] != before + 1:
            raise AssertionError("moe_gmm launch counter did not advance")
        _check_route(f"gmm {label}", gmmc, routes, x.dtype, 1)
        err, rel = _rel_check(f"gmm {label}", got, gmm.moe_gmm_plain(x, w),
                              LM_TOL[dtype])
        worst = max(worst, err)
        rows.append({"case": label, "shape": [e, n, d, f], "dtype": dtype,
                     "max_abs_err": err, "err_over_max": rel, "tol": LM_TOL[dtype]})
    log("parity moe_gmm " + json.dumps(rows))
    return {"cases": rows, "max_abs_err": worst}


# The flash backward's cases: `FLASH_CASES` with more than one query row;
# every head dim on the bfloat16 route (16 with q_offset > 0, 64, 128);
# gemma2's global (softcap 50) and local (window 4,096 and softcap 50)
# training calls, the local one also on the float32 route, windows of 100
# (with and without a softcap, with an offset) on both routes, and every
# attention call of the VLM's and Whisper's training steps at its own
# shape: the VLM's self and cross layers, Whisper's encoder (at the zoo
# forward's batch of 2 and the training batch of 4), its decoder's self-
# and cross-attention.
FLASH_BWD_CASES = ("forward", "forward_f32", "non_causal", "ragged", "ragged_f32",
                   "d128_one_kv_head", "vlm_cross", "whisper_encoder",
                   "whisper_encoder_train", "whisper_cross", "vlm_self", "whisper_self",
                   "d128_bf16",
                   "d16_offset", "gemma2_global", "gemma2_local", "gemma2_local_f32",
                   "window_ragged", "window_ragged_f32", "window_offset",
                   "window_offset_f32")
# Row by row, bfloat16 backward: a row's scale is its max |plain|, floored
# at this share of the whole output's max.  dq's first causal row is zero
# in exact arithmetic (a softmax over one key has no gradient), so both
# versions hold float32 rounding noise there and its own max would
# compare noise with noise.  A causal dq row of n keys scales as
# 1/sqrt(n), 1/32 of the first rows' at 1,024 keys, well above the floor,
# so a fault in the late key or query tiles still moves its row past
# `FLASH_ROW_TOL`.
FLASH_BWD_ROW_FLOOR = 2.0 ** -8
# The flash forward's log-sum-exp against its plain version, max |err|
# over max(1, max |plain|): float32 sums of the same products.
LSE_TOL = 1e-5
# The GMM's backward: `GMM_CASES` at the prefill (training) shapes and the
# ragged ones; Granite's training call is "prefill": 4 × 320 rows an
# expert at 4 × 1,024 tokens.
GMM_BWD_CASES = ("prefill", "prefill_down", "prefill_f32", "ragged", "ragged_f32")


def _bwd_row_check(label, got, want, tol) -> float:
    """`_row_check` with each row's scale floored at `FLASH_BWD_ROW_FLOOR`
    of the whole output's max."""
    g, w = got.float(), want.float()
    scale = w.abs().amax(-1).clamp_min(FLASH_BWD_ROW_FLOOR * float(w.abs().max()))
    rel = float(((g - w).abs().amax(-1) / scale).max())
    if not rel <= tol:
        raise AssertionError(f"{label}: a row {rel} × its (floored) max off its "
                             f"plain version (> {tol})")
    return rel


def check_flash_backward(device) -> dict:
    """The flash backward kernel against `flash_attention_backward_plain`
    at `FLASH_BWD_CASES` (with their windows and softcaps), from the same
    q, k, v, dO (numpy seeds; q scaled as the case says) and the kernel
    forward's own output and log-sum-exp: dq, dk and dv each within
    `LM_TOL` of max |plain|, bfloat16 also row by row within
    `FLASH_ROW_TOL` (`_bwd_row_check`), repeatable, one launch a call on
    the type's route (`bwd_route_counts`).  The forward with the
    log-sum-exp gives the output bit-equal to the inference forward (null
    log-sum-exp), and its log-sum-exp is within `LSE_TOL` of
    `flash_lse_plain`."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_attention_cuda as fac

    rows, worst = [], 0.0
    for i, c in enumerate(x for x in FLASH_CASES if x.label in FLASH_BWD_CASES):
        q, k, v = _flash_inputs(c.b, c.s, c.h, c.kvh, c.d, c.dtype, device,
                                seed=900 + 4 * i, skv=c.skv, q_scale=c.q_scale)
        do = _randn((c.b, c.s, c.h, c.d), 903 + 4 * i, device, c.dtype)
        kw = _flash_kw(c)
        plain_o = fac.flash_attention_cuda(q, k, v, **kw)
        o, lse = fac.flash_attention_cuda(q, k, v, return_lse=True, **kw)
        if not torch.equal(o, plain_o):
            raise AssertionError(f"flash {c.label}: the forward with the log-sum-exp "
                                 f"differs from the inference forward")
        want_lse = fa.flash_lse_plain(q, k, **kw)
        lse_err = float((lse - want_lse).abs().max()) / max(1.0, float(want_lse.abs().max()))
        if not lse_err <= LSE_TOL:
            raise AssertionError(f"flash {c.label}: log-sum-exp {lse_err} off (> {LSE_TOL})")
        before = fac.launch_counts()["flash_attention_backward"]
        routes = fac.bwd_route_counts()
        got = fac.flash_attention_backward_cuda(q, k, v, o, lse, do, **kw)
        again = fac.flash_attention_backward_cuda(q, k, v, o, lse, do, **kw)
        torch.cuda.synchronize()
        if fac.launch_counts()["flash_attention_backward"] != before + 2:
            raise AssertionError("flash_attention_backward launch counter did not advance")
        _check_route(f"flash backward {c.label}", fac, routes, q.dtype, 2,
                     fac.bwd_route_counts)
        want = fa.flash_attention_backward_plain(q, k, v, o, lse, do, **kw)
        row = {"case": c.label, "shape": [c.b, c.s, c.h, c.kvh, c.d], "skv": c.keys,
               "causal": c.causal, "q_offset": c.q_offset, "window": c.window,
               "softcap": c.softcap, "dtype": c.dtype,
               "route": fac.ROUTES[q.dtype][1], "lse_err_over_max": lse_err,
               "tol": LM_TOL[c.dtype]}
        for name, g, w in zip(("dq", "dk", "dv"), got, want):
            err, rel = _rel_check(f"flash backward {c.label} {name}", g, w,
                                  LM_TOL[c.dtype])
            row[name] = {"max_abs_err": err, "err_over_max": rel}
            if c.dtype == "bfloat16":
                row[name]["row_err_over_max"] = _bwd_row_check(
                    f"flash backward {c.label} {name}", g, w, FLASH_ROW_TOL)
            worst = max(worst, err)
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError(f"flash backward {c.label} is not repeatable")
        rows.append(row)
        del q, k, v, do, o, lse, got, again, want, plain_o
        torch.cuda.empty_cache()
    log("parity flash_attention_backward " + json.dumps(rows))
    return {"cases": rows, "max_abs_err": worst}


def check_gmm_backward(device) -> dict:
    """The GMM's autograd on the card (dX and dW through the GMM kernel)
    against autograd of `moe_gmm_plain` on the same inputs (numpy seeds),
    within `LM_TOL`; three launches a forward and backward."""
    import torch
    from repro_torch.kernels import moe_gmm as gmm
    from repro_torch.kernels import moe_gmm_cuda as gmmc

    rows, worst = [], 0.0
    for i, (label, e, n, d, f, dtype) in enumerate(c for c in GMM_CASES
                                                  if c[0] in GMM_BWD_CASES):
        x, w = (t.requires_grad_() for t in _gmm_inputs(e, n, d, f, dtype, device,
                                                        seed=950 + 3 * i))
        dy = _randn((e, n, f), 952 + 3 * i, device, dtype)
        before = gmmc.launch_counts()["moe_gmm"]
        got = torch.autograd.grad(gmm.moe_gmm(x, w), (x, w), dy)
        torch.cuda.synchronize()
        if gmmc.launch_counts()["moe_gmm"] != before + 3:
            raise AssertionError("the GMM's backward did not launch the GMM twice")
        want = torch.autograd.grad(gmm.moe_gmm_plain(x, w), (x, w), dy)
        row = {"case": label, "shape": [e, n, d, f], "dtype": dtype, "tol": LM_TOL[dtype]}
        for name, g, r in zip(("dx", "dw"), got, want):
            err, rel = _rel_check(f"gmm backward {label} {name}", g, r, LM_TOL[dtype])
            row[name] = {"max_abs_err": err, "err_over_max": rel}
            worst = max(worst, err)
        rows.append(row)
    log("parity moe_gmm_backward " + json.dumps(rows))
    return {"cases": rows, "max_abs_err": worst}


def check_lm_on_host(device, archs=(LM_ARCH, "qwen2-72b"), seq: int = 100) -> dict:
    """Reduced LMs in float32 (a VLM's gates at 0.7, so its cross-attention
    counts): forward on 2 × ``seq`` tokens and four decode steps on the
    card, through the kernels, against the port on the host."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models import build_model, encdec

    torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    for arch in archs:
        cfg = dataclasses.replace(get_arch(arch).reduced(), compute_dtype="float32")
        m = build_model(cfg)
        host = _set_gates(m.init(3, device="cpu"), cfg, 0.7)
        card = _set_gates(m.init(3, device="cpu"), cfg, 0.7).to(device)
        toks = torch.from_numpy(np.random.default_rng(5).integers(
            0, cfg.vocab_size, (2, seq)))
        ex_h = _zoo_inputs(cfg, 2, "cpu", seed=6)
        ex_c = {k: v.to(device) for k, v in ex_h.items()}
        errs = [float((m.forward(card, {"tokens": toks.to(device), **ex_c}).cpu()
                       - m.forward(host, {"tokens": toks, **ex_h})).abs().max())]
        if cfg.family == "encdec":
            ex_h = {"memory": encdec.encode(host, ex_h["frames"], cfg)}
            ex_c = {"memory": encdec.encode(card, ex_c["frames"], cfg)}
        cd = lm_cache(cfg, 2, 16, "float32", device)
        ch = lm_cache(cfg, 2, 16, "float32", "cpu")
        for t in range(4):
            a, cd = m.decode_step(card, {"token": toks[:, t:t + 1].to(device), **ex_c},
                                  cd)
            b, ch = m.decode_step(host, {"token": toks[:, t:t + 1], **ex_h}, ch)
            errs.append(float((a.cpu() - b).abs().max()))
        if not max(errs) <= HOST_TOL:
            raise AssertionError(f"{cfg.name}: card vs host port {max(errs)}")
        out[cfg.name] = max(errs)
    log("parity lm_card_vs_host_reduced_f32_max_abs_err " + json.dumps(out))
    return out


def lm_cache(cfg, batch: int, max_len: int, dtype: str, device):
    """A decoder's or Whisper's decode cache in ``dtype``."""
    from repro_torch.models import encdec, transformer

    if cfg.family == "encdec":
        return encdec.init_encdec_cache(cfg, batch, max_len, dtype, device=device)
    return transformer.init_cache(cfg, batch, max_len, dtype, device=device)


def check_prefill_decode(cfg, params, device, seq: int = 128, extras=None,
                         tag: str = "prefill_decode") -> dict:
    """Forward on (1, seq) tokens against feeding them one by one through
    `decode_step`: the last position's logits.  ``extras(c)`` gives the
    forward's and the decode steps' other inputs under config ``c`` (the
    VLM's vision embeddings, Whisper's frames and the memory its encoder
    makes of them in ``c``'s compute type).

    Gated in float32 compute with a float32 cache and, for a MoE, a
    capacity factor of e/k, which drops nothing: at the configured 1.25
    the forward drops an expert's latest tokens once its queue is full,
    while a one-token decode step never drops, so the two paths differ by
    design.  The served configuration (bfloat16, 1.25, bfloat16 cache) is
    read, not gated: there a near-tie in top-k routing can go either way
    in the two paths."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.models import build_model

    torch.backends.cuda.matmul.allow_tf32 = False
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (1, seq))).to(device)
    out = {"tokens": seq}
    over = {"capacity_factor": cfg.num_experts / cfg.top_k} if cfg.num_experts else {}
    f32 = dataclasses.replace(cfg, compute_dtype="float32", **over)
    for label, c, cache_dtype in (("float32_no_drop", f32, "float32"),
                                  ("served_bfloat16", cfg, "bfloat16")):
        m = build_model(c)
        fwd_extra, step_extra = extras(c) if extras else ({}, {})
        full = m.forward(params, {"tokens": toks, **fwd_extra})[:, -1]
        cache = lm_cache(c, 1, seq + 32, cache_dtype, device)
        for t in range(seq):
            logits, cache = m.decode_step(
                params, {"token": toks[:, t:t + 1], **step_extra}, cache)
        out[label] = float((logits - full).abs().max())
        out[label + "_logit_max"] = float(full.abs().max())
        del cache, fwd_extra, step_extra
    if not out["float32_no_drop"] <= CONSISTENCY_TOL:
        raise AssertionError(f"{cfg.name} decode vs forward: {out['float32_no_drop']} "
                             f"(> {CONSISTENCY_TOL})")
    log(tag + " " + json.dumps({"arch": cfg.name, **out}))
    return out


def _serve_prompts(vocab: int, n: int = 8, seed: int = 0) -> list:
    import numpy as np

    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, int(rng.integers(8, 33))).astype(np.int32)
            for _ in range(n)]


def profile_lm(model, params, tokens, device, steps: int = 3, tag: str = "lm_profile",
               kernels: tuple = (), forward_extra=None, decode_extra=None) -> dict:
    """Where the LM path's time goes: one forward on ``tokens`` (with
    ``forward_extra`` in its batch) and ``steps`` decode steps of 4 slots
    (with ``decode_extra``), each under torch.profiler (CUPTI):
    wall ms, device-busy ms (the sum of the kernels' and copies' device
    intervals), launches and the device's idle share, with the kernels
    that took the most device time and, for each name stem in
    ``kernels``, the device ms and share of the kernels whose name holds
    it."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    cache = model.init_cache(4, 512, device=device)
    token = torch.zeros((4, 1), dtype=torch.int32, device=device)

    def decode():
        nonlocal cache
        _, cache = model.decode_step(params, {"token": token, **(decode_extra or {})},
                                     cache)

    out = {}
    batch = {"tokens": tokens, **(forward_extra or {})}
    for label, fn, n in (("forward", lambda: model.forward(params, batch), 1),
                         ("decode_step", decode, steps)):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3 / n
        by_name = {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
        busy = math.fsum(by_name.values()) / 1e3 / n
        launches = sum(1 for e in prof.events() if e.name == "cudaLaunchKernel")
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
        out[label] = {"wall_ms": wall, "device_busy_ms": busy,
                      "idle_share": max(0.0, 1.0 - busy / wall),
                      "launches": launches / n,
                      "top_kernels_ms": [[k[:80], v / 1e3 / n] for k, v in top]}
        for stem in kernels:
            ms = math.fsum(v for k, v in by_name.items() if stem in k) / 1e3 / n
            out[label][stem + "_ms"] = ms
            out[label][stem + "_share"] = ms / busy if busy else 0.0
    log(tag + " " + json.dumps(out))
    return out


def run_lm_path(device, new_tokens: int = 16) -> dict:
    """Granite-MoE at full width and `LM_DEPTH` from the port's own init
    (torch.Generator, seed 0): prefill/decode consistency, then, with every launch count
    zeroed just before and read just after, `Model.forward` on 4 × 1,024
    tokens and a 4-slot `ServeEngine` answering 8 requests; then a
    profiled forward and decode steps (`profile_lm`, not counted)."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models import build_model
    from repro_torch.obs import Observability
    from repro_torch.serving import ServeEngine

    full = get_arch(LM_ARCH)
    cfg = dataclasses.replace(full, **LM_DEPTH)
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init(0, device=device)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in params.parameters())
    consistency = check_prefill_decode(cfg, params, device)
    # Warm-up (not counted): the bfloat16 weight copies and cuBLAS handles.
    model.forward(params, {"tokens": torch.zeros((1, 16), dtype=torch.long,
                                                  device=device)})
    b, s = FORWARD_SHAPE
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (b, s))).to(device)
    torch.cuda.synchronize()

    reset_counts()
    t0 = time.perf_counter()
    logits = model.forward(params, {"tokens": tokens})
    torch.cuda.synchronize()
    forward_s = time.perf_counter() - t0
    fwd = read_counts()
    if logits.shape != (b, s, cfg.vocab_size) or logits.dtype != torch.float32 \
            or not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"forward logits {logits.dtype} {tuple(logits.shape)}")
    if fwd["flash_attention"] != cfg.num_layers or \
            fwd["moe_gmm"] != 3 * cfg.num_layers:
        raise AssertionError(f"forward launches {fwd}")
    fwd_routes = read_routes()
    if fwd_routes["flash_attention"]["bf16_mma"] != fwd["flash_attention"] or \
            fwd_routes["moe_gmm"]["bf16_mma"] != fwd["moe_gmm"]:
        raise AssertionError(f"bfloat16 forward off the tensor-core route: {fwd_routes}")
    del logits

    bundle = Observability(seed=0)
    engine = ServeEngine(model, params, batch_slots=4, max_len=512, obs=bundle,
                         device=device)
    prompts = _serve_prompts(cfg.vocab_size)
    for prompt in prompts:
        engine.submit(prompt, max_new_tokens=new_tokens)
    t0 = time.perf_counter()
    done = engine.run(max_steps=1000)
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    counts = read_counts()
    served = {k: counts[k] - fwd[k] for k in counts}
    stats = engine.stats()
    calls = stats["steps"] + sum(len(p) - 1 for p in prompts)
    # The step counters live in the obs registry (the reference's names).
    obs_steps = bundle.registry.get("serve_steps_total", engine="engine0")
    obs_hist = bundle.registry.hist_stats("serve_step_duration", engine="engine0")
    if not obs_steps == obs_hist["count"] == stats["steps"] > 0:
        raise AssertionError(f"serve_steps_total {obs_steps}, serve_step_duration "
                             f"count {obs_hist['count']}, engine steps {stats['steps']}")
    if len(done) != len(prompts) or any(
            len(r.generated) != new_tokens or not all(0 <= t < cfg.vocab_size
                                                      for t in r.generated)
            for r in done):
        raise AssertionError(f"{len(done)} of {len(prompts)} requests answered")
    if served["moe_gmm"] != 3 * cfg.num_layers * calls or served["moe_gmm"] == 0:
        raise AssertionError(f"serving made {served['moe_gmm']} GMM launches in "
                             f"{calls} decode steps")
    routes = read_routes()
    if routes["moe_gmm"]["bf16_mma"] != counts["moe_gmm"]:
        raise AssertionError(f"bfloat16 serving off the tensor-core route: {routes}")
    if int(engine.cache["layers"]["len"].max()) >= engine.max_len:
        raise AssertionError("the engine ran past max_len")
    del engine
    breakdown = profile_lm(model, params, tokens, device,
                           kernels=("flash_fwd", "moe_gmm"))
    out = {"arch": cfg.name, "params": n_params, "init_s": init_s,
           "reduced": {k: f"{v} of {getattr(full, k)}" for k, v in LM_DEPTH.items()},
           "forward_tokens": [b, s], "forward_s": forward_s,
           "forward_launches": {k: fwd[k] for k in ("flash_attention", "moe_gmm")},
           "requests": len(prompts), "requests_finished": len(done),
           "prompt_tokens": int(sum(len(p) for p in prompts)),
           "tokens_generated": sum(len(r.generated) for r in done),
           "decode_steps": stats["steps"], "decode_step_calls": calls,
           "obs_serve_steps_total": obs_steps,
           "obs_serve_step_duration": {k: obs_hist[k] for k in ("count", "sum")},
           "serve_s": serve_s,
           "tokens_per_s": sum(len(r.generated) for r in done) / serve_s,
           "mean_step_ms": 1e3 * stats["measured_step_s"],
           "serve_launches": {k: served[k] for k in ("flash_attention", "moe_gmm")},
           "launches": counts, "routes": routes, "prefill_decode": consistency,
           "profile": breakdown,
           "peak_memory_gb": torch.cuda.max_memory_allocated(device) / 1e9}
    log("lm_path " + json.dumps(out))
    return out


# -- the SSM and hybrid LM path (Mamba2, Zamba2) ------------------------------------

SSM_ARCHS = ("mamba2-2.7b", "zamba2-1.2b")
# The depth each SSM runs at on the serving path, at full width: every
# decode step's host time grows with the layers (a Mamba2 serving call
# took 93.9 ms at 64 layers and 24.6 ms at 16; NVIDIA H100 80GB HBM3,
# 700 W), and the check of decode against forward feeds 512 tokens one at
# a time twice.  Mamba2 at 4 of 64
# layers; Zamba2 at 8 of 38 (one shared-attention group of 6 and a tail
# of 2, as the full 6 × 6 + 2).
SSM_DEPTH = {"mamba2-2.7b": {"num_layers": 4}, "zamba2-1.2b": {"num_layers": 8}}
SSM_FORWARD_SHAPE = (2, 4096)       # (batch, tokens): 16 chunks of 256
SSM_CONSISTENCY_SEQ = 512           # two chunks, so h_prev is not all zero
SSM_REQUESTS = {"mamba2-2.7b": 8, "zamba2-1.2b": 4}
SSD_CASES = [                       # (label, nc, b, h, p, n, dtype, decay dtype)
    ("mamba2_forward", 16, 2, 80, 64, 128, "float32", "float32"),
    ("zamba2_forward", 16, 2, 64, 64, 64, "float32", "float32"),
    ("ragged", 3, 1, 3, 5, 7, "float32", "float32"),
    ("one_chunk", 1, 2, 80, 64, 128, "float32", "float32"),
    ("bfloat16", 16, 2, 64, 64, 64, "bfloat16", "float32"),
    ("bfloat16_decay", 3, 1, 3, 5, 7, "bfloat16", "bfloat16")]


def _ssd_inputs(nc, b, h, p, n, dtype, ddtype, device, seed):
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    d = rng.uniform(0.3, 1.0, (nc, b, h)).astype(np.float32)
    return (_randn((nc, b, h, p, n), seed, device, dtype),
            torch.from_numpy(d).to(device, getattr(torch, ddtype)))


def check_ssd_scan(device) -> dict:
    """SSD scan kernel vs its plain version, bit for bit (the same float32
    multiply, then add, per chunk, and one rounding to the output type), at
    both path shapes, a ragged shape, one chunk and in bfloat16."""
    import torch
    from repro_torch.kernels import ssd_scan as ss
    from repro_torch.kernels import ssd_scan_cuda as ssc

    rows = []
    for i, (label, nc, b, h, p, n, dtype, ddtype) in enumerate(SSD_CASES):
        s, d = _ssd_inputs(nc, b, h, p, n, dtype, ddtype, device, seed=700 + i)
        before = ssc.launch_counts()["ssd_scan"]
        got = ssc.ssd_scan_cuda(s, d)
        torch.cuda.synchronize()
        if ssc.launch_counts()["ssd_scan"] != before + 1:
            raise AssertionError("ssd_scan launch counter did not advance")
        want = ss.ssd_scan_plain(s, d)
        err = max(float((g.float() - w.float()).abs().max()) for g, w in zip(got, want))
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            raise AssertionError(f"ssd_scan {label}: not bit-equal to its plain "
                                 f"version (max |err| {err})")
        rows.append({"case": label, "shape": [nc, b, h, p, n], "dtype": dtype,
                     "decay_dtype": ddtype, "bit_equal": True, "max_abs_err": err})
    log("parity ssd_scan " + json.dumps(rows))
    return {"cases": rows, "max_abs_err": max(r["max_abs_err"] for r in rows)}


# The scan's backward: (label, nc, b, h, p, n, s dtype, decay dtype,
# g_final given): Mamba2's and Zamba2's training calls (4 × 1,024 tokens,
# chunk 256: 4 chunks; no g_final, as the SSM blocks drop h_final), one
# chunk, a P·N that is not a multiple of 4 (the scalar route), a nonzero
# g_final, and bfloat16 s (with a float32 and a bfloat16 decay).
SSD_BWD_CASES = [
    ("mamba2_train", 4, 4, 80, 64, 128, "float32", "float32", False),
    ("zamba2_train", 4, 4, 64, 64, 64, "float32", "float32", False),
    ("one_chunk", 1, 4, 80, 64, 128, "float32", "float32", True),
    ("ragged", 3, 1, 3, 5, 7, "float32", "float32", True),
    ("mamba2_final", 4, 4, 80, 64, 128, "float32", "float32", True),
    ("bfloat16", 4, 4, 64, 64, 64, "bfloat16", "float32", True),
    ("bfloat16_decay", 3, 1, 3, 5, 7, "bfloat16", "bfloat16", True)]


def _ssd_bwd_inputs(nc, b, h, p, n, dtype, ddtype, final, device, seed):
    """(g_prev, g_final or None, h_prev, decay), h_prev the plain scan's of
    random s."""
    from repro_torch.kernels import ssd_scan as ss

    s, d = _ssd_inputs(nc, b, h, p, n, dtype, ddtype, device, seed)
    hp, _ = ss.ssd_scan_plain(s, d)
    gp = _randn((nc, b, h, p, n), seed + 1, device, dtype)
    gf = _randn((b, h, p, n), seed + 2, device, dtype) if final else None
    return gp, gf, hp, d


def ssd_bwd_bound(nc, b, h, p, n, itemsize, decay_itemsize, final) -> tuple:
    """(bound_ms, bound_by) of the scan's backward: h_prev and g_prev[1:]
    read and ds written, (3·nc − 1) arrays of b·h·p·n elements, g_final
    read when it is given, decay[1:] read and ddecay written; 4 operations
    per state element and chunk (G's multiply and add, ddecay's product and
    sum), 2 at chunk 0, which takes no step of G.  g_prev[0] and decay[0]
    would only feed the zero initial state's gradient: not counted."""
    state = b * h * p * n
    moved = (itemsize * (3 * nc - 1 + int(final)) * state
             + decay_itemsize * (2 * nc - 1) * b * h)
    return bound(moved, (4 * nc - 2) * state)


# The statistical ddecay gate: within DDECAY_SIGMAS·sqrt(P·N)·u·Σ|x| of
# the float64 sum of the same float32 products x = G·h_prev.  Rounding
# errors of a float32 sum in any order grow like sqrt(P·N)·u·|x| when
# they do not line up; the worst case (`ddecay_tolerance`) is P·N·u·Σ|x|.
DDECAY_SIGMAS = 4


def ddecay_tolerance(ds, h_prev, want, ddtype: str):
    """The worst-case ceiling per (chunk, row): a float32 sum of P·N
    products in any order is within (P·N − 1)·u·Σ|x| of the exact sum, so
    two orders within twice that, Σ|x| = Σ|ds·h_prev|; plus one rounding
    of a bfloat16 decay."""
    pn = h_prev.shape[-1] * h_prev.shape[-2]
    tol = 2 * pn * U32 * (ds.double().abs() * h_prev.double().abs()).sum((-2, -1))
    if ddtype == "bfloat16":
        tol = tol + 2.0 ** -8 * want.double().abs()
    return tol + 1e-30


def ddecay_gates(got, want, gp, gf, hp, d, ddtype: str, label: str) -> dict:
    """Hold the kernel's (ds, ddecay) to the plain version's: ds bit-equal,
    ddecay within the worst-case ceiling of the plain sum
    (`ddecay_tolerance`) and within DDECAY_SIGMAS·sqrt(P·N)·u·Σ|x| of the
    float64 sum of the float32 adjoint's products (plus a bfloat16
    ddecay's rounding).  Returns the readings: the kernel's worst error in
    units of sqrt(P·N)·u·Σ|x| (`ddecay_sigmas`; None for a bfloat16
    ddecay, whose rounding is the most of it), and the share of rows
    with a nonzero sum in which a kernel that dropped one warp's partial
    (the row's first 32 threads' products) would fail the statistical gate
    and the ceiling (`fault_caught_share`, `fault_caught_share_ceiling`)."""
    import torch
    from repro_torch.kernels import ssd_scan as ss

    if not torch.equal(got[0], want[0]):
        err = float((got[0].float() - want[0].float()).abs().max())
        raise AssertionError(f"ssd_scan_backward {label}: ds not bit-equal to its "
                             f"plain version (max |err| {err})")
    ceiling = ddecay_tolerance(want[0], hp, want[1], ddtype)
    dd = got[1].double()
    off_plain = (dd - want[1].double()).abs()
    if got[1].dtype != want[1].dtype or not bool((off_plain <= ceiling).all()):
        raise AssertionError(f"ssd_scan_backward {label}: ddecay past its sum ceiling")
    g32 = ss.ssd_scan_backward_plain(gp.float(), None if gf is None else gf.float(),
                                     hp.float(), d.float())[0]
    x = (g32.double() * hp.double()).flatten(-2)
    exact, mag = x.sum(-1), x.abs().sum(-1)
    pn = x.shape[-1]
    unit = pn ** 0.5 * U32 * mag + 1e-30
    limit = DDECAY_SIGMAS * unit
    if ddtype == "bfloat16":
        limit = limit + 2.0 ** -8 * exact.abs()
    err = (dd - exact).abs()
    if not bool((err <= limit).all()):
        raise AssertionError(f"ssd_scan_backward {label}: ddecay "
                             f"{float((err / limit).max())}× its limit off the float64 "
                             f"sum")
    warp = 32 * (4 if pn % 4 == 0 else 1)
    dropped = x[..., :warp].sum(-1).abs()
    live = mag > 0
    n_live = max(int(live.sum()), 1)
    return {"ddecay_max_abs_err": float(off_plain.max()),
            "ddecay_err_over_ceiling": float((off_plain / ceiling).max()),
            "ddecay_sigmas": (None if ddtype == "bfloat16"   # its rounding rules
                              else float((err / unit).max())),
            "ddecay_err_over_limit": float((err / limit).max()),
            "fault_caught_share": int(((dropped > limit) & live).sum()) / n_live,
            "fault_caught_share_ceiling": int(((dropped > ceiling) & live).sum())
            / n_live}


def check_ssd_scan_backward(device) -> dict:
    """The scan's backward kernel against `ssd_scan_backward_plain` at
    `SSD_BWD_CASES`, under `ddecay_gates` (ds bit-equal, ddecay within the
    worst-case ceiling and the statistical limit), both outputs repeatable
    bit for bit (a fixed order of sums, no atomics), one launch a call."""
    import torch
    from repro_torch.kernels import ssd_scan as ss
    from repro_torch.kernels import ssd_scan_cuda as ssc

    rows = []
    for i, (label, nc, b, h, p, n, dtype, ddtype, final) in enumerate(SSD_BWD_CASES):
        gp, gf, hp, d = _ssd_bwd_inputs(nc, b, h, p, n, dtype, ddtype, final, device,
                                        seed=740 + 3 * i)
        before = ssc.launch_counts()["ssd_scan_backward"]
        got = ssc.ssd_scan_backward_cuda(gp, gf, hp, d)
        again = ssc.ssd_scan_backward_cuda(gp, gf, hp, d)
        torch.cuda.synchronize()
        if ssc.launch_counts()["ssd_scan_backward"] != before + 2:
            raise AssertionError("ssd_scan_backward launch counter did not advance")
        want = ss.ssd_scan_backward_plain(gp, gf, hp, d)
        readings = ddecay_gates(got, want, gp, gf, hp, d, ddtype, label)
        if not (torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])):
            raise AssertionError(f"ssd_scan_backward {label} is not repeatable")
        rows.append({"case": label, "shape": [nc, b, h, p, n], "dtype": dtype,
                     "decay_dtype": ddtype, "g_final": final, "ds_bit_equal": True,
                     **readings, "repeatable": True,
                     "max_abs_err": readings["ddecay_max_abs_err"]})
    log("parity ssd_scan_backward " + json.dumps(rows))
    return {"cases": rows, "max_abs_err": max(r["max_abs_err"] for r in rows)}


# The SSD's intra-chunk kernel (`ssd_intra.cu`): (label, b, c, q, h, n),
# p = 64.  Mamba2 2.7B's training call (2 × 2,048 tokens, chunk 256: the
# main path's b·c 16, q 256, h 80), Zamba2 1.2B's state (n 64), the
# reduced configs (chunk 32, n 16) and two sequences shorter than a chunk
# (one chunk of 7 and of 100 positions).
SSD_INTRA_CASES = [("mamba2_train", 2, 8, 256, 80, 128), ("zamba2_train", 2, 8, 256, 64, 64),
                   ("reduced", 2, 4, 32, 4, 16), ("short_7", 1, 1, 7, 4, 16),
                   ("short_100", 2, 1, 100, 8, 128)]
# Normwise errors, max |got − float64| / max |float64|, that the kernel and
# the plain version in float32 must both keep (the card tests' limits):
# float32 sums of up to q·p products in other orders, each weight's expf
# against torch's exp, and the exp(−60) terms the kernel skips above the
# diagonal tiles.  y and dx sum positive-weighted terms; d dt, d cum and
# d cb sum signed products of dw = dy·xᵀ (d cum a difference of two).
SSD_INTRA_TOL = {"y": 1e-5, "dx": 1e-5, "ddt": 1e-4, "dcum": 1e-4, "dcb": 1e-4}


def _ssd_intra_inputs(b, c, q, h, n, device, seed) -> dict:
    """x, dt, cum, cb = C·Bᵀ and the output's gradient dy, float32 on
    ``device``: dt = softplus(z − 1), decay rates from 1e-3 (weights across
    the whole chunk) to 16 (the model's largest, A_log's init)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    dt = np.log1p(np.exp(rng.standard_normal((b, c, q, h)) - 1.0))
    cum = np.cumsum(-(dt * np.exp(np.linspace(np.log(1e-3), np.log(16.0), h))), axis=2)
    cmat = rng.standard_normal((b, c, q, n)) * 0.5
    bmat = rng.standard_normal((b, c, q, n)) * 0.5
    arrays = {"x": rng.standard_normal((b, c, q, h, 64)), "dt": dt, "cum": cum,
              "cb": cmat @ bmat.swapaxes(-1, -2), "dy": rng.standard_normal((b, c, q, h, 64))}
    return {k: torch.from_numpy(v.astype(np.float32)).to(device) for k, v in arrays.items()}


def _normwise(got, want) -> float:
    want = want.double()
    return float((got.double() - want).abs().max() / want.abs().max().clamp_min(1e-300))


def _intra_gate(label: str, names, got, plain32, want) -> dict:
    """Hold each of the kernel's outputs, and the float32 plain version's,
    within `SSD_INTRA_TOL` of the float64 plain version, normwise."""
    import torch

    readings = {}
    for name, g, p32, w in zip(names, got, plain32, want):
        err, err32 = _normwise(g, w), _normwise(p32, w)
        if g.shape != w.shape or g.dtype != torch.float32 or \
                not bool(torch.isfinite(g).all()) or not err <= SSD_INTRA_TOL[name]:
            raise AssertionError(f"ssd_intra {label} {name}: {err} normwise off the "
                                 f"float64 plain version (> {SSD_INTRA_TOL[name]})")
        if not err32 <= SSD_INTRA_TOL[name]:
            raise AssertionError(f"ssd_intra {label} {name}: the float32 plain version "
                                 f"is {err32} off float64: the limit is unfair")
        readings[name] = {"normwise": err, "plain32_normwise": err32,
                          "max_abs_err": float((g.double() - w.double()).abs().max())}
    return readings


def check_ssd_intra(device) -> dict:
    """The intra-chunk kernel (`ssd_intra_cuda`, one launch a call) against
    `ssd_intra_plain` in float64 at `SSD_INTRA_CASES`, within
    `SSD_INTRA_TOL` normwise, as the float32 plain version must be too;
    a second call bit-equal."""
    import torch
    from repro_torch.kernels import ssd_intra as si
    from repro_torch.kernels import ssd_intra_cuda as sic

    torch.backends.cuda.matmul.allow_tf32 = False
    rows = []
    for i, (label, b, c, q, h, n) in enumerate(SSD_INTRA_CASES):
        ins = _ssd_intra_inputs(b, c, q, h, n, device, seed=760 + i)
        args = [ins[k] for k in ("x", "dt", "cum", "cb")]
        before = sic.launch_counts()["ssd_intra"]
        got, again = sic.ssd_intra_cuda(*args), sic.ssd_intra_cuda(*args)
        torch.cuda.synchronize()
        if sic.launch_counts()["ssd_intra"] != before + 2:
            raise AssertionError("ssd_intra launch counter did not advance")
        if not torch.equal(got, again):
            raise AssertionError(f"ssd_intra {label} is not repeatable")
        want = si.ssd_intra_plain(*(t.double() for t in args))
        readings = _intra_gate(label, ("y",), (got,), (si.ssd_intra_plain(*args),), (want,))
        rows.append({"case": label, "shape": [b, c, q, h, 64, n], "repeatable": True,
                     **readings, "max_abs_err": readings["y"]["max_abs_err"]})
        del ins, args, got, again, want
    log("parity ssd_intra " + json.dumps(rows))
    return {"cases": rows, "max_abs_err": max(r["max_abs_err"] for r in rows)}


def check_ssd_intra_backward(device) -> dict:
    """The intra-chunk backward (`ssd_intra_backward_cuda`: dx, d dt, d cum,
    d cb; four kernels, one counted launch a call) against
    `ssd_intra_backward_plain` in float64 at `SSD_INTRA_CASES`, within
    `SSD_INTRA_TOL` normwise, as the float32 plain version must be too;
    a second call bit-equal (no atomics, fixed-order sums)."""
    import torch
    from repro_torch.kernels import ssd_intra as si
    from repro_torch.kernels import ssd_intra_cuda as sic

    torch.backends.cuda.matmul.allow_tf32 = False
    names = ("dx", "ddt", "dcum", "dcb")
    rows = []
    for i, (label, b, c, q, h, n) in enumerate(SSD_INTRA_CASES):
        ins = _ssd_intra_inputs(b, c, q, h, n, device, seed=780 + i)
        args = [ins[k] for k in ("dy", "x", "dt", "cum", "cb")]
        before = sic.launch_counts()["ssd_intra_backward"]
        got = sic.ssd_intra_backward_cuda(*args)
        again = sic.ssd_intra_backward_cuda(*args)
        torch.cuda.synchronize()
        if sic.launch_counts()["ssd_intra_backward"] != before + 2:
            raise AssertionError("ssd_intra_backward launch counter did not advance")
        if not all(torch.equal(g, a) for g, a in zip(got, again)):
            raise AssertionError(f"ssd_intra_backward {label} is not repeatable")
        want = si.ssd_intra_backward_plain(*(t.double() for t in args))
        readings = _intra_gate(label, names, got, si.ssd_intra_backward_plain(*args),
                               want)
        rows.append({"case": label, "shape": [b, c, q, h, 64, n], "repeatable": True,
                     **readings,
                     "max_abs_err": max(r["max_abs_err"] for r in readings.values())})
        del ins, args, got, again, want
    log("parity ssd_intra_backward " + json.dumps(rows))
    return {"cases": rows, "max_abs_err": max(r["max_abs_err"] for r in rows)}


def ssd_intra_bound(b, c, q, h, p, backward: bool) -> tuple:
    """(bound_ms, bound_by) of the intra-chunk kernel, float32: 2·p
    operations a causal (t, s) pair and head forward (w·x), 4·p backward
    (dx and dw); x, dt, cum and cb read and y written once forward, dy,
    x, dt, cum and cb read and dx, d dt, d cum and d cb written once
    backward."""
    from repro_torch.kernels.ssd_intra import causal_pairs

    xs, rows, cbs = b * c * q * h * p, b * c * q * h, b * c * q * q
    ops = (4 if backward else 2) * p * b * c * h * causal_pairs(q)
    moved = 4 * (3 * xs + 4 * rows + 2 * cbs if backward else 2 * xs + 2 * rows + cbs)
    return bound(moved, ops)


def _f32_kv(cache) -> dict:
    """A hybrid cache with float32 K/V (its default is bfloat16 whatever the
    compute type): float32 checks compare the recurrence, not a rounding."""
    if "attn" in cache:
        for k in ("k", "v"):
            cache["attn"][k] = cache["attn"][k].float()
    return cache


def _ssm_configs() -> list:
    import dataclasses

    from repro_torch.configs import get_arch

    return [get_arch("mamba2-2.7b").reduced(),
            dataclasses.replace(get_arch("zamba2-1.2b").reduced(), num_layers=5,
                                shared_attn_every=2)]


def check_ssm_on_host(device) -> dict:
    """Reduced Mamba2, and Zamba2 with 5 layers (two groups and a tail), in
    float32: forward on 2 × 128 tokens (4 chunks) and four decode steps on
    the card, through the scan (and flash) kernels, against the port on
    the host."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.models import build_model

    torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    for cfg in _ssm_configs():
        cfg = dataclasses.replace(cfg, compute_dtype="float32")
        m = build_model(cfg)
        host = m.init(3, device="cpu")
        card = m.init(3, device="cpu").to(device)
        toks = torch.from_numpy(np.random.default_rng(5).integers(
            0, cfg.vocab_size, (2, 128)))
        errs = [float((m.forward(card, {"tokens": toks.to(device)}).cpu()
                       - m.forward(host, {"tokens": toks})).abs().max())]
        cd = _f32_kv(m.init_cache(2, 16, device=device))
        ch = _f32_kv(m.init_cache(2, 16, device="cpu"))
        for t in range(4):
            a, cd = m.decode_step(card, {"token": toks[:, t:t + 1].to(device)}, cd)
            b, ch = m.decode_step(host, {"token": toks[:, t:t + 1]}, ch)
            errs.append(float((a.cpu() - b).abs().max()))
        if not max(errs) <= HOST_TOL:
            raise AssertionError(f"{cfg.name}: card vs host port {max(errs)}")
        out[f"{cfg.name}_{cfg.num_layers}L"] = max(errs)
    log("parity ssm_card_vs_host_reduced_f32_max_abs_err " + json.dumps(out))
    return out


def check_ssm_prefill_decode(cfg, params, device, seq: int = SSM_CONSISTENCY_SEQ
                             ) -> dict:
    """Forward on (1, seq) tokens against feeding them one by one through
    `decode_step`: the last position's logits.  Gated in float32 compute
    (float32 K/V in the hybrid); the served configuration (bfloat16
    compute and K/V) is read, not gated."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.models import build_model

    torch.backends.cuda.matmul.allow_tf32 = False
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (1, seq))).to(device)
    out = {"tokens": seq}
    f32 = dataclasses.replace(cfg, compute_dtype="float32")
    for label, c in (("float32", f32), ("served_bfloat16", cfg)):
        m = build_model(c)
        full = m.forward(params, {"tokens": toks})[:, -1]
        cache = m.init_cache(1, seq + 8, device=device)
        if label == "float32":
            cache = _f32_kv(cache)
        for t in range(seq):
            logits, cache = m.decode_step(params, {"token": toks[:, t:t + 1]}, cache)
        out[label] = float((logits - full).abs().max())
        out[label + "_logit_max"] = float(full.abs().max())
        del cache
    if not out["float32"] <= CONSISTENCY_TOL:
        raise AssertionError(f"{cfg.name} decode vs forward: {out['float32']} "
                             f"(> {CONSISTENCY_TOL})")
    log("ssm_prefill_decode " + json.dumps({"arch": cfg.name, **out}))
    return out


def profile_ssm(cfg, model, params, tokens, device) -> dict:
    """`profile_lm` over one forward and one decode step of an SSM
    (``ssm_profile``: the ssd_scan share of device time) or a hybrid
    (``hybrid_profile``: the ssd_scan and flash shares)."""
    hybrid = bool(cfg.shared_attn_every)
    return profile_lm(model, params, tokens, device, steps=1,
                      tag="hybrid_profile" if hybrid else "ssm_profile",
                      kernels=("ssd_scan", "flash_fwd") if hybrid else ("ssd_scan",))


def run_ssm_path(device, new_tokens: int = 16) -> dict:
    """Mamba2 2.7B, then Zamba2 1.2B, at full width (depth cut as
    `SSM_DEPTH` says) from the port's own init (seed 0; float32 parameters, bfloat16 compute): for
    each, prefill/decode consistency first (not counted), then, with every
    launch count zeroed just before and read just after, `Model.forward` on
    2 × 4,096 tokens (one ssd_scan launch per Mamba block, one flash launch
    per shared-block call) and a 4-slot `ServeEngine`; each is then
    profiled (`profile_ssm`, not counted).  Each model is freed before the
    next is built."""
    import dataclasses
    import gc

    import numpy as np
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models import build_model
    from repro_torch.serving import ServeEngine

    out, launches = {}, {}
    for arch in SSM_ARCHS:
        full = get_arch(arch)
        cfg = dataclasses.replace(full, **SSM_DEPTH[arch])
        model = build_model(cfg)
        torch.cuda.reset_peak_memory_stats(device)
        t0 = time.perf_counter()
        params = model.init(0, device=device)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        n_params = sum(p.numel() for p in params.parameters())
        consistency = check_ssm_prefill_decode(cfg, params, device)
        # Warm-up (not counted): the bfloat16 weight copies and cuBLAS handles.
        model.forward(params, {"tokens": torch.zeros((1, 256), dtype=torch.long,
                                                      device=device)})
        b, s = SSM_FORWARD_SHAPE
        tokens = torch.from_numpy(np.random.default_rng(0).integers(
            0, cfg.vocab_size, (b, s))).to(device)
        torch.cuda.synchronize()
        groups = cfg.num_layers // cfg.shared_attn_every if cfg.shared_attn_every else 0

        reset_counts()
        t0 = time.perf_counter()
        logits = model.forward(params, {"tokens": tokens})
        torch.cuda.synchronize()
        forward_s = time.perf_counter() - t0
        fwd = read_counts()
        if logits.shape != (b, s, cfg.vocab_size) or logits.dtype != torch.float32 \
                or not bool(torch.isfinite(logits).all()):
            raise AssertionError(f"{arch} forward logits {logits.dtype} "
                                 f"{tuple(logits.shape)}")
        if fwd["ssd_scan"] != cfg.num_layers or fwd["ssd_intra"] != cfg.num_layers \
                or fwd["flash_attention"] != groups or fwd["moe_gmm"] != 0:
            raise AssertionError(f"{arch} forward launches {fwd}")
        del logits

        engine = ServeEngine(model, params, batch_slots=4, max_len=512, device=device)
        prompts = _serve_prompts(cfg.vocab_size, n=SSM_REQUESTS[arch])
        for prompt in prompts:
            engine.submit(prompt, max_new_tokens=new_tokens)
        t0 = time.perf_counter()
        done = engine.run(max_steps=1000)
        torch.cuda.synchronize()
        serve_s = time.perf_counter() - t0
        counts = read_counts()
        served = {k: counts[k] - fwd[k] for k in counts}
        stats = engine.stats()
        calls = stats["steps"] + sum(len(p) - 1 for p in prompts)
        if len(done) != len(prompts) or any(
                len(r.generated) != new_tokens or not all(0 <= t < cfg.vocab_size
                                                          for t in r.generated)
                for r in done):
            raise AssertionError(f"{arch}: {len(done)} of {len(prompts)} requests "
                                 f"answered")
        if "attn" in engine.cache and \
                int(engine.cache["attn"]["len"].max()) >= engine.max_len:
            raise AssertionError("the engine ran past max_len")
        del engine
        breakdown = profile_ssm(cfg, model, params, tokens, device)
        generated = sum(len(r.generated) for r in done)
        out[arch] = {
            "arch": cfg.name, "params": n_params, "init_s": init_s,
            "reduced": {k: f"{v} of {getattr(full, k)}"
                        for k, v in SSM_DEPTH[arch].items()},
            "forward_tokens": [b, s], "forward_s": forward_s,
            "forward_launches": {k: fwd[k] for k in ("ssd_scan", "ssd_intra",
                                                     "flash_attention")},
            "requests": len(prompts), "requests_finished": len(done),
            "prompt_tokens": int(sum(len(p) for p in prompts)),
            "tokens_generated": generated, "decode_steps": stats["steps"],
            "decode_step_calls": calls, "serve_s": serve_s,
            "tokens_per_s": generated / serve_s,
            "mean_step_ms": 1e3 * stats["measured_step_s"],
            "serve_launches": {k: served[k] for k in ("ssd_scan", "ssd_intra",
                                                      "flash_attention")},
            "launches": counts, "prefill_decode": consistency,
            "profile": breakdown,
            "peak_memory_gb": torch.cuda.max_memory_allocated(device) / 1e9}
        log("ssm_path " + json.dumps(out[arch]))
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
        del model, params, tokens
        gc.collect()
        torch.cuda.empty_cache()
    out["launches"] = launches
    return out


# -- the rest of the LM zoo (gemma2, the VLM, Whisper) ------------------------------

# Each model at full width (d_model, heads, head_dim, d_ff, vocab as
# configured); depth is the only cut.  Every decode step's host time grows
# with the layers, and each model feeds 2 × 128 tokens one at a time
# (`check_prefill_decode`) before it serves 8 requests, so the depth is
# the least that keeps each model's structure whole.
#   arch → (layer counts replaced, forward batch, forward tokens)
ZOO = {
    # 4 of 46 layers (2 local/global pairs): 3.44 B parameters, 13.8 GB.
    # 6,144 tokens: the local layers' window of 4,096 masks keys for the
    # last 2,048 rows.
    "gemma2-27b": ({"num_layers": 4}, 1, 6144),
    # 1 of 20 groups (4 self- and 1 cross-attention layer of 100): 5.67 B
    # parameters, 22.7 GB; 2,048 tokens over 1,600 vision embeddings.
    "llama-3.2-vision-90b": ({"num_layers": 5}, 1, 2048),
    # 8 of 32 encoder and 8 of 32 decoder layers: 0.48 B parameters;
    # 1,500 frames and the decoder's 448 tokens.
    "whisper-large-v3": ({"num_layers": 8, "encoder_layers": 8}, 2, 448),
}
# The VLM's gates start at zero (as the reference's), which would hide a
# wrong cross-attention: the card's runs set them to this value.
ZOO_GATE = 1.0
# The reduced gemma2 (window 64) at 160 tokens: decode against forward
# where the window masks keys.
ZOO_WINDOW_SEQ = 160


def _set_gates(params, cfg, value: float):
    import torch

    if cfg.cross_attn_every:
        with torch.no_grad():
            for cp in params["cross_layers"]:
                cp["gate"].fill_(value)
    return params


def _zoo_inputs(cfg, b: int, device, seed: int) -> dict:
    """The stub frontend's output in the compute type: vision embeddings
    (b, vision_seq, d_model) or audio frames (b, encoder_seq, d_model)."""
    import torch

    dt = getattr(torch, cfg.compute_dtype)
    if cfg.family == "vlm":
        return {"vision_embeds": _randn((b, cfg.vision_seq, cfg.d_model), seed,
                                        device, "float32").to(dt)}
    if cfg.family == "encdec":
        return {"frames": _randn((b, cfg.encoder_seq, cfg.d_model), seed, device,
                                 "float32").to(dt)}
    return {}


def _zoo_extras(params, cfg, b: int, device, seed: int):
    """``extras(c)`` for `check_prefill_decode`: the forward's and the
    decode steps' frontend inputs under config ``c``."""
    from repro_torch.models import encdec

    def extras(c):
        fwd = _zoo_inputs(c, b, device, seed)
        if c.family == "encdec":
            return fwd, {"memory": encdec.encode(params, fwd["frames"], c)}
        return fwd, dict(fwd)
    return extras


def _cache_lens(cache) -> int:
    if "len" in cache:
        return int(cache["len"].max())
    return max(int(kv["len"].max()) for kv in cache.values())


def _zoo_flash_calls(cfg) -> tuple:
    """Flash launches of one forward and of one decode step."""
    if cfg.family == "encdec":
        return cfg.encoder_layers + 2 * cfg.num_layers, cfg.num_layers
    if cfg.family == "vlm":
        return cfg.num_layers, cfg.num_layers // cfg.cross_attn_every
    return cfg.num_layers, 0


def run_lm_zoo_path(device, new_tokens: int = 16) -> dict:
    """gemma2-27b, llama-3.2-vision-90b and whisper-large-v3 at full width
    (depth cut as `ZOO` says) from the port's own init (seed 0; float32
    parameters, bfloat16 compute; the VLM's gates at `ZOO_GATE`).  For
    each: the reduced model on the card against the host at
    `ZOO_WINDOW_SEQ` tokens (`check_lm_on_host`); decode against forward at 128 tokens
    (`check_prefill_decode`, float32 gated), for gemma2 also the reduced
    model at `ZOO_WINDOW_SEQ` tokens; then, with every launch count zeroed
    just before and read just after, `Model.forward` (every flash launch
    on the bfloat16 tensor-core route, counted per attention call) and a
    4-slot `ServeEngine` answering 8 requests of ``new_tokens`` (the flash
    launches of each decode step counted); then a profiled forward and
    decode step (`profile_lm`, not counted).  Each model is freed before
    the next is built."""
    import dataclasses
    import gc

    import numpy as np
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models import build_model, encdec
    from repro_torch.serving import ServeEngine

    out, launches = {}, {}
    for arch, (cut, b, s) in ZOO.items():
        t_model = time.perf_counter()
        full = get_arch(arch)
        (host_err,) = check_lm_on_host(device, (arch,), ZOO_WINDOW_SEQ).values()
        cfg = dataclasses.replace(full, **cut)
        model = build_model(cfg)
        torch.cuda.reset_peak_memory_stats(device)
        t0 = time.perf_counter()
        params = _set_gates(model.init(0, device=device), cfg, ZOO_GATE)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        n_params = sum(p.numel() for p in params.parameters())
        consistency = {"full": check_prefill_decode(
            cfg, params, device, extras=_zoo_extras(params, cfg, 1, device, seed=2),
            tag="zoo_prefill_decode")}
        if cfg.alt_local_global:
            small = full.reduced()
            consistency["reduced_window"] = check_prefill_decode(
                small, build_model(small).init(1, device=device), device,
                seq=ZOO_WINDOW_SEQ, tag="zoo_prefill_decode")
        fwd_extra = _zoo_inputs(cfg, b, device, seed=3)
        # Warm-up (not counted): the bfloat16 weight copies and cuBLAS handles.
        model.forward(params, {"tokens": torch.zeros((b, 16), dtype=torch.long,
                                                      device=device), **fwd_extra})
        tokens = torch.from_numpy(np.random.default_rng(0).integers(
            0, cfg.vocab_size, (b, s))).to(device)
        torch.cuda.synchronize()
        per_fwd, per_step = _zoo_flash_calls(cfg)

        reset_counts()
        t0 = time.perf_counter()
        logits = model.forward(params, {"tokens": tokens, **fwd_extra})
        torch.cuda.synchronize()
        forward_s = time.perf_counter() - t0
        fwd = read_counts()
        fwd_routes = read_routes()["flash_attention"]
        if logits.shape != (b, s, cfg.vocab_size) or logits.dtype != torch.float32 \
                or not bool(torch.isfinite(logits).all()):
            raise AssertionError(f"{arch} forward logits {logits.dtype} "
                                 f"{tuple(logits.shape)}")
        if fwd["flash_attention"] != per_fwd or fwd["moe_gmm"] or fwd["ssd_scan"] \
                or fwd["ssd_intra"]:
            raise AssertionError(f"{arch} forward launches {fwd}, expected "
                                 f"{per_fwd} flash")
        if fwd_routes["bf16_mma"] != per_fwd:
            raise AssertionError(f"{arch} forward off the tensor-core route: "
                                 f"{fwd_routes}")
        del logits

        serve_extra = _zoo_inputs(cfg, 4, device, seed=4)
        if cfg.family == "encdec":
            serve_extra = {"memory": encdec.encode(params, serve_extra["frames"], cfg)}
        torch.cuda.synchronize()
        before = read_counts()
        engine = ServeEngine(model, params, batch_slots=4, max_len=512,
                             extras=serve_extra, device=device)
        prompts = _serve_prompts(cfg.vocab_size)
        for prompt in prompts:
            engine.submit(prompt, max_new_tokens=new_tokens)
        t0 = time.perf_counter()
        done = engine.run(max_steps=1000)
        torch.cuda.synchronize()
        serve_s = time.perf_counter() - t0
        counts = read_counts()
        served = {k: counts[k] - before[k] for k in counts}
        stats = engine.stats()
        calls = stats["steps"] + sum(len(p) - 1 for p in prompts)
        if len(done) != len(prompts) or any(
                len(r.generated) != new_tokens or not all(0 <= t < cfg.vocab_size
                                                          for t in r.generated)
                for r in done):
            raise AssertionError(f"{arch}: {len(done)} of {len(prompts)} requests "
                                 f"answered")
        if served["flash_attention"] != per_step * calls:
            raise AssertionError(f"{arch}: {served['flash_attention']} flash launches "
                                 f"in {calls} decode steps, expected {per_step} a step")
        if read_routes()["flash_attention"]["bf16_mma"] != counts["flash_attention"]:
            raise AssertionError(f"{arch} serving off the tensor-core route")
        if _cache_lens(engine.cache) >= engine.max_len:
            raise AssertionError("the engine ran past max_len")
        del engine
        breakdown = profile_lm(model, params, tokens, device, steps=1,
                               tag="zoo_profile", kernels=("flash_fwd",),
                               forward_extra=fwd_extra, decode_extra=serve_extra)
        generated = sum(len(r.generated) for r in done)
        reduced = {k: f"{v} of {getattr(full, k)}" for k, v in cut.items()}
        out[arch] = {
            "arch": cfg.name, "reduced": reduced or "none", "params": n_params,
            "init_s": init_s, "card_vs_host_reduced_f32_max_abs_err": host_err,
            "forward_tokens": [b, s], "forward_s": forward_s,
            "forward_flash_launches": fwd["flash_attention"],
            "requests": len(prompts), "requests_finished": len(done),
            "prompt_tokens": int(sum(len(p) for p in prompts)),
            "tokens_generated": generated, "decode_steps": stats["steps"],
            "decode_step_calls": calls, "serve_s": serve_s,
            "tokens_per_s": generated / serve_s,
            "mean_step_ms": 1e3 * stats["measured_step_s"],
            "flash_launches_per_decode_step": served["flash_attention"] / calls,
            "launches": counts, "prefill_decode": consistency, "profile": breakdown,
            "peak_memory_gb": torch.cuda.max_memory_allocated(device) / 1e9,
            "model_s": time.perf_counter() - t_model}
        log("lm_zoo_path " + json.dumps(out[arch]))
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
        del model, params, tokens, fwd_extra, serve_extra
        gc.collect()
        torch.cuda.empty_cache()
    out["launches"] = launches
    return out


# -- the serving driver (launch/serve.py) -----------------------------------------

# The serving driver's runs: arch → None for the driver's own `main` at
# full size, or the zoo's cut (`ZOO`) for a model built here and served
# through `serve.serve`.  Flags: the reference driver's defaults (8
# requests of 16 random tokens, 16 new tokens each, 4 slots, max_len 256).
SERVE_DRIVER = {"granite-moe-1b-a400m": None,
                "whisper-large-v3": ZOO["whisper-large-v3"][0],
                "llama-3.2-vision-90b": ZOO["llama-3.2-vision-90b"][0]}


class _ServedLines(logging.Handler):
    """Keeps the arguments of the serving driver's ``served …`` lines:
    (finished, requests, tokens, seconds, tokens/s)."""

    def __init__(self):
        super().__init__()
        self.served = []

    def emit(self, record):
        if record.getMessage().startswith("served "):
            self.served.append(record.args)


def _serve_calls(args) -> int:
    """Decode-step calls of the engine for the driver's requests, which all
    have the same prompt and new-token counts: each prompt replayed but its
    last token, then waves of ``slots`` requests that finish together
    after ``max_new`` steps."""
    waves = -(-args.requests // args.slots)
    return args.requests * (args.prompt_len - 1) + waves * args.max_new


def _serve_launches_per_call(cfg) -> dict:
    """Kernel launches of one decode step: flash's (`_zoo_flash_calls`) and
    the MoE's three expert products a layer."""
    per_call = {"flash_attention": _zoo_flash_calls(cfg)[1]}
    if cfg.family == "moe":
        per_call["moe_gmm"] = 3 * cfg.num_layers
    return per_call


def run_serve_driver_path(device) -> dict:
    """The serving driver, `repro_torch.launch.serve`, as a user runs it:
    `main` for Granite-MoE at full size, and `serve` for Whisper and the
    VLM at the zoo's cuts (8 + 8 of 32 + 32 and 5 of 100 layers), each
    from the port's own init (seed 0) with the driver's zero extras.  Each
    run with every launch count zeroed just before it and read just after;
    gates: every request
    answered with ``max_new`` tokens in the vocabulary, the driver's
    ``served`` line saying so, each kernel's launches
    `_serve_launches_per_call` times `_serve_calls` (every other kernel
    none), flash on the bfloat16 tensor-core route.  Reports the driver's
    own tokens/s beside the run's wall time."""
    import dataclasses
    import gc

    import torch
    from repro_torch.configs import get_arch
    from repro_torch.launch import serve
    from repro_torch.models import build_model

    handler = _ServedLines()
    logger = logging.getLogger("repro.serve")
    logger.addHandler(handler)
    out, launches = {}, {}
    try:
        for arch, cut in SERVE_DRIVER.items():
            argv = ["--arch", arch, "--device", str(device)]
            args = serve.parse_args(argv)
            cfg = dataclasses.replace(get_arch(arch), **(cut or {}))
            model = params = None
            if cut is not None:
                model = build_model(cfg)
                params = model.init(args.seed, device=device)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(device)
            reset_counts()
            t0 = time.perf_counter()
            done = serve.main(argv) if cut is None else serve.serve(model, params, args)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts, routes = read_counts(), read_routes()
            finished, requests, tokens, seconds, rate = handler.served[-1]
            if len(done) != args.requests or not finished == requests == args.requests or any(
                    len(r.generated) != args.max_new
                    or not all(0 <= t < cfg.vocab_size for t in r.generated)
                    for r in done):
                raise AssertionError(f"serve driver {arch}: {len(done)} of "
                                     f"{args.requests} requests answered")
            calls = _serve_calls(args)
            want = {k: v * calls for k, v in _serve_launches_per_call(cfg).items()}
            if counts != {k: want.get(k, 0) for k in counts}:
                raise AssertionError(f"serve driver {arch}: launches {counts} in {calls} "
                                     f"decode steps, expected {want}")
            if routes["flash_attention"]["bf16_mma"] != counts["flash_attention"]:
                raise AssertionError(f"serve driver {arch} off the tensor-core route: "
                                     f"{routes['flash_attention']}")
            reduced = {k: f"{v} of {getattr(get_arch(arch), k)}" for k, v in
                       (cut or {}).items()}
            out[arch] = {
                "arch": cfg.name, "entry": "main" if cut is None else "serve",
                "reduced": reduced or "none", "requests": args.requests,
                "requests_finished": finished, "tokens_generated": tokens,
                "decode_step_calls": calls, "serve_s": seconds, "tokens_per_s": rate,
                "wall_s": wall, "launches": counts,
                "peak_memory_gb": torch.cuda.max_memory_allocated(device) / 1e9}
            log("serve_driver " + json.dumps(out[arch]))
            for k, v in counts.items():
                launches[k] = launches.get(k, 0) + v
            del model, params, done
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        logger.removeHandler(handler)
    out["launches"] = launches
    return out


# -- the LM training path (Granite-MoE, Mamba2, Zamba2, gemma2, Whisper, VLM) ----

TRAIN_SHAPE = (4, 1024)             # (batch, tokens) of a training step
TRAIN_STEPS = 8
# The models trained after Granite, each at full width from the port's own
# init: arch → (config fields replaced, (batch, tokens), the cut listed in
# its ``reduced`` field).  Mamba2 at 16 of 64 layers (0.77 B parameters)
# and Zamba2 at 14 of 38 (two shared-attention groups and a tail, 0.49 B):
# at full depth their 8 steps took 34.4 and 20.2 s of the script's time,
# at these 8.7 and 8.1 s (NVIDIA H100 80GB HBM3, 700 W); gemma2
# at one local/global pair (2 of 46 layers: 2.31 B parameters, 37 GB of
# state) on 4,608 tokens, so that the local layer's window of 4,096 hides
# keys from the last 512 rows.  Its loss holds several float32 buffers of
# tokens × 256,000 logits at once (capped, tanh, their gradients): at
# 6,144 tokens (5.86 GiB each) the first backward ran out of the card's
# 80 GB with 66.4 GiB allocated (NVIDIA H100 80GB HBM3, 700 W).  Whisper
# at the zoo's depth (8 of 32 encoder and 8 of 32 decoder layers: 0.48 B
# parameters; 26.4 s at full depth) on 4 × 448 tokens over 4 × 1,500
# frames.  The VLM at one
# self- and one cross-attention layer (the reference's own `reduced()`
# takes cross_attn_every 2): one published group of 4 self layers and a
# cross layer with the 2.10 B-parameter embedding and head is 5.67 B
# parameters, 91 GB of state, past the card; this cut is 3.11 B, 50 GB.
# Its gates start at zero, where the cross-attention's backward would
# receive dO = 0 and hide a fault: they are set to `ZOO_GATE`.  The last
# field is the peak learning rate.  The VLM's is 1e-5: at 8,192 wide,
# AdamW's first steps (about ±lr on every element, two warm-up steps)
# threw its loss from 18.2 to 45–156 at peaks of 2e-5 to 3e-4 and it had
# not come back below the first step's by step 8 (`train_model` at those
# peaks on an NVIDIA H100 80GB HBM3, 700 W).  The reference's own train
# step does the same when the rate is too large for the width, and the
# port's step follows it through the rise
# (tests/test_torch_train.py::test_wide_vlm_loss_rise_at_a_large_rate_is_the_references).
TRAIN_MODELS = {
    "mamba2-2.7b": ({"num_layers": 16}, (4, 1024), "num_layers 16 of 64", 3e-4),
    "zamba2-1.2b": ({"num_layers": 14}, (4, 1024), "num_layers 14 of 38", 3e-4),
    "gemma2-27b": ({"num_layers": 2}, (1, 4608),
                   "num_layers 2 of 46 (one local/global pair); 4,608 tokens "
                   "(6,144 ran out of memory)", 3e-4),
    "whisper-large-v3": (ZOO["whisper-large-v3"][0], (4, 448),
                         "num_layers 8 of 32, encoder_layers 8 of 32", 3e-4),
    "llama-3.2-vision-90b": ({"num_layers": 2, "cross_attn_every": 2}, (2, 2048),
                             "num_layers 2 of 100, cross_attn_every 2 of 5 (one self "
                             "and one cross layer: 100 layers do not fit one card); "
                             "gates set to 1.0 (zero at init)", 1e-5),
}
TRAIN_KW = dict(base_lr=3e-4, warmup_steps=2, total_steps=TRAIN_STEPS)
# The repeat gate: each trained model rebuilt from the same seed takes its
# first steps again on the same batches; losses, grad norms and every
# parameter leaf's checksum must equal the first run's bit for bit (the
# reference's jitted step repeats; an atomic add in a backward does not).
REPEAT_STEPS = 3
# The card-against-host, microbatch and resume checks: Granite at full
# width, 2 of 24 layers, float32 compute, batches of 2 × 128 tokens.
HOST_TRAIN_LAYERS = 2
HOST_TRAIN_SHAPE = (2, 128)
# The reduced models of the zoo held card against host in training, and
# the VLM's gates there (zero at init, as the reference's; the host tests
# set 0.7).
HOST_TRAIN_ZOO = ("llama-3.2-vision-90b", "whisper-large-v3")
HOST_GATE = 0.7
# AdamW divides each element's first moment by the root of its second:
# an element whose gradient is float32 noise (zero in exact arithmetic, as
# a key bias's, or cancelling to near zero) takes a step of up to about
# ±lr from the sign of that noise on either device.  Such elements may
# differ by up to 3 × the learning rate and be at most this share of
# them; every other element is held to `HOST_TOL`
# (tests/test_torch_train.py holds the same rule on the host).
NOISE_SHARE = 1e-4
# The same step with the flash backward's bfloat16 route on the CUDA cores
# (NVIDIA H100 80GB HBM3, 700 W; PERF.md §6), reported beside this run's.
CUDA_CORE_BWD_STEP = {"median_step_ms": 429.1, "flash_bwd_ms": 25.9,
                      "flash_bwd_share": 0.072}


def _plain_counters():
    """Patch the plain versions of flash attention (forward, log-sum-exp,
    backward), the GMM, the SSD scan and the SSD's intra-chunk output
    (forward, backward) to count their calls; returns the counts and a
    function that restores them."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import moe_gmm as gmm

    from repro_torch.kernels import ssd_intra as si
    from repro_torch.kernels import ssd_scan as ss

    names = [(fa, "flash_attention_plain"), (fa, "flash_lse_plain"),
             (fa, "flash_attention_backward_plain"), (gmm, "moe_gmm_plain"),
             (ss, "ssd_scan_plain"), (ss, "ssd_scan_backward_plain"),
             (si, "ssd_intra_plain"), (si, "ssd_intra_backward_plain")]
    counts = {n: 0 for _, n in names}
    originals = [(m, n, getattr(m, n)) for m, n in names]

    def counted(name, fn):
        def call(*a, **k):
            counts[name] += 1
            return fn(*a, **k)
        return call

    for m, n, fn in originals:
        setattr(m, n, counted(n, fn))

    def restore():
        for m, n, fn in originals:
            setattr(m, n, fn)
    return counts, restore


def _train_data(cfg, b: int, s: int, seed: int):
    """The training driver's data: `SyntheticLMData` with the VLM's vision
    embeddings or Whisper's frames (float32, as the reference's driver)."""
    from repro_torch.data import SyntheticLMData

    return SyntheticLMData(
        vocab_size=cfg.vocab_size, seq_len=s, global_batch=b, seed=seed,
        with_vision=cfg.vision_seq if cfg.family == "vlm" else 0,
        with_frames=cfg.encoder_seq if cfg.family == "encdec" else 0,
        d_model=cfg.d_model)


def _torch_batch(batch: dict, device) -> dict:
    import torch

    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def _train_profile(step_fn, state, batch, device) -> tuple:
    """One training step under torch.profiler: wall ms, device-busy ms, idle
    share, launches, the top kernels and the flash-backward, flash-forward,
    GMM and SSD scan (backward, forward) shares of device time; returns
    (profile, state after)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch)
        float(metrics["loss"])
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    busy = math.fsum(by_name.values()) / 1e3
    out = {"wall_ms": wall, "device_busy_ms": busy,
           "idle_share": max(0.0, 1.0 - busy / wall),
           "launches": sum(1 for e in prof.events() if e.name == "cudaLaunchKernel"),
           "top_kernels_ms": [[k[:80], v / 1e3] for k, v in
                              sorted(by_name.items(), key=lambda kv: -kv[1])[:8]]}
    for stem in ("flash_bwd", "flash_fwd", "moe_gmm", "ssd_scan_bwd", "ssd_scan_vec4"):
        ms = math.fsum(v for k, v in by_name.items() if stem in k) / 1e3
        out[stem + "_ms"] = ms
        out[stem + "_share"] = ms / busy if busy else 0.0
    # torch's own gather, scatter and index kernels (the MoE dispatch and
    # combine, the loss's gather, the embedding's backward), each instance.
    out["indexing_kernels_ms"] = [[k[:160], v / 1e3] for k, v in by_name.items()
                                  if any(w in k for w in ("scatter", "gather", "index",
                                                          "embedding"))]
    return out, state


def _leaf_checksums(params) -> dict:
    """Per parameter leaf, [sum, sum of squares] of its words viewed as
    integers, in int64 (wrapping, so the order of the adds does not
    matter): one changed bit anywhere changes the sum."""
    import torch
    from repro_torch.utils.tree import flatten_with_paths

    words = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    out = {}
    for key, leaf in flatten_with_paths(params).items():
        flat = leaf.detach().reshape(-1).view(words[leaf.element_size()])
        acc = torch.zeros(2, dtype=torch.long, device=flat.device)
        for part in flat.split(1 << 24):
            part = part.long()
            acc += torch.stack([part.sum(), (part * part).sum()])
        out[key] = acc.tolist()
    return out


def _repeat_run(cfg, data, device, steps: int, base_lr: float, first: dict) -> dict:
    """``cfg`` rebuilt and initialised from seed 0 as in `train_model`, its
    first `REPEAT_STEPS` steps taken again on the same batches; ``first``
    holds the first run's losses, grad norms and `_leaf_checksums` after
    that step.  ``equal`` when all of them match bit for bit."""
    from repro_torch.distributed import init_train_state, make_train_step
    from repro_torch.models import build_model

    model = build_model(cfg)
    state = init_train_state(model, 0, device=device)
    _set_gates(state.params, cfg, ZOO_GATE)
    step_fn = make_train_step(model, **dict(TRAIN_KW, total_steps=steps, base_lr=base_lr))
    losses, norms = [], []
    for i in range(REPEAT_STEPS):
        state, metrics = step_fn(state, _torch_batch(data.batch_at(i), device))
        losses.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))
    sums = _leaf_checksums(state.params)
    differ = [k for k, v in sums.items() if v != first["checksums"].get(k)]
    return {"steps": REPEAT_STEPS, "losses": losses, "grad_norms": norms,
            "leaves": len(sums), "leaves_differing": len(differ),
            "first_differing": differ[:4],
            "equal": (losses == first["losses"] and norms == first["grad_norms"]
                      and not differ and sums.keys() == first["checksums"].keys())}


def _close_states(label, got, want, lr: float) -> dict:
    """Loss-free comparison of two train states (one moved to the host):
    AdamW's moments within `HOST_TOL` of their largest value, the
    parameters within `HOST_TOL` but for `NOISE_SHARE` of AdamW's
    noise-normalized elements (each within 3 × lr)."""
    from repro_torch.utils.tree import flatten_with_paths

    out = {}
    for name in ("mu", "nu"):
        g, w = getattr(got.opt, name), getattr(want.opt, name)
        scale = max(float(t.abs().max()) for t in w.values())
        err = max(float((g[k].cpu() - w[k].cpu()).abs().max()) for k in w)
        if not err <= HOST_TOL * scale:
            raise AssertionError(f"{label}: AdamW {name} {err} off (> {HOST_TOL} × {scale})")
        out[name + "_err_over_max"] = err / scale
    gp, wp = flatten_with_paths(got.params), flatten_with_paths(want.params)
    total = noisy = 0
    worst = 0.0
    for k, w in wp.items():
        d = (gp[k].detach().cpu() - w.detach().cpu()).abs()
        worst = max(worst, float(d.max()))
        total += d.numel()
        noisy += int((d > HOST_TOL).sum())
    if worst > 3 * lr or noisy > NOISE_SHARE * total:
        raise AssertionError(f"{label}: parameters {worst} off, {noisy} of {total} "
                             f"elements past {HOST_TOL}")
    out.update({"params_max_abs_err": worst, "params_past_tol": noisy,
                "params": total})
    return out


def _copy_state(state, device):
    """A train state with every tensor copied onto ``device``."""
    from repro_torch.utils.tree import map_with_paths

    return map_with_paths(lambda _, t: t.detach().to(device, copy=True), state)


def check_train_on_host(device) -> dict:
    """Granite at full width and `HOST_TRAIN_LAYERS` layers, float32 compute:
    one train step (lr 3e-4 from step 0) on the card through the kernels
    and on the host through the plain versions, from one state; then, on
    the card, microbatches=2 against the mean of the halves' gradients,
    two compressed steps, and a checkpoint at step 2 restored into a fresh
    state and continued two steps beside the uninterrupted run; last, the
    reduced VLM (gates `HOST_GATE`) and Whisper one step each, card against
    host (`_one_step_card_vs_host`)."""
    import dataclasses
    import shutil

    import torch
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_arch
    from repro_torch.data import SyntheticLMData
    from repro_torch.distributed import init_train_state, make_train_step
    from repro_torch.distributed.compression import compression_error
    from repro_torch.distributed.trainstep import train_state_for
    from repro_torch.models import build_model
    from repro_torch.optim.adamw import global_norm
    from repro_torch.utils.tree import flatten_with_paths

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_arch(LM_ARCH), num_layers=HOST_TRAIN_LAYERS,
                              compute_dtype="float32")
    model = build_model(cfg)
    b, s = HOST_TRAIN_SHAPE
    data = SyntheticLMData(vocab_size=cfg.vocab_size, seq_len=s, global_batch=b, seed=1)
    host_batch = _torch_batch(data.batch_at(0), "cpu")
    batch = _torch_batch(data.batch_at(0), device)
    kw = dict(base_lr=3e-4, warmup_steps=0, total_steps=10)
    host = init_train_state(model, 0, device="cpu")
    card = _copy_state(host, device)
    step = make_train_step(model, **kw)
    card, cm = step(card, batch)
    host, hm = step(host, host_batch)
    out = {"arch": cfg.name, "reduced": f"num_layers {HOST_TRAIN_LAYERS} of 24",
           "compute_dtype": "float32", "tokens": [b, s]}
    for key in ("loss", "grad_norm", "nll", "aux"):
        rel = abs(float(cm[key]) - float(hm[key])) / max(abs(float(hm[key])), 1e-30)
        if not rel <= HOST_TOL:
            raise AssertionError(f"train step card vs host: {key} {rel} off (> {HOST_TOL})")
        out[key + "_rel_err"] = rel
    out.update(_close_states("train step card vs host", card, host, kw["base_lr"]))

    # Microbatches: the accumulated gradient is the mean of the halves'.
    fresh = _copy_state(init_train_state(model, 0, device="cpu"), device)
    mb_state, mb_metrics = make_train_step(model, microbatches=2, **kw)(
        _copy_state(fresh, device), batch)
    leaves = flatten_with_paths(fresh.params)
    want = {k: torch.zeros_like(p) for k, p in leaves.items()}
    for half in ({k: v[:b // 2] for k, v in batch.items()},
                 {k: v[b // 2:] for k, v in batch.items()}):
        loss, _ = model.loss(fresh.params, half)
        for k, g in zip(leaves, torch.autograd.grad(loss, list(leaves.values()))):
            want[k] += g / 2
    norm = float(global_norm(want))
    clip = min(1.0, 1.0 / norm)
    scale = max(float(g.abs().max()) for g in want.values())
    mb_err = max(float((mb_state.opt.mu[k] / 0.1 / clip - g).abs().max())
                 for k, g in want.items()) / scale
    norm_err = abs(float(mb_metrics["grad_norm"]) - norm) / norm
    if not (mb_err <= LM_TOL["float32"] and norm_err <= LM_TOL["float32"]):
        raise AssertionError(f"microbatches=2: gradient {mb_err}, norm {norm_err} off "
                             f"the halves' mean (> {LM_TOL['float32']})")
    out["microbatch_grad_err_over_max"] = mb_err
    out["microbatch_grad_norm_rel_err"] = norm_err
    del mb_state

    # Two compressed steps, and one round's compression error.
    comp_state = train_state_for(_copy_state(fresh.params, device), compression=True)
    grads = dict(zip(leaves, torch.autograd.grad(model.loss(fresh.params, batch)[0],
                                                 list(leaves.values()))))
    out["compression_error"] = float(compression_error(grads, comp_state.comp))
    del grads
    comp_step = make_train_step(model, compression=True, **kw)
    comp_losses = []
    for i in range(2):
        comp_state, m = comp_step(comp_state, _torch_batch(data.batch_at(i), device))
        comp_losses.append(float(m["loss"]))
        if not (math.isfinite(float(m["loss"])) and math.isfinite(float(m["grad_norm"]))):
            raise AssertionError(f"compressed step {i}: {m}")
    out["compressed_losses"] = comp_losses
    del comp_state

    # Checkpoint at step 2, restored into a fresh state, continued.
    batches = [_torch_batch(data.batch_at(i), device) for i in range(4)]
    whole, losses = _copy_state(fresh, device), []
    for bt in batches:
        whole, m = step(whole, bt)
        losses.append(float(m["loss"]))
    part = _copy_state(fresh, device)
    for bt in batches[:2]:
        part, _ = step(part, bt)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        ckpt = CheckpointManager(tmp)
        ckpt.save(2, part, {"arch": cfg.name})
        ckpt.wait()
        restored, meta = ckpt.restore(target=_copy_state(
            init_train_state(model, 7, device="cpu"), device))
        ckpt.close()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    saved, back = flatten_with_paths(part), flatten_with_paths(restored)
    if meta["step"] != 2 or sorted(saved) != sorted(back) or not all(
            torch.equal(saved[k], back[k]) and saved[k].device == back[k].device
            for k in saved):
        raise AssertionError("the restored state differs from the saved one")
    resumed = []
    for bt in batches[2:]:
        restored, m = step(restored, bt)
        resumed.append(float(m["loss"]))
    resume_err = max(abs(a - w) / abs(w) for a, w in zip(resumed, losses[2:]))
    if not resume_err <= HOST_TOL:
        raise AssertionError(f"resumed losses {resumed} against {losses[2:]}")
    out.update({"uninterrupted_losses": losses, "resumed_losses": resumed,
                "resume_loss_rel_err": resume_err, "checkpoint_arrays": len(saved)})

    # The reduced VLM and Whisper: one step each, card against host.
    out["zoo"] = {arch: _one_step_card_vs_host(get_arch(arch).reduced(), device, seed=3)
                  for arch in HOST_TRAIN_ZOO}
    log("train_card_vs_host " + json.dumps(out))
    return out


def _one_step_card_vs_host(cfg, device, seed: int) -> dict:
    """``cfg`` in float32 compute (the VLM's gates at `HOST_GATE`): one
    train step (lr 3e-4 from step 0) on the card through the kernels and
    on the host through the plain versions, from one state, on
    `_train_data` batches of `HOST_TRAIN_SHAPE`; loss and grad norm
    within `HOST_TOL`, the states by `_close_states`; the card's launches
    `_expected_train_launches` (every other kernel none)."""
    import dataclasses

    import torch
    from repro_torch.distributed import init_train_state, make_train_step
    from repro_torch.models import build_model

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(cfg, compute_dtype="float32")
    model = build_model(cfg)
    b, s = HOST_TRAIN_SHAPE
    data = _train_data(cfg, b, s, seed=seed)
    kw = dict(base_lr=3e-4, warmup_steps=0, total_steps=10)
    host = init_train_state(model, 0, device="cpu")
    _set_gates(host.params, cfg, HOST_GATE)
    card = _copy_state(host, device)
    step = make_train_step(model, **kw)
    reset_counts()
    card, cm = step(card, _torch_batch(data.batch_at(0), device))
    torch.cuda.synchronize()
    counts = read_counts()
    host, hm = step(host, _torch_batch(data.batch_at(0), "cpu"))
    want = _expected_train_launches(cfg)
    if counts != {k: want.get(k, 0) for k in counts}:
        raise AssertionError(f"{cfg.name}: training launches {counts}, expected {want}")
    row = {"arch": cfg.name, "num_layers": cfg.num_layers, "compute_dtype": "float32",
           "tokens": [b, s], "launches": counts}
    for key in ("loss", "grad_norm"):
        rel = abs(float(cm[key]) - float(hm[key])) / max(abs(float(hm[key])), 1e-30)
        if not rel <= HOST_TOL:
            raise AssertionError(f"{cfg.name} train step card vs host: {key} {rel} "
                                 f"off (> {HOST_TOL})")
        row[key + "_rel_err"] = rel
    row.update(_close_states(f"{cfg.name} train step card vs host", card, host,
                             kw["base_lr"]))
    return row


def check_ssm_train_on_host(device) -> dict:
    """Reduced Mamba2 and a 5-layer Zamba2 (two groups and a tail), float32
    compute, remat: one train step on the card and on the host
    (`_one_step_card_vs_host`: 2 scans and 1 scan backward a layer)."""
    out = {f"{cfg.name}_{cfg.num_layers}L": _one_step_card_vs_host(cfg, device, seed=2)
           for cfg in _ssm_configs()}
    log("ssm_train_card_vs_host " + json.dumps(out))
    return out


def check_no_grad_through_kernels(device) -> dict:
    """Winograd and the tree kernels have no backward: a gradient asked
    through them on the card must raise, not cut the graph silently
    (`_build.refuse_grad`); without a gradient they run.  The int8 GEMM's
    operands are integers, which cannot require a gradient (torch refuses
    it); its dispatcher refuses one all the same."""
    import numpy as np
    import torch
    from repro_torch.core.predictors import GBDTPredictor
    from repro_torch.kernels import ops
    from repro_torch.kernels import tree_gather as tg

    out = {}

    def refused(label, fn):
        try:
            fn()
        except RuntimeError as e:
            if "no backward" not in str(e):
                raise
            out[label] = f"raised: {e}"[:200]
        else:
            raise AssertionError(f"{label} with a gradient launched on the card")

    x = _randn((1, 8, 8, 16), 990, device, "float32").requires_grad_()
    wt = _randn((3, 3, 16, 16), 991, device, "float32")
    refused("winograd_conv2d_with_grad", lambda: ops.winograd_conv2d(x, wt))
    rng = np.random.default_rng(992)
    feats = np.abs(rng.standard_normal((400, N_FEATURES)))
    gbdt = GBDTPredictor(n_stages=10, max_depth=3).fit(feats, feats @ rng.random(N_FEATURES))
    db = gbdt.flat().device_bank(device)
    mean, std = tg.to_device_scaler(gbdt.scaler, device)
    kind, scale, bias = gbdt._device_reduction()
    xr = torch.rand(5, N_FEATURES, device=device, requires_grad=True)
    refused("tree_predict_fused_with_grad",
            lambda: db.fused(mean, std, scale, bias, xr, kind))
    refused("tree_gather_leaves_with_grad",
            lambda: db.gather_leaves((xr - mean) / std))
    try:
        torch.zeros(4, dtype=torch.int8, device=device).requires_grad_()
    except RuntimeError as e:
        out["int8_operand_with_grad"] = f"raised: {e}"[:200]
    else:
        raise AssertionError("an int8 tensor took requires_grad")
    with torch.no_grad():
        ops.winograd_conv2d(x, wt)
        db.fused(mean, std, scale, bias, xr, kind)
    log("no_grad_guard " + json.dumps(out))
    return out


def _expected_train_launches(cfg) -> dict:
    """Launches a training step (remat): flash forward 2 and backward 1
    per attention call (a decoder layer, a VLM cross layer, a shared-block
    call; Whisper's encoder layers one each, its decoder layers two:
    self- and cross-attention), the GMM 6 + 6 per MoE layer, the scan and
    the intra-chunk output 2 each and their backwards 1 each per Mamba2
    layer; none elsewhere."""
    n = cfg.num_layers
    if cfg.family == "encdec":
        calls = cfg.encoder_layers + 2 * n
        return {"flash_attention": 2 * calls, "flash_attention_backward": calls}
    ssd = {"ssd_scan": 2 * n, "ssd_scan_backward": n,
           "ssd_intra": 2 * n, "ssd_intra_backward": n}
    if cfg.family == "ssm":
        return ssd
    if cfg.family == "hybrid":
        calls = n // cfg.shared_attn_every
        return {**ssd, "flash_attention": 2 * calls, "flash_attention_backward": calls}
    want = {"flash_attention": 2 * n, "flash_attention_backward": n}
    if cfg.family == "moe":
        want["moe_gmm"] = 12 * n
    return want


def train_model(cfg, shape, device, steps: int = TRAIN_STEPS, reduced: str = "none",
                base_lr: float = TRAIN_KW["base_lr"]) -> dict:
    """``cfg`` trained from the port's own init (seed 0; float32 parameters
    and AdamW state, bfloat16 compute, remat): with every launch count
    zeroed just before and read just after, ``steps`` `make_train_step`
    steps (`TRAIN_KW` with the peak ``base_lr``) on `_train_data(seed=0)`
    batches of ``shape`` (the VLM's gates
    at `ZOO_GATE`); gates: finite
    losses and grad norms, the last quarter's mean loss below the first
    step's, each kernel's launches equal to `_expected_train_launches`
    times the steps (every other kernel none), flash on the bfloat16
    tensor-core routes, no plain version called.  Then one profiled step
    (not counted), and the repeat (`_repeat_run`, not counted): the model
    rebuilt from seed 0 and its first `REPEAT_STEPS` steps taken again,
    their result as ``repeat`` (its ``equal`` is gated by the caller).
    Returns the run's line (also logged as ``lm_train_path``) with its
    launches; frees the model."""
    import gc
    import statistics

    import torch
    from repro_torch.distributed import init_train_state, make_train_step
    from repro_torch.models import build_model
    from repro_torch.utils.tree import tree_num_params

    model = build_model(cfg)
    resident = torch.cuda.memory_allocated(device) / 1e9
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    state = init_train_state(model, 0, device=device)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    _set_gates(state.params, cfg, ZOO_GATE)
    b, s = shape
    data = _train_data(cfg, b, s, seed=0)
    step_fn = make_train_step(model, **dict(TRAIN_KW, total_steps=steps, base_lr=base_lr))
    plain, restore = _plain_counters()
    try:
        reset_counts()
        losses, norms, lrs, step_s = [], [], [], []
        for i in range(steps):
            batch = _torch_batch(data.batch_at(i), device)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, metrics = step_fn(state, batch)
            losses.append(float(metrics["loss"]))
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
            norms.append(float(metrics["grad_norm"]))
            lrs.append(float(metrics["lr"]))
            if i == REPEAT_STEPS - 1:
                checksums = _leaf_checksums(state.params)
        counts, routes = read_counts(), read_routes()
    finally:
        restore()
    if any(plain.values()):
        raise AssertionError(f"{cfg.name}: plain versions called on the card's path: "
                             f"{plain}")
    if not all(math.isfinite(x) for x in losses + norms):
        raise AssertionError(f"{cfg.name}: non-finite training: losses {losses}, "
                             f"norms {norms}")
    last = statistics.mean(losses[-max(1, steps // 4):])
    if not last < losses[0]:
        raise AssertionError(f"{cfg.name}: loss did not fall: {losses}")
    per_step = _expected_train_launches(cfg)
    want = {k: per_step.get(k, 0) * steps for k in counts}
    if counts != want:
        raise AssertionError(f"{cfg.name}: training launches {counts}, expected {want}")
    for k in ("flash_attention", "flash_attention_backward", "moe_gmm"):
        if routes[k]["bf16_mma"] != want[k]:
            raise AssertionError(f"{cfg.name}: bfloat16 training off the tensor-core "
                                 f"route: {routes}")
    median_s = statistics.median(step_s[1:])
    peak = torch.cuda.max_memory_allocated(device) / 1e9
    profiled, state = _train_profile(step_fn, state, _torch_batch(data.batch_at(steps),
                                                                  device), device)
    out = {"arch": cfg.name, "reduced": reduced, "params": tree_num_params(state.params),
           "init_s": init_s, "tokens": [b, s], "base_lr": base_lr, "steps": steps,
           "losses": losses, "grad_norms": norms, "lrs": lrs, "step_s": step_s,
           "median_step_ms": 1e3 * median_s, "tokens_per_s": b * s / median_s,
           "last_quarter_mean_loss": last, "launches": counts,
           "launches_per_step": {k: v / steps for k, v in want.items() if v},
           "routes": routes, "plain_calls": plain, "peak_memory_gb": peak,
           "resident_before_gb": resident, "profile": profiled,
           # The profiler slows the host: the device-busy time of the
           # profiled step against the unprofiled median step.
           "idle_share_of_median_step": max(
               0.0, 1.0 - profiled.get("device_busy_ms", 0.0) / (1e3 * median_s))}
    del state, step_fn, model
    gc.collect()
    first = {"losses": losses[:REPEAT_STEPS], "grad_norms": norms[:REPEAT_STEPS],
             "checksums": checksums}
    out["repeat"] = _repeat_run(cfg, data, device, steps, base_lr, first)
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _gate_repeat(row: dict) -> None:
    if not row["repeat"]["equal"]:
        raise AssertionError(f"{row['arch']}: the training run did not repeat bit for "
                             f"bit: {row['repeat']} against losses "
                             f"{row['losses'][:REPEAT_STEPS]}, grad norms "
                             f"{row['grad_norms'][:REPEAT_STEPS]}")


def run_lm_train_path(device, steps: int = TRAIN_STEPS) -> dict:
    """Granite-MoE trained at full width and depth (`train_model`, batches
    of 4 × 1,024 tokens; flash forward 2 a layer, backward 1, GMM 6 + 6),
    its median step and the profiled step's flash-backward ms and share
    reported beside `CUDA_CORE_BWD_STEP`; then `TRAIN_MODELS` one after
    another (Mamba2, Zamba2, gemma2, Whisper and the VLM at full width,
    each freed before the next), each with its counts zeroed just before
    it; each run must repeat bit for bit (``repeat``, gated once its line
    is logged); then the float32 card-against-host checks (`check_train_on_host`:
    Granite at 2 layers, the reduced VLM and Whisper;
    `check_ssm_train_on_host`) and the guard (`check_no_grad_through_kernels`).  Returns Granite's line
    with ``models`` (each model's line) and ``launches`` summed over all
    the runs."""
    import dataclasses

    from repro_torch.configs import get_arch

    out = train_model(get_arch(LM_ARCH), TRAIN_SHAPE, device, steps)
    profiled, median_ms = out["profile"], out["median_step_ms"]
    # [this run, the CUDA-core backward's step]
    out["against_cuda_core_backward"] = {
        "median_step_ms": [median_ms, CUDA_CORE_BWD_STEP["median_step_ms"]],
        "flash_bwd_ms": [profiled.get("flash_bwd_ms"), CUDA_CORE_BWD_STEP["flash_bwd_ms"]],
        "flash_bwd_share": [profiled.get("flash_bwd_share"),
                            CUDA_CORE_BWD_STEP["flash_bwd_share"]]}
    log("lm_train_path " + json.dumps(out))
    _gate_repeat(out)
    launches = dict(out["launches"])
    out["models"] = {}
    for arch, (over, shape, reduced, lr) in TRAIN_MODELS.items():
        t0 = time.perf_counter()
        row = train_model(dataclasses.replace(get_arch(arch), **over), shape, device,
                          steps, reduced, lr)
        row["run_s"] = time.perf_counter() - t0
        log("lm_train_path " + json.dumps(row))
        _gate_repeat(row)
        for k, v in row["launches"].items():
            launches[k] = launches.get(k, 0) + v
        out["models"][arch] = row
    out["all_launches"] = launches
    out["card_vs_host"] = check_train_on_host(device)
    out["ssm_card_vs_host"] = check_ssm_train_on_host(device)
    out["guard"] = check_no_grad_through_kernels(device)
    return out


# -- the multi-device path -----------------------------------------------------

# The sharded flush: one card listed this many times (the reference's
# forced host devices), flushes of this many rows (above SHARD_MIN_ROWS,
# not a multiple of the shard count, as the reference test's).
FLUSH_SHARDS = 4
FLUSH_ROWS = 2050
# The sharded step: Granite-MoE at full width and depth under the fsdp
# variant with fsdp_gather and seq_shard on a world-size-1 NCCL mesh.
SHARDED_VARIANT = "fsdp"
# The host ranks: gloo processes on the card machine's CPU, the reduced
# qwen2-72b step sharded over a (2, 2) mesh against one rank, float32.
HOST_RANKS = 4
HOST_RANKS_TOL = 1e-5
HOST_RANKS_TIMEOUT_S = 300
PIPE = dict(layers=8, d=16, micro=4, mb=2, s=4)


def check_sharded_flush(bank, population, device) -> dict:
    """Every tree model of ``bank`` with a device reduction: a bank built
    over ``[device] * FLUSH_SHARDS`` (`CudaBank.from_flat(devices=…)`,
    one upload) flushes its op type's rows of the 1,024-graph population
    (a NAS generation) and their first `FLUSH_ROWS` rows through
    `fused_predict` and the leaves route; gates: bit-equal to the same
    flush on the unsharded card bank, `FLUSH_SHARDS` launches of the
    kernel a flush of at least `SHARD_MIN_ROWS` rows and one below it,
    every shard's rows equal.  Counts are zeroed just before each flush
    and read just after; returns the launches summed."""
    import numpy as np
    import torch
    from repro_torch.kernels import tree_gather as tg

    pop32 = per_type_matrices(population, bank.predictors, f32=True)
    rows_out, largest = [], []
    launches = {"tree_gather_leaves": 0, "tree_predict_fused": 0}
    for t, x in pop32.items():
        model = bank.predictors[t]
        red = model._device_reduction() if hasattr(model, "_device_reduction") else None
        if red is None:
            continue
        kind, scale, bias = red
        largest.append(t)
        flat = model.flat()
        whole = tg.CudaBank.from_flat(flat, device, devices=[device])
        sharded = tg.CudaBank.from_flat(flat, device, devices=[device] * FLUSH_SHARDS)
        mean, std = tg.to_device_scaler(model.scaler, device)
        flushes = [("generation", x)]
        if len(x) > FLUSH_ROWS:
            flushes.append(("flush_2050", x[:FLUSH_ROWS]))
        for label, rows in flushes:
            xs = model.scaler.transform(rows.astype(np.float64))
            for route in ("fused", "leaves"):
                if route == "fused":
                    want = whole.fused(mean, std, scale, bias, whole.stage_input(rows), kind)
                    staged = sharded.stage_input(rows)
                    reset_counts()
                    got = sharded.fused(mean, std, scale, bias, staged, kind)
                else:
                    want = whole.gather_leaves(whole.stage_input(xs))
                    staged = sharded.stage_input(xs)
                    reset_counts()
                    got = sharded.gather_leaves(staged)
                torch.cuda.synchronize()
                counts = read_counts()
                name = "tree_predict_fused" if route == "fused" else "tree_gather_leaves"
                n = FLUSH_SHARDS if len(rows) >= tg.SHARD_MIN_ROWS else 1
                if counts[name] != n or sum(counts.values()) != n:
                    raise AssertionError(f"sharded flush {t} {label} {route}: launches "
                                         f"{counts}, expected {n} of {name}")
                if n > 1 and len({len(s) for s in staged.shards}) != 1:
                    raise AssertionError(f"uneven shards: {[len(s) for s in staged.shards]}")
                if not torch.equal(got, want):
                    raise AssertionError(f"sharded flush {t} {label} {route} differs from "
                                         f"the unsharded card flush")
                launches[name] += counts[name]
                rows_out.append({"op_type": t, "flush": label, "route": route,
                                 "rows": len(rows), "launches": counts[name],
                                 "sharded": n > 1})
        if sharded.stats()["uploads"] != 1 or not sharded.stats()["sharded"]:
            raise AssertionError(f"sharded bank stats {sharded.stats()}")
    if not any(r["sharded"] for r in rows_out) or not rows_out:
        raise AssertionError("no sharded flush ran")
    # Times of the largest flush, sharded against unsharded (same card),
    # inputs staged beforehand.
    t = max(largest, key=lambda k: len(pop32[k]))
    model, x = bank.predictors[t], pop32[t]
    kind, scale, bias = model._device_reduction()
    mean, std = tg.to_device_scaler(model.scaler, device)
    whole = tg.CudaBank.from_flat(model.flat(), device, devices=[device])
    sharded = tg.CudaBank.from_flat(model.flat(), device, devices=[device] * FLUSH_SHARDS)
    xw, xs = whole.stage_input(x), sharded.stage_input(x)
    timing = {"op_type": t, "rows": len(x),
              "unsharded": cuda_ms(lambda: whole.fused(mean, std, scale, bias, xw, kind)),
              "sharded": cuda_ms(lambda: sharded.fused(mean, std, scale, bias, xs, kind))}
    out = {"flushes": rows_out, "launches": launches, "time": timing}
    log("sharded_flush " + json.dumps(out))
    return out


def _nccl_world_of_one(device):
    """The default process group: NCCL, world size 1, rendezvous through a
    FileStore under build/ (no port)."""
    import tempfile

    import torch.distributed as dist

    (ROOT / "build").mkdir(exist_ok=True)
    path = tempfile.mkstemp(prefix="store_", dir=ROOT / "build")[1]
    os.unlink(path)
    dist.init_process_group("nccl", store=dist.FileStore(path, 1), rank=0,
                            world_size=1, device_id=device)
    return path


def _host_split(model, step_fn, state, batch) -> tuple:
    """One training step with host timers around its parts: the forward
    and loss (``model.loss``), the backward (`torch.autograd.grad`, with
    its remat recomputes), AdamW (`adamw_update`), and the sharding hooks
    the decoder calls (`gather_layer`, inside the forward and the
    recomputes; `pin_layer_stack`; `local_params` of the top leaves).
    Each is the host's time in it, waits for the card included; the
    parts nest.  Returns ({part: ms}, state after)."""
    import torch
    import repro_torch.distributed.trainstep as ts
    import repro_torch.models.transformer as tr

    spent = {}

    def timed(name, fn):
        def call(*a, **k):
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                spent[name] = spent.get(name, 0.0) + (time.perf_counter() - t0) * 1e3
        return call

    targets = [(model, "loss"), (torch.autograd, "grad"), (ts, "adamw_update"),
               (tr, "gather_layer"), (tr, "pin_layer_stack"), (tr, "local_params")]
    originals = [(o, n, getattr(o, n)) for o, n in targets]
    for o, n, fn in originals:
        setattr(o, n, timed(n, fn))
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch)
        float(metrics["loss"])
        torch.cuda.synchronize()
        spent["step"] = (time.perf_counter() - t0) * 1e3
    finally:
        for o, n, fn in originals:
            setattr(o, n, fn)
    return spent, state


def _unsharded_host_split(cfg, shape, device, steps: int) -> dict:
    """`_host_split` of the unsharded step of ``cfg`` (seed 0, `TRAIN_KW`,
    after two warm-up steps), for comparison with the sharded one."""
    import gc

    import torch
    from repro_torch.distributed import init_train_state, make_train_step
    from repro_torch.models import build_model

    model = build_model(cfg)
    state = init_train_state(model, 0, device=device)
    data = _train_data(cfg, *shape, seed=0)
    step_fn = make_train_step(model, **dict(TRAIN_KW, total_steps=steps))
    for i in range(2):
        state, _ = step_fn(state, _torch_batch(data.batch_at(i), device))
    split, state = _host_split(model, step_fn, state, _torch_batch(data.batch_at(2), device))
    del state, step_fn, model
    gc.collect()
    torch.cuda.empty_cache()
    return split


def sharded_train(cfg, shape, device, mesh, steps: int, unsharded: dict) -> dict:
    """``cfg`` trained as `train_model` trains it (seed 0, `TRAIN_KW`,
    `_train_data` batches) but on ``mesh`` under `SHARDED_VARIANT` with
    fsdp_gather and seq_shard: the first step shards the state; gates:
    each step's loss within `LM_TOL` (bfloat16) of ``unsharded``'s at the
    same step, launches equal to `_expected_train_launches` × steps on the
    bfloat16 tensor-core routes, no plain version called, every parameter
    and moment a DTensor.  Then, not counted, one step under torch.profiler
    and one under `_host_split`, and `_unsharded_host_split` of ``cfg``
    itself: where the sharded step's extra time goes."""
    import dataclasses
    import gc
    import statistics

    import torch
    from torch.distributed.tensor import DTensor
    from repro_torch.distributed import init_train_state, make_train_step
    from repro_torch.models import build_model
    from repro_torch.utils.tree import flatten_with_paths

    base, cfg = cfg, dataclasses.replace(cfg, fsdp_gather=True, seq_shard=True)
    model = build_model(cfg)
    torch.cuda.reset_peak_memory_stats(device)
    state = init_train_state(model, 0, device=device)
    b, s = shape
    data = _train_data(cfg, b, s, seed=0)
    step_fn = make_train_step(model, mesh=mesh, variant=SHARDED_VARIANT,
                              **dict(TRAIN_KW, total_steps=steps))
    plain, restore = _plain_counters()
    try:
        reset_counts()
        losses, norms, step_s = [], [], []
        for i in range(steps):
            batch = _torch_batch(data.batch_at(i), device)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, metrics = step_fn(state, batch)
            losses.append(float(metrics["loss"]))
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
            norms.append(float(metrics["grad_norm"]))
        counts, routes = read_counts(), read_routes()
    finally:
        restore()
    if any(plain.values()):
        raise AssertionError(f"sharded {cfg.name}: plain versions called: {plain}")
    leaves = list(flatten_with_paths(state.params).values()) + \
        list(state.opt.mu.values()) + list(state.opt.nu.values())
    if not all(isinstance(t, DTensor) for t in leaves):
        raise AssertionError("the sharded state holds plain tensors")
    tol = LM_TOL["bfloat16"]
    diffs = [abs(a - w) / abs(w) for a, w in zip(losses, unsharded["losses"])]
    if len(diffs) != steps or max(diffs) > tol:
        raise AssertionError(f"sharded losses {losses} against unsharded "
                             f"{unsharded['losses']}: {max(diffs)} > {tol}")
    per_step = _expected_train_launches(cfg)
    want = {k: per_step.get(k, 0) * steps for k in counts}
    if counts != want or counts != unsharded["launches"]:
        raise AssertionError(f"sharded launches {counts}, expected {want} "
                             f"(unsharded {unsharded['launches']})")
    for k in ("flash_attention", "flash_attention_backward", "moe_gmm"):
        if routes[k]["bf16_mma"] != want[k]:
            raise AssertionError(f"sharded step off the tensor-core route: {routes}")
    median_s = statistics.median(step_s[1:])
    peak = torch.cuda.max_memory_allocated(device) / 1e9
    profiled, state = _train_profile(step_fn, state, _torch_batch(data.batch_at(steps),
                                                                  device), device)
    host, state = _host_split(model, step_fn, state, _torch_batch(data.batch_at(steps + 1),
                                                                  device))
    out = {"arch": cfg.name, "variant": SHARDED_VARIANT, "fsdp_gather": True,
           "seq_shard": True, "mesh": dict(zip(mesh.mesh_dim_names, mesh.mesh.shape)),
           "tokens": [b, s], "steps": steps, "losses": losses, "grad_norms": norms,
           "unsharded_losses": unsharded["losses"], "max_rel_loss_diff": max(diffs),
           "step_s": step_s, "median_step_ms": 1e3 * median_s,
           "tokens_per_s": b * s / median_s,
           "peak_memory_gb": peak,
           "unsharded": {k: unsharded[k] for k in ("median_step_ms", "tokens_per_s",
                                                   "peak_memory_gb")},
           "launches": counts, "routes": routes,
           # One profiled step each (not counted): the device-busy time
           # against the unsharded run's, and where the host's time went.
           "profile": {k: profiled[k] for k in ("wall_ms", "device_busy_ms", "idle_share",
                                                "launches")},
           "unsharded_profile": {k: unsharded["profile"][k] for k in (
               "wall_ms", "device_busy_ms", "idle_share", "launches")},
           "host_split_ms": host}
    del state, step_fn, model, leaves
    gc.collect()
    torch.cuda.empty_cache()
    out["unsharded_host_split_ms"] = _unsharded_host_split(base, shape, device, steps)
    return out


def check_collectives_on_card(device) -> dict:
    """`compressed_psum` and `pipeline_forward` on the NCCL group of one
    rank: the psum is the int8 round trip of its input (the only rank's
    part) within 0.02 of it; the pipeline (one stage, `PIPE`'s sizes,
    tanh(x @ w), float32 without TF32) within 1e-5 of the sequential
    loop, with the bubble fraction 0."""
    import numpy as np
    import torch
    from repro_torch.distributed.compression import _quantize, compressed_psum
    from repro_torch.distributed.pipeline import (
        pipeline_bubble_fraction, pipeline_forward, split_layers_to_stages)
    from repro_torch.launch.mesh import make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(0)
    x = torch.from_numpy(np.asarray(rng.standard_normal(64), np.float32)).to(device)
    got = compressed_psum(x, "data", make_mesh((1,), ("data",)))
    scale = x.abs().max() / 127.0 + 1e-12
    if not torch.equal(got, _quantize(x, scale).float() * scale):
        raise AssertionError("compressed_psum on one rank is not the int8 round trip")
    rel = float(torch.linalg.norm(got - x) / torch.linalg.norm(x))
    p = PIPE
    ws = torch.from_numpy(np.asarray(rng.standard_normal((p["layers"], p["d"], p["d"]))
                                     * 0.1, np.float32)).to(device)
    xm = torch.from_numpy(np.asarray(rng.standard_normal(
        (p["micro"], p["mb"], p["s"], p["d"])), np.float32)).to(device)
    ref = xm
    for i in range(p["layers"]):
        ref = torch.tanh(ref @ ws[i])
    out = pipeline_forward(lambda w, a: torch.tanh(a @ w), split_layers_to_stages(ws, 1),
                           xm, mesh=make_mesh((1,), ("pipe",)), axis="pipe")
    err = float((out - ref).abs().max())
    if rel >= 0.02 or err >= 1e-5 or pipeline_bubble_fraction(1, p["micro"]) != 0.0:
        raise AssertionError(f"collectives: psum rel {rel}, pipeline err {err}")
    res = {"compressed_psum_rel_err": rel, "pipeline_max_abs_err": err}
    log("card_collectives " + json.dumps(res))
    return res


HOST_RANK_BODY = """
import dataclasses, datetime, json, os, sys
import torch
import torch.distributed as dist
torch.set_num_threads(1)
rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
dist.init_process_group("gloo", store=dist.FileStore(os.environ["STORE"], world),
                        rank=rank, world_size=world, timeout=datetime.timedelta(seconds=120))
from repro_torch.configs import get_arch
from repro_torch.data import SyntheticLMData
from repro_torch.distributed import init_train_state, make_train_step
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import build_model
cfg = dataclasses.replace(get_arch("qwen2-72b").reduced(), compute_dtype="float32")
model = build_model(cfg)
batch = {k: torch.from_numpy(v) for k, v in SyntheticLMData(
    vocab_size=cfg.vocab_size, seq_len=32, global_batch=4, seed=0).batch_at(0).items()}
mesh = make_mesh((2, 2), ("data", "model"), device_type="cpu")
res = {}
for name, m in (("sharded", mesh), ("one_rank", None)):
    step = make_train_step(model, mesh=m, base_lr=1e-2, warmup_steps=1)
    state, out = init_train_state(model, 0, device="cpu"), []
    for _ in range(3):
        state, metrics = step(state, batch)
        out.append([float(metrics["loss"]), float(metrics["grad_norm"])])
    res[name] = out
with open(os.path.join(os.environ["OUT"], f"rank{rank}.json"), "w") as f:
    json.dump(res, f)
dist.destroy_process_group()
"""


def check_host_ranks() -> dict:
    """`HOST_RANKS` gloo processes on this machine's CPU (a FileStore
    rendezvous under build/): reduced qwen2-72b, 3 steps sharded over a
    (2, 2) mesh against the port's step on one rank, loss and grad norm
    within `HOST_RANKS_TOL` relative on every rank."""
    import subprocess
    import tempfile

    (ROOT / "build").mkdir(exist_ok=True)
    out = tempfile.mkdtemp(prefix="host_ranks_", dir=ROOT / "build")
    env = {k: v for k, v in os.environ.items() if k != "CUDA_VISIBLE_DEVICES"}
    env.update(PYTHONPATH=str(ROOT / "src"), WORLD_SIZE=str(HOST_RANKS), OUT=out,
               STORE=os.path.join(out, "store"), CUDA_VISIBLE_DEVICES="",
               OMP_NUM_THREADS="1")
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, "-c", HOST_RANK_BODY],
                              env={**env, "RANK": str(r)}, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for r in range(HOST_RANKS)]
    errors = []
    try:
        for r, proc in enumerate(procs):
            _, err = proc.communicate(timeout=HOST_RANKS_TIMEOUT_S)
            if proc.returncode:
                errors.append(f"rank {r}: rc {proc.returncode}: {err[-2000:]}")
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    if errors:
        raise AssertionError("host ranks failed: " + " | ".join(errors))
    worst = 0.0
    for r in range(HOST_RANKS):
        res = json.loads(Path(out, f"rank{r}.json").read_text())
        for got, want in zip(res["sharded"], res["one_rank"]):
            for a, w in zip(got, want):
                worst = max(worst, abs(a - w) / abs(w))
    if worst > HOST_RANKS_TOL:
        raise AssertionError(f"host ranks: sharded vs one rank {worst} > {HOST_RANKS_TOL}")
    line = {"ranks": HOST_RANKS, "mesh": [2, 2], "steps": 3, "max_rel_diff": worst,
            "seconds": time.perf_counter() - t0}
    log("host_ranks " + json.dumps(line))
    return line


# The dry run's production cell, traced in a child process (a fake
# process group is process-global) through the CLI a user runs.
DRYRUN_CELL = ("qwen2-72b", "decode_32k", "single")
# Granite at full width and 12 of 24 layers on 16 × 1,024 tokens, 16
# microbatches, traced in fake mode and run on the card (its real step
# took 56.4 s of the script at 24 layers on an NVIDIA H100 80GB HBM3,
# 700 W).
DRYRUN_TRAIN = ("granite-moe-1b-a400m", 1024, 16, 12)
# The traced peak against the card's `max_memory_allocated` (less what was
# allocated before the cell was built): a miss means a tensor the trace
# does not see.
DRYRUN_PEAK_BAND = 0.15


# The Granite trace's child process: one fake-mode `run_cell` on `cuda`,
# its record (with the trace's seconds) as the last line of its output.
DRYRUN_TRAIN_CHILD = """
import dataclasses, json, sys, time
from repro_torch.configs import InputShape, get_arch
from repro_torch.launch import dryrun
name, seq, batch, layers = sys.argv[1], *map(int, sys.argv[2:5])
t0 = time.perf_counter()
rec = dryrun.run_cell(name, "train_4k", None,
                      cfg_override=dataclasses.replace(get_arch(name), num_layers=layers),
                      shape_override=InputShape("train_4k", seq, batch, "train"),
                      fake=True, device="cuda")
rec.pop("traceback", None)
rec["trace_s"] = time.perf_counter() - t0
print(json.dumps(rec))
"""


class DryrunTraces:
    """The dry run's two fake-mode traces, each in a child process started
    as soon as the kernels are built: `DRYRUN_CELL` through the CLI a user
    runs (a fake process group is process-global) and Granite's
    `DRYRUN_TRAIN` (`DRYRUN_TRAIN_CHILD`).  A trace is host work on fake
    tensors that allocates nothing on the card, so both overlap the card's
    phases; `run_dryrun_path` waits for them.  `stop` ends any child
    still running."""

    def __init__(self) -> None:
        arch, shape, mesh = DRYRUN_CELL
        out_dir = ROOT / "build" / "dryrun"
        out_dir.mkdir(parents=True, exist_ok=True)
        self.cell_out = out_dir / f"{arch}_{shape}_{mesh}.json"
        if self.cell_out.exists():
            self.cell_out.unlink()
        env = dict(os.environ)
        env["PYTHONPATH"] = str(ROOT / "src")
        name, seq, batch, layers = DRYRUN_TRAIN
        self.logs = {}
        self.started = time.perf_counter()
        self.cell = self._start(
            "cell", ["-m", "repro_torch.launch.dryrun", "--arch", arch, "--shape", shape,
                     "--mesh", mesh, "--out", str(self.cell_out), "--device", "cuda"],
            out_dir, env)
        self.train = self._start("train", ["-c", DRYRUN_TRAIN_CHILD, name, str(seq),
                                           str(batch), str(layers)], out_dir, env)

    def _start(self, key: str, args: list, out_dir: Path, env: dict):
        """A child with its output and errors in files (a pipe nobody reads
        until the child ends could fill and stall it)."""
        out, err = out_dir / f"{key}.out", out_dir / f"{key}.err"
        self.logs[key] = (out, err)
        with open(out, "w") as fo, open(err, "w") as fe:
            return subprocess.Popen([sys.executable, *args], cwd=ROOT, env=env,
                                    stdout=fo, stderr=fe)

    def wait(self, key: str, what: str, timeout: float = 900) -> str:
        """The child's output once it has ended; raises if it failed."""
        proc = getattr(self, key)
        proc.wait(timeout=max(1.0, timeout - (time.perf_counter() - self.started)))
        out, err = (path.read_text() for path in self.logs[key])
        if proc.returncode:
            raise AssertionError(f"{what} exited {proc.returncode}:\n{err[-3000:]}")
        return out

    def stop(self) -> None:
        for proc in (self.cell, self.train):
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def _load_example(name: str):
    """``examples/torch/<name>.py`` as a module (its ``main`` not run)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        f"torch_{name}", ROOT / "examples" / "torch" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def step_prediction(rec: dict, cfg, shape) -> dict:
    """The analytic step-cost model (`repro_torch.launch.roofline`) of a
    dry-run record's cell, built from the record's config, shape, mesh,
    microbatches and variant as the reference's ``derive_terms`` reads a
    record, beside the record's traced FLOPs, bytes and collective bytes
    per device; the three terms at the card's published rates and the
    predicted step (the largest); for a step run on the card also the
    measured step and predicted ÷ measured, the step's roofline
    fraction."""
    from repro_torch.launch import roofline

    ana = roofline.step_costs(cfg, shape, rec["mesh"],
                              microbatches=rec.get("microbatches", 16),
                              fsdp=rec.get("variant") == "fsdp")
    terms, dominant, step = roofline.step_terms(ana)
    analytic = {"flops": ana["ana_flops_dev"], "bytes": ana["ana_bytes_dev"],
                "collective_bytes": ana["ana_coll_dev"]}
    traced = {"flops": rec["cost"]["flops_per_device"],
              "bytes": rec["cost"]["bytes_per_device"],
              "collective_bytes": rec["collective_bytes"]}
    line = {"arch": rec["arch"], "shape": [shape.name, shape.global_batch, shape.seq_len],
            "layers": cfg.num_layers, "mesh": rec["mesh"], "variant": rec["variant"],
            "mode": rec["mode"], "analytic_per_device": analytic, "traced_per_device": traced,
            "analytic_over_traced": {k: analytic[k] / traced[k] if traced[k] else None
                                     for k in analytic},
            "terms_ms": {k: 1e3 * v for k, v in terms.items()}, "dominant": dominant,
            "predicted_step_ms": 1e3 * step,
            "rates": {"peak_flops": roofline.PEAK_FLOPS, "hbm_bw": roofline.HBM_BW,
                      "link_bw": roofline.LINK_BW}}
    if "step_ms" in rec:
        line.update(measured_step_ms=rec["step_ms"],
                    predicted_over_measured=1e3 * step / rec["step_ms"],
                    card=rec.get("nvidia_smi"))
    return line


def check_step_prediction(line: dict) -> None:
    """Gates of a step run on the card: every number finite and > 0 (the
    collective term aside: one card moves nothing), and the predicted step
    at most the measured one: a roofline is a lower bound."""
    nums = [*(line[k][q] for k in ("analytic_per_device", "traced_per_device")
              for q in ("flops", "bytes")),
            line["analytic_over_traced"]["flops"], line["analytic_over_traced"]["bytes"],
            line["predicted_step_ms"], line["measured_step_ms"],
            line["predicted_over_measured"]]
    if not all(x is not None and math.isfinite(x) and x > 0 for x in nums):
        raise AssertionError(f"step prediction: a number is not finite and > 0: {line}")
    if line["predicted_step_ms"] > line["measured_step_ms"]:
        raise AssertionError(f"predicted step {line['predicted_step_ms']} ms above the "
                             f"measured {line['measured_step_ms']} ms")


# The predictor twin's lines for qwen2-72b: a step for each of these
# shapes, and long_500k skipped (no sub-quadratic context path).
TWIN_ARCH = "qwen2-72b"
TWIN_STEPS = ("train_4k", "prefill_32k", "decode_32k")


def run_predictor_twin() -> list:
    """``examples/torch/predict_tpu_step.py``'s ``main`` for `TWIN_ARCH`
    in this process (arithmetic only); its lines are printed and gated."""
    import contextlib
    import io

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        _load_example("predict_tpu_step").main(["--arch", TWIN_ARCH])
    lines = out.getvalue().splitlines()
    log("predict_tpu_step " + json.dumps(lines, ensure_ascii=False))
    want = [f"  {name:12s} step ≈" for name in TWIN_STEPS] + ["  long_500k    skipped: "]
    if not (len(lines) == 5 and "on an H100" in lines[0] and "(256 cards)" in lines[0]
            and all(ln.startswith(w) for ln, w in zip(lines[1:], want))):
        raise AssertionError(f"predict_tpu_step printed {lines}")
    return lines


def run_dryrun_path(device, traces: DryrunTraces) -> dict:
    """The dry run (`repro_torch.launch.dryrun`): `DRYRUN_CELL` traced on
    fake CUDA tensors over a fake group of 256 ranks (its record and
    seconds printed), then Granite (`DRYRUN_TRAIN`) traced in fake mode
    and run for real on the card at world size 1.  Both traces run in
    ``traces``' child processes; this waits for them.  Gates: FLOPs and
    argument bytes equal, the traced peak within `DRYRUN_PEAK_BAND` of the
    card's, the real loss finite, every LM kernel of the step launched.
    Launch counts are zeroed just before the real run and read just after
    it.  Then the analytic model beside both records (`step_prediction`
    lines; Granite's gated by `check_step_prediction`) and the predictor
    twin (`run_predictor_twin`): arithmetic on the records, no new run."""
    import dataclasses

    import torch
    from repro_torch.configs import INPUT_SHAPES, InputShape, get_arch
    from repro_torch.launch import dryrun

    arch, shape, _ = DRYRUN_CELL
    t0 = time.perf_counter()
    traces.wait("cell", f"dry run of {arch} × {shape}")
    cell_wait_s = time.perf_counter() - t0
    if not traces.cell_out.exists():
        raise AssertionError(f"dry run of {arch} × {shape} wrote no record")
    rec = json.loads(traces.cell_out.read_text())["cells"][0]
    log("dryrun_cell " + json.dumps(rec))
    log(f"dryrun_cell_s {rec['lower_s'] + rec['compile_s']:.1f} (waited {cell_wait_s:.1f})")
    if not rec["ok"] or rec["cost"]["flops_per_device"] <= 0 or \
            rec["mesh"] != {"data": 16, "model": 16}:
        raise AssertionError(f"dry run of {arch} × {shape}: {rec.get('error', rec)}")

    name, seq, batch, layers = DRYRUN_TRAIN
    cfg = dataclasses.replace(get_arch(name), num_layers=layers)
    train = InputShape("train_4k", seq, batch, "train")
    t0 = time.perf_counter()
    fake = json.loads(traces.wait("train", f"trace of {name}").strip().splitlines()[-1])
    train_wait_s = time.perf_counter() - t0
    fake_s = fake.pop("trace_s")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    reset_counts()
    t0 = time.perf_counter()
    real = dryrun.run_cell(name, "train_4k", None, cfg_override=cfg,
                           shape_override=train, fake=False, device="cuda")
    real_s = time.perf_counter() - t0
    launches = read_counts()
    real.pop("traceback", None)
    card_peak = real.get("max_memory_allocated", 0) - real.get("allocated_before_build", 0)
    row = {"arch": name, "layers": cfg.num_layers, "tokens": [batch, seq],
           "fake": fake, "real": real, "fake_s": fake_s, "fake_wait_s": train_wait_s,
           "real_s": real_s, "card_peak_bytes": card_peak,
           "peak_ratio": fake.get("peak_bytes", 0) / card_peak if card_peak else None,
           "launches": launches}
    log("dryrun_train " + json.dumps(row))
    torch.cuda.empty_cache()
    if not (fake["ok"] and real["ok"]):
        raise AssertionError(f"dry run of {name}: {fake.get('error')} / {real.get('error')}")
    if fake["cost"]["flops_per_device"] != real["cost"]["flops_per_device"]:
        raise AssertionError(f"traced FLOPs {fake['cost']['flops_per_device']} != the "
                             f"card's {real['cost']['flops_per_device']}")
    if fake["memory"]["argument_bytes"] != real["memory"]["argument_bytes"]:
        raise AssertionError(f"traced argument bytes {fake['memory']['argument_bytes']} "
                             f"!= the card's {real['memory']['argument_bytes']}")
    if abs(fake["peak_bytes"] - card_peak) > DRYRUN_PEAK_BAND * card_peak:
        raise AssertionError(f"traced peak {fake['peak_bytes']} is not within "
                             f"{DRYRUN_PEAK_BAND:.0%} of the card's {card_peak}")
    if not (real["loss"] is not None and math.isfinite(real["loss"])):
        raise AssertionError(f"the card's step loss {real['loss']}")
    for kernel in ("flash_attention", "flash_attention_backward", "moe_gmm"):
        if launches[kernel] == 0:
            raise AssertionError(f"the dry run's step never launched {kernel}")

    predicted = {"cell": step_prediction(rec, get_arch(arch), INPUT_SHAPES[shape]),
                 "train": step_prediction(real, cfg, train)}
    for line in predicted.values():
        log("step_prediction " + json.dumps(line))
    check_step_prediction(predicted["train"])
    twin = run_predictor_twin()
    return {"cell": rec, "train": row, "launches": launches,
            "step_prediction": predicted, "predict_tpu_step": twin}


def run_examples_path(device) -> dict:
    """``examples/torch/quickstart.py``'s ``main`` in this process on the
    card, with a store of its own under build/ (cold): it profiles its
    graphs on the card and predicts the held-out ones through the tree
    kernel.  Gate: the tree kernels launched.  Counts zeroed just before."""
    quickstart = _load_example("quickstart")
    store = ROOT / "build" / "examples" / "quickstart_store.jsonl"
    store.parent.mkdir(parents=True, exist_ok=True)
    if store.exists():
        store.unlink()
    reset_counts()
    t0 = time.perf_counter()
    svc = quickstart.main(["--store", str(store)])
    seconds = time.perf_counter() - t0
    launches = read_counts()
    tree = launches["tree_predict_fused"] + launches["tree_gather_leaves"]
    row = {"example": "quickstart", "seconds": seconds, "tree_launches": tree,
           "launches": launches, "stats": svc.stats()}
    log("examples " + json.dumps(row, default=str))
    if tree == 0:
        raise AssertionError("quickstart's predictions never launched the tree kernel")
    return row


def run_multi_device_path(device, bank, population, unsharded: dict) -> dict:
    """(a) the sharded tree flush (`check_sharded_flush`) over the main
    path's bank; (b) Granite-MoE at full width trained on a world-size-1
    NCCL mesh (`sharded_train`) against ``unsharded`` (the training path's
    Granite run: same seed, data and steps); (c) `compressed_psum` and
    `pipeline_forward` on that group and the host ranks
    (`check_host_ranks`).  The process group is destroyed before it
    returns.  Returns the launches of (a) and (b) and their lines."""
    import torch.distributed as dist
    from repro_torch.configs import get_arch
    from repro_torch.launch.mesh import make_mesh

    flush = check_sharded_flush(bank, population, device)
    store = _nccl_world_of_one(device)
    try:
        mesh = make_mesh((1, 1), ("data", "model"))
        step = sharded_train(get_arch(LM_ARCH), TRAIN_SHAPE, device, mesh, TRAIN_STEPS,
                             unsharded)
        log("sharded_train " + json.dumps(step))
        collectives = check_collectives_on_card(device)
    finally:
        dist.destroy_process_group()
        if os.path.exists(store):
            os.unlink(store)
    host = check_host_ranks()
    launches = dict(flush["launches"])
    for k, v in step["launches"].items():
        launches[k] = launches.get(k, 0) + v
    return {"flush": flush, "sharded_train": step, "collectives": collectives,
            "host_ranks": host, "launches": launches}


# -- phase 4 ------------------------------------------------------------------

def _timed(op_type: str, db, rows: int, d: int, fused: bool, kernel, plain,
           numpy_tier, err: float) -> dict:
    """One op type's row of the timing table (device and host times)."""
    from repro_torch.kernels import tree_gather_cuda as tgc

    # The plain version issues tens of launches a call: 3 calls keep the
    # queued loop inside CUDA's launch queue while the card sleeps.
    k, p = cuda_ms(kernel), cuda_ms(plain, iters=3, warmup=2)
    b_ms, b_by = bound(*traffic(db, rows, d, fused))
    pl = tgc.plan_for(db, rows, d, fused)
    return {"op_type": op_type, "rows": rows, "trees": db.n_trees,
            "nodes": db.n_nodes, "route": pl.route, "threads_a_row": pl.groups,
            "rows_on_lanes": pl.rows_on_lanes,
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


def int8_timed_cases(graph, device):
    """(row, a, b, bt, bias) at each int8 GEMM of one forward pass of
    ``graph``, A laid out as the executor gives it (`gemm_shapes`)."""
    for i, (op, m, k, n, patches) in enumerate(gemm_shapes(graph)):
        a, b, bt, bias = _int8_operands(m, k, n, device, seed=1000 + i, patches=patches)
        yield {"op": op, "m": m, "k": k, "n": n, "patches": patches}, a, b, bt, bias


def time_int8_gemm(graph, device) -> list:
    """The int8 GEMM at the shapes of one int8 forward pass of ``graph``:
    kernel (with its route), plain version and ``torch._int_mm`` (int32
    out, no scale).  cuBLASLt refuses many int8 shapes whose sides are
    multiples of 8 (m·k·n = 784·40·208 and 17·24·72 on this card), so the
    library's operands are zero-padded to multiples of 32, with the
    weight column-major, and the padded shape is reported."""
    import torch
    from repro_torch.kernels import int8_matmul as im
    from repro_torch.kernels import int8_matmul_cuda as imc

    scale = im.out_scale(INT8_SCALE, 1.0)
    rows = []
    for row, a, b, bt, bias in int8_timed_cases(graph, device):
        m, k, n = row["m"], row["k"], row["n"]
        if not torch.equal(imc.int8_matmul_cuda(a, bt, scale, bias),
                           im.int8_matmul_plain(a, bt, scale, bias)):
            raise AssertionError(f"int8 GEMM differs at {(m, k, n)}")
        ap, bp, lib_shape = _int_mm_operands(a, b, device)
        kern = cuda_ms(lambda: imc.int8_matmul_cuda(a, bt, scale, bias))
        plain = cuda_ms(lambda: im.int8_matmul_plain(a, bt, scale, bias),
                        iters=3, warmup=2)
        lib = cuda_ms(lambda: torch._int_mm(ap, bp))
        b_ms, b_by = _int8_bound(m, k, n)
        row.update({"route": int8_route(m, k, n, a), "max_abs_err": 0.0,
                    "ms": kern["device"], "host_ms": kern["host"],
                    "plain_ms": plain["device"], "library_ms": lib["device"],
                    "library_shape": lib_shape,
                    "library_padded": lib_shape != [m, k, n],
                    "bound_ms": b_ms, "bound_by": b_by})
        rows.append(row)
        log("time int8_matmul " + json.dumps(row))
    return rows


def winograd_case(name: str, i: int, device) -> dict:
    """Input, weights, U and tiles of one `STUDY_SHAPES` entry (seed 200 + i),
    ``F.conv2d``'s NCHW operands, and the bound: tiles and U read once,
    output tiles written once, against the 16 products plus 32 adds per
    (tile, channel) in and 24 per (tile, output channel) out."""
    import numpy as np
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels import winograd_conv as wc

    c, k, hw = STUDY_SHAPES[name]
    rng = np.random.default_rng(200 + i)
    x = torch.from_numpy(rng.standard_normal((1, hw, hw, c)).astype(np.float32)).to(device)
    wt = torch.from_numpy((rng.standard_normal((3, 3, c, k)) * 0.1)
                          .astype(np.float32)).to(device)
    u = wc.transform_weights(wt)
    tiles = ref.extract_winograd_tiles(x).reshape(-1, 16, c).contiguous()
    t = tiles.shape[0]
    b_ms, b_by = bound(4 * (16 * t * c + 16 * c * k + 4 * t * k),
                       32 * t * c * k + 32 * t * c + 24 * t * k)
    return {"tiles": tiles, "u": u, "t": t, "c": c, "k": k,
            "xc": x.permute(0, 3, 1, 2),
            "w_oihw": wt.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last),
            "bound_ms": b_ms, "bound_by": b_by}


def winograd_names() -> list:
    """The selection path's shape first, then the Fig. 8 shapes."""
    return ["nas_79x77_56"] + [n for n in STUDY_SHAPES if n != "nas_79x77_56"]


def time_winograd(device) -> list:
    """The Winograd kernel at the selection path's shape (first row) and
    at the Fig. 8 study shapes: kernel on (T, 16, C) tiles (with its
    route), plain version and ``F.conv2d`` (TF32 off) on the same input."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import winograd_conv as wc
    from repro_torch.kernels import winograd_conv_cuda as wcc

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    rows = []
    for i, name in enumerate(winograd_names()):
        case = winograd_case(name, i, device)
        tiles, u, t = case["tiles"], case["u"], case["t"]
        err = float((wcc.winograd_tiles_cuda(tiles, u)
                     - wc.winograd_tiles_plain(tiles, u)).abs().max())
        pl = wcc.plan(t, case["c"], case["k"])
        kern = cuda_ms(lambda: wcc.winograd_tiles_cuda(tiles, u))
        plain = cuda_ms(lambda: wc.winograd_tiles_plain(tiles, u), iters=3, warmup=2)
        lib = cuda_ms(lambda: F.conv2d(case["xc"], case["w_oihw"], padding=1))
        rows.append({"shape": name, "tiles": t, "c": case["c"], "k": case["k"],
                     "route": f"{pl.route} ({pl.blocks} blocks, "
                              f"{2 * -(-t // pl.t_pass)} launches)",
                     "max_abs_err": err,
                     "ms": kern["device"], "host_ms": kern["host"],
                     "plain_ms": plain["device"], "library_ms": lib["device"],
                     "bound_ms": case["bound_ms"], "bound_by": case["bound_by"]})
        log("time winograd_conv2d " + json.dumps(rows[-1]))
    return rows


def time_flash(device) -> list:
    """The flash kernel at the Granite forward's shape (b = 4, s = 1,024,
    16 query and 8 kv heads, d = 64, causal, bfloat16 and float32), at the
    Zamba2 forward's (b = 2, s = 4,096, 32 heads MHA, bfloat16) and at the
    LM zoo's (gemma2's local and global layers, the VLM's cross-attention,
    Whisper's encoder): kernel, plain version and one
    ``F.scaled_dot_product_attention`` call on the same input.  SDPA has
    no softcap: for gemma2's cases it computes another function (no
    softcap; the local case with a boolean window mask), labelled
    ``library_fn``.  Bound: q, k, v read once and o written once, against
    4·d operations for each (query, key) pair the masks keep, at the
    type's rate."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_attention_cuda as fac

    rows = []
    for c in (c for c in FLASH_CASES if c.label in FLASH_TIMED):
        kw = _flash_kw(c)
        q, k, v = _flash_inputs(c.b, c.s, c.h, c.kvh, c.d, c.dtype, device, seed=500,
                                skv=c.skv, q_scale=c.q_scale)
        err = float((fac.flash_attention_cuda(q, k, v, **kw).float()
                     - fa.flash_attention_plain(q, k, v, **kw).float())
                    .abs().max())
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        kern = cuda_ms(lambda: fac.flash_attention_cuda(q, k, v, **kw))
        plain = cuda_ms(lambda: fa.flash_attention_plain(q, k, v, **kw),
                        iters=3, warmup=2)
        mask, library_fn = None, "same function"
        if c.window:
            mask = ~fa.hidden_keys(c.s, c.keys, causal=c.causal, q_offset=0,
                                   window=c.window, device=device)
        if c.softcap:
            library_fn = ("not the same function: no softcap"
                          + (", window as a boolean mask" if c.window else ""))
        lib = cuda_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, is_causal=c.causal and mask is None,
            enable_gqa=True))
        b_ms, b_by = _flash_bound(c.b, c.s, c.h, c.kvh, c.d, c.causal, c.dtype,
                                  c.skv, c.window)
        rows.append({"case": c.label, "shape": [c.b, c.s, c.h, c.kvh, c.d],
                     "skv": c.keys, "dtype": c.dtype, "causal": c.causal,
                     "window": c.window, "softcap": c.softcap, "q_scale": c.q_scale,
                     "max_abs_err": err, "ms": kern["device"], "host_ms": kern["host"],
                     "plain_ms": plain["device"], "library_ms": lib["device"],
                     "library_fn": library_fn, "bound_ms": b_ms, "bound_by": b_by})
        log("time flash_attention " + json.dumps(rows[-1]))
        del q, k, v, qt, kt, vt, mask
        torch.cuda.empty_cache()
    return rows


# Weight sets the cold-L2 GMM timing rotates over: 4 × 33.6 MB of decode
# weights, well past the 50 MB L2, as serving reads each layer's experts.
GMM_COLD_SETS = 4
# The GMM shapes `time_gmm` times, each with the input sets its launches
# rotate over: one (L2 warm) at the serving path's four shapes, and
# `GMM_COLD_SETS` (L2 cold) at the two decode shapes; then the float32
# kernel at the gate/up decode and prefill shapes (L2 warm).
GMM_TIMED = [(c, 1) for c in GMM_CASES[:4]] + [(c, GMM_COLD_SETS) for c in GMM_CASES[:2]] \
    + [(c, 1) for c in GMM_CASES[4:6]]


def _gmm_turns(e, n, d, f, dtype, device, n_sets) -> tuple:
    """``n_sets`` input sets of one GMM shape, and a function that hands
    them out in turn: with several, no launch finds its weights in L2."""
    sets = [_gmm_inputs(e, n, d, f, dtype, device, seed=600 + i) for i in range(n_sets)]
    turn = itertools.cycle(sets)
    return sets, lambda: next(turn)


def time_gmm(device) -> list:
    """The GMM kernel at `GMM_TIMED`: the serving path's four shapes
    (gate/up and down, decode with 4 slots × capacity 8 rows, prefill with
    4 × 320), bfloat16, kernel, plain version and ``torch.bmm`` on the same
    inputs (``l2`` "warm": the decode weights stay in L2); then the two
    decode shapes with ``l2`` "cold", kernel and ``torch.bmm`` rotating
    over `GMM_COLD_SETS` input sets, so every launch reads its weights from
    device memory, as a serving step does; last the float32 kernel at the
    gate/up decode and prefill shapes.  Bound: x and w read once and the
    output written once, against 2·e·rows·d·f operations at the type's
    rate (`_gmm_bound`)."""
    import torch
    from repro_torch.kernels import moe_gmm as gmm
    from repro_torch.kernels import moe_gmm_cuda as gmmc

    rows = []
    for (label, e, n, d, f, dtype), n_sets in GMM_TIMED:
        sets, turn = _gmm_turns(e, n, d, f, dtype, device, n_sets)
        err = max(float((gmmc.moe_gmm_cuda(x, w).float()
                         - gmm.moe_gmm_plain(x, w).float()).abs().max())
                  for x, w in sets)
        kern = cuda_ms(lambda: gmmc.moe_gmm_cuda(*turn()))
        plain = None if n_sets > 1 else cuda_ms(
            lambda: gmm.moe_gmm_plain(*turn()), iters=3, warmup=2)["device"]
        lib = cuda_ms(lambda: torch.bmm(*turn()))
        b_ms, b_by = _gmm_bound(e, n, d, f, dtype)
        cold = n_sets > 1
        rows.append({"case": label + ("_cold" if cold else ""), "shape": [e, n, d, f],
                     "dtype": dtype, "l2": "cold" if cold else "warm", "sets": n_sets,
                     "max_abs_err": err, "ms": kern["device"], "host_ms": kern["host"],
                     "plain_ms": plain, "library_ms": lib["device"],
                     "bound_ms": b_ms, "bound_by": b_by})
        log("time moe_gmm " + json.dumps(rows[-1]))
        del sets, turn
        torch.cuda.empty_cache()
    return rows


def _flash_bwd_bound(b, s, h, kvh, d, causal, dtype, skv=0, window=0) -> tuple:
    """q, k, v, o, dO and the log-sum-exp read once, dq, dk, dv written
    once, against five products of 2·d operations (S, dP, dV, dK, dQ) for
    each (query, key) pair the masks keep, at the type's rate."""
    skv = skv or s
    pairs = b * h * flash_pairs(s, skv, causal, window)
    bf16 = dtype == "bfloat16"
    size = 2 if bf16 else 4
    moved = size * 4 * (b * s * h * d + b * skv * kvh * d) + 4 * b * h * s
    return bound(moved, 10 * d * pairs, PEAK_BF16_OPS_PER_S if bf16 else PEAK_F32_OPS_PER_S)


# The flash backward cases `time_flash_backward` times: the Granite
# training call in both types, gemma2's global and local ones, the VLM's
# cross-attention and Whisper's encoder and cross-attention.
FLASH_BWD_TIMED = ("forward", "forward_f32", "gemma2_global", "gemma2_local",
                   "vlm_cross", "whisper_encoder_train", "whisper_cross")


def sdpa_backward(q, k, v, do, causal: bool, mask=None) -> tuple:
    """SDPA's backward for the flash backward's function: the gradient of
    one ``F.scaled_dot_product_attention`` forward (GQA; ``mask`` a boolean
    mask of kept keys in place of the causal flag) of q, k, v (b, s, h, d)
    through ``torch.autograd.grad`` with the graph kept.  Returns a call
    that recomputes it (to time) and its (dq, dk, dv) in the (b, s, h, d)
    layout."""
    import torch
    import torch.nn.functional as F

    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v))
    out = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                         is_causal=causal and mask is None,
                                         enable_gqa=True)
    dot = do.transpose(1, 2)

    def call():
        return torch.autograd.grad(out, (qt, kt, vt), dot, retain_graph=True)
    return call, tuple(g.transpose(1, 2) for g in call())


def time_flash_backward(device) -> list:
    """The flash backward kernel at Granite's training call (b = 4, s =
    1,024, 16 query and 8 kv heads, d = 64, causal), bfloat16 and float32,
    and at gemma2's (b = 1, s = 6,144, 32 query and 16 kv heads, d = 128,
    causal, softcap 50; the local layer's window 4,096), the VLM's
    cross-attention (2, 2,048 queries over 1,600 rows, 64 query and 8 kv
    heads, d = 128) and Whisper's encoder (4, 1,500, 20 heads, d = 64) and
    cross-attention (448 queries over 1,500 frames), none causal, bfloat16:
    kernel, plain version, and SDPA's backward for the same function (the
    gradient of one ``F.scaled_dot_product_attention`` forward, GQA, TF32
    off, through ``torch.autograd.grad`` with the graph kept) on the same
    q, k, v and dO.  SDPA has no softcap: for gemma2's calls it computes
    another function (the window as a boolean mask), labelled
    ``library_fn``.  Bound:
    `_flash_bwd_bound`."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_attention_cuda as fac

    torch.backends.cuda.matmul.allow_tf32 = False
    rows = []
    for c in (c for c in FLASH_CASES if c.label in FLASH_BWD_TIMED):
        kw = _flash_kw(c)
        q, k, v = _flash_inputs(c.b, c.s, c.h, c.kvh, c.d, c.dtype, device, seed=1000,
                                skv=c.skv, q_scale=c.q_scale)
        do = _randn((c.b, c.s, c.h, c.d), 1003, device, c.dtype)
        o, lse = fac.flash_attention_cuda(q, k, v, return_lse=True, **kw)
        got = fac.flash_attention_backward_cuda(q, k, v, o, lse, do, **kw)
        want = fa.flash_attention_backward_plain(q, k, v, o, lse, do, **kw)
        err = max(float((g.float() - w.float()).abs().max()) for g, w in zip(got, want))
        kern = cuda_ms(lambda: fac.flash_attention_backward_cuda(q, k, v, o, lse, do, **kw))
        # One call a loop: three of gemma2's plain backwards (dozens of
        # launches over 4.8 GB score buffers each) can outlast the sleep.
        plain = cuda_ms(lambda: fa.flash_attention_backward_plain(q, k, v, o, lse, do, **kw),
                        iters=1, warmup=2)
        mask = (~fa.hidden_keys(c.s, c.keys, causal=c.causal, q_offset=0,
                                window=c.window, device=device) if c.window else None)
        sdpa, lib_grads = sdpa_backward(q, k, v, do, c.causal, mask)
        lib = cuda_ms(sdpa)
        lib_err = max(float((a.float() - w.float()).abs().max())
                      for a, w in zip(lib_grads, want))
        library_fn = "SDPA backward (same function)"
        if c.softcap:
            library_fn = ("SDPA backward, not the same function: no softcap"
                          + (", window as a boolean mask" if c.window else ""))
        b_ms, b_by = _flash_bwd_bound(c.b, c.s, c.h, c.kvh, c.d, c.causal, c.dtype,
                                      skv=c.skv, window=c.window)
        rows.append({"case": c.label, "shape": [c.b, c.s, c.h, c.kvh, c.d],
                     "skv": c.keys, "dtype": c.dtype, "route": fac.ROUTES[q.dtype][1],
                     "causal": c.causal, "window": c.window, "softcap": c.softcap,
                     "max_abs_err": err, "ms": kern["device"], "host_ms": kern["host"],
                     "plain_ms": plain["device"], "library_ms": lib["device"],
                     "library_fn": library_fn, "library_max_abs_err": lib_err,
                     "bound_ms": b_ms, "bound_by": b_by,
                     "pairs": c.b * c.h * flash_pairs(c.s, c.keys, c.causal, c.window)})
        del sdpa, lib_grads, mask
        log("time flash_attention_backward " + json.dumps(rows[-1]))
        del q, k, v, do, o, lse, got, want
        torch.cuda.empty_cache()
    return rows


def time_gmm_backward(device) -> list:
    """The GMM's two backward products at Granite's training shapes
    (gate/up: x (32, 1,280, 1,024), w (32, 1,024, 512); down: d and f
    swapped), bfloat16, each through the GMM kernel as `GroupedMatmul`
    launches it (dX = moe_gmm(dY, wᵀ), dW = moe_gmm(xᵀ, dY), contiguous
    transposes made outside the timed loop) against ``torch.bmm`` on the
    same operands.  Bound: `_gmm_bound` of each product."""
    import torch
    from repro_torch.kernels import moe_gmm_cuda as gmmc

    rows = []
    for label, e, n, d, f, dtype in (c for c in GMM_CASES
                                     if c[0] in ("prefill", "prefill_down")):
        x, w = _gmm_inputs(e, n, d, f, dtype, device, seed=1100)
        dy = _randn((e, n, f), 1102, device, dtype)
        wt, xt = w.transpose(1, 2).contiguous(), x.transpose(1, 2).contiguous()
        for prod, a, bb, shape in (("dx", dy, wt, (e, n, f, d)),
                                   ("dw", xt, dy, (e, d, n, f))):
            err = float((gmmc.moe_gmm_cuda(a, bb).float()
                         - torch.bmm(a.float(), bb.float())).abs().max())
            kern = cuda_ms(lambda: gmmc.moe_gmm_cuda(a, bb))
            lib = cuda_ms(lambda: torch.bmm(a, bb))
            b_ms, b_by = _gmm_bound(*shape, dtype)
            rows.append({"case": f"{label}_{prod}", "shape": list(shape), "dtype": dtype,
                         "max_abs_err": err, "ms": kern["device"],
                         "host_ms": kern["host"], "library_ms": lib["device"],
                         "bound_ms": b_ms, "bound_by": b_by})
            log("time moe_gmm_backward " + json.dumps(rows[-1]))
        del x, w, dy, wt, xt
        torch.cuda.empty_cache()
    return rows


def time_ssd_scan(device) -> list:
    """The SSD scan kernel at the SSM path's two shapes (Mamba2 2.7B and
    Zamba2 1.2B forward on 2 × 4,096 tokens, float32): kernel and plain
    version.  Bound: s and decay read once, h_prev and h_final written
    once, against 2 operations per state element and chunk at the float32
    rate.  No single PyTorch call computes this recurrence, so there is no
    library time."""
    from repro_torch.kernels import ssd_scan as ss
    from repro_torch.kernels import ssd_scan_cuda as ssc

    rows = []
    for label, nc, b, h, p, n, dtype, ddtype in SSD_CASES[:2]:
        s, d = _ssd_inputs(nc, b, h, p, n, dtype, ddtype, device, seed=800)
        got, want = ssc.ssd_scan_cuda(s, d), ss.ssd_scan_plain(s, d)
        err = max(float((g.float() - w.float()).abs().max()) for g, w in zip(got, want))
        kern = cuda_ms(lambda: ssc.ssd_scan_cuda(s, d))
        plain = cuda_ms(lambda: ss.ssd_scan_plain(s, d), iters=5, warmup=2)
        state = b * h * p * n
        moved = (s.element_size() * (2 * nc * state + state)      # s, h_prev, h_final
                 + d.element_size() * nc * b * h)                  # decay
        b_ms, b_by = bound(moved, 2 * nc * state)
        rows.append({"case": label, "shape": [nc, b, h, p, n], "dtype": dtype,
                     "max_abs_err": err, "ms": kern["device"], "host_ms": kern["host"],
                     "plain_ms": plain["device"], "library_ms": None,
                     "bound_ms": b_ms, "bound_by": b_by})
        log("time ssd_scan " + json.dumps(rows[-1]))
    log("library_ms: null for ssd_scan — no single PyTorch call computes the "
        "inter-chunk recurrence (a cumulative product-and-sum over chunks)")
    return rows


def time_ssd_intra(device) -> list:
    """The intra-chunk kernel at Mamba2's training call (b·c 16, q 256,
    h 80, p 64, float32), held to its float64 plain version first: kernel,
    and the plain version without a gradient (the in-place weights, the
    route before the kernel); bound `ssd_intra_bound`.  No single PyTorch
    call computes it: no library time."""
    import torch
    from repro_torch.kernels import ssd_intra as si
    from repro_torch.kernels import ssd_intra_cuda as sic

    label, b, c, q, h, n = SSD_INTRA_CASES[0]
    ins = _ssd_intra_inputs(b, c, q, h, n, device, seed=840)
    args = [ins[k] for k in ("x", "dt", "cum", "cb")]
    got = sic.ssd_intra_cuda(*args)
    readings = _intra_gate(label, ("y",), (got,), (si.ssd_intra_plain(*args),),
                           (si.ssd_intra_plain(*(t.double() for t in args)),))
    kern = cuda_ms(lambda: sic.ssd_intra_cuda(*args))
    with torch.no_grad():
        plain = cuda_ms(lambda: si.ssd_intra_plain(*args), iters=5, warmup=2)
    b_ms, b_by = ssd_intra_bound(b, c, q, h, 64, backward=False)
    row = {"case": label, "shape": [b, c, q, h, 64], "dtype": "float32",
           "max_abs_err": readings["y"]["max_abs_err"],
           "normwise": readings["y"]["normwise"], "ms": kern["device"],
           "host_ms": kern["host"], "plain_ms": plain["device"], "library_ms": None,
           "bound_ms": b_ms, "bound_by": b_by}
    log("time ssd_intra " + json.dumps(row))
    log("library_ms: null for ssd_intra — no single PyTorch call computes the "
        "decay-weighted intra-chunk product")
    return [row]


def time_ssd_intra_backward(device) -> list:
    """The intra-chunk backward at Mamba2's training call, held to its
    float64 plain version first: kernel and `ssd_intra_backward_plain`;
    bound `ssd_intra_bound`.  No single PyTorch call computes it: no
    library time."""
    from repro_torch.kernels import ssd_intra as si
    from repro_torch.kernels import ssd_intra_cuda as sic

    label, b, c, q, h, n = SSD_INTRA_CASES[0]
    ins = _ssd_intra_inputs(b, c, q, h, n, device, seed=850)
    args = [ins[k] for k in ("dy", "x", "dt", "cum", "cb")]
    got = sic.ssd_intra_backward_cuda(*args)
    readings = _intra_gate(label, ("dx", "ddt", "dcum", "dcb"), got,
                           si.ssd_intra_backward_plain(*args),
                           si.ssd_intra_backward_plain(*(t.double() for t in args)))
    kern = cuda_ms(lambda: sic.ssd_intra_backward_cuda(*args))
    plain = cuda_ms(lambda: si.ssd_intra_backward_plain(*args), iters=5, warmup=2)
    b_ms, b_by = ssd_intra_bound(b, c, q, h, 64, backward=True)
    row = {"case": label, "shape": [b, c, q, h, 64], "dtype": "float32",
           "max_abs_err": max(r["max_abs_err"] for r in readings.values()),
           "normwise": {k: r["normwise"] for k, r in readings.items()},
           "ms": kern["device"], "host_ms": kern["host"], "plain_ms": plain["device"],
           "library_ms": None, "bound_ms": b_ms, "bound_by": b_by}
    log("time ssd_intra_backward " + json.dumps(row))
    log("library_ms: null for ssd_intra_backward — no single PyTorch call computes "
        "the intra-chunk product's gradient")
    return [row]


def time_custom_op_dispatch(device, calls: int = 2000) -> list:
    """Host µs a call of each LM kernel through its `torch.library` op
    (`ops.flash_attention`, `ops.moe_gmm`, `ops.ssd_scan`, no gradient:
    `call_op` sends the call below the autograd step) against the entry
    point before the ops (its checks, then the CUDA wrapper: ``before``)
    and the CUDA wrapper alone (``direct``): all launch the same kernel,
    so the differences are the op's dispatch and the checks.  Beside
    them, the op called by name (``torch.ops.repro_torch.*``) through the
    dispatcher's autograd step, as a call that may take a gradient goes.
    Small shapes (Granite's heads and experts on a few rows), so the host
    bounds every loop; the loops are timed in turns (direct, before, op,
    autograd, autograd, op, before, direct) and each pair averaged."""
    import torch
    from repro_torch.kernels import flash_attention_cuda as fac
    from repro_torch.kernels import moe_gmm_cuda as gmmc
    from repro_torch.kernels import ops
    from repro_torch.kernels import ssd_scan_cuda as ssc
    from repro_torch.kernels._build import refuse_dtensor
    from repro_torch.kernels.flash_attention import _check_heads
    from repro_torch.kernels.ssd_scan import _check_shapes

    g = torch.Generator(device=device).manual_seed(0)
    by_name = torch.ops.repro_torch

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=g, device=device, dtype=torch.float32).to(dtype)

    q, k, v = randn(1, 16, 16, 64), randn(1, 16, 8, 64), randn(1, 16, 8, 64)
    x, w = randn(40, 4, 1024), randn(40, 1024, 512)
    s, d = randn(4, 1, 8, 64, 128, dtype=torch.float32), \
        torch.rand((4, 1, 8), generator=g, device=device)

    def flash_before():
        refuse_dtensor("flash_attention", q, k, v)
        _check_heads(q, k, v)
        return fac.flash_attention_cuda(q.contiguous(), k.contiguous(), v.contiguous(),
                                        causal=True, q_offset=0, window=0, softcap=0.0)

    def gmm_before():
        refuse_dtensor("moe_gmm", x, w)
        if x.dim() != 3 or w.dim() != 3 or x.shape[0] != w.shape[0] \
                or x.shape[2] != w.shape[1]:
            raise ValueError("shapes")
        return gmmc.moe_gmm_cuda(x.contiguous(), w.contiguous())

    def scan_before():
        refuse_dtensor("ssd_scan", s, d)
        _check_shapes(s, d)
        return ssc.ssd_scan_cuda(s.contiguous(), d.contiguous())

    cases = {
        "flash_attention": (lambda: ops.flash_attention(q, k, v),
                            lambda: by_name.FlashAttention(q, k, v, True, 0, 0, 0.0, False),
                            flash_before, lambda: fac.flash_attention_cuda(q, k, v)),
        "moe_gmm": (lambda: ops.moe_gmm(x, w), lambda: by_name.GroupedMatmul(x, w),
                    gmm_before, lambda: gmmc.moe_gmm_cuda(x, w)),
        "ssd_scan": (lambda: ops.ssd_scan(s, d), lambda: by_name.SSDScan(s, d),
                     scan_before, lambda: ssc.ssd_scan_cuda(s, d)),
    }

    def per_call_us(fn) -> float:
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / calls * 1e6

    rows = []
    with torch.no_grad():
        for name, (op, autograd, before, direct) in cases.items():
            d1, b1, o1, a1, a2, o2, b2, d2 = (
                per_call_us(f) for f in (direct, before, op, autograd, autograd, op,
                                         before, direct))
            row = {"kernel": name, "calls": calls, "op_us": (o1 + o2) / 2,
                   "autograd_us": (a1 + a2) / 2, "before_us": (b1 + b2) / 2,
                   "direct_us": (d1 + d2) / 2,
                   "dispatch_us": (o1 + o2 - b1 - b2) / 2}
            log("custom_op_dispatch " + json.dumps(row))
            rows.append(row)
        # Two parts of the flash op's call, alone: the empty log-sum-exp it
        # returns without a gradient, and the casts of its four scalars.
        parts = {"new_empty_us": per_call_us(lambda: q.new_empty((0,), dtype=torch.float32)),
                 "scalar_casts_us": per_call_us(lambda: (bool(True), int(0), int(0),
                                                         float(0.0)))}
        log("custom_op_dispatch_flash_parts " + json.dumps(parts))
    return rows


def time_ssd_scan_backward(device) -> list:
    """The scan's backward kernel at Mamba2's and Zamba2's training calls
    (4 × 1,024 tokens, chunk 256, float32, no g_final), held to its plain
    version under `ddecay_gates` first: kernel, plain version, and the
    forward kernel at the same shape beside it; bound `ssd_bwd_bound`.  No
    single PyTorch call computes the reverse recurrence: no library
    time."""
    from repro_torch.kernels import ssd_scan as ss
    from repro_torch.kernels import ssd_scan_cuda as ssc

    rows = []
    for label, nc, b, h, p, n, dtype, ddtype, final in SSD_BWD_CASES[:2]:
        gp, gf, hp, d = _ssd_bwd_inputs(nc, b, h, p, n, dtype, ddtype, final, device,
                                        seed=820)
        s = _randn((nc, b, h, p, n), 823, device, dtype)
        got, want = ssc.ssd_scan_backward_cuda(gp, gf, hp, d), \
            ss.ssd_scan_backward_plain(gp, gf, hp, d)
        readings = ddecay_gates(got, want, gp, gf, hp, d, ddtype, label)
        kern = cuda_ms(lambda: ssc.ssd_scan_backward_cuda(gp, gf, hp, d))
        plain = cuda_ms(lambda: ss.ssd_scan_backward_plain(gp, gf, hp, d), iters=5,
                        warmup=2)
        fwd = cuda_ms(lambda: ssc.ssd_scan_cuda(s, d))
        b_ms, b_by = ssd_bwd_bound(nc, b, h, p, n, gp.element_size(), d.element_size(),
                                   final)
        rows.append({"case": label, "shape": [nc, b, h, p, n], "dtype": dtype,
                     "max_abs_err": readings["ddecay_max_abs_err"],
                     "ms": kern["device"], "host_ms": kern["host"],
                     "plain_ms": plain["device"], "forward_ms": fwd["device"],
                     "library_ms": None, "bound_ms": b_ms, "bound_by": b_by})
        log("time ssd_scan_backward " + json.dumps(rows[-1]))
        del gp, gf, hp, d, s, got, want
    log("library_ms: null for ssd_scan_backward — no single PyTorch call computes "
        "the reverse recurrence")
    return rows


def time_device_guard(device, iters: int = 20000) -> dict:
    """Host µs of selecting the operands' card at a launch, both ways, with
    the card already current: the wrappers pass ``t.get_device()`` to the C
    entry point, which compares it with cudaGetDevice (not timed here);
    the alternative was a ``torch.cuda.device`` guard around the launch."""
    import torch

    t = torch.empty(1, device=device)

    def loop(kind: str) -> float:
        t0 = time.perf_counter()
        for _ in range(iters):
            if kind == "guard":
                with torch.cuda.device(device):
                    pass
            elif kind == "index":
                t.get_device()
        return (time.perf_counter() - t0) / iters * 1e6

    loop("guard")
    empty = min(loop("empty") for _ in range(3))
    return {"get_device_us": min(loop("index") for _ in range(3)) - empty,
            "torch_cuda_device_guard_us": min(loop("guard") for _ in range(3)) - empty,
            "empty_loop_us": empty}


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
    csrc = ROOT / CSRC
    if not all((ROOT / src).exists() for src in SOURCES.values()):
        print("chip_smoke: src/repro_torch is not beside this script", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 3
    started = time.perf_counter()
    sys.path.insert(0, str(ROOT / "src"))
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    starts = []                     # (phase, its start), in order

    def enter(name: str) -> str:
        starts.append((name, time.perf_counter()))
        return name

    phase = enter("card")
    traces = None
    try:
        card = card_line()
        log(f"card: {card}")
        log(f"torch {torch.__version__} cuda {torch.version.cuda} "
            f"python {sys.version.split()[0]}")
        phase = enter("build")
        from repro_torch.kernels import _build

        t0 = time.perf_counter()
        info = _build.build_all([lib for m in kernel_modules()
                                 for lib in getattr(m, "LIBRARIES", (m.LIBRARY,))])
        log(f"build: {len(info)} libraries from {csrc} in "
            f"{time.perf_counter() - t0:.2f} s wall")
        for name, b in info.items():
            log(f"build {name}: {b['path']} in {b['seconds']:.2f} s")
            for line in b["ptxas"].splitlines():
                if "registers" in line or "Compiling entry" in line or "spill" in line:
                    log(f"ptxas {name}: " + line.strip())
        # The dry run's fake-mode traces run beside the card's phases.
        traces = DryrunTraces()
        log_bf16_smem()
        imma = sass_opcodes("int8_matmul", "IMMA")
        log(f"sass int8_matmul: {imma} IMMA instructions")
        if imma == 0:
            raise AssertionError("the int8 GEMM is not on the s8 tensor cores")

        phase = enter("graphs")
        from repro_torch.core.dataset import synthetic_graphs
        from repro_torch.core.profiler import DeviceSetting

        graphs = synthetic_graphs(40, resolution=224)
        pop = synthetic_graphs(1024, resolution=224, seed0=10_000)
        pop2 = synthetic_graphs(256, resolution=224, seed0=20_000)
        f32 = DeviceSetting("h100_f32", "float32", "fused_groups", device="h100")
        int8 = DeviceSetting("h100_int8", "int8", "op_by_op", device="h100")

        phase = enter("parity (trees)")
        parity = [check_parity(n, m, r, device) for n, m, r in parity_models()]
        phase = enter("parity (int8)")
        gemm_parity = check_int8_gemm(graphs, device)
        phase = enter("parity (Winograd)")
        wino_parity = check_winograd(device)
        phase = enter("parity (int8 round trips and executor)")
        lut_diffs = check_int8_round_trips(device)
        check_int8_executor(graphs[:2], device, lut_diffs)
        phase = enter("parity (flash)")
        flash_parity = check_flash(device)
        flash_bwd_parity = check_flash_backward(device)
        phase = enter("parity (GMM)")
        gmm_parity = check_gmm(device)
        gmm_bwd_parity = check_gmm_backward(device)
        phase = enter("parity (LMs, card against host)")
        check_lm_on_host(device)
        phase = enter("parity (SSD scan)")
        ssd_parity = check_ssd_scan(device)
        ssd_bwd_parity = check_ssd_scan_backward(device)
        phase = enter("parity (SSD intra-chunk)")
        intra_parity = check_ssd_intra(device)
        intra_bwd_parity = check_ssd_intra_backward(device)
        phase = enter("parity (SSMs, card against host)")
        check_ssm_on_host(device)

        phase = enter("main path (float32)")
        main_f32 = run_main_path(device, f32, graphs, pop, pop2)
        tree_routes = {r: main_f32["summary"]["tree_routes"][r]
                       + sum(p["routes"][r] for p in parity)
                       for r in main_f32["summary"]["tree_routes"]}
        log("tree_routes " + json.dumps(tree_routes))
        if min(tree_routes.values()) == 0:
            raise AssertionError(f"tree routes {tree_routes}: the parity banks and "
                                 f"the main path should take every route")
        log("host_featurize_1024_cold_s " + json.dumps(cold_featurize_s(
            synthetic_graphs(1024, resolution=224, seed0=30_000))))

        phase = enter("main path (int8)")
        main_i8 = run_main_path(device, int8, graphs, pop, pop2)
        if main_i8["summary"]["launches"]["int8_matmul"] == 0:
            raise AssertionError("the int8 GEMM was never launched on the int8 path")
        i8_routes = main_i8["summary"]["routes_while_profiling"]["int8_matmul"]
        i8_launches = main_i8["summary"]["launches_while_profiling"]["int8_matmul"]
        if i8_routes["one_pass"] + i8_routes["split_k"] != i8_launches or \
                i8_routes["a_cp_async"] + i8_routes["a_words"] != i8_launches or \
                min(i8_routes.values()) == 0:
            raise AssertionError(f"int8 GEMM routes {i8_routes} for {i8_launches} "
                                 f"launches: every route should be taken")

        phase = enter("transfer path")
        t0 = time.perf_counter()
        transfer = run_transfer_path(device, int8, graphs, main_i8)
        log(f"transfer_path_s {time.perf_counter() - t0:.1f}")

        phase = enter("paper method path")
        t0 = time.perf_counter()
        run_paper_method_path(device, transfer, int8, main_i8, graphs)
        log(f"paper_method_path_s {time.perf_counter() - t0:.1f}")

        phase = enter("real-world path")
        t0 = time.perf_counter()
        run_realworld_path(device, f32, graphs, main_f32["store"])
        log(f"realworld_path_s {time.perf_counter() - t0:.1f}")

        phase = enter("search path")
        t0 = time.perf_counter()
        search = run_search_path(device, {f32: (main_f32["bank"], main_f32["store"]),
                                          int8: (main_i8["bank"], main_i8["store"])},
                                 graphs)
        log(f"search_path_s {time.perf_counter() - t0:.1f}")

        phase = enter("RPC path")
        t0 = time.perf_counter()
        run_rpc_path(device, {f32: main_f32["bank"], int8: main_i8["bank"]}, search,
                     graphs)
        log(f"rpc_path_s {time.perf_counter() - t0:.1f}")

        phase = enter("selection path")
        sel = run_selection_path(device, f32, graphs, main_f32["store"])

        phase = enter("LM serving path")
        lm = run_lm_path(device)

        phase = enter("SSM and hybrid LM path")
        ssm = run_ssm_path(device)

        phase = enter("LM zoo path")
        t0 = time.perf_counter()
        zoo = run_lm_zoo_path(device)
        log(f"lm_zoo_path_s {time.perf_counter() - t0:.1f}")

        phase = enter("serving driver path")
        t0 = time.perf_counter()
        served = run_serve_driver_path(device)
        log(f"serve_driver_path_s {time.perf_counter() - t0:.1f}")

        phase = enter("LM training path")
        t0 = time.perf_counter()
        train = run_lm_train_path(device)
        log(f"lm_train_path_s {time.perf_counter() - t0:.1f}")

        phase = enter("multi-device path")
        t0 = time.perf_counter()
        multi = run_multi_device_path(device, main_f32["bank"], pop, train)
        log(f"multi_device_path_s {time.perf_counter() - t0:.1f}")

        phase = enter("dry run path")
        t0 = time.perf_counter()
        dry = run_dryrun_path(device, traces)
        log(f"dryrun_path_s {time.perf_counter() - t0:.1f}")

        phase = enter("examples path")
        t0 = time.perf_counter()
        run_examples_path(device)
        log(f"examples_path_s {time.perf_counter() - t0:.1f}")

        phase = enter("times (device guard, tree kernels)")
        log("device_guard " + json.dumps(time_device_guard(device)))
        timed = time_kernels(main_f32["bank"], main_f32["held"], pop, device)
        preds = main_f32["bank"].predictors
        curve = auto_curve(preds.get("conv2d") or next(iter(preds.values())),
                           device)
        log("auto_curve_summary " + json.dumps(
            [(p["slots"], p["numpy_ms"], p["cuda_path_ms"]) for p in curve]))
        log("library_ms: null for the tree kernels — no single PyTorch call "
            "computes a tree-ensemble traversal")
        phase = enter("times (int8 GEMM, Winograd)")
        gemm_rows = time_int8_gemm(main_i8["held"][0], device)
        wino_rows = time_winograd(device)
        phase = enter("times (flash)")
        flash_rows = time_flash(device)
        phase = enter("times (flash backward)")
        flash_bwd_rows = time_flash_backward(device)
        phase = enter("times (GMM, SSD scan and intra-chunk, dispatch)")
        gmm_rows = time_gmm(device)
        time_gmm_backward(device)
        ssd_rows = time_ssd_scan(device)
        ssd_bwd_rows = time_ssd_scan_backward(device)
        intra_rows = time_ssd_intra(device)
        intra_bwd_rows = time_ssd_intra_backward(device)
        time_custom_op_dispatch(device)

        parity_err = max(p["fused_max_abs_err"] for p in parity)
        kernels = []
        for name in ("tree_gather_leaves", "tree_predict_fused"):
            entry = {"name": name, "route": "cuda", "source": SOURCES[name],
                     "replaces": REPLACES[name]}
            entry.update(summarize(timed[name],
                                   main_f32["summary"]["launches"][name]
                                   + multi["launches"][name],
                                   parity_err if name == "tree_predict_fused" else 0.0))
            kernels.append(entry)
        for name, rows, launches, err in (
                ("int8_matmul", gemm_rows, main_i8["summary"]["launches"],
                 gemm_parity["max_abs_err"]),
                ("winograd_conv2d", wino_rows[:1], sel["summary"]["launches"],
                 wino_parity["max_abs_err"]),
                ("flash_attention", flash_rows[:1],
                 {"flash_attention": lm["launches"]["flash_attention"]
                  + ssm["launches"]["flash_attention"]
                  + zoo["launches"]["flash_attention"]
                  + served["launches"]["flash_attention"]
                  + train["all_launches"]["flash_attention"]
                  + multi["launches"]["flash_attention"]
                  + dry["launches"]["flash_attention"]},
                 flash_parity["max_abs_err"]),
                ("flash_attention_backward", flash_bwd_rows[:1],
                 {"flash_attention_backward":
                  train["all_launches"]["flash_attention_backward"]
                  + multi["launches"]["flash_attention_backward"]
                  + dry["launches"]["flash_attention_backward"]},
                 flash_bwd_parity["max_abs_err"]),
                ("moe_gmm", [r for r in gmm_rows
                             if r["l2"] == "warm" and r["dtype"] == "bfloat16"],
                 {"moe_gmm": lm["launches"]["moe_gmm"]
                  + served["launches"]["moe_gmm"]
                  + train["all_launches"]["moe_gmm"]
                  + multi["launches"]["moe_gmm"]
                  + dry["launches"]["moe_gmm"]},
                 max(gmm_parity["max_abs_err"], gmm_bwd_parity["max_abs_err"]))):
            entry = {"name": name, "route": "cuda", "source": SOURCES[name],
                     "replaces": REPLACES[name]}
            entry.update(summarize(rows, launches[name], err))
            entry["library_ms"] = math.fsum(r["library_ms"] for r in rows)
            kernels.append(entry)
        for name, rows, launches, err in (
                ("ssd_scan", ssd_rows[:1], ssm["launches"]["ssd_scan"]
                 + train["all_launches"]["ssd_scan"], ssd_parity["max_abs_err"]),
                ("ssd_scan_backward", ssd_bwd_rows[:1],
                 train["all_launches"]["ssd_scan_backward"],
                 ssd_bwd_parity["max_abs_err"]),
                ("ssd_intra", intra_rows, ssm["launches"]["ssd_intra"]
                 + train["all_launches"]["ssd_intra"], intra_parity["max_abs_err"]),
                ("ssd_intra_backward", intra_bwd_rows,
                 train["all_launches"]["ssd_intra_backward"],
                 intra_bwd_parity["max_abs_err"])):
            entry = {"name": name, "route": "cuda", "source": SOURCES[name],
                     "replaces": REPLACES[name]}
            entry.update(summarize(rows, launches, err))
            kernels.append(entry)
        ends = [t for _, t in starts[1:]] + [time.perf_counter()]
        log("phase_s " + json.dumps({name: round(end - t, 1)
                                     for (name, t), end in zip(starts, ends)}))
        log(f"chip_smoke: all phases in {time.perf_counter() - started:.1f} s")
        log(f"card: {card_line()}")
        log(json.dumps({"kernels": kernels}))
    except Exception:
        traceback.print_exc()
        print(f"chip_smoke: FAIL in phase {phase}", file=sys.stderr)
        return 1
    finally:
        if traces is not None:
            traces.stop()
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
