#!/usr/bin/env python3
"""Time kernels of an earlier commit against this tree's, in turns, on one
NVIDIA H100.

    git archive <parent> src/repro_torch/kernels/csrc | tar -x -C build/parent
    python3 compare_kernels.py build/parent/src/repro_torch/kernels/csrc \
        [out.json] [--only int8_matmul,winograd_conv,tree_gather]
    python3 compare_kernels.py --sweep [out.json] [--only tree_gather]

Builds the parent's sources of the chosen kernels (default: all seven,
``flash_attention``, ``flash_attention_bwd``, ``moe_gmm``,
``int8_matmul``, ``winograd_conv``, ``tree_gather``,
``ssd_scan_backward``) with this tree's nvcc flags (into ``build/``), and
this tree's kernels through their wrappers.  At each shape both outputs
are first held to their plain version, then the two are timed parent,
change, change, parent with `chip_smoke.cuda_ms` (device time per call):
  * flash: its ``FLASH_TIMED`` cases without a window, a softcap or
    sq != skv (the parent's function), within ``LM_TOL``;
  * flash backward: ``FLASH_BWD_TIMED`` without a window or a softcap
    (Granite's training call, bfloat16 and float32, and the VLM's and
    Whisper's non-causal ones: the parent's function), dq, dk and dv within ``LM_TOL`` and, in bfloat16, row by
    row within ``FLASH_ROW_TOL`` (`_bwd_row_check`), with SDPA's backward
    (`chip_smoke.sdpa_backward`) beside them;
  * the SSD scan's backward (``ssd_scan_backward``): no parent (the
    kernel is new), so this tree's kernel alone, as
    `chip_smoke.time_ssd_scan_backward` holds and times it at
    ``SSD_BWD_CASES``' two training calls (Mamba2's and Zamba2's), with
    the forward kernel at the same shape and the bound beside it;
  * GMM: its ``GMM_TIMED`` shapes on the input sets ``_gmm_turns`` hands
    out (the four serving shapes, and the two decode shapes with a cold
    L2), within ``LM_TOL``;
  * int8 GEMM: the 13 GEMMs of one int8 forward of the main path's
    held-out graph (`chip_smoke.int8_timed_cases`), bit-equal; the
    change gets A as the executor lays it out (im2col rows padded to 16
    bytes), the parent a contiguous copy, as its executor gave it;
  * Winograd: the four `STUDY_SHAPES`, within ``WINO_TOL``;
  * tree kernels (`tree_shapes`): both kernels at `TREE_ROWS` on the two
    banks of `chip_smoke.parity_models`, the fused kernel at the main
    path's ten op-type row counts and the leaves kernel at its held-out
    ones, on the GBDT bank; leaves bit-equal, fused within
    `chip_smoke.fused_tolerance` (and the change's repeatable); then the
    same on the ``rf`` banks the service trains on chip_smoke's profiled
    graphs (`path_rf_models`), at the main path's rows.  The
    parent is called with its wrapper's host work, so ``host`` ms are
    comparable; the parent's unstaged (global) route and the launch floor
    are timed beside it.
The library call and the bound are those of `chip_smoke.py`.  Prints the
card line and one JSON line per shape, and writes them all to
``out.json`` when it is given.

``--sweep`` times, instead, every launch plan of this tree's int8 GEMM
(block tile × split of k) at those 13 shapes, every Winograd block
tile × step at those four, and every threads-a-row count and lane layout
of the tree kernels at `tree_shapes`, each checked first, beside the plan
that `int8_matmul_cuda.plan` / `winograd_conv_cuda.plan` /
`tree_gather_cuda.plan` picks: the data the plans' rules were read from.

The parent's C interfaces are those of the commit before the int8 and
Winograd redesign: ``int8_matmul_launch(a, bt, bias, out, m, n, k, ldb,
scale, stream)`` (contiguous A) and ``winograd_conv_launch(tiles, u, y,
t, c, k, stream)``; of the commit before the tree redesign:
``tree_gather_leaves_launch(nodes, value, roots, x, out, rows, d,
n_nodes, n_trees, depth, rows_per_block, bank_in_smem, grid, smem_bytes,
stream)`` and ``tree_predict_fused_launch`` likewise (with mean, std,
scale, bias and the reduction), launched as `parent_tree_plan` plans;
the GMM's is this tree's; the flash backward's that of the commit before
window and softcap (``flash_attention_bwd_launch(q, k, v, o, dout, lse,
delta, dq, dk, dv, b, sq, skv, heads, kv_heads, d, dtype, causal,
q_offset, scale, device, stream)``: the parent is called with the same
operands and a D scratch of its own, the change through its wrapper
without masks); and flash's that of the
commit before the log-sum-exp output
(``flash_attention_launch`` without ``lse``: the parent is called with
window 0 and softcap 0, the change through its wrapper, whose inference
launch passes a null ``lse``).
"""
from __future__ import annotations

import ctypes
import itertools
import json
import math
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent


KERNELS = ("flash_attention", "flash_attention_bwd", "moe_gmm", "int8_matmul",
           "winograd_conv", "tree_gather", "ssd_scan_backward")
# Kernels without a parent source: this tree's is timed alone.
NEW_KERNELS = ("ssd_scan_backward",)
# Rows timed on each tree bank of `chip_smoke.parity_models` (the main
# path's own op-type shapes are added by `tree_shapes`).
TREE_ROWS = {"gbdt_150x4": (5, 64, 527, 2048, 11437, 32768),
             "rf_10x14": (2048, 32768)}


def build_parent(csrc: Path, names) -> dict:
    """nvcc the parent's sources in parallel; name → loaded library."""
    from repro_torch.kernels import _build

    out = _build.BUILD_DIR / "parent"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        so = out / f"lib{name}_parent.so"
        procs[name] = (so, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so), str(csrc / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    libs = {}
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    argtypes = {
        "flash_attention": [p, p, p, p, i, i, i, i, i, i, i, i, i, i, f, f, i, p],
        "flash_attention_bwd": [p] * 10 + [i] * 9 + [f, i, p],
        "moe_gmm": [p, p, p, i, i, i, i, i, i, p],
        "int8_matmul": [p, p, p, p, i, i, i, i, f, p],
        "winograd_conv": [p, p, p, i, i, i, p]}
    z = ctypes.c_size_t
    argtypes["tree_gather_leaves"] = [p, p, p, p, p, i, i, i, i, i, i, i, i, z, p]
    argtypes["tree_predict_fused"] = [p, p, p, p, p, p, p, i, i, i, i, i, i, i,
                                      f, f, i, i, z, p]
    for name, (so, proc) in procs.items():
        _, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for the parent's {name}.cu:\n{err}")
        lib = ctypes.CDLL(str(so))
        for fn in (("tree_gather_leaves", "tree_predict_fused")
                   if name == "tree_gather" else (name,)):
            launch = getattr(lib, f"{fn}_launch")
            launch.argtypes = argtypes[fn]
            launch.restype = i
        libs[name] = lib
    return libs


def parent_flash(lib, q, k, v, causal):
    import torch

    b, sq, h, d = q.shape
    out = torch.empty_like(q)
    err = lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, sq, k.shape[1],
        h, k.shape[2], d, 1 if q.dtype == torch.bfloat16 else 0, int(causal), 0, 0,
        0.0, 1.0 / math.sqrt(d), q.get_device(), torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"parent flash_attention launch failed: {err}")
    return out


def change_flash(fac, q, k, v, causal):
    """This tree's kernel at the parent's function: no window, no softcap."""
    return fac.flash_attention_cuda(q, k, v, causal=causal, window=0, softcap=0.0)


def parent_flash_bwd(lib, q, k, v, o, lse, do, causal):
    """(dq, dk, dv) from the parent's backward entry point."""
    import torch

    b, sq, h, d = q.shape
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    err = lib.flash_attention_bwd_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        b, sq, k.shape[1], h, k.shape[2], d, 1 if q.dtype == torch.bfloat16 else 0,
        int(causal), 0, 1.0 / math.sqrt(d), q.get_device(),
        torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"parent flash_attention_bwd launch failed: {err}")
    return dq, dk, dv


def parent_gmm(lib, x, w):
    import torch

    e, c, d = x.shape
    out = torch.empty((e, c, w.shape[2]), dtype=x.dtype, device=x.device)
    err = lib.moe_gmm_launch(x.data_ptr(), w.data_ptr(), out.data_ptr(), e, c, d,
                             w.shape[2], 1 if x.dtype == torch.bfloat16 else 0,
                             x.get_device(), torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"parent moe_gmm launch failed: {err}")
    return out


def in_turns(cs, parent, change) -> dict:
    """Device ms per launch, timed parent, change, change, parent."""
    t = [cs.cuda_ms(fn)["device"] for fn in (parent, change, change, parent)]
    p, c = (t[0] + t[3]) / 2, (t[1] + t[2]) / 2
    return {"parent_ms": [t[0], t[3]], "change_ms": [t[1], t[2]],
            "parent_mean_ms": p, "change_mean_ms": c, "speedup": p / c}


def compare_flash(cs, lib, device) -> list:
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_attention_cuda as fac

    rows = []
    for label, b, s, h, kvh, d, causal, dtype, *_ in (
            c for c in cs.FLASH_CASES if c.label in cs.FLASH_TIMED
            and not c.skv and not c.window and not c.softcap):
        q, k, v = cs._flash_inputs(b, s, h, kvh, d, dtype, device, seed=500)
        want = fa.flash_attention_plain(q, k, v, causal=causal)
        errs = {}
        for who, fn in (("parent", lambda: parent_flash(lib, q, k, v, causal)),
                        ("change", lambda: change_flash(fac, q, k, v, causal))):
            errs[who] = cs._rel_check(f"{who} flash {label}", fn(), want,
                                      cs.LM_TOL[dtype])[1]
        row = {"kernel": "flash_attention", "case": label, "shape": [b, s, h, kvh, d],
               "dtype": dtype, "err_over_max": errs}
        row.update(in_turns(cs, lambda: parent_flash(lib, q, k, v, causal),
                            lambda: change_flash(fac, q, k, v, causal)))
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        row["library_ms"] = cs.cuda_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal, enable_gqa=True))["device"]
        row["bound_ms"], row["bound_by"] = cs._flash_bound(b, s, h, kvh, d, causal, dtype)
        rows.append(row)
        cs.log("compare " + json.dumps(row))
        del q, k, v, want
        torch.cuda.empty_cache()
    return rows


def compare_flash_bwd(cs, lib, device) -> list:
    """The flash backward at ``FLASH_BWD_TIMED`` from the forward's output
    and log-sum-exp (this tree's forward kernel): parent and change held to
    `flash_attention_backward_plain`, then timed in turns, with SDPA's
    backward and `chip_smoke._flash_bwd_bound` beside them."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_attention_cuda as fac

    rows = []
    for c in (c for c in cs.FLASH_CASES if c.label in cs.FLASH_BWD_TIMED
              and not c.window and not c.softcap):
        q, k, v = cs._flash_inputs(c.b, c.s, c.h, c.kvh, c.d, c.dtype, device, seed=1000,
                                   skv=c.skv)
        do = cs._randn((c.b, c.s, c.h, c.d), 1003, device, c.dtype)
        o, lse = fac.flash_attention_cuda(q, k, v, causal=c.causal, return_lse=True)
        want = fa.flash_attention_backward_plain(q, k, v, o, lse, do, causal=c.causal)

        def parent():
            return parent_flash_bwd(lib, q, k, v, o, lse, do, c.causal)

        def change():
            return fac.flash_attention_backward_cuda(q, k, v, o, lse, do, causal=c.causal)

        errs = {}
        for who, fn in (("parent", parent), ("change", change)):
            errs[who] = {}
            for name, g, w in zip(("dq", "dk", "dv"), fn(), want):
                label = f"{who} flash backward {c.label} {name}"
                errs[who][name] = {"err_over_max": cs._rel_check(
                    label, g, w, cs.LM_TOL[c.dtype])[1]}
                if c.dtype == "bfloat16":
                    errs[who][name]["row_err_over_max"] = cs._bwd_row_check(
                        label, g, w, cs.FLASH_ROW_TOL)
        row = {"kernel": "flash_attention_bwd", "case": c.label,
               "shape": [c.b, c.s, c.h, c.kvh, c.d], "skv": c.keys, "dtype": c.dtype,
               "route": fac.ROUTES[q.dtype][1], "err_over_max": errs}
        row.update(in_turns(cs, parent, change))
        sdpa, _ = cs.sdpa_backward(q, k, v, do, c.causal)
        row["library_ms"] = cs.cuda_ms(sdpa)["device"]
        row["bound_ms"], row["bound_by"] = cs._flash_bwd_bound(
            c.b, c.s, c.h, c.kvh, c.d, c.causal, c.dtype, skv=c.skv)
        rows.append(row)
        cs.log("compare " + json.dumps(row))
        del q, k, v, do, o, lse, want, sdpa
        torch.cuda.empty_cache()
    return rows


def compare_ssd_bwd(cs, lib, device) -> list:
    """The SSD scan's backward (no parent: ``lib`` is None):
    `chip_smoke.time_ssd_scan_backward`'s rows, gates, times and bound
    included, as change-only rows."""
    return [dict(row, kernel="ssd_scan_backward", parent_ms=None, change_ms=row["ms"])
            for row in cs.time_ssd_scan_backward(device)]


def compare_gmm(cs, lib, device) -> list:
    import torch
    from repro_torch.kernels import moe_gmm as gmm
    from repro_torch.kernels import moe_gmm_cuda as gmmc

    rows = []
    for (label, e, n, d, f, dtype), n_sets in cs.GMM_TIMED:
        sets, turn = cs._gmm_turns(e, n, d, f, dtype, device, n_sets)
        errs = {"parent": 0.0, "change": 0.0}
        for x, w in sets:
            want = gmm.moe_gmm_plain(x, w)
            for who, got in (("parent", parent_gmm(lib, x, w)),
                             ("change", gmmc.moe_gmm_cuda(x, w))):
                errs[who] = max(errs[who], cs._rel_check(
                    f"{who} gmm {label}", got, want, cs.LM_TOL[dtype])[1])
        row = {"kernel": "moe_gmm", "case": label + ("_cold" if n_sets > 1 else ""),
               "shape": [e, n, d, f], "dtype": dtype,
               "l2": "cold" if n_sets > 1 else "warm", "err_over_max": errs}
        row.update(in_turns(cs, lambda: parent_gmm(lib, *turn()),
                            lambda: gmmc.moe_gmm_cuda(*turn())))
        row["library_ms"] = cs.cuda_ms(lambda: torch.bmm(*turn()))["device"]
        row["bound_ms"], row["bound_by"] = cs._gmm_bound(e, n, d, f)
        rows.append(row)
        cs.log("compare " + json.dumps(row))
        del sets, turn
        torch.cuda.empty_cache()
    return rows


def parent_int8(lib, a, bt, scale, bias):
    import torch

    (m, k), (n, ldb) = a.shape, bt.shape
    out = torch.empty((m, n), dtype=torch.float32, device=a.device)
    err = lib.int8_matmul_launch(a.data_ptr(), bt.data_ptr(), bias.data_ptr(),
                                 out.data_ptr(), m, n, k, ldb, scale,
                                 torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"parent int8_matmul launch failed: {err}")
    return out


def parent_winograd(lib, tiles, u):
    import torch

    t, _, c = tiles.shape
    k = u.shape[2]
    out = torch.empty((t, 4, k), dtype=torch.float32, device=tiles.device)
    err = lib.winograd_conv_launch(tiles.data_ptr(), u.data_ptr(), out.data_ptr(),
                                   t, c, k, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"parent winograd_conv launch failed: {err}")
    return out


def compare_int8(cs, lib, device) -> list:
    import torch
    from repro_torch.core.dataset import synthetic_graphs
    from repro_torch.kernels import int8_matmul as im
    from repro_torch.kernels import int8_matmul_cuda as imc

    graph = synthetic_graphs(40, resolution=224)[32]     # the int8 path's held[0]
    scale = im.out_scale(cs.INT8_SCALE, 1.0)
    rows = []
    for row, a, b, bt, bias in cs.int8_timed_cases(graph, device):
        m, k, n = row["m"], row["k"], row["n"]
        ac = a.contiguous()
        want = im.int8_matmul_plain(a, bt, scale, bias)
        for who, got in (("parent", parent_int8(lib, ac, bt, scale, bias)),
                         ("change", imc.int8_matmul_cuda(a, bt, scale, bias))):
            if not torch.equal(got, want):
                raise AssertionError(f"{who} int8 GEMM differs at {(m, k, n)}")
        row.update({"kernel": "int8_matmul", "route": cs.int8_route(m, k, n, a),
                    "bit_equal": True})
        row.update(in_turns(cs, lambda: parent_int8(lib, ac, bt, scale, bias),
                            lambda: imc.int8_matmul_cuda(a, bt, scale, bias)))
        ap, bp, _ = cs._int_mm_operands(a, b, device)
        row["library_ms"] = cs.cuda_ms(lambda: torch._int_mm(ap, bp))["device"]
        row["bound_ms"], row["bound_by"] = cs._int8_bound(m, k, n)
        rows.append(row)
        cs.log("compare " + json.dumps(row))
    total = {key: math.fsum(r[key] for r in rows)
             for key in ("parent_mean_ms", "change_mean_ms", "library_ms", "bound_ms")}
    total["speedup"] = total["parent_mean_ms"] / total["change_mean_ms"]
    cs.log("compare int8_matmul_sum " + json.dumps(total))
    return rows


def compare_winograd(cs, lib, device) -> list:
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import winograd_conv as wc
    from repro_torch.kernels import winograd_conv_cuda as wcc

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    rows = []
    for i, name in enumerate(cs.winograd_names()):
        case = cs.winograd_case(name, i, device)
        tiles, u = case["tiles"], case["u"]
        want = wc.winograd_tiles_plain(tiles, u)
        scale = float(want.abs().max())
        errs = {}
        for who, got in (("parent", parent_winograd(lib, tiles, u)),
                         ("change", wcc.winograd_tiles_cuda(tiles, u))):
            errs[who] = float((got - want).abs().max()) / scale
            if not errs[who] <= cs.WINO_TOL:
                raise AssertionError(f"{who} Winograd {name}: {errs[who]} × max")
        pl = wcc.plan(case["t"], case["c"], case["k"])
        row = {"kernel": "winograd_conv", "case": name, "tiles": case["t"],
               "c": case["c"], "k": case["k"], "route": f"{pl.route} ({pl.blocks} blocks)",
               "err_over_max": errs}
        row.update(in_turns(cs, lambda: parent_winograd(lib, tiles, u),
                            lambda: wcc.winograd_tiles_cuda(tiles, u)))
        row["library_ms"] = cs.cuda_ms(
            lambda: F.conv2d(case["xc"], case["w_oihw"], padding=1))["device"]
        row["bound_ms"], row["bound_by"] = case["bound_ms"], case["bound_by"]
        rows.append(row)
        cs.log("compare " + json.dumps(row))
    return rows


def parent_tree_plan(n_nodes: int, rows: int, d: int, n_sm: int) -> dict:
    """The parent's launch plan (its ``tree_gather_cuda.launch_plan``):
    the bank in shared memory when it fits beside a 32-row block, a
    persistent grid."""
    rows_per_block, optin, per_sm_bytes = 32, 232448, 233472
    x_bytes = rows_per_block * d * 4
    bank_bytes = n_nodes * 20
    in_smem = bank_bytes + x_bytes <= optin
    smem = (bank_bytes if in_smem else 0) + x_bytes
    per_sm = max(1, min(8, per_sm_bytes // (smem + 1024)))
    return {"bank_in_smem": int(in_smem), "smem_bytes": smem,
            "grid": max(1, min(-(-rows // rows_per_block), n_sm * per_sm))}


# The parent's packed node array of each bank (its `CudaBank.nodes`, which
# it built for every bank on the card), built once by `parent_nodes`.
_PARENT_NODES: dict = {}


def parent_nodes(db):
    """The (n_nodes, 4) int32 node rows the parent's kernels read for the
    bank ``db``: `tree_gather.packed_layout`, built once a bank (as the
    parent built it once, at upload) and kept beside the bank."""
    from repro_torch.kernels import tree_gather as tg

    if id(db) not in _PARENT_NODES:
        _PARENT_NODES[id(db)] = (db, tg.packed_layout(*db.bank_args))
    return _PARENT_NODES[id(db)][1]


def parent_tree(lib, db, x, fused=None, staged=True):
    """One launch of the parent's leaves kernel, or (``fused`` = (mean,
    std, scale, bias, kind)) of its fused kernel, with the parent
    wrapper's host work on every call: its argument checks, the SM count
    asked of the CUDA runtime and its launch plan.  ``staged=False`` takes the
    parent's global route (the bank read through L1 and L2, not staged)
    whatever the bank's size."""
    import numpy as np
    import torch
    from repro_torch.kernels._build import check_tensor

    rows, d = x.shape
    nodes = parent_nodes(db)
    check_tensor(x, "x", torch.float32, db.device, tuple(x.shape))
    check_tensor(nodes, "bank.nodes", torch.int32, db.device, (db.n_nodes, 4))
    check_tensor(db.value, "bank.value", torch.float32, db.device, (db.n_nodes,))
    check_tensor(db.roots, "bank.roots", torch.int32, db.device, (db.n_trees,))
    if fused is not None:
        check_tensor(fused[0], "mean", torch.float32, db.device, (d,))
        check_tensor(fused[1], "std", torch.float32, db.device, (d,))
    n_sm = torch.cuda.get_device_properties(db.device).multi_processor_count
    pl = parent_tree_plan(db.n_nodes if staged else 1 << 30, rows, d, n_sm)
    stream = torch.cuda.current_stream().cuda_stream
    if fused is None:
        out = torch.empty((rows, db.n_trees), dtype=torch.float32, device=x.device)
        err = lib.tree_gather_leaves_launch(
            nodes.data_ptr(), db.value.data_ptr(), db.roots.data_ptr(), x.data_ptr(),
            out.data_ptr(), rows, d, db.n_nodes, db.n_trees, db.depth, 32,
            pl["bank_in_smem"], pl["grid"], pl["smem_bytes"], stream)
    else:
        mean, std, scale, bias, kind = fused
        out = torch.empty((rows,), dtype=torch.float32, device=x.device)
        err = lib.tree_predict_fused_launch(
            nodes.data_ptr(), db.value.data_ptr(), db.roots.data_ptr(), x.data_ptr(),
            mean.data_ptr(), std.data_ptr(), out.data_ptr(), rows, d, db.n_nodes,
            db.n_trees, db.depth, 32, pl["bank_in_smem"], float(np.float32(scale)),
            float(np.float32(bias)), int(kind == "mean"), pl["grid"], pl["smem_bytes"],
            stream)
    if err:
        raise RuntimeError(f"parent tree launch failed: {err}")
    return out


def tree_shapes(cs) -> list:
    """(bank, kernel, label, rows): the fixed rows of `TREE_ROWS` for both
    kernels, then the main path's own row counts (chip_smoke's graphs:
    each op type the 32 training graphs give a model, with at least 5
    rows) on the GBDT bank: the fused kernel at the 1,024-graph
    population's rows, the leaves kernel at the 8 held-out graphs'."""
    from repro_torch.core.dataset import synthetic_graphs

    graphs = synthetic_graphs(40, resolution=224)
    types = [t for t, x in cs.per_type_matrices(graphs[:32], _all_types(graphs), True).items()
             if len(x) >= 5]
    pop = cs.per_type_matrices(synthetic_graphs(1024, resolution=224, seed0=10_000),
                               types, True)
    held = cs.per_type_matrices(graphs[32:], types, True)
    out = [(bank, kernel, f"rows{rows}", rows) for bank, rs in TREE_ROWS.items()
           for rows in rs for kernel in ("tree_predict_fused", "tree_gather_leaves")]
    out += [("gbdt_150x4", "tree_predict_fused", f"main:{t}", len(x)) for t, x in pop.items()]
    out += [("gbdt_150x4", "tree_gather_leaves", f"held:{t}", len(x)) for t, x in held.items()]
    return out


def _all_types(graphs) -> list:
    from repro_torch.core.features import graph_features
    from repro_torch.core.fusion import fuse_graph

    return sorted({t for g in graphs for t in graph_features(fuse_graph(g)[1]).matrix})


def _tree_inputs(cs, model, rows, device, seed):
    """Raw and standardized float32 rows of chip_smoke's parity features,
    the scaler on the card and the model's reduction."""
    import numpy as np
    import torch
    from repro_torch.kernels import tree_gather as tg

    rng = np.random.default_rng(seed)
    raw = np.abs(rng.standard_normal((rows, cs.N_FEATURES))) * np.linspace(1, 50, cs.N_FEATURES)
    xr = torch.from_numpy(raw.astype(np.float32)).to(device)
    xs = torch.from_numpy(model.scaler.transform(raw).astype(np.float32)).to(device)
    mean, std = tg.to_device_scaler(model.scaler, device)
    return xr, xs, mean, std, model._device_reduction()


def _tree_check(cs, db, got, xr, xs, mean, std, red, fused: bool, label: str) -> float:
    """Leaves bit-equal to the plain version, or the fused prediction within
    `chip_smoke.fused_tolerance`; returns the max |err| (0 for leaves)."""
    import torch
    from repro_torch.kernels import tree_gather as tg

    kind, scale, bias = red
    if not fused:
        if not torch.equal(got, tg.gather_leaves_plain(*db.bank_args, xs, depth=db.depth)):
            raise AssertionError(f"tree leaves differ: {label}")
        return 0.0
    want = tg.fused_plain(*db.bank_args, mean, std, scale, bias, xr, depth=db.depth, kind=kind)
    leaves = tg.gather_leaves_plain(*db.bank_args, (xr - mean) / std, depth=db.depth)
    err = (got.double() - want.double()).abs()
    if not bool((err <= cs.fused_tolerance(leaves, want, scale, kind)).all()):
        raise AssertionError(f"fused tree prediction off: {label}: {float(err.max())}")
    return float(err.max())


def _compare_tree_shape(cs, lib, db, model, kernel, bank, label, inputs) -> dict:
    """One shape of `compare_tree`: both outputs checked, then parent,
    change, change, parent."""
    import torch
    from repro_torch.kernels import tree_gather_cuda as tgc

    xr, xs, mean, std, red = inputs
    rows, d = xs.shape
    kind, scale, bias = red
    fused = kernel == "tree_predict_fused"
    if fused:
        args = (mean, std, scale, bias, kind)
        par = lambda: parent_tree(lib, db, xr, args)  # noqa: E731
        chg = lambda: tgc.fused_predict_cuda(db, mean, std, scale, bias, xr, kind)  # noqa: E731
    else:
        par = lambda: parent_tree(lib, db, xs)  # noqa: E731
        chg = lambda: tgc.gather_leaves_cuda(db, xs)  # noqa: E731
    errs = {who: _tree_check(cs, db, fn(), xr, xs, mean, std, red, fused,
                             f"{who} {kernel} {bank} {label}")
            for who, fn in (("parent", par), ("change", chg))}
    if fused and not torch.equal(chg(), chg()):
        raise AssertionError(f"fused tree kernel not repeatable: {bank} {label}")
    pl = tgc.plan_for(db, rows, d, fused)
    n_sm = torch.cuda.get_device_properties(db.device).multi_processor_count
    row = {"kernel": kernel, "bank": bank, "case": label, "rows": rows, "d": d,
           "trees": db.n_trees, "depth": db.depth, "nodes": db.n_nodes,
           "plan": {"route": pl.route, "groups": pl.groups,
                    "rows_on_lanes": pl.rows_on_lanes,
                    "grid": pl.grid, "smem": pl.smem_bytes},
           "parent_plan": parent_tree_plan(db.n_nodes, rows, d, n_sm),
           "max_abs_err": errs}
    t = [cs.cuda_ms(fn) for fn in (par, chg, chg, par)]
    row.update({"parent_ms": [t[0]["device"], t[3]["device"]],
                "change_ms": [t[1]["device"], t[2]["device"]],
                "parent_host_ms": [t[0]["host"], t[3]["host"]],
                "change_host_ms": [t[1]["host"], t[2]["host"]]})
    row["parent_mean_ms"] = (t[0]["device"] + t[3]["device"]) / 2
    row["change_mean_ms"] = (t[1]["device"] + t[2]["device"]) / 2
    row["speedup"] = row["parent_mean_ms"] / row["change_mean_ms"]
    if db.cnodes is not None:
        # The parent's time without staging: its global route.
        x_in, args_in = (xr, (mean, std, scale, bias, kind)) if fused else (xs, None)
        row["parent_unstaged_ms"] = cs.cuda_ms(
            lambda: parent_tree(lib, db, x_in, args_in, staged=False))["device"]
    row["bound_ms"], row["bound_by"] = cs.bound(*cs.traffic(db, rows, d, fused))
    cs.log("compare " + json.dumps(row))
    return row


def path_rf_models(cs, device) -> tuple:
    """The ``rf`` banks the service trains on chip_smoke's graphs: the 40
    graphs profiled on the card (float32 setting of the main path), then
    `PredictorHub.train` with the ``rf`` family (`FAST_HPARAMS`) on the 32
    training graphs, as `LatencyService` gets them.  Returns (op type →
    model, op type → population rows, op type → held-out rows), the rows
    float32 features as the service stages them."""
    from repro_torch.core.dataset import synthetic_graphs
    from repro_torch.core.profiler import DeviceSetting, ProfileSession
    from repro_torch.pipeline import PredictorHub, ProfileStore

    graphs = synthetic_graphs(40, resolution=224)
    setting = DeviceSetting("h100_f32", "float32", "fused_groups", device="h100")
    store = ProfileStore()
    ProfileSession(store=store, device=device).profile_suite(graphs, setting)
    models = PredictorHub().train(
        store, setting, "rf", fingerprints=[g.fingerprint() for g in graphs[:32]],
        save=False).predictors
    pop = cs.per_type_matrices(synthetic_graphs(1024, resolution=224, seed0=10_000),
                               models, True)
    held = cs.per_type_matrices(graphs[32:], models, True)
    return models, pop, held


def compare_tree(cs, lib, device) -> list:
    """Both tree kernels, parent vs change in turns, at `tree_shapes`, then
    on the service's ``rf`` banks (`path_rf_models`: the fused kernel at
    the population's rows of each op type, the leaves kernel at the
    held-out rows, on the op type's own features); each output checked
    first (leaves bit-equal, fused within tolerance, the change's fused
    also repeatable); ``host`` ms a call beside ``device``, the parent's
    unstaged route beside its plan on the GBDT bank, and the launch floor
    (``torch.cuda._sleep(0)`` back to back)."""
    import numpy as np
    import torch
    from repro_torch.kernels import tree_gather as tg

    models = {name: m for name, m, _ in cs.parity_models()}
    rows_out = []
    for i, (bank, kernel, label, rows) in enumerate(tree_shapes(cs)):
        model = models[bank]
        db = model.flat().device_bank(device)
        inputs = _tree_inputs(cs, model, rows, device, seed=700 + i)
        rows_out.append(_compare_tree_shape(cs, lib, db, model, kernel, bank,
                                            label, inputs))
    rf, pop, held = path_rf_models(cs, device)
    for prefix, kernel, mats in (("rfmain:", "tree_predict_fused", pop),
                                 ("rfheld:", "tree_gather_leaves", held)):
        for t, raw in mats.items():
            model = rf[t]
            db = model.flat().device_bank(device)
            xr = torch.from_numpy(np.ascontiguousarray(raw, dtype=np.float32)).to(device)
            xs = torch.from_numpy(model.scaler.transform(raw.astype(np.float64))
                                  .astype(np.float32)).to(device)
            mean, std = tg.to_device_scaler(model.scaler, device)
            rows_out.append(_compare_tree_shape(
                cs, lib, db, model, kernel, f"rf_path:{t}", f"{prefix}{t}",
                (xr, xs, mean, std, model._device_reduction())))
    for prefix, kernel in (("main:", "tree_predict_fused"), ("held:", "tree_gather_leaves"),
                           ("rfmain:", "tree_predict_fused"),
                           ("rfheld:", "tree_gather_leaves")):
        sel = [r for r in rows_out if r["case"].startswith(prefix)]
        total = {k: math.fsum(r[k] for r in sel)
                 for k in ("parent_mean_ms", "change_mean_ms", "bound_ms")}
        total["speedup"] = total["parent_mean_ms"] / total["change_mean_ms"]
        total["shapes"] = len(sel)
        total["slower_than_parent"] = [r["case"] for r in sel if r["speedup"] < 1]
        cs.log(f"compare {kernel}_sum_{prefix[:-1]} " + json.dumps(total))
    floor = cs.cuda_ms(lambda: torch.cuda._sleep(0), iters=200)
    cs.log("compare launch_floor " + json.dumps(floor))
    rows_out.append({"kernel": "launch_floor", "device_ms": floor["device"],
                     "host_ms": floor["host"]})
    return rows_out


def sweep_tree(cs, device) -> list:
    """Every route and threads-a-row count of the tree kernels' plan at
    `tree_shapes`: device ms each (output checked first), beside `plan`'s
    choice."""
    import torch
    from repro_torch.kernels import tree_gather_cuda as tgc

    models = {name: m for name, m, _ in cs.parity_models()}
    n_sm = torch.cuda.get_device_properties(device).multi_processor_count
    rows_out = []
    for i, (bank, kernel, label, rows) in enumerate(tree_shapes(cs)):
        model = models[bank]
        db = model.flat().device_bank(device)
        xr, xs, mean, std, red = _tree_inputs(cs, model, rows, device, seed=700 + i)
        kind, scale, bias = red
        fused = kernel == "tree_predict_fused"
        timed = []
        route = "staged" if db.cnodes is not None else "packed"
        for groups, on_lanes in itertools.product(tgc.GROUPS, (False, True)):
            try:
                pl = tgc.make_plan(route, groups, on_lanes, db.n_trees, db.depth,
                                   rows, xs.shape[1], n_sm)
            except ValueError:
                continue
            if fused:
                fn = lambda: tgc.launch_fused(db, mean, std, scale, bias, xr, kind, pl)  # noqa: E731
            else:
                fn = lambda: tgc.launch_leaves(db, xs, pl)  # noqa: E731
            _tree_check(cs, db, fn(), xr, xs, mean, std, red, fused,
                        f"{kernel} {bank} {label} {pl}")
            timed.append({"route": route, "groups": groups,
                          "rows_on_lanes": on_lanes, "grid": pl.grid,
                          "ms": cs.cuda_ms(fn, iters=30)["device"]})
        pl = tgc.plan_for(db, rows, xs.shape[1], fused)
        row = {"kernel": kernel, "bank": bank, "case": label, "rows": rows,
               "plan": next(t for t in timed
                            if (t["groups"], t["rows_on_lanes"])
                            == (pl.groups, pl.rows_on_lanes)),
               "best": min(timed, key=lambda t: t["ms"]), "all": timed}
        rows_out.append(row)
        cs.log("sweep " + json.dumps({k: row[k] for k in
                                      ("kernel", "bank", "case", "rows", "plan", "best")}))
    return rows_out


def sweep_int8(cs, device) -> list:
    """Every tile and split of k the int8 kernel takes, at the 13 path
    shapes: device ms each (bit-equal first), beside `plan`'s choice."""
    import torch
    from repro_torch.core.dataset import synthetic_graphs
    from repro_torch.kernels import int8_matmul as im
    from repro_torch.kernels import int8_matmul_cuda as imc

    graph = synthetic_graphs(40, resolution=224)[32]
    scale = im.out_scale(cs.INT8_SCALE, 1.0)
    rows = []
    for row, a, _, bt, bias in cs.int8_timed_cases(graph, device):
        m, k, n = row["m"], row["k"], row["n"]
        want = im.int8_matmul_plain(a, bt, scale, bias)
        steps = max(1, -(-k // imc.K_STEP))
        timed = []
        for bm, bn in imc.TILES:
            if bm > 16 * -(-m // 16):
                continue
            for splits in sorted({-(-steps // per) for per in range(1, steps + 1)}):
                if splits > imc.MAX_SPLITS:
                    continue
                per = -(-steps // splits)
                pl = imc.Plan(bm, bn, per * imc.K_STEP, splits,
                              (-(-m // bm) * -(-n // bn), 1, splits))
                if not torch.equal(imc.launch(a, bt, scale, bias, pl), want):
                    raise AssertionError(f"int8 GEMM {(m, k, n)} differs with {pl}")
                ms = cs.cuda_ms(lambda: imc.launch(a, bt, scale, bias, pl), iters=30)
                timed.append({"bm": bm, "bn": bn, "splits": splits,
                              "blocks": pl.blocks, "ms": ms["device"]})
        pl = imc.plan(m, n, k)
        chosen = next(t for t in timed
                      if (t["bm"], t["bn"], t["splits"]) == (pl.bm, pl.bn, pl.splits))
        row.update({"kernel": "int8_matmul", "route": imc.a_route(a),
                    "plan": chosen, "best": min(timed, key=lambda t: t["ms"]),
                    "all": timed})
        rows.append(row)
        cs.log("sweep " + json.dumps({key: row[key] for key in
                                      ("m", "k", "n", "route", "plan", "best")}))
    return rows


def sweep_winograd(cs, device) -> list:
    """Every block tile and step of the Winograd kernel at the four study
    shapes: device ms each (within ``WINO_TOL`` first), beside `plan`'s
    choice."""
    import torch
    from repro_torch.kernels import winograd_conv as wc
    from repro_torch.kernels import winograd_conv_cuda as wcc

    rows = []
    for i, name in enumerate(cs.winograd_names()):
        case = cs.winograd_case(name, i, device)
        tiles, u, t, c, k = (case[key] for key in ("tiles", "u", "t", "c", "k"))
        want = wc.winograd_tiles_plain(tiles, u)
        timed = []
        for bt, bq in wcc.TILES:
            for cc in wcc.CHUNKS:
                t_pass = wcc.plan(t, c, k).t_pass
                pl = wcc.Plan(bt, bq, cc, t_pass,
                              (-(-t_pass // bt), -(-k // bq), wcc.POSITIONS))
                err = float((wcc.launch(tiles, u, pl) - want).abs().max())
                if not err <= cs.WINO_TOL * float(want.abs().max()):
                    raise AssertionError(f"Winograd {name} off with {pl}")
                ms = cs.cuda_ms(lambda: wcc.launch(tiles, u, pl), iters=30)
                timed.append({"route": pl.route, "blocks": pl.blocks,
                              "ms": ms["device"]})
        route = wcc.plan(t, c, k).route
        row = {"kernel": "winograd_conv", "case": name, "tiles": t, "c": c, "k": k,
               "plan": next(x for x in timed if x["route"] == route),
               "best": min(timed, key=lambda x: x["ms"]), "all": timed}
        rows.append(row)
        cs.log("sweep " + json.dumps({key: row[key] for key in
                                      ("case", "plan", "best")}))
    return rows


def main(argv) -> int:
    sweep = len(argv) > 1 and argv[1] == "--sweep"
    names = list(KERNELS)
    if "--only" in argv:
        at = argv.index("--only")
        names = argv[at + 1].split(",") if at + 1 < len(argv) else []
        argv = argv[:at] + argv[at + 2:]
    if len(argv) not in (2, 3) or not names or set(names) - set(KERNELS):
        print(__doc__, file=sys.stderr)
        return 2
    parent_csrc = None if sweep else Path(argv[1]).resolve()
    out = Path(argv[2]).resolve() if len(argv) == 3 else None
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("compare_kernels: CUDA is not available", file=sys.stderr)
        return 3
    import chip_smoke as cs
    from repro_torch.kernels import (_build, flash_attention_cuda, int8_matmul_cuda,
                                     moe_gmm_cuda, ssd_scan_cuda, tree_gather_cuda,
                                     winograd_conv_cuda)

    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs.card_line()
    cs.log(f"card: {card}")
    libraries = {"flash_attention": flash_attention_cuda.LIBRARY,
                 "flash_attention_bwd": flash_attention_cuda.BWD_LIBRARY,
                 "moe_gmm": moe_gmm_cuda.LIBRARY, "int8_matmul": int8_matmul_cuda.LIBRARY,
                 "winograd_conv": winograd_conv_cuda.LIBRARY,
                 "tree_gather": tree_gather_cuda.LIBRARY,
                 "ssd_scan_backward": ssd_scan_cuda.LIBRARY}
    if sweep:
        sweeps = {"int8_matmul": sweep_int8, "winograd_conv": sweep_winograd,
                  "tree_gather": sweep_tree}
        names = [n for n in names if n in sweeps]
        _build.build_all([libraries[n] for n in names])
        rows = [r for n in names for r in sweeps[n](cs, device)]
    else:
        libs = build_parent(parent_csrc, [n for n in names if n not in NEW_KERNELS])
        _build.build_all([libraries[n] for n in names])
        compare = {"flash_attention": compare_flash,
                   "flash_attention_bwd": compare_flash_bwd, "moe_gmm": compare_gmm,
                   "int8_matmul": compare_int8, "winograd_conv": compare_winograd,
                   "tree_gather": compare_tree, "ssd_scan_backward": compare_ssd_bwd}
        rows = [r for n in names for r in compare[n](cs, libs.get(n), device)]
    if out is not None:
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps({"card": card, "rows": rows}, indent=1))
    cs.log(f"card: {cs.card_line()}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
