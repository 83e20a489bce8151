#!/usr/bin/env python3
"""Time kernels of an earlier commit against this tree's, in turns, on one
NVIDIA H100.

    git archive <parent> src/repro_torch/kernels/csrc | tar -x -C build/parent
    python3 compare_kernels.py build/parent/src/repro_torch/kernels/csrc \
        [out.json] [--only int8_matmul,winograd_conv]
    python3 compare_kernels.py --sweep [out.json]

Builds the parent's sources of the chosen kernels (default: all four,
``flash_attention``, ``moe_gmm``, ``int8_matmul``, ``winograd_conv``)
with this tree's nvcc flags (into ``build/``), and this tree's kernels
through their wrappers.  At each shape `chip_smoke.py` times both outputs
are first held to their plain version, then the two are timed parent,
change, change, parent with `chip_smoke.cuda_ms` (device time per call):
  * flash: its ``FLASH_TIMED`` cases, within ``LM_TOL``;
  * GMM: its ``GMM_TIMED`` shapes on the input sets ``_gmm_turns`` hands
    out (the four serving shapes, and the two decode shapes with a cold
    L2), within ``LM_TOL``;
  * int8 GEMM: the 13 GEMMs of one int8 forward of the main path's
    held-out graph (`chip_smoke.int8_timed_cases`), bit-equal; the
    change gets A as the executor lays it out (im2col rows padded to 16
    bytes), the parent a contiguous copy, as its executor gave it;
  * Winograd: the four `STUDY_SHAPES`, within ``WINO_TOL``.
The library call and the bound are those of `chip_smoke.py`.  Prints the
card line and one JSON line per shape, and writes them all to
``out.json`` when it is given.

``--sweep`` times, instead, every launch plan of this tree's int8 GEMM
(block tile × split of k) at those 13 shapes and every Winograd block
tile × step at those four, each checked first, beside the plan that
`int8_matmul_cuda.plan` / `winograd_conv_cuda.plan` picks: the data the
plans' rules were read from.

The parent's C interfaces are those of the commit before the int8 and
Winograd redesign: ``int8_matmul_launch(a, bt, bias, out, m, n, k, ldb,
scale, stream)`` (contiguous A) and ``winograd_conv_launch(tiles, u, y,
t, c, k, stream)``; flash's and the GMM's are this tree's.
"""
from __future__ import annotations

import ctypes
import json
import math
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent


KERNELS = ("flash_attention", "moe_gmm", "int8_matmul", "winograd_conv")


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
        "flash_attention": [p, p, p, p, i, i, i, i, i, i, i, i, i, f, p],
        "moe_gmm": [p, p, p, i, i, i, i, i, p],
        "int8_matmul": [p, p, p, p, i, i, i, i, f, p],
        "winograd_conv": [p, p, p, i, i, i, p]}
    for name, (so, proc) in procs.items():
        _, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for the parent's {name}.cu:\n{err}")
        lib = ctypes.CDLL(str(so))
        launch = getattr(lib, f"{name}_launch")
        launch.argtypes = argtypes[name]
        launch.restype = i
        libs[name] = lib
    return libs


def parent_flash(lib, q, k, v, causal):
    import torch

    b, sq, h, d = q.shape
    out = torch.empty_like(q)
    err = lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, sq, k.shape[1],
        h, k.shape[2], d, 1 if q.dtype == torch.bfloat16 else 0, int(causal), 0,
        1.0 / math.sqrt(d), torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"parent flash_attention launch failed: {err}")
    return out


def parent_gmm(lib, x, w):
    import torch

    e, c, d = x.shape
    out = torch.empty((e, c, w.shape[2]), dtype=x.dtype, device=x.device)
    err = lib.moe_gmm_launch(x.data_ptr(), w.data_ptr(), out.data_ptr(), e, c, d,
                             w.shape[2], 1 if x.dtype == torch.bfloat16 else 0,
                             torch.cuda.current_stream().cuda_stream)
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
    for label, b, s, h, kvh, d, causal, dtype in (
            c for c in cs.FLASH_CASES if c[0] in cs.FLASH_TIMED):
        q, k, v = cs._flash_inputs(b, s, h, kvh, d, dtype, device, seed=500)
        want = fa.flash_attention_plain(q, k, v, causal=causal)
        errs = {}
        for who, fn in (("parent", lambda: parent_flash(lib, q, k, v, causal)),
                        ("change", lambda: fac.flash_attention_cuda(q, k, v, causal=causal))):
            errs[who] = cs._rel_check(f"{who} flash {label}", fn(), want,
                                      cs.LM_TOL[dtype])[1]
        row = {"kernel": "flash_attention", "case": label, "shape": [b, s, h, kvh, d],
               "dtype": dtype, "err_over_max": errs}
        row.update(in_turns(cs, lambda: parent_flash(lib, q, k, v, causal),
                            lambda: fac.flash_attention_cuda(q, k, v, causal=causal)))
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        row["library_ms"] = cs.cuda_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal, enable_gqa=True))["device"]
        row["bound_ms"], row["bound_by"] = cs._flash_bound(b, s, h, kvh, d, causal, dtype)
        rows.append(row)
        cs.log("compare " + json.dumps(row))
        del q, k, v, want
        torch.cuda.empty_cache()
    return rows


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
                                     moe_gmm_cuda, winograd_conv_cuda)

    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs.card_line()
    cs.log(f"card: {card}")
    modules = {"flash_attention": flash_attention_cuda, "moe_gmm": moe_gmm_cuda,
               "int8_matmul": int8_matmul_cuda, "winograd_conv": winograd_conv_cuda}
    if sweep:
        _build.build_all([int8_matmul_cuda.LIBRARY, winograd_conv_cuda.LIBRARY])
        rows = sweep_int8(cs, device) + sweep_winograd(cs, device)
    else:
        libs = build_parent(parent_csrc, names)
        _build.build_all([modules[n].LIBRARY for n in names])
        compare = {"flash_attention": compare_flash, "moe_gmm": compare_gmm,
                   "int8_matmul": compare_int8, "winograd_conv": compare_winograd}
        rows = [r for n in names for r in compare[n](cs, libs[n], device)]
    if out is not None:
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps({"card": card, "rows": rows}, indent=1))
    cs.log(f"card: {cs.card_line()}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
