#!/usr/bin/env python3
"""Time the LM kernels of an earlier commit against this tree's, in turns,
on one NVIDIA H100.

    git archive <parent> src/repro_torch/kernels/csrc | tar -x -C build/parent
    python3 compare_kernels.py build/parent/src/repro_torch/kernels/csrc [out.json]

Builds the parent's ``flash_attention.cu`` and ``moe_gmm.cu`` with this
tree's nvcc flags (into ``build/``), and this tree's kernels through their
wrappers.  At each shape `chip_smoke.py` times (its ``FLASH_TIMED`` flash
cases, and its ``GMM_TIMED`` GMM shapes on the input sets its
``_gmm_turns`` hands out: the four serving shapes, and the two decode
shapes with a cold L2) both outputs are first held to their plain version within
``LM_TOL``, then the two are timed parent, change, change, parent with
`chip_smoke.cuda_ms` (device time per launch).  The library call and the
bound are those of `chip_smoke.py`.  Prints the card line and one JSON line
per shape, and writes them all to ``out.json`` when it is given.
Both C interfaces must be the ones of this tree (unchanged since the two
kernels were first ported).
"""
from __future__ import annotations

import ctypes
import json
import math
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent


def build_parent(csrc: Path) -> dict:
    """nvcc the parent's two sources in parallel; name → loaded library."""
    from repro_torch.kernels import _build

    out = _build.BUILD_DIR / "parent"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in ("flash_attention", "moe_gmm"):
        so = out / f"lib{name}_parent.so"
        procs[name] = (so, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so), str(csrc / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    libs = {}
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    for name, (so, proc) in procs.items():
        _, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for the parent's {name}.cu:\n{err}")
        lib = ctypes.CDLL(str(so))
        if name == "flash_attention":
            lib.flash_attention_launch.argtypes = [p, p, p, p, i, i, i, i, i, i, i,
                                                   i, i, f, p]
        else:
            lib.moe_gmm_launch.argtypes = [p, p, p, i, i, i, i, i, p]
        getattr(lib, f"{name}_launch").restype = i
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


def main(argv) -> int:
    if len(argv) not in (2, 3):
        print(__doc__, file=sys.stderr)
        return 2
    parent_csrc = Path(argv[1]).resolve()
    out = Path(argv[2]).resolve() if len(argv) == 3 else None
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("compare_kernels: CUDA is not available", file=sys.stderr)
        return 3
    import chip_smoke as cs
    from repro_torch.kernels import _build, flash_attention_cuda, moe_gmm_cuda

    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs.card_line()
    cs.log(f"card: {card}")
    libs = build_parent(parent_csrc)
    _build.build_all([flash_attention_cuda.LIBRARY, moe_gmm_cuda.LIBRARY])
    rows = compare_flash(cs, libs["flash_attention"], device) + \
        compare_gmm(cs, libs["moe_gmm"], device)
    if out is not None:
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps({"card": card, "rows": rows}, indent=1))
    cs.log(f"card: {cs.card_line()}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
