#!/usr/bin/env python3
"""Time whole decode steps through the LM kernels' `torch.library` ops
against the same steps through the entry points the ops replaced (the
direct launch of the CUDA wrapper), in one process, in turns, on one
NVIDIA H100: what the ops' dispatch costs a serving step on the host.

    python3 compare_decode_steps.py [out.json]

The earlier entry points are replicated below (`direct_flash_attention`,
`direct_moe_gmm`: the checks of the commit before the ops, then the CUDA
wrapper) and swapped into `repro_torch.kernels.ops`, which the models
call through, for the ``direct`` blocks.  Whole processes of two trees
are not compared: their decode steps spread 59–86 ms a process on an
H100, far more than the effect.

For Granite-MoE 1B (72 GMM calls a step) and Whisper large-v3 (32 flash
calls a step), at full width and depth with random weights (seed 0),
under `torch.no_grad()`, batch `BATCH`, from an empty cache of `MAX_LEN`
positions (Whisper over a random memory of its 1,500 frames): first one
step from the same cache through each entry, whose logits must be
bit-equal; then `WARM` steps, then `ROUNDS` rounds of four blocks of
`BLOCK` steps, ops / direct / direct / ops, each step synchronised before
and after.  Each step is read twice: its wall time on the host's clock
(``step``), and the host thread's CPU time inside the `decode_step` call
(``cpu``: the Python, dispatch and launch work, without the wait for the
card or time the thread was not running; the thread clock can tick
coarsely, 10 ms on one H100 host, so only its means over many steps
count).  A round's difference is its ops blocks' mean
less its direct blocks' mean (paired, so the cache's growth and the
host's drift cancel).  Prints the card line (``nvidia-smi
--query-gpu=name,power.limit``) and one JSON line per arch: launches a
step through each entry, both means of each reading, the mean of the
round differences and their range; writes them to ``out.json`` when it
is given.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

ARCHS = ("granite-moe-1b-a400m", "whisper-large-v3")
BATCH, MAX_LEN, WARM, BLOCK, ROUNDS = 8, 448, 5, 10, 10


def direct_flash_attention(q, k, v, *, causal=True, q_offset=0, window=0, softcap=0.0):
    """The entry point before the ops, without a gradient: its checks,
    then the CUDA wrapper."""
    from repro_torch.kernels import flash_attention_cuda
    from repro_torch.kernels._build import refuse_dtensor
    from repro_torch.kernels.flash_attention import _check_heads

    refuse_dtensor("flash_attention", q, k, v)
    _check_heads(q, k, v)
    return flash_attention_cuda.flash_attention_cuda(
        q.contiguous(), k.contiguous(), v.contiguous(), causal=causal,
        q_offset=q_offset, window=window, softcap=softcap)


def direct_moe_gmm(x, w):
    """The GMM's entry point before the ops, without a gradient."""
    from repro_torch.kernels import moe_gmm_cuda
    from repro_torch.kernels._build import refuse_dtensor

    refuse_dtensor("moe_gmm", x, w)
    if x.dim() != 3 or w.dim() != 3 or x.shape[0] != w.shape[0] \
            or x.shape[2] != w.shape[1]:
        raise ValueError(f"expected x (e, c, d) and w (e, d, f), got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    return moe_gmm_cuda.moe_gmm_cuda(x.contiguous(), w.contiguous())


def _entries(which: str) -> None:
    from repro_torch.kernels import flash_attention, moe_gmm, ops

    if which == "ops":
        ops.flash_attention, ops.moe_gmm = flash_attention.flash_attention, moe_gmm.moe_gmm
    else:
        ops.flash_attention, ops.moe_gmm = direct_flash_attention, direct_moe_gmm


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree.clone() if hasattr(tree, "clone") else tree


def run_arch(arch: str) -> dict:
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.kernels import flash_attention_cuda, moe_gmm_cuda
    from repro_torch.models import build_model

    counted = (flash_attention_cuda, moe_gmm_cuda)
    cfg = get_arch(arch)
    model = build_model(cfg)
    params = model.init(0, device="cuda")
    cache = model.init_cache(BATCH, MAX_LEN, device="cuda")
    n_steps = 1 + WARM + 4 * BLOCK * ROUNDS
    gen = torch.Generator(device="cuda").manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (n_steps, BATCH, 1), device="cuda",
                           generator=gen)
    extra = {}
    if cfg.family == "encdec":
        extra["memory"] = torch.randn((BATCH, cfg.encoder_seq, cfg.d_model), device="cuda",
                                      generator=gen).to(getattr(torch, cfg.compute_dtype))
    row = {"arch": arch, "batch": BATCH, "block": BLOCK, "rounds": ROUNDS}
    t = 0

    def step(which: str) -> tuple:
        """(wall ms, thread CPU ms) of one decode step."""
        nonlocal cache, t
        _entries(which)
        torch.cuda.synchronize()
        t0, c0 = time.perf_counter(), time.thread_time()
        _, cache = model.decode_step(params, {"token": tokens[t], **extra}, cache)
        c1 = time.thread_time()
        torch.cuda.synchronize()
        t += 1
        return (time.perf_counter() - t0) * 1e3, (c1 - c0) * 1e3

    with torch.no_grad():
        first = {}
        for which in ("ops", "direct"):
            _entries(which)
            for m in counted:
                m.reset_launch_counts()
            logits, _ = model.decode_step(params, {"token": tokens[0], **extra},
                                          _clone(cache))
            torch.cuda.synchronize()
            first[which] = logits
            row[f"launches_{which}"] = {k: v for m in counted
                                        for k, v in m.launch_counts().items() if v}
        row["same_logits"] = bool(torch.equal(first["ops"], first["direct"]))
        t = 1
        for _ in range(WARM):
            step("ops")
        times = {(w, r): [] for w in ("ops", "direct") for r in (0, 1)}
        diffs = ([], [])
        for _ in range(ROUNDS):
            blocks = {"ops": [], "direct": []}
            for which in ("ops", "direct", "direct", "ops"):
                blocks[which] += [step(which) for _ in range(BLOCK)]
            for r in (0, 1):
                for which, ms in blocks.items():
                    times[which, r] += [m[r] for m in ms]
                diffs[r].append(statistics.fmean(m[r] for m in blocks["ops"])
                                - statistics.fmean(m[r] for m in blocks["direct"]))
    _entries("ops")
    for r, reading in enumerate(("step", "cpu")):
        for which in ("ops", "direct"):
            ms = times[which, r]
            row[f"{which}_{reading}"] = {"mean_ms": statistics.fmean(ms),
                                         "median_ms": statistics.median(ms)}
        row[f"{reading}_ops_less_direct_ms"] = statistics.fmean(diffs[r])
        row[f"{reading}_round_diffs_ms"] = [min(diffs[r]), max(diffs[r])]
    del model, params, cache
    torch.cuda.empty_cache()
    return row


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card, flush=True)
    rows = []
    for arch in ARCHS:
        rows.append(run_arch(arch))
        print(json.dumps(rows[-1]), flush=True)
    if argv:
        Path(argv[0]).parent.mkdir(parents=True, exist_ok=True)
        Path(argv[0]).write_text(json.dumps({"card": card, "rows": rows}, indent=1))
    return 0 if all(r["same_logits"] for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
