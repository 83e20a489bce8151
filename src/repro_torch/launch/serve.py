"""Serving driver: batched decode with the continuous-batching engine, on
one card (twin of ``repro.launch.serve``).

  python -m repro_torch.launch.serve --arch granite-moe-1b-a400m \
      --requests 8 --prompt-len 16 --max-new 16

serves on the card (``--device cuda``, the default); ``--device cpu``
runs the same loop on the host at a reduced size (``--arch
granite-moe-1b-a400m-reduced``).  The flags, the prompts (drawn from
``np.random.default_rng(seed)``), the stub frontends' zero extras (the
VLM's ``vision_embeds``, Whisper's encoder ``memory``, bfloat16 as in the
reference) and the log lines are the reference's.  `serve` runs a model
that the caller built; `main` builds it from the port's own init.
"""
from __future__ import annotations

import argparse
import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs import get_arch
from repro_torch.models import build_model
from repro_torch.serving import ServeEngine
from repro_torch.serving.engine import Request
from repro_torch.utils.device import resolve_device
from repro_torch.utils.logging import get_logger

log = get_logger("repro.serve")


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", required=True)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    return ap.parse_args(argv)


def serve(model, params, args: argparse.Namespace) -> List[Request]:
    """Serve ``args.requests`` prompts of ``args.prompt_len`` random tokens
    through a `ServeEngine` of ``args.slots`` slots on ``args.device``;
    returns the finished requests in submission order."""
    cfg = model.cfg
    device = resolve_device(args.device)
    extras = {}
    if cfg.family == "vlm":
        extras["vision_embeds"] = torch.zeros(
            (args.slots, cfg.vision_seq, cfg.d_model), dtype=torch.bfloat16,
            device=device)
    if cfg.family == "encdec":
        extras["memory"] = torch.zeros(
            (args.slots, cfg.encoder_seq, cfg.d_model), dtype=torch.bfloat16,
            device=device)

    engine = ServeEngine(model, params, batch_slots=args.slots,
                         max_len=args.max_len, extras=extras, device=device)
    rng = np.random.default_rng(args.seed)
    for _ in range(args.requests):
        prompt = rng.integers(0, cfg.vocab_size, size=args.prompt_len)
        engine.submit(prompt, max_new_tokens=args.max_new)

    t0 = time.time()
    done = engine.run()
    dt = time.time() - t0
    total_tokens = sum(len(r.generated) for r in done)
    log.info("served %d/%d requests, %d tokens in %.1fs (%.1f tok/s)",
             len(done), args.requests, total_tokens, dt, total_tokens / max(dt, 1e-9))
    for r in done[:3]:
        log.info("req %d: %s...", r.uid, r.generated[:8])
    return done


def main(argv: Optional[Sequence[str]] = None) -> List[Request]:
    """Run the driver; returns the finished requests."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    model = build_model(get_arch(args.arch))
    params = model.init(args.seed, device=device)
    return serve(model, params, args)


if __name__ == "__main__":
    main()
