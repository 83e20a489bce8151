"""Serving on the port (twin of ``examples/serve_lm.py``): continuous
batching over a small model.

Submits a wave of requests with mixed prompt lengths, runs the engine,
prints per-request tokens + throughput.  On the card attention runs in
the hand-written flash kernel.

  PYTHONPATH=src python examples/torch/serve_lm.py            # on the card
  PYTHONPATH=src python examples/torch/serve_lm.py --device cpu
"""
import argparse
import time

import numpy as np

from repro_torch.configs import get_arch
from repro_torch.models import build_model
from repro_torch.serving import ServeEngine


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--requests", type=int, default=10)
    args = ap.parse_args(argv)

    cfg = get_arch("starcoder2-15b").reduced()
    model = build_model(cfg)
    params = model.init(0, device=args.device)
    engine = ServeEngine(model, params, batch_slots=4, max_len=160, device=args.device)

    rng = np.random.default_rng(0)
    for i in range(args.requests):
        plen = int(rng.integers(4, 24))
        engine.submit(rng.integers(0, cfg.vocab_size, plen), max_new_tokens=12)

    t0 = time.time()
    done = engine.run()
    dt = time.time() - t0
    toks = sum(len(r.generated) for r in done)
    print(f"completed {len(done)} requests / {toks} tokens "
          f"in {dt:.1f}s ({toks/dt:.1f} tok/s)")
    for r in done[:4]:
        print(f"  req {r.uid}: prompt[{len(r.prompt)}] → {r.generated}")


if __name__ == "__main__":
    main()
