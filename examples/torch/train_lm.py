"""End-to-end training on the port (twin of ``examples/train_lm.py``): a
~100M-parameter LM for a few hundred steps.

Builds a ~100M-parameter qwen2-family model (scaled-down config of an
assigned architecture), trains it on the synthetic pipeline with
checkpointing, and, run again with the same ``--ckpt-dir``, RESUMES from
the latest checkpoint: the fault-tolerance path end to end.

  PYTHONPATH=src python examples/torch/train_lm.py [--steps 300]      # on the card
  PYTHONPATH=src python examples/torch/train_lm.py --device cpu --steps 20
"""
import argparse
import dataclasses
import os
import tempfile

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_arch
from repro_torch.data.pipeline import SyntheticLMData
from repro_torch.distributed.trainstep import init_train_state, make_train_step
from repro_torch.models import build_model
from repro_torch.utils.tree import tree_num_params


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_torch_train_lm"))
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--width", type=int, default=512,
                    help="d_model (512: ~100M parameters with the 32k vocab)")
    return ap.parse_args(argv)


def main(argv=None) -> None:
    args = parse_args(argv)
    # ~100M params: qwen2 family at width 512, 8 layers, vocab 32k.
    w = args.width
    cfg = dataclasses.replace(
        get_arch("qwen2-72b"),
        name="qwen2-100m", num_layers=8, d_model=w, num_heads=8,
        num_kv_heads=4, head_dim=w // 8, d_ff=3 * w, vocab_size=64 * w,
        q_chunk=128,
    )
    model = build_model(cfg)
    state = init_train_state(model, 0, device=args.device)
    n = tree_num_params(state.params)
    print(f"model: {cfg.name} — {n/1e6:.1f}M params")

    data = SyntheticLMData(vocab_size=cfg.vocab_size, seq_len=128,
                           global_batch=8, seed=0)
    ckpt = CheckpointManager(args.ckpt_dir)
    start = 0
    if ckpt.latest_step() is not None:
        state, meta = ckpt.restore(target=state)
        start = int(meta["step"])
        print(f"resumed from step {start}")
    step_fn = make_train_step(model, base_lr=3e-4, total_steps=args.steps)
    losses = []
    for step in range(start, args.steps):
        batch = {k: torch.from_numpy(v).to(args.device)
                 for k, v in data.batch_at(step).items()}
        state, metrics = step_fn(state, batch)
        losses.append(float(metrics["loss"]))
        if (step + 1) % 25 == 0:
            print(f"step {step+1:4d}  loss {np.mean(losses[-25:]):.4f}  "
                  f"lr {float(metrics['lr']):.2e}")
        if (step + 1) % 100 == 0:
            ckpt.save(step + 1, state, {"arch": cfg.name})
    ckpt.save(args.steps, state, {"arch": cfg.name}, block=True)
    ckpt.close()
    if losses:
        print(f"final loss {np.mean(losses[-20:]):.4f} "
              f"(start {np.mean(losses[:20]):.4f})")


if __name__ == "__main__":
    main()
