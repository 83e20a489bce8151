"""Training driver: end-to-end LM training with checkpoint/resume (twin of
``repro.launch.train``).

  python -m repro_torch.launch.train --arch granite-moe-1b-a400m \
      --steps 20 --global-batch 4 --seq-len 1024 --ckpt-dir runs/granite

trains on the card (``--device cuda``, the default); ``--device cpu``
runs the same loop on the host at a reduced size (``--arch
qwen2-72b-reduced``).  It trains every family: the dense decoders
(gemma2's local and global pairs with their window and softcaps among
them), the MoE, the SSM (``--arch mamba2-2.7b``), the hybrid (``--arch
zamba2-1.2b``), the VLM (``--arch llama-3.2-vision-90b``, on the stub
frontend's vision embeddings) and the encoder-decoder (``--arch
whisper-large-v3``, on the stub frontend's audio frames).  The flags, the
data, the log lines and resuming from the latest checkpoint under
``--ckpt-dir`` are the reference's.

On several ranks it takes the reference's mesh path: launched by
``torchrun`` (one process per card; NCCL on the card, gloo with
``--device cpu``), or inside a process group its caller initialised, it
builds ``elastic_mesh_shape(world, model_parallel=…)``, then
`make_mesh`, and runs the step on that mesh (the tp rules; see
`repro_torch.distributed.trainstep`):

  torchrun --nproc-per-node 4 -m repro_torch.launch.train \
      --arch qwen2-72b-reduced --steps 2 --global-batch 4 --seq-len 32 \
      --model-parallel 2 --device cpu

A lone process without a group trains on its one device with no mesh
(the reference's (1, 1) mesh changes nothing there).
"""
from __future__ import annotations

import argparse
import os
import time
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_arch
from repro_torch.data.pipeline import SyntheticLMData
from repro_torch.distributed.trainstep import init_train_state, make_train_step
from repro_torch.launch.mesh import elastic_mesh_shape, make_mesh, mesh_shape
from repro_torch.models import build_model
from repro_torch.utils.device import resolve_device
from repro_torch.utils.logging import get_logger
from repro_torch.utils.tree import tree_num_params

log = get_logger("repro.train")


def main(argv: Optional[Sequence[str]] = None) -> list:
    """Run the driver; returns the per-step losses."""
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--compression", action="store_true",
                    help="int8 gradient compression w/ error feedback")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    owns_group = not dist.is_initialized() and "WORLD_SIZE" in os.environ
    if owns_group:
        if device.type == "cuda":
            device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
            torch.cuda.set_device(device)
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo")
    mesh = None
    if dist.is_initialized():
        shape, axes = elastic_mesh_shape(dist.get_world_size(),
                                         model_parallel=args.model_parallel)
        mesh = make_mesh(shape, axes, device.type)
        log.info("mesh: %s", dict(zip(axes, shape)))

    cfg = get_arch(args.arch)
    model = build_model(cfg)
    log.info("arch %s (family=%s): ~%.1fM params (config estimate)",
             cfg.name, cfg.family, cfg.num_params() / 1e6)

    # Data pipeline (pure function of step — resume-safe).
    data = SyntheticLMData(
        vocab_size=cfg.vocab_size, seq_len=args.seq_len,
        global_batch=args.global_batch, seed=args.seed,
        with_vision=cfg.vision_seq if cfg.family == "vlm" else 0,
        with_frames=cfg.encoder_seq if cfg.family == "encdec" else 0,
        d_model=cfg.d_model,
    )

    state = init_train_state(model, args.seed, compression=args.compression,
                             device=device)
    n_params = tree_num_params(state.params)
    log.info("initialized %d parameters (%.1fM) on %s", n_params, n_params / 1e6,
             device)

    start_step = 0
    ckpt = None
    if args.ckpt_dir:
        ckpt = CheckpointManager(args.ckpt_dir)
        latest = ckpt.latest_step()
        if latest is not None:
            state, meta = ckpt.restore(latest, target=state)
            start_step = int(meta["step"])
            log.info("resumed from checkpoint step %d", start_step)

    step_fn = make_train_step(model, base_lr=args.lr, total_steps=args.steps,
                              microbatches=args.microbatches,
                              compression=args.compression, mesh=mesh)
    meta = {"device": str(device), "arch": cfg.name}
    if mesh is not None:
        meta["mesh_shape"] = mesh_shape(mesh)
    t0 = time.time()
    tokens_per_step = args.global_batch * args.seq_len
    losses = []
    for step in range(start_step, args.steps):
        batch = {k: torch.from_numpy(v).to(device)
                 for k, v in data.batch_at(step).items()}
        state, metrics = step_fn(state, batch)
        losses.append(float(metrics["loss"]))
        if (step + 1) % args.log_every == 0:
            dt = time.time() - t0
            log.info("step %d loss %.4f lr %.2e gnorm %.3f  %.1f tok/s",
                     step + 1, np.mean(losses[-args.log_every:]),
                     float(metrics["lr"]), float(metrics["grad_norm"]),
                     tokens_per_step * args.log_every / max(dt, 1e-9))
            t0 = time.time()
        if ckpt and (step + 1) % args.ckpt_every == 0:
            ckpt.save(step + 1, state, meta)
    if ckpt:
        ckpt.save(args.steps, state, meta, block=True)
        ckpt.close()
    if losses:
        first = np.mean(losses[: max(1, len(losses) // 10)])
        last = np.mean(losses[-max(1, len(losses) // 10):])
        log.info("done: loss %.4f → %.4f over %d steps", first, last, len(losses))
    if owns_group:
        dist.destroy_process_group()
    return losses


if __name__ == "__main__":
    main()
