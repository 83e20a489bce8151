"""Three-term roofline of one training, prefill or decode step on the
port's card (the analytic half of the reference's
``benchmarks/roofline.py``).

Terms, per card:

  compute    = FLOPs/device   / PEAK_FLOPS
  memory     = bytes/device   / HBM_BW
  collective = coll bytes/dev / LINK_BW

`step_costs` is the reference's analytic per-step cost model (the MFU
accounting every LLM framework uses: 6·N·D train, 2·N_active/token
decode, + attention terms, + remat recompute, + FSDP gather traffic),
copied with its float expressions in the reference's order, so its dicts
are bit-equal to the reference's; it takes the config and shape objects,
so a cell cut in depth can be priced.  `analytic_costs` is the
reference's name-level signature over it.  A step is predicted as the
largest of the three terms (`step_terms`); the dry run
(`repro_torch.launch.dryrun`) gives the traced counts to hold the model
against.  Pure arithmetic: nothing here allocates a tensor.

  PYTHONPATH=src python examples/torch/predict_tpu_step.py --arch qwen2-72b
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from repro_torch.configs import INPUT_SHAPES, get_arch
from repro_torch.core.selection import DEVICE_PROFILES

# Published figures of the NVIDIA H100 SXM (the data sheet's dense rates),
# not readings: the card the port runs on is an NVIDIA H100 80GB HBM3 at
# 700.00 W (nvidia-smi --query-gpu=name,power.limit --format=csv,noheader),
# the power limit these rates assume.  Compute and HBM come from the
# `h100` profile of `repro_torch.core.selection`.
PEAK_FLOPS = DEVICE_PROFILES["h100"].peak_flops   # bf16 / card, tensor cores
HBM_BW = DEVICE_PROFILES["h100"].hbm_bw           # bytes/s / card
# One 400 Gb/s InfiniBand NDR port per card, as a DGX H100 has: either
# axis of a (16, 16) mesh leaves an 8-card NVLink node, so its
# collectives cross the network.  Kept here and not in the `h100`
# profile, whose `link_bw` feeds the transfer descriptors.
LINK_BW = 50e9                                    # bytes/s / card


# ---------------------------------------------------------------------------
# Analytic per-step cost model (global, then /chips)
# ---------------------------------------------------------------------------

def analytic_costs(arch: str, shape_name: str, mesh: Dict[str, int],
                   microbatches: int = 16, fsdp: Optional[bool] = None
                   ) -> Dict[str, float]:
    return step_costs(get_arch(arch), INPUT_SHAPES[shape_name], mesh,
                      microbatches=microbatches, fsdp=fsdp)


def step_costs(cfg, shape, mesh: Dict[str, int], microbatches: int = 16,
               fsdp: Optional[bool] = None) -> Dict[str, float]:
    chips = int(np.prod(list(mesh.values())))
    model_axis = mesh.get("model", 1)
    data_axis = chips // model_axis
    n = cfg.num_params()
    n_active = cfg.active_params()
    b, s = shape.global_batch, shape.seq_len
    L, d, hd = cfg.num_layers, cfg.d_model, cfg.head_dim
    heads, kvh = cfg.num_heads, cfg.num_kv_heads

    if shape.kind == "train":
        tokens = b * s
        useful = 6.0 * n_active * tokens
        # attention (causal): fwd 2·2·s²/2·h·hd per layer per seq → ×3 bwd+fwd
        attn = 0.0
        if heads:
            n_attn_layers = L if cfg.family != "hybrid" else max(1, L // max(1, cfg.shared_attn_every))
            attn = 3.0 * 2.0 * b * s * s * heads * hd * n_attn_layers
        remat = 2.0 * n_active * tokens          # one fwd recompute
        total_flops = useful + attn + remat
        # bytes: params f32 read+write + opt states + activations/microbatch
        act_bytes = 2.0 * b * s * d * L * 2 / max(1, microbatches)
        param_bytes = (4 + 4 + 4 + 4) * n        # p, g, mu, nu traffic
        total_bytes = param_bytes + act_bytes * microbatches
        # collectives: grad reduce (f32·N over data) + fsdp gathers (bf16·N)
        use_fsdp = fsdp if fsdp is not None else n >= 15e9
        coll = 4.0 * n * 2 * (data_axis - 1) / data_axis   # ring all-reduce ≈ 2N
        if use_fsdp:
            coll += 2.0 * n * microbatches                  # per-mb layer gathers
        # TP activation collectives: per layer 2 all-reduces of (b·s·d) bf16
        coll += 2.0 * 2.0 * b * s * d * L / max(1, microbatches) * 0  # overlapped in TP-seq layout
        tok_or_seq = tokens
    elif shape.kind == "prefill":
        tokens = b * s
        useful = 2.0 * n_active * tokens
        attn = 2.0 * b * s * s * heads * hd * L if heads else 0.0
        total_flops = useful + attn
        total_bytes = 2.0 * n + 2.0 * b * s * d * L
        coll = 2.0 * b * s * d * L * 2 / 4      # TP all-reduces, partial
        tok_or_seq = tokens
    else:  # decode: one token, KV cache of seq_len
        tokens = b
        useful = 2.0 * n_active * tokens
        kv_bytes = 0.0
        if kvh:
            win = cfg.sliding_window or s
            n_full = L
            if cfg.alt_local_global:
                kv_read = (min(s, cfg.sliding_window) * (L // 2) + s * (L // 2))
            elif cfg.family == "hybrid":
                kv_read = s * max(1, L // max(1, cfg.shared_attn_every))
            else:
                kv_read = s * L
            kv_bytes = 2.0 * b * kvh * hd * 2 * kv_read
        state_bytes = 0.0
        if cfg.ssm_state:
            d_inner = cfg.d_model * cfg.ssm_expand
            state_bytes = 4.0 * b * (d_inner // cfg.ssm_head_dim) * cfg.ssm_head_dim * cfg.ssm_state * L * 2
        total_flops = useful + 2.0 * kv_bytes / 2  # attn dot ≈ kv reads
        total_bytes = 2.0 * n + kv_bytes + state_bytes
        coll = 2.0 * b * d * L * 2               # TP reduces per layer
        tok_or_seq = tokens

    return {
        "ana_flops_dev": total_flops / chips,
        "ana_bytes_dev": total_bytes / chips,
        "ana_coll_dev": coll / chips,
        "model_flops": useful,
        "total_flops": total_flops,
        "useful_ratio": useful / max(total_flops, 1.0),
        "tokens": tok_or_seq,
    }


def step_terms(costs: Dict[str, float]) -> Tuple[Dict[str, float], str, float]:
    """The three terms in seconds of one step's ``costs`` on the card,
    the dominant term's name, and the predicted step: the largest term."""
    terms = {
        "compute": costs["ana_flops_dev"] / PEAK_FLOPS,
        "memory": costs["ana_bytes_dev"] / HBM_BW,
        "collective": costs["ana_coll_dev"] / LINK_BW,
    }
    dominant = max(terms, key=terms.get)
    return terms, dominant, terms[dominant]


__all__ = ["PEAK_FLOPS", "HBM_BW", "LINK_BW", "analytic_costs", "step_costs", "step_terms"]
