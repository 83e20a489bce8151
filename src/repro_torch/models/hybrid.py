"""Zamba2-style hybrid: Mamba2 backbone + a SHARED attention block (twin of
``repro.models.hybrid``).

Zamba2 [arXiv:2411.15242] interleaves one shared (weight-tied)
attention+MLP block every ``shared_attn_every`` Mamba2 layers; the last
``num_layers % shared_attn_every`` layers form a tail group without a
shared-block call.  The shared block is the decoder's
`transformer.layer_forward` / `layer_decode`, so its prefill attention
runs the flash kernel.

What differs from the reference: the Mamba layers are per-layer `Params`
modules in ``params["mamba_groups"]`` (n_groups·k of them, group-major)
and ``params["tail_mamba"]`` instead of arrays stacked on (n_groups, k)
and (rem,); its ``lax.scan``s are Python loops, its ``jax.checkpoint``s
`torch.utils.checkpoint.checkpoint` (one per group, its k Mamba layers
and the shared block, and one per tail layer), and its sharding
constraints are left out, as in `repro_torch.models.transformer`.  Decode
writes the caches in place (`ssm.mamba_decode_layers`,
`transformer.layer_decode`).
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.distributed.activations import constrain_logits, constrain_seq
from repro_torch.distributed.fsdp import gather_layer, local_params, pin_layer_stack
from repro_torch.distributed.sharding import local_cache
from repro_torch.models.layers import (
    Params, dtype_of, embed, embed_init, norm_init, remat_runner, rms_norm, softcap,
    unembed,
)
from repro_torch.models.ssm import (
    init_mamba_cache, mamba_decode_layers, mamba_init, mamba_layer,
)
from repro_torch.models.transformer import (
    _head, layer_decode, layer_forward, layer_init, local_kv,
)

Tensor = torch.Tensor


def _groups(cfg) -> Tuple[int, int, int]:
    """(n_full_groups, group_size, remainder_layers).

    zamba2-1.2b has 38 Mamba layers with the shared block every 6 —
    the last 2 layers form a tail group without a shared-attn call.
    """
    k = cfg.shared_attn_every
    n_groups = cfg.num_layers // k
    rem = cfg.num_layers - n_groups * k
    return n_groups, k, rem


def init_hybrid(gen: torch.Generator, cfg) -> Params:
    """The port's own init, drawn from ``gen`` on its device."""
    n_groups, k, rem = _groups(cfg)
    p: Dict[str, Any] = {
        "embed": embed_init(gen, cfg.vocab_size, cfg.d_model, cfg.param_dtype),
        "mamba_groups": [mamba_init(gen, cfg) for _ in range(n_groups * k)],
        "shared_attn": layer_init(gen, cfg),     # ONE block, reused per group
        "final_norm": norm_init(cfg.d_model, cfg.param_dtype, gen.device),
    }
    if rem:
        p["tail_mamba"] = [mamba_init(gen, cfg) for _ in range(rem)]
    if not cfg.tie_embeddings:
        p["lm_head"] = embed_init(gen, cfg.vocab_size, cfg.d_model, cfg.param_dtype)
    return Params(p)


def _group_forward(layers, shared: Params, x: Tensor, cfg, positions: Tensor
                   ) -> Tensor:
    """One group: its Mamba layers, then the weight-tied shared block."""
    s = positions.shape[1]
    for lp in layers:
        x = mamba_layer(lp, constrain_seq(x, cfg), cfg, s)
    x, _ = layer_forward(shared, x, cfg, positions)
    return x


def hybrid_forward(params: Params, tokens: Tensor, cfg, *, remat: bool = True
                   ) -> Tensor:
    """tokens: (b, s) integer → logits (b, s, vocab) float32, softcapped.
    With ``remat`` and gradients enabled (as in `decoder_forward`), each
    group and each tail layer runs under `torch.utils.checkpoint.checkpoint`;
    nothing else changes.  The shared block's gradient sums over its
    n_groups calls.  The sharding hooks sit where the reference's do
    (the shared block gathered once, outside the groups)."""
    n_groups, k, _ = _groups(cfg)
    b, s = tokens.shape
    top = local_params(params)
    x = embed(top["embed"], tokens, dtype_of(cfg))
    positions = torch.arange(s, device=tokens.device).expand(b, s)
    shared = gather_layer(top["shared_attn"], cfg)
    run = remat_runner(remat)
    layers = pin_layer_stack(params["mamba_groups"], cfg)
    for g in range(n_groups):
        x = run(_group_forward, layers[g * k:(g + 1) * k], shared, x,
                cfg, positions)
    if "tail_mamba" in params:
        for lp in pin_layer_stack(params["tail_mamba"], cfg):
            x = run(mamba_layer, lp, x, cfg, s)
    x = rms_norm(top["final_norm"], x, cfg.norm_eps)
    logits = constrain_logits(unembed(_head(top, cfg), x), cfg.vocab_size)
    return softcap(logits.float(), cfg.final_logit_softcap)


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------

def init_hybrid_cache(cfg, batch: int, max_len: int, device) -> Dict[str, Any]:
    """Mamba caches for the grouped and tail layers; one K/V cache per
    shared-block call, bfloat16 whatever the compute dtype (as the
    reference's)."""
    n_groups, k, rem = _groups(cfg)
    kvh, hd = cfg.num_kv_heads, cfg.head_dim
    kv = (n_groups, batch, max_len, kvh, hd)
    return {
        "mamba": init_mamba_cache(cfg, batch, n_groups * k, device),
        "tail": init_mamba_cache(cfg, batch, rem, device) if rem else None,
        "attn": {
            "k": torch.zeros(kv, dtype=torch.bfloat16, device=device),
            "v": torch.zeros(kv, dtype=torch.bfloat16, device=device),
            "len": torch.zeros((n_groups, batch), dtype=torch.int32, device=device),
        },
    }


def hybrid_decode_step(params: Params, token: Tensor, cache: Dict[str, Any], cfg
                       ) -> Tuple[Tensor, Dict[str, Any]]:
    """token: (b, 1) → (logits (b, vocab) float32, updated cache).  Every
    group's shared block sees the same position; ``len`` advances once per
    step, after all groups.  On a mesh the leaves are gathered layer by
    layer and the caches are this rank's parts (`local_cache`,
    `transformer.local_kv`)."""
    n_groups, k, _ = _groups(cfg)
    top = local_params(params)
    x = embed(top["embed"], token, dtype_of(cfg))
    mc, tail = local_cache(cache["mamba"]), local_cache(cache["tail"])
    ac, seq_first = local_kv(cache["attn"])
    layers = params["mamba_groups"]
    shared = gather_layer(params["shared_attn"], cfg)
    for g in range(n_groups):
        group = slice(g * k, (g + 1) * k)
        x = mamba_decode_layers(layers[group], x, cfg,
                                {"conv": mc["conv"][group], "state": mc["state"][group]})
        x, _ = layer_decode(shared, x, cfg,
                            {"k": ac["k"][g], "v": ac["v"][g], "len": ac["len"][g]},
                            seq_first=seq_first)
    if "tail_mamba" in params:
        x = mamba_decode_layers(params["tail_mamba"], x, cfg, tail)
    x = rms_norm(top["final_norm"], x, cfg.norm_eps)
    logits = unembed(_head(top, cfg), x[:, 0])
    at = cache["attn"]
    attn = {"k": at["k"], "v": at["v"], "len": at["len"] + 1}
    return (softcap(logits.float(), cfg.final_logit_softcap),
            {"mamba": cache["mamba"], "tail": cache["tail"], "attn": attn})