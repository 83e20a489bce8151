"""Mamba2 / SSD (state-space duality) blocks [arXiv:2405.21060] (twin of
``repro.models.ssm``).

Chunked SSD: sequences are split into chunks of Q tokens; within a chunk
the computation is a masked-decay "attention" (quadratic in Q); across
chunks a linear recurrence over per-chunk states (h, p, n).  That
recurrence, a ``lax.scan`` in the reference, is one `ops.ssd_scan` call:
the hand-written CUDA kernel on the card, its plain version on the host.
Decode is a single-step state update: h ← dA·h + dt·B⊗x, y = C·h + D·x.

What differs from the reference, and why:
  * its einsums are written as explicit steps whose intermediates are
    known.  The intra-chunk output w·x, with the weights
    w[t, s] = exp(cum_t − cum_s)·(C_t·B_s)·dt_s, is `ops.ssd_intra`.  On
    the card that is one float32 CUDA kernel, forward and backward
    (`kernels/ssd_intra.py`, ``csrc/ssd_intra.cu``), that builds w tile by
    tile in shared memory and never writes it to the card's memory: the
    (b, c, h, t, s) weights are 335 MB a layer at Mamba2 2.7B's width on
    2 × 2,048 tokens, and elementwise passes over them take a third of
    its training step on an H100.  The kernel skips the tiles strictly
    above the diagonal, where every term is exp(−60) ≈ 8.8e-27 times
    cb·dt·x: below float32's resolution against the kept terms, among
    them the diagonal's exp(0)·cb·dt·x.  On the host the plain version
    builds the weights whole (in place when no gradient is asked) and
    keeps the masked terms.  The reference's three-operand einsum would
    be free to form a (b, c, t, s, h, p) product, 43 GB at Mamba2's width
    on 2 × 4,096 tokens;
  * the per-chunk states come out of their product in chunk-major order
    (nc, b, h, p, n), the kernel's layout, so the scan's operand is not
    a transposed copy;
  * the decode steps of a layer stack write each layer's new conv window
    and state into the stacked cache in place (`mamba_decode_layers`);
    the reference returns new arrays.
"""
from __future__ import annotations

from typing import Any, Dict, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch.distributed.activations import (
    heads_local, heads_whole, model_shard, model_whole, unshard_seq,
)
from repro_torch.distributed.fsdp import gather_layer
from repro_torch.kernels import ops
from repro_torch.kernels.ssd_intra import MASKED_DECAY  # noqa: F401 (re-exported)
from repro_torch.models.layers import (
    Params, dense, dense_init, dtype_of, norm_init, rms_norm, torch_dtype,
)
from repro_torch.obs.tracing import train_span

Tensor = torch.Tensor


def ssm_dims(cfg) -> Tuple[int, int, int, int]:
    """(d_inner, heads, head_dim, state)."""
    d_inner = cfg.d_model * cfg.ssm_expand
    head_dim = cfg.ssm_head_dim
    heads = d_inner // head_dim
    return d_inner, heads, head_dim, cfg.ssm_state


def mamba_init(gen: torch.Generator, cfg) -> Dict[str, Any]:
    """The port's own init of one Mamba2 block, drawn from ``gen``."""
    d_inner, heads, head_dim, n = ssm_dims(cfg)
    d = cfg.d_model
    conv_ch = d_inner + 2 * n  # x + B + C go through the causal conv
    dev, pdt = gen.device, torch_dtype(cfg.param_dtype)
    conv_w = torch.empty((cfg.ssm_conv_width, conv_ch), dtype=pdt, device=dev)
    return {
        "norm": norm_init(d, cfg.param_dtype, dev),
        # in_proj → [z (d_inner), x (d_inner), B (n), C (n), dt (heads)]
        "in_proj": dense_init(gen, d, 2 * d_inner + 2 * n + heads, cfg.param_dtype),
        "conv_w": conv_w.normal_(generator=gen) * 0.1,
        "conv_b": torch.zeros((conv_ch,), dtype=pdt, device=dev),
        "A_log": torch.log(torch.linspace(1.0, 16.0, heads, device=dev).to(pdt)),
        "D": torch.ones((heads,), dtype=pdt, device=dev),
        "dt_bias": torch.zeros((heads,), dtype=pdt, device=dev),
        "out_norm": norm_init(d_inner, cfg.param_dtype, dev),
        "out_proj": dense_init(gen, d_inner, d, cfg.param_dtype),
    }


def softplus(x: Tensor) -> Tensor:
    """``jax.nn.softplus``: max(x, 0) + log1p(exp(−|x|))."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-x.abs()))


def _causal_conv(x: Tensor, w: Tensor, b: Tensor) -> Tensor:
    """Depthwise causal conv along seq. x: (b, s, c); w: (k, c).  Unrolled
    adds in x's type, as the reference."""
    k = w.shape[0]
    xp = F.pad(x, (0, 0, k - 1, 0))
    out = torch.zeros_like(x)
    for i in range(k):
        out = out + xp[:, i: i + x.shape[1], :] * w[i]
    return out + b


def ssd_forward(xh: Tensor, dt: Tensor, a: Tensor, bmat: Tensor, cmat: Tensor,
                chunk: int) -> Tuple[Tensor, Tensor]:
    """Chunked SSD core.

    xh: (b, s, h, p)   dt: (b, s, h)   a: (h,) positive decay rates
    bmat, cmat: (b, s, n)  (single B/C group broadcast over heads)
    Returns (y: (b, s, h, p), final_state: (b, h, p, n)).
    Recurrence: state_t = exp(-a·dt_t)·state_{t-1} + dt_t·B_t⊗x_t;
                y_t = C_t·state_t (+ D·x_t added by the caller).
    A sequence shorter than ``chunk`` is one chunk; otherwise s must be a
    multiple of s // (s // chunk), as in the reference.

    When a gradient is asked (grad mode on and an input requiring one),
    every step is out of place, so autograd can follow it, the scan is
    `ssd_scan.SSDScan` and, on the card, the intra-chunk output
    `ssd_intra.SSDIntra`; otherwise the chunk-major buffers (and, on the
    host, the (b, c, h, t, s) weights) are filled in place (the serving
    route's memory).
    """
    b, s, h, p = xh.shape
    n = bmat.shape[-1]
    nc = max(1, s // chunk)
    q = s // nc
    if nc * q != s:
        raise ValueError("seq must be divisible by ssm_chunk")
    dev, f32 = xh.device, xh.dtype
    grad = torch.is_grad_enabled() and any(
        t.requires_grad for t in (xh, dt, a, bmat, cmat))

    log_da = -(dt * a[None, None, :])
    xr = xh.reshape(b, nc, q, h, p)
    br = bmat.reshape(b, nc, q, n)
    cr = cmat.reshape(b, nc, q, n)
    dtr = dt.reshape(b, nc, q, h)
    cum = torch.cumsum(log_da.reshape(b, nc, q, h), dim=2)          # (b,c,Q,h)

    # Intra-chunk weights w[b,c,h,t,s] = (C_t·B_s)·exp(cum_t − cum_s)·dt_s,
    # masked above the diagonal before the exp (so no cotangent is NaN),
    # and the intra-chunk output y_intra (b,c,t,h,p) (`ops.ssd_intra`):
    # span ``ssm.intra`` in a traced training step, its backward
    # ``ssm.intra.bwd``.
    with train_span("ssm.intra") as intra:
        cum_i, cr_i, br_i, dtr_i, xr_i = intra.inputs(cum, cr, br, dtr, xr)
        cb = cr_i @ br_i.transpose(-1, -2)                           # C_t·B_s
        y_intra = intra.output(ops.ssd_intra(xr_i, dtr_i, cum_i, cb))

    # Per-chunk input→state contributions, chunk-major: (c, b, h, p, n).
    tail = torch.exp(cum[:, :, -1:, :] - cum) * dtr                  # (b,c,Q,h)
    if grad:
        u = (tail.transpose(0, 1)[..., None] * xr.transpose(0, 1)).reshape(
            nc * b, q, h * p)
    else:
        u = torch.empty((nc, b, q, h, p), dtype=f32, device=dev)
        torch.mul(tail.transpose(0, 1)[..., None], xr.transpose(0, 1), out=u)
        u = u.view(nc * b, q, h * p)
    b_cb = br.transpose(0, 1).reshape(nc * b, q, n)
    s_chunk = (u.transpose(1, 2) @ b_cb).view(nc, b, h, p, n)
    del u
    chunk_decay = torch.exp(cum[:, :, -1, :]).transpose(0, 1).contiguous()  # (c,b,h)

    # Inter-chunk recurrence (the ssd_scan kernel), on this rank's heads
    # over `model` on a mesh.
    h_prev, h_final = ops.ssd_scan(heads_local(s_chunk, 2, h),
                                   heads_local(chunk_decay, 2, h))
    h_prev, h_final = heads_whole(h_prev, 2, h), heads_whole(h_final, 1, h)
    del s_chunk

    # Inter-chunk output: y[t] += exp(cum_t)·C_t·h_prev, chunk-major.
    c_cb = cr.transpose(0, 1).reshape(nc * b, q, n)
    y_inter = (c_cb @ h_prev.view(nc * b, h * p, n).transpose(1, 2)).view(nc, b, q, h, p)
    del h_prev
    decay_t = torch.exp(cum).transpose(0, 1)[..., None]
    if grad:
        y = y_intra + (y_inter * decay_t).transpose(0, 1)
    else:
        y_inter.mul_(decay_t)
        y = torch.empty((b, nc, q, h, p), dtype=f32, device=dev)
        torch.add(y_intra, y_inter.transpose(0, 1), out=y)
    return y.reshape(b, s, h, p), h_final


def mamba_forward(p: Params, x: Tensor, cfg) -> Tensor:
    """One Mamba2 block (pre-norm residual). x: (b, s, d)."""
    dt_ = dtype_of(cfg)
    d_inner, heads, head_dim, n = ssm_dims(cfg)
    b, s, d = x.shape
    h = rms_norm(p["norm"], x, cfg.norm_eps)
    zxbcdt = dense(p["in_proj"], h, dt_)
    z, xin, bmat, cmat, dt = torch.split(zxbcdt, [d_inner, d_inner, n, n, heads],
                                         dim=-1)
    conv_in = torch.cat([xin, bmat, cmat], dim=-1)
    conv_out = F.silu(_causal_conv(conv_in, p.cast("conv_w", dt_),
                                   p.cast("conv_b", dt_)))
    xin, bmat, cmat = torch.split(conv_out, [d_inner, n, n], dim=-1)
    dt = softplus(dt.float() + p["dt_bias"].float())
    a = torch.exp(p["A_log"].float())
    xh = xin.reshape(b, s, heads, head_dim).float()
    y, _ = ssd_forward(xh, dt, a, bmat.float(), cmat.float(), cfg.ssm_chunk)
    y = y + xh * p["D"].float()[None, None, :, None]
    y = y.reshape(b, s, d_inner).to(dt_)
    y = rms_norm(p["out_norm"], y * F.silu(z), cfg.norm_eps)
    return x + dense(p["out_proj"], y, dt_)


def mamba_layer(lp: Params, x: Tensor, cfg, seq: int) -> Tensor:
    """One Mamba2 layer of a stack: its carry whole along the sequence of
    ``seq`` rows again and its leaves gathered (`constrain_seq`'s inverse
    and `fsdp.gather_layer`, both the identity off-mesh), then
    `mamba_forward`."""
    return mamba_forward(gather_layer(lp, cfg), unshard_seq(x, seq), cfg)


# ---------------------------------------------------------------------------
# Decode (single-step state update)
# ---------------------------------------------------------------------------

def init_mamba_cache(cfg, batch: int, n_layers: int, device) -> Dict[str, Tensor]:
    """The conv window in the compute dtype (it holds its activations); the
    SSD state in float32 (a long-horizon recurrence accumulator)."""
    d_inner, heads, head_dim, n = ssm_dims(cfg)
    conv_ch = d_inner + 2 * n
    return {
        "conv": torch.zeros((n_layers, batch, cfg.ssm_conv_width - 1, conv_ch),
                            dtype=dtype_of(cfg), device=device),
        "state": torch.zeros((n_layers, batch, heads, head_dim, n),
                             dtype=torch.float32, device=device),
    }


def mamba_decode(p: Params, x: Tensor, cfg, cache: Dict[str, Tensor]
                 ) -> Tuple[Tensor, Dict[str, Tensor]]:
    """x: (b, 1, d); cache: {'conv': (b, w-1, c), 'state': (b, h, p, n)}.

    On a mesh the state may hold this rank's block of the head dim p
    (`sharding.cache_shardings` cuts p over `model`): the update and the
    read-out are elementwise in p, so they run on that block and the
    read-out is gathered whole again."""
    dt_ = dtype_of(cfg)
    d_inner, heads, head_dim, n = ssm_dims(cfg)
    b = x.shape[0]
    h = rms_norm(p["norm"], x, cfg.norm_eps)
    zxbcdt = dense(p["in_proj"], h, dt_)[:, 0]
    z, xin, bmat, cmat, dt = torch.split(zxbcdt, [d_inner, d_inner, n, n, heads],
                                         dim=-1)
    # Conv in the compute dtype, as the forward's, then float32.
    conv_in = torch.cat([xin, bmat, cmat], dim=-1).to(dt_)
    window = torch.cat([cache["conv"].to(dt_), conv_in[:, None, :]], dim=1)  # (b,w,c)
    conv_out = F.silu(torch.einsum("bwc,wc->bc", window, p.cast("conv_w", dt_))
                      + p.cast("conv_b", dt_)).float()
    xin, bmat, cmat = torch.split(conv_out, [d_inner, n, n], dim=-1)
    dt = softplus(dt.float() + p["dt_bias"].float())
    a = torch.exp(p["A_log"].float())
    da = torch.exp(-(dt * a[None, :]))                                # (b,h)
    xh = xin.reshape(b, heads, head_dim)
    if cache["state"].shape[2] != head_dim:
        xh = model_shard(xh, 2)
    new_state = (cache["state"] * da[..., None, None]
                 + torch.einsum("bh,bn,bhp->bhpn", dt, bmat, xh))
    y = torch.einsum("bn,bhpn->bhp", cmat, new_state)
    y = y + xh * p["D"].float()[None, :, None]
    y = unshard_p(y, head_dim).reshape(b, d_inner).to(dt_)
    y = rms_norm(p["out_norm"], y * F.silu(z), cfg.norm_eps)
    out = x + dense(p["out_proj"], y, dt_)[:, None, :]
    return out, {"conv": window[:, 1:], "state": new_state}


def unshard_p(y: Tensor, head_dim: int) -> Tensor:
    """(b, h, p) whole along p again (the identity when it is whole)."""
    return y if y.shape[2] == head_dim else model_whole(y, 2)


def mamba_decode_layers(layers: Sequence[Params], x: Tensor, cfg,
                        cache: Dict[str, Tensor]) -> Tensor:
    """`mamba_decode` through a stack of layers whose caches are stacked on
    the leading axis of ``cache``; each layer's new window and state are
    written into ``cache`` in place.  On a mesh each layer's leaves are
    gathered (`fsdp.gather_layer`) and ``cache`` holds this rank's tensors
    (`sharding.local_cache`)."""
    for i, lp in enumerate(layers):
        x, new = mamba_decode(gather_layer(lp, cfg), x, cfg, {"conv": cache["conv"][i],
                                           "state": cache["state"][i]})
        cache["conv"][i] = new["conv"]
        cache["state"][i] = new["state"]
    return x
