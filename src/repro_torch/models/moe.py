"""Mixture-of-Experts FFN with capacity-based token dispatch (twin of
``repro.models.moe``).

Per batch row, as the reference: router logits (float32) → top-k gates
and experts → each (token, slot)'s position in its expert's queue by a
stable sort → an (e·cap, d) dispatch buffer → three grouped expert
matmuls → gather-combine weighted by the gates.  Assignments past an
expert's capacity cap = max(ceil(s·k/e·cf), k) are dropped.

The three expert matmuls go through `repro_torch.kernels.ops.moe_gmm`
(the hand-written GMM kernel on the card) with the batch folded into the
rows, (b, e, cap, d) → (e, b·cap, d), since the weights are shared
across the batch.

The reference scatters every assignment into a buffer of e·cap + 1 rows,
a dropped one of expert j at row (j+1)·cap (the first row of expert
j+1, or the overflow row for the last expert), and where two writes meet
the later assignment in token-slot order wins (XLA's scatter).  The port
builds the same buffer deterministically on every device: each row takes
the last assignment that writes it.  Dispatch and combine are `_Route`s,
row gathers whose index is one-to-one between buffer rows and token
slots (slot j = t·k + i, as the reference's repeat of x k times): the
backward of each is the gather at the inverse index, and the dispatch's
then a sum over each token's k slots, the reference's own transpose.
No backward adds two contributions into one row, so a training step
gives the same bits on every run, as the reference's does.

Spans of a traced training step (`repro_torch.obs.tracing`):
``moe.route`` (the router through the rows each assignment writes and
reads), ``moe.dispatch`` and ``moe.combine`` (the two `_Route`s, the
combine with its gate weighting), and ``moe.dispatch.bwd`` and
``moe.combine.bwd`` (their backwards).  ``moe.route`` counts, as 0-d
tensors left on the device: ``rows`` (b·e·cap), ``filled`` (rows some
assignment writes), ``dropped`` (assignments past capacity) and
``displaced`` (kept assignments whose row an overflow write took).
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.distributed.activations import batch_mean, model_shard, model_whole
from repro_torch.kernels import ops
from repro_torch.models.layers import Params, dense_init, dtype_of, uniform
from repro_torch.obs.tracing import NOOP_SPAN, train_span

Tensor = torch.Tensor


def moe_init(gen: torch.Generator, cfg) -> Dict[str, Any]:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    return {
        "router": dense_init(gen, d, e, cfg.param_dtype),
        "gate": uniform(gen, (e, d, f), cfg.param_dtype, 1.0 / np.sqrt(d)),
        "up": uniform(gen, (e, d, f), cfg.param_dtype, 1.0 / np.sqrt(d)),
        "down": uniform(gen, (e, f, d), cfg.param_dtype, 1.0 / np.sqrt(f)),
    }


def expert_capacity(tokens_per_row: int, cfg) -> int:
    cap = int(np.ceil(tokens_per_row * cfg.top_k / cfg.num_experts
                      * cfg.capacity_factor))
    return max(cap, cfg.top_k)


def _take(src: Tensor, index: Tensor, k: int = 1) -> Tensor:
    """Row ``index // k`` of ``src`` (b, n, d) for each entry of ``index``
    (b, m); a zero row where ``index < 0``."""
    b, m = index.shape
    rows = src.gather(1, (index.clamp(min=0) // k)[..., None].expand(b, m, src.shape[2]))
    return rows.masked_fill_((index < 0)[..., None], 0)


class _Route(torch.autograd.Function):
    """Rows moved between token slots and buffer rows: out[r] is row
    ``index[r] // k`` of ``src`` (zero where ``index[r] < 0``), i.e. slot
    ``index[r]`` of ``src`` repeated k times along its rows, without the
    repeat.  ``inverse`` gives for each of those k·n slots the output row
    that reads it (-1 for none); no two rows read one slot, so the
    backward is the gather at ``inverse`` and a sum over each source
    row's k slots, in a fixed order, under the span ``bwd``."""

    @staticmethod
    def forward(ctx, src, index, inverse, k, bwd):
        ctx.save_for_backward(inverse)
        ctx.k, ctx.bwd = k, bwd
        return _take(src, index, k)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        inverse, = ctx.saved_tensors
        with train_span(ctx.bwd):
            grad = _take(g, inverse)
            if ctx.k > 1:
                b, n, d = grad.shape
                grad = grad.reshape(b, n // ctx.k, ctx.k, d).sum(dim=2)
        return grad, None, None, None, None


def _last_of(b: int, rows: int, dest: Tensor) -> Tensor:
    """(b, rows): for each row the last assignment j (by position in
    ``dest``, (b, sk), values ≤ rows) whose destination it is, -1 if
    none; destination ``rows`` is the overflow row, left out."""
    sk = dest.shape[1]
    last = torch.full((b, rows + 1), -1, dtype=torch.long, device=dest.device)
    last.scatter_reduce_(1, dest, torch.arange(sk, device=dest.device).expand(b, sk),
                         reduce="amax")
    return last[:, :rows]


def moe_ffn(p: Params, x: Tensor, cfg) -> Tuple[Tensor, Tensor]:
    """x: (b, s, d) → (y: (b, s, d), aux_loss: float32 scalar)."""
    dt = dtype_of(cfg)
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.top_k
    cap = expert_capacity(s, cfg)
    slots, sk = e * cap, s * k
    dev = x.device

    with train_span("moe.route") as route:
        # Router (float32 for softmax stability).
        logits = x.float() @ p["router"]["kernel"].float()        # (b, s, e)
        probs = torch.softmax(logits, dim=-1)
        gates, expert_idx = torch.topk(probs, k, dim=-1)           # (b, s, k)
        gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)

        # Position of each (token, slot) in its expert's queue, in token order.
        flat_expert = expert_idx.reshape(b, sk)
        order = torch.argsort(flat_expert, dim=1, stable=True)
        sorted_e = flat_expert.gather(1, order)
        starts = torch.searchsorted(
            sorted_e, torch.arange(e, device=dev).expand(b, e).contiguous(),
            side="left")
        pos_sorted = torch.arange(sk, device=dev)[None, :] - starts.gather(1, sorted_e)
        pos = torch.empty_like(pos_sorted).scatter_(1, order, pos_sorted)
        keep = pos < cap
        dest = flat_expert * cap + torch.where(keep, pos, cap)     # (b, sk)

        # Buffer row r holds the token of the last assignment whose
        # destination is r (token j // k of assignment j), zero if none;
        # each assignment feeds the row it won, if any.  The combine reads
        # each kept assignment's row back.
        row = dest.clamp(max=slots)
        writer = _last_of(b, slots, row)
        won = writer.gather(1, row.clamp(max=slots - 1)) == torch.arange(sk, device=dev)
        reader = _last_of(b, slots, torch.where(keep, dest, slots))
        if route is not NOOP_SPAN:
            route.set_attr("rows", b * slots)
            route.set_attr("filled", (writer >= 0).sum())
            route.set_attr("dropped", (~keep).sum())
            route.set_attr("displaced", (keep & ~won).sum())

    with train_span("moe.dispatch"):
        expert_in = _Route.apply(x.to(dt), writer, torch.where(won, row, -1), k,
                                 "moe.dispatch.bwd")

    # Expert SwiGLU: three grouped matmuls, batch folded into the rows.
    # On a mesh the expert stacks hold this rank's experts over `model`
    # (`fsdp.gather_layer` keeps them cut): the GMM runs on their rows of
    # the buffer and the outputs are gathered whole.
    xin = expert_in.reshape(b, e, cap, d).transpose(0, 1).reshape(e, b * cap, d)
    w_gate, w_up, w_down = (p.cast(n, dt) for n in ("gate", "up", "down"))
    local = w_gate.shape[0] != e
    if local:
        xin = model_shard(xin, 0)
    g = ops.moe_gmm(xin, w_gate)
    u = ops.moe_gmm(xin, w_up)
    h = F.silu(g) * u
    out = ops.moe_gmm(h, w_down)                                   # (e, b·cap, d)
    if local:
        out = model_whole(out, 0)
    out_flat = out.reshape(e, b, cap, d).transpose(0, 1).reshape(b, slots, d)

    # Combine: each kept assignment's output weighted by its gate, summed
    # over the k contiguous slots of a token; a dropped one reads zero.
    with train_span("moe.combine"):
        per_assign = _Route.apply(out_flat, torch.where(keep, dest, -1), reader, 1,
                                  "moe.combine.bwd")
        per_assign = per_assign * gates.reshape(b, sk, 1).to(dt)
        y = per_assign.reshape(b, s, k, d).sum(dim=2)

    # Switch-style load-balancing aux loss, its means over the whole
    # batch (over the data axes on a mesh).
    me = batch_mean(probs.mean(dim=(0, 1)))                        # (e,)
    # One-hot by comparison: F.one_hot checks its indices on the host,
    # which waits for the card in every layer.
    top1 = expert_idx[..., :1] == torch.arange(e, device=dev)
    ce = batch_mean(top1.float().mean(dim=(0, 1)))
    aux = e * torch.sum(me * ce)
    return y, aux
