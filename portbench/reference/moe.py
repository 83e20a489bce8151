"""Plain float32 reference of the decoder with mixture-of-experts FFNs
(family ``moe``: Granite-MoE), and the benchmark's weights for it.

The layer (pre-norm residual, as the port runs it):
    h = rms(x); q, k, v = h·Wq, h·Wk, h·Wv; rotary on q and k;
    causal attention, query head i reading key/value head i // (h/kvh),
    scores scaled by 1/sqrt(hd); x += o·Wo;
    h = rms(x); x += moe(h)
then rms and the tied head (x·Eᵀ), and the loss: the mean next-token NLL
plus 0.01 × the layers' summed Switch load-balance terms.

The MoE FFN, per batch row (GShard / Switch routing with capacity):
router logits h·Wr in float32, softmax, the top-k experts and their
probabilities renormalised to sum to one; each (token, slot) pair, in
token-then-slot order, takes the next place in its expert's queue, and
the pairs past cap = max(ceil(s·k/e · capacity_factor), k) are dropped;
each expert runs SwiGLU (silu(x·G) ⊙ x·U)·D on its queue; a token sums
its kept pairs' outputs weighted by their gates; a dropped pair adds 0.
One departure from the published scheme, the system's own (its docstring
states it): a dropped pair of expert j is written to the first place of
expert j+1's queue (the last expert's to an overflow row no expert
reads), and where two pairs are written to one place the later one in
token order stays there; the pair that owns that place then reads the
expert's output on the later pair's token.  This reference does the
same, so the comparison measures arithmetic, not that choice.  With
``overflow: "drop"`` in the configuration it drops the pair as published
instead; only `calibrate.py` sets that, to read what the choice does.

Attention and the loss are computed a block of rows at a time, each block
recomputed in the backward, and every layer is recomputed in the
backward, so the reference fits beside nothing larger than one layer's
float32 activations.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from portbench.reference._plain import (
    Group, Prec, cross_entropy, layer_leaves, normal, rms_norm, rope, uniform,
)

Tensor = torch.Tensor


def groups(cfg: Dict[str, Any]) -> List[Group]:
    """The benchmark's weights in the port's layout and in its init's
    distributions, a draw a group (`_plain.weights_by_group`): embedding
    N(0, 0.02²), each kernel U(±1/sqrt(fan_in)), norm scales 1."""
    L, d, h, kvh, hd = (cfg[k] for k in ("num_layers", "d_model", "num_heads",
                                         "num_kv_heads", "head_dim"))
    e, f, v = cfg["num_experts"], cfg["d_ff"], cfg["vocab_size"]

    def kernel(path, shape, fan_in):
        return lambda gen: layer_leaves(path, uniform(gen, (L, *shape), 1 / math.sqrt(fan_in)))

    def norms(gen):
        ones = torch.ones(d, device=gen.device)
        out = {"final_norm/scale": ones}
        for i in range(L):
            out[f"layers/{i}/attn_norm/scale"] = ones
            out[f"layers/{i}/mlp_norm/scale"] = ones
        return out

    return [lambda gen: {"embed/embedding": normal(gen, (v, d), 0.02)},
            kernel("attn/q/kernel", (d, h * hd), d),
            kernel("attn/k/kernel", (d, kvh * hd), d),
            kernel("attn/v/kernel", (d, kvh * hd), d),
            kernel("attn/o/kernel", (h * hd, d), h * hd),
            kernel("mlp/router/kernel", (d, e), d),
            kernel("mlp/gate", (e, d, f), d),
            kernel("mlp/up", (e, d, f), d),
            kernel("mlp/down", (e, f, d), f),
            norms]


def _attention_block(q: Tensor, k: Tensor, v: Tensor, q0: int, prec: Prec) -> Tensor:
    """Causal attention of queries q0.. (n, h, hd) over keys 0..q0+n-1
    (m, kvh, hd)."""
    n, h, hd = q.shape
    m, kvh, _ = k.shape
    qg = q.reshape(n, kvh, h // kvh, hd).permute(1, 2, 0, 3)       # (kvh, r, n, hd)
    kg = k.permute(1, 0, 2)[:, None]                               # (kvh, 1, m, hd)
    scores = prec.mm(qg, kg.transpose(-1, -2)) / math.sqrt(hd)     # (kvh, r, n, m)
    hidden = (torch.arange(m, device=q.device)[None, :]
              > (q0 + torch.arange(n, device=q.device))[:, None])
    probs = torch.softmax(scores.masked_fill(hidden, -math.inf), dim=-1)
    out = prec.mm(probs, v.permute(1, 0, 2)[:, None])              # (kvh, r, n, hd)
    return out.permute(2, 0, 1, 3).reshape(n, h, hd)


def attention(q: Tensor, k: Tensor, v: Tensor, prec: Prec, rows: int = 1024) -> Tensor:
    """Causal GQA attention, (b, s, h, hd) over (b, s, kvh, hd), a batch
    row and a block of query rows at a time."""
    b, s = q.shape[:2]
    out = []
    for i in range(b):
        blocks = [checkpoint(_attention_block, q[i, q0:q0 + rows], k[i, :q0 + rows],
                             v[i, :q0 + rows], q0, prec, use_reentrant=False)
                  for q0 in range(0, s, rows)]
        out.append(torch.cat(blocks, dim=0))
    return torch.stack(out)


def capacity(s: int, cfg: Dict[str, Any]) -> int:
    cap = math.ceil(s * cfg["top_k"] / cfg["num_experts"] * cfg["capacity_factor"])
    return max(cap, cfg["top_k"])


def moe(p: Dict[str, Any], x: Tensor, cfg: Dict[str, Any], prec: Prec):
    """x (b, s, d) → (y (b, s, d), the Switch load-balance term)."""
    b, s, d = x.shape
    e, k = cfg["num_experts"], cfg["top_k"]
    cap = capacity(s, cfg)
    probs = torch.softmax(x @ p["router"]["kernel"], dim=-1)        # float32 always
    gates, idx = torch.topk(probs, k, dim=-1)
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    flat = idx.reshape(b, s * k)
    onehot = F.one_hot(flat, e)                                     # (b, sk, e)
    pos = (torch.cumsum(onehot, dim=1) - 1).gather(2, flat[..., None])[..., 0]
    keep = pos < cap
    dest = flat * cap + torch.where(keep, pos, torch.full_like(pos, cap))
    if cfg.get("overflow") == "drop":
        place = torch.where(keep, dest, torch.full_like(dest, e * cap))
    else:
        place = dest.clamp(max=e * cap)                             # e·cap: overflow
    pair = torch.arange(s * k, device=x.device).expand(b, s * k)
    writer = torch.full((b, e * cap + 1), -1, dtype=torch.long, device=x.device)
    writer.scatter_reduce_(1, place, pair, reduce="amax")
    writer = writer[:, :e * cap]
    buf = x.gather(1, (writer.clamp(min=0) // k)[..., None].expand(b, e * cap, d))
    buf = buf * (writer >= 0)[..., None]
    buf = buf.reshape(b, e, cap, d)
    g = prec.mm(buf, p["gate"])                                     # (b, e, cap, f)
    u = prec.mm(buf, p["up"])
    out = prec.mm(F.silu(g) * u, p["down"]).reshape(b, e * cap, d)
    read = out.gather(1, dest.clamp(max=e * cap - 1)[..., None].expand(b, s * k, d))
    y = (read * (gates.reshape(b, s * k, 1) * keep[..., None])).reshape(b, s, k, d).sum(2)
    me = probs.mean(dim=(0, 1))
    ce = F.one_hot(idx[..., 0], e).float().mean(dim=(0, 1))
    return y, e * torch.sum(me * ce)


def _layer(lp: Dict[str, Any], x: Tensor, cfg: Dict[str, Any], prec: Prec):
    b, s, d = x.shape
    h, kvh, hd = cfg["num_heads"], cfg["num_kv_heads"], cfg["head_dim"]
    eps, theta = cfg["norm_eps"], cfg["rope_theta"]
    a = lp["attn"]
    hn = rms_norm(x, lp["attn_norm"]["scale"], eps)
    q = rope(prec.mm(hn, a["q"]["kernel"]).reshape(b, s, h, hd), theta)
    k = rope(prec.mm(hn, a["k"]["kernel"]).reshape(b, s, kvh, hd), theta)
    v = prec.mm(hn, a["v"]["kernel"]).reshape(b, s, kvh, hd)
    o = attention(q, k, v, prec).reshape(b, s, h * hd)
    x = x + prec.mm(o, a["o"]["kernel"])
    y, aux = moe(lp["mlp"], rms_norm(x, lp["mlp_norm"]["scale"], eps), cfg, prec)
    return x + y, aux


def loss(params: Dict[str, Any], batch: Dict[str, Tensor], cfg: Dict[str, Any],
         prec: Prec = Prec()) -> Tensor:
    emb = params["embed"]["embedding"]
    x = emb[batch["tokens"].long()]
    aux = torch.zeros((), device=x.device)
    for lp in params["layers"]:
        x, a = checkpoint(_layer, lp, x, cfg, prec, use_reentrant=False)
        aux = aux + a
    x = rms_norm(x, params["final_norm"]["scale"], cfg["norm_eps"])
    return cross_entropy(x, emb, batch["labels"], prec) + 0.01 * aux
