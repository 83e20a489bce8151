"""Plain float32 reference of the Mamba2 stack (family ``ssm``), and the
benchmark's weights for it.

The block (Dao & Gu, arXiv:2405.21060, one B/C group; pre-norm residual,
as the port runs it):
    h = rms(x); [z, x', B, C, dt] = h·W_in;
    [x', B, C] = silu(causal depthwise conv of width w over [x', B, C] + b);
    dt = softplus(dt + dt_bias); a = exp(A_log);
    y = SSD(x', dt, a, B, C) + D·x';   y = rms(y ⊙ silu(z));   x += y·W_out
then rms and the tied head, and the mean next-token NLL.

SSD is the paper's chunked algorithm (its ``ssd_minimal``): the
recurrence state_t = exp(−a·dt_t)·state_{t−1} + dt_t·B_t ⊗ x_t,
y_t = C_t·state_t, computed in chunks of Q tokens as a masked
decay-weighted product within each chunk plus the chunks' states carried
by a loop over the chunks.  All of it in float32 (as the port computes
it); only in_proj and out_proj take the control's precision, the products
that the configuration runs in bfloat16.  Masked decays are exactly 0
here (the port uses exp(−60)).  Every block is recomputed in the
backward.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from portbench.reference._plain import (
    Group, Prec, cross_entropy, layer_leaves, normal, rms_norm, softplus, uniform,
)

Tensor = torch.Tensor


def dims(cfg: Dict[str, Any]):
    """(d_inner, heads, head_dim, state)."""
    d_inner = cfg["d_model"] * cfg["ssm_expand"]
    return d_inner, d_inner // cfg["ssm_head_dim"], cfg["ssm_head_dim"], cfg["ssm_state"]


def groups(cfg: Dict[str, Any]) -> List[Group]:
    """The benchmark's weights in the port's layout and in its init's
    distributions, a draw a group (`_plain.weights_by_group`): embedding
    N(0, 0.02²), in_proj and out_proj U(±1/sqrt(fan_in)), conv weights
    N(0, 0.1²), conv bias and dt_bias 0, A_log = log(1..16 over the heads),
    D and norm scales 1."""
    L, d, v, w = cfg["num_layers"], cfg["d_model"], cfg["vocab_size"], cfg["ssm_conv_width"]
    di, h, _, n = dims(cfg)
    ch = di + 2 * n

    def constants(gen):
        dev = gen.device
        out = {"final_norm/scale": torch.ones(d, device=dev)}
        a_log = torch.log(torch.linspace(1.0, 16.0, h, device=dev))
        for i in range(L):
            out.update({f"layers/{i}/norm/scale": torch.ones(d, device=dev),
                        f"layers/{i}/conv_b": torch.zeros(ch, device=dev),
                        f"layers/{i}/A_log": a_log,
                        f"layers/{i}/D": torch.ones(h, device=dev),
                        f"layers/{i}/dt_bias": torch.zeros(h, device=dev),
                        f"layers/{i}/out_norm/scale": torch.ones(di, device=dev)})
        return out

    return [lambda gen: {"embed/embedding": normal(gen, (v, d), 0.02)},
            lambda gen: layer_leaves("in_proj/kernel", uniform(
                gen, (L, d, 2 * di + 2 * n + h), 1 / math.sqrt(d))),
            lambda gen: layer_leaves("conv_w", normal(gen, (L, w, ch), 0.1)),
            lambda gen: layer_leaves("out_proj/kernel", uniform(
                gen, (L, di, d), 1 / math.sqrt(di))),
            constants]


def ssd(x: Tensor, dt: Tensor, a: Tensor, bmat: Tensor, cmat: Tensor, chunk: int) -> Tensor:
    """x (b, s, h, p), dt (b, s, h), a (h,), B and C (b, s, n) → y (b, s, h, p).
    A sequence shorter than ``chunk`` is one chunk."""
    b, s, h, p = x.shape
    n = bmat.shape[-1]
    nc = max(1, s // chunk)
    q = s // nc
    if nc * q != s:
        raise ValueError("the sequence must split into whole chunks")
    x = x.reshape(b, nc, q, h, p)
    dt = dt.reshape(b, nc, q, h)
    bc, cc = bmat.reshape(b, nc, q, n), cmat.reshape(b, nc, q, n)
    cum = torch.cumsum(-dt * a, dim=2)                               # (b, c, q, h)
    tri = torch.ones(q, q, dtype=torch.bool, device=x.device).tril()
    seg = (cum[:, :, :, None, :] - cum[:, :, None, :, :]).masked_fill(
        ~tri[None, None, :, :, None], -math.inf)                     # (b, c, t, s, h)
    w = torch.exp(seg) * (cc @ bc.transpose(-1, -2))[..., None] * dt[:, :, None]
    y = torch.einsum("bctsh,bcshp->bcthp", w, x)
    del w, seg
    to_end = torch.exp(cum[:, :, -1:, :] - cum) * dt                 # (b, c, q, h)
    states = torch.einsum("bcsh,bcshp,bcsn->bchpn", to_end, x, bc)
    decay = torch.exp(cum[:, :, -1, :])                              # (b, c, h)
    state = torch.zeros(b, h, p, n, device=x.device)
    before = []
    for c in range(nc):
        before.append(state)
        state = decay[:, c, :, None, None] * state + states[:, c]
    inter = torch.einsum("bctn,bchpn->bcthp", cc, torch.stack(before, dim=1))
    y = y + inter * torch.exp(cum)[..., None]
    return y.reshape(b, s, h, p)


def _causal_conv(x: Tensor, w: Tensor, bias: Tensor) -> Tensor:
    k = w.shape[0]
    xp = F.pad(x, (0, 0, k - 1, 0))
    return sum(xp[:, i: i + x.shape[1]] * w[i] for i in range(k)) + bias


def _layer(lp: Dict[str, Any], x: Tensor, cfg: Dict[str, Any], prec: Prec) -> Tensor:
    b, s, _ = x.shape
    di, h, p, n = dims(cfg)
    eps = cfg["norm_eps"]
    zxbcdt = prec.mm(rms_norm(x, lp["norm"]["scale"], eps), lp["in_proj"]["kernel"])
    z, xin, bmat, cmat, dt = torch.split(zxbcdt, [di, di, n, n, h], dim=-1)
    conv = F.silu(_causal_conv(torch.cat([xin, bmat, cmat], dim=-1),
                               lp["conv_w"], lp["conv_b"]))
    xin, bmat, cmat = torch.split(conv, [di, n, n], dim=-1)
    dt = softplus(dt + lp["dt_bias"])
    xh = xin.reshape(b, s, h, p)
    y = ssd(xh, dt, torch.exp(lp["A_log"]), bmat, cmat, cfg["ssm_chunk"])
    y = (y + xh * lp["D"][:, None]).reshape(b, s, di)
    y = rms_norm(y * F.silu(z), lp["out_norm"]["scale"], eps)
    return x + prec.mm(y, lp["out_proj"]["kernel"])


def loss(params: Dict[str, Any], batch: Dict[str, Tensor], cfg: Dict[str, Any],
         prec: Prec = Prec()) -> Tensor:
    emb = params["embed"]["embedding"]
    x = emb[batch["tokens"].long()]
    for lp in params["layers"]:
        x = checkpoint(_layer, lp, x, cfg, prec, use_reentrant=False)
    x = rms_norm(x, params["final_norm"]["scale"], cfg["norm_eps"])
    return cross_entropy(x, emb, batch["labels"], prec)
