"""Plain PyTorch pieces every family's reference shares: the precisions,
RMS norm, rotary embedding, the blocked cross-entropy, AdamW with its
learning-rate schedule, and the three steps whose readings `correct`
compares.

Float32 with TF32 off (`precise`), written from the published
descriptions, not from the port: nothing here imports the port.  Every
function takes plain tensors and nested dicts or lists of them.

The control computes the same functions with the operands of every
product that the configuration runs in its compute type (bfloat16)
rounded to float8 e4m3 first, each tensor scaled by its largest
magnitude (`Prec("fp8")`): the next precision down, the step a later
change might take.  The rounding passes gradients through unchanged.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, Iterator, List, Sequence

import torch
from torch.utils.checkpoint import checkpoint

Tensor = torch.Tensor

FP8_MAX = 448.0                     # largest finite float8 e4m3fn

# AdamW's constants.  The port's step runs `adamw_update` with its own
# fixed defaults (β1 0.9, β2 0.95, ε 1e-8, gradients clipped to a global
# norm of 1) and takes none of them from a job, so neither does a cell.
B1, B2, EPS, MAX_GRAD_NORM = 0.9, 0.95, 1e-8, 1.0


def precise() -> None:
    """Float32 products in float32: TF32 off for matmuls and convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


class _RoundFp8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        amax = x.detach().abs().amax().clamp_min(1e-30)
        scale = FP8_MAX / amax
        return (x * scale).to(torch.float8_e4m3fn).to(x.dtype) / scale

    @staticmethod
    def backward(ctx, g):
        return g


class Prec:
    """The precision of the products that the configuration runs in its
    compute type: ``"float32"`` (the reference) or ``"fp8"`` (the
    control)."""

    def __init__(self, name: str = "float32"):
        if name not in ("float32", "fp8"):
            raise ValueError(f"unknown precision {name!r}")
        self.name = name

    def round(self, x: Tensor) -> Tensor:
        return _RoundFp8.apply(x) if self.name == "fp8" else x

    def mm(self, a: Tensor, b: Tensor) -> Tensor:
        return self.round(a) @ self.round(b)


def rms_norm(x: Tensor, scale: Tensor, eps: float) -> Tensor:
    """x / rms(x) · (1 + scale), the port's convention for its norm scale."""
    return x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps) * (1.0 + scale)


def rope(x: Tensor, theta: float) -> Tensor:
    """Rotary embedding of x (b, s, heads, hd) at positions 0..s-1, the
    two halves of each head rotated together (not interleaved)."""
    s, hd = x.shape[1], x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                        device=x.device) / hd))
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] * inv
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def softplus(x: Tensor) -> Tensor:
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-x.abs()))


def _nll_sum(x: Tensor, emb: Tensor, labels: Tensor, prec: Prec) -> Tensor:
    logits = prec.mm(x, emb.t())
    return (torch.logsumexp(logits, dim=-1)
            - logits.gather(-1, labels[:, None])[:, 0]).sum()


def cross_entropy(x: Tensor, emb: Tensor, labels: Tensor, prec: Prec,
                  rows: int = 2048) -> Tensor:
    """Mean next-token NLL of the tied head ``x @ emb.T`` over all rows,
    a block of rows at a time (each recomputed in the backward)."""
    x = x.reshape(-1, x.shape[-1])
    labels = labels.reshape(-1).long()
    total = sum(checkpoint(_nll_sum, x[i:i + rows], emb, labels[i:i + rows], prec,
                           use_reentrant=False)
                for i in range(0, x.shape[0], rows))
    return total / x.shape[0]


# ---------------------------------------------------------------------------
# Trees
# ---------------------------------------------------------------------------

def flatten(tree: Any, prefix: str = "") -> Dict[str, Tensor]:
    """{'a/b/0/c': leaf}: dict keys in sorted order, list items by index."""
    if isinstance(tree, dict):
        items = [(str(k), tree[k]) for k in sorted(tree)]
    elif isinstance(tree, (list, tuple)):
        items = [(str(i), v) for i, v in enumerate(tree)]
    else:
        return {prefix: tree}
    out: Dict[str, Tensor] = {}
    for k, v in items:
        out.update(flatten(v, f"{prefix}/{k}" if prefix else k))
    return out


def unflatten(flat: Dict[str, Tensor]) -> Dict[str, Any]:
    """The tree of {'a/b/0/c': leaf}: a level whose keys are all digits is
    a list."""
    tree: Dict[str, Any] = {}
    for path, leaf in flat.items():
        node = tree
        *parts, last = path.split("/")
        for part in parts:
            node = node.setdefault(part, {})
        node[last] = leaf

    def lists(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return [lists(node[str(i)]) for i in range(len(node))]
        return {k: lists(v) for k, v in node.items()}

    return lists(tree)


Group = Callable[[torch.Generator], Dict[str, Tensor]]


def layer_leaves(path: str, stack: Tensor) -> Dict[str, Tensor]:
    """{'layers/i/<path>': stack[i]}: one draw cut into the layers' leaves."""
    return {f"layers/{i}/{path}": stack[i] for i in range(stack.shape[0])}


def weights_by_group(groups: Sequence[Group], seed: int, device) -> Iterator[Dict[str, Tensor]]:
    """Each group's leaves in turn ({path: tensor}, each its own copy),
    group i drawn from a generator on ``device`` seeded with
    64·seed + i: one large draw a group, and a group can be made again
    without the others."""
    for i, make in enumerate(groups):
        gen = torch.Generator(device=device)
        gen.manual_seed(64 * int(seed) + i)
        yield {k: v.clone() for k, v in make(gen).items()}


def weights(groups: Sequence[Group], seed: int, device) -> Dict[str, Any]:
    """The whole tree of `weights_by_group`."""
    flat: Dict[str, Tensor] = {}
    for part in weights_by_group(groups, seed, device):
        flat.update(part)
    return unflatten(flat)


def uniform(gen: torch.Generator, shape, bound: float) -> Tensor:
    return torch.empty(shape, device=gen.device).uniform_(-bound, bound, generator=gen)


def normal(gen: torch.Generator, shape, std: float) -> Tensor:
    return torch.empty(shape, device=gen.device).normal_(generator=gen) * std


# ---------------------------------------------------------------------------
# AdamW and its schedule
# ---------------------------------------------------------------------------

def learning_rate(step: int, job: Dict[str, Any], device) -> Tensor:
    """Linear warm-up to ``base_lr`` over ``warmup_steps``, then a cosine
    to a tenth of it at ``total_steps``, in float32; ``step`` counts from
    0 (the rate of the first update)."""
    base, warm, total = job["base_lr"], job["warmup_steps"], job["total_steps"]
    t = torch.tensor(step, dtype=torch.float32, device=device)
    if step < warm:
        return base * torch.clamp(t / max(1, warm), max=1.0)
    frac = torch.clamp((t - warm) / max(1, total - warm), 0.0, 1.0)
    return base * (0.1 + 0.9 * 0.5 * (1 + torch.cos(math.pi * frac)))


@torch.no_grad()
def adamw(params: Dict[str, Tensor], grads: Dict[str, Tensor], mu, nu, step: int,
          job: Dict[str, Any], b1: float = B1, b2: float = B2,
          eps: float = EPS, max_norm: float = MAX_GRAD_NORM) -> Dict[str, Tensor]:
    """One AdamW step (Loshchilov & Hutter: decay decoupled, scaled by the
    rate) on gradients clipped to a global norm of ``max_norm``; updates
    ``params``, ``mu`` and ``nu`` in place and returns the clipped
    gradients' per-leaf norms."""
    dev = next(iter(params.values())).device
    gnorm = torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))
    scale = torch.clamp(max_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    t = torch.tensor(step + 1, dtype=torch.float32, device=dev)
    bc1 = 1 - torch.pow(torch.tensor(b1, device=dev), t)
    bc2 = 1 - torch.pow(torch.tensor(b2, device=dev), t)
    lr = learning_rate(step, job, dev)
    norms = {}
    for k, p in params.items():
        g = grads[k] * scale
        norms[k] = torch.linalg.vector_norm(g)
        mu[k].mul_(b1).add_((1 - b1) * g)
        nu[k].mul_(b2).add_((1 - b2) * g * g)
        u = (mu[k] / bc1) / (torch.sqrt(nu[k] / bc2) + eps) + job["weight_decay"] * p
        p.sub_(lr * u)
    return norms


# ---------------------------------------------------------------------------
# The readings
# ---------------------------------------------------------------------------

def train_readings(loss_fn: Callable[[Dict[str, Any], Dict[str, Tensor]], Tensor],
                   groups: Sequence[Group], seed: int, device,
                   batches: Sequence[Dict[str, Tensor]], job: Dict[str, Any]) -> Dict[str, Any]:
    """Train the weights of ``groups`` from ``seed`` on ``batches`` with
    AdamW, one step a batch, and read what `correct` compares: each step's
    loss, the first step's clipped gradient norm of each leaf (as the
    optimizer gets it) and each leaf's change after the last step (the
    norm of the difference from the weights made again from the seed)."""
    tree = weights(groups, seed, device)
    flat = flatten(tree)
    for v in flat.values():
        v.requires_grad_(True)
    mu = {k: torch.zeros_like(v) for k, v in flat.items()}
    nu = {k: torch.zeros_like(v) for k, v in flat.items()}
    losses: List[float] = []
    grad_norms: Dict[str, float] = {}
    for step, batch in enumerate(batches):
        loss = loss_fn(tree, batch)
        grads = dict(zip(flat, torch.autograd.grad(loss, list(flat.values()),
                                                   allow_unused=True)))
        grads = {k: torch.zeros_like(flat[k]) if g is None else g for k, g in grads.items()}
        losses.append(float(loss.detach()))
        del loss
        norms = adamw(flat, grads, mu, nu, step, job)
        del grads
        if step == 0:
            grad_norms = {k: float(v) for k, v in norms.items()}
    del mu, nu
    change: Dict[str, float] = {}
    for start in weights_by_group(groups, seed, device):
        change.update({k: float(torch.linalg.vector_norm(flat[k].detach() - v))
                       for k, v in start.items()})
        del start
    return {"losses": losses, "grad_norms": grad_norms, "change_norms": change}
