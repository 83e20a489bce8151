"""Shared layers for the LM model zoo (twin of ``repro.models.layers``).

Conventions, as in the reference:
  * parameters are a nested tree read as ``p["attn"]["q"]["kernel"]``;
    here the tree is a `Params` module, so it moves with ``.to(device)``
    and the layer stack is an `nn.ModuleList` a Python loop walks;
  * every layer takes (params, inputs, cfg) and is shape-polymorphic in
    batch/seq; layouts are the reference's ((b, s, d) activations,
    (in, out) dense kernels, (b, s, heads, head_dim) attention heads).
"""
from __future__ import annotations

import functools
import math
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.distributed.activations import (
    model_copy, model_shard, model_sum, model_whole, vocab_parallel_embedding,
)

Tensor = torch.Tensor


def torch_dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


def dtype_of(cfg) -> torch.dtype:
    return torch_dtype(cfg.compute_dtype)


def remat_runner(remat: bool = True):
    """``run(fn, *args, **kw)``: ``fn`` under
    `torch.utils.checkpoint.checkpoint` (the reference's ``jax.checkpoint``)
    when ``remat`` and gradients are enabled, else a plain call."""
    if remat and torch.is_grad_enabled():
        return lambda fn, *args, **kw: checkpoint(fn, *args, use_reentrant=False, **kw)
    return lambda fn, *args, **kw: fn(*args, **kw)


class Params(nn.Module):
    """A nested parameter tree as a module: ``p["q"]["kernel"]``,
    ``"bias" in p``.  Dicts become `Params`, lists `nn.ModuleList`s of
    `Params`, tensors parameters that start frozen; training
    (`repro_torch.distributed.init_train_state`) turns ``requires_grad``
    on for the floating ones.

    `cast` hands out a leaf in another dtype.  The reference casts its
    float32 parameters to the compute type in every call
    (``p["gate"].astype(dt)``).  At inference the cast is deterministic, so
    the copy is made once and reused, bit-identical, until the leaf is
    replaced or changed in place.  With gradients enabled and a leaf that
    requires one, `cast` returns a fresh, differentiable ``t.to(dtype)``
    and leaves the cache alone: a cached copy would be detached, and every
    matrix cast to bfloat16 would get no gradient.
    """

    def __init__(self, tree: Dict[str, Any]):
        super().__init__()
        self._casts: Dict[tuple, tuple] = {}
        for name, value in tree.items():
            if isinstance(value, dict):
                self.add_module(name, Params(value))
            elif isinstance(value, (list, tuple)):
                self.add_module(name, nn.ModuleList(Params(t) for t in value))
            else:
                self.register_parameter(
                    name, nn.Parameter(torch.as_tensor(value), requires_grad=False))

    def __getitem__(self, name: str):
        return getattr(self, name)

    def __contains__(self, name: str) -> bool:
        return name in self._parameters or name in self._modules

    def cut(self, name: str) -> Optional[int]:
        """The dim of leaf ``name`` cut over `model`: None, a module's
        leaves are whole (see `ParamView.cut`)."""
        return None

    def cast(self, name: str, dtype: Optional[torch.dtype]) -> Tensor:
        t = self._parameters[name]
        if dtype is None or t.dtype == dtype:
            return t
        if (t.requires_grad and torch.is_grad_enabled()) or is_fake(t):
            return t.to(dtype)
        stamp = (t.data_ptr(), t.device, t._version)
        hit = self._casts.get((name, dtype))
        if hit is None or hit[0] != stamp:
            hit = (stamp, t.detach().to(dtype))
            self._casts[(name, dtype)] = hit
        return hit[1]


class ParamView:
    """A read-only tree with `Params`'s interface (``p["q"]["kernel"]``,
    ``"bias" in p``, `cast`, `cut`) over nested dicts of tensors: what
    `repro_torch.distributed.fsdp.gather_layer` hands a layer in place of
    its `Params`.  A child that is not a dict (a layer stack) is returned
    as it is.  ``cut`` mirrors the tree with, for each leaf that is this
    rank's block of a dim cut over `model`, that dim."""

    __slots__ = ("_tree", "_cut")

    def __init__(self, tree: Dict[str, Any], cut: Optional[Dict[str, Any]] = None):
        self._tree = tree
        self._cut = cut or {}

    def __getitem__(self, name: str):
        node = self._tree[name]
        return ParamView(node, self._cut.get(name)) if isinstance(node, dict) else node

    def __contains__(self, name: str) -> bool:
        return name in self._tree

    def cut(self, name: str) -> Optional[int]:
        """The dim of leaf ``name`` cut over `model`, or None when whole."""
        return self._cut.get(name)

    def cast(self, name: str, dtype: Optional[torch.dtype]) -> Tensor:
        t = self._tree[name]
        return t if dtype is None or t.dtype == dtype else t.to(dtype)


# ---------------------------------------------------------------------------
# Initializers (the port's own, from a torch.Generator; the reference's
# jax.random draws are carried across with `repro_torch.convert`)
# ---------------------------------------------------------------------------

def uniform(gen: torch.Generator, shape, dtype: str, scale: float) -> Tensor:
    t = torch.empty(shape, dtype=torch_dtype(dtype), device=gen.device)
    return t.uniform_(-scale, scale, generator=gen)


def dense_init(gen: torch.Generator, in_dim: int, out_dim: int, dtype: str,
               bias: bool = False) -> Dict[str, Tensor]:
    p = {"kernel": uniform(gen, (in_dim, out_dim), dtype, 1.0 / np.sqrt(in_dim))}
    if bias:
        p["bias"] = torch.zeros((out_dim,), dtype=torch_dtype(dtype),
                                device=gen.device)
    return p


def embed_init(gen: torch.Generator, vocab: int, dim: int,
               dtype: str) -> Dict[str, Tensor]:
    e = torch.empty((vocab, dim), dtype=torch_dtype(dtype), device=gen.device)
    return {"embedding": e.normal_(generator=gen) * 0.02}


def norm_init(dim: int, dtype: str, device) -> Dict[str, Tensor]:
    return {"scale": torch.ones((dim,), dtype=torch_dtype(dtype), device=device)}


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------

def dense(p: Params, x: Tensor, dtype: Optional[torch.dtype] = None, *,
          keep_cut: bool = False) -> Tensor:
    """x @ kernel (+ bias).  A kernel cut over `model` (`Params.cut`) is
    Megatron's: column-cut, this rank's output columns (with this rank's
    block of the bias), gathered whole unless ``keep_cut``; row-cut, this
    rank's block of x's columns (x may be that block already) times the
    kernel's rows, summed over the axis, then the whole bias.  A whole
    kernel given x's block gathers x whole first."""
    kernel = p.cast("kernel", dtype)
    if dtype is not None:
        x = x.to(dtype)
    cut = p.cut("kernel")
    if cut == 0:
        if x.shape[-1] != kernel.shape[0]:
            x = model_shard(x, -1)
        y = model_sum(x @ kernel)
    elif cut == 1:
        y = model_copy(x) @ kernel
    else:
        if x.shape[-1] != kernel.shape[0]:
            x = model_whole(x, -1)
        y = x @ kernel
    if "bias" in p:
        y = y + p.cast("bias", y.dtype)
    if cut == 1 and not keep_cut:
        y = model_whole(y, -1)
    return y


def rms_norm(p: Params, x: Tensor, eps: float = 1e-6) -> Tensor:
    dt = x.dtype
    x = x.float()
    var = (x * x).mean(dim=-1, keepdim=True)
    y = x * torch.rsqrt(var + eps) * (1.0 + p["scale"].float())
    return y.to(dt)


def embed(p: Params, ids: Tensor, dtype: Optional[torch.dtype] = None,
          scale: bool = False) -> Tensor:
    e = p.cast("embedding", dtype)
    y = vocab_parallel_embedding(e, ids) if p.cut("embedding") == 0 else F.embedding(ids, e)
    if scale:
        y = y * torch.tensor(math.sqrt(e.shape[-1]), dtype=y.dtype)
    return y


def unembed(p: Params, x: Tensor) -> Tensor:
    """Project to vocab logits (uses embedding transpose when tied); a
    vocab cut over `model` gives this rank's block of the logits."""
    if p.cut("embedding") == 0:
        x = model_copy(x)
    return x @ p.cast("embedding", x.dtype).T


def swiglu_init(gen: torch.Generator, d_model: int, d_ff: int,
                dtype: str) -> Dict[str, Any]:
    return {"gate": dense_init(gen, d_model, d_ff, dtype),
            "up": dense_init(gen, d_model, d_ff, dtype),
            "down": dense_init(gen, d_ff, d_model, dtype)}


_ACTS = {
    "silu": F.silu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "gelu_tanh": lambda x: F.gelu(x, approximate="tanh"),
    "relu": F.relu,
}


def swiglu(p: Params, x: Tensor, act: str = "silu",
           dtype: Optional[torch.dtype] = None) -> Tensor:
    g = dense(p["gate"], x, dtype, keep_cut=True)
    u = dense(p["up"], x, dtype, keep_cut=True)
    return dense(p["down"], _ACTS[act](g) * u, dtype)


def mlp_gelu_init(gen: torch.Generator, d_model: int, d_ff: int, dtype: str,
                  bias: bool = True) -> Dict[str, Any]:
    return {"up": dense_init(gen, d_model, d_ff, dtype, bias=bias),
            "down": dense_init(gen, d_ff, d_model, dtype, bias=bias)}


def mlp_gelu(p: Params, x: Tensor, act: str = "gelu",
             dtype: Optional[torch.dtype] = None) -> Tensor:
    return dense(p["down"], _ACTS[act](dense(p["up"], x, dtype, keep_cut=True)), dtype)


# ---------------------------------------------------------------------------
# RoPE (split halves, as the reference: not interleaved)
# ---------------------------------------------------------------------------

def rope_frequencies(head_dim: int, theta: float) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float32) / head_dim))


@functools.lru_cache(maxsize=None)
def _rope_table(head_dim: int, theta: float, device: torch.device) -> Tensor:
    # Made once per device: a host-to-card copy in every call would wait
    # for the card's queue to drain.
    return torch.as_tensor(rope_frequencies(head_dim, theta), device=device)


def is_fake(t: Tensor) -> bool:
    """Whether ``t`` is a fake tensor (a trace under `FakeTensorMode`): the
    tables above are then made anew, never cached, so no fake tensor
    outlives its trace."""
    from torch._subclasses.fake_tensor import FakeTensor

    return isinstance(t, FakeTensor)


def apply_rope(x: Tensor, positions: Tensor, theta: float = 10000.0) -> Tensor:
    """x: (..., seq, heads, head_dim); positions: (..., seq)."""
    table = _rope_table.__wrapped__ if is_fake(x) else _rope_table
    freqs = table(x.shape[-1], float(theta), x.device)
    angles = positions[..., :, None].float() * freqs       # (..., seq, hd/2)
    cos = torch.cos(angles)[..., :, None, :]
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    return torch.cat([y1, y2], dim=-1).to(x.dtype)


def softcap(x: Tensor, cap: float) -> Tensor:
    if not cap:
        return x
    return torch.tanh(x / cap) * cap


def sinusoidal_positions(seq: int, dim: int) -> np.ndarray:
    """Whisper-style sinusoidal position embeddings."""
    pos = np.arange(seq)[:, None]
    div = np.exp(-np.log(10000.0) * np.arange(0, dim, 2) / dim)
    out = np.zeros((seq, dim), np.float32)
    out[:, 0::2] = np.sin(pos * div)
    out[:, 1::2] = np.cos(pos * div)
    return out
