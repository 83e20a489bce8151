"""MLP latency predictor (paper §4.2), on torch.

Architecture per the paper: 1–6 fully-connected layers, widths in
{64,128,256,512}, ReLU, Adam, relative squared loss, 20% validation
split, early stopping after 50 epochs without improvement.

Port notes (twin of the reference's ``repro.core.predictors.mlp``): the
network is plain functions on float32 tensors with the reference's
weight layout, ``(w, b)`` per layer with ``w`` of shape (din, dout) used
as ``h @ w + b``, so the saved JSON is the reference's field for field.
Training and prediction run on the predictor's ``device`` — the card
unless ``device="cpu"``.  The loss (relative squared error plus L2
weight decay inside it, not AdamW), full-batch Adam (`_adam_epoch`, the
gradient by `torch.autograd`) and the every-5-epochs validation with
patience and best-parameter tracking follow the reference step for
step; the validation read is the loop's one host sync per 5 epochs.

The initial weights come from a `torch.Generator` seeded with ``seed``:
JAX's threefry stream cannot be reproduced in torch, so a port MLP
trained from its own init differs from the reference's.  `_init_params`
is a module-level function so a test can substitute the reference's
initial parameters (`repro_torch.convert.mlp_params_from_reference`).
"""
from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.predictors.base import PREDICTORS, Predictor
from repro_torch.utils.device import DeviceLike, resolve_device

Params = List[Tuple[torch.Tensor, torch.Tensor]]


def _init_params(generator: torch.Generator, sizes: Sequence[int],
                 y_mean: float, device: torch.device) -> Params:
    params = []
    for i, (din, dout) in enumerate(zip(sizes[:-1], sizes[1:])):
        w = torch.randn((din, dout), generator=generator,
                        dtype=torch.float32) * math.sqrt(2.0 / din)
        b = torch.zeros(dout, dtype=torch.float32)
        if i == len(sizes) - 2:
            b = b + y_mean  # start predictions at the target mean
        params.append((w.to(device), b.to(device)))
    return params


def _forward(params: Params, x: torch.Tensor) -> torch.Tensor:
    h = x
    for w, b in params[:-1]:
        h = torch.relu(h @ w + b)
    w, b = params[-1]
    return (h @ w + b)[:, 0]


def _loss(params: Params, x: torch.Tensor, y: torch.Tensor,
          weight_decay: float) -> torch.Tensor:
    pred = _forward(params, x)
    rel = (pred - y) / torch.clamp_min(y, 1e-12)
    l2 = sum(torch.sum(w * w) for w, _ in params)
    return torch.mean(rel * rel) + weight_decay * l2


def _adam_epoch(params: Params, opt_state: Tuple[Params, Params],
                x: torch.Tensor, y: torch.Tensor, step: int, lr: float,
                weight_decay: float) -> Tuple[Params, Tuple[Params, Params]]:
    """One full-batch Adam step; returns new tensors (inputs untouched,
    so a caller may keep earlier parameters as the best so far)."""
    m, v = opt_state
    flat = [p.detach().requires_grad_(True) for pair in params for p in pair]
    with torch.enable_grad():
        loss = _loss(list(zip(flat[0::2], flat[1::2])), x, y, weight_decay)
        grads = torch.autograd.grad(loss, flat)
    b1, b2, eps = 0.9, 0.999, 1e-8
    c1, c2 = 1 - b1 ** step, 1 - b2 ** step
    new_p, new_m, new_v = [], [], []
    with torch.no_grad():
        for p, mi, vi, gi in zip(flat, (t for pair in m for t in pair),
                                 (t for pair in v for t in pair), grads):
            mi = b1 * mi + (1 - b1) * gi
            vi = b2 * vi + (1 - b2) * gi * gi
            new_p.append(p.detach() - lr * (mi / c1) / (torch.sqrt(vi / c2) + eps))
            new_m.append(mi)
            new_v.append(vi)

    def pairs(ts):
        return list(zip(ts[0::2], ts[1::2]))

    return pairs(new_p), (pairs(new_m), pairs(new_v))


@PREDICTORS.register("mlp")
class MLPPredictor(Predictor):
    name = "mlp"
    device_bound = True

    def __init__(self, hidden_layers: int = 3, width: int = 128,
                 lr: float = 5e-3, weight_decay: float = 1e-5,
                 max_epochs: int = 1500, patience: int = 100,
                 val_frac: float = 0.2, seed: int = 0,
                 device: DeviceLike = "cuda"):
        super().__init__(hidden_layers=hidden_layers, width=width, lr=lr)
        self.hidden_layers = int(hidden_layers)
        self.width = int(width)
        self.lr = float(lr)
        self.weight_decay = float(weight_decay)
        self.max_epochs = int(max_epochs)
        self.patience = int(patience)
        self.val_frac = float(val_frac)
        self.seed = seed
        self.device = resolve_device(device)
        self.params = None
        # The parameters as float32 tensors on ``device`` (built from
        # ``params`` on first use after a load).
        self._dev_params: Optional[Params] = None
        # Where the training loop's parameters lived (not serialized).
        self.fit_device: Optional[torch.device] = None

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(a, dtype=torch.float32, device=self.device)

    def _fit(self, xs: np.ndarray, y: np.ndarray) -> None:
        # Normalize the target scale (latencies are ~1e-6..1e-1 s): the
        # relative loss is scale-invariant, but Adam optimizes far better
        # with O(1) outputs.  Undone in _predict.
        self.y_scale = float(np.mean(y)) or 1.0
        y = y / self.y_scale
        n, d = xs.shape
        rng = np.random.default_rng(self.seed)
        perm = rng.permutation(n)
        n_val = max(1, int(self.val_frac * n)) if n >= 5 else 0
        val_idx, tr_idx = perm[:n_val], perm[n_val:]
        if len(tr_idx) == 0:
            tr_idx = val_idx
        xt, yt = self._tensor(xs[tr_idx]), self._tensor(y[tr_idx])
        xv, yv = ((self._tensor(xs[val_idx]), self._tensor(y[val_idx]))
                  if n_val else (xt, yt))

        sizes = [d] + [self.width] * self.hidden_layers + [1]
        gen = torch.Generator().manual_seed(int(self.seed))
        params = _init_params(gen, sizes, float(np.mean(y)), self.device)
        opt_state = ([(torch.zeros_like(w), torch.zeros_like(b)) for w, b in params],
                     [(torch.zeros_like(w), torch.zeros_like(b)) for w, b in params])

        best_val, best_params, since = float("inf"), params, 0
        for epoch in range(1, self.max_epochs + 1):
            params, opt_state = _adam_epoch(
                params, opt_state, xt, yt, epoch, self.lr, self.weight_decay
            )
            if epoch % 5 == 0 or epoch == self.max_epochs:
                with torch.no_grad():
                    pv = _forward(params, xv)
                    val = float(torch.mean(torch.abs(
                        (pv - yv) / torch.clamp_min(yv, 1e-12))))
                if val < best_val - 1e-6:
                    best_val, best_params, since = val, params, 0
                else:
                    since += 5
                    if since >= self.patience:
                        break
        self.fit_device = best_params[0][0].device
        self._dev_params = best_params
        self.params = [(w.cpu().numpy(), b.cpu().numpy()) for w, b in best_params]

    def _predict(self, xs: np.ndarray) -> np.ndarray:
        if self.params is None:
            raise RuntimeError("not fitted")
        if self._dev_params is None:
            self._dev_params = [(self._tensor(w), self._tensor(b))
                                for w, b in self.params]
        with torch.no_grad():
            out = _forward(self._dev_params, self._tensor(xs))
        return out.cpu().numpy() * self.y_scale

    # -- serialization --------------------------------------------------------
    def _config_json(self):
        return {"hidden_layers": self.hidden_layers, "width": self.width,
                "lr": self.lr, "weight_decay": self.weight_decay,
                "max_epochs": self.max_epochs, "patience": self.patience,
                "val_frac": self.val_frac, "seed": self.seed}

    def _state_to_json(self):
        return {
            "y_scale": self.y_scale,
            "params": [[w.tolist(), b.tolist()] for w, b in self.params],
        }

    def _state_from_json(self, d):
        self.y_scale = float(d["y_scale"])
        # float32 restores the trained dtype exactly (f32 → repr → f32 is
        # lossless), so reloaded predictions are bit-identical.
        self.params = [(np.asarray(w, dtype=np.float32),
                        np.asarray(b, dtype=np.float32))
                       for w, b in d["params"]]
        self._dev_params = None
