"""Uniform model API (twin of ``repro.models.model_factory``), for the
families the port has: ``dense`` and ``moe`` (the plain decoder stack).

`build_model(cfg)` returns a `Model` with:
  * init(seed, device="cuda") → params         (the port's own init)
  * loss(params, batch) → (scalar, metrics)
  * forward(params, batch) → logits            (prefill)
  * init_cache(batch, max_len, device="cuda") → cache
  * decode_step(params, batch, cache) → (logits, cache)   (serve step body)

The reference's ``input_specs`` (shape stand-ins for its dry-run) has no
use without a tracer and is left out.  Families ``ssm``, ``hybrid``,
``encdec`` and ``vlm`` raise NotImplementedError (ROADMAP A.1).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import transformer
from repro_torch.models.layers import Params
from repro_torch.utils.device import DeviceLike, resolve_device

Tensor = torch.Tensor

UNPORTED_FAMILIES = {
    "ssm": "the SSM family with the ssd_scan kernel (ROADMAP A.1, B.6)",
    "hybrid": "the hybrid family with the ssd_scan kernel (ROADMAP A.1, B.6)",
    "encdec": "the encoder-decoder family (ROADMAP A.1: encdec)",
    "vlm": "the VLM family (ROADMAP A.1: VLM cross-attention)",
}


def cross_entropy(logits: Tensor, labels: Tensor) -> Tensor:
    """Mean token NLL. logits: (..., vocab) float32; labels: (...) integer."""
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels.long()[..., None])[..., 0]
    return torch.mean(logz - gold)


@dataclass
class Model:
    cfg: ArchConfig
    init: Callable[..., Params]
    loss: Callable[[Params, Dict[str, Tensor]], Tuple[Tensor, Dict[str, Tensor]]]
    forward: Callable[[Params, Dict[str, Tensor]], Tensor]
    init_cache: Callable[..., Dict[str, Any]]
    decode_step: Callable[[Params, Dict[str, Tensor], Dict[str, Any]],
                          Tuple[Tensor, Dict[str, Any]]]


def build_model(cfg: ArchConfig) -> Model:
    if cfg.family in ("dense", "moe"):
        return _build_decoder(cfg)
    if cfg.family in UNPORTED_FAMILIES:
        raise NotImplementedError(f"{cfg.name}: {UNPORTED_FAMILIES[cfg.family]} "
                                  f"is not ported yet")
    raise ValueError(f"unknown family {cfg.family!r}")


def _build_decoder(cfg: ArchConfig) -> Model:
    transformer.check_plain_stack(cfg)

    def init(seed: int, device: DeviceLike = "cuda") -> Params:
        dev = resolve_device(device)
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(seed))
        return transformer.init_decoder(gen, cfg)

    def forward(params, batch):
        logits, _ = transformer.decoder_forward(params, batch["tokens"], cfg)
        return logits

    def loss(params, batch):
        logits, aux = transformer.decoder_forward(params, batch["tokens"], cfg)
        nll = cross_entropy(logits, batch["labels"])
        return nll + 0.01 * aux, {"nll": nll, "aux": aux}

    def init_cache(batch: int, max_len: int, device: DeviceLike = "cuda"):
        return transformer.init_cache(cfg, batch, max_len,
                                      device=resolve_device(device))

    def decode_step(params, batch, cache):
        return transformer.decode_step(params, batch["token"], cache, cfg)

    return Model(cfg, init, loss, forward, init_cache, decode_step)
