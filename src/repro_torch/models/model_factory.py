"""Uniform model API over every architecture family (twin of
``repro.models.model_factory``): ``dense``, ``moe`` and ``vlm`` (the
decoder stacks of `transformer`, gemma2's local/global pairs among the
dense), ``ssm`` (Mamba2), ``hybrid`` (Zamba2) and ``encdec`` (Whisper).

`build_model(cfg)` returns a `Model` with:
  * init(seed, device="cuda") → params         (the port's own init)
  * loss(params, batch) → (scalar, metrics)
  * forward(params, batch) → logits            (prefill)
  * init_cache(batch, max_len, device="cuda") → cache
  * decode_step(params, batch, cache) → (logits, cache)   (serve step body)
  * input_specs(shape) → {name: InputSpec}     (the dry run's stand-ins)

Batches carry the modality frontends' stub outputs, as the reference's:
the VLM's ``vision_embeds`` (b, vision_seq, d_model) in ``forward``,
``loss`` and ``decode_step``; Whisper's ``frames`` (b, encoder_seq,
d_model) in ``forward`` and ``loss`` and the encoder's ``memory``
(`encdec.encode`) in ``decode_step``.  ``input_specs`` gives each input's
shape and dtype for a `configs.InputShape` (the reference's
``ShapeDtypeStruct`` stand-ins), which `repro_torch.launch.dryrun` makes
into fake tensors.

``init`` makes every tensor with factory calls on the generator's
device, so under `torch._subclasses.fake_tensor.FakeTensorMode` it
allocates nothing; `_generator` only makes the seeded generator, which a
fake trace on ``cuda`` needs no card memory for.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig, InputShape
from repro_torch.distributed.activations import (
    constrain_logits, constrain_seq, vocab_parallel_cross_entropy,
)
from repro_torch.distributed.fsdp import local_params, pin_layer_stack
from repro_torch.distributed.sharding import local_cache
from repro_torch.models import encdec, hybrid, ssm, transformer
from repro_torch.models.layers import (
    Params, dtype_of, embed, embed_init, norm_init, remat_runner, rms_norm, torch_dtype,
    unembed,
)
from repro_torch.obs.tracing import train_span
from repro_torch.utils.device import DeviceLike, resolve_device

Tensor = torch.Tensor

def cross_entropy(logits: Tensor, labels: Tensor, vocab: Optional[int] = None
                  ) -> Tensor:
    """Mean token NLL. logits: (..., vocab) float32; labels: (...) integer.
    Logits narrower than ``vocab`` are this rank's block of a vocab cut
    over `model` (`activations.constrain_logits`)."""
    if vocab is not None and logits.shape[-1] != vocab:
        return vocab_parallel_cross_entropy(logits, labels)
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels.long()[..., None])[..., 0]
    return torch.mean(logz - gold)


class InputSpec(NamedTuple):
    """One input's shape and dtype (the reference's ``ShapeDtypeStruct``)."""

    shape: Tuple[int, ...]
    dtype: torch.dtype


def _token_specs(shape: InputShape) -> Dict[str, InputSpec]:
    b = shape.global_batch
    if shape.is_decode:
        return {"token": InputSpec((b, 1), torch.int32)}
    return {"tokens": InputSpec((b, shape.seq_len), torch.int32),
            "labels": InputSpec((b, shape.seq_len), torch.int32)}


@dataclass
class Model:
    cfg: ArchConfig
    init: Callable[..., Params]
    loss: Callable[[Params, Dict[str, Tensor]], Tuple[Tensor, Dict[str, Tensor]]]
    forward: Callable[[Params, Dict[str, Tensor]], Tensor]
    init_cache: Callable[..., Dict[str, Any]]
    decode_step: Callable[[Params, Dict[str, Tensor], Dict[str, Any]],
                          Tuple[Tensor, Dict[str, Any]]]
    input_specs: Callable[[InputShape], Dict[str, InputSpec]]


def build_model(cfg: ArchConfig) -> Model:
    if cfg.family in ("dense", "moe", "vlm"):
        return _build_decoder(cfg)
    if cfg.family == "ssm":
        return _build_ssm(cfg)
    if cfg.family == "hybrid":
        return _build_hybrid(cfg)
    if cfg.family == "encdec":
        return _build_encdec(cfg)
    raise ValueError(f"unknown family {cfg.family!r}")


def _generator(seed: int, device: DeviceLike) -> torch.Generator:
    gen = torch.Generator(device=resolve_device(device))
    gen.manual_seed(int(seed))
    return gen


def head_nll(head: Callable[[Tensor], Tensor], x: Tensor, labels: Tensor,
             vocab: int) -> Tensor:
    """The loss head: the last layer's output ``x`` → logits (``head``) →
    the mean token NLL (`cross_entropy`).  Span ``lm.head`` in a traced
    training step, its backward ``lm.head.bwd``."""
    with train_span("lm.head") as span:
        x, = span.inputs(x)
        return span.output(cross_entropy(head(x), labels, vocab))


def _nll_loss(forward, vocab: int):
    def loss(params, batch):
        nll = cross_entropy(forward(params, batch), batch["labels"], vocab)
        return nll, {"nll": nll}
    return loss


def _build_decoder(cfg: ArchConfig) -> Model:
    def init(seed: int, device: DeviceLike = "cuda") -> Params:
        return transformer.init_decoder(_generator(seed, device), cfg)

    def forward(params, batch):
        logits, _ = transformer.decoder_forward(
            params, batch["tokens"], cfg, vision_embeds=batch.get("vision_embeds"))
        return logits

    def loss(params, batch):
        top, x, aux = transformer.decoder_trunk(
            params, batch["tokens"], cfg, vision_embeds=batch.get("vision_embeds"))
        nll = head_nll(lambda h: transformer.decoder_head(top, h, cfg), x,
                       batch["labels"], cfg.vocab_size)
        return nll + 0.01 * aux, {"nll": nll, "aux": aux}

    def init_cache(batch: int, max_len: int, device: DeviceLike = "cuda"):
        return transformer.init_cache(cfg, batch, max_len,
                                      device=resolve_device(device))

    def decode_step(params, batch, cache):
        return transformer.decode_step(params, batch["token"], cache, cfg,
                                       vision_embeds=batch.get("vision_embeds"))

    def input_specs(shape: InputShape) -> Dict[str, InputSpec]:
        specs = _token_specs(shape)
        if cfg.family == "vlm":
            specs["vision_embeds"] = InputSpec(
                (shape.global_batch, cfg.vision_seq or 1024, cfg.d_model),
                torch_dtype(cfg.compute_dtype))
        return specs

    return Model(cfg, init, loss, forward, init_cache, decode_step, input_specs)


# ---------------------------------------------------------------------------
# ssm — Mamba2
# ---------------------------------------------------------------------------

def _build_ssm(cfg: ArchConfig) -> Model:
    def init(seed: int, device: DeviceLike = "cuda") -> Params:
        gen = _generator(seed, device)
        p = {
            "embed": embed_init(gen, cfg.vocab_size, cfg.d_model, cfg.param_dtype),
            "layers": [ssm.mamba_init(gen, cfg) for _ in range(cfg.num_layers)],
            "final_norm": norm_init(cfg.d_model, cfg.param_dtype, gen.device),
        }
        if not cfg.tie_embeddings:
            p["lm_head"] = embed_init(gen, cfg.vocab_size, cfg.d_model,
                                      cfg.param_dtype)
        return Params(p)

    def trunk(params, batch, remat: bool = True):
        """(the top-level leaves as computed on, the last layer's output)."""
        top = local_params(params)
        x = embed(top["embed"], batch["tokens"], dtype_of(cfg))
        run = remat_runner(remat)
        s = x.shape[1]
        for lp in pin_layer_stack(params["layers"], cfg):
            x = run(ssm.mamba_layer, lp, constrain_seq(x, cfg), cfg, s)
        return top, x

    def head(top, x):
        x = rms_norm(top["final_norm"], x, cfg.norm_eps)
        return constrain_logits(unembed(transformer._head(top, cfg), x),
                                cfg.vocab_size).float()

    def forward(params, batch, *, remat: bool = True):
        """Logits in float32, no softcap (as the reference's SSM).  With
        ``remat`` and gradients enabled each layer runs under
        `torch.utils.checkpoint.checkpoint` (remat, the reference's
        ``jax.checkpoint`` of its layer scan), as in `decoder_forward`;
        the sharding hooks sit where the reference's do."""
        return head(*trunk(params, batch, remat))

    def loss(params, batch):
        top, x = trunk(params, batch)
        nll = head_nll(lambda h: head(top, h), x, batch["labels"], cfg.vocab_size)
        return nll, {"nll": nll}

    def init_cache(batch: int, max_len: int, device: DeviceLike = "cuda"):
        return ssm.init_mamba_cache(cfg, batch, cfg.num_layers,
                                    resolve_device(device))

    def decode_step(params, batch, cache):
        top = local_params(params)
        x = embed(top["embed"], batch["token"], dtype_of(cfg))
        x = ssm.mamba_decode_layers(params["layers"], x, cfg, local_cache(cache))
        x = rms_norm(top["final_norm"], x, cfg.norm_eps)
        return unembed(transformer._head(top, cfg), x[:, 0]).float(), cache

    return Model(cfg, init, loss, forward, init_cache, decode_step, _token_specs)


# ---------------------------------------------------------------------------
# hybrid — Zamba2
# ---------------------------------------------------------------------------

def _build_hybrid(cfg: ArchConfig) -> Model:
    def init(seed: int, device: DeviceLike = "cuda") -> Params:
        return hybrid.init_hybrid(_generator(seed, device), cfg)

    def forward(params, batch):
        return hybrid.hybrid_forward(params, batch["tokens"], cfg)

    def init_cache(batch: int, max_len: int, device: DeviceLike = "cuda"):
        return hybrid.init_hybrid_cache(cfg, batch, max_len, resolve_device(device))

    def decode_step(params, batch, cache):
        return hybrid.hybrid_decode_step(params, batch["token"], cache, cfg)

    return Model(cfg, init, _nll_loss(forward, cfg.vocab_size), forward, init_cache,
                 decode_step, _token_specs)


# ---------------------------------------------------------------------------
# encdec — Whisper
# ---------------------------------------------------------------------------

def _build_encdec(cfg: ArchConfig) -> Model:
    def init(seed: int, device: DeviceLike = "cuda") -> Params:
        return encdec.init_encdec(_generator(seed, device), cfg)

    def forward(params, batch):
        memory = encdec.encode(params, batch["frames"], cfg)
        return encdec.decode_train(params, batch["tokens"], memory, cfg)

    def init_cache(batch: int, max_len: int, device: DeviceLike = "cuda"):
        return encdec.init_encdec_cache(cfg, batch, max_len,
                                        device=resolve_device(device))

    def decode_step(params, batch, cache):
        return encdec.decode_step(params, batch["token"], cache, batch["memory"], cfg)

    def input_specs(shape: InputShape) -> Dict[str, InputSpec]:
        """Teacher-forced train/prefill take the shape's decoder length (the
        reference's: Whisper's real decoder caps at 448)."""
        b, enc = shape.global_batch, cfg.encoder_seq or 1500
        frames = InputSpec((b, enc, cfg.d_model), torch_dtype(cfg.compute_dtype))
        if shape.is_decode:
            return {"token": InputSpec((b, 1), torch.int32), "memory": frames}
        return {"frames": frames, **_token_specs(shape)}

    return Model(cfg, init, _nll_loss(forward, cfg.vocab_size), forward, init_cache,
                 decode_step, input_specs)
