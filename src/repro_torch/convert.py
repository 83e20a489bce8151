"""Carry a reference model's state into the port as plain data.

The port never takes the reference's objects: these functions take what
the reference serializes (the dicts of ``Predictor.to_json()`` and
``PredictorBank.to_json()``), a flattened ensemble's numpy arrays, an
MLP's ``[(w, b), …]`` or an LM's parameter tree as numpy arrays, and
rebuild the port's own objects from them.  Both packages then compute
with the same values, which is what the parity tests rely on.
"""
from __future__ import annotations

from typing import Any, Dict, List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.composition import PredictorBank
from repro_torch.core.predictors.base import Predictor, load_predictor
from repro_torch.core.predictors.flat import FlatEnsemble
from repro_torch.models.layers import Params
from repro_torch.models.transformer import decoder_stacks
from repro_torch.utils.device import DeviceLike, resolve_device


def predictor_from_reference(d: Dict[str, Any],
                             device: DeviceLike = "cuda") -> Predictor:
    """A fitted port predictor from a reference ``Predictor.to_json()``
    dict (a lasso or MLP predictor on ``device``)."""
    return load_predictor(d, device)


def bank_from_reference(d: Dict[str, Any],
                        device: DeviceLike = "cuda") -> PredictorBank:
    """A port bank from a reference ``PredictorBank.to_json()`` dict."""
    return PredictorBank.from_json(d, device)


def mlp_params_from_reference(params: Sequence[Tuple[Any, Any]],
                              device: DeviceLike = "cuda"
                              ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """The port MLP's parameters from the reference's ``[(w, b), …]``
    (numpy arrays, ``w`` of shape (din, dout)): float32 tensors on
    ``device``, in the same layout."""
    dev = resolve_device(device)
    return [(torch.tensor(np.asarray(w), dtype=torch.float32, device=dev),
             torch.tensor(np.asarray(b), dtype=torch.float32, device=dev))
            for w, b in params]


def flat_from_arrays(feature: np.ndarray, threshold: np.ndarray,
                     left: np.ndarray, right: np.ndarray, value: np.ndarray,
                     roots: np.ndarray, max_depth: int) -> FlatEnsemble:
    """A port `FlatEnsemble` from a reference ensemble's arrays (copied,
    in the reference's dtypes: int32 indices, float64 values)."""
    return FlatEnsemble(
        np.array(feature, dtype=np.int32), np.array(threshold, dtype=np.float64),
        np.array(left, dtype=np.int32), np.array(right, dtype=np.int32),
        np.array(value, dtype=np.float64), np.array(roots, dtype=np.int32),
        max_depth=int(max_depth))


def lm_params_from_reference(tree: Dict[str, Any], cfg,
                             device: DeviceLike = "cuda") -> Params:
    """The port's parameter modules from a reference LM parameter tree.

    ``tree`` is the reference's ``Model.init`` pytree as nested dicts of
    numpy arrays (``jax.tree_util.tree_map(np.asarray, params)``).  The
    reference stacks its layers on leading axes; the port holds one
    module per layer, so those axes are unstacked:
      * decoder (dense, moe) and ssm: ``layers`` on (num_layers,);
      * gemma2 (``alt_local_global``): ``local_layers`` and
        ``global_layers`` on (num_layers / 2,);
      * VLM (``cross_attn_every``): ``self_layers`` on (n_groups, n_self),
        unstacked group-major into n_groups·n_self modules, and
        ``cross_layers`` on (n_groups,);
      * encdec: ``enc_layers`` on (encoder_layers,), ``dec_layers`` on
        (num_layers,);
      * hybrid: ``mamba_groups`` on (n_groups, k), unstacked group-major
        into n_groups·k modules; ``tail_mamba`` on (rem,), present only
        when ``num_layers % shared_attn_every``; ``shared_attn`` is one
        unstacked layer.
    Each stack's leading shape is checked against ``cfg``.  Values are
    copied in their dtypes onto ``device``.
    """
    dev = resolve_device(device)
    if cfg.family == "hybrid":
        every = cfg.shared_attn_every
        n_groups, rem = divmod(cfg.num_layers, every)
        stacks = {"mamba_groups": (n_groups, every)}
        if rem:
            stacks["tail_mamba"] = (rem,)
        if "tail_mamba" in tree and not rem:
            raise ValueError(f"tree has tail_mamba, {cfg.name} has no tail group")
    elif cfg.family == "encdec":
        stacks = {"enc_layers": (cfg.encoder_layers,), "dec_layers": (cfg.num_layers,)}
    else:
        stacks = decoder_stacks(cfg)
    out = {k: _tensors(v, dev) for k, v in tree.items() if k not in stacks}
    for name, lead in stacks.items():
        if name not in tree:
            raise ValueError(f"tree has no {name!r} stack for {cfg.name}")
        found = {tuple(np.shape(a)[:len(lead)]) for a in _leaves(tree[name])}
        if found != {lead}:
            raise ValueError(f"tree stacks {name} as {sorted(found)}, {cfg.name} "
                             f"has {lead}")
        out[name] = [_tensors(tree[name], dev, i) for i in np.ndindex(*lead)]
    return Params(out)


def _leaves(t):
    if isinstance(t, dict):
        for v in t.values():
            yield from _leaves(v)
    else:
        yield t


def _tensors(t, dev, index=None):
    """Nested dicts of arrays → of tensors on ``dev`` (the entry at
    ``index`` of each array's leading axes, when given)."""
    if isinstance(t, dict):
        return {k: _tensors(v, dev, index) for k, v in t.items()}
    a = np.asarray(t)
    return torch.tensor(a if index is None else a[index], device=dev)


def _plain(tree: Any) -> Any:
    """NamedTuples (the reference's TrainState, AdamWState, …) as dicts."""
    if hasattr(tree, "_asdict"):
        tree = tree._asdict()
    if isinstance(tree, dict):
        return {k: _plain(v) for k, v in tree.items()}
    return tree


def unflatten_paths(flat: Dict[str, Any]) -> Dict[str, Any]:
    """{'a/b/c': x} (checkpoint keys) → nested dicts {'a': {'b': {'c': x}}}."""
    out: Dict[str, Any] = {}
    for key, value in flat.items():
        node = out
        *parents, leaf = key.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = value
    return out


def train_state_from_reference(state_tree: Any, cfg, device: DeviceLike = "cuda"):
    """The port's `TrainState` from a reference LM train state.

    ``state_tree`` is the reference's ``TrainState`` (arrays as numpy), the
    same as nested dicts, or the flat arrays of a checkpoint the
    reference's ``CheckpointManager`` wrote (``restore(target=None)``,
    keys such as ``'opt/mu/layers/attn/q/kernel'``).  The parameters go
    through `lm_params_from_reference` (layer stacks unstacked) and become
    trainable; AdamW's moments and the compression residual through the
    same unstacking, keyed by the port's parameter paths; both steps
    become 0-d int32 tensors."""
    from repro_torch.distributed.compression import CompressionState
    from repro_torch.distributed.trainstep import TrainState, trainable
    from repro_torch.optim.adamw import AdamWState
    from repro_torch.utils.tree import flatten_with_paths

    tree = _plain(state_tree)
    if any("/" in k for k in tree):
        tree = unflatten_paths(tree)
    dev = resolve_device(device)

    def moments(t: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        return dict(flatten_with_paths(lm_params_from_reference(t, cfg, dev)))

    def step(x) -> torch.Tensor:
        return torch.tensor(np.asarray(x), dtype=torch.int32, device=dev)

    params = trainable(lm_params_from_reference(tree["params"], cfg, dev))
    opt = tree["opt"]
    comp = tree.get("comp")
    return TrainState(
        params=params,
        opt=AdamWState(step(opt["step"]), moments(opt["mu"]), moments(opt["nu"])),
        comp=CompressionState(moments(comp["residual"])) if comp else None,
        step=step(tree["step"]))
