"""Carry a reference model's state into the port as plain data.

The port never takes the reference's objects: these functions take what
the reference serializes (the dicts of ``Predictor.to_json()`` and
``PredictorBank.to_json()``), a flattened ensemble's numpy arrays, or an
LM's parameter tree as numpy arrays, and rebuild the port's own objects
from them.  Both packages then compute with the same values, which is
what the parity tests rely on.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.core.composition import PredictorBank
from repro_torch.core.predictors.base import Predictor, load_predictor
from repro_torch.core.predictors.flat import FlatEnsemble
from repro_torch.models.layers import Params
from repro_torch.models.transformer import check_plain_stack
from repro_torch.utils.device import DeviceLike, resolve_device


def predictor_from_reference(d: Dict[str, Any]) -> Predictor:
    """A fitted port predictor from a reference ``Predictor.to_json()`` dict."""
    return load_predictor(d)


def bank_from_reference(d: Dict[str, Any]) -> PredictorBank:
    """A port bank from a reference ``PredictorBank.to_json()`` dict."""
    return PredictorBank.from_json(d)


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
    plain decoder stack keeps its layers stacked on a leading axis in
    ``tree["layers"]``; the port holds one module per layer, so that axis
    is unstacked.  Values are copied in their dtypes onto ``device``.
    """
    check_plain_stack(cfg)
    dev = resolve_device(device)
    lead = {np.shape(a)[0] for a in _leaves(tree["layers"])}
    if lead != {cfg.num_layers}:
        raise ValueError(f"tree stacks {sorted(lead)} layers, {cfg.name} has "
                         f"{cfg.num_layers}")
    out = {k: _tensors(v, dev) for k, v in tree.items() if k != "layers"}
    out["layers"] = [_tensors(tree["layers"], dev, i)
                     for i in range(cfg.num_layers)]
    return Params(out)


def _leaves(t):
    if isinstance(t, dict):
        for v in t.values():
            yield from _leaves(v)
    else:
        yield t


def _tensors(t, dev, index=None):
    """Nested dicts of arrays → of tensors on ``dev`` (row ``index`` of each
    array, when given)."""
    if isinstance(t, dict):
        return {k: _tensors(v, dev, index) for k, v in t.items()}
    a = np.asarray(t)
    return torch.tensor(a if index is None else a[index], device=dev)
