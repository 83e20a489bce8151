"""Carry a reference model's state into the port as plain data.

The port never takes the reference's objects: these functions take what
the reference serializes (the dicts of ``Predictor.to_json()`` and
``PredictorBank.to_json()``) or a flattened ensemble's numpy arrays, and
rebuild the port's own objects from them.  Both packages then score the
same trees, which is what the parity tests rely on.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np

from repro_torch.core.composition import PredictorBank
from repro_torch.core.predictors.base import Predictor, load_predictor
from repro_torch.core.predictors.flat import FlatEnsemble


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
