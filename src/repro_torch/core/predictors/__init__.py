"""Per-operation latency predictors (paper §4.2): Lasso, RF, GBDT, MLP.

Lasso fits and the MLP trains and predicts on a torch device (the card
unless ``device="cpu"``); the tree families predict on the tier the
serving layer picks.  The transfer layer's calibrated wrapper registers
itself from `repro_torch.transfer.calibration`, which `load_predictor`
imports on first use.
"""
from repro_torch.core.predictors.base import (
    PREDICTORS,
    Predictor,
    Standardizer,
    build_predictor,
    cross_val_mape,
    grid_search,
    load_predictor,
    relative_weights,
)
from repro_torch.core.predictors.flat import FlatEnsemble
from repro_torch.core.predictors.gbdt import GBDTPredictor, fit_gbdt_with_cv
from repro_torch.core.predictors.lasso import LassoPredictor
from repro_torch.core.predictors.mlp import MLPPredictor
from repro_torch.core.predictors.random_forest import RandomForestPredictor, fit_rf_with_cv

__all__ = [
    "PREDICTORS", "Predictor", "Standardizer",
    "build_predictor", "cross_val_mape", "grid_search", "load_predictor",
    "relative_weights", "FlatEnsemble", "LassoPredictor",
    "RandomForestPredictor", "GBDTPredictor", "MLPPredictor",
    "fit_rf_with_cv", "fit_gbdt_with_cv",
]


def make_predictor(name: str, **kwargs) -> Predictor:
    return PREDICTORS.get(name)(**kwargs)
