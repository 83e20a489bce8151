"""Per-operation latency predictors ported so far: RF and GBDT.

Lasso, MLP and the transfer layer's calibrated wrapper come in later
slices; `load_predictor` raises NotImplementedError for them.
"""
from repro_torch.core.predictors.base import (
    PREDICTORS,
    Predictor,
    Standardizer,
    cross_val_mape,
    grid_search,
    load_predictor,
    relative_weights,
)
from repro_torch.core.predictors.flat import FlatEnsemble
from repro_torch.core.predictors.gbdt import GBDTPredictor, fit_gbdt_with_cv
from repro_torch.core.predictors.random_forest import RandomForestPredictor, fit_rf_with_cv

__all__ = [
    "PREDICTORS", "Predictor", "Standardizer", "cross_val_mape", "grid_search",
    "load_predictor", "relative_weights", "FlatEnsemble",
    "RandomForestPredictor", "GBDTPredictor", "fit_rf_with_cv",
    "fit_gbdt_with_cv",
]


def make_predictor(name: str, **kwargs) -> Predictor:
    return PREDICTORS.get(name)(**kwargs)
