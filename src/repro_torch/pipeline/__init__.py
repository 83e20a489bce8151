"""Latency-prediction pipeline on torch.

ProfileStore (persisted measurements) → PredictorHub (trained banks)
→ LatencyService (cached, batched end-to-end prediction on the card).
"""
from repro_torch.pipeline.hub import FAMILIES, PredictorHub
from repro_torch.pipeline.service import LatencyService, PredictionReport
from repro_torch.pipeline.store import ProfileStore, op_axis, setting_key

__all__ = [
    "FAMILIES", "LatencyService", "PredictionReport", "PredictorHub",
    "ProfileStore", "op_axis", "setting_key",
]
