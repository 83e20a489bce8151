"""Cross-device transfer: budgeted profiling + bank calibration.

Turns one fully-profiled *source* device (its ProfileStore + trained
PredictorHub banks) into serving-ready predictors for a *target* device
using a tiny measurement budget K (see docs/PIPELINE.md § Cross-device
transfer):

    descriptors — fixed-length device identity vectors (priors/distance)
    sampler     — budgeted, deterministic selection of ops to re-profile
    calibration — per-op-type source→target latency maps (+ the
                  "calibrated" predictor family)
    engine      — TransferEngine.adapt: K measurements → a registered
                  target PredictorBank
    synthetic   — deterministic synthetic device pairs for tests/benches
"""
from repro_torch.transfer.calibration import (CalibratedPredictor, LatencyMap,
                                        fit_latency_map, identity_map,
                                        scale_map)
from repro_torch.transfer.descriptors import (DESCRIPTOR_FIELDS, DeviceDescriptor,
                                        describe, descriptor_distance,
                                        prior_scale)
from repro_torch.transfer.engine import TransferEngine, TransferResult
from repro_torch.transfer.sampler import SamplePlan, plan_samples
from repro_torch.transfer.synthetic import (CostModelProfileSession,
                                      ReplayProfileSession, SyntheticDevice)

__all__ = [
    "CalibratedPredictor", "CostModelProfileSession", "DESCRIPTOR_FIELDS",
    "DeviceDescriptor", "LatencyMap", "ReplayProfileSession", "SamplePlan",
    "SyntheticDevice", "TransferEngine", "TransferResult", "describe",
    "descriptor_distance", "fit_latency_map", "identity_map", "plan_samples",
    "prior_scale", "scale_map",
]
