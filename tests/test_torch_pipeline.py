"""The ported slice as a whole: store → hub → LatencyService, held
against the reference pipeline on the same profile store.

The reference's `CostModelProfileSession` (hardware-free, deterministic
latencies) writes one JSONL store; both packages read that same file,
train with the same hyperparameters, and serve the same graphs.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro.core.dataset import synthetic_graphs as ref_graphs  # noqa: E402
from repro.core.profiler import DeviceSetting as RefSetting  # noqa: E402
from repro.pipeline import LatencyService as RefService  # noqa: E402
from repro.pipeline import PredictorHub as RefHub  # noqa: E402
from repro.pipeline import ProfileStore as RefStore  # noqa: E402
from repro.transfer.synthetic import CostModelProfileSession  # noqa: E402

from repro_torch.core.dataset import synthetic_graphs  # noqa: E402
from repro_torch.core.profiler import DeviceSetting  # noqa: E402
from repro_torch.pipeline import LatencyService, PredictorHub, ProfileStore  # noqa: E402

N_GRAPHS, N_TRAIN = 12, 9
# 30 stages instead of the default 150 keeps the two trainings quick; the
# code path is the same.
HPARAMS = {"gbdt": {"n_stages": 30}, "rf": {"n_trees": 6}}
SETTING = ("h100_f32", "float32", "fused_groups", "h100")


@pytest.fixture(scope="module")
def store_path(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("store") / "store.jsonl")
    store = RefStore(path)
    CostModelProfileSession(store=store).profile_suite(
        ref_graphs(N_GRAPHS, resolution=16), RefSetting(*SETTING))
    store.close()
    return path


@pytest.fixture(scope="module", params=["gbdt", "rf"])
def trained(request, store_path):
    family = request.param
    ref_store, store = RefStore(store_path), ProfileStore(store_path)
    rg, pg = ref_graphs(N_GRAPHS, resolution=16), synthetic_graphs(N_GRAPHS, resolution=16)
    ref_hub, hub = RefHub(), PredictorHub()
    ref_bank = ref_hub.train(ref_store, RefSetting(*SETTING), family,
                             hparams=HPARAMS[family],
                             fingerprints=[g.fingerprint() for g in rg[:N_TRAIN]])
    bank = hub.train(store, DeviceSetting(*SETTING), family,
                     hparams=HPARAMS[family],
                     fingerprints=[g.fingerprint() for g in pg[:N_TRAIN]])
    return family, ref_hub, hub, ref_bank, bank, rg, pg


def test_port_store_reads_the_reference_file(store_path):
    ref_store, store = RefStore(store_path), ProfileStore(store_path)
    assert store.stats()["op_records"] == ref_store.stats()["op_records"]
    assert store.stats()["arch_records"] == ref_store.stats()["arch_records"] == N_GRAPHS
    s, rs = DeviceSetting(*SETTING), RefSetting(*SETTING)
    for g, rg in zip(synthetic_graphs(N_GRAPHS, resolution=16),
                     ref_graphs(N_GRAPHS, resolution=16)):
        assert g.fingerprint() == rg.fingerprint()
        assert store.get_arch(s, g.fingerprint()).to_json() == \
            ref_store.get_arch(rs, rg.fingerprint()).to_json()


def test_trained_bank_json_equals_reference(trained):
    _, _, _, ref_bank, bank, _, _ = trained
    assert bank.to_json() == ref_bank.to_json()


def test_numpy_reports_equal_reference_field_for_field(trained):
    family, ref_hub, hub, _, _, rg, pg = trained
    ref = RefService(ref_hub, default_setting=RefSetting(*SETTING),
                     predictor=family, inference_backend="numpy")
    svc = LatencyService(hub, default_setting=DeviceSetting(*SETTING),
                         predictor=family, inference_backend="numpy",
                         device="cpu")
    want = ref.predict_batch(rg)
    got = svc.predict_batch(pg)
    assert [r.to_json() for r in got] == [r.to_json() for r in want]
    assert svc.stats()["backend_runs"] == ref.stats()["backend_runs"]


def test_torch_tier_matches_reference_jax_tier(trained):
    # rtol=1e-5 on e2e: both device tiers score identical float32 leaves;
    # only the float32 reduction order over trees differs per op.
    family, ref_hub, hub, _, _, rg, pg = trained
    ref = RefService(ref_hub, default_setting=RefSetting(*SETTING),
                     predictor=family, inference_backend="jax")
    svc = LatencyService(hub, default_setting=DeviceSetting(*SETTING),
                         predictor=family, inference_backend="torch",
                         device="cpu")
    want = ref.predict_batch(rg)
    got = svc.predict_batch(pg)
    np.testing.assert_allclose([r.e2e_s for r in got], [r.e2e_s for r in want],
                               rtol=1e-5)
    for a, b in zip(got, want):
        assert (a.num_ops, a.num_kernels, a.fingerprint) == \
            (b.num_ops, b.num_kernels, b.fingerprint)
        assert [t for t, _ in a.per_op] == [t for t, _ in b.per_op]
    ref_stats, stats = ref.stats(), svc.stats()
    assert stats["backend_runs"] == {"torch": ref_stats["backend_runs"]["jax"]}
    assert stats["device_fused_runs"] == ref_stats["device_fused_runs"] > 0


def test_auto_on_the_host_serves_the_torch_tier(trained):
    family, _, hub, _, bank, _, pg = trained
    svc = LatencyService(hub, default_setting=DeviceSetting(*SETTING),
                         predictor=family, device="cpu")
    assert svc.inference_backend == "auto"
    svc.predict_batch(pg)
    stats = svc.stats()
    assert set(stats["backend_runs"]) == {"torch"}
    res = stats["device_residency"]
    assert res["banks"] == res["bank_uploads"] == len(bank.predictors)
    assert res["sharded_banks"] == 0 and res["bytes"] > 0
    svc.predict_batch(synthetic_graphs(4, resolution=16, seed0=500))
    assert svc.stats()["device_residency"]["bank_uploads"] == len(bank.predictors)


def _drive(svc, graphs, setting):
    svc.predict_batch(graphs[:3])
    peek, miss = svc.cache_peek(graphs[0]), svc.cache_peek(graphs[5])
    hit = svc.predict_e2e(graphs[1])
    multi = svc.predict_multi(graphs[:2], [setting])
    return peek, miss, hit, multi


def test_service_cache_and_stats_keys(trained):
    family, ref_hub, hub, _, _, rg, pg = trained
    ref = RefService(ref_hub, default_setting=RefSetting(*SETTING),
                     predictor=family, inference_backend="numpy")
    svc = LatencyService(hub, default_setting=DeviceSetting(*SETTING),
                         predictor=family, inference_backend="numpy",
                         device="cpu")
    r_peek, r_miss, r_hit, r_multi = _drive(ref, rg, RefSetting(*SETTING))
    peek, miss, hit, multi = _drive(svc, pg, DeviceSetting(*SETTING))
    assert peek.from_cache and r_peek.from_cache and miss is r_miss is None
    assert hit.from_cache and hit.to_json() == r_hit.to_json()
    assert list(multi) == list(r_multi) == ["h100:float32/fused_groups"]
    assert svc.cache_info() == ref.cache_info()
    assert set(svc.stats()) == set(ref.stats())
    assert set(svc.stats()["device_residency"]) == \
        set(ref.stats()["device_residency"])
    svc.clear_cache()
    assert svc.cache_info()["size"] == 0


def test_retrain_invalidates_the_report_cache(store_path):
    hub = PredictorHub()
    setting = DeviceSetting(*SETTING)
    store = ProfileStore(store_path)
    hub.train(store, setting, "gbdt", hparams={"n_stages": 5})
    svc = LatencyService(hub, default_setting=setting, device="cpu")
    g = synthetic_graphs(1, resolution=16)[0]
    first = svc.predict_e2e(g)
    hub.train(store, setting, "gbdt", hparams={"n_stages": 8})
    again = svc.predict_e2e(g)
    assert not again.from_cache and again.bank_epoch > first.bank_epoch


def test_build_profiles_trains_and_serves_on_the_host(tmp_path):
    setting = DeviceSetting("cpu_f32", "float32", "op_by_op")
    graphs = synthetic_graphs(6, resolution=16, seed0=40)
    svc = LatencyService.build(
        graphs, setting, store=str(tmp_path / "s.jsonl"),
        hparams={"n_stages": 5}, train_graphs=graphs[:5], device="cpu")
    assert svc.session.device.type == "cpu" and svc.device.type == "cpu"
    assert svc.session.measured_graphs == 6
    reports = svc.predict_batch(graphs)
    assert all(np.isfinite(r.e2e_s) for r in reports)
    assert svc.stats()["backend_runs"] == {"torch": svc.stats()["device_fused_runs"]}


def test_calibrated_bank_from_the_reference_serves_identically(trained):
    """A transfer-calibrated bank the reference saved loads in the port's
    hub and serves the target setting as the reference does (numpy tier)."""
    from repro.core.composition import PredictorBank as RefBank
    from repro.transfer import CalibratedPredictor, scale_map
    from repro_torch.core.composition import PredictorBank

    family, _, _, ref_bank, _, rg, pg = trained
    ref_hub, hub = RefHub(), PredictorHub(device="cpu")
    target = ("h100_sim", "float32", "fused_groups", "sim")
    cal = RefBank(setting="sim:float32/fused_groups", overhead=2e-5,
                  op_sum_scale=1.1, overhead_per_kernel=1e-6)
    for t, m in ref_bank.predictors.items():
        cal.predictors[t] = CalibratedPredictor.wrap(m, scale_map(2.5))
    ref_hub.register(RefSetting(*target), family, cal)
    hub.register(DeviceSetting(*target), family,
                 PredictorBank.from_json(cal.to_json(), device="cpu"))
    ref = RefService(ref_hub, predictor=family, inference_backend="numpy")
    svc = LatencyService(hub, predictor=family, inference_backend="numpy",
                         device="cpu")
    want = ref.predict_batch(rg, RefSetting(*target))
    got = svc.predict_batch(pg, DeviceSetting(*target))
    assert [r.to_json() for r in got] == [r.to_json() for r in want]
    assert svc.stats()["backend_runs"] == ref.stats()["backend_runs"] == \
        {"numpy": len(cal.predictors)}


def test_cuda_tier_on_a_host_service_needs_the_card(trained, monkeypatch):
    family, _, hub, _, _, _, pg = trained
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    svc = LatencyService(hub, default_setting=DeviceSetting(*SETTING),
                         predictor=family, inference_backend="cuda",
                         device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        svc.predict_batch(pg[:2])
    assert svc.stats()["backend_runs"] == {}
