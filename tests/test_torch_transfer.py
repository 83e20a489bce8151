"""The port's transfer layer (repro_torch.transfer) held against the reference's.

One deterministic source device: the reference's `CostModelProfileSession`
profiles 12 NAS graphs into a JSONL store, and the reference trains a GBDT
source bank on 9 of them.  The port reads the same file and loads the same
bank from its JSON (``device="cpu"``).  Every target device is replayed
(`ReplayProfileSession`, a seeded `SyntheticDevice`) or cost-modelled, so
nothing here reads the wall clock and every number is the same in both
packages:

* latency maps (affine, ratio, shrunk slope, isotonic) fit bit for bit and
  round-trip through JSON text bit-exactly;
* the calibrated wrapper predicts and serializes as the reference's, also
  inside a bank through `PredictorBank.from_json` and `PredictorHub.load`;
* the sampler picks the same signatures;
* `TransferEngine.adapt` at K = 8, 24 and 64 gives the same result and bank
  JSON, and the target's `predict_e2e` is identical on the numpy tier and
  within `TestBackendParity`'s near-tie argument on the host torch tier;
* the reference's acceptance bar (K = 64 no worse than K = 8, within 2× of
  the fully profiled oracle), determinism, errors, the probe-graph path and
  the multi-device search scorer run on the port.
"""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro import search as ref_search  # noqa: E402
from repro.core.composition import PredictorBank as RefBank  # noqa: E402
from repro.core.dataset import synthetic_graphs as ref_graphs  # noqa: E402
from repro.core.predictors import make_predictor as ref_make  # noqa: E402
from repro.core.profiler import DeviceSetting as RefSetting  # noqa: E402
from repro.core.selection import get_device as ref_get_device  # noqa: E402
from repro.pipeline import LatencyService as RefService  # noqa: E402
from repro.pipeline import PredictorHub as RefHub  # noqa: E402
from repro.pipeline import ProfileStore as RefStore  # noqa: E402
from repro import transfer as ref_transfer  # noqa: E402

from repro_torch import search, transfer  # noqa: E402
from repro_torch.core.composition import PredictorBank, mape  # noqa: E402
from repro_torch.core.dataset import synthetic_graphs  # noqa: E402
from repro_torch.core.features import graph_features  # noqa: E402
from repro_torch.core.nas_space import NASSpaceConfig, sample_architecture  # noqa: E402
from repro_torch.core.predictors import load_predictor  # noqa: E402
from repro_torch.core.profiler import DeviceSetting  # noqa: E402
from repro_torch.core.selection import get_device  # noqa: E402
from repro_torch.pipeline import LatencyService, PredictorHub, ProfileStore  # noqa: E402

# One intra-op thread per xdist worker's share of the cores: these tests
# run beside the reference's wall-clock profiling tests.
torch.set_num_threads(max(1, (os.cpu_count() or 1)
                          // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

SRC = ("cpu_f32", "float32", "op_by_op")
TGT = ("sim_f32", "float32", "op_by_op", "simdev")
DEVICE_KW = dict(seed=7, noise=0.1, curvature=0.15)
N_GRAPHS, N_TRAIN = 12, 9
CPU = "cpu"
# `tests/test_predictors.py::TestBackendParity`: a float32 tier agrees
# with numpy within this, or the row lies within 8 float32 eps of a split.
TIER_RTOL, TIE_REL = 2e-4, 8 * np.finfo(np.float32).eps


@pytest.fixture(scope="module")
def source(tmp_path_factory):
    """(port store, ref store, port bank, ref bank, port graphs, ref graphs)."""
    path = str(tmp_path_factory.mktemp("transfer") / "source.jsonl")
    rg = ref_graphs(N_GRAPHS, resolution=16)
    ref_store = RefStore(path)
    sess = ref_transfer.CostModelProfileSession(store=ref_store, seed=1)
    for g in rg:
        sess.profile_graph(g, RefSetting(*SRC))
    ref_store.flush()
    ref_bank = RefHub().train(ref_store, RefSetting(*SRC), "gbdt",
                              hparams={"n_stages": 50}, min_samples=3,
                              fingerprints=[g.fingerprint() for g in rg[:N_TRAIN]])
    store = ProfileStore(path)
    bank = PredictorBank.from_json(json.loads(json.dumps(ref_bank.to_json())),
                                   device=CPU)
    return store, ref_store, bank, ref_bank, synthetic_graphs(N_GRAPHS, resolution=16), rg


def _hubs(source):
    store, ref_store, bank, ref_bank, _, _ = source
    hub, ref_hub = PredictorHub(device=CPU), RefHub()
    hub.register(DeviceSetting(*SRC), "gbdt", bank)
    ref_hub.register(RefSetting(*SRC), "gbdt", ref_bank)
    return hub, ref_hub


def _sessions(source, **device_kw):
    store, ref_store = source[0], source[1]
    kw = {**DEVICE_KW, **device_kw}
    return (transfer.ReplayProfileSession(
                store, transfer.SyntheticDevice("simdev", **kw), DeviceSetting(*SRC)),
            ref_transfer.ReplayProfileSession(
                ref_store, ref_transfer.SyntheticDevice("simdev", **kw),
                RefSetting(*SRC)))


def _adapt_both(source, budget, **engine_kw):
    store, ref_store = source[0], source[1]
    hub, ref_hub = _hubs(source)
    sess, ref_sess = _sessions(source)
    res = transfer.TransferEngine(DeviceSetting(*SRC), DeviceSetting(*TGT),
                                  family="gbdt", seed=0, **engine_kw).adapt(
        store, hub, sess, budget)
    ref_res = ref_transfer.TransferEngine(RefSetting(*SRC), RefSetting(*TGT),
                                          family="gbdt", seed=0, **engine_kw).adapt(
        ref_store, ref_hub, ref_sess, budget)
    return (res, hub, sess), (ref_res, ref_hub, ref_sess)


# -- device identity --------------------------------------------------------------

@pytest.mark.parametrize("pair", [("cpu_xla", "tpu_v5e"), ("mali_g76", "adreno640"),
                                  ("powervr_ge8320", "cpu_xla")])
def test_descriptors_equal_reference(pair):
    a, b = (transfer.describe(get_device(n), DeviceSetting(*SRC)) for n in pair)
    ra, rb = (ref_transfer.describe(ref_get_device(n), RefSetting(*SRC)) for n in pair)
    assert a.to_json() == ra.to_json() and b.to_json() == rb.to_json()
    assert transfer.descriptor_distance(a, b) == ref_transfer.descriptor_distance(ra, rb)
    assert transfer.prior_scale(a, b) == ref_transfer.prior_scale(ra, rb)
    assert transfer.DESCRIPTOR_FIELDS == ref_transfer.DESCRIPTOR_FIELDS


# -- latency maps -------------------------------------------------------------------

def _pairs(case):
    src = np.geomspace(1e-5, 1e-2, 10)
    return {"affine": (src, np.exp(0.31) * src ** 0.93, {"slope_shrink": 0.0}),
            "shrunk": (np.array([1e-5, 1e-3]), np.array([1e-5, 1e-3]) ** 1.5, {}),
            "ratio": (np.array([1e-4]), np.array([3e-4]), {}),
            "flat": (np.full(4, 2e-4), np.array([1e-4, 3e-4, 2e-4, 5e-4]), {}),
            "isotonic": (np.array([1e-5, 1e-4, 1e-4, 1e-3, 1e-2]),
                         np.array([4e-4, 3e-4, 3.5e-4, 2e-4, 1e-4]), {})}[case]


@pytest.mark.parametrize("case", ["affine", "shrunk", "ratio", "flat", "isotonic"])
def test_latency_map_fits_equal_reference_and_round_trip(case):
    src, tgt, kw = _pairs(case)
    m = transfer.fit_latency_map(src, tgt, **kw)
    ref = ref_transfer.fit_latency_map(src, tgt, **kw)
    assert m.to_json() == ref.to_json()
    assert m.kind == {"isotonic": "isotonic_log"}.get(case, "affine_log")
    grid = np.geomspace(1e-7, 1.0, 97)
    assert np.array_equal(m.apply(grid), ref.apply(grid))
    back = transfer.LatencyMap.from_json(json.loads(json.dumps(m.to_json())))
    assert back == m and np.array_equal(back.apply(grid), m.apply(grid))
    assert transfer.LatencyMap.from_json(ref.to_json()) == m


def test_scale_and_identity_maps_equal_reference():
    assert transfer.scale_map(2.7182818, n_fit=3).to_json() == \
        ref_transfer.scale_map(2.7182818, n_fit=3).to_json()
    assert transfer.identity_map().to_json() == ref_transfer.identity_map().to_json()
    with pytest.raises(ValueError):
        transfer.fit_latency_map([], [])


# -- the calibrated predictor --------------------------------------------------------

def _ref_calibrated():
    rng = np.random.default_rng(0)
    x = np.abs(rng.standard_normal((60, 5))) * np.array([1e9, 1e6, 64, 64, 3])
    y = np.maximum(x[:, 0] / 50e9, x[:, 1] / 10e9) + 5e-6
    base = ref_make("gbdt", n_stages=20).fit(x, y)
    m = ref_transfer.fit_latency_map(y, np.exp(0.4) * y ** 1.05)
    return ref_transfer.CalibratedPredictor.wrap(base, m), x


def test_calibrated_predictor_equals_reference():
    ref, x = _ref_calibrated()
    base = load_predictor(ref.base.to_json(), device=CPU)
    cal = transfer.CalibratedPredictor.wrap(
        base, transfer.LatencyMap.from_json(ref.map.to_json()))
    assert cal.to_json() == ref.to_json()
    np.testing.assert_array_equal(cal.predict(x), ref.predict(x))
    np.testing.assert_array_equal(cal.predict_oracle(x), ref.predict_oracle(x))
    assert cal.tree_model() is base and cal.scaler is base.scaler
    with pytest.raises(TypeError):
        transfer.CalibratedPredictor.wrap(cal, transfer.identity_map())
    with pytest.raises(RuntimeError):
        cal.fit(x, x[:, 0])


def test_calibrated_bank_round_trips_through_json_and_hub(tmp_path):
    ref, x = _ref_calibrated()
    ref_bank = RefBank(setting="simdev:float32/op_by_op", overhead=1e-4,
                       op_sum_scale=1.2)
    ref_bank.predictors["conv2d"] = ref
    text = json.dumps(ref_bank.to_json())
    bank = PredictorBank.from_json(json.loads(text), device=CPU)
    assert json.dumps(bank.to_json()) == text
    np.testing.assert_array_equal(bank.predictors["conv2d"].predict(x), ref.predict(x))
    hub = PredictorHub(str(tmp_path / "hub"), device=CPU)
    hub.register(DeviceSetting(*TGT), "gbdt", bank, save=True)
    again = PredictorHub.load(str(tmp_path / "hub"), device=CPU)
    loaded = again.get(DeviceSetting(*TGT), "gbdt")
    assert loaded.predictors["conv2d"].name == "calibrated"
    np.testing.assert_array_equal(loaded.predictors["conv2d"].predict(x), ref.predict(x))
    # The reference's hub reads the port's file.
    ref_again = RefHub.load(str(tmp_path / "hub"))
    assert ref_again.get(RefSetting(*TGT), "gbdt").to_json() == loaded.to_json()


# -- the sampler --------------------------------------------------------------------

@pytest.mark.parametrize("budget", [1, 7, 24, 30, 10 ** 6])
@pytest.mark.parametrize("seed", [0, 3])
def test_plan_samples_equal_reference(source, budget, seed):
    store, ref_store, bank, ref_bank, _, _ = source
    for b, rb in ((bank, ref_bank), (None, None)):
        plan = transfer.plan_samples(store, DeviceSetting(*SRC), budget, bank=b,
                                     seed=seed)
        ref = ref_transfer.plan_samples(ref_store, RefSetting(*SRC), budget, bank=rb,
                                        seed=seed)
        assert plan.signatures == ref.signatures and plan.to_json() == ref.to_json()
        assert len(plan.records) <= budget
    allowed = set(store.op_types(DeviceSetting(*SRC))[:2])
    assert transfer.plan_samples(store, DeviceSetting(*SRC), budget, op_types=allowed,
                                 seed=seed).to_json() == \
        ref_transfer.plan_samples(ref_store, RefSetting(*SRC), budget,
                                  op_types=allowed, seed=seed).to_json()


# -- the engine ---------------------------------------------------------------------

@pytest.mark.parametrize("budget", [8, 24, 64])
def test_adapt_equals_reference(source, budget):
    (res, hub, sess), (ref_res, ref_hub, ref_sess) = _adapt_both(source, budget)
    assert res.to_json() == ref_res.to_json()
    assert json.dumps(res.bank.to_json()) == json.dumps(ref_res.bank.to_json())
    assert res.n_measurements <= budget
    assert (sess.measured_ops, sess.measured_graphs) == \
        (ref_sess.measured_ops, ref_sess.measured_graphs)
    assert sess.measured_ops + sess.measured_graphs <= budget
    assert res.composition.startswith("probes:")
    assert hub.get(DeviceSetting(*TGT), "gbdt") is res.bank
    assert hub.epochs() == ref_hub.epochs()


@pytest.mark.parametrize("budget", [8, 24, 64])
def test_target_predictions_equal_reference_on_numpy(source, budget):
    (_, hub, _), (_, ref_hub, _) = _adapt_both(source, budget)
    pg, rg = source[4], source[5]
    svc = LatencyService(hub, predictor="gbdt", inference_backend="numpy", device=CPU)
    ref = RefService(ref_hub, predictor="gbdt", inference_backend="numpy")
    got = [svc.predict_e2e(g, DeviceSetting(*TGT)) for g in pg]
    want = [ref.predict_e2e(g, RefSetting(*TGT)) for g in rg]
    assert [r.to_json() for r in got] == [r.to_json() for r in want]
    assert got[0].setting == "simdev:float32/op_by_op"
    assert svc.stats()["backend_runs"] == ref.stats()["backend_runs"]


def _max_log_slope(latency_map) -> float:
    if latency_map.kind == "affine_log":
        return abs(latency_map.b)
    dx, dy = np.diff(latency_map.knots_x), np.diff(latency_map.knots_y)
    return float(np.max(np.abs(dy) / dx)) if len(dx) else 0.0


def _near_tie(flat, xs) -> bool:
    internal = flat.feature >= 0
    gap = np.abs(xs[flat.feature[internal]] - flat.threshold[internal])
    return bool((gap <= TIE_REL * np.maximum(1.0, np.abs(flat.threshold[internal]))).any())


def test_target_torch_tier_agrees_with_numpy_or_near_tie(source):
    """The host torch tier scores the calibrated bank's bases in float32:
    every op's prediction agrees with the numpy tier within
    ``TIER_RTOL`` × the map's largest log-slope (a relative error of the
    base scales by the slope through t = e^a s^b), or its row lies within
    ``TIE_REL`` of a split of the base's trees."""
    (res, hub, _), _ = _adapt_both(source, 24)
    pg = source[4]
    tgt = DeviceSetting(*TGT)
    np_svc = LatencyService(hub, predictor="gbdt", inference_backend="numpy", device=CPU)
    t_svc = LatencyService(hub, predictor="gbdt", inference_backend="torch", device=CPU)
    n_rows = 0
    for g in pg:
        a, b = t_svc.predict_e2e(g, tgt), np_svc.predict_e2e(g, tgt)
        gf = graph_features(g)
        ties = set()
        for op_type, idx in gf.index.items():
            model = res.bank.predictors.get(op_type)
            if model is None:
                continue
            xs = model.base.scaler.transform(gf.matrix[op_type])
            rtol = TIER_RTOL * max(1.0, _max_log_slope(model.map))
            for row, k in enumerate(idx):
                n_rows += 1
                if not np.isclose(a.per_op[k][1], b.per_op[k][1], rtol=rtol, atol=0):
                    assert _near_tie(model.base.flat(), xs[row]), (g.name, op_type, k)
                    ties.add(k)
        if not ties:
            slope = max(_max_log_slope(m.map) for m in res.bank.predictors.values())
            assert a.e2e_s == pytest.approx(b.e2e_s, rel=TIER_RTOL * max(1.0, slope))
    assert n_rows > 0
    runs = t_svc.stats()["backend_runs"]
    assert set(runs) == {"torch"} and t_svc.stats()["device_fused_runs"] == 0


def _oracle(source):
    """Fully profiled target through the port: (truth by name, oracle MAPE)."""
    store, pg = source[0], source[4]
    osess = transfer.ReplayProfileSession(
        store, transfer.SyntheticDevice("simdev", **DEVICE_KW), DeviceSetting(*SRC),
        store=ProfileStore())
    truth = {g.name: osess.profile_graph(g, DeviceSetting(*TGT)).e2e_s for g in pg}
    hub = PredictorHub(device=CPU)
    hub.train(osess.store, DeviceSetting(*TGT), "gbdt", hparams={"n_stages": 50},
              min_samples=3, fingerprints=[g.fingerprint() for g in pg[:N_TRAIN]])
    svc = LatencyService(hub, predictor="gbdt", device=CPU)
    test = pg[N_TRAIN:]
    return truth, mape([truth[g.name] for g in test],
                       [svc.predict_e2e(g, DeviceSetting(*TGT)).e2e_s for g in test])


def _transfer_mape(source, truth, budget):
    (res, hub, _), _ = _adapt_both(source, budget)
    svc = LatencyService(hub, predictor="gbdt", device=CPU)
    test = source[4][N_TRAIN:]
    return res, mape([truth[g.name] for g in test],
                     [svc.predict_e2e(g, DeviceSetting(*TGT)).e2e_s for g in test])


def test_budget_curve_and_oracle_gap(source):
    truth, o_mape = _oracle(source)
    _, m8 = _transfer_mape(source, truth, 8)
    r64, m64 = _transfer_mape(source, truth, 64)
    assert m64 <= m8
    assert m64 <= 2.0 * o_mape
    assert r64.n_measurements <= 64


def test_adapt_is_deterministic(source):
    outs = []
    for _ in range(2):
        (res, hub, _), _ = _adapt_both(source, 24)
        svc = LatencyService(hub, predictor="gbdt", inference_backend="numpy",
                             device=CPU)
        outs.append((json.dumps(res.to_json()),
                     [svc.predict_e2e(g, DeviceSetting(*TGT)).e2e_s for g in source[4]]))
    assert outs[0] == outs[1]


def test_focus_plan_equals_reference(source):
    store, ref_store, bank, ref_bank, _, _ = source
    focus = store.op_types(DeviceSetting(*SRC))[:2]
    (res, _, _), (ref_res, _, _) = _adapt_both(source, 24, focus_op_types=focus)
    assert res.to_json() == ref_res.to_json()
    assert res.focus_op_types == sorted(focus)


def test_same_key_and_missing_bank_raise(source):
    store = source[0]
    with pytest.raises(ValueError, match="same key"):
        transfer.TransferEngine(DeviceSetting(*SRC),
                                DeviceSetting("other", "float32", "op_by_op"))
    sess, _ = _sessions(source)
    with pytest.raises(ValueError, match="no trained source bank"):
        transfer.TransferEngine(DeviceSetting(*SRC), DeviceSetting(*TGT),
                                family="mlp").adapt(store, PredictorHub(device=CPU),
                                                    sess, 8)
    hub, _ = _hubs(source)
    with pytest.raises(ValueError, match="budget_k"):
        transfer.TransferEngine(DeviceSetting(*SRC), DeviceSetting(*TGT)).adapt(
            store, hub, sess, 0)
    # A session with no measure_record needs probe graphs.
    with pytest.raises(ValueError, match="probe_graphs"):
        transfer.TransferEngine(DeviceSetting(*SRC), DeviceSetting(*TGT)).adapt(
            store, hub, transfer.CostModelProfileSession(), 8)


def test_synthetic_sessions_run_nowhere_and_keep_the_device_name(source):
    sess, _ = _sessions(source)
    assert isinstance(sess.device, transfer.SyntheticDevice)
    cm = transfer.CostModelProfileSession()
    assert cm.device == torch.device(CPU) and cm.measured_ops == 0


def test_probe_graph_path_equals_reference(source):
    """A target with `measure_op` and no `measure_record`: sampled
    signatures are located in the probe graphs and measured there; the
    composition is ratio-scaled from the source's constants."""
    store, ref_store = source[0], source[1]
    pg, rg = source[4], source[5]
    hub, ref_hub = _hubs(source)
    tgt = ("cm2x", "float32", "op_by_op", "cm2x")
    sess = transfer.CostModelProfileSession(seed=9, flops_per_s=25e9,
                                            bytes_per_s=4e9)
    ref_sess = ref_transfer.CostModelProfileSession(seed=9, flops_per_s=25e9,
                                                    bytes_per_s=4e9)
    res = transfer.TransferEngine(DeviceSetting(*SRC), DeviceSetting(*tgt),
                                  family="gbdt", seed=0,
                                  probe_graphs=pg[:N_TRAIN]).adapt(store, hub, sess, 16)
    ref_res = ref_transfer.TransferEngine(RefSetting(*SRC), RefSetting(*tgt),
                                          family="gbdt", seed=0,
                                          probe_graphs=rg[:N_TRAIN]).adapt(
        ref_store, ref_hub, ref_sess, 16)
    assert res.composition == "ratio-scaled" == ref_res.composition
    assert res.n_e2e_measurements == 0 and 0 < res.n_op_measurements <= 16
    assert sess.measured_ops == ref_sess.measured_ops == res.n_op_measurements
    assert res.to_json() == ref_res.to_json()
    assert json.dumps(res.bank.to_json()) == json.dumps(ref_res.bank.to_json())
    svc = LatencyService(hub, predictor="gbdt", inference_backend="numpy", device=CPU)
    reports = [svc.predict_e2e(g, DeviceSetting(*tgt)) for g in pg[N_TRAIN:]]
    assert all(r.e2e_s > 0 for r in reports)


# -- the multi-device search scorer (reference: tests/test_search.py TestMultiDevice) --

SPACE_KW = {"resolution": 16}


@pytest.fixture(scope="module")
def two_device(source):
    """Both packages' services holding the source bank and a target bank
    transfer-calibrated against the same synthetic device (K = 24)."""
    store, ref_store = source[0], source[1]
    hub, ref_hub = _hubs(source)
    kw = dict(seed=7, noise=0.1, base_scale=3.0)
    transfer.TransferEngine(DeviceSetting(*SRC), DeviceSetting(*TGT), family="gbdt",
                            seed=0).adapt(
        store, hub, transfer.ReplayProfileSession(
            store, transfer.SyntheticDevice("simdev", **kw), DeviceSetting(*SRC)), 24)
    ref_transfer.TransferEngine(RefSetting(*SRC), RefSetting(*TGT), family="gbdt",
                                seed=0).adapt(
        ref_store, ref_hub, ref_transfer.ReplayProfileSession(
            ref_store, ref_transfer.SyntheticDevice("simdev", **kw), RefSetting(*SRC)),
        24)
    return (LatencyService(hub, default_setting=DeviceSetting(*SRC), predictor="gbdt",
                           inference_backend="numpy", device=CPU),
            RefService(ref_hub, default_setting=RefSetting(*SRC), predictor="gbdt",
                       inference_backend="numpy"))


def test_scorer_filters_on_every_device(two_device):
    svc, ref = two_device
    from repro.core.nas_space import NASSpaceConfig as RefSpace
    from repro.core.nas_space import sample_architecture as ref_sample
    space, ref_space = NASSpaceConfig(**SPACE_KW), RefSpace(**SPACE_KW)
    graphs = [sample_architecture(s, space) for s in range(300, 316)]
    ref_gs = [ref_sample(s, ref_space) for s in range(300, 316)]
    calls0 = svc.predict_batch_calls
    loose = search.LatencyScorer(svc, [search.DeviceBudget(DeviceSetting(*SRC), 1e9),
                                       search.DeviceBudget(DeviceSetting(*TGT), 1e9)])
    lats = loose.score(graphs)
    assert svc.predict_batch_calls - calls0 == 2          # one per setting
    assert set(lats) == {"float32/op_by_op", "simdev:float32/op_by_op"}
    assert loose.feasible_mask(lats).all()
    ref_lats = ref_search.LatencyScorer(
        ref, [ref_search.DeviceBudget(RefSetting(*SRC), 1e9),
              ref_search.DeviceBudget(RefSetting(*TGT), 1e9)]).score(ref_gs)
    for k in lats:
        np.testing.assert_array_equal(lats[k], ref_lats[k])
    # Tighten ONLY the second device to its median: some candidates that
    # pass device 1 must now fail the joint constraint.
    t_med = float(np.median(lats["simdev:float32/op_by_op"]))
    tight = search.LatencyScorer(svc, [search.DeviceBudget(DeviceSetting(*SRC), 1e9),
                                       search.DeviceBudget(DeviceSetting(*TGT), t_med)])
    mask = tight.feasible_mask(lats)
    assert 0 < mask.sum() < len(graphs)
    viol = tight.violation(lats)
    assert (viol[~mask] > 0).all() and (viol[mask] == 0).all()


def test_search_respects_both_budgets(two_device):
    svc, _ = two_device
    space = NASSpaceConfig(**SPACE_KW)
    probe = [sample_architecture(s, space) for s in range(400, 408)]
    s_lat = [r.e2e_s for r in svc.predict_batch(probe, DeviceSetting(*SRC))]
    t_lat = [r.e2e_s for r in svc.predict_batch(probe, DeviceSetting(*TGT))]
    budgets = [search.DeviceBudget(DeviceSetting(*SRC), float(np.max(s_lat))),
               search.DeviceBudget(DeviceSetting(*TGT), float(np.median(t_lat)))]
    cfg = search.SearchConfig(population_size=12, generations=4, children_per_gen=10,
                              tournament_size=4, seed=13, resolution=16,
                              front_capacity=8)
    rep = search.SearchEngine(svc, budgets, cfg).run()
    assert len(rep.front) > 0
    for m in rep.front:
        for b in budgets:
            assert m.latencies[b.key] <= b.budget_s
    assert any(s.feasible_new < s.new_scored for s in rep.stats)
    assert len(rep.front[0].objectives) == 3
