"""The port's real-world suite and dataset functions held against the
reference's.

Every registered real-world architecture, at resolutions 32 and 224, is
built by both packages and compared node for node (ops, shapes,
attributes, fingerprints).  Then one store, written by the reference's
hardware-free `CostModelProfileSession` over synthetic and real-world
graphs, is read by both: `build_dataset` gives the same records, and
`evaluate_bank` gives the same report for banks of every family that
the port loads from the reference's JSON (numpy tier for the trees;
lasso predicts in numpy too; the MLP within float32 order-of-sums).
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro.core import dataset as ref_dataset  # noqa: E402
from repro.core.profiler import DeviceSetting as RefSetting  # noqa: E402
from repro.core.realworld import build_realworld_suite as ref_suite  # noqa: E402
from repro.pipeline import PredictorHub as RefHub  # noqa: E402
from repro.pipeline import ProfileStore as RefStore  # noqa: E402
from repro.transfer.synthetic import CostModelProfileSession  # noqa: E402

from repro_torch.core import dataset  # noqa: E402
from repro_torch.core.composition import PredictorBank  # noqa: E402
from repro_torch.core.profiler import DeviceSetting  # noqa: E402
from repro_torch.core.realworld import REALWORLD, build_realworld_suite  # noqa: E402
from repro_torch.pipeline import ProfileStore, setting_key  # noqa: E402

# One intra-op thread per xdist worker's share of the cores: these tests
# run beside the reference's wall-clock profiling tests.
torch.set_num_threads(max(1, (os.cpu_count() or 1)
                          // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

SETTING = ("cpu_f32", "float32", "op_by_op")
N_SYNTH, N_TRAIN = 10, 8
# MLP e2e predictions across packages: the same float32 parameters,
# float32 sums in another order (see tests/test_torch_predictors.py).
MLP_RTOL = 1e-5
NAMES = [g.name for g in ref_suite(resolution=32)]


def _graph_json(g):
    return {"name": g.name, "json": g.to_json(), "fingerprint": g.fingerprint(),
            "num_ops": g.num_ops()}


def test_suite_registers_the_reference_families():
    from repro.core.realworld import REALWORLD as REF

    assert list(REALWORLD.names()) == list(REF.names())
    assert [g.name for g in build_realworld_suite()] == NAMES


@pytest.mark.parametrize("resolution", [32, 224])
@pytest.mark.parametrize("index", range(len(NAMES)), ids=NAMES)
def test_realworld_graph_equals_reference(index, resolution):
    ref = ref_suite(resolution=resolution)[index]
    port = dataset.realworld_graphs(resolution=resolution)[index]
    assert _graph_json(port) == _graph_json(ref)
    assert [n.op_type for n in port.nodes] == [n.op_type for n in ref.nodes]
    assert [port.tensor(t).shape for n in port.nodes for t in n.outputs] == \
        [ref.tensor(t).shape for n in ref.nodes for t in n.outputs]


@pytest.fixture(scope="module")
def store_path(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("rw") / "store.jsonl")
    store = RefStore(path)
    CostModelProfileSession(store=store).profile_suite(
        ref_dataset.synthetic_graphs(N_SYNTH, resolution=16)
        + ref_dataset.realworld_graphs(resolution=16), RefSetting(*SETTING))
    store.close()
    return path


def test_build_dataset_reads_the_reference_store(store_path):
    ref_graphs = ref_dataset.realworld_graphs(resolution=16)
    ref = ref_dataset.build_dataset(ref_graphs, RefSetting(*SETTING),
                                    store=RefStore(store_path))
    port = dataset.build_dataset(dataset.realworld_graphs(resolution=16),
                                 DeviceSetting(*SETTING),
                                 store=ProfileStore(store_path), device="cpu")
    assert port.setting == ref.setting
    assert [a.to_json() for a in port.archs] == [a.to_json() for a in ref.archs]


@pytest.fixture(scope="module")
def datasets(store_path):
    """(train, real-world) datasets of both packages from one store."""
    out = {}
    for pkg, store_cls, setting, ds_mod in (
            ("ref", RefStore, RefSetting(*SETTING), ref_dataset),
            ("port", ProfileStore, DeviceSetting(*SETTING), dataset)):
        store = store_cls(store_path)
        synth = ds_mod.synthetic_graphs(N_SYNTH, resolution=16)
        rw = ds_mod.realworld_graphs(resolution=16)
        key = setting_key(DeviceSetting(*SETTING))

        def ds(graphs):
            return ds_mod.LatencyDataset(key, store.arch_records(
                setting, fingerprints=[g.fingerprint() for g in graphs]))

        out[pkg] = {"train": ds(synth[:N_TRAIN]), "held": ds(synth[N_TRAIN:]),
                    "rw": ds(rw)}
    return out


HPARAMS = {"lasso": {"iters": 200}, "rf": {"n_trees": 4},
           "gbdt": {"n_stages": 20}, "mlp": {"max_epochs": 40, "width": 32}}


@pytest.mark.parametrize("family", ["lasso", "rf", "gbdt", "mlp"])
@pytest.mark.parametrize("split", ["held", "rw"])
def test_evaluate_bank_equals_reference(datasets, family, split):
    ref_bank = ref_dataset.fit_predictor_bank(
        datasets["ref"]["train"], family, hparams=HPARAMS[family],
        min_samples=3, overhead_model="affine")
    bank = PredictorBank.from_json(ref_bank.to_json(), device="cpu")
    assert bank.to_json() == ref_bank.to_json()
    ref_ds, ds = datasets["ref"][split], datasets["port"][split]
    idx = list(range(len(ds.archs)))
    want = ref_dataset.evaluate_bank(ref_ds, ref_bank, idx)
    got = dataset.evaluate_bank(ds, bank, idx)
    assert got["n_test"] == want["n_test"] == len(idx)
    assert got["y_true"] == want["y_true"]
    if family == "mlp":
        np.testing.assert_allclose(got["y_pred"], want["y_pred"], rtol=MLP_RTOL)
        assert got["per_op_mape"].keys() == want["per_op_mape"].keys()
        np.testing.assert_allclose(got["e2e_mape"], want["e2e_mape"], rtol=1e-3)
    else:
        assert got == want


def test_port_trains_every_family_on_the_host(datasets):
    """The port's own banks (device-bound families on ``device="cpu"``)
    cover the reference bank's op types and predict finite, ≥ 0."""
    for family in ("lasso", "mlp"):
        ref_bank = ref_dataset.fit_predictor_bank(
            datasets["ref"]["train"], family, hparams=HPARAMS[family], min_samples=3)
        bank = dataset.fit_predictor_bank(
            datasets["port"]["train"], family, hparams=HPARAMS[family],
            min_samples=3, device="cpu")
        assert sorted(bank.predictors) == sorted(ref_bank.predictors)
        assert all(m.fit_device == torch.device("cpu") for m in bank.predictors.values())
        rep = dataset.evaluate_bank(datasets["port"]["rw"], bank,
                                    range(len(datasets["port"]["rw"].archs)))
        assert np.isfinite(rep["y_pred"]).all() and np.isfinite(rep["e2e_mape"])
