"""The port's lasso and MLP predictors held against the reference's.

Lasso: the torch ISTA solve against the reference's jitted float32
`_ista_jax` on the same float32 design, and against the float64 numpy
oracle `_ista_numpy` (the reference's, copied into the port) at
convergence (by objective value: the oracle's
exact Lipschitz step takes another path to the same minimum).  MLP: the
port's full-batch Adam against the reference's `_adam_epoch` from the
reference's initial parameters (JAX's threefry init cannot be
reproduced, so they are carried over with
`convert.mlp_params_from_reference`), and accuracy from the port's own
init inside the reference's band.  Both packages' JSON load in the
other.  Everything runs on the host (``device="cpu"``).
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core.predictors import load_predictor as ref_load  # noqa: E402
from repro.core.predictors import make_predictor as ref_make  # noqa: E402
from repro.core.predictors import lasso as ref_lasso  # noqa: E402
from repro.core.predictors import mlp as ref_mlp  # noqa: E402

from repro_torch.convert import mlp_params_from_reference  # noqa: E402
from repro_torch.core.predictors import (PREDICTORS, LassoPredictor,  # noqa: E402
                                         MLPPredictor, load_predictor,
                                         make_predictor)
from repro_torch.core.predictors import lasso as port_lasso  # noqa: E402
from repro_torch.core.predictors import mlp as port_mlp  # noqa: E402

# One intra-op thread per xdist worker's share of the cores: these tests
# run beside the reference's wall-clock profiling tests.
torch.set_num_threads(max(1, (os.cpu_count() or 1)
                          // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

U32 = 2.0 ** -24                  # float32 unit roundoff
CPU = "cpu"


def _linear_data(n=300, d=6, seed=0):
    """The reference's `tests/test_predictors.py::_linear_data`."""
    rng = np.random.default_rng(seed)
    x = np.abs(rng.standard_normal((n, d))) * np.linspace(1, 50, d)
    w = np.array([2.0, 0, 0.5, 0, 0, 1.0])
    y = x @ w + 0.3
    return x, y


def _design(fit_intercept):
    """The row-scaled float32 design both solvers take.  Without an
    intercept the features stay uncentred (positive), so a non-negative
    combination can fit and the solution is not all zero."""
    x, y = _linear_data()
    xs = (x - x.mean(0)) / x.std(0) if fit_intercept else x / x.std(0)
    w_inv = 1.0 / np.maximum(y, 1e-12)
    a = xs * w_inv[:, None]
    if fit_intercept:
        a = np.concatenate([a, w_inv[:, None]], axis=1)
    return xs, y, a


def _objective(a, w, alpha, fit_intercept):
    r = a @ w - 1.0
    return np.mean(r * r) + alpha * np.abs(w[:-1] if fit_intercept else w).sum()


# -- lasso -----------------------------------------------------------------------

@pytest.mark.parametrize("fit_intercept", [True, False])
@pytest.mark.parametrize("alpha", [1e-5, 1e-3, 1e-1])
@pytest.mark.parametrize("iters", [50, 800])
def test_ista_matches_reference_jax(fit_intercept, alpha, iters):
    _, _, a = _design(fit_intercept)
    want = np.asarray(ref_lasso._ista_jax(jnp.asarray(a), alpha, iters, fit_intercept))
    got = port_lasso._ista_torch(torch.as_tensor(a, dtype=torch.float32),
                                 alpha, iters, fit_intercept)
    assert got.dtype == torch.float32
    # Both iterate in float32 with their products summed in another
    # order: allow one float32 rounding of the iterate's scale per step.
    tol = iters * U32 * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol)


@pytest.mark.parametrize("fit_intercept", [True, False])
@pytest.mark.parametrize("alpha", [1e-4, 1e-2])
def test_ista_reaches_the_numpy_oracles_minimum(fit_intercept, alpha):
    xs, y, a = _design(fit_intercept)
    w_np = port_lasso._ista_numpy(xs, y, alpha, 3000, fit_intercept)
    # The oracle is the reference's, copied.
    np.testing.assert_array_equal(
        w_np, ref_lasso._ista_numpy(xs, y, alpha, 3000, fit_intercept))
    w = port_lasso._ista_torch(torch.as_tensor(a, dtype=torch.float32),
                               alpha, 3000, fit_intercept).numpy().astype(np.float64)
    f_np, f = _objective(a, w_np, alpha, fit_intercept), _objective(a, w, alpha, fit_intercept)
    # A float32 iterate at the minimum: the objective, flat there, moves
    # by the ℓ1 term's share of a rounding of w (read: ≤ 3e-11 relative).
    assert abs(f - f_np) <= 1e-7 * f_np
    assert f > 0


def test_lasso_fit_selects_the_reference_alpha():
    x, y = _linear_data()
    ref = ref_lasso.LassoPredictor().fit(x[:250], y[:250])
    port = LassoPredictor(device=CPU).fit(x[:250], y[:250])
    assert port.alpha == ref.alpha
    assert port.w.dtype == ref.w.dtype == np.float32
    assert port.fit_device == torch.device(CPU)
    tol = port.iters * U32 * float(np.abs(ref.w).max())
    np.testing.assert_allclose(port.w, ref.w, rtol=0, atol=tol)


# -- MLP -------------------------------------------------------------------------

def _mlp_problem():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((64, 5))
    y = np.abs(x @ rng.standard_normal(5)) + 1.0
    return x, y


def _max_diff(ref_params, port_params):
    return max(float(np.abs(np.asarray(r) - p.detach().cpu().numpy()).max())
               for rp, pp in zip(ref_params, port_params) for r, p in zip(rp, pp))


def test_mlp_adam_epochs_match_reference():
    x, y = _mlp_problem()
    sizes = [5, 32, 32, 1]
    rp = ref_mlp._init_params(jax.random.PRNGKey(0), sizes, float(y.mean()))
    pp = mlp_params_from_reference([(np.asarray(w), np.asarray(b)) for w, b in rp],
                                   device=CPU)
    assert _max_diff(rp, pp) == 0.0
    zeros = jax.tree_util.tree_map(jnp.zeros_like, rp)
    ro = (zeros, jax.tree_util.tree_map(jnp.zeros_like, rp))
    po = tuple([(torch.zeros_like(w), torch.zeros_like(b)) for w, b in pp]
               for _ in range(2))
    xj, yj = jnp.asarray(x), jnp.asarray(y)
    xt, yt = torch.tensor(x, dtype=torch.float32), torch.tensor(y, dtype=torch.float32)
    for epoch in range(1, 51):
        rp, ro = ref_mlp._adam_epoch(rp, ro, xj, yj, epoch, 5e-3, 1e-5)
        pp, po = port_mlp._adam_epoch(pp, po, xt, yt, epoch, 5e-3, 1e-5)
        # Float32 gradients summed in another order, bias corrections
        # rounded once more: 2e-7 a step on O(1) parameters (read: 2.7e-6
        # after 50 epochs).  Past ~100 epochs a near-zero gradient whose
        # sign differs moves one weight by up to 2·lr, so N stays 50.
        assert _max_diff(rp, pp) <= 2e-7 * epoch, epoch


def test_mlp_fit_from_reference_init_matches(monkeypatch):
    x, y = _linear_data()
    hp = dict(hidden_layers=2, width=32, max_epochs=50, patience=10_000)

    def ref_init(generator, sizes, y_mean, device):
        params = ref_mlp._init_params(jax.random.PRNGKey(0), sizes, y_mean)
        return mlp_params_from_reference(
            [(np.asarray(w), np.asarray(b)) for w, b in params], device)

    monkeypatch.setattr(port_mlp, "_init_params", ref_init)
    ref = ref_mlp.MLPPredictor(**hp).fit(x[:250], y[:250])
    port = MLPPredictor(**hp, device=CPU).fit(x[:250], y[:250])
    assert port.fit_device == torch.device(CPU)
    assert port.y_scale == ref.y_scale
    # 50 epochs at the per-step budget of the test above.
    assert _max_diff(ref.params, [(torch.from_numpy(w), torch.from_numpy(b))
                                  for w, b in port.params]) <= 2e-7 * 50
    np.testing.assert_allclose(port.predict(x[250:]), ref.predict(x[250:]),
                               rtol=1e-4)


# -- both families, as the reference tests them ----------------------------------

@pytest.mark.parametrize("name,tol", [
    ("lasso", 0.05), ("rf", 0.25), ("gbdt", 0.10), ("mlp", 0.30)])
def test_predictor_fits_linear_relation(name, tol):
    x, y = _linear_data()
    kw = {"max_epochs": 1200} if name == "mlp" else {}
    if name in ("lasso", "mlp"):
        kw["device"] = CPU
    m = make_predictor(name, **kw)
    m.fit(x[:250], y[:250])
    assert m.mape(x[250:], y[250:]) < tol


def test_lasso_nonneg_weights():
    x, y = _linear_data()
    m = LassoPredictor(alpha=1e-3, device=CPU).fit(x, y)
    assert (m.feature_weights >= 0).all()


def test_lasso_sparsity_increases_with_alpha():
    x, y = _linear_data()
    w_small = LassoPredictor(alpha=1e-4, device=CPU).fit(x, y).feature_weights
    w_big = LassoPredictor(alpha=10.0, device=CPU).fit(x, y).feature_weights
    assert (w_big > 1e-8).sum() <= (w_small > 1e-8).sum()


@pytest.mark.parametrize("name", ["lasso", "rf", "gbdt", "mlp"])
def test_predictions_nonnegative(name):
    x, y = _linear_data()
    kw = {"device": CPU, **({"max_epochs": 100} if name == "mlp" else {})} \
        if name in ("lasso", "mlp") else {}
    m = make_predictor(name, **kw).fit(x, y)
    assert (m.predict(-np.abs(x)) >= 0).all()


# -- JSON across the two packages ------------------------------------------------

# MLP predictions across packages (and, in chip_smoke.py, card against
# host): the same float32 parameters, float32 sums of ≤ 128 terms a layer
# in another order; relative to the largest prediction, since an output
# near zero is a difference of larger terms.
MLP_PREDICT_TOL = 1e-5


def _assert_mlp_close(got, want):
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=MLP_PREDICT_TOL * np.abs(want).max())


@pytest.fixture(scope="module")
def ref_saved():
    x, y = _linear_data()
    lasso = ref_make("lasso").fit(x[:250], y[:250])
    mlp = ref_make("mlp", hidden_layers=2, width=32, max_epochs=60).fit(x[:250], y[:250])
    return x, {"lasso": lasso, "mlp": mlp}


@pytest.mark.parametrize("name", ["lasso", "mlp"])
def test_reference_json_loads_in_the_port(ref_saved, name):
    x, models = ref_saved
    ref = models[name]
    port = load_predictor(ref.to_json(), device=CPU)
    assert type(port).__name__ == type(ref).__name__
    assert port.to_json() == ref.to_json()
    if name == "lasso":
        np.testing.assert_array_equal(port.predict(x), ref.predict(x))
    else:
        assert port.predict(x).dtype == ref.predict(x).dtype == np.float32
        _assert_mlp_close(port.predict(x), ref.predict(x))


@pytest.mark.parametrize("name", ["lasso", "mlp"])
def test_port_json_loads_in_the_reference(name):
    x, y = _linear_data()
    kw = {"max_epochs": 60, "hidden_layers": 2, "width": 32} if name == "mlp" else {}
    port = make_predictor(name, device=CPU, **kw).fit(x[:250], y[:250])
    d = port.to_json()
    assert d["config"].keys() == ref_make(name, **kw)._config_json().keys()
    ref = ref_load(d)
    assert ref.to_json() == d
    if name == "lasso":
        np.testing.assert_array_equal(ref.predict(x), port.predict(x))
    else:
        _assert_mlp_close(ref.predict(x), port.predict(x))


# -- the calibrated wrapper (transfer) around every base family -------------------

def _ref_calibrated(name):
    """A reference `CalibratedPredictor` around a fitted ``name`` base."""
    from repro.transfer import CalibratedPredictor as RefCalibrated
    from repro.transfer import fit_latency_map as ref_fit_map
    x, y = _linear_data()
    kw = {"mlp": {"max_epochs": 60, "hidden_layers": 2, "width": 32},
          "gbdt": {"n_stages": 20}, "rf": {"n_trees": 4}}.get(name, {})
    base = ref_make(name, **kw).fit(x[:250], y[:250])
    latency_map = ref_fit_map(y[:40], np.exp(0.4) * y[:40] ** 1.05)
    return RefCalibrated.wrap(base, latency_map), x


@pytest.mark.parametrize("name", ["lasso", "gbdt", "rf", "mlp"])
def test_calibrated_loads_from_the_reference_json(name):
    ref, x = _ref_calibrated(name)
    port = load_predictor(ref.to_json(), device=CPU)
    assert port.name == "calibrated" and port.base.name == name
    assert port.to_json() == ref.to_json()
    if name == "mlp":
        _assert_mlp_close(port.predict(x), ref.predict(x))
    else:
        np.testing.assert_array_equal(port.predict(x), ref.predict(x))
        np.testing.assert_array_equal(port.predict_oracle(x), ref.predict_oracle(x))


def test_calibrated_mlp_base_loads_on_the_host():
    ref, x = _ref_calibrated("mlp")
    port = load_predictor(ref.to_json(), device=CPU)
    assert port.base.device == torch.device(CPU)
    port.predict(x)
    assert port.base._dev_params[0][0].device == torch.device(CPU)
    # `wrap` hands the wrapper its base's device, so a bank round trip
    # keeps the base on the host too.
    from repro_torch.transfer import CalibratedPredictor
    again = CalibratedPredictor.wrap(port.base, port.map)
    assert again.device == torch.device(CPU)
    assert load_predictor(again.to_json(), device=CPU).base.device == torch.device(CPU)


def test_failed_calibration_import_raises(monkeypatch):
    """`load_predictor` imports the transfer layer for an unknown family;
    the module is part of the port, so a failed import is an error."""
    import sys
    ref, _ = _ref_calibrated("lasso")
    monkeypatch.delitem(PREDICTORS._items, "calibrated", raising=False)
    monkeypatch.setitem(sys.modules, "repro_torch.transfer.calibration", None)
    with pytest.raises(ImportError):
        load_predictor(ref.to_json(), device=CPU)


def test_mlp_predicts_on_its_device():
    x, y = _linear_data()
    m = MLPPredictor(hidden_layers=1, width=8, max_epochs=10, device=CPU).fit(x, y)
    assert m.device == torch.device(CPU)
    assert all(w.device == m.device for pair in m._dev_params for w in pair)
    again = load_predictor(m.to_json(), device=CPU)
    assert again._dev_params is None
    np.testing.assert_array_equal(again.predict(x), m.predict(x))
    assert again._dev_params[0][0].device == torch.device(CPU)
