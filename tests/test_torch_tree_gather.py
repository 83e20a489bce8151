"""Port tree tiers (repro_torch) held against the reference (repro).

Reference GBDT/RF models are fitted on the shapes of the reference's own
`TestTreeGatherPallas`, carried into the port as plain data
(`repro_torch.convert`), and both packages score the same numpy inputs.
The reference runs on the CPU as its own tests run it: the jax tier, and
the Pallas kernel in interpret mode.  The CUDA kernels themselves run
only on the card (chip_smoke.py and tests/test_torch_cuda_kernels.py);
here the CPU bank takes their plain torch versions.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro.core.predictors import GBDTPredictor, RandomForestPredictor  # noqa: E402
from repro.kernels.tree_gather import fused_predict as ref_fused_predict  # noqa: E402
from repro.kernels.tree_gather import predict_trees_jax  # noqa: E402
from repro.kernels.tree_gather import to_device_scaler as ref_scaler  # noqa: E402
from repro.kernels.tree_gather_pallas import predict_trees_pallas  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.core.predictors import flat as port_flat  # noqa: E402
from repro_torch.kernels import tree_gather as tg  # noqa: E402
from repro_torch.kernels import tree_gather_cuda as tgc  # noqa: E402

D = 5
SHAPES = [(1, 1, 1), (7, 3, 2), (64, 10, 3), (257, 20, 4), (300, 130, 2)]


def _features(rng, n):
    return np.abs(rng.standard_normal((n, D))) * np.linspace(1, 20, D)


def _fit(family, n_trees, depth, seed, n=120):
    rng = np.random.default_rng(seed)
    x = _features(rng, n)
    y = x @ rng.random(D) + 0.1
    if family == "gbdt":
        ref = GBDTPredictor(n_stages=n_trees, max_depth=depth).fit(x, y)
    else:
        ref = RandomForestPredictor(n_trees=n_trees, max_depth=depth).fit(x, y)
    return ref, convert.predictor_from_reference(ref.to_json()), rng


CASES = [("gbdt", t, dep, rows) for rows, t, dep in SHAPES] + \
        [("rf", 6, 10, 200)]                 # one forest at depth >= 8
IDS = [f"{f}-rows{r}-trees{t}-depth{d}" for f, t, d, r in CASES]


@pytest.fixture(scope="module", params=CASES, ids=IDS)
def case(request):
    family, n_trees, depth, rows = request.param
    n_fit = 400 if family == "rf" else 120
    ref, port, rng = _fit(family, n_trees, depth, seed=rows + n_trees, n=n_fit)
    q = _features(rng, rows)
    return ref, port, q


def test_depth_reaches_requested(case):
    ref, port, _ = case
    assert port.flat().max_depth == ref.flat().max_depth
    if isinstance(ref, RandomForestPredictor):
        assert ref.flat().max_depth >= 8


def test_numpy_tier_bit_identical(case):
    ref, port, q = case
    xs = ref.scaler.transform(q)
    assert np.array_equal(port.flat().predict_trees(xs, backend="numpy"),
                          ref.flat().predict_trees(xs, backend="numpy"))
    assert np.array_equal(port.predict(q), ref.predict(q))


def test_plain_leaves_bit_equal_jax_and_pallas(case):
    # Same float32 input, same `xv <= thr` compare in float32: leaves
    # are identical bits, no tolerance.
    ref, port, q = case
    xs = ref.scaler.transform(q)
    got = tg.predict_trees_device(port.flat(), xs, device="cpu")
    assert got.shape == (len(q), port.flat().n_trees)
    assert np.array_equal(got, predict_trees_jax(ref.flat(), xs))
    assert np.array_equal(got, predict_trees_pallas(ref.flat(), xs))
    assert np.array_equal(port.flat().predict_trees(xs, backend="torch"), got)


def test_gather_leaves_plain_on_bank_arrays(case):
    ref, port, q = case
    db = port.flat().device_bank("cpu")
    xs = torch.from_numpy(ref.scaler.transform(q).astype(np.float32))
    leaves = tg.gather_leaves_plain(*db.bank_args, xs, depth=db.depth)
    assert leaves.dtype == torch.float32
    assert np.array_equal(leaves.numpy().astype(np.float64),
                          predict_trees_jax(ref.flat(), ref.scaler.transform(q)))


@pytest.mark.parametrize("ref_backend", ["jax", "pallas"])
def test_fused_plain_matches_reference_fused(case, ref_backend):
    # Tolerance rtol=1e-6, atol=1e-7: the leaves are identical, and only
    # the float32 summation order over trees differs between torch's sum
    # and XLA's (and the Pallas branch's jnp epilogue).
    ref, port, q = case
    q32 = q.astype(np.float32)
    want = ref.predict_on_device(q32, backend=ref_backend)
    got = port.predict_on_device(q32, device="cpu")
    assert got.shape == want.shape == (len(q),)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_fused_predict_function_matches_model_path(case):
    _, port, q = case
    flat = port.flat()
    sc = tg.to_device_scaler(port.scaler, "cpu")
    direct = tg.fused_predict(flat, sc, port._device_reduction(),
                              q.astype(np.float32), device="cpu")
    assert np.array_equal(direct, port.predict_on_device(q.astype(np.float32),
                                                         device="cpu"))


def test_bank_uploaded_once_across_calls(case):
    ref, port, q = case
    flat = port.flat()
    xs = ref.scaler.transform(q)
    before = tg.residency_counters()["banks_built"]
    flat.predict_trees(xs, backend="torch")
    db = flat._device_bank
    assert db is not None and db.uploads == 1
    flat.predict_trees(xs, backend="torch")
    port.predict_on_device(q.astype(np.float32), device="cpu")
    port.predict_on_device(q.astype(np.float32), device="cpu")
    assert flat._device_bank is db and db.uploads == 1
    assert db.inputs_staged >= 4
    assert tg.residency_counters()["banks_built"] - before <= 1


def test_flat_from_arrays_round_trip(case):
    ref, _, q = case
    rf = ref.flat()
    flat = convert.flat_from_arrays(rf.feature, rf.threshold, rf.left,
                                    rf.right, rf.value, rf.roots, rf.max_depth)
    xs = ref.scaler.transform(q)
    assert np.array_equal(flat.predict_trees(xs, backend="numpy"),
                          rf.predict_trees(xs, backend="numpy"))
    assert np.array_equal(flat.predict_trees(xs, backend="torch"),
                          predict_trees_jax(rf, xs))


def test_reference_scaler_and_port_scaler_agree(case):
    ref, port, _ = case
    m_ref, s_ref = ref_scaler(ref.scaler)
    m, s = tg.to_device_scaler(port.scaler, "cpu")
    assert np.array_equal(m.numpy(), np.asarray(m_ref))
    assert np.array_equal(s.numpy(), np.asarray(s_ref))


def test_fused_predict_reference_function_parity():
    ref, port, rng = _fit("gbdt", 12, 3, seed=3)
    q32 = _features(rng, 513).astype(np.float32)
    want = ref_fused_predict(ref.flat(), ref_scaler(ref.scaler),
                             ref._device_reduction(), q32, backend="jax")
    got = tg.fused_predict(port.flat(), tg.to_device_scaler(port.scaler, "cpu"),
                           port._device_reduction(), q32, device="cpu")
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


# -- tiers and dispatch ---------------------------------------------------------

def test_auto_threshold_is_unmeasured_zero():
    assert port_flat.AUTO_DEVICE_MIN_SLOTS == 0


@pytest.mark.parametrize("device,tier", [("cpu", "torch"), ("cuda", "cuda")])
def test_resolve_backend_auto_picks_device_tier(device, tier):
    assert port_flat.resolve_backend("auto", 1, device) == tier
    assert port_flat.resolve_backend("auto", 1 << 22, device) == tier
    assert port_flat.resolve_backend("numpy", 1 << 22, device) == "numpy"


def test_resolve_backend_auto_below_threshold_is_numpy(monkeypatch):
    monkeypatch.setattr(port_flat, "AUTO_DEVICE_MIN_SLOTS", 1 << 16)
    assert port_flat.resolve_backend("auto", (1 << 16) - 1, "cpu") == "numpy"
    assert port_flat.resolve_backend("auto", 1 << 16, "cpu") == "torch"


@pytest.mark.parametrize("backend", ["jax", "pallas", "triton"])
def test_unknown_backend_raises(backend):
    with pytest.raises(ValueError, match="unknown tree backend"):
        port_flat.resolve_backend(backend, 10)
    _, port, rng = _fit("gbdt", 3, 2, seed=1)
    with pytest.raises(ValueError, match="unknown tree backend"):
        port.flat().predict_trees(_features(rng, 4), backend=backend)


def test_auto_on_host_bank_runs_torch_tier():
    ref, port, rng = _fit("gbdt", 8, 3, seed=5)
    q = _features(rng, 40)
    xs = ref.scaler.transform(q)
    port.flat().device_bank("cpu")             # resident on the host
    got = port.flat().predict_trees(xs, backend="auto")
    assert np.array_equal(got, predict_trees_jax(ref.flat(), xs))


def test_bank_moves_when_device_changes():
    _, port, _ = _fit("gbdt", 4, 2, seed=9)
    flat = port.flat()
    db = flat.device_bank("cpu")
    assert flat.device_bank("cpu") is db
    assert db.stats()["uploads"] == 1 and db.stats()["sharded"] is False


def test_cuda_wrappers_reject_host_banks():
    # On the CPU the bank takes the plain version; the kernel wrappers
    # themselves only take tensors on the card and raise otherwise.
    ref, port, rng = _fit("gbdt", 4, 2, seed=2)
    db = port.flat().device_bank("cpu")
    xs = db.stage_input(ref.scaler.transform(_features(rng, 8)))
    with pytest.raises(ValueError, match="resident on the card"):
        tgc.gather_leaves_cuda(db, xs)
    m, s = tg.to_device_scaler(port.scaler, "cpu")
    before = tgc.launch_counts()
    with pytest.raises(ValueError, match="resident on the card"):
        tgc.fused_predict_cuda(db, m, s, 0.1, 0.0, xs, "sum")
    with pytest.raises(ValueError, match="unknown reduction"):
        tgc.fused_predict_cuda(db, m, s, 0.1, 0.0, xs, "max")
    assert tgc.launch_counts() == before      # a refused call counts nothing


def test_launch_counters_reset():
    tgc.LAUNCHES["tree_gather_leaves"] += 3
    tgc.reset_launch_counts()
    assert tgc.launch_counts() == {"tree_gather_leaves": 0,
                                   "tree_predict_fused": 0}


# -- launch geometry (pure arithmetic, no card needed) --------------------------

def test_launch_plan_default_gbdt_bank_in_shared_memory():
    # FAST_HPARAMS GBDT: 150 stages of depth <= 4 → at most 150·31 nodes.
    plan = tgc.launch_plan(150 * 31, 32768, 20, n_sm=132)
    assert plan["bank_in_smem"] == 1
    assert plan["smem_bytes"] == 150 * 31 * 20 + tgc.ROWS_PER_BLOCK * 20 * 4
    assert plan["smem_bytes"] <= tgc.SMEM_OPTIN_BYTES
    assert 1 <= plan["grid"] <= 132 * tgc.MAX_BLOCKS_PER_SM


def test_launch_plan_deep_forest_stays_in_global_memory():
    plan = tgc.launch_plan(10 * (2 ** 15 - 1), 32768, 20, n_sm=132)
    assert plan["bank_in_smem"] == 0
    assert plan["smem_bytes"] == tgc.ROWS_PER_BLOCK * 20 * 4
    assert plan["grid"] == min(32768 // tgc.ROWS_PER_BLOCK,
                               132 * tgc.MAX_BLOCKS_PER_SM)


def test_launch_plan_grid_covers_small_batches():
    plan = tgc.launch_plan(100, 1, 5, n_sm=132)
    assert plan["grid"] == 1
    plan = tgc.launch_plan(100, 33, 5, n_sm=132)
    assert plan["grid"] == 2


def test_launch_plan_rejects_rows_too_wide_for_shared_memory():
    with pytest.raises(ValueError, match="do not fit"):
        tgc.launch_plan(10, 100, 4096, n_sm=132)


def test_library_path_is_keyed_by_sources(monkeypatch):
    from repro_torch.kernels import _build

    p = tgc.LIBRARY.path()
    assert p.parent == _build.BUILD_DIR and p.suffix == ".so"
    assert p.name.startswith("libtree_gather_")
    assert tgc.LIBRARY.path() == p
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-lineinfo",))
    assert tgc.LIBRARY.path() != p
    assert "arch=compute_90a,code=sm_90a" in " ".join(_build.NVCC_FLAGS)
    assert "--use_fast_math" not in _build.NVCC_FLAGS
