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
    tgc._ROUTE_COUNTER.add("packed")
    tgc.reset_launch_counts()
    assert tgc.launch_counts() == {"tree_gather_leaves": 0,
                                   "tree_predict_fused": 0}
    assert tgc.route_counts() == {"staged": 0, "packed": 0}


# -- launch plan (pure arithmetic, no card needed) ------------------------------

H100_SMS = 132


def _x_bytes(pl, d):
    return (tgc.THREADS // pl.groups) * (d | 1) * 4 + tgc.THREADS * 4


def test_plan_default_gbdt_bank_is_staged_in_shared_memory():
    # FAST_HPARAMS GBDT: 150 stages of depth <= 4, kept complete (27,600 B).
    assert tgc.complete_bytes(150, 4) == 150 * 15 * 8 + 150 * 16 * 4
    assert tgc.has_complete(150, 4)
    for fused in (True, False):
        pl = tgc.plan(fused, 150, 4, True, 32768, 20, H100_SMS)
        assert pl.route == "staged"
        assert pl.smem_bytes == tgc.complete_bytes(150, 4) + _x_bytes(pl, 20)
        assert pl.smem_bytes <= tgc.SMEM_OPTIN_BYTES
        per_sm = min(tgc.MAX_BLOCKS_PER_SM,
                     tgc.SMEM_PER_SM_BYTES // (pl.smem_bytes + 1024))
        assert pl.grid == min(-(-32768 // pl.rows_per_block), H100_SMS * per_sm)
        assert pl.rows_per_block * pl.groups == tgc.THREADS


def test_plan_deep_forest_takes_the_packed_route():
    # RF 10 x 14: the complete layout would take 1.97 MB; the packed one stays.
    assert not tgc.has_complete(10, 14)
    pl = tgc.plan(True, 10, 14, False, 32768, 20, H100_SMS)
    assert pl.route == "packed"
    assert pl.smem_bytes == _x_bytes(pl, 20)


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "leaves"])
def test_plan_threads_a_row_at_each_crossover(fused):
    # Just below and just above every rows-an-SM crossover of the table.
    table = tgc.FUSED_GROUPS if fused else tgc.LEAVES_GROUPS
    for (most, g), (_, g_next) in zip(table, table[1:]):
        at = int(most * H100_SMS)
        assert tgc.plan(fused, 150, 4, True, at, 20, H100_SMS).groups == g
        assert tgc.plan(fused, 150, 4, True, at + 1, 20, H100_SMS).groups == g_next
    assert tgc.plan(fused, 150, 4, True, 1, 20, H100_SMS).groups == table[0][1]
    assert tgc.plan(fused, 150, 4, True, 1 << 22, 20, H100_SMS).groups == table[-1][1]


@pytest.mark.parametrize("rows", [5, 527, 11437])
def test_plan_puts_rows_on_lanes_only_for_the_fused_kernel(rows):
    fused = tgc.plan(True, 150, 4, True, rows, 16, H100_SMS)
    assert fused.rows_on_lanes == (fused.groups < 32)
    assert not tgc.plan(False, 150, 4, True, rows, 16, H100_SMS).rows_on_lanes


def test_plan_caps_threads_a_row_at_the_tree_count():
    # 10 trees: at most 16 threads a row, however few the rows.
    assert tgc.plan(False, 10, 14, False, 5, 20, H100_SMS).groups == 16
    assert tgc.plan(True, 1, 1, True, 5, 20, H100_SMS).groups == 1


def test_plan_grid_covers_small_batches():
    pl = tgc.plan(True, 100, 3, True, 1, 5, H100_SMS)
    assert pl.grid == 1
    pl = tgc.make_plan("staged", 8, True, 100, 3, pl.rows_per_block + 1, 5, H100_SMS)
    assert pl.rows_per_block == 32
    pl = tgc.make_plan("staged", 8, True, 100, 3, 33, 5, H100_SMS)
    assert pl.grid == 2


def test_plan_widens_threads_a_row_when_rows_do_not_fit():
    # 5,000 features: 64 rows do not fit beside the bank; fewer rows do.
    pl = tgc.plan(True, 150, 4, True, 11437, 5000, H100_SMS)
    assert pl.groups > tgc.plan(True, 150, 4, True, 11437, 20, H100_SMS).groups
    assert pl.smem_bytes <= tgc.SMEM_OPTIN_BYTES
    assert pl.smem_bytes == tgc.complete_bytes(150, 4) + _x_bytes(pl, 5000)


def test_plan_rejects_rows_too_wide_for_shared_memory():
    with pytest.raises(ValueError, match="do not fit"):
        tgc.plan(True, 10, 2, True, 100, 100_000, H100_SMS)
    with pytest.raises(ValueError, match="do not fit"):
        tgc.make_plan("packed", 1, True, 10, 14, 100, 4096, H100_SMS)


def test_make_plan_rejects_unknown_routes_and_group_counts():
    with pytest.raises(ValueError, match="no launch"):
        tgc.make_plan("direct", 8, False, 150, 4, 100, 20, H100_SMS)
    with pytest.raises(ValueError, match="no launch"):
        tgc.make_plan("staged", 3, False, 150, 4, 100, 20, H100_SMS)


def test_plan_is_cached_per_shape():
    tgc.plan.cache_clear()
    tgc.plan(True, 150, 4, True, 527, 7, H100_SMS)
    tgc.plan(True, 150, 4, True, 527, 7, H100_SMS)
    assert tgc.plan.cache_info().hits == 1


def test_has_complete_limits():
    assert not tgc.has_complete(0, 4)
    assert tgc.complete_bytes(1, 1) == 16 + 16          # 8 B node, 8 B leaves, aligned
    big = max(t for t in range(1, 2000) if tgc.has_complete(t, 4))
    assert tgc.complete_bytes(big, 4) <= tgc.COMPLETE_MAX_BYTES
    assert tgc.complete_bytes(big + 1, 4) > tgc.COMPLETE_MAX_BYTES


# -- the complete level-order layout (walked here by a plain reader) -------------

def _walk_complete(nodes, leaves, x, *, depth, n_trees):
    """(rows, trees) leaves of the complete layout, as the kernels' staged
    route walks it: child 2i + 1 when ``x <= thr``, else 2i + 2."""
    n_int = (1 << depth) - 1
    base = torch.arange(n_trees).long() * n_int
    i = torch.zeros((x.shape[0], n_trees), dtype=torch.long)
    for _ in range(depth):
        nd = nodes[base + i]
        xv = torch.gather(x, 1, nd[..., 0].long())
        i = 2 * i + torch.where(xv <= nd[..., 1].view(torch.float32), 1, 2)
    return leaves[torch.arange(n_trees).long() * (n_int + 1) + i - n_int]


def _handmade_flat():
    """Three trees over 3 features: leaves at depths 1, 2 and 3, and a
    single-node tree (its root is a leaf)."""
    L = -1
    # tree 0: root f0 <= 0.5 → leaf 1.0 | (f1 <= -1 → leaf 2.0 | (f2 <= 0 → 3 | 4))
    # tree 1: the root alone, value 7.0
    # tree 2: root f2 <= 0.25 → (f0 <= 0 → 5 | 6) | leaf 8.0
    feature = [0, L, 1, L, 2, L, L, L, 2, 0, L, L, L]
    threshold = [0.5, 0, -1.0, 0, 0.0, 0, 0, 0, 0.25, 0.0, 0, 0, 0]
    left = [1, 1, 3, 3, 5, 5, 6, 7, 9, 10, 10, 11, 12]
    right = [2, 1, 4, 3, 6, 5, 6, 7, 12, 11, 10, 11, 12]
    value = [0, 1.0, 0, 2.0, 0, 3.0, 4.0, 7.0, 0, 0, 5.0, 6.0, 8.0]
    roots = [0, 7, 8]
    arrays = [np.array(a) for a in (feature, threshold, left, right, value, roots)]
    return arrays, 3


def _edge_inputs(rng, thresholds, n, d):
    """Random rows, rows equal to the bank's thresholds, and NaN features."""
    x = rng.standard_normal((n, d)).astype(np.float32)
    thr = np.asarray(thresholds, dtype=np.float32)
    x[: n // 3] = rng.choice(thr, size=(n // 3, d))          # exact ties
    x[n // 3: n // 3 + 5, ::2] = np.nan
    x[-1] = np.nan
    return x


def _layout_vs_plain(flat, x32):
    db = flat.device_bank("cpu")
    nodes, leaves = tg.complete_layout(*db.bank_args, depth=db.depth)
    assert nodes.shape == (db.n_trees * ((1 << db.depth) - 1), 2)
    assert leaves.shape == (db.n_trees * (1 << db.depth),)
    assert nodes.dtype == torch.int32 and leaves.dtype == torch.float32
    x = torch.from_numpy(x32)
    got = _walk_complete(nodes, leaves, x, depth=db.depth, n_trees=db.n_trees)
    assert torch.equal(got, tg.gather_leaves_plain(*db.bank_args, x, depth=db.depth))
    return got


def test_complete_layout_150x4_gbdt_bit_equal_to_plain_and_jax():
    ref, port, rng = _fit("gbdt", 150, 4, seed=11, n=600)
    assert port.flat().max_depth == 4
    x = _edge_inputs(rng, port.flat().threshold, 300, D)
    got = _layout_vs_plain(port.flat(), x)
    assert np.array_equal(got.numpy().astype(np.float64),
                          predict_trees_jax(ref.flat(), x.astype(np.float64)))


def test_complete_layout_unbalanced_and_single_node_trees():
    arrays, depth = _handmade_flat()
    rng = np.random.default_rng(4)
    x = _edge_inputs(rng, arrays[1], 90, 3)
    port = convert.flat_from_arrays(*arrays, max_depth=depth)
    got = _layout_vs_plain(port, x)
    from repro.core.predictors.flat import FlatEnsemble as RefFlat
    ref = RefFlat(arrays[0].astype(np.int32), arrays[1].astype(np.float64),
                  arrays[2].astype(np.int32), arrays[3].astype(np.int32),
                  arrays[4].astype(np.float64), arrays[5].astype(np.int32), depth)
    assert np.array_equal(got.numpy().astype(np.float64),
                          predict_trees_jax(ref, x.astype(np.float64)))
    # Hand-checked rows (ties go left; NaN goes right).
    rows = np.array([[0.5, 0, 0], [0.6, -1.0, 0.0], [0.6, -0.5, 0.1],
                     [0.0, 0.0, 0.25], [np.nan, np.nan, np.nan]], dtype=np.float32)
    want = torch.tensor([[1.0, 7.0, 6.0], [2.0, 7.0, 6.0], [4.0, 7.0, 6.0],
                         [1.0, 7.0, 5.0], [4.0, 7.0, 8.0]])
    assert torch.equal(_layout_vs_plain(port, rows), want)


def test_complete_layout_single_node_bank():
    arrays = [np.array(a) for a in ([-1], [0.0], [0], [0], [3.5], [0])]
    port = convert.flat_from_arrays(*arrays, max_depth=0)
    got = _layout_vs_plain(port, np.zeros((4, 1), dtype=np.float32))
    assert torch.equal(got, torch.full((4, 1), 3.5))


def test_complete_layout_depth_14_forest():
    ref, port, rng = _fit("rf", 3, 14, seed=21, n=3000)
    assert port.flat().max_depth == 14
    x = _edge_inputs(rng, port.flat().threshold, 64, D)
    got = _layout_vs_plain(port.flat(), x)
    assert np.array_equal(got.numpy().astype(np.float64),
                          predict_trees_jax(ref.flat(), x.astype(np.float64)))


def test_host_bank_keeps_no_kernel_layout():
    # The plain versions walk the reference's five arrays; only a bank on
    # the card builds a kernel layout.
    _, port, _ = _fit("gbdt", 4, 2, seed=2)
    db = port.flat().device_bank("cpu")
    assert db.cnodes is None and db.cleaves is None and db.nodes is None


def test_packed_layout_rows_hold_feature_threshold_bits_and_children():
    _, port, _ = _fit("rf", 3, 6, seed=4)
    db = port.flat().device_bank("cpu")
    nodes = tg.packed_layout(*db.bank_args)
    assert nodes.dtype == torch.int32 and nodes.shape == (db.n_nodes, 4)
    assert nodes.is_contiguous()
    assert torch.equal(nodes[:, 0], db.feature)
    assert torch.equal(nodes[:, 1].view(torch.float32), db.threshold)
    assert torch.equal(nodes[:, 2], db.left) and torch.equal(nodes[:, 3], db.right)


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
