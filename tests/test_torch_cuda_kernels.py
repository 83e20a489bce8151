"""The CUDA kernels on the card, against their plain torch versions.

Marked ``cuda``: these tests need an NVIDIA card and nvcc (the kernels
are built at first use), and skip elsewhere.  On a machine with the
card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_kernels.py

The leaves must be bit-equal to the plain version (same float32 compare
and IEEE standardization); fused predictions differ only by the order of
the float32 reduction over trees, bounded per row by
2·T·u·Σ|leaf| + 4·u·|pred| with u = 2^-24.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

pytestmark = pytest.mark.cuda

U32 = 2.0 ** -24


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _fit(family, n_trees, depth, n, d, seed):
    from repro_torch.core.predictors import GBDTPredictor, RandomForestPredictor

    rng = np.random.default_rng(seed)
    x = np.abs(rng.standard_normal((n, d))) * np.linspace(1, 30, d)
    y = x @ rng.random(d) + 0.1
    if family == "gbdt":
        return GBDTPredictor(n_stages=n_trees, max_depth=depth).fit(x, y), rng
    return RandomForestPredictor(n_trees=n_trees, max_depth=depth).fit(x, y), rng


@pytest.mark.parametrize("family,n_trees,depth,n_fit,rows", [
    ("gbdt", 1, 1, 50, 1), ("gbdt", 3, 2, 80, 7), ("gbdt", 130, 2, 200, 300),
    ("gbdt", 150, 4, 600, 4099), ("rf", 10, 14, 3000, 2048)])
def test_kernels_match_plain_versions(card, family, n_trees, depth, n_fit, rows):
    from repro_torch.kernels import tree_gather as tg
    from repro_torch.kernels import tree_gather_cuda as tgc

    model, rng = _fit(family, n_trees, depth, n_fit, 6, seed=rows)
    raw = np.abs(rng.standard_normal((rows, 6))) * np.linspace(1, 30, 6)
    db = model.flat().device_bank(card)
    xs = torch.from_numpy(model.scaler.transform(raw).astype(np.float32)).to(card)
    xr = torch.from_numpy(raw.astype(np.float32)).to(card)
    mean, std = tg.to_device_scaler(model.scaler, card)
    kind, scale, bias = model._device_reduction()

    before = tgc.launch_counts()
    leaves = tgc.gather_leaves_cuda(db, xs)
    fused = tgc.fused_predict_cuda(db, mean, std, scale, bias, xr, kind)
    torch.cuda.synchronize()
    after = tgc.launch_counts()
    assert after["tree_gather_leaves"] == before["tree_gather_leaves"] + 1
    assert after["tree_predict_fused"] == before["tree_predict_fused"] + 1

    assert torch.equal(leaves, tg.gather_leaves_plain(*db.bank_args, xs,
                                                      depth=db.depth))
    plain = tg.fused_plain(*db.bank_args, mean, std, scale, bias, xr,
                           depth=db.depth, kind=kind)
    lv = tg.gather_leaves_plain(*db.bank_args, (xr - mean) / std, depth=db.depth)
    s = lv.abs().sum(1).double() / (db.n_trees if kind == "mean" else 1)
    tol = 2 * db.n_trees * U32 * abs(scale) * s + 4 * U32 * plain.abs().double()
    assert bool(((fused.double() - plain.double()).abs() <= tol + 1e-30).all())
    again = tgc.fused_predict_cuda(db, mean, std, scale, bias, xr, kind)
    assert torch.equal(fused, again)                # no atomics: repeatable
    np.testing.assert_array_equal(
        tgc.predict_trees_cuda(model.flat(), model.scaler.transform(raw), card),
        leaves.cpu().numpy().astype(np.float64))


def test_wrappers_check_their_inputs(card):
    from repro_torch.kernels import tree_gather as tg
    from repro_torch.kernels import tree_gather_cuda as tgc

    model, rng = _fit("gbdt", 4, 2, 60, 6, seed=0)
    db = model.flat().device_bank(card)
    x = torch.zeros((8, 6), device=card)
    with pytest.raises(TypeError):
        tgc.gather_leaves_cuda(db, x.double())
    with pytest.raises(ValueError, match="contiguous"):
        tgc.gather_leaves_cuda(db, torch.zeros((6, 8), device=card).t())
    with pytest.raises(ValueError, match="lie on"):
        tgc.gather_leaves_cuda(db, x.cpu())
    with pytest.raises(ValueError, match="features"):
        tgc.gather_leaves_cuda(db, x[:, :0].contiguous())
    mean, std = tg.to_device_scaler(model.scaler, card)
    with pytest.raises(ValueError, match="shape"):
        tgc.fused_predict_cuda(db, mean[:3].contiguous(), std, 1.0, 0.0, x, "sum")
    assert tgc.gather_leaves_cuda(db, x[:0]).shape == (0, db.n_trees)


def test_service_serves_on_the_card(card):
    from repro_torch.core.dataset import synthetic_graphs
    from repro_torch.core.profiler import DeviceSetting
    from repro_torch.pipeline import LatencyService

    setting = DeviceSetting("h100_f32", "float32", "fused_groups", device="h100")
    graphs = synthetic_graphs(6, resolution=32)
    svc = LatencyService.build(graphs, setting, hparams={"n_stages": 10},
                               device=card)
    host = LatencyService(svc.hub, default_setting=setting, device="cpu")
    got = svc.predict_batch(graphs)
    assert set(svc.stats()["backend_runs"]) == {"cuda"}
    res = svc.stats()["device_residency"]
    assert res["banks"] == res["bank_uploads"] > 0
    want = host.predict_batch(graphs)     # re-uploads the banks to the host
    np.testing.assert_allclose([r.e2e_s for r in got], [r.e2e_s for r in want],
                               rtol=1e-5)


# -- int8 GEMM and Winograd ------------------------------------------------------

@pytest.mark.parametrize("m,k,n", [(1, 63, 252), (1, 1477, 1000), (64, 128, 64),
                                   (130, 27, 77), (3136, 79, 77), (12544, 96, 24)])
def test_int8_matmul_bit_equal_to_plain(card, m, k, n):
    from repro_torch.kernels import int8_matmul as im
    from repro_torch.kernels import int8_matmul_cuda as imc

    rng = np.random.default_rng(m + k + n)
    a = torch.from_numpy(rng.integers(-127, 128, (m, k)).astype(np.int8)).to(card)
    b = torch.from_numpy(rng.integers(-127, 128, (k, n)).astype(np.int8)).to(card)
    bias = torch.from_numpy(rng.integers(-999, 999, n).astype(np.int32)).to(card)
    bt = im.pack_weight(b)
    scale = im.out_scale(4.0 / 127.0 * (0.4 / 127.0) / (4.0 / 127.0), 1.0)
    before = imc.launch_counts()["int8_matmul"]
    got = imc.int8_matmul_cuda(a, bt, scale, bias)
    got2 = im.int8_matmul(a, b, 0.02, 0.05)
    torch.cuda.synchronize()
    assert imc.launch_counts()["int8_matmul"] == before + 2
    assert torch.equal(got, im.int8_matmul_plain(a, bt, scale, bias))
    assert torch.equal(got2, im.int8_matmul_plain(a, bt, im.out_scale(0.02, 0.05)))


def test_int8_wrapper_checks_its_inputs(card):
    from repro_torch.kernels import int8_matmul as im
    from repro_torch.kernels import int8_matmul_cuda as imc

    a = torch.zeros((4, 8), dtype=torch.int8, device=card)
    bt = im.pack_weight(torch.zeros((8, 5), dtype=torch.int8, device=card))
    with pytest.raises(TypeError):
        imc.int8_matmul_cuda(a.int(), bt, 1.0)
    with pytest.raises(ValueError, match="lie on"):
        imc.int8_matmul_cuda(a.cpu(), bt, 1.0)
    with pytest.raises(ValueError, match="contiguous"):
        imc.int8_matmul_cuda(torch.zeros((8, 4), dtype=torch.int8, device=card).t(),
                             bt, 1.0)
    with pytest.raises(ValueError, match="shape"):
        imc.int8_matmul_cuda(a, bt, 1.0, torch.zeros(4, dtype=torch.int32, device=card))
    with pytest.raises(ValueError, match="packs"):
        imc.int8_matmul_cuda(torch.zeros((4, 40), dtype=torch.int8, device=card), bt, 1.0)
    assert imc.int8_matmul_cuda(a[:0], bt, 1.0).shape == (0, 5)


WINO_TOL = 1e-5     # × max|plain|: float32 summation order only


@pytest.mark.parametrize("b,h,w,c,k", [(1, 8, 8, 16, 16), (2, 12, 12, 64, 64),
                                       (1, 7, 9, 16, 16), (1, 56, 56, 79, 77),
                                       (1, 14, 14, 256, 256), (3, 5, 3, 3, 5)])
def test_winograd_within_tolerance_of_plain(card, b, h, w, c, k):
    from repro_torch.kernels import ref
    from repro_torch.kernels import winograd_conv as wc
    from repro_torch.kernels import winograd_conv_cuda as wcc

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(h * w + c)
    x = torch.from_numpy(rng.standard_normal((b, h, w, c)).astype(np.float32)).to(card)
    wt = torch.from_numpy((rng.standard_normal((3, 3, c, k)) * 0.1)
                          .astype(np.float32)).to(card)
    u = wc.transform_weights(wt)
    tiles = ref.extract_winograd_tiles(x).reshape(-1, 16, c).contiguous()
    before = wcc.launch_counts()["winograd_conv2d"]
    got = wcc.winograd_tiles_cuda(tiles, u)
    y = wc.winograd_conv2d(x, wt)
    torch.cuda.synchronize()
    assert wcc.launch_counts()["winograd_conv2d"] == before + 2
    plain = wc.winograd_tiles_plain(tiles, u)
    assert float((got - plain).abs().max()) <= WINO_TOL * float(plain.abs().max())
    direct = ref.winograd_conv_ref(x, wt)
    assert y.shape == direct.shape
    assert float((y - direct).abs().max()) <= 1e-4 * float(direct.abs().max())
    assert torch.equal(got, wcc.winograd_tiles_cuda(tiles, u))   # repeatable


def test_winograd_wrapper_checks_its_inputs(card):
    from repro_torch.kernels import winograd_conv_cuda as wcc

    tiles = torch.zeros((10, 16, 8), device=card)
    u = torch.zeros((16, 8, 5), device=card)
    with pytest.raises(TypeError):
        wcc.winograd_tiles_cuda(tiles.double(), u)
    with pytest.raises(ValueError, match="lie on"):
        wcc.winograd_tiles_cuda(tiles, u.cpu())
    with pytest.raises(ValueError, match="contiguous"):
        wcc.winograd_tiles_cuda(torch.zeros((10, 8, 16), device=card).transpose(1, 2), u)
    with pytest.raises(ValueError, match="shape"):
        wcc.winograd_tiles_cuda(tiles, torch.zeros((16, 7, 5), device=card))
    assert wcc.winograd_tiles_cuda(tiles[:0], u).shape == (0, 4, 5)


@pytest.mark.parametrize("mode", ["op_by_op", "fused_groups"])
def test_int8_executor_card_equals_host(card, mode):
    from repro_torch.core.dataset import synthetic_graphs
    from repro_torch.core.executor import GraphExecutor
    from repro_torch.kernels import int8_matmul_cuda as imc

    g = synthetic_graphs(2, resolution=32)[1]
    host = GraphExecutor(g, mode=mode, dtype="int8", device="cpu")
    dev = GraphExecutor(g, mode=mode, dtype="int8", device=card)
    before = imc.launch_counts()["int8_matmul"]
    got = dev(*dev.example_inputs())
    torch.cuda.synchronize()
    assert imc.launch_counts()["int8_matmul"] > before
    want = host(*host.example_inputs())
    for a, b in zip(got, want):
        # Transcendental round trips may move an element by one step.
        d = (a.cpu().int() - b.int()).abs()
        assert int(d.max()) <= 1 and float((d > 0).float().mean()) <= 0.01
