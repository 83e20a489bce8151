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
