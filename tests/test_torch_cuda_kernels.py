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
import dataclasses

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
    model, rng = _fit(family, n_trees, depth, n_fit, 6, seed=rows)
    raw = np.abs(rng.standard_normal((rows, 6))) * np.linspace(1, 30, 6)
    _hold_tree_kernels(card, model, raw)


def _hold_tree_kernels(card, model, raw, route=None):
    """Both tree kernels on ``raw`` rows: one launch each (on ``route``
    when given), leaves bit-equal to the plain version, fused within the
    summation bound and repeatable."""
    from repro_torch.kernels import tree_gather as tg
    from repro_torch.kernels import tree_gather_cuda as tgc

    db = model.flat().device_bank(card)
    xs = torch.from_numpy(model.scaler.transform(raw).astype(np.float32)).to(card)
    xr = torch.from_numpy(raw.astype(np.float32)).to(card)
    mean, std = tg.to_device_scaler(model.scaler, card)
    kind, scale, bias = model._device_reduction()

    before, routes0 = tgc.launch_counts(), tgc.route_counts()
    leaves = tgc.gather_leaves_cuda(db, xs)
    fused = tgc.fused_predict_cuda(db, mean, std, scale, bias, xr, kind)
    torch.cuda.synchronize()
    after, routes1 = tgc.launch_counts(), tgc.route_counts()
    assert after["tree_gather_leaves"] == before["tree_gather_leaves"] + 1
    assert after["tree_predict_fused"] == before["tree_predict_fused"] + 1
    if route is not None:
        assert routes1[route] == routes0[route] + 2

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


@pytest.fixture(scope="module")
def gbdt_150x4(card):
    from repro_torch.core.dataset import FAST_HPARAMS
    from repro_torch.core.predictors import GBDTPredictor

    rng = np.random.default_rng(17)
    x = np.abs(rng.standard_normal((800, 16))) * np.linspace(1, 30, 16)
    y = x @ rng.random(16) + 0.1
    return GBDTPredictor(**FAST_HPARAMS["gbdt"]).fit(x, y)


@pytest.mark.parametrize("rows", [5, 527, 11437])
def test_tree_kernels_at_main_path_sizes(card, gbdt_150x4, rows):
    # The held-out scoring's smallest op type, and the 1,024-graph batch's
    # smallest and largest (pad and conv2d), on the staged route.
    rng = np.random.default_rng(rows)
    raw = np.abs(rng.standard_normal((rows, 16))) * np.linspace(1, 30, 16)
    _hold_tree_kernels(card, gbdt_150x4, raw, route="staged")


@pytest.mark.parametrize("side", [0, 1], ids=["at", "past"])
@pytest.mark.parametrize("edge", range(4))
@pytest.mark.parametrize("fused", [True, False], ids=["fused", "leaves"])
def test_tree_kernels_at_each_plan_crossover(card, gbdt_150x4, fused, edge, side):
    # Rows at each rows-an-SM crossover of the plan's tables and one past
    # it, where the threads a row change.
    from repro_torch.kernels import tree_gather_cuda as tgc

    n_sm = torch.cuda.get_device_properties(card).multi_processor_count
    table = tgc.FUSED_GROUPS if fused else tgc.LEAVES_GROUPS
    rows = int(table[edge][0] * n_sm) + side
    db = gbdt_150x4.flat().device_bank(card)
    assert tgc.plan_for(db, rows, 16, fused).groups == table[edge + side][1]
    rng = np.random.default_rng(rows)
    raw = np.abs(rng.standard_normal((rows, 16))) * np.linspace(1, 30, 16)
    _hold_tree_kernels(card, gbdt_150x4, raw, route="staged")


@pytest.mark.parametrize("rows", [1024, 2050, 11437])
def test_sharded_tree_flush_is_bit_equal_on_the_card(card, gbdt_150x4, rows):
    # A bank over the card listed 4 times: one launch a shard, each with
    # the unsharded flush's plan, so both kernels' outputs equal the
    # unsharded flush's bit for bit.
    from repro_torch.kernels import tree_gather as tg
    from repro_torch.kernels import tree_gather_cuda as tgc

    flat = gbdt_150x4.flat()
    whole = tg.CudaBank.from_flat(flat, card, devices=[card])
    sharded = tg.CudaBank.from_flat(flat, card, devices=[card] * 4)
    mean, std = tg.to_device_scaler(gbdt_150x4.scaler, card)
    kind, scale, bias = gbdt_150x4._device_reduction()
    rng = np.random.default_rng(rows)
    raw = np.abs(rng.standard_normal((rows, 16))) * np.linspace(1, 30, 16)
    xs = gbdt_150x4.scaler.transform(raw)
    tgc.reset_launch_counts()
    got_f = sharded.fused(mean, std, scale, bias, sharded.stage_input(raw), kind)
    got_l = sharded.gather_leaves(sharded.stage_input(xs))
    assert tgc.launch_counts() == {"tree_gather_leaves": 4, "tree_predict_fused": 4}
    assert torch.equal(got_f, whole.fused(mean, std, scale, bias, whole.stage_input(raw),
                                          kind))
    assert torch.equal(got_l, whole.gather_leaves(whole.stage_input(xs)))
    assert sharded.stats()["uploads"] == 1


@pytest.mark.parametrize("rows", [5, 2048])
def test_tree_kernels_on_the_packed_route(card, rows):
    model, rng = _fit("rf", 10, 14, 3000, 6, seed=rows)
    assert model.flat().device_bank(card).cnodes is None
    raw = np.abs(rng.standard_normal((rows, 6))) * np.linspace(1, 30, 6)
    _hold_tree_kernels(card, model, raw, route="packed")


def test_tree_bank_keeps_one_layout_and_the_other_route_raises(card, gbdt_150x4):
    from repro_torch.kernels import tree_gather_cuda as tgc

    deep, _ = _fit("rf", 10, 14, 3000, 6, seed=3)
    for model, kept, other in ((gbdt_150x4, "staged", "packed"),
                               (deep, "packed", "staged")):
        db = model.flat().device_bank(card)
        assert (db.nodes is None) == (kept == "staged")
        assert (db.cnodes is None) == (kept == "packed")
        x = torch.zeros((8, 16), device=card)
        pl = dataclasses.replace(tgc.plan_for(db, 8, 16, False), route=other)
        before = tgc.launch_counts()
        with pytest.raises(ValueError, match=f"the {other} route"):
            tgc.launch_leaves(db, x, pl)
        assert tgc.launch_counts() == before


def test_tree_complete_layout_on_the_card_equals_the_host_build(card, gbdt_150x4):
    from repro_torch.kernels import tree_gather as tg

    db = gbdt_150x4.flat().device_bank(card)
    nodes, leaves = tg.complete_layout(*(a.cpu() for a in db.bank_args),
                                       depth=db.depth)
    assert torch.equal(db.cnodes.cpu(), nodes)
    assert torch.equal(db.cleaves.cpu(), leaves)
    assert db.cnodes.data_ptr() % 16 == 0 and db.cleaves.data_ptr() % 16 == 0


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


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "leaves"])
def test_tree_launch_refused_by_its_plan_does_not_fail_the_next(card, gbdt_150x4, fused):
    """A plan asking for more shared memory than the card grants (1 MiB)
    makes the launch raise; the next launch on the same thread runs, since
    the refused opt-in's error is cleared."""
    from repro_torch.kernels import tree_gather as tg
    from repro_torch.kernels import tree_gather_cuda as tgc

    rng = np.random.default_rng(3)
    raw = np.abs(rng.standard_normal((527, 16))) * np.linspace(1, 30, 16)
    db = gbdt_150x4.flat().device_bank(card)
    xr = torch.from_numpy(raw.astype(np.float32)).to(card)
    mean, std = tg.to_device_scaler(gbdt_150x4.scaler, card)
    kind, scale, bias = gbdt_150x4._device_reduction()
    xs = (xr - mean) / std
    pl = tgc.plan_for(db, len(raw), 16, fused)
    bad = dataclasses.replace(pl, smem_bytes=1 << 20)
    name = "tree_predict_fused" if fused else "tree_gather_leaves"
    run = ((lambda p: tgc.launch_fused(db, mean, std, scale, bias, xr, kind, p))
           if fused else (lambda p: tgc.launch_leaves(db, xs, p)))
    with pytest.raises(RuntimeError, match=f"{name} launch failed"):
        run(bad)
    got = run(pl)
    torch.cuda.synchronize()
    assert torch.equal(got, run(pl))
    if not fused:
        assert torch.equal(got, tg.gather_leaves_plain(*db.bank_args, xs, depth=db.depth))


def test_rpc_flushes_launch_on_the_batcher_thread(card):
    """Predicts sent over a socket flush on the batcher's daemon thread,
    whose launches run the fused kernel on the card."""
    from repro_torch.core.dataset import synthetic_graphs
    from repro_torch.core.profiler import DeviceSetting
    from repro_torch.kernels import tree_gather_cuda as tgc
    from repro_torch.pipeline import LatencyService
    from repro_torch.rpc import LatencyClient, LatencyRPCServer

    setting = DeviceSetting("h100_f32", "float32", "fused_groups", device="h100")
    graphs = synthetic_graphs(6, resolution=32)
    svc = LatencyService.build(graphs, setting, hparams={"n_stages": 10}, device=card)
    server = LatencyRPCServer(svc)
    host, port = server.start()
    before = tgc.launch_counts()["tree_predict_fused"]
    try:
        with LatencyClient(host, port, timeout=60.0) as c:
            got = c.predict_pipelined(synthetic_graphs(8, resolution=32, seed0=900))
        st = server.batcher.stats()
    finally:
        server.stop()
    assert len(got) == 8 and all(r.e2e_s > 0 for r in got)
    assert set(st["flush_backends"]) == {"cuda"} and st["answered"] == 8
    assert tgc.launch_counts()["tree_predict_fused"] > before


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


# The 13 GEMMs (m, k, n) of one int8 forward of the main path's held-out
# graph (`synthetic_graphs(40, resolution=224)[32]`, chip_smoke's
# `gemm_shapes`).
INT8_MAIN_SHAPES = [(12544, 3, 72), (12544, 72, 19), (3136, 19, 70), (1, 70, 17),
                    (1, 17, 70), (3136, 70, 49), (784, 441, 38), (784, 38, 201),
                    (196, 201, 170), (196, 170, 183), (49, 183, 289),
                    (49, 289, 1580), (1, 1580, 1000)]


def _int8_case(card, m, k, n, seed, lda=None):
    """A (m, k) as a view of an (m, lda) buffer when lda is given, packed
    weight, bias and scale."""
    from repro_torch.kernels import int8_matmul as im

    rng = np.random.default_rng(seed)
    a = torch.from_numpy(rng.integers(-127, 128, (m, k)).astype(np.int8)).to(card)
    if lda is not None:
        buf = torch.from_numpy(rng.integers(-127, 128, (m, lda)).astype(np.int8)).to(card)
        buf[:, :k] = a
        a = buf[:, :k]
    b = torch.from_numpy(rng.integers(-127, 128, (k, n)).astype(np.int8)).to(card)
    bias = torch.from_numpy(rng.integers(-999, 999, n).astype(np.int32)).to(card)
    scale = im.out_scale(4.0 / 127.0 * (0.4 / 127.0) / (4.0 / 127.0), 1.0)
    return a, im.pack_weight(b), bias, scale


@pytest.mark.parametrize("m,k,n", [(1, 1580, 1000), (784, 441, 38)])
def test_int8_split_k_route_is_bit_equal(card, m, k, n):
    from repro_torch.kernels import int8_matmul as im
    from repro_torch.kernels import int8_matmul_cuda as imc

    assert imc.plan(m, n, k).splits > 1
    a, bt, bias, scale = _int8_case(card, m, k, n, seed=k)
    before = imc.route_counts()
    got = imc.int8_matmul_cuda(a, bt, scale, bias)
    again = imc.int8_matmul_cuda(a, bt, scale, bias)
    torch.cuda.synchronize()
    assert imc.route_counts()["split_k"] == before["split_k"] + 2
    assert imc.route_counts()["one_pass"] == before["one_pass"]
    assert torch.equal(got, im.int8_matmul_plain(a, bt, scale, bias))
    assert torch.equal(got, again)     # the cluster reduction is deterministic


@pytest.mark.parametrize("m,k,n", INT8_MAIN_SHAPES + [(7, 1477, 13), (4099, 131, 65)])
def test_int8_row_strided_a_is_bit_equal_to_its_contiguous_copy(card, m, k, n):
    from repro_torch.kernels import int8_matmul as im
    from repro_torch.kernels import int8_matmul_cuda as imc

    lda = -(-k // 16) * 16 + 16
    a, bt, bias, scale = _int8_case(card, m, k, n, seed=m + k, lda=lda)
    assert a.stride() == (lda, 1)
    # The contiguous copy starts 4 bytes past an aligned base: never the
    # cp.async route.
    copy = torch.empty(m * k + 4, dtype=torch.int8, device=card)[4:].view(m, k)
    copy.copy_(a)
    before = imc.route_counts()
    strided = imc.int8_matmul_cuda(a, bt, scale, bias)
    dense = imc.int8_matmul_cuda(copy, bt, scale, bias)
    torch.cuda.synchronize()
    after = imc.route_counts()
    assert after["a_cp_async"] == before["a_cp_async"] + 1
    assert after["a_words"] == before["a_words"] + 1
    assert torch.equal(strided, dense)
    assert torch.equal(strided, im.int8_matmul_plain(a, bt, scale, bias))


def test_int8_wrapper_checks_the_row_stride(card):
    from repro_torch.kernels import int8_matmul as im
    from repro_torch.kernels import int8_matmul_cuda as imc

    bt = im.pack_weight(torch.zeros((8, 5), dtype=torch.int8, device=card))
    buf = torch.zeros((6, 32), dtype=torch.int8, device=card)
    with pytest.raises(ValueError, match="contiguous"):
        imc.int8_matmul_cuda(buf[:, ::4], bt, 1.0)          # column stride 4
    with pytest.raises(ValueError, match="stride"):
        imc.int8_matmul_cuda(buf.view(-1)[:40].as_strided((5, 8), (4, 1)), bt, 1.0)
    with pytest.raises(ValueError, match="pack_weight"):
        imc.int8_matmul_cuda(buf[:, :8], torch.zeros((5, 8), dtype=torch.int8,
                                                      device=card), 1.0)
    assert imc.int8_matmul_cuda(buf[:, :8], bt, 1.0).shape == (6, 5)


def test_winograd_position_split_is_repeatable_at_256_channels_14x14(card):
    from repro_torch.kernels import ref
    from repro_torch.kernels import winograd_conv as wc
    from repro_torch.kernels import winograd_conv_cuda as wcc

    rng = np.random.default_rng(14)
    x = torch.from_numpy(rng.standard_normal((1, 14, 14, 256)).astype(np.float32)).to(card)
    wt = torch.from_numpy((rng.standard_normal((3, 3, 256, 256)) * 0.1)
                          .astype(np.float32)).to(card)
    u = wc.transform_weights(wt)
    tiles = ref.extract_winograd_tiles(x).reshape(-1, 16, 256).contiguous()
    pl = wcc.plan(tiles.shape[0], 256, 256)
    assert pl.blocks >= wcc.SMS
    before = wcc.route_counts()
    runs = [wcc.winograd_tiles_cuda(tiles, u) for _ in range(3)]
    torch.cuda.synchronize()
    assert wcc.route_counts()[pl.route] == before[pl.route] + 3
    assert all(torch.equal(runs[0], r) for r in runs[1:])
    plain = wc.winograd_tiles_plain(tiles, u)
    assert float((runs[0] - plain).abs().max()) <= WINO_TOL * float(plain.abs().max())


def test_winograd_past_two_to_the_twenty_tiles_runs_in_bounded_workspace(card):
    # 1 × 2,050 × 2,050 × 1 has 1,025² = 1,050,625 tiles: more than 65,535
    # blocks of 16 tiles hold, and three runs of the 32 MiB workspace.
    from repro_torch.kernels import ref
    from repro_torch.kernels import winograd_conv as wc
    from repro_torch.kernels import winograd_conv_cuda as wcc

    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(2050)
    x = torch.from_numpy(rng.standard_normal((1, 2050, 2050, 1)).astype(np.float32)).to(card)
    wt = torch.from_numpy((rng.standard_normal((3, 3, 1, 1)) * 0.1)
                          .astype(np.float32)).to(card)
    u = wc.transform_weights(wt)
    tiles = ref.extract_winograd_tiles(x).reshape(-1, 16, 1).contiguous()
    t = tiles.shape[0]
    pl = wcc.plan(t, 1, 1)
    assert t == 1025 * 1025 > 2**20 and -(-t // pl.t_pass) == 3
    got = wcc.winograd_tiles_cuda(tiles, u)
    plain = wc.winograd_tiles_plain(tiles, u)
    assert float((got - plain).abs().max()) <= WINO_TOL * float(plain.abs().max())
    assert torch.equal(got, wcc.winograd_tiles_cuda(tiles, u))   # repeatable
    y = wc.winograd_conv2d(x, wt)
    direct = ref.winograd_conv_ref(x, wt)
    assert float((y - direct).abs().max()) <= 1e-4 * float(direct.abs().max())


def test_int8_rows_past_the_grid_y_limit_are_bit_equal(card):
    # 65,535 row tiles of 64 rows is 4,194,240: one more row needs the
    # output tiles on the grid's x axis.
    from repro_torch.kernels import int8_matmul as im
    from repro_torch.kernels import int8_matmul_cuda as imc

    m, k, n = 65535 * 64 + 1, 3, 5
    pl = imc.plan(m, n, k)
    assert -(-m // pl.bm) > 65535
    a, bt, bias, scale = _int8_case(card, m, k, n, seed=7)
    got = imc.int8_matmul_cuda(a, bt, scale, bias)
    assert torch.equal(got, im.int8_matmul_plain(a, bt, scale, bias))


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


# -- flash attention and MoE GMM -------------------------------------------------

# Kernel against its plain version: float32 1e-5 × max|plain| (float32 sums
# in another order); bfloat16 2e-2 × max|plain| (both round the float32
# result once, so they differ by at most one bfloat16 step; the flash
# kernel also rounds its probabilities to bfloat16 before P·V, which
# tests/test_torch_flash_attention.py bounds with the output's rounding
# at 5e-3).
LM_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
# bfloat16 flash also row by row (each query row's max |err| over its own
# max |plain|): causal outputs shrink as 1/sqrt(row), so the whole-output
# scale would let a fault in the late key tiles pass.  One bfloat16 step
# is at most 2^-7 of a row's largest value; the limit allows two.
ROW_TOL = 1.6e-2


def _close(got, want, dtype):
    assert got.dtype == want.dtype == dtype and got.shape == want.shape
    scale = max(float(want.float().abs().max()), 1e-30)
    assert float((got.float() - want.float()).abs().max()) <= LM_TOL[dtype] * scale


def _rows_close(got, want):
    g, w = got.float(), want.float()
    rel = (g - w).abs().amax(-1) / w.abs().amax(-1).clamp_min(1e-30)
    assert float(rel.max()) <= ROW_TOL


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,h,kvh,d,causal", [
    (2, 256, 16, 8, 64, True), (1, 1000, 4, 2, 64, True), (2, 77, 4, 4, 32, False),
    (1, 33, 8, 1, 128, True), (3, 5, 2, 2, 16, False), (1, 1, 4, 2, 64, True),
    (1, 300, 32, 32, 64, True)])
def test_flash_attention_within_tolerance_of_plain(card, dtype, b, s, h, kvh, d, causal):
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_attention_cuda as fac

    rng = np.random.default_rng(s + h + d)
    q, k, v = (torch.from_numpy(rng.standard_normal((b, s, n, d)).astype(np.float32))
               .to(card, dtype) for n in (h, kvh, kvh))
    before = fac.launch_counts()["flash_attention"]
    got = fa.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert fac.launch_counts()["flash_attention"] == before + 1
    _close(got, fa.flash_attention_plain(q, k, v, causal=causal), dtype)
    assert torch.equal(got, fac.flash_attention_cuda(q, k, v, causal=causal))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("e,c,d,f", [(32, 32, 1024, 512), (32, 1280, 1024, 512),
                                     (32, 32, 512, 1024), (3, 33, 70, 17),
                                     (1, 1, 5, 3)])
def test_moe_gmm_within_tolerance_of_plain(card, dtype, e, c, d, f):
    from repro_torch.kernels import moe_gmm as gmm
    from repro_torch.kernels import moe_gmm_cuda as gmmc

    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(e + c + d + f)
    x = torch.from_numpy(rng.standard_normal((e, c, d)).astype(np.float32)).to(card, dtype)
    w = torch.from_numpy((rng.standard_normal((e, d, f)) / np.sqrt(d))
                         .astype(np.float32)).to(card, dtype)
    before = gmmc.launch_counts()["moe_gmm"]
    got = gmm.moe_gmm(x, w)
    torch.cuda.synchronize()
    assert gmmc.launch_counts()["moe_gmm"] == before + 1
    _close(got, gmm.moe_gmm_plain(x, w), dtype)


def _bf16(rng, shape, scale=1.0):
    return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32))


@pytest.mark.parametrize("d", [16, 32, 64, 128])
@pytest.mark.parametrize("rep", [1, 2, 8])
@pytest.mark.parametrize("sq,skv,q_offset,causal", [
    (200, 200, 0, True), (77, 333, 256, True), (100, 130, 0, False),
    (64, 64, 0, True)])
def test_flash_bf16_takes_the_tensor_core_kernel(card, d, rep, sq, skv, q_offset,
                                                 causal):
    """Every head dim, GQA groups of 1, 2 and 8, a ragged sq and skv, and a
    query block at q_offset > 0 over a longer key sequence: within the
    bfloat16 tolerance of the plain version, over the whole output and row
    by row, repeatable, and launched on the tensor-core route."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_attention_cuda as fac

    rng = np.random.default_rng(d + rep + sq + skv)
    q = _bf16(rng, (2, sq, 2 * rep, d)).to(card, torch.bfloat16)
    k, v = (_bf16(rng, (2, skv, 2, d)).to(card, torch.bfloat16) for _ in range(2))
    before = fac.route_counts()
    got = fa.flash_attention(q, k, v, causal=causal, q_offset=q_offset)
    again = fac.flash_attention_cuda(q, k, v, causal=causal, q_offset=q_offset)
    torch.cuda.synchronize()
    after = fac.route_counts()
    assert after["bf16_mma"] == before["bf16_mma"] + 2
    assert after["f32_simt"] == before["f32_simt"]
    want = fa.flash_attention_plain(q, k, v, causal=causal, q_offset=q_offset)
    _close(got, want, torch.bfloat16)
    _rows_close(got, want)
    assert torch.equal(got, again)


@pytest.mark.parametrize("e,c,d,f", [
    (32, 1, 1024, 512), (32, 32, 1024, 512), (32, 64, 1024, 512),
    (32, 1, 512, 1024), (32, 32, 512, 1024), (32, 64, 512, 1024),
    (5, 77, 300, 129), (2, 200, 64, 40), (4, 65, 136, 72), (3, 5, 9, 7)])
def test_moe_gmm_bf16_takes_the_tensor_core_kernel(card, e, c, d, f):
    """Decode rows (1, 32, 64) at both decode widths, prefill-sized rows,
    and depth and columns that are not multiples of 8: within the bfloat16
    tolerance of the plain version, repeatable, on the tensor-core route."""
    from repro_torch.kernels import moe_gmm as gmm
    from repro_torch.kernels import moe_gmm_cuda as gmmc

    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(e * c + d + f)
    x = _bf16(rng, (e, c, d)).to(card, torch.bfloat16)
    w = _bf16(rng, (e, d, f), 1.0 / np.sqrt(d)).to(card, torch.bfloat16)
    before = gmmc.route_counts()
    got = gmm.moe_gmm(x, w)
    again = gmmc.moe_gmm_cuda(x, w)
    torch.cuda.synchronize()
    after = gmmc.route_counts()
    assert after["bf16_mma"] == before["bf16_mma"] + 2
    assert after["f32_simt"] == before["f32_simt"]
    _close(got, gmm.moe_gmm_plain(x, w), torch.bfloat16)
    assert torch.equal(got, again)


@pytest.mark.parametrize("operand", ["x", "w"])
def test_moe_gmm_bf16_operand_off_16_byte_alignment(card, operand):
    """An operand 2 bytes past a 16-byte boundary fills shared memory by
    element loads instead of cp.async; the result is the same function."""
    from repro_torch.kernels import moe_gmm as gmm
    from repro_torch.kernels import moe_gmm_cuda as gmmc

    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(7)
    ops = {"x": _bf16(rng, (3, 40, 64)).to(card, torch.bfloat16),
           "w": _bf16(rng, (3, 64, 96), 0.125).to(card, torch.bfloat16)}
    t = ops[operand]
    flat = torch.empty(t.numel() + 1, dtype=torch.bfloat16, device=card)
    shifted = flat[1:].view(t.shape)
    shifted.copy_(t)
    assert shifted.data_ptr() % 16 == 2 and shifted.is_contiguous()
    want = gmm.moe_gmm_plain(ops["x"], ops["w"])
    ops[operand] = shifted
    got = gmmc.moe_gmm_cuda(ops["x"], ops["w"])
    _close(got, want, torch.bfloat16)
    assert torch.equal(got, gmmc.moe_gmm_cuda(ops["x"], ops["w"]))


def test_float32_takes_the_simt_kernels(card):
    """float32 stays on the CUDA-core kernels of both modules."""
    from repro_torch.kernels import flash_attention_cuda as fac
    from repro_torch.kernels import moe_gmm_cuda as gmmc

    q = torch.zeros((1, 70, 4, 64), device=card)
    kv = torch.zeros((1, 70, 2, 64), device=card)
    x, w = torch.zeros((2, 33, 64), device=card), torch.zeros((2, 64, 48), device=card)
    before = (fac.route_counts(), gmmc.route_counts())
    fac.flash_attention_cuda(q, kv, kv)
    gmmc.moe_gmm_cuda(x, w)
    torch.cuda.synchronize()
    for mod, was in zip((fac, gmmc), before):
        now = mod.route_counts()
        assert now["f32_simt"] == was["f32_simt"] + 1
        assert now["bf16_mma"] == was["bf16_mma"]


def test_lm_wrappers_check_their_inputs(card):
    from repro_torch.kernels import flash_attention_cuda as fac
    from repro_torch.kernels import moe_gmm_cuda as gmmc
    from repro_torch.models import attention

    q = torch.zeros((1, 8, 4, 64), device=card)
    kv = torch.zeros((1, 8, 2, 64), device=card)
    with pytest.raises(TypeError):
        fac.flash_attention_cuda(q.double(), kv.double(), kv.double())
    with pytest.raises(ValueError, match="head dim"):
        fac.flash_attention_cuda(q[..., :48].contiguous(), kv[..., :48].contiguous(),
                                 kv[..., :48].contiguous())
    with pytest.raises(ValueError, match="shape"):
        fac.flash_attention_cuda(q, kv, kv[:, :4].contiguous())
    with pytest.raises(ValueError, match="softcap"):
        attention.naive_attention(q, kv, kv, window=-1)
    with pytest.raises(ValueError, match="softcap"):
        attention.chunked_attention(q, kv, kv, logit_softcap=float("inf"))
    with pytest.raises(ValueError, match="hides every key"):
        fac.flash_attention_cuda(q, kv, kv, causal=False, window=4, q_offset=20)
    x = torch.zeros((2, 4, 8), device=card)
    with pytest.raises(TypeError):
        gmmc.moe_gmm_cuda(x, torch.zeros((2, 8, 3), device=card, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="lie on"):
        gmmc.moe_gmm_cuda(x, torch.zeros((2, 8, 3)))


# (b, sq, skv, h, kvh, d, causal, q_offset, window, softcap): gemma2's
# local and global layers (reduced heads), a window (8, 100) that is not a
# multiple of the 64-key tile, so the late rows of a query tile start on
# wholly hidden key tiles, a window under a query block at q_offset > 0,
# the VLM's and Whisper's cross-attention (sq != skv, non-causal) and a
# non-causal window.
FLASH_MASK_CASES = [
    (1, 700, 700, 4, 2, 128, True, 0, 256, 50.0),
    (1, 700, 700, 4, 2, 128, True, 0, 0, 50.0),
    (2, 1000, 1000, 4, 2, 64, True, 0, 100, 5.0),
    (1, 300, 300, 2, 1, 64, True, 0, 8, 0.0),
    (1, 77, 333, 8, 2, 32, True, 256, 100, 0.0),
    (2, 130, 70, 8, 1, 128, False, 0, 0, 0.0),
    (4, 1, 300, 4, 4, 64, False, 0, 0, 0.0),
    (1, 160, 160, 4, 4, 16, False, 0, 40, 5.0)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,sq,skv,h,kvh,d,causal,q_offset,window,cap", FLASH_MASK_CASES)
def test_flash_window_and_softcap_within_tolerance_of_plain(
        card, dtype, b, sq, skv, h, kvh, d, causal, q_offset, window, cap):
    """Window, softcap and sq != skv on both routes: within the type's
    tolerance of the plain version (bfloat16 also row by row, where a late
    row's uncleared hidden tile shows), repeatable, one launch each on the
    type's route."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_attention_cuda as fac

    rng = np.random.default_rng(sq + skv + window + d)
    q = (3 * _bf16(rng, (b, sq, h, d))).to(card, dtype)
    k, v = (_bf16(rng, (b, skv, kvh, d)).to(card, dtype) for _ in range(2))
    kw = dict(causal=causal, q_offset=q_offset, window=window, softcap=cap)
    before = fac.route_counts()
    got = fa.flash_attention(q, k, v, **kw)
    again = fac.flash_attention_cuda(q, k, v, **kw)
    torch.cuda.synchronize()
    route = fac.ROUTES[dtype][1]
    after = fac.route_counts()
    assert {r: after[r] - before[r] for r in after} == \
        {r: 2 if r == route else 0 for r in after}
    want = fa.flash_attention_plain(q, k, v, **kw)
    _close(got, want, dtype)
    if dtype == torch.bfloat16:
        _rows_close(got, want)
    assert torch.equal(got, again)


@pytest.mark.parametrize("arch", ["gemma2-27b", "llama-3.2-vision-90b",
                                  "whisper-large-v3"])
def test_reduced_zoo_on_the_card_equals_the_host_port(card, arch):
    """gemma2 (window 64, 160 tokens), the VLM (gates 0.7) and Whisper in
    float32: forward and four decode steps on the card, every attention
    call but decode's self-attention through the flash kernel, against
    the port on the host."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels import flash_attention_cuda as fac
    from repro_torch.models import build_model, encdec, transformer

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_arch(arch).reduced(), compute_dtype="float32")
    m = build_model(cfg)

    def init():
        p = m.init(3, device="cpu")
        with torch.no_grad():
            for cp in p["cross_layers"] if cfg.cross_attn_every else ():
                cp["gate"].fill_(0.7)
        return p

    dev, host = init().to(card), init()
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 160)).astype(np.int64))
    extra = {}
    if cfg.family == "vlm":
        extra["vision_embeds"] = torch.from_numpy(
            rng.standard_normal((2, cfg.vision_seq, cfg.d_model)).astype(np.float32))
    if cfg.family == "encdec":
        extra["frames"] = torch.from_numpy(
            rng.standard_normal((2, cfg.encoder_seq, cfg.d_model)).astype(np.float32))
    fac.reset_launch_counts()
    got = m.forward(dev, {"tokens": toks.to(card),
                          **{k: v.to(card) for k, v in extra.items()}})
    torch.cuda.synchronize()
    calls = {"dense": cfg.num_layers, "vlm": cfg.num_layers,
             "encdec": cfg.encoder_layers + 2 * cfg.num_layers}[cfg.family]
    assert fac.launch_counts()["flash_attention"] == calls
    want = m.forward(host, {"tokens": toks, **extra})
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=1e-4, atol=1e-4)
    if cfg.family == "encdec":
        ex_d = {"memory": encdec.encode(dev, extra["frames"].to(card), cfg)}
        ex_h = {"memory": encdec.encode(host, extra["frames"], cfg)}
        cd = encdec.init_encdec_cache(cfg, 2, 16, "float32", device=card)
        ch = encdec.init_encdec_cache(cfg, 2, 16, "float32", device="cpu")
    else:
        ex_d = {k: v.to(card) for k, v in extra.items()}
        ex_h = extra
        cd = transformer.init_cache(cfg, 2, 16, "float32", device=card)
        ch = transformer.init_cache(cfg, 2, 16, "float32", device="cpu")
    for t in range(4):
        a, cd = m.decode_step(dev, {"token": toks[:, t:t + 1].to(card), **ex_d}, cd)
        b, ch = m.decode_step(host, {"token": toks[:, t:t + 1], **ex_h}, ch)
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "qwen2-72b"])
def test_reduced_lm_on_the_card_equals_the_host_port(card, arch):
    """Forward and decode in float32 on the card, through both kernels,
    against the port's plain versions on the host."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.kernels import flash_attention_cuda as fac
    from repro_torch.kernels import moe_gmm_cuda as gmmc
    from repro_torch.models import build_model, transformer

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_arch(arch).reduced(), compute_dtype="float32")
    m = build_model(cfg)
    host = m.init(3, device="cpu")
    dev = host.to(card)
    host = m.init(3, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 100)).astype(np.int64))
    fac.reset_launch_counts()
    gmmc.reset_launch_counts()
    got = m.forward(dev, {"tokens": toks.to(card)})
    torch.cuda.synchronize()
    assert fac.launch_counts()["flash_attention"] == cfg.num_layers
    assert gmmc.launch_counts()["moe_gmm"] == (3 * cfg.num_layers if cfg.num_experts else 0)
    want = m.forward(host, {"tokens": toks})
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=1e-4, atol=1e-4)
    cd = transformer.init_cache(cfg, 2, 16, "float32", device=card)
    ch = transformer.init_cache(cfg, 2, 16, "float32", device="cpu")
    for t in range(4):
        a, cd = m.decode_step(dev, {"token": toks[:, t:t + 1].to(card)}, cd)
        b, ch = m.decode_step(host, {"token": toks[:, t:t + 1]}, ch)
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), rtol=1e-4, atol=1e-4)


# -- SSD inter-chunk scan and the SSM / hybrid LMs -------------------------------

# (nc, b, h, p, n): Mamba2 2.7B's and Zamba2 1.2B's forward on 2 × 4,096
# tokens, an odd b·h with a p·n that is not a multiple of 4, one chunk.
SSD_SHAPES = [(16, 2, 80, 64, 128), (16, 2, 64, 64, 64), (3, 1, 3, 5, 7),
              (1, 2, 4, 8, 16)]


def _ssd_inputs(shape, card, dtype, decay_dtype, seed):
    rng = np.random.default_rng(seed)
    s = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    d = torch.from_numpy(rng.uniform(0.3, 1.0, shape[:3]).astype(np.float32))
    return s.to(card, dtype), d.to(card, decay_dtype)


@pytest.mark.parametrize("dtype,decay_dtype", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.float32),
    (torch.bfloat16, torch.bfloat16)])
@pytest.mark.parametrize("shape", SSD_SHAPES, ids=str)
def test_ssd_scan_bit_equal_to_plain(card, shape, dtype, decay_dtype):
    """The same float32 multiply, then add, per chunk (never an FMA), and
    one rounding to the output type: bit-equal."""
    from repro_torch.kernels import ssd_scan as ss
    from repro_torch.kernels import ssd_scan_cuda as ssc

    s, d = _ssd_inputs(shape, card, dtype, decay_dtype, seed=sum(shape))
    before = ssc.launch_counts()["ssd_scan"]
    hp, hf = ss.ssd_scan(s, d)
    torch.cuda.synchronize()
    assert ssc.launch_counts()["ssd_scan"] == before + 1
    want = ss.ssd_scan_plain(s, d)
    assert hp.dtype == hf.dtype == dtype
    assert torch.equal(hp, want[0]) and torch.equal(hf, want[1])


def test_ssd_scan_unaligned_operand_takes_the_scalar_kernel(card):
    from repro_torch.kernels import ssd_scan as ss
    from repro_torch.kernels import ssd_scan_cuda as ssc

    s, d = _ssd_inputs((5, 1, 2, 4, 8), card, torch.float32, torch.float32, seed=1)
    flat = torch.empty(s.numel() + 1, device=card)
    shifted = flat[1:].view(s.shape)            # 4 bytes off a 16-byte boundary
    shifted.copy_(s)
    got = ssc.ssd_scan_cuda(shifted, d)
    want = ss.ssd_scan_plain(s, d)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_ssd_scan_wrapper_checks_its_inputs(card):
    from repro_torch.kernels import ssd_scan_cuda as ssc

    s = torch.zeros((2, 1, 3, 4, 4), device=card)
    d = torch.ones((2, 1, 3), device=card)
    with pytest.raises(TypeError):
        ssc.ssd_scan_cuda(s.double(), d)
    with pytest.raises(TypeError):
        ssc.ssd_scan_cuda(s, d.half())
    with pytest.raises(ValueError, match="contiguous"):
        ssc.ssd_scan_cuda(s.transpose(3, 4), d)
    with pytest.raises(ValueError, match="shape"):
        ssc.ssd_scan_cuda(s, d[:, :, :2].contiguous())
    with pytest.raises(ValueError, match="lie on"):
        ssc.ssd_scan_cuda(s.cpu(), d.cpu())
    with pytest.raises(ValueError, match="lie on"):
        ssc.ssd_scan_cuda(s, d.cpu())
    hp, hf = ssc.ssd_scan_cuda(s[:, :, :0].contiguous(), d[:, :, :0].contiguous())
    assert hp.shape == (2, 1, 0, 4, 4) and hf.shape == (1, 0, 4, 4)


# The scan's backward: Mamba2's and Zamba2's training calls (4 × 1,024
# tokens, chunk 256), one chunk, and a p·n that is not a multiple of 4.
SSD_BWD_SHAPES = [(4, 4, 80, 64, 128), (4, 4, 64, 64, 64), (1, 2, 4, 8, 16),
                  (3, 1, 3, 5, 7)]


def _ddecay_close(got, want, ds, h_prev, decay_dtype):
    """ddecay within the bound of a float32 sum of P·N products in any
    order (2·(P·N)·u·Σ|ds·h_prev|), plus one rounding of a bfloat16 decay."""
    pn = h_prev.shape[-1] * h_prev.shape[-2]
    scale = (ds.double().abs() * h_prev.double().abs()).sum((-2, -1))
    w = want.double()
    tol = 2 * pn * U32 * scale + 1e-30
    if decay_dtype == torch.bfloat16:
        tol = tol + 2.0 ** -8 * w.abs()
    assert bool(((got.double() - w).abs() <= tol).all())


@pytest.mark.parametrize("final", [False, True], ids=["no_final", "final"])
@pytest.mark.parametrize("dtype,decay_dtype", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.float32),
    (torch.bfloat16, torch.bfloat16)])
@pytest.mark.parametrize("shape", SSD_BWD_SHAPES, ids=str)
def test_ssd_scan_backward_matches_plain(card, shape, dtype, decay_dtype, final):
    """ds bit-equal to `ssd_scan_backward_plain` (the same float32 multiply,
    then add, per chunk), ddecay within its sum bound, both repeatable."""
    from repro_torch.kernels import ssd_scan as ss
    from repro_torch.kernels import ssd_scan_cuda as ssc

    s, d = _ssd_inputs(shape, card, dtype, decay_dtype, seed=sum(shape) + 1)
    hp, hf = ss.ssd_scan_plain(s, d)
    rng = np.random.default_rng(sum(shape) + 2)
    gp = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(card, dtype)
    gf = (torch.from_numpy(rng.standard_normal(shape[1:]).astype(np.float32))
          .to(card, dtype) if final else None)
    before = ssc.launch_counts()["ssd_scan_backward"]
    ds, dd = ssc.ssd_scan_backward_cuda(gp, gf, hp, d)
    torch.cuda.synchronize()
    assert ssc.launch_counts()["ssd_scan_backward"] == before + 1
    want_ds, want_dd = ss.ssd_scan_backward_plain(gp, gf, hp, d)
    assert ds.dtype == dtype and dd.dtype == decay_dtype
    assert torch.equal(ds, want_ds)
    _ddecay_close(dd, want_dd, want_ds, hp, decay_dtype)
    again = ssc.ssd_scan_backward_cuda(gp, gf, hp, d)
    assert torch.equal(again[0], ds) and torch.equal(again[1], dd)


def test_ssd_gradient_on_the_card_matches_the_plain(card):
    """A gradient through `ops.ssd_scan` on the card (`SSDScan`: the
    forward kernel, then the backward kernel) against autograd of the
    plain scan on the same card tensors: ds within 1e-6 of max(1, |ds|),
    ddecay within its sum bound."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import ssd_scan as ss
    from repro_torch.kernels import ssd_scan_cuda as ssc

    s, d = _ssd_inputs((4, 2, 8, 16, 32), card, torch.float32, torch.float32, 9)
    gp = torch.randn(4, 2, 8, 16, 32, device=card)
    leaves = [s.clone().requires_grad_(), d.clone().requires_grad_()]
    before = ssc.launch_counts()
    hp, _ = ops.ssd_scan(*leaves)
    got = torch.autograd.grad(hp, leaves, gp)
    torch.cuda.synchronize()
    after = ssc.launch_counts()
    assert {k: after[k] - before[k] for k in after} == {"ssd_scan": 1,
                                                        "ssd_scan_backward": 1}
    ref = [s.clone().requires_grad_(), d.clone().requires_grad_()]
    want = torch.autograd.grad(ss.ssd_scan_plain(*ref)[0], ref, gp)
    assert float((got[0] - want[0]).abs().max()) <= 1e-6 * max(
        1.0, float(want[0].abs().max()))
    _ddecay_close(got[1], want[1], want[0], hp.detach(), torch.float32)


# -- the SSD's intra-chunk output (`ssd_intra.cu`) ---------------------------------

# (b, c, q, h, n), p = 64: Mamba2 2.7B's training call (2 × 2,048 tokens),
# Zamba2 1.2B's state (n 64), the reduced configs (chunk 32, n 16) and two
# sequences shorter than a chunk (one chunk of 7 and of 100 positions).
SSD_INTRA_CASES = {"mamba2": (2, 8, 256, 80, 128), "zamba2": (2, 8, 256, 64, 64),
                   "reduced": (2, 4, 32, 4, 16), "short_7": (1, 1, 7, 4, 16),
                   "short_100": (2, 1, 100, 8, 128)}
# Normwise errors, max |got − float64| / max |float64|, that the kernel and
# the plain version in float32 must both keep: float32 sums of up to q·p
# products in other orders (the kernel FMAs over s, the plain version's
# batched products block it), each weight's expf against torch's exp, and
# the tiny terms the kernel skips above the diagonal tiles.  y and dx are
# sums of positive-weighted terms; d dt, d cum, dB and dC sum signed
# products of dw = dy·xᵀ, and d cum is a difference of two such sums.
SSD_INTRA_TOL = {"y": 1e-5, "dx": 1e-5, "ddt": 1e-4, "dcum": 1e-4, "dC": 1e-4,
                 "dB": 1e-4}


def _ssd_intra_inputs(card, b, c, q, h, n, seed):
    """x, dt, cum, C, B and the output's gradient, float32 on ``card``:
    dt = softplus(z − 1) and decay rates from 1e-3 (weights across the
    whole chunk) to 16 (the model's largest, A_log's init)."""
    rng = np.random.default_rng(seed)
    dt = np.log1p(np.exp(rng.standard_normal((b, c, q, h)) - 1.0))
    a = np.exp(np.linspace(np.log(1e-3), np.log(16.0), h))
    cum = np.cumsum(-(dt * a), axis=2)
    arrays = {"x": rng.standard_normal((b, c, q, h, 64)), "dt": dt, "cum": cum,
              "C": rng.standard_normal((b, c, q, n)) * 0.5,
              "B": rng.standard_normal((b, c, q, n)) * 0.5,
              "dy": rng.standard_normal((b, c, q, h, 64))}
    return {k: torch.from_numpy(v.astype(np.float32)).to(card) for k, v in arrays.items()}


def _ssd_intra_run(ins, dtype, route):
    """y and (dx, d dt, d cum, dC, dB) through ``route`` with cb = C·Bᵀ,
    the inputs cast to ``dtype``."""
    leaves = [ins[k].to(dtype).requires_grad_() for k in ("x", "dt", "cum", "C", "B")]
    x, dt, cum, cmat, bmat = leaves
    y = route(x, dt, cum, cmat @ bmat.transpose(-1, -2))
    grads = torch.autograd.grad(y, leaves, ins["dy"].to(dtype))
    return dict(zip(("y", "dx", "ddt", "dcum", "dC", "dB"),
                    (y.detach(),) + tuple(grads)))


def _normwise(got, want):
    want = want.double()
    return float((got.double() - want).abs().max() / want.abs().max())


@pytest.mark.parametrize("name", list(SSD_INTRA_CASES))
def test_ssd_intra_matches_the_plain_version_in_float64(card, name, monkeypatch):
    """`ops.ssd_intra` on the card (the `SSDIntra` op: one forward and one
    backward launch) against `ssd_intra_plain` in float64, and the plain
    version in float32 inside the same tolerances; the call without a
    gradient gives the same y bit for bit."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import ssd_intra as si
    from repro_torch.kernels import ssd_intra_cuda as sic

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    ins = _ssd_intra_inputs(card, *SSD_INTRA_CASES[name], seed=len(name))
    before = sic.launch_counts()
    got = _ssd_intra_run(ins, torch.float32, ops.ssd_intra)
    torch.cuda.synchronize()
    after = sic.launch_counts()
    assert {k: after[k] - before[k] for k in after} == {"ssd_intra": 1,
                                                        "ssd_intra_backward": 1}
    want = _ssd_intra_run(ins, torch.float64, si.ssd_intra_plain)
    plain32 = _ssd_intra_run(ins, torch.float32, si.ssd_intra_plain)
    for k, tol in SSD_INTRA_TOL.items():
        assert bool(torch.isfinite(got[k]).all()), k
        assert _normwise(got[k], want[k]) <= tol, (k, _normwise(got[k], want[k]))
        assert _normwise(plain32[k], want[k]) <= tol, (k, _normwise(plain32[k], want[k]))
    with torch.no_grad():
        x, dt, cum, cmat, bmat = (ins[k] for k in ("x", "dt", "cum", "C", "B"))
        y = ops.ssd_intra(x, dt, cum, cmat @ bmat.transpose(-1, -2))
    assert torch.equal(y, got["y"])


def test_ssd_intra_repeats_bit_for_bit(card):
    """Forward and backward at Mamba2's shape, twice each: bit-equal (no
    floating-point atomics; every partial sum in a fixed order)."""
    from repro_torch.kernels import ssd_intra_cuda as sic

    ins = _ssd_intra_inputs(card, *SSD_INTRA_CASES["mamba2"], seed=3)
    cb = ins["C"] @ ins["B"].transpose(-1, -2)
    args = (ins["x"], ins["dt"], ins["cum"], cb)
    y1, y2 = sic.ssd_intra_cuda(*args), sic.ssd_intra_cuda(*args)
    g1 = sic.ssd_intra_backward_cuda(ins["dy"], *args)
    g2 = sic.ssd_intra_backward_cuda(ins["dy"], *args)
    assert torch.equal(y1, y2)
    assert all(torch.equal(a, b) for a, b in zip(g1, g2))


def test_ssd_intra_wrapper_checks_its_inputs(card):
    from repro_torch.kernels import ssd_intra_cuda as sic

    ins = _ssd_intra_inputs(card, 1, 2, 9, 3, 4, seed=1)
    cb = ins["C"] @ ins["B"].transpose(-1, -2)
    x, dt, cum = ins["x"], ins["dt"], ins["cum"]
    with pytest.raises(ValueError, match="head dims"):
        sic.ssd_intra_cuda(x[..., :32].contiguous(), dt, cum, cb)
    with pytest.raises(TypeError):
        sic.ssd_intra_cuda(x.double(), dt, cum, cb)
    with pytest.raises(ValueError, match="contiguous"):
        sic.ssd_intra_cuda(x, dt.transpose(1, 2).contiguous().transpose(1, 2), cum, cb)
    with pytest.raises(ValueError, match="shape"):
        sic.ssd_intra_cuda(x, dt, cum, cb[:, :, :8].contiguous())
    with pytest.raises(ValueError):
        sic.ssd_intra_cuda(x.cpu(), dt.cpu(), cum.cpu(), cb.cpu())
    with pytest.raises(ValueError, match="shape"):
        sic.ssd_intra_backward_cuda(ins["dy"][:, :1].contiguous(), x, dt, cum, cb)
    empty = [t[:0].contiguous() for t in (x, dt, cum, cb)]
    assert sic.ssd_intra_cuda(*empty).shape == (0, 2, 9, 3, 64)
    assert all(g.shape[0] == 0 for g in sic.ssd_intra_backward_cuda(empty[0], *empty))


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "zamba2-1.2b"])
def test_reduced_ssm_train_step_on_the_card_equals_the_host(card, arch):
    """One float32 train step of reduced Mamba2 and of a 5-layer Zamba2 (two
    groups and a tail), remat, through the kernels on the card and the
    plain versions on the host from one state: loss and grad norm within
    1e-4, AdamW's first moment within 1e-4 of its max."""
    from repro_torch.configs import get_arch
    from repro_torch.data import SyntheticLMData
    from repro_torch.distributed import init_train_state, make_train_step
    from repro_torch.kernels import ssd_intra_cuda as sic
    from repro_torch.kernels import ssd_scan_cuda as ssc
    from repro_torch.models import build_model
    from repro_torch.utils.tree import map_with_paths

    torch.backends.cuda.matmul.allow_tf32 = False
    over = {"num_layers": 5, "shared_attn_every": 2} if arch.startswith("zamba2") else {}
    cfg = dataclasses.replace(get_arch(arch).reduced(), compute_dtype="float32", **over)
    m = build_model(cfg)
    host = init_train_state(m, 0, device="cpu")
    dev = map_with_paths(lambda _, t: t.detach().to(card, copy=True), host)
    batch = SyntheticLMData(vocab_size=cfg.vocab_size, seq_len=128,
                            global_batch=2).batch_at(0)
    step = make_train_step(m, base_lr=1e-3, warmup_steps=0, total_steps=10)
    before, intra0 = ssc.launch_counts(), sic.launch_counts()
    dev, dm = step(dev, {k: torch.from_numpy(v).to(card) for k, v in batch.items()})
    torch.cuda.synchronize()
    after = ssc.launch_counts()
    assert after["ssd_scan"] - before["ssd_scan"] == 2 * cfg.num_layers
    assert after["ssd_scan_backward"] - before["ssd_scan_backward"] == cfg.num_layers
    intra = sic.launch_counts()
    assert intra["ssd_intra"] - intra0["ssd_intra"] == 2 * cfg.num_layers
    assert intra["ssd_intra_backward"] - intra0["ssd_intra_backward"] == cfg.num_layers
    host, hm = step(host, {k: torch.from_numpy(v) for k, v in batch.items()})
    for key in ("loss", "grad_norm"):
        assert abs(float(dm[key]) - float(hm[key])) <= 1e-4 * abs(float(hm[key]))
    scale = max(float(t.abs().max()) for t in host.opt.mu.values())
    for k_, t in host.opt.mu.items():
        assert float((dev.opt.mu[k_].cpu() - t).abs().max()) <= 1e-4 * scale, k_


@pytest.mark.parametrize("arch,over", [("mamba2-2.7b", {}), ("zamba2-1.2b", {}),
                                       ("zamba2-1.2b", {"num_layers": 5})])
def test_reduced_ssm_on_the_card_equals_the_host_port(card, arch, over):
    """Forward and decode in float32 on the card, through the scan kernel
    (and the flash kernel in the hybrid's shared block), against the
    port's plain versions on the host; one scan launch per Mamba block."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.kernels import flash_attention_cuda as fac
    from repro_torch.kernels import ssd_intra_cuda as sic
    from repro_torch.kernels import ssd_scan_cuda as ssc
    from repro_torch.models import build_model

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_arch(arch).reduced(), compute_dtype="float32",
                              **over)
    m = build_model(cfg)
    host = m.init(3, device="cpu")
    dev = m.init(3, device="cpu").to(card)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 128)).astype(np.int64))
    fac.reset_launch_counts()
    ssc.reset_launch_counts()
    sic.reset_launch_counts()
    got = m.forward(dev, {"tokens": toks.to(card)})
    torch.cuda.synchronize()
    assert ssc.launch_counts()["ssd_scan"] == cfg.num_layers
    assert sic.launch_counts()["ssd_intra"] == cfg.num_layers
    groups = cfg.num_layers // cfg.shared_attn_every if cfg.shared_attn_every else 0
    assert fac.launch_counts()["flash_attention"] == groups
    want = m.forward(host, {"tokens": toks})
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=1e-4, atol=1e-4)
    cd, ch = m.init_cache(2, 16, device=card), m.init_cache(2, 16, device="cpu")
    for c in (cd, ch):
        if "attn" in c:
            for k in ("k", "v"):
                c["attn"][k] = c["attn"][k].float()
    for t in range(4):
        a, cd = m.decode_step(dev, {"token": toks[:, t:t + 1].to(card)}, cd)
        b, ch = m.decode_step(host, {"token": toks[:, t:t + 1]}, ch)
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), rtol=1e-4, atol=1e-4)
    assert ssc.launch_counts()["ssd_scan"] == cfg.num_layers   # decode: none
    assert sic.launch_counts()["ssd_intra"] == cfg.num_layers


# -- the device guard: every wrapper launched from a new thread -------------------

def _wrapper_calls(card, gbdt):
    """kernel name → a call of its wrapper on operands on ``card``."""
    from repro_torch.kernels import flash_attention_cuda as fac
    from repro_torch.kernels import int8_matmul_cuda as imc
    from repro_torch.kernels import moe_gmm_cuda as mgc
    from repro_torch.kernels import ssd_intra_cuda as sic
    from repro_torch.kernels import ssd_scan_cuda as ssc
    from repro_torch.kernels import tree_gather as tg
    from repro_torch.kernels import tree_gather_cuda as tgc
    from repro_torch.kernels import winograd_conv_cuda as wcc

    rng = np.random.default_rng(5)
    raw = np.abs(rng.standard_normal((527, 16))) * np.linspace(1, 30, 16)
    db = gbdt.flat().device_bank(card)
    xr = torch.from_numpy(raw.astype(np.float32)).to(card)
    mean, std = tg.to_device_scaler(gbdt.scaler, card)
    kind, scale, bias = gbdt._device_reduction()
    xs = (xr - mean) / std
    a, bt, ibias, iscale = _int8_case(card, 784, 441, 38, seed=5)
    tiles = torch.from_numpy(rng.standard_normal((196, 16, 64)).astype(np.float32)).to(card)
    u = torch.from_numpy(rng.standard_normal((16, 64, 64)).astype(np.float32)).to(card)
    bf16 = torch.bfloat16
    q = _bf16(rng, (1, 128, 4, 64)).to(card, bf16)
    k, v = (_bf16(rng, (1, 128, 2, 64)).to(card, bf16) for _ in range(2))
    x, w = _bf16(rng, (4, 32, 64)).to(card, bf16), _bf16(rng, (4, 64, 32)).to(card, bf16)
    s, d = _ssd_inputs((4, 1, 3, 8, 16), card, torch.float32, torch.float32, 5)
    from repro_torch.kernels import ssd_scan as ss

    hp, _ = ss.ssd_scan_plain(s, d)
    g = torch.randn_like(hp)
    ins = _ssd_intra_inputs(card, 1, 2, 70, 3, 16, seed=5)
    intra = (ins["x"], ins["dt"], ins["cum"], ins["C"] @ ins["B"].transpose(-1, -2))
    return {
        "tree_gather_leaves": lambda: tgc.gather_leaves_cuda(db, xs),
        "tree_predict_fused": lambda: tgc.fused_predict_cuda(db, mean, std, scale,
                                                             bias, xr, kind),
        "int8_matmul": lambda: imc.int8_matmul_cuda(a, bt, iscale, ibias),
        "winograd_conv2d": lambda: wcc.winograd_tiles_cuda(tiles, u),
        "flash_attention": lambda: fac.flash_attention_cuda(q, k, v, causal=True),
        "flash_attention_backward": lambda: fac.flash_attention_backward_cuda(
            q, k, v, *fac.flash_attention_cuda(q, k, v, causal=True, return_lse=True), q,
            causal=True),
        "moe_gmm": lambda: mgc.moe_gmm_cuda(x, w),
        "ssd_scan": lambda: ssc.ssd_scan_cuda(s, d),
        "ssd_scan_backward": lambda: ssc.ssd_scan_backward_cuda(g, g[0], hp, d),
        "ssd_intra": lambda: sic.ssd_intra_cuda(*intra),
        "ssd_intra_backward": lambda: sic.ssd_intra_backward_cuda(ins["dy"], *intra),
    }


KERNEL_NAMES = ("tree_gather_leaves", "tree_predict_fused", "int8_matmul",
                "winograd_conv2d", "flash_attention", "flash_attention_backward",
                "moe_gmm", "ssd_scan", "ssd_scan_backward", "ssd_intra",
                "ssd_intra_backward")


def _kernel_counts():
    from repro_torch.kernels import (flash_attention_cuda, int8_matmul_cuda,
                                     moe_gmm_cuda, ssd_intra_cuda, ssd_scan_cuda,
                                     tree_gather_cuda, winograd_conv_cuda)

    out = {}
    for m in (tree_gather_cuda, int8_matmul_cuda, winograd_conv_cuda,
              flash_attention_cuda, moe_gmm_cuda, ssd_scan_cuda, ssd_intra_cuda):
        out.update(m.launch_counts())
    return out


@pytest.mark.parametrize("name", KERNEL_NAMES)
def test_wrapper_launched_from_a_new_thread(card, gbdt_150x4, name):
    """On one card this shows the guard does no harm (the result and the
    count are those of a launch from the main thread), not that it picks a
    second card."""
    import threading

    call = _wrapper_calls(card, gbdt_150x4)[name]
    want = call()
    torch.cuda.synchronize()
    before = _kernel_counts()
    box = {}

    def run():
        try:
            box["out"] = call()
            torch.cuda.synchronize()
        except BaseException as e:          # re-raised on the main thread
            box["error"] = e

    t = threading.Thread(target=run)
    t.start()
    t.join(timeout=120)
    assert not t.is_alive() and "error" not in box, box.get("error")
    after = _kernel_counts()
    # The backward's call also runs the forward that hands it o and lse.
    assert {k: after[k] - before[k] for k in after} == \
        {k: int(k == name or (name == "flash_attention_backward"
                               and k == "flash_attention")) for k in after}
    got = box["out"]
    for g, w_ in zip(got if isinstance(got, tuple) else (got,),
                     want if isinstance(want, tuple) else (want,)):
        assert torch.equal(g, w_)


# -- whole-graph mode: one CUDA-graph replay ---------------------------------------

WHOLE_RTOL, WHOLE_ATOL = 1e-5, 1e-6     # tests/test_torch_executor.py's bound


def _within(got, want):
    w64, g64 = want.double(), got.double()
    scale = max(1.0, float(w64.abs().max()))
    return bool(((g64 - w64).abs() <= WHOLE_RTOL * w64.abs() + WHOLE_ATOL * scale).all())


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_whole_graph_replay_equals_eager(card, dtype):
    from repro_torch.core.dataset import synthetic_graphs
    from repro_torch.core.executor import GraphExecutor

    g = synthetic_graphs(2, resolution=64)[1]
    eager = GraphExecutor(g, "op_by_op", dtype, device=card)
    whole = GraphExecutor(g, "whole_jit", dtype, device=card)
    ins, ins2 = eager.example_inputs(), eager.example_inputs(seed=7)
    want, want2 = eager(*ins, sync_per_op=True), eager(*ins2, sync_per_op=True)
    first = whole(*ins)
    (wg,) = whole.whole_graphs.values()
    captured = wg.kernel_launches()
    if dtype == "int8":
        assert captured["int8_matmul"] > 0
    before = _kernel_counts()
    second = whole(*ins2)
    again = [whole(*ins) for _ in range(2)]
    torch.cuda.synchronize()
    after = _kernel_counts()
    assert wg.replays == 4 and whole.kernel_count() == 1
    assert {k: after[k] - before[k] for k in after} == \
        {k: 3 * captured.get(k, 0) for k in after}
    # A later call overwrites nothing returned earlier.
    for got, ref in [(first, want), (second, want2)] + [(a, want) for a in again]:
        for o, w_ in zip(got, ref):
            assert o.dtype == w_.dtype and _within(o, w_)


def test_whole_graph_capture_failure_raises(card):
    """An op that copies to the host cannot be captured: the executor
    raises and keeps no graph.  (Last in the file: it is the one test here
    that aborts a stream capture.)"""
    from repro_torch.core.dataset import synthetic_graphs
    from repro_torch.core.executor import GraphExecutor

    g = synthetic_graphs(1, resolution=32)[0]
    whole = GraphExecutor(g, "whole_jit", "int8", device=card)
    node, fn, ids = whole.op_fns[0]
    whole.op_fns[0] = (node, lambda *xs: fn(*xs).cpu().to(card), ids)
    ins = whole.example_inputs()
    torch.cuda.synchronize()
    with pytest.raises(RuntimeError, match="whole_jit: capturing"):
        whole(*ins)
    assert whole.whole_graphs == {}


# -- training: the flash backward kernel, the GMM's backward, the guard -----------

# Row by row, bfloat16 backward: each row's max |plain| floored at 2^-8 of
# the output's max (dq's first causal row is zero in exact arithmetic;
# chip_smoke.py's FLASH_BWD_ROW_FLOOR says why).
BWD_ROW_FLOOR = 2.0 ** -8


def _bwd_rows_close(got, want):
    g, w = got.float(), want.float()
    scale = w.abs().amax(-1).clamp_min(BWD_ROW_FLOOR * float(w.abs().max()))
    assert float(((g - w).abs().amax(-1) / scale).max()) <= ROW_TOL


def _flash_bwd_inputs(card, dtype, b, sq, skv, h, kvh, d):
    rng = np.random.default_rng(sq + skv + h + d)
    return [torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(card, dtype)
            for shape in ((b, sq, h, d), (b, skv, kvh, d), (b, skv, kvh, d), (b, sq, h, d))]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,sq,skv,h,kvh,d,causal,q_offset", [
    (2, 256, 256, 16, 8, 64, True, 0), (1, 1000, 1000, 4, 2, 64, True, 0),
    (2, 77, 50, 4, 2, 32, False, 0), (1, 33, 33, 8, 1, 128, True, 0),
    (1, 20, 45, 4, 4, 16, True, 25), (3, 5, 7, 2, 2, 16, False, 0)])
def test_flash_backward_within_tolerance_of_plain(card, dtype, b, sq, skv, h, kvh, d,
                                                   causal, q_offset):
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_attention_cuda as fac

    q, k, v, do = _flash_bwd_inputs(card, dtype, b, sq, skv, h, kvh, d)
    kw = {"causal": causal, "q_offset": q_offset}
    o, lse = fac.flash_attention_cuda(q, k, v, return_lse=True, **kw)
    assert torch.equal(o, fac.flash_attention_cuda(q, k, v, **kw))
    torch.testing.assert_close(lse, fa.flash_lse_plain(q, k, **kw), rtol=0,
                               atol=1e-5 * max(1.0, float(lse.abs().max())))
    before = fac.launch_counts()["flash_attention_backward"]
    got = fac.flash_attention_backward_cuda(q, k, v, o, lse, do, **kw)
    torch.cuda.synchronize()
    assert fac.launch_counts()["flash_attention_backward"] == before + 1
    want = fa.flash_attention_backward_plain(q, k, v, o, lse, do, **kw)
    for g, w in zip(got, want):
        _close(g, w, dtype)
        if dtype == torch.bfloat16:
            _bwd_rows_close(g, w)
    again = fac.flash_attention_backward_cuda(q, k, v, o, lse, do, **kw)
    assert all(torch.equal(a, c) for a, c in zip(got, again))


# (b, sq, skv, h, kvh, d, causal, q_offset, window, softcap, q's standard
# deviation): gemma2's local call cut to 600 rows (window 200, softcap 50,
# q scaled so the cap bends the scores), its global call's softcap at
# Granite's heads, a window with an offset over cached keys, and a
# non-causal window (tests/test_torch_flash_backward.py's CARD_CASES
# emulate the bfloat16 rounding points at the first three).
FLASH_BWD_MASK_CASES = [
    (1, 600, 600, 8, 4, 128, True, 0, 200, 50.0, 8.0),
    (2, 256, 256, 16, 8, 64, True, 0, 0, 5.0, 1.0),
    (1, 200, 328, 8, 2, 16, True, 128, 100, 0.0, 1.0),
    (2, 130, 130, 4, 2, 32, False, 0, 100, 50.0, 4.0)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", FLASH_BWD_MASK_CASES, ids=str)
def test_flash_backward_with_window_and_softcap_within_tolerance_of_plain(
        card, dtype, case):
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_attention_cuda as fac

    b, sq, skv, h, kvh, d, causal, q_offset, window, cap, q_scale = case
    rng = np.random.default_rng(sq + skv + h + d)
    q, k, v, do = (torch.from_numpy((rng.standard_normal(shape) * sc).astype(np.float32)
                                    ).to(card, dtype)
                   for shape, sc in (((b, sq, h, d), q_scale), ((b, skv, kvh, d), 1.0),
                                     ((b, skv, kvh, d), 1.0), ((b, sq, h, d), 1.0)))
    kw = {"causal": causal, "q_offset": q_offset, "window": window, "softcap": cap}
    o, lse = fac.flash_attention_cuda(q, k, v, return_lse=True, **kw)
    torch.testing.assert_close(lse, fa.flash_lse_plain(q, k, **kw), rtol=0,
                               atol=1e-5 * max(1.0, float(lse.abs().max())))
    routes = fac.bwd_route_counts()
    got = fac.flash_attention_backward_cuda(q, k, v, o, lse, do, **kw)
    torch.cuda.synchronize()
    assert fac.bwd_route_counts()[fac.ROUTES[dtype][1]] == routes[fac.ROUTES[dtype][1]] + 1
    want = fa.flash_attention_backward_plain(q, k, v, o, lse, do, **kw)
    for g, w in zip(got, want):
        _close(g, w, dtype)
        if dtype == torch.bfloat16:
            _bwd_rows_close(g, w)
    again = fac.flash_attention_backward_cuda(q, k, v, o, lse, do, **kw)
    assert all(torch.equal(a, c) for a, c in zip(got, again))
    with pytest.raises(ValueError, match="hides every key"):
        fac.flash_attention_backward_cuda(q, k, v, o, lse, do, causal=False,
                                          q_offset=skv + 5, window=4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_autograd_on_the_card_runs_both_kernels(card, dtype):
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_attention_cuda as fac

    q, k, v, do = _flash_bwd_inputs(card, dtype, 2, 130, 130, 8, 2, 64)
    ts = [t.clone().requires_grad_() for t in (q, k, v)]
    before = fac.launch_counts()
    out = fa.flash_attention(*ts, causal=True)
    got = torch.autograd.grad(out, ts, do)
    torch.cuda.synchronize()
    after = fac.launch_counts()
    assert after["flash_attention"] - before["flash_attention"] == 1
    assert after["flash_attention_backward"] - before["flash_attention_backward"] == 1
    o, lse = fac.flash_attention_cuda(q, k, v, causal=True, return_lse=True)
    assert torch.equal(out.detach(), o)
    for g, w in zip(got, fac.flash_attention_backward_cuda(q, k, v, o, lse, do)):
        assert torch.equal(g, w)
    kw = {"causal": True, "window": 16, "softcap": 5.0}
    before = fac.launch_counts()
    got = torch.autograd.grad(fa.flash_attention(*ts, **kw), ts, do)
    torch.cuda.synchronize()
    after = fac.launch_counts()
    assert after["flash_attention_backward"] - before["flash_attention_backward"] == 1
    o, lse = fac.flash_attention_cuda(q, k, v, return_lse=True, **kw)
    for g, w in zip(got, fac.flash_attention_backward_cuda(q, k, v, o, lse, do, **kw)):
        assert torch.equal(g, w)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("e,c,d,f", [(32, 1280, 1024, 512), (32, 1280, 512, 1024),
                                     (3, 33, 70, 17), (5, 77, 300, 129)])
def test_moe_gmm_backward_within_tolerance_of_plain(card, dtype, e, c, d, f):
    from repro_torch.kernels import moe_gmm as gmm
    from repro_torch.kernels import moe_gmm_cuda as gmmc

    rng = np.random.default_rng(e + c + d + f)
    x = torch.from_numpy(rng.standard_normal((e, c, d)).astype(np.float32)).to(card, dtype)
    w = torch.from_numpy((rng.standard_normal((e, d, f)) / np.sqrt(d)).astype(np.float32)
                         ).to(card, dtype)
    dy = torch.from_numpy(rng.standard_normal((e, c, f)).astype(np.float32)).to(card, dtype)
    x.requires_grad_()
    w.requires_grad_()
    before = gmmc.launch_counts()["moe_gmm"]
    got = torch.autograd.grad(gmm.moe_gmm(x, w), (x, w), dy)
    torch.cuda.synchronize()
    assert gmmc.launch_counts()["moe_gmm"] == before + 3
    for g, r in zip(got, torch.autograd.grad(gmm.moe_gmm_plain(x, w), (x, w), dy)):
        _close(g, r, dtype)


def test_gradient_through_a_kernel_without_backward_raises(card, gbdt_150x4):
    """Winograd and the tree kernels have no backward: a gradient asked
    through them on the card raises instead of cutting the graph.  The int8
    GEMM's operands are integers, which cannot require a gradient; its
    dispatcher refuses one all the same."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import tree_gather as tg

    x = torch.randn(1, 8, 8, 16, device=card, requires_grad=True)
    wt = torch.randn(3, 3, 16, 16, device=card)
    with pytest.raises(RuntimeError, match="winograd_conv2d on the card has no backward"):
        ops.winograd_conv2d(x, wt)
    db = gbdt_150x4.flat().device_bank(card)
    mean, std = tg.to_device_scaler(gbdt_150x4.scaler, card)
    xr = torch.rand(5, mean.shape[0], device=card, requires_grad=True)
    kind, scale, bias = gbdt_150x4._device_reduction()
    with pytest.raises(RuntimeError, match="tree_predict_fused on the card has no backward"):
        db.fused(mean, std, scale, bias, xr, kind)
    with torch.no_grad():
        ops.winograd_conv2d(x, wt)


def test_reduced_granite_train_step_on_the_card_equals_the_host(card):
    """One float32 train step of reduced Granite-MoE (lr 1e-3 from step 0)
    through the kernels on the card and the plain versions on the host,
    from one state: loss and grad norm within 1e-4, AdamW's first moment
    within 1e-4 of its max."""
    from repro_torch.configs import get_arch
    from repro_torch.data import SyntheticLMData
    from repro_torch.distributed import init_train_state, make_train_step
    from repro_torch.models import build_model
    from repro_torch.utils.tree import map_with_paths

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_arch("granite-moe-1b-a400m").reduced(),
                              compute_dtype="float32")
    m = build_model(cfg)
    host = init_train_state(m, 0, device="cpu")
    dev = map_with_paths(lambda _, t: t.detach().to(card, copy=True), host)
    batch = SyntheticLMData(vocab_size=cfg.vocab_size, seq_len=64, global_batch=2).batch_at(0)
    step = make_train_step(m, base_lr=1e-3, warmup_steps=0, total_steps=10)
    dev, dm = step(dev, {k: torch.from_numpy(v).to(card) for k, v in batch.items()})
    host, hm = step(host, {k: torch.from_numpy(v) for k, v in batch.items()})
    for key in ("loss", "grad_norm"):
        assert abs(float(dm[key]) - float(hm[key])) <= 1e-4 * abs(float(hm[key]))
    scale = max(float(t.abs().max()) for t in host.opt.mu.values())
    for k_, t in host.opt.mu.items():
        assert float((dev.opt.mu[k_].cpu() - t).abs().max()) <= 1e-4 * scale, k_


def test_moe_ffn_gradients_repeat_bit_for_bit_at_granite_width(card):
    """Granite's MoE FFN at full width (d 1,024, 32 experts, top 8,
    capacity 1.25) on 4 × 1,024 bfloat16 tokens, forward and backward
    twice: every gradient bit-equal (no backward accumulates a token's 8
    buffer rows with atomic adds)."""
    from repro_torch.configs import get_arch
    from repro_torch.models import moe
    from repro_torch.models.layers import Params

    cfg = get_arch("granite-moe-1b-a400m")
    assert (cfg.d_model, cfg.num_experts, cfg.top_k, cfg.compute_dtype) == \
        (1024, 32, 8, "bfloat16")
    gen = torch.Generator(card).manual_seed(0)
    p = Params(moe.moe_init(gen, cfg))
    for t in p.parameters():
        t.requires_grad_(True)
    x = torch.randn((4, 1024, cfg.d_model), generator=gen, device=card).to(torch.bfloat16)
    cot = torch.randn((4, 1024, cfg.d_model), generator=gen, device=card)
    runs = []
    for _ in range(2):
        xt = x.clone().requires_grad_(True)
        y, aux = moe.moe_ffn(p, xt, cfg)
        (torch.sum(y.float() * cot) + aux).backward()
        runs.append([xt.grad] + [t.grad.clone() for t in p.parameters()])
        for t in p.parameters():
            t.grad = None
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def test_reduced_granite_train_step_repeats_bit_for_bit(card):
    """One bfloat16 train step of reduced Granite-MoE with Granite's own
    routing (32 experts, top 8) on 4 × 512 tokens, from seed 0, twice:
    loss, grad norm and every parameter bit-equal."""
    from repro_torch.configs import get_arch
    from repro_torch.data import SyntheticLMData
    from repro_torch.distributed import init_train_state, make_train_step
    from repro_torch.models import build_model
    from repro_torch.utils.tree import flatten_with_paths

    cfg = dataclasses.replace(get_arch("granite-moe-1b-a400m").reduced(),
                              num_experts=32, top_k=8)
    batch = SyntheticLMData(vocab_size=cfg.vocab_size, seq_len=512,
                            global_batch=4).batch_at(0)
    runs = []
    for _ in range(2):
        m = build_model(cfg)
        state = init_train_state(m, 0, device=card)
        step = make_train_step(m, base_lr=1e-3, warmup_steps=0, total_steps=10)
        state, metrics = step(state, {k: torch.from_numpy(v).to(card)
                                      for k, v in batch.items()})
        runs.append((float(metrics["loss"]), float(metrics["grad_norm"]),
                     flatten_with_paths(state.params)))
    (l0, n0, p0), (l1, n1, p1) = runs
    assert (l0, n0) == (l1, n1)
    assert p0.keys() == p1.keys()
    for k, t in p0.items():
        assert torch.equal(t, p1[k]), k
