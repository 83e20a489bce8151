"""Port Winograd F(2×2,3×3) (repro_torch.kernels.winograd_conv) held
against the reference (repro.kernels, repro.core.executor).

Same float32 inputs, made with numpy, through the reference's Pallas
kernel (interpret mode), its jnp executor op and its direct-conv oracle,
and through the port's plain version (the CPU side of the dispatch).
Tolerances, relative to the output's largest magnitude:
  * 1e-5 against the reference's Winograd (same algorithm; only the
    order of the float32 sums differs);
  * 1e-4 against a direct convolution (Winograd's transforms round at
    other places than a direct sum).
The tile helpers move values without arithmetic and are bit-equal.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import repro.kernels.ops as rops  # noqa: E402
import repro.kernels.ref as rref  # noqa: E402
from repro.core import executor as rex  # noqa: E402
from repro.kernels import winograd_conv as rwc  # noqa: E402

from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import winograd_conv as wc  # noqa: E402
from repro_torch.kernels import winograd_conv_cuda as wcc  # noqa: E402

WINO_TOL = 1e-5
DIRECT_TOL = 1e-4


def _inputs(b, h, w, c, k, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, h, w, c)).astype(np.float32)
    wt = (rng.standard_normal((3, 3, c, k)) * 0.1).astype(np.float32)
    return x, wt


def _close(got, want, tol):
    scale = float(np.abs(want).max())
    assert got.shape == want.shape
    assert float(np.abs(got - want).max()) <= tol * scale


@pytest.mark.parametrize("b,hw,c,k", [(1, 8, 16, 16), (2, 12, 64, 64),
                                      (1, 16, 32, 48), (1, 7, 16, 16)])
def test_plain_matches_reference_pallas_kernel(b, hw, c, k):
    x, w = _inputs(b, hw, hw, c, k, seed=hw * c)
    want = np.asarray(rops.winograd_conv2d(jnp.asarray(x), jnp.asarray(w),
                                           block_t=32, block_k=16))
    got = ops.winograd_conv2d(torch.from_numpy(x), torch.from_numpy(w)).numpy()
    _close(got, want, WINO_TOL)
    _close(got, np.asarray(rref.winograd_conv_ref(jnp.asarray(x), jnp.asarray(w))),
           DIRECT_TOL)


# Shapes the Pallas kernel refuses (K not a multiple of its block): the
# NAS op Alg. C.2 selects, odd and non-square H, W.
@pytest.mark.parametrize("b,h,w,c,k", [(1, 14, 14, 79, 77), (2, 9, 5, 3, 7),
                                       (1, 1, 1, 4, 2), (1, 15, 16, 8, 12)])
def test_plain_matches_reference_executor_op(b, h, w, c, k):
    x, wt = _inputs(b, h, w, c, k, seed=h * w + k)
    u_ref = rex.winograd_transform_weights(jnp.asarray(wt))
    want = np.asarray(rex.winograd_conv2d(jnp.asarray(x), u_ref, k))
    got = ops.winograd_conv2d(torch.from_numpy(x), torch.from_numpy(wt)).numpy()
    _close(got, want, WINO_TOL)
    _close(ref.winograd_conv_ref(torch.from_numpy(x), torch.from_numpy(wt)).numpy(),
           np.asarray(rref.winograd_conv_ref(jnp.asarray(x), jnp.asarray(wt))),
           WINO_TOL)


def test_transform_weights_matches_reference():
    _, wt = _inputs(1, 1, 1, 12, 10, seed=4)
    want = np.asarray(rwc.transform_weights(jnp.asarray(wt)))
    got = wc.transform_weights(torch.from_numpy(wt))
    assert got.shape == (16, 12, 10) and got.is_contiguous()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)


def test_tiles_plain_matches_reference_kernel_body():
    # The kernel's own function, tile by tile: the reference's Pallas
    # kernel on the same (T, 16, C) tiles and U.
    x, wt = _inputs(1, 10, 10, 8, 16, seed=5)
    tiles = np.array(rref.extract_winograd_tiles(jnp.asarray(x))).reshape(-1, 16, 8)
    u = np.array(rwc.transform_weights(jnp.asarray(wt)))
    got = wc.winograd_tiles_plain(torch.from_numpy(tiles), torch.from_numpy(u))
    y_ref = rops.winograd_conv2d(jnp.asarray(x), jnp.asarray(wt), block_t=25,
                                 block_k=16)
    want = np.asarray(y_ref).reshape(1, 5, 2, 5, 2, 16).transpose(0, 1, 3, 2, 4, 5)
    _close(got.numpy(), want.reshape(25, 4, 16), WINO_TOL)


@pytest.mark.parametrize("shape", [(2, 10, 10, 4), (1, 7, 9, 3), (1, 1, 2, 5)])
def test_tile_helpers_bit_equal(shape):
    x = np.random.default_rng(6).standard_normal(shape).astype(np.float32)
    t = ref.extract_winograd_tiles(torch.from_numpy(x))
    want = np.asarray(rref.extract_winograd_tiles(jnp.asarray(x)))
    assert np.array_equal(t.numpy(), want)
    b, h, w, _ = shape
    y = np.random.default_rng(7).standard_normal((t.shape[0], 2, 2, 6)).astype(np.float32)
    assert np.array_equal(
        ref.assemble_winograd_tiles(torch.from_numpy(y), b, h, w).numpy(),
        np.asarray(rref.assemble_winograd_tiles(jnp.asarray(y), b, h, w)))


def test_raw_and_transformed_weights_agree():
    x, wt = _inputs(1, 6, 6, 5, 4, seed=8)
    xt, w = torch.from_numpy(x), torch.from_numpy(wt)
    assert torch.equal(wc.winograd_conv2d(xt, w),
                       wc.winograd_conv2d(xt, wc.transform_weights(w)))


def test_host_tensors_take_the_plain_version(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a CPU tensor reached the CUDA wrapper")

    monkeypatch.setattr(wcc, "winograd_tiles_cuda", refuse)
    before = wcc.launch_counts()
    x, wt = _inputs(1, 4, 4, 2, 3, seed=9)
    wc.winograd_conv2d(torch.from_numpy(x), torch.from_numpy(wt))
    assert wcc.launch_counts() == before


def test_cuda_wrapper_refuses_host_tensors_and_counts_nothing():
    before = wcc.launch_counts()
    with pytest.raises(ValueError, match="lie on"):
        wcc.winograd_tiles_cuda(torch.zeros((4, 16, 2)), torch.zeros((16, 2, 3)))
    assert wcc.launch_counts() == before


def test_launch_counter_resets():
    wcc.LAUNCHES["winograd_conv2d"] += 1
    wcc.reset_launch_counts()
    assert wcc.launch_counts() == {"winograd_conv2d": 0}


# -- the CUDA kernel's launch plan (pure Python) -----------------------------

# (T, C, K) of the selection path's NAS op and of the three Fig. 8 shapes.
STUDY = [(784, 79, 77), (784, 64, 64), (196, 128, 128), (49, 256, 256)]


# Past 2^20 tiles: a 1 × 2,050 × 2,050 input has 1,025² = 1,050,625.
LARGE = [(1025 * 1025, 1, 1), (4 * 512 * 512, 64, 64), (300000, 3, 77)]


@pytest.mark.parametrize("t,c,k", STUDY + [(1, 3, 2), (1568, 16, 24), (30, 8, 5)]
                         + LARGE)
def test_plan_covers_each_tile_and_channel_once_per_position(t, c, k):
    pl = wcc.plan(t, c, k)
    assert (pl.bt, pl.bq) in wcc.TILES and pl.cc in wcc.CHUNKS
    gx, gy, gz = pl.grid
    assert gz == wcc.POSITIONS == 16
    assert gx * pl.bt >= pl.t_pass > (gx - 1) * pl.bt
    assert gy * pl.bq >= k > (gy - 1) * pl.bq
    # Runs of t_pass tiles, the last one shorter, cover [0, t) once.
    runs = [(t0, min(t, t0 + pl.t_pass)) for t0 in range(0, t, pl.t_pass)]
    assert runs[-1][1] == t and all(b - a <= pl.t_pass for a, b in runs)
    assert pl.route in wcc.route_counts()


@pytest.mark.parametrize("t,c,k", STUDY + LARGE)
def test_plan_bounds_the_workspace_and_the_grid(t, c, k):
    pl = wcc.plan(t, c, k)
    workspace = wcc.POSITIONS * pl.t_pass * k * 4
    assert workspace <= wcc.WORKSPACE_BYTES
    # The study shapes are one run each; a larger input is cut only as far
    # as the workspace forces.
    assert pl.t_pass == t or workspace > wcc.WORKSPACE_BYTES - wcc.POSITIONS * k * 4
    assert pl.t_pass == t or (t, c, k) in LARGE
    # CUDA's grid limits: x up to 2^31 - 1, y and z up to 65,535.
    assert pl.grid[0] <= 2**31 - 1 and pl.grid[1] <= 65535


@pytest.mark.parametrize("t,c,k", STUDY)
def test_plan_fills_the_card_at_the_study_shapes(t, c, k):
    assert wcc.plan(t, c, k).blocks >= wcc.SMS


def test_route_counters_reset_with_the_launch_count():
    route = wcc.plan(784, 64, 64).route
    wcc._ROUTE_COUNTER.add(route)
    wcc.reset_launch_counts()
    assert set(wcc.route_counts().values()) == {0}
