"""Port int8 GEMM (repro_torch.kernels.int8_matmul) held against the
reference (repro.kernels).

Same int8 inputs, made with numpy, through the reference's Pallas kernel
(interpret mode, as the reference's own tests run it) or its jnp oracle,
and through the port's plain version (the CPU side of the dispatch).
The integer sum is exact and there is one float32 multiply, so outputs
must be bit-equal: no tolerance.  The CUDA kernel itself runs only on
the card (tests/test_torch_cuda_kernels.py, chip_smoke.py).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import repro.kernels.ops as rops  # noqa: E402
import repro.kernels.ref as rref  # noqa: E402

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import int8_matmul as im  # noqa: E402
from repro_torch.kernels import int8_matmul_cuda as imc  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402


def _operands(m, k, n, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(-127, 128, (m, k)).astype(np.int8),
            rng.integers(-127, 128, (k, n)).astype(np.int8))


@pytest.mark.parametrize("m,k,n", [(64, 128, 64), (128, 256, 192), (256, 512, 128)])
def test_plain_equals_reference_pallas_kernel(m, k, n):
    a, b = _operands(m, k, n, seed=m + k + n)
    want = rops.int8_matmul(jnp.asarray(a), jnp.asarray(b), 0.02, 0.05,
                            block_m=64, block_n=64, block_k=128)
    got = ops.int8_matmul(torch.from_numpy(a), torch.from_numpy(b), 0.02, 0.05)
    assert got.dtype == torch.float32
    assert np.array_equal(got.numpy(), np.asarray(want))


# Shapes the Pallas kernel refuses (not multiples of its blocks): FC ops
# of the NAS space, an im2col'd 3×3 conv, a ragged 1×1 conv.
ODD = [(1, 63, 252), (1, 1477, 1000), (7, 27, 5), (33, 130, 77),
       (100, 711, 19), (5, 1, 3)]


@pytest.mark.parametrize("m,k,n", ODD)
@pytest.mark.parametrize("scales", [(0.02, 0.05), (4.0 / 127.0 * (0.4 / 127.0)
                                                   / (4.0 / 127.0), 1.0)])
def test_plain_equals_reference_oracle_at_odd_shapes(m, k, n, scales):
    a, b = _operands(m, k, n, seed=m * k + n)
    want = np.asarray(rref.int8_matmul_ref(jnp.asarray(a), jnp.asarray(b), *scales))
    got = ops.int8_matmul(torch.from_numpy(a), torch.from_numpy(b), *scales)
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(ref.int8_matmul_ref(torch.from_numpy(a),
                                              torch.from_numpy(b), *scales).numpy(),
                          want)


def test_sums_beyond_float32_integers_are_exact():
    # 127·127·1477 > 2^24: the int32 sum must be exact before its one
    # rounding to float32 (a float32 accumulation would round early).
    a = np.full((2, 1477), 127, np.int8)
    b = np.full((1477, 3), 127, np.int8)
    b[0, 1] = 126
    got = im.int8_matmul(torch.from_numpy(a), torch.from_numpy(b), 1.0, 1.0)
    acc = 127 * 127 * 1477
    assert got[0, 0].item() == float(np.float32(acc))
    assert got[0, 1].item() == float(np.float32(acc - 127))


def test_pack_weight_layout():
    _, b = _operands(1, 37, 5, seed=1)
    bt = im.pack_weight(torch.from_numpy(b))
    assert bt.dtype == torch.int8 and bt.is_contiguous()
    assert bt.shape == (5, 48) and bt.shape[1] % im.PACK_ALIGN == 0
    assert np.array_equal(bt[:, :37].numpy(), b.T)
    assert not bt[:, 37:].any()


def test_bias_is_an_int32_add_before_the_scale():
    a, b = _operands(9, 20, 6, seed=2)
    bias = np.arange(-3, 3, dtype=np.int32) * 1001
    scale = im.out_scale(0.02, 0.05)
    got = im.int8_matmul_packed(torch.from_numpy(a), im.pack_weight(torch.from_numpy(b)),
                                scale, torch.from_numpy(bias))
    acc = a.astype(np.int64) @ b.astype(np.int64) + bias
    want = acc.astype(np.float32) * np.float32(scale)
    assert np.array_equal(got.numpy(), want)


def test_out_scale_is_float32_of_the_product():
    assert im.out_scale(0.02, 0.05) == float(np.float32(0.02 * 0.05))


def test_host_tensors_take_the_plain_version(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a CPU tensor reached the CUDA wrapper")

    monkeypatch.setattr(imc, "int8_matmul_cuda", refuse)
    before = imc.launch_counts()
    a, b = _operands(3, 8, 4, seed=3)
    im.int8_matmul(torch.from_numpy(a), torch.from_numpy(b), 1.0, 1.0)
    assert imc.launch_counts() == before


def test_cuda_wrapper_refuses_host_tensors_and_counts_nothing():
    a = torch.zeros((4, 8), dtype=torch.int8)
    bt = im.pack_weight(torch.zeros((8, 5), dtype=torch.int8))
    before = imc.launch_counts()
    with pytest.raises(ValueError, match="lie on"):
        imc.int8_matmul_cuda(a, bt, 1.0)
    assert imc.launch_counts() == before


def test_mismatched_inner_dimensions_raise():
    with pytest.raises(ValueError, match="inner"):
        im.int8_matmul(torch.zeros((2, 3), dtype=torch.int8),
                       torch.zeros((4, 2), dtype=torch.int8), 1.0, 1.0)


def test_launch_counter_resets():
    imc.LAUNCHES["int8_matmul"] += 2
    imc.reset_launch_counts()
    assert imc.launch_counts() == {"int8_matmul": 0}


@pytest.mark.parametrize("module,name,source", [
    ("int8_matmul_cuda", "int8_matmul", "int8_matmul.cu"),
    ("winograd_conv_cuda", "winograd_conv", "winograd_conv.cu"),
    ("tree_gather_cuda", "tree_gather", "tree_gather.cu")])
def test_each_source_is_its_own_hashed_library(module, name, source):
    import importlib

    lib = importlib.import_module(f"repro_torch.kernels.{module}").LIBRARY
    assert lib.sources == (source,)
    p = lib.path()
    assert p.parent == _build.BUILD_DIR and p.name.startswith(f"lib{name}_")
    src = (_build.CSRC / source).read_text()
    assert f"{name}_error_string" in src and "cudaGetLastError" in src


# -- the CUDA kernel's launch plan (pure Python) -----------------------------

# The 13 GEMMs (m, k, n) of one int8 forward of the main path's held-out
# graph (`synthetic_graphs(40, resolution=224)[32]`, chip_smoke's
# `gemm_shapes`), and the six slowest of them on the card before the
# tensor-core redesign.
MAIN_SHAPES = [(12544, 3, 72), (12544, 72, 19), (3136, 19, 70), (1, 70, 17),
               (1, 17, 70), (3136, 70, 49), (784, 441, 38), (784, 38, 201),
               (196, 201, 170), (196, 170, 183), (49, 183, 289), (49, 289, 1580),
               (1, 1580, 1000)]
SLOWEST = [(1, 1580, 1000), (784, 441, 38), (49, 289, 1580), (196, 201, 170),
           (196, 170, 183), (49, 183, 289)]
RAGGED = [(1, 63, 252), (130, 27, 77), (7, 1477, 13), (4099, 131, 65), (5, 1, 3),
          (17, 33, 9), (12544, 3577, 71), (196, 9825, 391), (2, 0, 3)]


@pytest.mark.parametrize("m,k,n", MAIN_SHAPES + RAGGED)
def test_plan_covers_each_output_and_each_k_once(m, k, n):
    pl = imc.plan(m, n, k)
    assert (pl.bm, pl.bn) in imc.TILES
    gx, gy, gz = pl.grid
    n_tiles = -(-n // pl.bn)
    assert (gx, gy, gz) == (-(-m // pl.bm) * n_tiles, 1, pl.splits)
    cover = np.zeros((m, n), np.int64)
    for x in range(gx):              # the kernel's numbering: column tile fastest
        r, c = x // n_tiles * pl.bm, x % n_tiles * pl.bn
        cover[r:r + pl.bm, c:c + pl.bn] += 1
    assert (cover == 1).all()
    # k runs: whole 32-byte mma steps, none empty, together [0, k) once.
    assert pl.k_split > 0 and pl.k_split % imc.K_STEP == 0
    runs = [(z * pl.k_split, min(k, (z + 1) * pl.k_split)) for z in range(gz)]
    assert runs[0][0] == 0 and runs[-1][1] == k
    assert all(a1 == b0 for (_, b0), (a1, _) in zip(runs, runs[1:]))
    assert gz == 1 or all(b > a for a, b in runs)


@pytest.mark.parametrize("m,k,n", SLOWEST)
def test_plan_fills_the_card_at_the_slowest_main_path_shapes(m, k, n):
    assert imc.plan(m, n, k).blocks >= imc.SMS


@pytest.mark.parametrize("m,k,n", [(1, 1580, 1000), (784, 441, 38)])
def test_plan_splits_k_where_the_tiles_alone_leave_the_card_idle(m, k, n):
    pl = imc.plan(m, n, k)
    assert pl.splits > 1
    assert pl.grid[0] * pl.grid[1] < imc.SMS


# CUDA's grid limits: x up to 2^31 - 1, y and z up to 65,535.
GRID_LIMITS = (2**31 - 1, 65535, 65535)


@pytest.mark.parametrize("m,k,n", [(65535 * 64 + 1, 3, 5), (2**24, 27, 64),
                                   (1, 1580, 65535 * 32)])
def test_plan_grid_stays_within_the_launch_limits(m, k, n):
    # The output tiles go on grid x: an im2col of a large batch has
    # millions of rows (65,535 row tiles of 64 rows is 4,194,240).
    pl = imc.plan(m, n, k)
    assert pl.grid[0] == -(-m // pl.bm) * -(-n // pl.bn)
    assert all(0 < g <= lim for g, lim in zip(pl.grid, GRID_LIMITS))


def test_route_counters_reset_with_the_launch_count():
    imc._ROUTE_COUNTER.add("split_k")
    imc._ROUTE_COUNTER.add("a_words")
    imc.reset_launch_counts()
    assert imc.route_counts() == {"one_pass": 0, "split_k": 0, "a_cp_async": 0,
                                  "a_words": 0}


def test_a_route_needs_aligned_rows_and_base():
    buf = torch.zeros((4, 48), dtype=torch.int8)
    assert imc.a_route(buf[:, :37]) == "a_cp_async"
    assert imc.a_route(buf[:, :16].contiguous()) == "a_cp_async"
    assert imc.a_route(buf[:, :37].contiguous()) == "a_words"
    assert imc.a_route(buf.view(-1)[1:49].view(1, 48)) == "a_words"
    with pytest.raises(ValueError, match="contiguous"):
        imc.a_route(buf[:, ::2])
