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
