"""The port's inter-chunk SSD scan and chunked SSD core held against the
reference.

`repro_torch.kernels.ssd_scan.ssd_scan_plain` (what CPU tensors take, and
what the CUDA kernel is held bit-equal to on the card) against the
reference's Pallas kernel run as ``tests/test_kernels.py`` runs it
(``repro.kernels.ops.ssd_scan``, interpret mode on the CPU) and against
its oracle ``repro.kernels.ref.ssd_scan_ref``; then the port's
`models.ssm.ssd_forward`, whose recurrence is one ``ssd_scan`` call,
against the reference's and against a float64 sequential oracle.

Tolerances, and why:
  * scan, float32: 1e-6 × max(1, |out|).  The same float32 multiply and
    add per chunk; only XLA may contract them into one FMA.
  * scan, bfloat16 inputs: one bfloat16 step, 2^-7 × max(1, |out|).  The
    state is float32 in both and each output is rounded once to bfloat16,
    so a float32 difference can only flip that rounding.
  * ssd_forward vs the reference, float32: 1e-5 (rtol and atol), the order
    of float32 sums in the einsums' products.
  * ssd_forward vs the float64 sequential recurrence: 2e-3, the tolerance
    of the reference's own test (tests/test_models_math.py).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import repro.kernels.ops as rops  # noqa: E402
import repro.kernels.ref as rref  # noqa: E402
from repro.models.ssm import ssd_forward as r_ssd_forward  # noqa: E402

from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.ssd_scan import ssd_scan_plain  # noqa: E402
from repro_torch.models.ssm import MASKED_DECAY, ssd_forward  # noqa: E402

F32_TOL = 1e-6
BF16_STEP = 2.0 ** -7

# (nc, b, h, p, n): tests/test_kernels.py TestSSDScan's three shapes, a
# ragged b·h with a p·n that is not a multiple of 4, and a single chunk.
SHAPES = [(4, 1, 2, 8, 4), (8, 2, 4, 16, 8), (16, 1, 8, 32, 16),
          (3, 1, 3, 5, 7), (1, 2, 2, 8, 4)]


def _inputs(shape, seed):
    rng = np.random.default_rng(seed)
    s = rng.standard_normal(shape).astype(np.float32)
    d = rng.uniform(0.3, 1.0, shape[:3]).astype(np.float32)
    return s, d


def _pallas(s, d, dtype=jnp.float32):
    bh = s.shape[1] * s.shape[2]
    block = min(4, bh) if bh % min(4, bh) == 0 else bh
    hp, hf = rops.ssd_scan(jnp.asarray(s, dtype), jnp.asarray(d), block_bh=block)
    return np.asarray(hp, np.float32), np.asarray(hf, np.float32)


def _within(got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.all(np.abs(got - want) <= tol * np.maximum(1.0, np.abs(want)))


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_plain_matches_the_pallas_kernel_and_oracle_f32(shape):
    s, d = _inputs(shape, seed=sum(shape))
    hp, hf = ssd_scan_plain(torch.from_numpy(s), torch.from_numpy(d))
    assert hp.dtype == hf.dtype == torch.float32
    assert hp.shape == shape and hf.shape == shape[1:]
    for want in (_pallas(s, d), rref.ssd_scan_ref(jnp.asarray(s), jnp.asarray(d))):
        _within(hp.numpy(), want[0], F32_TOL)
        _within(hf.numpy(), want[1], F32_TOL)
    assert not hp[0].any()                       # the state before chunk 0


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_port_oracle_is_the_plain_version_in_float32(shape):
    s, d = (torch.from_numpy(a) for a in _inputs(shape, seed=1 + sum(shape)))
    for got, want in zip(ref.ssd_scan_ref(s, d), ssd_scan_plain(s, d)):
        assert torch.equal(got, want)


@pytest.mark.parametrize("decay_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [SHAPES[1], SHAPES[3]], ids=str)
def test_plain_in_bfloat16_is_within_one_step(shape, decay_dtype):
    s, d = _inputs(shape, seed=2 + sum(shape))
    st = torch.from_numpy(s).bfloat16()
    dt = torch.from_numpy(d).to(getattr(torch, decay_dtype))
    hp, hf = ssd_scan_plain(st, dt)
    assert hp.dtype == hf.dtype == torch.bfloat16
    # The float32 recurrence on the same (bfloat16-rounded) values.
    want = ssd_scan_plain(st.float(), dt.float())
    _within(hp.float().numpy(), want[0].numpy(), BF16_STEP)
    _within(hf.float().numpy(), want[1].numpy(), BF16_STEP)
    if decay_dtype == "float32":
        pal = _pallas(st.float().numpy(), d, jnp.bfloat16)
        _within(hp.float().numpy(), pal[0], BF16_STEP)
        _within(hf.float().numpy(), pal[1], BF16_STEP)


def test_dispatch_checks_shapes_and_takes_the_plain_version_on_the_host():
    s, d = (torch.from_numpy(a) for a in _inputs((4, 1, 2, 8, 4), seed=3))
    for got, want in zip(ops.ssd_scan(s, d), ssd_scan_plain(s, d)):
        assert torch.equal(got, want)
    with pytest.raises(ValueError, match="decay"):
        ops.ssd_scan(s, d[:, :, :1])
    with pytest.raises(ValueError, match="s_chunk"):
        ops.ssd_scan(s[0], d[0])


# -- the chunked SSD core ---------------------------------------------------------

def _sequential(xh, dt, a, bmat, cmat):
    """The float64 sequential recurrence of tests/test_models_math.py."""
    b, s, h, p = xh.shape
    n = bmat.shape[-1]
    state = np.zeros((b, h, p, n), np.float64)
    ys = np.zeros((b, s, h, p), np.float64)
    da = np.exp(-(dt * a[None, None]))
    for t in range(s):
        state = state * da[:, t][..., None, None] + np.einsum(
            "bh,bn,bhp->bhpn", dt[:, t], bmat[:, t], xh[:, t].astype(np.float64))
        ys[:, t] = np.einsum("bn,bhpn->bhp", cmat[:, t], state)
    return ys


def _ssd_inputs(b, s, h, p, n, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, s, h, p)).astype(np.float32),
            rng.uniform(0.1, 0.9, (b, s, h)).astype(np.float32),
            rng.uniform(0.5, 2.0, (h,)).astype(np.float32),
            rng.standard_normal((b, s, n)).astype(np.float32),
            rng.standard_normal((b, s, n)).astype(np.float32))


@pytest.mark.parametrize("s,chunk", [(32, 8), (64, 16), (64, 64), (20, 32)])
def test_ssd_forward_matches_reference_and_sequential_oracle(s, chunk):
    args = _ssd_inputs(2, s, 3, 4, 5, seed=s + chunk)
    y, hf = ssd_forward(*(torch.from_numpy(a) for a in args), chunk)
    ry, rhf = r_ssd_forward(*(jnp.asarray(a) for a in args), chunk)
    np.testing.assert_allclose(y.numpy(), np.asarray(ry), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(hf.numpy(), np.asarray(rhf), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(y.numpy(), _sequential(*args), rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("s,chunk", [(33, 16), (701, 256)])
def test_ssd_forward_refuses_what_the_reference_refuses(s, chunk):
    args = _ssd_inputs(1, s, 1, 2, 2, seed=s)
    with pytest.raises(AssertionError, match="divisible"):
        r_ssd_forward(*(jnp.asarray(a) for a in args), chunk)
    with pytest.raises(ValueError, match="divisible"):
        ssd_forward(*(torch.from_numpy(a) for a in args), chunk)


def test_masked_decay_is_the_reference_constant():
    """-60, not -inf: exp(-60) ≈ 8.8e-27 reaches the weights."""
    assert MASKED_DECAY == -60.0 and np.exp(MASKED_DECAY) > 0
