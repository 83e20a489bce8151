"""The port's inter-chunk SSD scan and chunked SSD core held against the
reference.

`repro_torch.kernels.ssd_scan.ssd_scan_plain` (what CPU tensors take, and
what the CUDA kernel is held bit-equal to on the card) against the
reference's Pallas kernel run as ``tests/test_kernels.py`` runs it
(``repro.kernels.ops.ssd_scan``, interpret mode on the CPU) and against
its oracle ``repro.kernels.ref.ssd_scan_ref``; then the port's
`models.ssm.ssd_forward`, whose recurrence is one ``ssd_scan`` call,
against the reference's and against a float64 sequential oracle.  The
scan's backward, `ssd_scan_backward_plain` (what the card's backward
kernel is held to: ds bit-equal, ddecay within its sum bound), against
autograd of `ssd_scan_plain` and ``jax.vjp`` of the reference's
``ssd_scan_ref``, with and without an upstream gradient for h_final and
with decays of 0 and 1; and the gradients of the port's `ssd_forward`
(through `SSDScan`) against ``jax.grad`` of the reference's.

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
  * scan backward, ds: 1e-6 × max(1, |ds|) against both (the same float32
    multiply and add per chunk; XLA may contract them into one FMA).
    ddecay, a sum over P·N products: 2·(P·N)·2^-24·Σ|ds·h_prev| + 1e-30,
    the bound of a float32 sum in any order (the card's gate too).
  * ssd_forward's gradients vs jax.grad: 1e-5 of the largest |gradient|
    of each input, float32 sums in another order.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.kernels.ops as rops  # noqa: E402
import repro.kernels.ref as rref  # noqa: E402
from repro.models.ssm import ssd_forward as r_ssd_forward  # noqa: E402

from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.ssd_scan import (  # noqa: E402
    ssd_scan_backward_plain, ssd_scan_plain,
)
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


# -- the scan's backward -----------------------------------------------------------

U32 = 2.0 ** -24


def _ddecay_within(got, want, ds, h_prev):
    """ddecay against ``want`` within the bound of a float32 sum of P·N
    products in any order."""
    pn = h_prev.shape[-1] * h_prev.shape[-2]
    scale = (np.abs(np.asarray(ds, np.float64)) * np.abs(np.asarray(h_prev, np.float64))
             ).sum((-2, -1))
    err = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    assert np.all(err <= 2 * pn * U32 * scale + 1e-30), float(err.max())


def _bwd_inputs(shape, seed, decay=None):
    s, d = _inputs(shape, seed)
    if decay is not None:
        d = np.full_like(d, decay)
    rng = np.random.default_rng(seed + 1)
    return (s, d, rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(shape[1:]).astype(np.float32))


# The forward's shapes × decay (drawn, or all 0, or all 1) × g_final.
BWD_CASES = [(shape, decay, final) for shape in SHAPES for decay in (None, 0.0, 1.0)
             for final in (False, True)]


def _bwd_id(case):
    shape, decay, final = case
    return f"{shape}-decay{decay}-{'final' if final else 'no_final'}"


@pytest.mark.parametrize("case", BWD_CASES, ids=_bwd_id)
def test_plain_backward_matches_autograd_of_the_plain_scan(case):
    shape, decay, final = case
    s, d, gp, gf = _bwd_inputs(shape, sum(shape) + 3, decay)
    st, dt = torch.from_numpy(s).requires_grad_(), torch.from_numpy(d).requires_grad_()
    hp, hf = ssd_scan_plain(st, dt)
    loss = (hp * torch.from_numpy(gp)).sum()
    if final:
        loss = loss + (hf * torch.from_numpy(gf)).sum()
    # One chunk without g_final: h_prev is the zero state, no gradient.
    want = (torch.autograd.grad(loss, (st, dt), allow_unused=True,
                                materialize_grads=True)
            if loss.requires_grad else (torch.zeros_like(st), torch.zeros_like(dt)))
    ds, dd = ssd_scan_backward_plain(torch.from_numpy(gp),
                                     torch.from_numpy(gf) if final else None,
                                     hp.detach(), dt.detach())
    assert ds.dtype == torch.float32 and dd.dtype == torch.float32
    _within(ds.numpy(), want[0].numpy(), F32_TOL)
    _ddecay_within(dd.numpy(), want[1].numpy(), ds.numpy(), hp.detach().numpy())


@pytest.mark.parametrize("case", BWD_CASES, ids=_bwd_id)
def test_plain_backward_matches_jax_vjp_of_the_reference(case):
    shape, decay, final = case
    s, d, gp, gf = _bwd_inputs(shape, sum(shape) + 4, decay)
    (hp, _), vjp = jax.vjp(rref.ssd_scan_ref, jnp.asarray(s), jnp.asarray(d))
    want = vjp((jnp.asarray(gp), jnp.asarray(gf if final else np.zeros_like(gf))))
    ds, dd = ssd_scan_backward_plain(torch.from_numpy(gp),
                                     torch.from_numpy(gf) if final else None,
                                     torch.from_numpy(np.array(hp)), torch.from_numpy(d))
    _within(ds.numpy(), np.asarray(want[0]), F32_TOL)
    _ddecay_within(dd.numpy(), np.asarray(want[1]), ds.numpy(), np.asarray(hp))


@pytest.mark.parametrize("decay_dtype", ["float32", "bfloat16"])
def test_scan_autograd_goes_through_its_function_in_both_types(decay_dtype):
    """`ops.ssd_scan` with a gradient goes through `SSDScan`: the plain
    forward's outputs, and the plain backward's gradients in the inputs'
    types (bfloat16 s, and decay in either type)."""
    from repro_torch.kernels.ssd_scan import SSDScan  # noqa: F401

    s, d, gp, gf = _bwd_inputs((3, 1, 3, 5, 7), 11)
    st = torch.from_numpy(s).bfloat16().requires_grad_()
    dt = torch.from_numpy(d).to(getattr(torch, decay_dtype)).requires_grad_()
    hp, hf = ops.ssd_scan(st, dt)
    assert "SSDScan" in type(hp.grad_fn).__name__
    want_hp, want_hf = ssd_scan_plain(st.detach(), dt.detach())
    assert torch.equal(hp.detach(), want_hp) and torch.equal(hf.detach(), want_hf)
    gpt, gft = torch.from_numpy(gp).bfloat16(), torch.from_numpy(gf).bfloat16()
    got = torch.autograd.grad((hp, hf), (st, dt), (gpt, gft))
    want = ssd_scan_backward_plain(gpt, gft, want_hp, dt.detach())
    assert got[0].dtype == torch.bfloat16 and got[1].dtype == dt.dtype
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("s,chunk", [(32, 8), (64, 16), (64, 64), (20, 32)])
def test_ssd_forward_gradients_match_jax_grad_of_the_reference(s, chunk):
    args = _ssd_inputs(2, s, 3, 4, 5, seed=s + chunk + 1)
    rng = np.random.default_rng(s * chunk)
    gy = rng.standard_normal((2, s, 3, 4)).astype(np.float32)
    gh = rng.standard_normal((2, 3, 4, 5)).astype(np.float32)

    def rloss(*xs):
        y, hf = r_ssd_forward(*xs, chunk)
        return jnp.sum(y * gy) + jnp.sum(hf * gh)

    want = jax.grad(rloss, argnums=tuple(range(5)))(*(jnp.asarray(a) for a in args))
    ts = [torch.from_numpy(a).requires_grad_() for a in args]
    y, hf = ssd_forward(*ts, chunk)
    got = torch.autograd.grad((y * torch.from_numpy(gy)).sum()
                              + (hf * torch.from_numpy(gh)).sum(), ts)
    for name, g, w in zip(("xh", "dt", "a", "bmat", "cmat"), got, want):
        w = np.asarray(w)
        assert g.shape == w.shape
        assert np.abs(g.numpy() - w).max() <= 1e-5 * np.abs(w).max(), name


def test_ssd_forward_routes_give_one_result():
    """With and without a gradient, the chunked core computes the same
    numbers: the in-place serving route and the out-of-place training
    route are the same steps."""
    args = [torch.from_numpy(a) for a in _ssd_inputs(2, 64, 3, 4, 5, seed=77)]
    with torch.no_grad():
        y0, h0 = ssd_forward(*args, 16)
    y1, h1 = ssd_forward(*(a.clone().requires_grad_() for a in args), 16)
    assert y1.grad_fn is not None
    assert torch.equal(y0, y1.detach()) and torch.equal(h0, h1.detach())


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_plain_backward_does_not_read_the_first_chunks_upstream_gradient(shape):
    """g_prev[0] would only feed the gradient of the zero initial state:
    the backward (and the kernel, whose bound leaves it out) never reads
    it, so a NaN there changes neither output."""
    s, d, gp, gf = _bwd_inputs(shape, sum(shape) + 5)
    hp, _ = ssd_scan_plain(torch.from_numpy(s), torch.from_numpy(d))
    poisoned = gp.copy()
    poisoned[0] = np.nan
    want = ssd_scan_backward_plain(torch.from_numpy(gp), torch.from_numpy(gf), hp,
                                   torch.from_numpy(d))
    got = ssd_scan_backward_plain(torch.from_numpy(poisoned), torch.from_numpy(gf), hp,
                                  torch.from_numpy(d))
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def _chip_smoke():
    import importlib
    import sys
    from pathlib import Path

    root = str(Path(__file__).resolve().parents[1])
    if root not in sys.path:
        sys.path.insert(0, root)
    return importlib.import_module("chip_smoke")


@pytest.mark.parametrize("case", ["mamba2_train", "ragged", "bfloat16_decay"])
def test_ddecay_gates_pass_a_sound_sum_and_catch_a_dropped_warp(case):
    """chip_smoke's ddecay gates, fed the plain version as the kernel: the
    plain sum reads well inside the statistical limit, and a sum missing
    one warp's partial (the row's first 32 threads' products) fails it.
    Mamba2's training call is cut to one (b, h) row here."""
    cs = _chip_smoke()
    label, nc, b, h, p, n, dtype, ddtype, final = next(
        c for c in cs.SSD_BWD_CASES if c[0] == case)
    cpu = torch.device("cpu")
    gp, gf, hp, d = cs._ssd_bwd_inputs(nc, 1, 1, p, n, dtype, ddtype, final, cpu,
                                       seed=740)
    want = ssd_scan_backward_plain(gp, gf, hp, d)
    readings = cs.ddecay_gates(want, want, gp, gf, hp, d, ddtype, case)
    assert readings["ddecay_err_over_limit"] <= 1.0, readings
    assert readings["ddecay_sigmas"] is None or readings["ddecay_sigmas"] <= 0.1, readings
    warp = 32 * (4 if (p * n) % 4 == 0 else 1)
    x = (want[0].double() * hp.double()).flatten(-2)
    faulty = (want[0], (want[1].double() - x[..., :warp].sum(-1)).to(want[1].dtype))
    with pytest.raises(AssertionError, match="ddecay"):
        cs.ddecay_gates(faulty, want, gp, gf, hp, d, ddtype, case)
