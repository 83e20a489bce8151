"""The SSD's intra-chunk output (`repro_torch.kernels.ssd_intra`) on the host.

* `ssd_intra_plain` is the code `ssd_forward` ran before the kernel, bit
  for bit, forward and gradient, with and without a gradient asked.
* `ssd_intra_backward_plain`, the CPU implementation of the
  `SSDIntraBackward` op, equals autograd through `ssd_intra_plain`.
* `torch.library.opcheck` passes for `SSDIntra` and `SSDIntraBackward`;
  the ops and their gradients equal the plain versions; under
  `FakeTensorMode` their outputs have the real shapes; `FlopCounterMode`
  counts 2·p a causal (t, s) pair and head forward and 4·p backward.
* On the host every call, with a gradient or without, takes the plain
  version: the route follows the device alone.
* The terms the card's kernel skips (the tiles strictly above the
  diagonal, exp(−60)·cb·dt·x each) are below float32's resolution of y.

Inputs come from numpy generators with fixed seeds.
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402
from torch.utils.flop_counter import FlopCounterMode  # noqa: E402

from repro_torch.kernels import ssd_intra as si  # noqa: E402
from repro_torch.models.ssm import ssd_forward  # noqa: E402

OPS = torch.ops.repro_torch

# (b, c, q, h, p, n): a chunk shorter than a kernel tile, the reduced
# configs' chunk of 32, and a chunk of 100 (a sequence shorter than one).
SHAPES = [(2, 3, 7, 4, 8, 5), (1, 2, 32, 3, 16, 16), (1, 1, 100, 2, 4, 8)]


def _inputs(b, c, q, h, p, n, seed, dtype=torch.float32):
    """x, dt, cum, C and B as `ssd_forward` makes them: dt in (0.1, 0.9),
    cum the chunk's running sum of −a·dt."""
    rng = np.random.default_rng(seed)
    dt = rng.uniform(0.1, 0.9, (b, c, q, h))
    cum = np.cumsum(-dt * rng.uniform(0.05, 2.0, (h,)), axis=2)
    arrays = (rng.standard_normal((b, c, q, h, p)), dt, cum,
              rng.standard_normal((b, c, q, n)), rng.standard_normal((b, c, q, n)))
    return [torch.from_numpy(a.astype(np.float32)).to(dtype) for a in arrays]


def _before(cum, cr, br, dtr, xr, grad):
    """`ssd_forward`'s intra-chunk code before `ops.ssd_intra`, verbatim but
    for its inputs: y_intra (b, c, h, t, p)."""
    b, nc, q, h = cum.shape
    dev, f32 = xr.device, xr.dtype
    cum_h = cum.permute(0, 1, 3, 2).contiguous()
    tri = torch.ones((q, q), dtype=torch.bool, device=dev).tril()
    cb = (cr @ br.transpose(-1, -2))[:, :, None]
    dts = dtr.permute(0, 1, 3, 2)[:, :, :, None, :]
    if grad:
        w = torch.exp((cum_h[..., :, None] - cum_h[..., None, :])
                      .masked_fill(~tri, si.MASKED_DECAY)) * cb * dts
    else:
        w = torch.empty((b, nc, h, q, q), dtype=f32, device=dev)
        torch.sub(cum_h[..., :, None], cum_h[..., None, :], out=w)
        w.masked_fill_(~tri, si.MASKED_DECAY).exp_()
        w.mul_(cb).mul_(dts)
    return w @ xr.permute(0, 1, 3, 2, 4)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("grad", [False, True])
def test_plain_is_the_code_it_replaces_bit_for_bit(shape, grad):
    x, dt, cum, cmat, bmat = _inputs(*shape, seed=sum(shape))
    gy = torch.from_numpy(np.random.default_rng(1).standard_normal(
        tuple(x.shape)).astype(np.float32))

    def run(fn):
        leaves = [t.clone().requires_grad_(grad) for t in (x, dt, cum, cmat, bmat)]
        xl, dtl, cuml, cl, bl = leaves
        y = fn(xl, dtl, cuml, cl, bl)
        grads = torch.autograd.grad(y, leaves, gy) if grad else ()
        return y.detach(), grads

    y0, g0 = run(lambda xl, dtl, cuml, cl, bl: _before(
        cuml, cl, bl, dtl, xl, grad).permute(0, 1, 3, 2, 4))
    y1, g1 = run(lambda xl, dtl, cuml, cl, bl: si.ssd_intra_plain(
        xl, dtl, cuml, cl @ bl.transpose(-1, -2)))
    assert torch.equal(y0, y1)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_plain_backward_is_autograd_of_the_plain_version(shape, dtype):
    x, dt, cum, cmat, bmat = _inputs(*shape, seed=sum(shape) + 2, dtype=dtype)
    cb = cmat @ bmat.transpose(-1, -2)
    leaves = [t.requires_grad_() for t in (x, dt, cum, cb)]
    y = si.ssd_intra_plain(*leaves)
    dy = torch.from_numpy(np.random.default_rng(2).standard_normal(
        tuple(y.shape))).to(dtype)
    want = torch.autograd.grad(y, leaves, dy)
    got = si.ssd_intra_backward_plain(dy, *(t.detach() for t in leaves))
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.is_contiguous()
        assert torch.equal(g, w)


def _op_args(seed=0, grad=False, shape=(2, 2, 7, 3, 4, 5)):
    x, dt, cum, cmat, bmat = _inputs(*shape, seed=seed)
    return [t.requires_grad_(grad) for t in (x, dt, cum, cmat @ bmat.transpose(-1, -2))]


@pytest.mark.parametrize("q", [7, 32])
def test_opcheck_ssd_intra(q):
    torch.library.opcheck(OPS.SSDIntra.default,
                          tuple(_op_args(grad=True, shape=(1, 2, q, 3, 4, 5))))
    torch.library.opcheck(OPS.SSDIntra.default, tuple(_op_args(shape=(1, 2, q, 3, 4, 5))))


@pytest.mark.parametrize("q", [7, 32])
def test_opcheck_ssd_intra_backward(q):
    args = _op_args(seed=1, shape=(1, 2, q, 3, 4, 5))
    dy = torch.randn(tuple(args[0].shape), generator=torch.Generator().manual_seed(3))
    torch.library.opcheck(OPS.SSDIntraBackward.default, (dy, *args))


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_op_and_gradients_equal_the_plain_versions(shape):
    args = _op_args(seed=4, grad=True, shape=shape)
    y = si.SSDIntra(*args)
    assert "SSDIntra" in type(y.grad_fn).__name__ and y.is_contiguous()
    dy = torch.randn(tuple(y.shape), generator=torch.Generator().manual_seed(5))
    got = torch.autograd.grad(y, args, dy)
    plain = [t.detach() for t in args]
    assert torch.equal(y.detach(), si.ssd_intra_plain(*plain))
    want = si.ssd_intra_backward_plain(dy, *plain)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_host_calls_take_the_plain_version_with_and_without_a_gradient(monkeypatch):
    args = _op_args(seed=6, grad=True, shape=SHAPES[0])
    y = si.ssd_intra(*args)
    assert "SSDIntra" not in type(y.grad_fn).__name__
    with torch.no_grad():
        y0 = si.ssd_intra(*args)
    assert torch.equal(y0, y.detach())
    rng = np.random.default_rng(8)
    b, s, h, p, n = 2, 64, 3, 4, 5
    xh, bmat, cmat = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
                      for shape in ((b, s, h, p), (b, s, n), (b, s, n)))
    dt = torch.from_numpy(rng.uniform(0.1, 0.9, (b, s, h)).astype(np.float32))
    a = torch.from_numpy(rng.uniform(0.5, 2.0, (h,)).astype(np.float32))
    calls, real = [], si.ssd_intra_plain
    monkeypatch.setattr(si, "ssd_intra_plain",
                        lambda *a_: calls.append(torch.is_grad_enabled()) or real(*a_))
    with torch.no_grad():
        y_off, _ = ssd_forward(xh, dt, a, bmat, cmat, 16)
    y_on, _ = ssd_forward(xh.requires_grad_(), dt, a, bmat, cmat, 16)
    assert calls == [False, True]
    assert torch.equal(y_off, y_on.detach())


def test_entry_point_checks_shapes():
    x, dt, cum, cb = _op_args(shape=SHAPES[0])
    with pytest.raises(ValueError, match="cb"):
        si.ssd_intra(x, dt, cum, cb[:, :, :3])
    with pytest.raises(ValueError, match="x"):
        si.ssd_intra(x[0], dt, cum, cb)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_fake_outputs_have_the_real_shapes(shape):
    args = _op_args(seed=9, shape=shape)
    dy = torch.randn(tuple(args[0].shape), generator=torch.Generator().manual_seed(10))

    def calls(t):
        return [OPS.SSDIntra(*t[1:])] + list(OPS.SSDIntraBackward(*t))

    want = calls([dy] + args)
    with FakeTensorMode(allow_non_fake_inputs=False) as mode:
        got = calls([mode.from_tensor(t) for t in [dy] + args])
    assert [(tuple(t.shape), t.dtype) for t in got] == \
        [(tuple(t.shape), t.dtype) for t in want]
    b, c, q, h, p, _ = shape
    assert [tuple(t.shape) for t in got] == [(b, c, q, h, p), (b, c, q, h, p),
                                             (b, c, q, h), (b, c, q, h), (b, c, q, q)]


@pytest.mark.parametrize("q,pairs", [(1, 1), (7, 28), (32, 528), (100, 5050)])
def test_flop_formulas_count_the_causal_products(q, pairs):
    """2·p a pair (t, s ≤ t) and head forward, 4·p backward (dx and dw)."""
    b, c, h, p = 2, 3, 4, 8
    assert si.causal_pairs(q) == pairs
    args = _op_args(seed=q, grad=True, shape=(b, c, q, h, p, 5))
    with FlopCounterMode(display=False) as fwd:
        y = si.SSDIntra(*args)
    with FlopCounterMode(display=False) as bwd:
        y.sum().backward()
    assert fwd.get_total_flops() == 2 * p * b * c * h * pairs
    assert bwd.get_total_flops() == 4 * p * b * c * h * pairs


def test_the_skipped_tiles_are_below_float32_resolution():
    """At Mamba2's chunk (256, four tiles of 64) and its slowest decay rate
    (a = 1, A_log's init), the terms of the tiles strictly above the
    diagonal, which the card's kernel skips, change y by under 2^-24 of
    its largest value, in float64."""
    rng = np.random.default_rng(11)
    b, c, q, h, p, n = 1, 2, 256, 2, 8, 16
    dt = rng.uniform(0.001, 0.1, (b, c, q, h))
    cum = np.cumsum(-dt, axis=2)
    x = rng.standard_normal((b, c, q, h, p))
    cmat, bmat = rng.standard_normal((b, c, q, n)), rng.standard_normal((b, c, q, n))
    x, dt, cum, cmat, bmat = (torch.from_numpy(a) for a in (x, dt, cum, cmat, bmat))
    cb = cmat @ bmat.transpose(-1, -2)
    y = si.ssd_intra_plain(x, dt, cum, cb)
    tile = torch.arange(q) // 64
    upper = (tile[None, :] > tile[:, None]).to(cb.dtype)      # s's tile after t's
    w_upper = torch.exp(torch.full((q, q), si.MASKED_DECAY, dtype=cb.dtype)) * upper \
        * cb[:, :, None] * dt.permute(0, 1, 3, 2)[:, :, :, None, :]
    skipped = (w_upper @ x.permute(0, 1, 3, 2, 4)).permute(0, 1, 3, 2, 4)
    assert float(skipped.abs().max()) > 0
    assert float(skipped.abs().max()) < 2.0 ** -24 * float(y.abs().max())


def _chip_smoke():
    import importlib
    import sys
    from pathlib import Path

    root = str(Path(__file__).resolve().parents[1])
    if root not in sys.path:
        sys.path.insert(0, root)
    return importlib.import_module("chip_smoke")


@pytest.mark.parametrize("case", ["reduced", "short_7", "short_100"])
def test_chip_smoke_intra_gates_pass_the_plain_version_and_catch_faults(case):
    """chip_smoke's intra-chunk gate, fed the float32 plain version as the
    kernel, passes at its limits; a forward that drops the diagonal's
    terms (t = s) and a backward whose d cb misses one head's share fail
    it."""
    cs = _chip_smoke()
    label, b, c, q, h, n = next(k for k in cs.SSD_INTRA_CASES if k[0] == case)
    ins = cs._ssd_intra_inputs(b, c, q, h, n, torch.device("cpu"), seed=760)
    x, dt, cum, cb, dy = (ins[k] for k in ("x", "dt", "cum", "cb", "dy"))
    y32 = si.ssd_intra_plain(x, dt, cum, cb)
    y64 = si.ssd_intra_plain(*(t.double() for t in (x, dt, cum, cb)))
    readings = cs._intra_gate(case, ("y",), (y32,), (y32,), (y64,))
    assert readings["y"]["normwise"] <= cs.SSD_INTRA_TOL["y"]
    diag = torch.diagonal(cb, dim1=-2, dim2=-1)[..., None, None] * dt[..., None] * x
    with pytest.raises(AssertionError, match="y"):
        cs._intra_gate(case, ("y",), (y32 - diag,), (y32,), (y64,))

    names = ("dx", "ddt", "dcum", "dcb")
    g32 = si.ssd_intra_backward_plain(dy, x, dt, cum, cb)
    g64 = si.ssd_intra_backward_plain(*(t.double() for t in (dy, x, dt, cum, cb)))
    cs._intra_gate(case, names, g32, g32, g64)
    dy_cut = dy.clone()
    dy_cut[..., -1, :] = 0
    faulty = g32[:3] + (si.ssd_intra_backward_plain(dy_cut, x, dt, cum, cb)[3],)
    with pytest.raises(AssertionError, match="dcb"):
        cs._intra_gate(case, names, faulty, g32, g64)


def test_chip_smoke_intra_bound_counts_the_causal_products():
    cs = _chip_smoke()
    ms, by = cs.ssd_intra_bound(2, 8, 256, 80, 64, backward=False)
    assert by == "operations" and ms == pytest.approx(
        2 * 64 * 16 * 80 * si.causal_pairs(256) / cs.PEAK_F32_OPS_PER_S * 1e3)
    ms_b, by_b = cs.ssd_intra_bound(2, 8, 256, 80, 64, backward=True)
    assert by_b == "operations" and ms_b == pytest.approx(2 * ms)
