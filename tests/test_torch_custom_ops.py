"""The LM kernels as `torch.library` custom ops (`repro_torch::FlashAttention`,
``FlashAttentionBackward``, ``GroupedMatmul``, ``SSDScan``,
``SSDScanBackward``), on the host.

* `torch.library.opcheck` passes for each op (schema, autograd
  registration, fake tensors against the CPU implementation, AOT dispatch).
* Outputs and gradients through each op equal the plain versions bit for
  bit: the CPU implementation is the plain version, and the autograd rule
  runs the backward op, whose CPU implementation is the plain backward.
* Under `FakeTensorMode` each op's outputs have the shapes and dtypes of
  the real ones (the kernels' outputs: flash's ``o`` and ``lse``, the
  scan's ``h_prev`` and ``h_final``).
* `FlopCounterMode` counts flash at 4·d a (query, key) pair the masks
  keep forward and 14·d backward, the GMM at 2·e·c·d·f, and the scans at
  0 (elementwise recurrences), against closed forms at causal, window,
  offset and cross-attention shapes.

Inputs come from numpy generators with fixed seeds, in float32 unless a
test says otherwise.
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402
from torch.utils.flop_counter import FlopCounterMode  # noqa: E402

from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import moe_gmm as gmm  # noqa: E402
from repro_torch.kernels import ssd_scan as ss  # noqa: E402

OPS = torch.ops.repro_torch


def _t(rng, shape, dtype=torch.float32, grad=False):
    t = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dtype)
    return t.requires_grad_() if grad else t


def _flash_args(seed=0, b=2, sq=12, skv=12, h=4, kvh=2, d=16, grad=True,
                dtype=torch.float32):
    rng = np.random.default_rng(seed)
    return tuple(_t(rng, s, dtype, grad) for s in
                 ((b, sq, h, d), (b, skv, kvh, d), (b, skv, kvh, d)))


# (causal, q_offset, window, softcap, sq, skv)
FLASH_MASKS = [(True, 0, 0, 0.0, 12, 12), (True, 3, 5, 0.0, 9, 12),
               (False, 0, 0, 5.0, 7, 12), (True, 0, 4, 30.0, 12, 12)]


# -- opcheck -----------------------------------------------------------------

@pytest.mark.parametrize("causal,q_offset,window,softcap,sq,skv", FLASH_MASKS)
def test_opcheck_flash_forward(causal, q_offset, window, softcap, sq, skv):
    q, k, v = _flash_args(sq=sq, skv=skv)
    torch.library.opcheck(OPS.FlashAttention.default,
                          (q, k, v, causal, q_offset, window, softcap, True))
    torch.library.opcheck(OPS.FlashAttention.default,
                          (q.detach(), k.detach(), v.detach(), causal, q_offset,
                           window, softcap, False))


@pytest.mark.parametrize("causal,q_offset,window,softcap,sq,skv", FLASH_MASKS)
def test_opcheck_flash_backward(causal, q_offset, window, softcap, sq, skv):
    q, k, v = _flash_args(sq=sq, skv=skv, grad=False)
    kw = {"causal": causal, "q_offset": q_offset, "window": window, "softcap": softcap}
    o = fa.flash_attention_plain(q, k, v, **kw)
    lse = fa.flash_lse_plain(q, k, **kw)
    do = _t(np.random.default_rng(5), tuple(q.shape))
    torch.library.opcheck(OPS.FlashAttentionBackward.default,
                          (q, k, v, o, lse, do, causal, q_offset, window, softcap))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_opcheck_gmm(dtype):
    rng = np.random.default_rng(1)
    x, w = _t(rng, (3, 10, 6), dtype, True), _t(rng, (3, 6, 5), dtype, True)
    torch.library.opcheck(OPS.GroupedMatmul.default, (x, w))


@pytest.mark.parametrize("decay_dtype", [torch.float32, torch.bfloat16])
def test_opcheck_ssd_scan(decay_dtype):
    rng = np.random.default_rng(2)
    s = _t(rng, (4, 2, 3, 5, 6), grad=True)
    d = torch.from_numpy(rng.uniform(0.5, 1.0, (4, 2, 3)).astype(np.float32)) \
        .to(decay_dtype).requires_grad_()
    torch.library.opcheck(OPS.SSDScan.default, (s, d))


@pytest.mark.parametrize("final", [True, False])
def test_opcheck_ssd_scan_backward(final):
    rng = np.random.default_rng(3)
    hp, gp = _t(rng, (4, 2, 3, 5, 6)), _t(rng, (4, 2, 3, 5, 6))
    gf = _t(rng, (2, 3, 5, 6)) if final else None
    d = torch.from_numpy(rng.uniform(0.5, 1.0, (4, 2, 3)).astype(np.float32))
    torch.library.opcheck(OPS.SSDScanBackward.default, (gp, gf, hp, d))


# -- the ops against the plain versions --------------------------------------

@pytest.mark.parametrize("causal,q_offset,window,softcap,sq,skv", FLASH_MASKS)
def test_flash_op_and_gradients_equal_the_plain_versions(causal, q_offset, window,
                                                         softcap, sq, skv):
    kw = {"causal": causal, "q_offset": q_offset, "window": window, "softcap": softcap}
    q, k, v = _flash_args(seed=7, sq=sq, skv=skv)
    o = fa.flash_attention(q, k, v, **kw)
    assert "FlashAttention" in type(o.grad_fn).__name__
    do = _t(np.random.default_rng(8), tuple(o.shape))
    got = torch.autograd.grad(o, (q, k, v), do)
    qd, kd, vd = q.detach(), k.detach(), v.detach()
    want_o = fa.flash_attention_plain(qd, kd, vd, **kw)
    lse = fa.flash_lse_plain(qd, kd, **kw)
    want = fa.flash_attention_backward_plain(qd, kd, vd, want_o, lse, do, **kw)
    assert torch.equal(o.detach(), want_o)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    o2, lse2 = OPS.FlashAttention(qd, kd, vd, causal, q_offset, window, softcap, True)
    assert torch.equal(o2, want_o) and torch.equal(lse2, lse)


def test_gmm_op_and_gradients_equal_the_plain_version():
    rng = np.random.default_rng(9)
    x, w = _t(rng, (4, 16, 8), grad=True), _t(rng, (4, 8, 12), grad=True)
    y = gmm.moe_gmm(x, w)
    assert "GroupedMatmul" in type(y.grad_fn).__name__
    dy = _t(rng, (4, 16, 12))
    gx, gw = torch.autograd.grad(y, (x, w), dy)
    xd, wd = x.detach(), w.detach()
    assert torch.equal(y.detach(), gmm.moe_gmm_plain(xd, wd))
    assert torch.equal(gx, gmm.moe_gmm_plain(dy, wd.transpose(1, 2).contiguous()))
    assert torch.equal(gw, gmm.moe_gmm_plain(xd.transpose(1, 2).contiguous(), dy))


@pytest.mark.parametrize("drop_final", [False, True])
def test_scan_op_and_gradients_equal_the_plain_versions(drop_final):
    rng = np.random.default_rng(10)
    s = _t(rng, (5, 2, 3, 4, 6), grad=True)
    d = torch.from_numpy(rng.uniform(0.5, 1.0, (5, 2, 3)).astype(np.float32)).requires_grad_()
    hp, hf = ss.ssd_scan(s, d)
    assert "SSDScan" in type(hp.grad_fn).__name__
    gp = _t(rng, tuple(hp.shape))
    gf = None if drop_final else _t(rng, tuple(hf.shape))
    outs, grads = ((hp,), (gp,)) if drop_final else ((hp, hf), (gp, gf))
    got = torch.autograd.grad(outs, (s, d), grads)
    want_hp, want_hf = ss.ssd_scan_plain(s.detach(), d.detach())
    assert torch.equal(hp.detach(), want_hp) and torch.equal(hf.detach(), want_hf)
    want = ss.ssd_scan_backward_plain(gp, gf, want_hp, d.detach())
    assert all(torch.equal(g, w) for g, w in zip(got, want))


# -- fake tensors --------------------------------------------------------------

def _meta(ts):
    return [(tuple(t.shape), t.dtype) for t in ts]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fake_outputs_have_the_real_shapes_and_dtypes(dtype):
    rng = np.random.default_rng(11)
    shapes = {"q": (2, 9, 4, 16), "k": (2, 12, 2, 16), "x": (3, 10, 6), "w": (3, 6, 5),
              "s": (4, 2, 3, 5, 6), "d": (4, 2, 3), "hf": (2, 3, 5, 6)}
    real = {n: _t(rng, s, dtype) for n, s in shapes.items()}
    real["v"] = real["k"].clone()
    real["d"] = real["d"].abs() / 4 + 0.5

    def calls(t):
        o, lse = OPS.FlashAttention(t["q"], t["k"], t["v"], True, 3, 0, 0.0, True)
        return {
            "flash": (o, lse),
            "flash_no_lse": OPS.FlashAttention(t["q"], t["k"], t["v"], True, 3, 0, 0.0,
                                               False),
            "flash_bwd": OPS.FlashAttentionBackward(t["q"], t["k"], t["v"], o,
                                                    lse, o, True, 3, 0, 0.0),
            "gmm": (OPS.GroupedMatmul(t["x"], t["w"]),),
            "scan": OPS.SSDScan(t["s"], t["d"]),
            "scan_bwd": OPS.SSDScanBackward(t["s"], t["hf"], t["s"], t["d"]),
        }

    want = calls(real)
    with FakeTensorMode(allow_non_fake_inputs=False) as mode:
        fake = {n: mode.from_tensor(t) for n, t in real.items()}
        got = calls(fake)
    for name in want:
        assert _meta(got[name]) == _meta(want[name]), name
    assert tuple(want["flash"][1].shape) == (2, 4, 9)
    assert tuple(want["scan"][1].shape) == (2, 3, 5, 6)


# -- FLOP formulas -------------------------------------------------------------

def _pairs_closed_form(sq, skv, causal, window, q_offset):
    total = 0
    for i in range(sq):
        p = i + q_offset
        hi = min(p, skv - 1) if causal else skv - 1
        lo = max(0, p - window + 1) if window else 0
        total += max(0, hi - lo + 1)
    return total


@pytest.mark.parametrize("sq,skv,causal,window,q_offset,expect", [
    (12, 12, True, 0, 0, 12 * 13 // 2),          # causal: n(n+1)/2
    (12, 12, True, 4, 0, 4 * 12 - 6),            # window 4: Σ min(i+1, 4)
    (7, 12, False, 0, 0, 7 * 12),                # cross-attention: sq·skv
    (9, 12, True, 5, 3, None),                   # window and offset
])
def test_flash_flop_formulas_are_the_closed_forms(sq, skv, causal, window, q_offset,
                                                  expect):
    pairs = _pairs_closed_form(sq, skv, causal, window, q_offset)
    if expect is not None:
        assert pairs == expect
    assert fa.flash_pairs(sq, skv, causal, window, q_offset) == pairs
    b, h, kvh, d = 2, 4, 2, 16
    q, k, v = _flash_args(seed=12, b=b, sq=sq, skv=skv, h=h, kvh=kvh, d=d)
    with FlopCounterMode(display=False) as fwd:
        o = fa.flash_attention(q, k, v, causal=causal, q_offset=q_offset, window=window)
    with FlopCounterMode(display=False) as bwd:
        o.sum().backward()
    assert fwd.get_total_flops() == 4 * d * b * h * pairs
    assert bwd.get_total_flops() == 14 * d * b * h * pairs


def _chip_smoke():
    import importlib.util
    from pathlib import Path

    spec = importlib.util.spec_from_file_location(
        "chip_smoke_for_pairs", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_the_ports_flash_pairs_is_chip_smokes():
    """chip_smoke.py keeps its own pair count for the flash bounds; the
    port's copy, which the FLOP formulas count with, agrees with it at
    q_offset 0 (the only offset chip_smoke times)."""
    smoke = _chip_smoke()
    for sq, skv in ((1, 1), (12, 12), (7, 12), (12, 7), (64, 1500), (448, 448)):
        for causal in (True, False):
            for window in (0, 1, 4, 100):
                assert fa.flash_pairs(sq, skv, causal, window) == \
                    smoke.flash_pairs(sq, skv, causal, window), (sq, skv, causal, window)


def test_gmm_and_scan_flop_formulas():
    rng = np.random.default_rng(13)
    e, c, d, f = 3, 10, 6, 5
    x, w = _t(rng, (e, c, d), grad=True), _t(rng, (e, d, f), grad=True)
    with FlopCounterMode(display=False) as fwd:
        y = gmm.moe_gmm(x, w)
    with FlopCounterMode(display=False) as bwd:
        y.sum().backward()
    assert fwd.get_total_flops() == 2 * e * c * d * f
    assert bwd.get_total_flops() == 2 * (2 * e * c * d * f)      # dX and dW
    s = _t(rng, (4, 2, 3, 5, 6), grad=True)
    dec = torch.full((4, 2, 3), 0.9, requires_grad=True)
    with FlopCounterMode(display=False) as scan:
        hp, _ = ss.ssd_scan(s, dec)
        hp.sum().backward()
    assert scan.get_total_flops() == 0
