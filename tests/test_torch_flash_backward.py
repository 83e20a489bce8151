"""Gradients of the port's flash attention and grouped expert matmul on
the host, against the reference's.

The backward kernel on the card (``csrc/flash_attention_bwd.cu``) is held
against `flash_attention_backward_plain` in chip_smoke.py and
tests/test_torch_cuda_kernels.py; here that plain backward is held
  * against ``torch.autograd`` of `flash_attention_plain`, and
  * against ``jax.grad`` of the reference's ``naive_attention`` and
    ``chunked_attention`` (``q_chunk`` 64, so several chunks and a padded
    one),
for causal and non-causal attention, sq != skv and h / kvh in {1, 2, 4},
each with windows {0, 8, 100} and softcaps {0, 5, 50} (a window of 8
hides every key from the last rows of the non-causal cross-attention
case, whose forward averages V: the reference's masked softmax gives
those rows no dq and dk), and `flash_attention`'s autograd path
(`FlashAttention`) gives the same gradients.  Inputs come from a numpy
seed.  Tolerance: 1e-5 of the largest |gradient| in float32 (the same
function; only the order of float32 sums differs).

The bfloat16 kernel on the card rounds P and dS to bfloat16 before the
dV, dK and dQ products (float32 sums, one final rounding), dS after the
softcap's factor 1 - t².  A torch emulation of those rounding points is
held to
`flash_attention_backward_plain` within the card's gates, which the kernel
meets there: 2e-2 of the output's max (chip_smoke.py's ``LM_TOL``) and,
row by row, 1.6e-2 of each row's max floored at 2^-8 of the output's
(``FLASH_ROW_TOL``, ``FLASH_BWD_ROW_FLOOR``), at the shapes of the
``cuda`` test (tests/test_torch_cuda_kernels.py).

The GMM's autograd (`GroupedMatmul`: both backward products through the
GMM itself) is held against ``jax.grad`` of the reference's
``moe_gmm_ref`` at 1e-5, in float32, and in bfloat16 against the same
gradient computed from float32 copies at one bfloat16 rounding (2^-7 of
the largest value).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.ref import moe_gmm_ref  # noqa: E402
from repro.models import attention as rattn  # noqa: E402

from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import moe_gmm as gmm  # noqa: E402

TOL = 1e-5                              # × max |gradient|, float32

# (b, sq, skv, h, kvh, d, causal, q_offset)
SHAPES = [
    (2, 37, 37, 4, 4, 16, True, 0),
    (2, 37, 37, 4, 2, 16, True, 0),
    (1, 150, 150, 4, 1, 32, True, 0),       # three query chunks of 64, padded
    (2, 40, 29, 4, 2, 16, False, 0),        # cross-attention, sq != skv
    (1, 130, 70, 8, 2, 32, False, 0),
    (2, 20, 45, 4, 4, 16, True, 25),        # decode-style offset, causal
]
# Each shape with windows {0, 8, 100} × softcaps {0, 5, 50}:
# (b, sq, skv, h, kvh, d, causal, q_offset, window, softcap).
CASES = [shape + (window, cap) for shape in SHAPES for window in (0, 8, 100)
         for cap in (0.0, 5.0, 50.0)]


def _inputs(b, sq, skv, h, kvh, d, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, sq, h, d)).astype(np.float32),
            rng.standard_normal((b, skv, kvh, d)).astype(np.float32),
            rng.standard_normal((b, skv, kvh, d)).astype(np.float32),
            rng.standard_normal((b, sq, h, d)).astype(np.float32))


def _check(got, want, label):
    for name, g, w in zip("qkv", got, want):
        g, w = np.asarray(g, np.float64), np.asarray(w, np.float64)
        assert g.shape == w.shape, (label, name)
        err = np.abs(g - w).max() / np.abs(w).max()
        assert err <= TOL, f"{label} d{name}: {err}"


def _ref_grads(fn, q, k, v, do, **kw):
    def loss(q, k, v):
        return jnp.sum(fn(q, k, v, **kw) * do)
    return jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(t) for t in (q, k, v)))


def _kw(case) -> dict:
    *_, causal, off, window, cap = case
    return {"causal": causal, "q_offset": off, "window": window, "softcap": cap}


def _seed(case) -> int:
    return int(sum(case[:8]) + 7 * case[8] + case[9])


def _plain_backward(q, k, v, do, kw):
    qt, kt, vt, dot = (torch.from_numpy(t) for t in (q, k, v, do))
    o = fa.flash_attention_plain(qt, kt, vt, **kw)
    lse = fa.flash_lse_plain(qt, kt, **kw)
    return fa.flash_attention_backward_plain(qt, kt, vt, o, lse, dot, **kw)


@pytest.mark.parametrize("case", CASES, ids=str)
def test_plain_backward_matches_autograd_of_the_plain_forward(case):
    b, sq, skv, h, kvh, d = case[:6]
    q, k, v, do = _inputs(b, sq, skv, h, kvh, d, seed=_seed(case))
    ts = [torch.from_numpy(t).requires_grad_() for t in (q, k, v)]
    out = fa.flash_attention_plain(*ts, **_kw(case))
    want = torch.autograd.grad(out, ts, torch.from_numpy(do))
    _check([g.numpy() for g in _plain_backward(q, k, v, do, _kw(case))],
           [g.numpy() for g in want], "autograd")


@pytest.mark.parametrize("impl", ["naive", "chunked"])
@pytest.mark.parametrize("case", CASES, ids=str)
def test_plain_backward_matches_jax_grad_of_the_reference(case, impl):
    b, sq, skv, h, kvh, d, causal, off, window, cap = case
    q, k, v, do = _inputs(b, sq, skv, h, kvh, d, seed=_seed(case) + 1)
    kw = {"causal": causal, "q_offset": off, "window": window, "logit_softcap": cap}
    if impl == "chunked":
        fn, kw = rattn.chunked_attention, {**kw, "q_chunk": 64}
    else:
        fn = rattn.naive_attention
    want = _ref_grads(fn, q, k, v, do, **kw)
    _check([g.numpy() for g in _plain_backward(q, k, v, do, _kw(case))], want, impl)


@pytest.mark.parametrize("case", [c for c in CASES if c[:8] in SHAPES[:4]], ids=str)
def test_flash_attention_autograd_path_gives_the_plain_gradients(case):
    b, sq, skv, h, kvh, d = case[:6]
    q, k, v, do = _inputs(b, sq, skv, h, kvh, d, seed=_seed(case) + 2)
    ts = [torch.from_numpy(t).requires_grad_() for t in (q, k, v)]
    out = fa.flash_attention(*ts, **_kw(case))
    assert out.grad_fn is not None and "FlashAttention" in type(out.grad_fn).__name__
    np.testing.assert_array_equal(
        out.detach().numpy(),
        fa.flash_attention_plain(*(torch.from_numpy(t) for t in (q, k, v)),
                                 **_kw(case)).numpy())
    got = torch.autograd.grad(out, ts, torch.from_numpy(do))
    want = _plain_backward(q, k, v, do, _kw(case))
    for g, w in zip(got, want):
        assert torch.equal(g, w)


# Whisper's training cross-attention in miniature: non-causal, MHA, fewer
# queries than keys, and a key count that leaves a partial last 64-key tile
# (the card's call: 448 queries over 1,500 frames, d = 64).
CROSS_SHORT_Q = [(2, 56, 150, 4, 4, 16, False, 0), (1, 28, 94, 4, 4, 64, False, 0)]


@pytest.mark.parametrize("impl", ["naive", "chunked"])
@pytest.mark.parametrize("shape", CROSS_SHORT_Q, ids=str)
def test_cross_attention_with_fewer_queries_than_keys_matches_the_reference(
        shape, impl):
    b, sq, skv, h, kvh, d, causal, off = shape
    assert sq < skv and skv % 64 and not causal
    q, k, v, do = _inputs(b, sq, skv, h, kvh, d, seed=sq + skv + d)
    kw = {"causal": causal, "q_offset": off}
    if impl == "chunked":
        fn, kw = rattn.chunked_attention, {**kw, "q_chunk": 64}
    else:
        fn = rattn.naive_attention
    want = _ref_grads(fn, q, k, v, do, **kw)
    got = _plain_backward(q, k, v, do, {"causal": causal, "q_offset": off})
    _check([g.numpy() for g in got], want, impl)
    ts = [torch.from_numpy(t).requires_grad_() for t in (q, k, v)]
    auto = torch.autograd.grad(fa.flash_attention(*ts, causal=causal), ts,
                               torch.from_numpy(do))
    for g, w in zip(auto, got):
        assert torch.equal(g, w)


def test_lse_is_the_log_sum_exp_of_the_masked_scores():
    q, k, _, _ = _inputs(2, 33, 33, 4, 2, 16, seed=9)
    qt, kt = torch.from_numpy(q), torch.from_numpy(k)
    lse = fa.flash_lse_plain(qt, kt, causal=True)
    assert lse.shape == (2, 4, 33) and lse.dtype == torch.float32
    s = torch.einsum("bqhd,bkhd->bhqk", qt, kt.repeat_interleave(2, dim=2)) / 4.0
    s = s.masked_fill(torch.ones(33, 33, dtype=torch.bool).triu(1), -float("inf"))
    torch.testing.assert_close(lse, torch.logsumexp(s, -1), rtol=0, atol=1e-5)


def test_lse_with_window_and_softcap_is_that_of_the_capped_masked_scores():
    q, k, _, _ = _inputs(1, 40, 40, 4, 2, 16, seed=10)
    qt, kt = torch.from_numpy(q), torch.from_numpy(k)
    lse = fa.flash_lse_plain(qt, kt, causal=True, window=8, softcap=5.0)
    s = torch.einsum("bqhd,bkhd->bhqk", qt, kt.repeat_interleave(2, dim=2)) / 4.0
    s = torch.tanh(s / 5.0) * 5.0
    i, j = torch.arange(40)[:, None], torch.arange(40)[None, :]
    s = s.masked_fill((j > i) | (j <= i - 8), -float("inf"))
    torch.testing.assert_close(lse, torch.logsumexp(s, -1), rtol=0, atol=1e-5)


def test_no_gradient_asked_takes_the_plain_forward():
    q, k, v, _ = _inputs(1, 16, 16, 2, 2, 16, seed=4)
    out = fa.flash_attention(*(torch.from_numpy(t) for t in (q, k, v)))
    assert out.grad_fn is None


# -- the bfloat16 kernel's rounding points -------------------------------------------

BF16_TOL = 2e-2                         # chip_smoke.py's LM_TOL["bfloat16"]
ROW_TOL = 1.6e-2                        # FLASH_ROW_TOL
ROW_FLOOR = 2.0 ** -8                   # FLASH_BWD_ROW_FLOOR
LOG2E = 1.4426950408889634

# The cuda tests' shapes: (b, sq, skv, h, kvh, d, causal, q_offset, window,
# softcap, q's standard deviation); the last three as the card's gemma2
# calls (window, softcap 50 with q scaled so the cap bends the scores), a
# softcap of 5 at Granite's heads and a small window with an offset.
CARD_CASES = [
    (2, 256, 256, 16, 8, 64, True, 0, 0, 0.0, 1.0),
    (1, 1000, 1000, 4, 2, 64, True, 0, 0, 0.0, 1.0),
    (2, 77, 50, 4, 2, 32, False, 0, 0, 0.0, 1.0),
    (1, 33, 33, 8, 1, 128, True, 0, 0, 0.0, 1.0),
    (1, 20, 45, 4, 4, 16, True, 25, 0, 0.0, 1.0),
    (3, 5, 7, 2, 2, 16, False, 0, 0, 0.0, 1.0),
    (1, 600, 600, 8, 4, 128, True, 0, 200, 50.0, 8.0),
    (2, 256, 256, 16, 8, 64, True, 0, 0, 5.0, 1.0),
    (1, 200, 328, 8, 2, 16, True, 128, 100, 0.0, 1.0)]


def _bf16_kernel_emulation(q, k, v, o, lse, do, causal, q_offset, window=0,
                           softcap=0.0):
    """The tensor-core kernel's arithmetic in float32 torch: P =
    exp2(cap(S·scale)·log2 e − LSE·log2 e) (0 where masked), dS = P ∘
    (dP − D) ∘ (1 − t²) from the float32 P, t = tanh(S·scale / softcap),
    both rounded to bfloat16 before dV = Pᵀ·dO, dK = scale·dSᵀ·Q and
    dQ = scale·dS·K; float32 sums, one final rounding."""
    b, sq, h, d = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    rep, scale = h // kvh, 1.0 / np.sqrt(d)
    qf = q.float().reshape(b, sq, kvh, rep, d)
    dof = do.float().reshape(b, sq, kvh, rep, d)
    s = torch.einsum("bqgrd,bkgd->bgrqk", qf, k.float())
    lse2 = lse.reshape(b, kvh, rep, sq, 1) * np.float32(LOG2E)
    if softcap:
        t = torch.tanh(s * np.float32(scale / softcap))
        p = torch.exp2(t * np.float32(softcap * LOG2E) - lse2)
    else:
        p = torch.exp2(s * np.float32(scale * LOG2E) - lse2)
    if causal or window:
        p = p.masked_fill(fa.hidden_keys(sq, skv, causal=causal, q_offset=q_offset,
                                         window=window), 0.0)
    dp = torch.einsum("bqgrd,bkgd->bgrqk", dof, v.float())
    delta = (dof * o.float().reshape(b, sq, kvh, rep, d)).sum(-1)
    ds = p * (dp - delta.permute(0, 2, 3, 1)[..., None])
    if softcap:
        ds = ds * (1.0 - t * t)
    pb, dsb = p.bfloat16().float(), ds.bfloat16().float()
    dv = torch.einsum("bgrqk,bqgrd->bkgd", pb, dof)
    dk = torch.einsum("bgrqk,bqgrd->bkgd", dsb, qf) * np.float32(scale)
    dq = torch.einsum("bgrqk,bkgd->bqgrd", dsb, k.float()) * np.float32(scale)
    return (dq.reshape(b, sq, h, d).bfloat16(), dk.bfloat16(), dv.bfloat16())


@pytest.mark.parametrize("case", CARD_CASES, ids=str)
def test_bf16_rounding_points_fit_the_card_gates(case):
    b, sq, skv, h, kvh, d, causal, off, window, cap, q_scale = case
    rng = np.random.default_rng(sq + skv + h + d)      # the cuda test's inputs
    q, k, v, do = (torch.from_numpy((rng.standard_normal(shape) * sc).astype(np.float32)
                                    ).bfloat16()
                   for shape, sc in (((b, sq, h, d), q_scale), ((b, skv, kvh, d), 1.0),
                                     ((b, skv, kvh, d), 1.0), ((b, sq, h, d), 1.0)))
    kw = {"causal": causal, "q_offset": off, "window": window, "softcap": cap}
    o = fa.flash_attention_plain(q, k, v, **kw)
    lse = fa.flash_lse_plain(q, k, **kw)
    got = _bf16_kernel_emulation(q, k, v, o, lse, do, causal, off, window, cap)
    want = fa.flash_attention_backward_plain(q, k, v, o, lse, do, **kw)
    for name, g, w in zip("qkv", got, want):
        assert g.dtype == w.dtype == torch.bfloat16 and g.shape == w.shape
        g, w = g.float(), w.float()
        top = float(w.abs().max())
        assert float((g - w).abs().max()) <= BF16_TOL * top, f"d{name}"
        rows = w.abs().amax(-1).clamp_min(ROW_FLOOR * top)
        assert float(((g - w).abs().amax(-1) / rows).max()) <= ROW_TOL, f"d{name} rows"


# -- the GMM ------------------------------------------------------------------------

@pytest.mark.parametrize("e,c,d,f", [(4, 16, 32, 24), (3, 33, 70, 17), (8, 40, 16, 8)])
def test_gmm_gradients_match_jax_grad_of_the_reference(e, c, d, f):
    rng = np.random.default_rng(e * c + d)
    x = rng.standard_normal((e, c, d)).astype(np.float32)
    w = (rng.standard_normal((e, d, f)) / np.sqrt(d)).astype(np.float32)
    dy = rng.standard_normal((e, c, f)).astype(np.float32)
    want = jax.grad(lambda x, w: jnp.sum(moe_gmm_ref(x, w) * dy), argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(w))
    xt, wt = torch.from_numpy(x).requires_grad_(), torch.from_numpy(w).requires_grad_()
    y = gmm.moe_gmm(xt, wt)
    assert "GroupedMatmul" in type(y.grad_fn).__name__
    got = torch.autograd.grad(y, (xt, wt), torch.from_numpy(dy))
    for g, r in zip(got, want):
        r = np.asarray(r)
        assert np.abs(g.numpy() - r).max() <= TOL * np.abs(r).max()


def test_gmm_backward_products_go_through_the_gmm(monkeypatch):
    calls = []
    real = gmm._gmm

    def counting(x, w):
        calls.append((tuple(x.shape), tuple(w.shape)))
        return real(x, w)

    monkeypatch.setattr(gmm, "_gmm", counting)
    x = torch.randn(3, 10, 6, requires_grad=True)
    w = torch.randn(3, 6, 5, requires_grad=True)
    gmm.moe_gmm(x, w).sum().backward()
    assert calls == [((3, 10, 6), (3, 6, 5)),
                     ((3, 10, 5), (3, 5, 6)),                 # dX = dY · wᵀ
                     ((3, 6, 10), (3, 10, 5))]                # dW = xᵀ · dY
    calls.clear()
    x2 = torch.randn(3, 10, 6)
    gmm.moe_gmm(x2, w).sum().backward()                      # only dW asked
    assert calls == [((3, 10, 6), (3, 6, 5)), ((3, 6, 10), (3, 10, 5))]


def test_gmm_bf16_gradients_are_in_the_compute_type():
    """bfloat16 operands (a float32 weight cast to bfloat16, as the MoE
    does): dX and dW come out of the GMM in bfloat16, and autograd casts
    dW back to the float32 leaf."""
    rng = np.random.default_rng(11)
    x = torch.from_numpy(rng.standard_normal((4, 24, 32)).astype(np.float32))
    w32 = torch.from_numpy((rng.standard_normal((4, 32, 16)) / 6).astype(np.float32))
    dy = torch.from_numpy(rng.standard_normal((4, 24, 16)).astype(np.float32))
    xb = x.to(torch.bfloat16).requires_grad_()
    w = w32.clone().requires_grad_()
    y = gmm.moe_gmm(xb, w.to(torch.bfloat16))
    gx, gw = torch.autograd.grad(y, (xb, w), dy.to(torch.bfloat16))
    assert gx.dtype == torch.bfloat16 and gw.dtype == torch.float32
    xf = xb.detach().float().requires_grad_()
    wf = w.detach().to(torch.bfloat16).float().requires_grad_()
    fx, fw = torch.autograd.grad(gmm.moe_gmm_plain(xf, wf), (xf, wf),
                                 dy.to(torch.bfloat16).float())
    for g, r in ((gx, fx), (gw, fw)):
        assert float((g.float() - r).abs().max()) <= 2 ** -7 * float(r.abs().max())
