"""The port's decoder LM (repro_torch.models) held against the reference
(repro.models) at reduced size: `Model.forward`, `loss` and a multi-step
`decode_step`, for reduced Granite-MoE (32 → 8 experts, top-2) and Qwen2
(dense, GQA, QKV bias), with the reference's initial parameters carried
across by `repro_torch.convert.lm_params_from_reference`.

Tolerances, and why:
  * float32 compute: 1e-5 (rtol and atol).  The same function; only the
    order of float32 sums differs.  Decode runs with a float32 K/V cache
    here: with the default bfloat16 cache, a key that lands within float32
    rounding of a bfloat16 midpoint rounds differently in the two
    packages, and that one bfloat16 step shows at 1e-4 in the logits.
  * bfloat16 compute, dense model: relative RMS error of the logits 2e-2
    (the reference's own bfloat16 tolerance, as a norm: elementwise, a few
    logits of magnitude near 1 sit one or two bfloat16 steps apart).  The
    flash kernel keeps attention probabilities in float32 where the
    reference rounds them to bfloat16, so the two differ by bfloat16
    rounding.
  * bfloat16 compute, MoE model: not compared logit by logit.  A rounding
    difference can move a near-tie in a token's top-k routing to another
    expert in one package and not the other, which changes that token by
    O(1) and, through attention, the tokens after it.  Measured on these
    reduced inputs, the reference's own bfloat16 logits lie 2–52% RMS from
    its float32 logits.  The bfloat16 MoE path is held through its parts,
    each from identical inputs, at 2e-2 (tests/test_torch_moe_gmm.py,
    tests/test_torch_flash_attention.py), and the whole stack in float32
    here; in bfloat16 the whole MoE stack is only required to run, with
    finite logits of the reference's shape and type.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as rget  # noqa: E402
from repro.models import build_model as rbuild  # noqa: E402
from repro.models import transformer as rtf  # noqa: E402

from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.convert import lm_params_from_reference  # noqa: E402
from repro_torch.models import build_model, transformer  # noqa: E402
from repro_torch.models.layers import Params  # noqa: E402

ARCHS = ["granite-moe-1b-a400m", "qwen2-72b"]
F32_TOL = 1e-5
BF16_REL = 2e-2


def _pair(arch, compute_dtype, seed=1, **over):
    rcfg = dataclasses.replace(rget(arch).reduced(), compute_dtype=compute_dtype,
                               **over)
    cfg = dataclasses.replace(get_arch(arch).reduced(),
                              compute_dtype=compute_dtype, **over)
    rm, m = rbuild(rcfg), build_model(cfg)
    rp = rm.init(jax.random.PRNGKey(seed))
    p = lm_params_from_reference(jax.tree_util.tree_map(np.asarray, rp), cfg,
                                 device="cpu")
    return rcfg, cfg, rm, m, rp, p


def _tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s)).astype(np.int32)


def _rel_rms(got, want):
    return float(np.sqrt(np.mean((got - want) ** 2)) / np.sqrt(np.mean(want ** 2)))


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_loss_match_reference_f32(arch):
    rcfg, cfg, rm, m, rp, p = _pair(arch, "float32")
    toks = _tokens(cfg, 2, 40, seed=2)
    batch = {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(toks)}
    rbatch = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(toks)}
    got = m.forward(p, batch)
    assert got.dtype == torch.float32 and got.shape == (2, 40, cfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(rm.forward(rp, rbatch)),
                               rtol=F32_TOL, atol=F32_TOL)
    (loss, metrics), (rloss, rmetrics) = m.loss(p, batch), rm.loss(rp, rbatch)
    np.testing.assert_allclose(float(loss), float(rloss), rtol=F32_TOL)
    np.testing.assert_allclose(float(metrics["aux"]), float(rmetrics["aux"]),
                               rtol=F32_TOL, atol=F32_TOL)


def test_forward_matches_reference_bf16_dense():
    _, cfg, rm, m, rp, p = _pair("qwen2-72b", "bfloat16")
    toks = _tokens(cfg, 2, 24, seed=3)
    got = m.forward(p, {"tokens": torch.from_numpy(toks)}).numpy()
    want = np.asarray(rm.forward(rp, {"tokens": jnp.asarray(toks)}))
    assert _rel_rms(got, want) <= BF16_REL


def _decode_both(rcfg, cfg, rm, m, rp, p, toks, cache_dtype):
    if cache_dtype == "float32":
        rc = rtf.init_cache(rcfg, toks.shape[0], 32, "float32")
        c = transformer.init_cache(cfg, toks.shape[0], 32, "float32", device="cpu")
    else:
        rc, c = rm.init_cache(toks.shape[0], 32), m.init_cache(toks.shape[0], 32,
                                                                device="cpu")
    step = jax.jit(rm.decode_step)
    steps = []
    for t in range(toks.shape[1]):
        rl, rc = step(rp, {"token": jnp.asarray(toks[:, t:t + 1])}, rc)
        got, c = m.decode_step(p, {"token": torch.from_numpy(toks[:, t:t + 1])}, c)
        steps.append((got.numpy(), np.asarray(rl)))
    return steps, c, rc


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_match_reference_f32(arch):
    rcfg, cfg, rm, m, rp, p = _pair(arch, "float32")
    toks = _tokens(cfg, 3, 10, seed=4)
    steps, c, rc = _decode_both(rcfg, cfg, rm, m, rp, p, toks, "float32")
    for got, want in steps:
        np.testing.assert_allclose(got, want, rtol=F32_TOL, atol=F32_TOL)
    np.testing.assert_array_equal(c["layers"]["len"].numpy(),
                                  np.asarray(rc["layers"]["len"]))
    np.testing.assert_allclose(c["layers"]["k"].numpy(),
                               np.asarray(rc["layers"]["k"]),
                               rtol=F32_TOL, atol=F32_TOL)


def test_decode_steps_match_reference_bf16_dense_with_the_default_cache():
    rcfg, cfg, rm, m, rp, p = _pair("qwen2-72b", "bfloat16")
    toks = _tokens(cfg, 2, 8, seed=5)
    steps, c, _ = _decode_both(rcfg, cfg, rm, m, rp, p, toks, "bfloat16")
    assert c["layers"]["k"].dtype == torch.bfloat16
    for got, want in steps:
        assert _rel_rms(got, want) <= BF16_REL


def test_moe_stack_runs_in_bf16_with_the_reference_shapes():
    rcfg, cfg, rm, m, rp, p = _pair("granite-moe-1b-a400m", "bfloat16")
    toks = _tokens(cfg, 2, 12, seed=3)
    got = m.forward(p, {"tokens": torch.from_numpy(toks)})
    want = rm.forward(rp, {"tokens": jnp.asarray(toks)})
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert bool(torch.isfinite(got).all())
    steps, c, rc = _decode_both(rcfg, cfg, rm, m, rp, p, toks[:, :4], "bfloat16")
    assert all(g.shape == w.shape and np.isfinite(g).all() for g, w in steps)
    assert c["layers"]["k"].dtype == torch.bfloat16


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_reproduces_forward_logits_f32(arch):
    """The port's own prefill/decode consistency, in float32 with a float32
    cache.  The MoE capacity factor is e/k so that the forward drops no
    assignment: at 1.25 a full expert queue drops its latest tokens in the
    forward, while a one-token decode step never drops (cap ≥ top_k), so
    the two differ by design (ROADMAP C)."""
    cfg = get_arch(arch).reduced()
    over = {"capacity_factor": cfg.num_experts / cfg.top_k} if cfg.num_experts else {}
    cfg = dataclasses.replace(cfg, compute_dtype="float32", **over)
    m = build_model(cfg)
    p = m.init(7, device="cpu")
    toks = torch.from_numpy(_tokens(cfg, 2, 16, seed=6))
    full = m.forward(p, {"tokens": toks})
    cache = transformer.init_cache(cfg, 2, 32, "float32", device="cpu")
    for t in range(toks.shape[1]):
        logits, cache = m.decode_step(p, {"token": toks[:, t:t + 1]}, cache)
    np.testing.assert_allclose(logits.numpy(), full[:, -1].numpy(),
                               rtol=1e-4, atol=1e-4)


def test_decode_reproduces_forward_logits_bf16_dense():
    """As the reference's own test (tests/test_models_math.py), for the
    dense model in bfloat16 with the default cache, at 2e-2."""
    cfg = get_arch("qwen2-72b").reduced()
    m = build_model(cfg)
    p = m.init(1, device="cpu")
    toks = torch.from_numpy(_tokens(cfg, 1, 8, seed=8))
    full = m.forward(p, {"tokens": toks})
    cache = m.init_cache(1, 32, device="cpu")
    for t in range(8):
        logits, cache = m.decode_step(p, {"token": toks[:, t:t + 1]}, cache)
    np.testing.assert_allclose(logits.numpy(), full[:, -1].numpy(),
                               rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("arch", ARCHS)
def test_port_init_has_the_reference_structure(arch):
    rcfg, cfg, _, m, _, p_ref = _pair(arch, "bfloat16")
    p = m.init(0, device="cpu")
    shapes = {k: (tuple(v.shape), v.dtype) for k, v in p.named_parameters()}
    assert shapes == {k: (tuple(v.shape), v.dtype)
                      for k, v in p_ref.named_parameters()}
    again = m.init(0, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(p.parameters(), again.parameters()))
    assert not any(t.requires_grad for t in p.parameters())


def test_params_cast_is_made_once_and_follows_in_place_changes():
    p = Params({"w": torch.ones(3)})
    a = p.cast("w", torch.bfloat16)
    assert a.dtype == torch.bfloat16 and p.cast("w", torch.bfloat16) is a
    assert p.cast("w", torch.float32) is p["w"]
    with torch.no_grad():
        p["w"].mul_(2)
    assert float(p.cast("w", torch.bfloat16)[0]) == 2.0


def test_scatter_cache_drops_writes_past_the_end():
    cache = torch.zeros((2, 4, 1, 2))
    new = torch.ones((2, 1, 1, 2))
    transformer._scatter_cache(cache, new, torch.tensor([1, 4]))
    assert cache[0, 1].sum() == 2 and cache[1].sum() == 0 and cache[0].sum() == 2
