"""The port's SSM and hybrid LMs (repro_torch.models: Mamba2 and Zamba2)
held against the reference (repro.models) at reduced size, with the
reference's initial parameters carried across by
`repro_torch.convert.lm_params_from_reference`: `Model.forward`, `loss`,
40 decode steps, the caches, and `ServeEngine` against the reference's
engine.  The builds are reduced ``mamba2-2.7b`` (4 layers), reduced
``zamba2-1.2b`` (4 layers, the shared block every 2: two groups, no tail)
and a Zamba2 variant with 5 layers (two groups and a one-layer tail).

Tolerances, and why:
  * float32 compute: 1e-5 (rtol and atol).  The same function; only the
    order of float32 sums in the SSD core's products differs.  The hybrid's
    shared-block K/V cache is bfloat16 in both packages whatever the
    compute type; the float32 comparisons put float32 K/V arrays into both
    packages' caches, because with bfloat16 a key within float32 rounding
    of a bfloat16 midpoint rounds differently in the two, and that one
    bfloat16 step shows at 1e-4 in the logits (as for the decoder,
    tests/test_torch_lm.py).
  * bfloat16 compute: the port's logits no farther (relative RMS) from
    the reference's float32 logits than the reference's own bfloat16
    logits are; for the SSM also within 2e-2 relative RMS of the
    reference's bfloat16 logits, the reference's own bfloat16 tolerance as
    a norm (see the test for why the hybrids are not held to that).
  * decode against the port's own forward: 1e-4 in float32 (chunked
    against sequential recurrence, float32 sums), and 5e-2 in bfloat16,
    the reference's own SSM tolerance (tests/test_models_math.py).
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
from repro.serving import ServeEngine as RefEngine  # noqa: E402

from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.convert import lm_params_from_reference  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.serving import ServeEngine  # noqa: E402

F32_TOL = 1e-5
BF16_REL = 2e-2
# (arch, overrides of its reduced config)
BUILDS = {"mamba2": ("mamba2-2.7b", {}), "zamba2": ("zamba2-1.2b", {}),
          "zamba2_tail": ("zamba2-1.2b", {"num_layers": 5})}


def _cfgs(name, compute_dtype):
    arch, over = BUILDS[name]
    rcfg = dataclasses.replace(rget(arch).reduced(), compute_dtype=compute_dtype,
                               **over)
    cfg = dataclasses.replace(get_arch(arch).reduced(),
                              compute_dtype=compute_dtype, **over)
    return rcfg, cfg


def _pair(name, compute_dtype, seed=1):
    rcfg, cfg = _cfgs(name, compute_dtype)
    rm, m = rbuild(rcfg), build_model(cfg)
    rp = rm.init(jax.random.PRNGKey(seed))
    p = lm_params_from_reference(jax.tree_util.tree_map(np.asarray, rp), cfg,
                                 device="cpu")
    return rcfg, cfg, rm, m, rp, p


@pytest.fixture(scope="module", params=list(BUILDS))
def f32(request):
    return _pair(request.param, "float32")


def _tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s)).astype(np.int32)


def _rel_rms(got, want):
    return float(np.sqrt(np.mean((got - want) ** 2)) / np.sqrt(np.mean(want ** 2)))


def _f32_kv(cache, zeros):
    """Float32 K/V arrays in a hybrid cache (see the module docstring)."""
    if isinstance(cache, dict) and "attn" in cache:
        cache["attn"]["k"] = zeros(cache["attn"]["k"].shape)
        cache["attn"]["v"] = zeros(cache["attn"]["v"].shape)
    return cache


def _ref_cache(rm, b, n):
    return _f32_kv(rm.init_cache(b, n), lambda s: jnp.zeros(s, jnp.float32))


def _port_cache(m, b, n, device="cpu"):
    return _f32_kv(m.init_cache(b, n, device=device),
                   lambda s: torch.zeros(s, device=device))


def test_forward_and_loss_match_reference_f32(f32):
    rcfg, cfg, rm, m, rp, p = f32
    toks = _tokens(cfg, 2, 96, seed=2)            # three chunks of 32
    batch = {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(toks)}
    rbatch = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(toks)}
    got = m.forward(p, batch)
    assert got.dtype == torch.float32 and got.shape == (2, 96, cfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(rm.forward(rp, rbatch)),
                               rtol=F32_TOL, atol=F32_TOL)
    (loss, metrics), (rloss, rmetrics) = m.loss(p, batch), rm.loss(rp, rbatch)
    np.testing.assert_allclose(float(loss), float(rloss), rtol=F32_TOL)
    assert set(metrics) == set(rmetrics) == {"nll"}


def test_decode_steps_and_caches_match_reference_f32(f32):
    rcfg, cfg, rm, m, rp, p = f32
    toks = _tokens(cfg, 3, 40, seed=4)
    rc, c = _ref_cache(rm, 3, 48), _port_cache(m, 3, 48)
    step = jax.jit(rm.decode_step)
    for t in range(toks.shape[1]):
        rl, rc = step(rp, {"token": jnp.asarray(toks[:, t:t + 1])}, rc)
        got, c = m.decode_step(p, {"token": torch.from_numpy(toks[:, t:t + 1])}, c)
        np.testing.assert_allclose(got.numpy(), np.asarray(rl), rtol=F32_TOL,
                                   atol=F32_TOL)
    _same_caches(rc, c)


def _same_caches(rc, c):
    if "attn" not in c:
        rc, c = {"mamba": rc}, {"mamba": c}
    for part in ("mamba", "tail"):
        if c.get(part) is None:
            assert rc.get(part) is None
            continue
        for k in ("conv", "state"):
            assert c[part][k].dtype == torch.float32
            np.testing.assert_allclose(c[part][k].numpy(), np.asarray(rc[part][k]),
                                       rtol=F32_TOL, atol=F32_TOL)
    if "attn" in c:
        np.testing.assert_array_equal(c["attn"]["len"].numpy(),
                                      np.asarray(rc["attn"]["len"]))
        np.testing.assert_allclose(c["attn"]["k"].numpy(),
                                   np.asarray(rc["attn"]["k"]),
                                   rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("name", list(BUILDS))
def test_forward_in_bf16_is_as_close_to_float32_as_the_reference(name):
    """Both packages' bfloat16 logits against the reference's float32
    logits: the port's may be no farther than the reference's own.  For the
    SSM the two bfloat16 forwards are also held to each other at 2e-2.  The
    hybrids are not: with attention and shared-block MLPs between the Mamba
    layers the bfloat16 noise grows with depth (measured here, the
    reference's own bfloat16 lies 2.0% (4 layers) and 2.2% (5 layers) RMS
    from its float32, and the port's about as far on another path)."""
    _, cfg, rm, m, rp, p = _pair(name, "bfloat16")
    rm32, rp32 = _f32_reference(name)
    toks = _tokens(cfg, 2, 64, seed=3)
    got = m.forward(p, {"tokens": torch.from_numpy(toks)}).numpy()
    want = np.asarray(rm.forward(rp, {"tokens": jnp.asarray(toks)}))
    truth = np.asarray(rm32.forward(rp32, {"tokens": jnp.asarray(toks)}))
    assert _rel_rms(got, truth) <= _rel_rms(want, truth)
    if cfg.family == "ssm":
        assert _rel_rms(got, want) <= BF16_REL


def _f32_reference(name):
    rcfg, _ = _cfgs(name, "float32")
    rm = rbuild(rcfg)
    return rm, rm.init(jax.random.PRNGKey(1))


@pytest.mark.parametrize("name", list(BUILDS))
def test_default_caches_have_the_reference_types(name):
    _, cfg, rm, m, _, _ = _pair(name, "bfloat16")
    c, rc = m.init_cache(2, 16, device="cpu"), rm.init_cache(2, 16)
    flat = jax.tree_util.tree_leaves_with_path(rc)
    assert len(flat) == sum(1 for _ in _leaves(c))
    for path, leaf in flat:
        node = c
        for key in path:
            node = node[key.key]
        assert tuple(node.shape) == leaf.shape
        assert str(node.dtype).replace("torch.", "") == str(leaf.dtype)


def _leaves(t):
    if isinstance(t, dict):
        for v in t.values():
            yield from _leaves(v)
    elif t is not None:
        yield t


@pytest.mark.parametrize("compute_dtype,tol", [("float32", 1e-4), ("bfloat16", 5e-2)])
@pytest.mark.parametrize("name", list(BUILDS))
def test_decode_reproduces_forward_logits(name, compute_dtype, tol):
    """The port's own prefill/decode consistency over two chunks."""
    _, cfg = _cfgs(name, compute_dtype)
    m = build_model(cfg)
    p = m.init(7, device="cpu")
    toks = torch.from_numpy(_tokens(cfg, 2, 64, seed=6))
    full = m.forward(p, {"tokens": toks})
    cache = (_port_cache(m, 2, 80) if compute_dtype == "float32"
             else m.init_cache(2, 80, device="cpu"))
    for t in range(toks.shape[1]):
        logits, cache = m.decode_step(p, {"token": toks[:, t:t + 1]}, cache)
    np.testing.assert_allclose(logits.numpy(), full[:, -1].numpy(), rtol=tol, atol=tol)


@pytest.mark.parametrize("name", list(BUILDS))
def test_port_init_has_the_reference_structure(name):
    _, cfg, _, m, _, p_ref = _pair(name, "bfloat16")
    p = m.init(0, device="cpu")
    shapes = {k: (tuple(v.shape), v.dtype) for k, v in p.named_parameters()}
    assert shapes == {k: (tuple(v.shape), v.dtype)
                      for k, v in p_ref.named_parameters()}
    again = m.init(0, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(p.parameters(), again.parameters()))
    assert not any(t.requires_grad for t in p.parameters())


@pytest.mark.parametrize("name", list(BUILDS))
def test_a_length_the_chunking_refuses_raises_in_both(name):
    rcfg, cfg, rm, m, rp, p = _pair(name, "float32")
    toks = _tokens(cfg, 1, 65, seed=9)           # 2 chunks of 32 leave one over
    with pytest.raises(AssertionError, match="divisible"):
        rm.forward(rp, {"tokens": jnp.asarray(toks)})
    with pytest.raises(ValueError, match="divisible"):
        m.forward(p, {"tokens": torch.from_numpy(toks)})


# -- conversion -------------------------------------------------------------------

def _np_tree(name):
    rcfg, cfg = _cfgs(name, "float32")
    rp = rbuild(rcfg).init(jax.random.PRNGKey(0))
    return jax.tree_util.tree_map(np.asarray, rp), cfg


def test_convert_unstacks_the_hybrid_groups_in_order():
    tree, cfg = _np_tree("zamba2_tail")
    p = lm_params_from_reference(tree, cfg, device="cpu")
    k = cfg.shared_attn_every
    assert len(p["mamba_groups"]) == 4 and len(p["tail_mamba"]) == 1
    stacked = tree["mamba_groups"]["in_proj"]["kernel"]
    for i, lp in enumerate(p["mamba_groups"]):
        np.testing.assert_array_equal(lp["in_proj"]["kernel"].numpy(),
                                      stacked[i // k, i % k])
    np.testing.assert_array_equal(p["tail_mamba"][0]["conv_w"].numpy(),
                                  tree["tail_mamba"]["conv_w"][0])


@pytest.mark.parametrize("case", ["ssm_layers", "hybrid_group_size",
                                  "hybrid_missing_tail", "hybrid_extra_tail"])
def test_convert_refuses_stacks_that_do_not_match_the_config(case):
    if case == "ssm_layers":
        tree, cfg = _np_tree("mamba2")
        tree["layers"] = jax.tree_util.tree_map(lambda a: a[:-1], tree["layers"])
    elif case == "hybrid_group_size":
        tree, cfg = _np_tree("zamba2")
        tree["mamba_groups"] = jax.tree_util.tree_map(lambda a: a[:, :1],
                                                      tree["mamba_groups"])
    elif case == "hybrid_missing_tail":
        tree, cfg = _np_tree("zamba2_tail")
        del tree["tail_mamba"]
    else:
        tree, cfg = _np_tree("zamba2")
        tree["tail_mamba"] = jax.tree_util.tree_map(lambda a: a[0][:1],
                                                    tree["mamba_groups"])
    with pytest.raises(ValueError, match="tail|stacks"):
        lm_params_from_reference(tree, cfg, device="cpu")


# -- serving ----------------------------------------------------------------------

def _engines(pair, slots, max_len):
    rcfg, cfg, rm, m, rp, p = pair
    rm = dataclasses.replace(rm, init_cache=lambda b, n: _ref_cache(
        rbuild(rcfg), b, n))
    m = dataclasses.replace(m, init_cache=lambda b, n, device: _port_cache(
        build_model(cfg), b, n, device))
    return (RefEngine(rm, rp, batch_slots=slots, max_len=max_len),
            ServeEngine(m, p, batch_slots=slots, max_len=max_len, device="cpu"))


def _requests(n, seed, vocab=512):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, vocab, int(rng.integers(1, 9))).astype(np.int32),
             int(rng.integers(2, 6))) for _ in range(n)]


def _drive(engine, requests):
    for prompt, new in requests:
        engine.submit(prompt, max_new_tokens=new)
    return engine.run(max_steps=200)


def test_engine_matches_reference_engine(f32):
    """More requests than slots, so freed slots are reused with the state
    they were left with."""
    ref, eng = _engines(f32, slots=2, max_len=96)
    reqs = _requests(5, seed=0)
    ref_done, done = _drive(ref, reqs), _drive(eng, reqs)
    assert len(done) == len(ref_done) == 5
    assert [r.generated for r in done] == [r.generated for r in ref_done]
    assert eng.stats()["steps"] == ref.stats()["steps"]
    _same_caches(ref.cache, eng.cache)


def test_prefill_of_one_slot_feeds_token_zero_through_every_slot(f32):
    ref, eng = _engines(f32, slots=2, max_len=32)
    for e in (ref, eng):
        e.submit(np.arange(1, 6, dtype=np.int32), max_new_tokens=3)
        e._admit()
    # The idle slot 1 went through 4 replay steps with token 0.
    assert bool((_states(eng)[:, 1].abs().sum(dim=(-1, -2, -3)) > 0).all())
    _same_caches(ref.cache, eng.cache)


def _states(engine):
    c = engine.cache
    return (c if "attn" not in c else c["mamba"])["state"]


def test_a_freed_slot_keeps_its_state(f32):
    ref, eng = _engines(f32, slots=1, max_len=48)
    first, second = (np.array([3, 4, 5], np.int32), 2), (np.array([7, 8], np.int32), 2)
    for e in (ref, eng):
        e.submit(*first)
        e.run()
    assert bool(_states(eng).abs().sum() > 0)
    fresh = _engines(f32, slots=1, max_len=48)[1]
    for e in (ref, eng, fresh):
        e.submit(*second)
        e._admit()
    # The replay step ran on the old state, not on a reset one.
    assert not torch.allclose(_states(eng), _states(fresh))
    _same_caches(ref.cache, eng.cache)
