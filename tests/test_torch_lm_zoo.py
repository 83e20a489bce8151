"""The rest of the port's LM zoo held against the reference at reduced size:
gemma2 (local/global pairs, sliding window, logit softcaps), the VLM
(gated cross-attention over vision embeddings) and Whisper (the
encoder-decoder).  Same inputs, made with numpy; the reference's initial
parameters carried across by `repro_torch.convert.lm_params_from_reference`.

The reduced configs keep what these tests need to see:
  * gemma2: 4 layers (2 pairs), window 64 and softcaps 50 / 30; the
    forward runs 160 tokens, so the local layers mask keys, and the
    reference's ``chunked_attention`` (``q_chunk`` 64) takes its scan;
  * VLM: 2 groups of one self-attention layer and one cross-attention
    layer over 16 vision embeddings.  The reference initializes the gates
    to zero, so a wrong cross-attention would change no logit: the gates
    are set to `GATE` in the reference's tree before conversion (and in
    the port's own init where it runs alone);
  * Whisper: 2 encoder and 4 decoder layers over 64 frames.

Tolerances, as in tests/test_torch_lm.py:
  * float32 compute: 1e-5 (rtol and atol), the same function with float32
    sums in another order.  Decode runs with a float32 K/V cache (the
    reference's Whisper cache is bfloat16 whatever the compute type, so
    its float32 cache is built here with the reference's own layout);
  * bfloat16 compute: relative RMS error of the logits 2e-2; the port's
    attention keeps its probabilities in float32 where the reference
    rounds them to bfloat16;
  * the port's decode against its own forward: 1e-4 in float32, and the
    reference's own recipe (tests/test_models_math.py, bfloat16, 2e-2).
"""
import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as rget  # noqa: E402
from repro.models import attention as rattn  # noqa: E402
from repro.models import build_model as rbuild  # noqa: E402
from repro.models import encdec as renc  # noqa: E402
from repro.models import transformer as rtf  # noqa: E402

from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.convert import lm_params_from_reference  # noqa: E402
from repro_torch.models import attention, build_model, encdec, transformer  # noqa: E402
from repro_torch.models.layers import Params  # noqa: E402

# One intra-op thread per xdist worker's share of the cores: these tests
# run beside the reference's wall-clock profiling tests.
torch.set_num_threads(max(1, (os.cpu_count() or 1)
                          // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

ARCHS = ["gemma2-27b", "llama-3.2-vision-90b", "whisper-large-v3"]
F32_TOL = 1e-5
BF16_REL = 2e-2
GATE = 0.7
# Tokens of the forward tests: gemma2's past its reduced window of 64.
SEQ = {"gemma2-27b": 160, "llama-3.2-vision-90b": 40, "whisper-large-v3": 24}


def _cfgs(arch, compute_dtype):
    rcfg = dataclasses.replace(rget(arch).reduced(), compute_dtype=compute_dtype)
    cfg = dataclasses.replace(get_arch(arch).reduced(), compute_dtype=compute_dtype)
    return rcfg, cfg


def _pair(arch, compute_dtype, seed=1):
    rcfg, cfg = _cfgs(arch, compute_dtype)
    rm, m = rbuild(rcfg), build_model(cfg)
    rp = rm.init(jax.random.PRNGKey(seed))
    if cfg.cross_attn_every:
        rp["cross_layers"]["gate"] = jnp.full_like(rp["cross_layers"]["gate"], GATE)
    p = lm_params_from_reference(jax.tree_util.tree_map(np.asarray, rp), cfg,
                                 device="cpu")
    return rcfg, cfg, rm, m, rp, p


def _set_gates(p, cfg, value=GATE):
    if cfg.cross_attn_every:
        with torch.no_grad():
            for cp in p["cross_layers"]:
                cp["gate"].fill_(value)
    return p


def _tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s)).astype(np.int32)


def _frontend(cfg, b, seed):
    """The stub frontend's output: vision embeddings or audio frames."""
    rng = np.random.default_rng(seed)
    if cfg.family == "vlm":
        return {"vision_embeds": rng.standard_normal(
            (b, cfg.vision_seq, cfg.d_model)).astype(np.float32)}
    if cfg.family == "encdec":
        return {"frames": rng.standard_normal(
            (b, cfg.encoder_seq, cfg.d_model)).astype(np.float32)}
    return {}


def _batches(cfg, toks, extra, dtype=torch.float32):
    arrays = {"tokens": toks, "labels": toks, **extra}
    batch = {k: torch.from_numpy(v) if k in ("tokens", "labels")
             else torch.from_numpy(v).to(dtype) for k, v in arrays.items()}
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    rbatch = {k: jnp.asarray(v) if k in ("tokens", "labels") else jnp.asarray(v, jdt)
              for k, v in arrays.items()}
    return batch, rbatch


def _rel_rms(got, want):
    return float(np.sqrt(np.mean((got - want) ** 2)) / np.sqrt(np.mean(want ** 2)))


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_loss_match_reference_f32(arch):
    rcfg, cfg, rm, m, rp, p = _pair(arch, "float32")
    batch, rbatch = _batches(cfg, _tokens(cfg, 2, SEQ[arch], seed=2), _frontend(cfg, 2, 3))
    got = m.forward(p, batch)
    assert got.dtype == torch.float32 and got.shape == (2, SEQ[arch], cfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(rm.forward(rp, rbatch)),
                               rtol=F32_TOL, atol=F32_TOL)
    (loss, _), (rloss, _) = m.loss(p, batch), rm.loss(rp, rbatch)
    np.testing.assert_allclose(float(loss), float(rloss), rtol=F32_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference_bf16(arch):
    _, cfg, rm, m, rp, p = _pair(arch, "bfloat16")
    batch, rbatch = _batches(cfg, _tokens(cfg, 2, SEQ[arch], seed=3),
                             _frontend(cfg, 2, 4), torch.bfloat16)
    got = m.forward(p, batch).numpy()
    assert _rel_rms(got, np.asarray(rm.forward(rp, rbatch))) <= BF16_REL


def _caches(rcfg, cfg, rm, m, b, max_len, dtype):
    """The reference's and the port's decode caches, both in ``dtype``."""
    if cfg.family == "encdec":
        jdt = jnp.dtype(dtype)
        shape = (cfg.num_layers, b, max_len, cfg.num_kv_heads, cfg.head_dim)
        rc = {"k": jnp.zeros(shape, jdt), "v": jnp.zeros(shape, jdt),
              "len": jnp.zeros((cfg.num_layers, b), jnp.int32)}
        return rc, encdec.init_encdec_cache(cfg, b, max_len, dtype, device="cpu")
    return (rtf.init_cache(rcfg, b, max_len, dtype),
            transformer.init_cache(cfg, b, max_len, dtype, device="cpu"))


def _decode_extras(cfg, rcfg, p, rp, extra, dtype=torch.float32):
    """Each package's decode-step extras: the vision embeddings, or the
    encoder memory each computes from the same frames."""
    batch, rbatch = _batches(cfg, np.zeros((1, 1), np.int32), extra, dtype)
    if cfg.family == "vlm":
        return ({"vision_embeds": batch["vision_embeds"]},
                {"vision_embeds": rbatch["vision_embeds"]})
    if cfg.family == "encdec":
        return ({"memory": encdec.encode(p, batch["frames"], cfg)},
                {"memory": renc.encode(rp, rbatch["frames"], rcfg)})
    return {}, {}


def _decode_both(arch, compute_dtype, cache_dtype, b, steps, seed):
    rcfg, cfg, rm, m, rp, p = _pair(arch, compute_dtype)
    toks = _tokens(cfg, b, steps, seed=seed)
    dt = torch.float32 if compute_dtype == "float32" else torch.bfloat16
    ex, rex = _decode_extras(cfg, rcfg, p, rp, _frontend(cfg, b, seed + 1), dt)
    rc, c = _caches(rcfg, cfg, rm, m, b, 32, cache_dtype)
    step = jax.jit(rm.decode_step)
    out = []
    for t in range(steps):
        rl, rc = step(rp, {"token": jnp.asarray(toks[:, t:t + 1]), **rex}, rc)
        got, c = m.decode_step(p, {"token": torch.from_numpy(toks[:, t:t + 1]), **ex}, c)
        out.append((got.numpy(), np.asarray(rl)))
    return out, c, rc


def _stacks(cache):
    """(name, {'k', 'v', 'len'}) for each stacked cache of a model."""
    if "k" in cache:
        return [("decoder", cache)]
    return sorted(cache.items())


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_and_caches_match_reference_f32(arch):
    steps, c, rc = _decode_both(arch, "float32", "float32", b=3, steps=10, seed=4)
    for got, want in steps:
        np.testing.assert_allclose(got, want, rtol=F32_TOL, atol=F32_TOL)
    assert [n for n, _ in _stacks(c)] == [n for n, _ in _stacks(rc)]
    for (_, kv), (_, rkv) in zip(_stacks(c), _stacks(rc)):
        np.testing.assert_array_equal(kv["len"].numpy(), np.asarray(rkv["len"]))
        for name in ("k", "v"):
            np.testing.assert_allclose(kv[name].numpy(), np.asarray(rkv[name]),
                                       rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_match_reference_bf16_with_the_default_cache(arch):
    steps, c, _ = _decode_both(arch, "bfloat16", "bfloat16", b=2, steps=6, seed=5)
    assert all(kv["k"].dtype == torch.bfloat16 for _, kv in _stacks(c))
    for got, want in steps:
        assert _rel_rms(got, want) <= BF16_REL


def _own_consistency(arch, compute_dtype, cache_dtype, s, seed=6):
    """The port's forward on (1, s) tokens and its decode, token by token,
    from the port's own init with nonzero gates; last-position logits."""
    cfg = dataclasses.replace(get_arch(arch).reduced(), compute_dtype=compute_dtype)
    m = build_model(cfg)
    p = _set_gates(m.init(7, device="cpu"), cfg)
    dt = torch.float32 if compute_dtype == "float32" else torch.bfloat16
    toks = _tokens(cfg, 1, s, seed)
    batch, _ = _batches(cfg, toks, _frontend(cfg, 1, seed + 1), dt)
    full = m.forward(p, batch)[:, -1]
    ex = {}
    if "vision_embeds" in batch:
        ex["vision_embeds"] = batch["vision_embeds"]
    if "frames" in batch:
        ex["memory"] = encdec.encode(p, batch["frames"], cfg)
    if cfg.family == "encdec":
        cache = encdec.init_encdec_cache(cfg, 1, s + 8, cache_dtype, device="cpu")
    else:
        cache = transformer.init_cache(cfg, 1, s + 8, cache_dtype, device="cpu")
    for t in range(s):
        logits, cache = m.decode_step(
            p, {"token": torch.from_numpy(toks[:, t:t + 1]), **ex}, cache)
    return logits.numpy(), full.numpy()


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_reproduces_forward_logits_f32(arch):
    got, want = _own_consistency(arch, "float32", "float32", s=16)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_gemma2_decode_reproduces_forward_past_the_window():
    """80 tokens through a window of 64: the last 16 positions' local
    layers mask keys, in the forward's flash path and in decode's."""
    got, want = _own_consistency("gemma2-27b", "float32", "float32", s=80)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_reproduces_forward_logits_bf16_reference_recipe(arch):
    """The reference's own test (tests/test_models_math.py:128-160):
    bfloat16, the model's default cache, 8 tokens, 2e-2; the gates are
    nonzero here."""
    cfg = get_arch(arch).reduced()
    m = build_model(cfg)
    p = _set_gates(m.init(1, device="cpu"), cfg)
    toks = _tokens(cfg, 1, 8, seed=8)
    batch, _ = _batches(cfg, toks, _frontend(cfg, 1, 9), torch.bfloat16)
    full = m.forward(p, batch)[:, -1]
    ex = {k: batch[k] for k in ("vision_embeds",) if k in batch}
    if "frames" in batch:
        ex["memory"] = encdec.encode(p, batch["frames"], cfg)
    cache = m.init_cache(1, 32, device="cpu")
    for t in range(8):
        logits, cache = m.decode_step(
            p, {"token": torch.from_numpy(toks[:, t:t + 1]), **ex}, cache)
    np.testing.assert_allclose(logits.numpy(), full.numpy(), rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("arch", ARCHS)
def test_port_init_has_the_reference_structure(arch):
    _, cfg, _, m, _, p_ref = _pair(arch, "bfloat16")
    p = m.init(0, device="cpu")
    shapes = {k: (tuple(v.shape), v.dtype) for k, v in p.named_parameters()}
    assert shapes == {k: (tuple(v.shape), v.dtype)
                      for k, v in p_ref.named_parameters()}
    again = m.init(0, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(p.parameters(), again.parameters()))
    if cfg.cross_attn_every:
        assert all(float(cp["gate"].abs().max()) == 0.0 for cp in p["cross_layers"])


def test_full_configs_build():
    for arch in ARCHS:
        m = build_model(get_arch(arch))
        assert m.cfg.name == arch


def test_encode_matches_reference():
    """The encoder alone (sinusoidal positions, RoPE and non-causal flash
    attention), from the same frames, float32."""
    rcfg, cfg, _, _, rp, p = _pair("whisper-large-v3", "float32")
    frames = _frontend(cfg, 2, 10)["frames"]
    got = encdec.encode(p, torch.from_numpy(frames), cfg)
    want = renc.encode(rp, jnp.asarray(frames), rcfg)
    assert got.shape == (2, cfg.encoder_seq, cfg.d_model)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=F32_TOL,
                               atol=F32_TOL)


@pytest.mark.parametrize("sq,skv", [(40, 16), (1, 64), (70, 70)])
def test_cross_attention_matches_reference(sq, skv):
    """One cross-attention layer alone: sq queries over skv memory rows
    (GQA, no mask, no RoPE), float32."""
    rcfg, cfg = _cfgs("llama-3.2-vision-90b", "float32")
    rp = rattn.cross_attention_init(jax.random.PRNGKey(sq + skv), rcfg)
    p = Params(jax.tree_util.tree_map(lambda a: torch.tensor(np.asarray(a)), rp))
    rng = np.random.default_rng(sq * skv)
    x = rng.standard_normal((2, sq, cfg.d_model)).astype(np.float32)
    mem = rng.standard_normal((2, skv, cfg.d_model)).astype(np.float32)
    got = attention.cross_attention(p, torch.from_numpy(x), torch.from_numpy(mem),
                                    cfg, torch.float32)
    want = rattn.cross_attention(rp, jnp.asarray(x), jnp.asarray(mem), rcfg,
                                 jnp.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=F32_TOL,
                               atol=F32_TOL)


def test_vlm_needs_vision_embeds():
    cfg = get_arch("llama-3.2-vision-90b").reduced()
    m = build_model(cfg)
    p = m.init(0, device="cpu")
    with pytest.raises(ValueError, match="vision_embeds"):
        m.forward(p, {"tokens": torch.zeros((1, 4), dtype=torch.long)})


def test_whisper_position_past_the_table_reads_nan_as_the_reference():
    """``jnp.take``'s fill mode: a decoder position past the learned table
    gives NaN logits in both packages; the positions before it do not."""
    rcfg, cfg, rm, m, rp, p = _pair("whisper-large-v3", "float32")
    n_pos = p["dec_pos"].shape[0]
    mem = encdec.encode(p, torch.from_numpy(_frontend(cfg, 2, 11)["frames"]), cfg)
    cache = encdec.init_encdec_cache(cfg, 2, 8, "float32", device="cpu")
    cache["len"][:, 1] = n_pos
    logits, _ = m.decode_step(p, {"token": torch.zeros((2, 1), dtype=torch.int32),
                                  "memory": mem}, cache)
    assert bool(torch.isfinite(logits[0]).all()) and bool(torch.isnan(logits[1]).all())
    rc = {k: jnp.asarray(np.asarray(v)) for k, v in
          encdec.init_encdec_cache(cfg, 2, 8, "float32", device="cpu").items()}
    rc["len"] = rc["len"].at[:, 1].set(n_pos)
    rmem = renc.encode(rp, jnp.asarray(_frontend(cfg, 2, 11)["frames"]), rcfg)
    rl, _ = renc.decode_step(rp, jnp.zeros((2, 1), jnp.int32), rc, rmem, rcfg)
    assert np.isnan(np.asarray(rl)[1]).all() and np.isfinite(np.asarray(rl)[0]).all()


def test_convert_checks_the_zoo_stacks():
    cfg = get_arch("llama-3.2-vision-90b").reduced()
    with pytest.raises(ValueError, match="self_layers"):
        lm_params_from_reference({"layers": {"w": np.zeros((4, 2))}}, cfg, device="cpu")
    with pytest.raises(ValueError, match="stacks cross_layers"):
        lm_params_from_reference({"self_layers": {"w": np.zeros((2, 1, 3))},
                                  "cross_layers": {"w": np.zeros((3, 1))}},
                                 cfg, device="cpu")
