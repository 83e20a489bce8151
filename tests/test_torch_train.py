"""The port's LM training (repro_torch.distributed.trainstep,
repro_torch.launch.train) against the reference's, on the host.

Both packages start from one reference state (``init_train_state`` of
the reference, carried over by `convert.train_state_from_reference`) and
take the same batches (`SyntheticLMData`, bit-equal in both); the
reference runs ``jax.jit(make_train_step(...))``, the port its
`make_train_step` with every kernel's plain version (flash attention's,
the GMM's and the SSD scan's backward included).  Reduced Granite-MoE,
Qwen2 (dense, GQA, QKV bias), Mamba2, Zamba2 (5 layers in groups of 2:
two groups and a tail), gemma2 (its local/global pairs, window 64 on
96 tokens, so the window hides keys, and softcaps 50 on the scores and
30 on the logits), the VLM (2 groups of a self- and a gated
cross-attention layer over 16 vision embeddings; the reference's zero
gates set to `GATE` in its tree before the state is carried over, so the
cross-attention gets a gradient) and Whisper (2 encoder and 4 decoder
layers over 64 frames) in float32 compute; the batches carry the stub
frontends' float32 vision embeddings and frames, as the reference's
driver builds them.

Tolerances, and why:
  * loss and grad norm after each of 3 steps: 1e-5 relative; with
    ``compression=True`` the grad norm 5e-5: an element whose gradient
    sits within a float32 rounding of a quantization midpoint rounds to
    another int8 value in the other package, one quantum (max|g| / 127)
    apart;
  * AdamW's moments after each step: 1e-5 of their largest value (the
    first moment is 0.1 × the clipped gradient after step 1, when the
    warm-up's rate is still 0);
  * parameters after 1 and 3 steps: 1e-5, except for the elements where
    AdamW divides float32 noise by float32 noise.  An element whose
    gradient is zero in exact arithmetic (a key bias: softmax ignores a
    per-row constant) or within rounding of zero, or whose compressed
    gradient flips as above, gets a step of up to about ±lr from the sign
    of that noise, in either package.  Those may differ by up to 3 × the
    summed learning rates and be at most `NOISE_FRACTION` of the elements
    (measured: 7e-6 of them without compression, 1.2e-4 with it);
  * bfloat16 compute against float32 compute, gradient of each leaf as a
    relative L2 error: dense 0.15 (measured ≤ 0.075), MoE 0.6 (measured
    ≤ 0.42, the router: bfloat16 hidden states move near-tie top-k
    routing, and the reference's own bfloat16 logits lie 2-52% RMS from
    its float32 ones, tests/test_torch_lm.py).  There, every floating leaf must get a
    nonzero gradient: a cast that detached the bfloat16 copies would give
    the experts and every dense kernel none.
"""
import dataclasses
import logging

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import CheckpointManager as RCheckpointManager  # noqa: E402
from repro.configs import get_arch as rget  # noqa: E402
from repro.distributed.trainstep import init_train_state as rinit  # noqa: E402
from repro.distributed.trainstep import make_train_step as rmake  # noqa: E402
from repro.models import build_model as rbuild  # noqa: E402

from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.convert import train_state_from_reference  # noqa: E402
from repro_torch.data import SyntheticLMData  # noqa: E402
from repro_torch.distributed import init_train_state, make_train_step  # noqa: E402
from repro_torch.distributed.trainstep import trainable  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import moe_gmm as gmm  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.utils.tree import flatten_with_paths  # noqa: E402

ARCHS = ["granite-moe-1b-a400m", "qwen2-72b", "mamba2-2.7b", "zamba2-1.2b",
         "gemma2-27b", "llama-3.2-vision-90b", "whisper-large-v3"]
# Per arch: overrides of the reduced config, and the tokens of a sequence
# (64 unless named: gemma2's reduced window is 64, so it takes 96).
ARCH_OVER = {"zamba2-1.2b": dict(num_layers=5, shared_attn_every=2)}
SEQ_OF = {"gemma2-27b": 96}
TOL = 1e-5
COMP_NORM_TOL = 5e-5
NOISE_FRACTION = {False: 1e-4, True: 5e-4}       # by compression
BF16_TOL = {"dense": 0.15, "moe": 0.6}
STEP_KW = dict(base_lr=1e-3, warmup_steps=2, total_steps=10)
SEQ, BATCH = 64, 4
GATE = 0.7                                        # the VLM's cross-attention gates


def _pair(arch, **over):
    over = {**ARCH_OVER.get(arch, {}), **over}
    rcfg = dataclasses.replace(rget(arch).reduced(), compute_dtype="float32", **over)
    cfg = dataclasses.replace(get_arch(arch).reduced(), compute_dtype="float32", **over)
    return rcfg, cfg, rbuild(rcfg), build_model(cfg)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _batches(cfg, n, seed=0, seq=SEQ):
    """The reference driver's data: tokens and labels, and the VLM's vision
    embeddings or Whisper's frames."""
    data = SyntheticLMData(
        vocab_size=cfg.vocab_size, seq_len=seq, global_batch=BATCH, seed=seed,
        with_vision=cfg.vision_seq if cfg.family == "vlm" else 0,
        with_frames=cfg.encoder_seq if cfg.family == "encdec" else 0,
        d_model=cfg.d_model)
    return [data.batch_at(s) for s in range(n)]


def _set_gates(params, value=GATE):
    """The VLM's gates (zero at init) set to ``value`` in the port's tree."""
    if "cross_layers" in params:
        with torch.no_grad():
            for cp in params["cross_layers"]:
                cp["gate"].fill_(value)
    return params


def _port_state(m, seed=0, **kw):
    state = init_train_state(m, seed, device="cpu", **kw)
    _set_gates(state.params)
    return state


def _rel(a, b):
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-30)


def _moments_close(port_state, ref_state, cfg):
    ref = train_state_from_reference(_np_tree(ref_state), cfg, device="cpu").opt
    for got, want in ((port_state.opt.mu, ref.mu), (port_state.opt.nu, ref.nu)):
        assert sorted(got) == sorted(want)
        scale = max(float(w.abs().max()) for w in want.values())
        for k in want:
            assert float((got[k] - want[k]).abs().max()) <= TOL * scale, k


def _params_close(port_state, ref_state, cfg, lrs, compression):
    want = flatten_with_paths(train_state_from_reference(
        _np_tree(ref_state), cfg, device="cpu").params)
    got = flatten_with_paths(port_state.params)
    assert sorted(got) == sorted(want)
    total = noisy = 0
    for k, g in got.items():
        d = (g - want[k]).detach().abs()
        assert float(d.max()) <= 3 * sum(lrs), k
        total += d.numel()
        noisy += int((d > TOL).sum())
    assert noisy <= NOISE_FRACTION[compression] * total, (noisy, total)


def _run_both(arch, steps, *, microbatches=1, compression=False):
    rcfg, cfg, rm, m = _pair(arch)
    rs = rinit(rm, jax.random.PRNGKey(1), compression=compression)
    if "cross_layers" in rs.params:
        rs.params["cross_layers"]["gate"] = jnp.full_like(
            rs.params["cross_layers"]["gate"], GATE)
    ps = train_state_from_reference(_np_tree(rs), cfg, device="cpu")
    kw = dict(STEP_KW, microbatches=microbatches, compression=compression)
    rstep, pstep = jax.jit(rmake(rm, **kw)), make_train_step(m, **kw)
    lrs = []
    for b in _batches(cfg, steps, seq=SEQ_OF.get(arch, SEQ)):
        rs, rmet = rstep(rs, {k: jnp.asarray(v) for k, v in b.items()})
        ps, pmet = pstep(ps, {k: torch.from_numpy(v) for k, v in b.items()})
        assert sorted(pmet) == sorted(rmet)
        for key in rmet:
            tol = COMP_NORM_TOL if compression and key == "grad_norm" else TOL
            assert _rel(pmet[key], rmet[key]) <= tol, (key, float(pmet[key]),
                                                        float(rmet[key]))
        lrs.append(float(rmet["lr"]))
        if not compression:
            _moments_close(ps, rs, cfg)
    assert int(ps.step) == int(rs.step) == int(ps.opt.step) == steps
    _params_close(ps, rs, cfg, lrs, compression)
    if compression:
        ref_res = train_state_from_reference(_np_tree(rs), cfg, device="cpu").comp.residual
        assert sorted(ps.comp.residual) == sorted(ref_res)
    return ps, rs


@pytest.mark.parametrize("steps", [1, 3])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_steps_match_the_reference_f32(arch, steps):
    _run_both(arch, steps)


@pytest.mark.parametrize("arch", ARCHS)
def test_microbatched_steps_match_the_reference(arch):
    _run_both(arch, 3, microbatches=2)


@pytest.mark.parametrize("arch", ARCHS)
def test_compressed_steps_match_the_reference(arch):
    _run_both(arch, 3, compression=True)


@pytest.mark.parametrize("arch", ARCHS)
def test_microbatches_accumulate_the_halves_gradients(arch):
    """microbatches=2 against the mean of the two halves' gradients taken
    one by one, read from the first moment after one step (0.1 × the
    clipped gradient).  For the dense model the halves' mean is the whole
    batch's gradient, so microbatches=1 is held too; the MoE's aux loss is
    a product of batch means and is not additive over microbatches."""
    _, cfg, _, m = _pair(arch, **({"capacity_factor": 4.0} if "granite" in arch else {}))
    batch = {k: torch.from_numpy(v)
             for k, v in _batches(cfg, 1, seq=SEQ_OF.get(arch, SEQ))[0].items()}
    halves = [{k: v[i * BATCH // 2:(i + 1) * BATCH // 2] for k, v in batch.items()}
              for i in range(2)]
    state = _port_state(m)
    _, met = make_train_step(m, microbatches=2, **STEP_KW)(state, batch)
    assert sorted(met) == ["grad_norm", "loss", "lr"]
    leaves = flatten_with_paths(state.params)
    want = {k: torch.zeros_like(p) for k, p in leaves.items()}
    losses = []
    for h in halves:
        loss, _ = m.loss(state.params, h)
        losses.append(float(loss))
        for k, g in zip(leaves, torch.autograd.grad(loss, list(leaves.values()))):
            want[k] += g / 2
    from repro_torch.optim.adamw import global_norm

    assert _rel(met["loss"], np.mean(losses)) <= TOL
    assert _rel(met["grad_norm"], global_norm(want)) <= TOL
    targets = [(want, TOL)]
    if "granite" not in arch:
        whole = _port_state(m)
        loss, _ = m.loss(whole.params, batch)
        targets.append((dict(zip(leaves, torch.autograd.grad(
            loss, list(flatten_with_paths(whole.params).values())))), TOL))
    for target, tol in targets:
        scale = max(float(g.abs().max()) for g in target.values())
        state = _port_state(m)
        state, _ = make_train_step(m, microbatches=2, **STEP_KW)(state, batch)
        clip = min(1.0, 1.0 / float(global_norm(target)))
        for k, g in target.items():
            assert float((state.opt.mu[k] / 0.1 / clip - g).abs().max()) <= 2 * tol * scale, k


def test_bf16_compute_gives_every_leaf_a_gradient():
    """The fault this slice repairs: bfloat16 compute casts every matrix
    through `Params.cast`; a cached, detached copy would leave the experts
    and the dense kernels without a gradient, silently."""
    for arch, kind in (("granite-moe-1b-a400m", "moe"), ("qwen2-72b", "dense")):
        base = get_arch(arch).reduced()
        over = {"capacity_factor": base.num_experts / base.top_k} if base.num_experts else {}
        batch = {k: torch.from_numpy(v) for k, v in _batches(base, 1)[0].items()}
        grads = {}
        for dt in ("float32", "bfloat16"):
            cfg = dataclasses.replace(base, compute_dtype=dt, **over)
            m = build_model(cfg)
            params = trainable(m.init(0, device="cpu"))
            leaves = flatten_with_paths(params)
            loss, _ = m.loss(params, batch)
            grads[dt] = dict(zip(leaves, torch.autograd.grad(
                loss, list(leaves.values()), allow_unused=True)))
        for k, g in grads["bfloat16"].items():
            f = grads["float32"][k]
            assert g is not None, f"{arch}: {k} is cut from the graph"
            assert g.dtype == torch.float32 and bool(torch.isfinite(g).all()), k
            assert float(g.abs().max()) > 0, f"{arch}: no gradient for {k}"
            assert float((g - f).norm() / f.norm()) <= BF16_TOL[kind], k


def test_params_cast_at_inference_is_still_cached():
    m = build_model(dataclasses.replace(get_arch("qwen2-72b").reduced(),
                                        compute_dtype="bfloat16"))
    p = trainable(m.init(0, device="cpu"))
    lp = p["layers"][0]["attn"]["q"]
    with torch.no_grad():
        a, b = lp.cast("kernel", torch.bfloat16), lp.cast("kernel", torch.bfloat16)
    assert a is b and not a.requires_grad
    c = lp.cast("kernel", torch.bfloat16)
    assert c is not a and c.requires_grad and c.grad_fn is not None


def test_remat_recomputes_each_layer_in_the_backward(monkeypatch):
    """With gradients, each layer runs under torch.utils.checkpoint: the
    forward's attention and expert matmuls run twice (forward and
    recompute) and their backward once, as the card's launch counts are
    gated; remat changes no number."""
    _, cfg, _, m = _pair("granite-moe-1b-a400m")
    calls = {"fwd": 0, "bwd": 0, "gmm": 0}
    real_f, real_b, real_g = (fa.flash_attention_plain, fa.flash_attention_backward_plain,
                              gmm.moe_gmm_plain)

    def count(key, fn):
        def wrapped(*a, **kw):
            calls[key] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(fa, "flash_attention_plain", count("fwd", real_f))
    monkeypatch.setattr(fa, "flash_attention_backward_plain", count("bwd", real_b))
    monkeypatch.setattr(gmm, "moe_gmm_plain", count("gmm", real_g))
    params = trainable(m.init(0, device="cpu"))
    leaves = flatten_with_paths(params)
    batch = {k: torch.from_numpy(v) for k, v in _batches(cfg, 1)[0].items()}
    from repro_torch.models import transformer

    grads = {}
    for remat in (True, False):
        for key in calls:
            calls[key] = 0
        logits, aux = transformer.decoder_forward(params, batch["tokens"], cfg, remat=remat)
        from repro_torch.models.model_factory import cross_entropy
        loss = cross_entropy(logits, batch["labels"]) + 0.01 * aux
        grads[remat] = torch.autograd.grad(loss, list(leaves.values()))
        n = cfg.num_layers
        assert calls == {"fwd": (2 if remat else 1) * n, "bwd": n,
                         "gmm": (6 if remat else 3) * n + 6 * n}, (remat, calls)
    for a, b in zip(grads[True], grads[False]):
        assert torch.equal(a, b)


def test_remat_recomputes_each_whisper_layer_in_the_backward(monkeypatch):
    """With gradients, `encode` and `decode_train` run each encoder and
    decoder layer under torch.utils.checkpoint: each layer body runs twice
    (forward and recompute) and its attention's backward once; the encoder
    runs once a step, though its memory feeds every decoder layer (its
    gradient sums over them).  Under no_grad each layer runs once; remat
    changes no number."""
    from repro_torch.models import encdec
    from repro_torch.models.model_factory import cross_entropy

    _, cfg, _, m = _pair("whisper-large-v3")
    calls = _count_calls(monkeypatch, [
        (encdec, "_enc_layer"), (encdec, "_dec_layer"),
        (fa, "flash_attention_plain"), (fa, "flash_attention_backward_plain")])
    params = trainable(m.init(0, device="cpu"))
    leaves = flatten_with_paths(params)
    batch = {k: torch.from_numpy(v) for k, v in _batches(cfg, 1)[0].items()}
    e, d = cfg.encoder_layers, cfg.num_layers
    grads = {}
    for remat in (True, False):
        for key in calls:
            calls[key] = 0
        memory = encdec.encode(params, batch["frames"], cfg, remat=remat)
        logits = encdec.decode_train(params, batch["tokens"], memory, cfg, remat=remat)
        grads[remat] = torch.autograd.grad(cross_entropy(logits, batch["labels"]),
                                           list(leaves.values()))
        runs = 2 if remat else 1
        assert calls == {"_enc_layer": runs * e, "_dec_layer": runs * d,
                         "flash_attention_plain": runs * (e + 2 * d),
                         "flash_attention_backward_plain": e + 2 * d}, (remat, calls)
    for k, a, b in zip(leaves, grads[True], grads[False]):
        assert torch.equal(a, b), k
        if k.startswith("enc_layers") and k.endswith("kernel"):
            assert float(a.abs().max()) > 0, k       # through the memory
    for key in calls:
        calls[key] = 0
    with torch.no_grad():
        m.forward(params, batch)
    assert calls == {"_enc_layer": e, "_dec_layer": d,
                     "flash_attention_plain": e + 2 * d,
                     "flash_attention_backward_plain": 0}


def _count_calls(monkeypatch, targets):
    """Wrap each (module, name) to count its calls; returns the counts."""
    calls = {name: 0 for _, name in targets}

    def count(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped

    for module, name in targets:
        monkeypatch.setattr(module, name, count(name, getattr(module, name)))
    return calls


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "zamba2-1.2b"])
def test_remat_recomputes_each_ssm_layer_and_hybrid_group(monkeypatch, arch):
    """With gradients, each Mamba2 layer (SSM) and each group and tail
    layer (hybrid) runs under torch.utils.checkpoint: the scan's forward
    runs twice a layer (forward and recompute) and its backward once, the
    hybrid's shared block's flash forward twice a group and its backward
    once; remat changes no number.  Without remat the SSM's checkpoint is
    replaced by a plain call."""
    from repro_torch.kernels import ssd_scan as ss
    from repro_torch.models import hybrid, layers

    _, cfg, _, m = _pair(arch)
    calls = _count_calls(monkeypatch, [
        (ss, "ssd_scan_plain"), (ss, "ssd_scan_backward_plain"),
        (fa, "flash_attention_plain"), (fa, "flash_attention_backward_plain")])
    params = trainable(m.init(0, device="cpu"))
    leaves = flatten_with_paths(params)
    batch = {k: torch.from_numpy(v) for k, v in _batches(cfg, 1)[0].items()}
    real_checkpoint = layers.checkpoint
    n_groups = cfg.num_layers // cfg.shared_attn_every if cfg.shared_attn_every else 0
    grads = {}
    for remat in (True, False):
        for key in calls:
            calls[key] = 0
        if arch.startswith("zamba2"):
            logits = hybrid.hybrid_forward(params, batch["tokens"], cfg, remat=remat)
        else:
            monkeypatch.setattr(layers, "checkpoint", real_checkpoint if remat
                                else lambda fn, *a, use_reentrant: fn(*a))
            logits = m.forward(params, batch)
        from repro_torch.models.model_factory import cross_entropy
        loss = cross_entropy(logits, batch["labels"])
        grads[remat] = torch.autograd.grad(loss, list(leaves.values()))
        n = cfg.num_layers
        assert calls == {"ssd_scan_plain": (2 if remat else 1) * n,
                         "ssd_scan_backward_plain": n,
                         "flash_attention_plain": (2 if remat else 1) * n_groups,
                         "flash_attention_backward_plain": n_groups}, (remat, calls)
    for a, b in zip(grads[True], grads[False]):
        assert torch.equal(a, b)


# The VLM at chip_smoke's training cut (one self and one cross layer,
# gates 1.0) and schedule (8 steps, two of warm-up), narrowed to 512 wide.
WIDE_VLM = dict(num_layers=2, cross_attn_every=2, d_model=512, num_heads=4,
                num_kv_heads=1, head_dim=128, d_ff=1792, vocab_size=8192,
                vision_seq=100, q_chunk=512)
WIDE_STEPS = 8
# Its grad norm: measured within 7.2e-7 except at the last state risen at
# 1e-2, where the gradient's norm is 98.8 (10× the first step's) and the
# two float32 sums lie 2.1e-5 apart.
WIDE_NORM_TOL = 1e-4


@pytest.mark.parametrize("lr, falls", [(1e-3, True), (1e-2, False)])
def test_wide_vlm_loss_rise_at_a_large_rate_is_the_references(lr, falls):
    """chip_smoke's training gate (the last quarter's mean loss below the
    first step's) holds the VLM to a peak rate small enough for its width:
    at 8,192 wide on the card its loss rose after the first updates at
    2e-5 and above.  The reference shows the same at 512 wide: along its
    own trajectory (``jax.jit(make_train_step)`` from its init, gates 1.0)
    the gate passes at 1e-3 and fails at 1e-2, and at every step the
    port's step from the reference's state gives the same loss within
    `TOL` and grad norm within `WIDE_NORM_TOL`.  So a rise is the model's and AdamW's, not the
    port's.  (Free-running, the two trajectories part by float32 rounding
    that the rise amplifies, hence one step from each reference state.)"""
    rcfg = dataclasses.replace(rget("llama-3.2-vision-90b"), compute_dtype="float32",
                               **WIDE_VLM)
    cfg = dataclasses.replace(get_arch("llama-3.2-vision-90b"), compute_dtype="float32",
                              **WIDE_VLM)
    rm, m = rbuild(rcfg), build_model(cfg)
    rs = rinit(rm, jax.random.PRNGKey(1))
    rs.params["cross_layers"]["gate"] = jnp.ones_like(rs.params["cross_layers"]["gate"])
    kw = dict(base_lr=lr, warmup_steps=2, total_steps=WIDE_STEPS)
    rstep, pstep = jax.jit(rmake(rm, **kw)), make_train_step(m, **kw)
    losses = []
    for b in _batches(cfg, WIDE_STEPS, seq=128):
        ps = train_state_from_reference(_np_tree(rs), cfg, device="cpu")
        _, pmet = pstep(ps, {k: torch.from_numpy(v) for k, v in b.items()})
        rs, rmet = rstep(rs, {k: jnp.asarray(v) for k, v in b.items()})
        for key, tol in (("loss", TOL), ("grad_norm", WIDE_NORM_TOL)):
            assert _rel(pmet[key], rmet[key]) <= tol, (key, float(pmet[key]),
                                                        float(rmet[key]))
        losses.append(float(rmet["loss"]))
    assert all(np.isfinite(losses)), losses
    last = np.mean(losses[-WIDE_STEPS // 4:])
    assert (last < losses[0]) == falls, losses


def test_hybrid_shared_block_gradient_sums_over_its_calls():
    """The weight-tied shared block gets one gradient, the sum over its
    calls: the same as the gradient of a model whose groups each hold
    their own copy of the block, summed over the copies."""
    _, cfg, _, m = _pair("zamba2-1.2b")
    from repro_torch.models import hybrid
    from repro_torch.models.model_factory import cross_entropy

    params = trainable(m.init(0, device="cpu"))
    batch = {k: torch.from_numpy(v) for k, v in _batches(cfg, 1)[0].items()}
    shared = flatten_with_paths(params["shared_attn"])
    loss = cross_entropy(hybrid.hybrid_forward(params, batch["tokens"], cfg),
                         batch["labels"])
    tied = dict(zip(shared, torch.autograd.grad(loss, list(shared.values()))))

    n_groups = cfg.num_layers // cfg.shared_attn_every
    copies = [trainable(m.init(0, device="cpu"))["shared_attn"] for _ in range(n_groups)]
    real = hybrid.layer_forward
    calls = iter(copies)
    try:
        hybrid.layer_forward = lambda _p, *a, **kw: real(next(calls), *a, **kw)
        loss = cross_entropy(hybrid.hybrid_forward(params, batch["tokens"], cfg,
                                                   remat=False), batch["labels"])
    finally:
        hybrid.layer_forward = real
    per_copy = [dict(zip(shared, torch.autograd.grad(
        loss, list(flatten_with_paths(c).values()), retain_graph=True)))
        for c in copies]
    for k, g in tied.items():
        want = sum(pc[k] for pc in per_copy)
        assert float((g - want).abs().max()) <= TOL * max(float(want.abs().max()), 1e-30), k


def test_port_checkpoint_resume_is_bit_equal(tmp_path):
    _, cfg, _, m = _pair("granite-moe-1b-a400m")
    step = make_train_step(m, **STEP_KW)
    batches = [{k: torch.from_numpy(v) for k, v in b.items()} for b in _batches(cfg, 4)]
    whole = init_train_state(m, 0, device="cpu")
    for b in batches:
        whole, _ = step(whole, b)
    part = init_train_state(m, 0, device="cpu")
    for b in batches[:2]:
        part, _ = step(part, b)
    ckpt = CheckpointManager(str(tmp_path), async_save=True)
    ckpt.save(2, part, {"arch": cfg.name})
    ckpt.wait()
    restored, meta = ckpt.restore(target=init_train_state(m, 1, device="cpu"))
    ckpt.close()
    assert meta["step"] == 2
    for k, t in flatten_with_paths(part).items():
        assert torch.equal(flatten_with_paths(restored)[k], t), k
    assert all(p.requires_grad for p in restored.params.parameters())
    for b in batches[2:]:
        restored, _ = step(restored, b)
    flat = flatten_with_paths(whole)
    for k, t in flatten_with_paths(restored).items():
        assert torch.equal(flat[k], t), k


@pytest.mark.parametrize("compression", [False, True])
def test_reference_checkpoint_resumes_in_the_port(tmp_path, compression):
    """Two steps in the reference, saved by its CheckpointManager; the
    port restores the arrays (target=None), carries them over and takes
    the third step beside the reference."""
    rcfg, cfg, rm, m = _pair("qwen2-72b")
    kw = dict(STEP_KW, compression=compression)
    rstep = jax.jit(rmake(rm, **kw))
    rs = rinit(rm, jax.random.PRNGKey(2), compression=compression)
    batches = _batches(cfg, 3, seed=4)
    lrs = []
    for b in batches[:2]:
        rs, met = rstep(rs, {k: jnp.asarray(v) for k, v in b.items()})
        lrs.append(float(met["lr"]))
    RCheckpointManager(str(tmp_path), async_save=False).save(2, rs)
    arrays, meta = CheckpointManager(str(tmp_path), async_save=False).restore()
    assert meta["step"] == 2 and ("comp/residual/embed/embedding" in arrays) == compression
    ps = train_state_from_reference(arrays, cfg, device="cpu")
    assert int(ps.step) == int(ps.opt.step) == 2
    rs, rmet = rstep(rs, {k: jnp.asarray(v) for k, v in batches[2].items()})
    ps, pmet = make_train_step(m, **kw)(ps, {k: torch.from_numpy(v)
                                            for k, v in batches[2].items()})
    lrs.append(float(rmet["lr"]))
    for key in rmet:
        tol = COMP_NORM_TOL if compression and key == "grad_norm" else TOL
        assert _rel(pmet[key], rmet[key]) <= tol, key
    _params_close(ps, rs, cfg, lrs, compression)


def test_train_driver_runs_on_the_host_and_resumes(tmp_path, caplog):
    from repro_torch.launch import train

    args = ["--arch", "qwen2-72b-reduced", "--global-batch", "2", "--seq-len", "32",
            "--log-every", "2", "--ckpt-every", "2", "--ckpt-dir", str(tmp_path),
            "--device", "cpu"]
    # The port's loggers write to their own handler and do not propagate.
    logging.getLogger("repro").addHandler(caplog.handler)
    try:
        _driver_script(train, args, caplog, tmp_path)
    finally:
        logging.getLogger("repro").removeHandler(caplog.handler)


def _driver_script(train, args, caplog, tmp_path):
    with caplog.at_level(logging.INFO, logger="repro"):
        first = train.main(args + ["--steps", "4"])
    assert len(first) == 4 and all(np.isfinite(first))
    assert CheckpointManager(str(tmp_path), async_save=False).all_steps() == [2, 4]
    assert any("step 4 loss" in r.getMessage() and "tok/s" in r.getMessage()
               for r in caplog.records)
    with caplog.at_level(logging.INFO, logger="repro"):
        more = train.main(args + ["--steps", "6"])
    assert len(more) == 2
    assert any("resumed from checkpoint step 4" in r.getMessage() for r in caplog.records)
    # The resumed run continues the uninterrupted one: the same losses.
    whole = train.main(args[:-4] + ["--device", "cpu", "--steps", "6"])
    np.testing.assert_array_equal(np.asarray(more), np.asarray(whole[4:]))
    # One process without a process group: --model-parallel is the
    # reference's (1, 1) mesh, the same run as without it.
    np.testing.assert_array_equal(
        train.main(args[:-4] + ["--device", "cpu", "--steps", "2", "--model-parallel", "2"]),
        np.asarray(whole[:2]))


def test_train_driver_trains_mamba2_on_the_host(caplog):
    """The driver on the reduced Mamba2 (remat, the SSD scan's plain
    backward): finite losses that fall over 6 steps."""
    from repro_torch.launch import train

    args = ["--arch", "mamba2-2.7b-reduced", "--global-batch", "2", "--seq-len", "64",
            "--log-every", "3", "--lr", "3e-3", "--device", "cpu"]
    logging.getLogger("repro").addHandler(caplog.handler)
    try:
        with caplog.at_level(logging.INFO, logger="repro"):
            losses = train.main(args + ["--steps", "6"])
    finally:
        logging.getLogger("repro").removeHandler(caplog.handler)
    assert len(losses) == 6 and all(np.isfinite(losses))
    assert np.mean(losses[-2:]) < losses[0]
    assert any("step 6 loss" in r.getMessage() for r in caplog.records)


@pytest.mark.parametrize("arch", ["llama-3.2-vision-90b-reduced",
                                  "whisper-large-v3-reduced"])
def test_train_driver_trains_the_vlm_and_whisper_on_the_host(caplog, arch):
    """The driver on the reduced VLM and Whisper, whose batches carry the
    stub frontends' vision embeddings or frames: finite losses that fall
    over 6 steps.  The driver's warm-up is 100 steps, so step 6 runs at 6%
    of ``--lr``: at 3e-3 the reduced VLM's loss moves less than the
    batches' spread in 6 steps (it falls by 10 steps), at 1e-2 it falls."""
    from repro_torch.launch import train

    args = ["--arch", arch, "--global-batch", "2", "--seq-len", "64",
            "--log-every", "3", "--lr", "1e-2", "--device", "cpu"]
    logging.getLogger("repro").addHandler(caplog.handler)
    try:
        with caplog.at_level(logging.INFO, logger="repro"):
            losses = train.main(args + ["--steps", "6"])
    finally:
        logging.getLogger("repro").removeHandler(caplog.handler)
    assert len(losses) == 6 and all(np.isfinite(losses))
    assert np.mean(losses[-2:]) < losses[0]
    assert any("step 6 loss" in r.getMessage() for r in caplog.records)


# -- spans inside the step (repro_torch.obs.tracing) -----------------------------------

SPAN_ARCHS = ["granite-moe-1b-a400m", "mamba2-2.7b"]
# Per family: the span of each layer's forward (recomputed in the
# backward) and the backward spans of each layer.
LAYER_SPANS = {"moe": (["moe.route", "moe.dispatch", "moe.combine"],
                       ["moe.dispatch.bwd", "moe.combine.bwd"]),
               "ssm": (["ssm.intra"], ["ssm.intra.bwd"])}


def _portbench_core():
    import importlib
    import sys
    from pathlib import Path

    root = str(Path(__file__).resolve().parents[1])
    if root not in sys.path:
        sys.path.insert(0, root)
    return importlib.import_module("portbench.core")


def _two_steps(m, cfg, how):
    """Two steps from one state, untraced (``"off"``), under torch.profiler
    (CPU activity) or into a bundle with tracing on (``"obs"``): (metrics,
    parameters, the spans recorded, the profiler or None)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import obs

    bundle = obs.Observability(seed=7) if how == "obs" else None
    tracer = (bundle or obs.default()).tracer
    before = len(tracer.export())
    state = _port_state(m)
    step = make_train_step(m, obs=bundle, **STEP_KW)
    batches = [{k: torch.from_numpy(v) for k, v in b.items()} for b in _batches(cfg, 2)]
    prof = None
    if how == "profiler":
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            for b in batches:
                state, met = step(state, b)
    else:
        for b in batches:
            state, met = step(state, b)
    params = {k: v.detach().clone() for k, v in flatten_with_paths(state.params).items()}
    return met, params, tracer.export()[before:], prof


@pytest.mark.parametrize("arch", SPAN_ARCHS)
def test_an_untraced_step_records_no_span_and_marks_nothing(arch):
    _, cfg, _, m = _pair(arch)
    *_, spans, _ = _two_steps(m, cfg, "off")
    assert spans == []
    params = trainable(m.init(0, device="cpu"))
    batch = {k: torch.from_numpy(v) for k, v in _batches(cfg, 1)[0].items()}
    loss, _ = m.loss(params, batch)
    seen, todo = set(), [loss.grad_fn]
    while todo:
        fn = todo.pop()
        if fn is not None and fn not in seen:
            seen.add(fn)
            todo.extend(f for f, _ in fn.next_functions)
    assert not {type(fn).__name__ for fn in seen} & {"_RegionInBackward",
                                                      "_RegionOutBackward"}


@pytest.mark.parametrize("arch", SPAN_ARCHS)
def test_a_profiled_step_gives_the_span_tree(arch):
    """Under torch.profiler each step is one trace: ``train.step`` over the
    forward, the backward and the optimizer (its ``train.sync``); the
    loss head and each layer's spans under the forward; their recompute
    and every ``.bwd`` span under the backward.  Each span is an op of the
    profiler's trace, none a user annotation."""
    _, cfg, _, m = _pair(arch)
    *_, spans, prof = _two_steps(m, cfg, "profiler")
    layer, bwd = LAYER_SPANS[cfg.family]
    by_sid = {s["sid"]: s for s in spans}
    tids = sorted({s["tid"] for s in spans})
    assert len(tids) == 2 and all(s["status"] == "ok" for s in spans)
    for tid in tids:
        mine = [s for s in spans if s["tid"] == tid]

        def under(name):
            return sorted(by_sid[s["parent"]]["name"] if s["parent"] else None
                          for s in mine if s["name"] == name)

        assert under("train.step") == [None]
        for name in ("train.forward", "train.backward", "train.optimizer"):
            assert under(name) == ["train.step"], name
        assert under("train.sync") == ["train.optimizer"]
        assert under("lm.head") == ["train.forward"]
        assert under("lm.head.bwd") == ["train.backward"]
        n = cfg.num_layers
        for name in layer:
            assert under(name) == ["train.backward"] * n + ["train.forward"] * n, name
        for name in bwd:
            assert under(name) == ["train.backward"] * n, name
    trace = _portbench_core().trace_from_profile(prof, 1.0, 2)
    names = {s["name"] for s in spans}
    assert names <= {c.name for c in trace.ops}
    assert not any(e.is_user_annotation for e in prof.events() if e.name in names)


@pytest.mark.parametrize("how", ["profiler", "obs"])
@pytest.mark.parametrize("arch", SPAN_ARCHS)
def test_tracing_keeps_every_bit(arch, how):
    """Loss, gradient norm and parameters after two steps are the same bits
    traced (under the profiler, or into a bundle with tracing on) as
    untraced."""
    _, cfg, _, m = _pair(arch)
    want, want_p, *_ = _two_steps(m, cfg, "off")
    got, got_p, spans, _ = _two_steps(m, cfg, how)
    assert spans
    for key in ("loss", "grad_norm"):
        assert torch.equal(got[key], want[key]), key
    assert all(torch.equal(got_p[k], v) for k, v in want_p.items())
