"""The port's training step is deterministic by construction, as the
reference's is: no backward adds two contributions into one element in
an order that can change between runs (a scatter-add or ``index_add_``
with a repeated index, which torch's CUDA kernels run as atomic adds).

  * (a) The autograd graph of a reduced Granite-MoE training loss (32
    experts, top 8, so every token is read by up to 8 buffer rows): every
    node that saves an index holds one without repeats along the dim it
    indexes, and the MoE dispatch and combine (`moe._Route`) map buffer
    rows and token slots one to one.  The embedding's backward is the one
    node allowed a repeated index: torch's CUDA kernel for it sorts the
    ids and sums each id's rows in a fixed order.
  * (b) `moe_ffn`'s gradients with respect to x, the router kernel and
    the expert stacks against ``jax.grad`` of the reference's
    ``moe_ffn``, at the (b, s, capacity factor) cases of
    tests/test_torch_moe_gmm.py and at Granite's own routing (e = 32,
    k = 8) at the reduced width.  Tolerances, of each gradient's largest
    magnitude: float32 1e-5 (the same sums, in another order), bfloat16
    2e-2 (both sum in float32 and round once; the SwiGLU, its gradient and
    the combine round in bfloat16 at places that differ by a step), those
    of tests/test_torch_moe_gmm.py.
  * (c) `activations._Select`'s backward on ranks whose query heads
    straddle kv groups (the index repeats a kv head): the sum it stands
    for, on three gloo ranks, and the same bits on a second run.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as rget  # noqa: E402
from repro.models import moe as rmoe  # noqa: E402

from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.distributed import init_train_state  # noqa: E402
from repro_torch.models import build_model, cross_entropy, moe, transformer  # noqa: E402
from repro_torch.models.layers import Params  # noqa: E402

from test_torch_distributed import spawn  # noqa: E402

F32_TOL = 1e-5
BF16_TOL = 2e-2
GRANITE_ROUTING = dict(num_experts=32, top_k=8)
# Nodes whose saved index may repeat: the embedding's CUDA backward sums
# each id's rows in a fixed order (torch lists it among neither its
# nondeterministic ops nor those it swaps in deterministic mode).
REPEATS_ALLOWED = {"EmbeddingBackward0"}


def _nodes(root):
    seen, stack = set(), [root]
    while stack:
        node = stack.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        yield node
        stack.extend(f for f, _ in node.next_functions)


def _repeats_along(index: torch.Tensor, dim: int) -> bool:
    """Whether ``index`` repeats a value along ``dim`` anywhere (entries
    below 0 mark none and are left out)."""
    srt = index.movedim(dim, -1).sort(dim=-1).values
    same = srt[..., 1:] == srt[..., :-1]
    return bool((same & (srt[..., 1:] >= 0)).any())


def _granite_loss(seed=0, b=2, s=64):
    cfg = dataclasses.replace(get_arch("granite-moe-1b-a400m").reduced(),
                              num_layers=2, **GRANITE_ROUTING)
    state = init_train_state(build_model(cfg), seed, device="cpu")
    tokens = torch.from_numpy(
        np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s + 1)))
    # The model's loss (nll + 0.01 · aux), without remat so the graph
    # holds every node and its saved tensors.
    logits, aux = transformer.decoder_forward(state.params, tokens[:, :-1], cfg,
                                              remat=False)
    return cross_entropy(logits, tokens[:, 1:], cfg.vocab_size) + 0.01 * aux


def test_no_backward_of_a_granite_training_loss_accumulates_a_repeated_index():
    loss = _granite_loss()
    checked, routes = [], 0
    for node in _nodes(loss.grad_fn):
        name = type(node).__name__
        if name == "_RouteBackward":
            inverse, = node.saved_tensors
            assert not _repeats_along(inverse, 1), "a buffer row fed by two slots"
            routes += 1
            continue
        for attr in ("_saved_index", "_saved_indices"):
            index = getattr(node, attr, None)
            if not isinstance(index, torch.Tensor) or name in REPEATS_ALLOWED:
                continue
            dim = getattr(node, "_saved_dim", None)
            dim = 0 if dim is None else (dim - 2 ** 64 if dim >= 2 ** 63 else dim)
            assert not _repeats_along(index, dim), \
                f"{name} saves an index that repeats along dim {dim}"
            checked.append(name)
    # Two MoE layers: a dispatch and a combine each; the router's top-k and
    # the loss's gather hold indices too.
    assert routes == 4
    assert "TopkBackward0" in checked and "GatherBackward0" in checked


def _setup(compute_dtype, capacity_factor, seed, **over):
    rcfg = dataclasses.replace(rget("granite-moe-1b-a400m").reduced(),
                               compute_dtype=compute_dtype,
                               capacity_factor=capacity_factor, **over)
    cfg = dataclasses.replace(get_arch("granite-moe-1b-a400m").reduced(),
                              compute_dtype=compute_dtype,
                              capacity_factor=capacity_factor, **over)
    rp = rmoe.moe_init(jax.random.PRNGKey(seed), rcfg)
    return rcfg, cfg, rp


def _held(got: torch.Tensor, want, tol: float, what: str):
    got = got.detach().float().numpy()
    want = np.asarray(jnp.asarray(want, jnp.float32))
    assert got.shape == want.shape, what
    scale = float(np.abs(want).max())
    assert scale > 0, f"{what}: zero gradient"
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{what}: {err} > {tol} × {scale}"


# The five cases of tests/test_torch_moe_gmm.py (capacity factors 0.3 and
# 0.6 drop assignments, so dropped ones meet kept ones' rows), then
# Granite's routing, with and without drops.
CASES = [((2, 16, 1.25), {}), ((1, 1, 1.25), {}), ((3, 24, 0.3), {}),
         ((2, 40, 0.6), {}), ((2, 12, 4.0), {}),
         ((2, 64, 1.25), GRANITE_ROUTING), ((2, 64, 0.6), GRANITE_ROUTING)]


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,over", CASES,
                         ids=[f"{b}x{s}-cf{cf}{'-e32k8' if o else ''}"
                              for (b, s, cf), o in CASES])
def test_moe_ffn_gradients_match_reference(compute_dtype, shape, over):
    b, s, cf = shape
    rcfg, cfg, rp = _setup(compute_dtype, cf, seed=s, **over)
    rng = np.random.default_rng(s + b)
    x = (rng.standard_normal((b, s, cfg.d_model)) * 0.5).astype(np.float32)
    cot = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
    jdt, tdt = getattr(jnp, compute_dtype), getattr(torch, compute_dtype)

    def rloss(params, xx):
        y, aux = rmoe.moe_ffn(params, xx, rcfg)
        return jnp.sum(y.astype(jnp.float32) * cot) + 0.01 * aux

    want_p, want_x = jax.grad(rloss, argnums=(0, 1))(rp, jnp.asarray(x, jdt))

    p = Params(jax.tree_util.tree_map(lambda a: torch.tensor(np.asarray(a)), rp))
    for t in p.parameters():
        t.requires_grad_(True)
    xt = torch.from_numpy(x).to(tdt).requires_grad_(True)
    y, aux = moe.moe_ffn(p, xt, cfg)
    (torch.sum(y.float() * torch.from_numpy(cot)) + 0.01 * aux).backward()

    tol = F32_TOL if compute_dtype == "float32" else BF16_TOL
    assert xt.grad.dtype == tdt
    _held(xt.grad, want_x, tol, "x")
    _held(p["router"]["kernel"].grad, want_p["router"]["kernel"], tol, "router")
    for name in ("gate", "up", "down"):
        _held(p[name].grad, want_p[name], tol, name)


def test_moe_ffn_forward_unchanged_by_the_routes(monkeypatch):
    """The dispatch and combine read the same rows as a plain gather from
    x (the token of the last assignment writing each row) and a gather of
    each kept assignment's row: the outputs are bit-equal."""
    _, cfg, rp = _setup("float32", 0.6, seed=3, **GRANITE_ROUTING)
    p = Params(jax.tree_util.tree_map(lambda a: torch.tensor(np.asarray(a)), rp))
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (2, 64, cfg.d_model)).astype(np.float32))
    calls = []
    real = moe._Route.apply

    def spy(src, index, inverse, k, bwd):
        out = real(src, index, inverse, k, bwd)
        rows = src.gather(1, (index.clamp(min=0) // k)[..., None].expand(*index.shape,
                                                                         src.shape[2]))
        assert torch.equal(out, rows * (index >= 0)[..., None])
        # inverse is the index's inverse: slot j feeds row inverse[j].
        slots = torch.arange(inverse.shape[1]).expand_as(inverse)
        fed = inverse >= 0
        assert torch.equal(index.gather(1, inverse.clamp(min=0))[fed], slots[fed])
        assert int(fed.sum()) == int((index >= 0).sum())
        calls.append((k, bwd))
        return out

    monkeypatch.setattr(moe._Route, "apply", spy)
    moe.moe_ffn(p, x, cfg)
    assert calls == [(cfg.top_k, "moe.dispatch.bwd"), (1, "moe.combine.bwd")]


# -- (c) the model axis's select, heads straddling kv groups -----------------

SELECT_BODY = """
from repro_torch.distributed import activations as act

# 6 query heads over 2 kv heads (groups of 3) on 3 ranks: 2 heads a rank,
# so rank 0 reads kv head 0 twice, rank 1 heads 0 and 1, rank 2 head 1
# twice (the straddling branch of `attention_heads`).
h, kvh, n = 6, 2, WORLD
hl, g = h // n, h // kvh
assert hl % g and g % hl
first = RANK * hl
index = torch.arange(first, first + hl) // g
rng = np.random.default_rng(0)
k = torch.from_numpy(rng.standard_normal((2, 5, kvh, 8)).astype(np.float32))
cot = torch.from_numpy(rng.standard_normal((n, 2, 5, hl, 8)).astype(np.float32))
group = dist.group.WORLD
grads = []
for _ in range(2):
    kk = k.clone().requires_grad_(True)
    out = act._Select.apply(kk, 2, index, group)
    (out * cot[RANK]).sum().backward()
    grads.append(kk.grad)
assert torch.equal(grads[0], grads[1])
report(index=index.tolist(), grad=grads[0].double().numpy().tolist(),
       bits=grads[0].view(torch.int32).numpy().tolist())
"""


def test_select_backward_sums_straddling_heads(tmp_path):
    reports = spawn(3, SELECT_BODY, tmp_path)
    rng = np.random.default_rng(0)
    k = rng.standard_normal((2, 5, 2, 8)).astype(np.float32)
    cot = rng.standard_normal((3, 2, 5, 2, 8)).astype(np.float32)
    assert any(len(set(r["index"])) < len(r["index"]) for r in reports)
    want = np.zeros(k.shape)
    for rank, r in enumerate(reports):
        for j, u in enumerate(r["index"]):
            want[:, :, u] += cot[rank, :, :, j].astype(np.float64)
    for r in reports:
        got = np.asarray(r["grad"])
        assert np.abs(got - want).max() <= F32_TOL * np.abs(want).max()
        # Every rank holds the same all-reduced gradient, bit for bit.
        assert r["bits"] == reports[0]["bits"]
