"""Port grouped expert matmul (repro_torch.kernels.moe_gmm) and MoE FFN
(repro_torch.models.moe), held against the reference (repro.kernels,
repro.models.moe).

Same inputs, made with numpy, through the reference's Pallas kernel (in
interpret mode, as tests/test_kernels.py runs it), its jnp oracle and its
``moe_ffn``, and through the port's plain version (the CPU side of the
dispatch), with the reference's parameters carried across as numpy.
Tolerances:
  * float32: 1e-5 of max(1, the output's largest magnitude) (same sums
    of products; only their float32 order differs);
  * bfloat16: 2e-2 of the same.  Both kernels sum in float32 and round once, so they
    differ by at most one bfloat16 step (2^-8 relative); the MoE FFN
    also rounds its SiLU, product and combine in bfloat16 at places
    that differ between JAX and torch by a step.
Expert routing is computed in float32 from the same input in both
packages, so the two pick the same experts and capacity slots.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.kernels.ops as rops  # noqa: E402
import repro.kernels.ref as rref  # noqa: E402
from repro.configs import get_arch as rget  # noqa: E402
from repro.models import moe as rmoe  # noqa: E402

from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.kernels import moe_gmm as gmm  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.layers import Params  # noqa: E402

F32_TOL = 1e-5
BF16_TOL = 2e-2


def _xw(e, c, d, f, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((e, c, d)).astype(np.float32),
            (rng.standard_normal((e, d, f)) * 0.1).astype(np.float32))


def _close(got, want, tol):
    got = np.asarray(got.float() if isinstance(got, torch.Tensor) else
                     jnp.asarray(got, jnp.float32))
    want = np.asarray(jnp.asarray(want, jnp.float32))
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max(initial=0.0)), 1.0)
    assert float(np.abs(got - want).max(initial=0.0)) <= tol * scale


@pytest.mark.parametrize("e,c,d,f", [(2, 32, 64, 32), (4, 64, 128, 96),
                                     (8, 128, 64, 64)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_reference_pallas_kernel(e, c, d, f, dtype):
    x, w = _xw(e, c, d, f, seed=e * c + f)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = rops.moe_gmm(jnp.asarray(x, jdt), jnp.asarray(w, jdt),
                        block_c=32, block_f=32, block_d=64)
    got = ops.moe_gmm(torch.from_numpy(x).to(tdt), torch.from_numpy(w).to(tdt))
    assert got.dtype == tdt
    _close(got, want, F32_TOL if dtype == "float32" else BF16_TOL)


# Ragged shapes the Pallas kernel refuses, among them Granite's decode
# shape folded over 4 slots (32 experts × 32 rows) at a small depth.
@pytest.mark.parametrize("e,c,d,f", [(3, 33, 70, 17), (32, 32, 64, 48),
                                     (1, 1, 5, 3), (2, 0, 8, 4)])
def test_plain_matches_reference_oracle_at_ragged_shapes(e, c, d, f):
    x, w = _xw(e, c, d, f, seed=c + d)
    want = rref.moe_gmm_ref(jnp.asarray(x), jnp.asarray(w))
    _close(gmm.moe_gmm_plain(torch.from_numpy(x), torch.from_numpy(w)), want,
           F32_TOL)
    _close(ref.moe_gmm_ref(torch.from_numpy(x), torch.from_numpy(w)), want,
           F32_TOL)


def test_shapes_are_checked():
    x, w = _xw(2, 4, 8, 3, seed=0)
    with pytest.raises(ValueError, match="expected x"):
        ops.moe_gmm(torch.from_numpy(x), torch.from_numpy(w[:, :4]))


# -- moe_ffn --------------------------------------------------------------------

def _setup(compute_dtype, capacity_factor=1.25, seed=0):
    rcfg = dataclasses.replace(rget("granite-moe-1b-a400m").reduced(),
                               compute_dtype=compute_dtype,
                               capacity_factor=capacity_factor)
    cfg = dataclasses.replace(get_arch("granite-moe-1b-a400m").reduced(),
                              compute_dtype=compute_dtype,
                              capacity_factor=capacity_factor)
    rp = rmoe.moe_init(jax.random.PRNGKey(seed), rcfg)
    p = Params(jax.tree_util.tree_map(lambda a: torch.tensor(np.asarray(a)), rp))
    return rcfg, cfg, rp, p


@pytest.mark.parametrize("s", [1, 16, 37])
def test_expert_capacity_matches_reference(s):
    rcfg, cfg, _, _ = _setup("float32")
    assert moe.expert_capacity(s, cfg) == rmoe.expert_capacity(s, rcfg)


# capacity_factor 0.3 and 0.6 make experts overflow, so the dropped
# assignments' destination collisions are exercised; 4.0 drops nothing.
@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,cf", [(2, 16, 1.25), (1, 1, 1.25), (3, 24, 0.3),
                                    (2, 40, 0.6), (2, 12, 4.0)])
def test_moe_ffn_matches_reference(compute_dtype, b, s, cf):
    rcfg, cfg, rp, p = _setup(compute_dtype, cf, seed=s)
    rng = np.random.default_rng(s + b)
    x = (rng.standard_normal((b, s, cfg.d_model)) * 0.5).astype(np.float32)
    jdt, tdt = getattr(jnp, compute_dtype), getattr(torch, compute_dtype)
    want_y, want_aux = rmoe.moe_ffn(rp, jnp.asarray(x, jdt), rcfg)
    got_y, got_aux = moe.moe_ffn(p, torch.from_numpy(x).to(tdt), cfg)
    assert got_y.dtype == tdt and got_y.shape == (b, s, cfg.d_model)
    _close(got_y, want_y, F32_TOL if compute_dtype == "float32" else BF16_TOL)
    np.testing.assert_allclose(float(got_aux), float(want_aux), rtol=1e-5)


def test_moe_ffn_runs_three_grouped_matmuls_with_the_batch_in_the_rows(monkeypatch):
    """The expert matmuls go through ops.moe_gmm as (e, b·cap, d) × (e, d, f)."""
    _, cfg, _, p = _setup("float32")
    shapes = []
    real = ops.moe_gmm

    def spy(x, w):
        shapes.append((tuple(x.shape), tuple(w.shape)))
        return real(x, w)

    monkeypatch.setattr(ops, "moe_gmm", spy)
    moe.moe_ffn(p, torch.zeros((3, 16, cfg.d_model)), cfg)
    e, d, f = cfg.num_experts, cfg.d_model, cfg.d_ff
    rows = 3 * moe.expert_capacity(16, cfg)
    assert shapes == [((e, rows, d), (e, d, f)), ((e, rows, d), (e, d, f)),
                      ((e, rows, f), (e, f, d))]
