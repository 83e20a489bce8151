"""Port flash attention (repro_torch.kernels.flash_attention) and the
attention functions of repro_torch.models.attention, held against the
reference (repro.kernels, repro.models.attention).

Same inputs, made with numpy, through the reference's Pallas kernel (in
interpret mode, as tests/test_kernels.py runs it), its jnp oracle and its
model attention, and through the port's plain version (the CPU side of
the dispatch).  Tolerances:
  * float32: 2e-5, the reference's own bound for its kernel against its
    oracle (same function; only the order of float32 sums differs);
  * bfloat16: 2e-2.  Both kernels keep scores and probabilities in
    float32 and round the output once, so they differ by at most one
    bfloat16 step (2^-8 relative) of outputs of magnitude < 2; the
    reference's model attention also rounds its probabilities to
    bfloat16 before the weighted sum, which the kernel does not.

The card's bfloat16 kernel rounds its probabilities to bfloat16 before
P·V (the tensor cores take bf16 operands).  `_bf16_route_emulation`
repeats that kernel's arithmetic in torch, and is held within
`DESIGN_TOL` = 5e-3 × max|·| of the plain version and of the reference's
Pallas kernel, both evaluated in float32 on the same bfloat16 values: the
design's two roundings (P and the output, each 2^-9 relative) use a
quarter of the card's 2e-2 bfloat16 tolerance at most.  Row by row
(each query row's max |err| over its own max |plain|) the emulation stays
within `ROW_TOL`, the card's row gate, which a key tile lost from the
late rows fails.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.kernels.ops as rops  # noqa: E402
import repro.kernels.ref as rref  # noqa: E402
from repro.configs import get_arch as rget  # noqa: E402
from repro.models import attention as rattn  # noqa: E402

from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import attention as attn  # noqa: E402
from repro_torch.models.layers import Params  # noqa: E402

F32_TOL = 2e-5
BF16_TOL = 2e-2
DESIGN_TOL = 5e-3
ROW_TOL = 1.6e-2


def _qkv(b, s, h, kvh, hd, seed, skv=None):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, s, h, hd)).astype(np.float32)
    k = rng.standard_normal((b, skv or s, kvh, hd)).astype(np.float32)
    v = rng.standard_normal((b, skv or s, kvh, hd)).astype(np.float32)
    return q, k, v


def _t(*arrays, dtype=torch.float32):
    return [torch.from_numpy(a).to(dtype) for a in arrays]


def _j(*arrays, dtype=jnp.float32):
    return [jnp.asarray(a, dtype) for a in arrays]


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("b,s,h,hd", [(1, 128, 1, 32), (2, 256, 2, 64),
                                      (1, 384, 2, 16)])
@pytest.mark.parametrize("causal", [True, False])
def test_plain_matches_reference_pallas_kernel(b, s, h, hd, causal):
    q, k, v = _qkv(b, s, h, h, hd, seed=s + h)
    want = rops.flash_attention(*_j(q, k, v), causal=causal, block_q=128,
                                block_kv=128)
    got = ops.flash_attention(*_t(q, k, v), causal=causal)
    np.testing.assert_allclose(_np(got), _np(want), rtol=F32_TOL, atol=F32_TOL)


def test_plain_matches_reference_pallas_kernel_bf16():
    q, k, v = _qkv(1, 256, 2, 2, 64, seed=5)
    want = rops.flash_attention(*_j(q, k, v, dtype=jnp.bfloat16),
                                block_q=128, block_kv=128)
    got = ops.flash_attention(*_t(q, k, v, dtype=torch.bfloat16))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), _np(want), rtol=BF16_TOL, atol=BF16_TOL)


# Ragged lengths the Pallas kernel refuses (not a multiple of its block),
# held against the reference's oracle.
@pytest.mark.parametrize("s,causal", [(100, True), (100, False), (1, True),
                                      (130, True)])
def test_plain_matches_reference_oracle_at_ragged_lengths(s, causal):
    q, k, v = _qkv(2, s, 2, 2, 32, seed=s)
    want = rref.flash_attention_ref(*_j(q, k, v), causal=causal)
    got = fa.flash_attention_plain(*_t(q, k, v), causal=causal)
    np.testing.assert_allclose(_np(got), _np(want), rtol=F32_TOL, atol=F32_TOL)
    mine = ref.flash_attention_ref(*_t(q, k, v), causal=causal)
    np.testing.assert_allclose(_np(mine), _np(want), rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("kvh", [1, 2, 4])
def test_gqa_reads_kv_head_i_over_rep_without_a_repeat(kvh):
    """The plain version with kvh < h equals the oracle on K/V repeated to
    h heads (head i reads kv head i // (h / kvh))."""
    q, k, v = _qkv(2, 96, 4, kvh, 32, seed=kvh)
    rep = 4 // kvh
    kr, vr = (np.repeat(a, rep, axis=2) for a in (k, v))
    want = rref.flash_attention_ref(*_j(q, kr, vr))
    got = fa.flash_attention_plain(*_t(q, k, v))
    np.testing.assert_allclose(_np(got), _np(want), rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("fn", ["naive_attention", "chunked_attention"])
@pytest.mark.parametrize("kvh,s", [(1, 160), (2, 160), (4, 77)])
def test_model_attention_matches_reference_f32(fn, kvh, s):
    q, k, v = _qkv(2, s, 4, kvh, 32, seed=s * kvh)
    kw = {"q_chunk": 32} if fn == "chunked_attention" else {}
    want = getattr(rattn, fn)(*_j(q, k, v), causal=True, **kw)
    got = getattr(attn, fn)(*_t(q, k, v), causal=True, **kw)
    np.testing.assert_allclose(_np(got), _np(want), rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("fn", ["naive_attention", "chunked_attention"])
def test_model_attention_matches_reference_bf16(fn):
    q, k, v = _qkv(1, 160, 4, 2, 32, seed=11)
    kw = {"q_chunk": 64} if fn == "chunked_attention" else {}
    want = getattr(rattn, fn)(*_j(q, k, v, dtype=jnp.bfloat16), **kw)
    got = getattr(attn, fn)(*_t(q, k, v, dtype=torch.bfloat16), **kw)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), _np(want), rtol=BF16_TOL, atol=BF16_TOL)


@pytest.mark.parametrize("window,cap", [(8, 0.0), (0, 5.0), (16, 5.0)])
def test_window_and_softcap_on_the_host_match_reference(window, cap):
    q, k, v = _qkv(1, 64, 4, 2, 16, seed=window + int(cap))
    want = rattn.naive_attention(*_j(q, k, v), window=window, logit_softcap=cap)
    got = attn.naive_attention(*_t(q, k, v), window=window, logit_softcap=cap)
    np.testing.assert_allclose(_np(got), _np(want), rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("cache_dtype", [np.float32, "bfloat16"])
@pytest.mark.parametrize("window", [0, 5])
def test_decode_attention_matches_reference(cache_dtype, window):
    """Single-token decode against a padded cache with per-row lengths; a
    bfloat16 cache under float32 queries promotes as JAX does."""
    q, k, v = _qkv(3, 1, 4, 2, 32, seed=3, skv=24)
    lens = np.array([24, 7, 1], np.int32)
    jdt = jnp.bfloat16 if cache_dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if cache_dtype == "bfloat16" else torch.float32
    want = rattn.decode_attention(jnp.asarray(q), *_j(k, v, dtype=jdt),
                                  cache_len=jnp.asarray(lens), window=window)
    got = attn.decode_attention(torch.from_numpy(q), *_t(k, v, dtype=tdt),
                                cache_len=torch.from_numpy(lens), window=window)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), _np(want), rtol=F32_TOL, atol=F32_TOL)


def test_decode_matches_full_attention_last_token():
    q, k, v = _qkv(1, 12, 4, 2, 16, seed=12)
    full = attn.naive_attention(*_t(q, k, v), causal=True)
    out = attn.decode_attention(*_t(q[:, -1:], k, v),
                                cache_len=torch.tensor([12]))
    np.testing.assert_allclose(_np(out)[:, 0], _np(full)[:, -1], atol=F32_TOL)


def test_qkv_project_matches_reference():
    rcfg = rget("qwen2-72b").reduced()
    cfg = get_arch("qwen2-72b").reduced()
    p = rattn.attention_init(jax.random.PRNGKey(3), rcfg)
    x = np.random.default_rng(3).standard_normal((2, 10, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(10), (2, 10)).astype(np.int32)
    want = rattn.qkv_project(p, jnp.asarray(x), rcfg, jnp.asarray(pos), jnp.float32)
    got = attn.qkv_project(
        Params(jax.tree_util.tree_map(lambda a: torch.tensor(np.asarray(a)), p)),
        torch.from_numpy(x), cfg, torch.from_numpy(pos), torch.float32)
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), _np(w), rtol=F32_TOL, atol=F32_TOL)


def test_kernel_arguments_are_checked():
    q, k, v = _t(*_qkv(1, 8, 3, 2, 16, seed=0))
    with pytest.raises(ValueError, match="multiple of kvh"):
        ops.flash_attention(q, k, v)


# -- the bfloat16 kernel's arithmetic, emulated ----------------------------------

def _bf16_route_emulation(q, k, v, *, causal=True, q_offset=0, keys=64):
    """Test-only torch emulation of the card's bfloat16 tensor-core kernel
    (``flash_fwd_bf16_mma``): bf16 Q·Kᵀ summed in float32; scale times
    log2(e) and the -1e30 mask; the online softmax over tiles of ``keys``
    keys in base 2; P rounded to bf16 before P·V (float32 sums); the
    denominator from the float32 P, clamped at 1e-30; the output rounded
    once to bf16."""
    b, sq, h, d = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    qf = q.float().reshape(b, sq, kvh, h // kvh, d)
    kf, vf = k.float(), v.float()
    scale_log2 = torch.tensor(1.0 / math.sqrt(d), dtype=torch.float32) \
        * torch.tensor(math.log2(math.e), dtype=torch.float32)
    m = torch.full((b, kvh, h // kvh, sq), fa.NEG_INF)
    l = torch.zeros((b, kvh, h // kvh, sq))
    acc = torch.zeros((b, kvh, h // kvh, sq, d))
    qpos = torch.arange(sq) + q_offset
    for t0 in range(0, skv, keys):
        kt, vt = kf[:, t0:t0 + keys], vf[:, t0:t0 + keys]
        s = torch.einsum("bqgrd,bkgd->bgrqk", qf, kt) * scale_log2
        kpos = torch.arange(t0, t0 + kt.shape[1])
        if causal:
            s = s.masked_fill(kpos[None, :] > qpos[:, None], fa.NEG_INF)
        mx = torch.maximum(m, s.amax(-1))
        alpha = torch.exp2(m - mx)
        p = torch.exp2(s - mx[..., None])
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bgrqk,bkgd->bgrqd", p.to(torch.bfloat16).float(), vt)
        m = mx
    out = acc / l.clamp_min(1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, d).to(torch.bfloat16)


def _design_close(got, want):
    scale = float(np.abs(want).max())
    assert float(np.abs(got - want).max()) <= DESIGN_TOL * scale


def _row_err(got, want):
    """Max over query rows of the row's max |err| over its max |want|."""
    return float((np.abs(got - want).max(-1)
                  / np.maximum(np.abs(want).max(-1), 1e-30)).max())


@pytest.mark.parametrize("d", [16, 32, 64, 128])
@pytest.mark.parametrize("rep", [1, 2, 8])
@pytest.mark.parametrize("causal,sq,skv,q_offset", [
    (True, 128, 128, 0), (False, 128, 128, 0), (True, 100, 100, 0),
    (False, 70, 130, 0), (True, 37, 150, 113)])
def test_bf16_kernel_design_stays_within_a_quarter_of_its_tolerance(
        d, rep, causal, sq, skv, q_offset):
    """Every head dim, GQA groups of 1, 2 and 8, causal and not, ragged
    lengths and a query block at q_offset > 0 over a longer key sequence:
    the emulated bfloat16 route against the plain version and, where the
    Pallas kernel takes the shape (equal lengths that its 64-row blocks
    divide, no offset; K/V repeated to the query heads), against it in
    interpret mode."""
    q, k, v = _qkv(1, sq, rep, 1, d, seed=d * rep + sq + skv, skv=skv)
    qb, kb, vb = _t(q, k, v, dtype=torch.bfloat16)
    got = _np(_bf16_route_emulation(qb, kb, vb, causal=causal, q_offset=q_offset))
    exact = [a.float() for a in (qb, kb, vb)]
    plain = _np(fa.flash_attention_plain(*exact, causal=causal, q_offset=q_offset))
    _design_close(got, plain)
    assert _row_err(got, plain) <= ROW_TOL
    if sq == skv and sq % 64 == 0 and not q_offset:
        kr, vr = (np.repeat(_np(a), rep, axis=2) for a in (kb, vb))
        want = rops.flash_attention(*_j(_np(qb), kr, vr), causal=causal,
                                    block_q=64, block_kv=64)
        _design_close(got, _np(want))


@pytest.mark.parametrize("d", [16, 64, 128])
def test_row_gate_rejects_a_key_tile_lost_from_the_late_rows(d):
    """The last 64 query rows of a causal 1,024-token sequence lose their
    diagonal key tile.  Their outputs are ~1/32 of the first rows', so
    against the whole output's scale the fault is near the 2e-2 gate;
    row by row it is far past `ROW_TOL`."""
    q, k, v = _qkv(1, 1024, 2, 1, d, seed=d)
    qb, kb, vb = _t(q, k, v, dtype=torch.bfloat16)
    want = _np(fa.flash_attention_plain(qb, kb, vb))
    got = _np(_bf16_route_emulation(qb, kb, vb))
    got[:, 960:] = _np(_bf16_route_emulation(qb[:, 960:], kb[:, :960], vb[:, :960],
                                             q_offset=960))
    assert _row_err(got, want) > ROW_TOL
