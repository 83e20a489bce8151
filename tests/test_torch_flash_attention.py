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

def _bf16_route_emulation(q, k, v, *, causal=True, q_offset=0, window=0,
                          softcap=0.0, keys=64, rows=64, clear_hidden=True):
    """Test-only torch emulation of the card's bfloat16 tensor-core kernel
    (``flash_fwd_bf16_mma``), one block of ``rows`` query rows at a time:
    bf16 Q·Kᵀ summed in float32; the scale times log2(e) (or, with a
    softcap, softcap·tanh(s·scale / softcap) then log2(e)) and the -1e30
    mask; the key loop from the tile of the block's first visible key
    (``max(0, q0 + q_offset - window + 1)``) to its causal end; the online
    softmax over tiles of ``keys`` keys in base 2; P rounded to bf16
    before P·V (float32 sums); the denominator from the float32 P, clamped
    at 1e-30; the output rounded once to bf16.  ``clear_hidden=False``
    emulates a fault: a row whose tiles so far were wholly hidden keeps
    their p = 1 sums (no rescale at its first visible key)."""
    b, sq, h, d = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    qf = q.float().reshape(b, sq, kvh, h // kvh, d)
    kf, vf = k.float(), v.float()
    scale = torch.tensor(1.0 / math.sqrt(d), dtype=torch.float32)
    log2e = torch.tensor(math.log2(math.e), dtype=torch.float32)
    out = torch.zeros((b, kvh, h // kvh, sq, d))
    for q0 in range(0, sq, rows):
        qb = qf[:, q0:q0 + rows]
        n = qb.shape[1]
        m = torch.full((b, kvh, h // kvh, n), fa.NEG_INF)
        l = torch.zeros((b, kvh, h // kvh, n))
        acc = torch.zeros((b, kvh, h // kvh, n, d))
        begin = max(0, q0 + q_offset - window + 1) // keys * keys if window else 0
        end = min(skv, q0 + rows + q_offset) if causal else skv
        for t0 in range(begin, end, keys):
            kt, vt = kf[:, t0:t0 + keys], vf[:, t0:t0 + keys]
            s = torch.einsum("bqgrd,bkgd->bgrqk", qb, kt)
            if softcap:
                s = torch.tanh(s * scale / softcap) * softcap * log2e
            else:
                s = s * (scale * log2e)
            s = s.masked_fill(fa.hidden_keys(n, kt.shape[1], causal=causal,
                                             q_offset=q_offset + q0 - t0,
                                             window=window), fa.NEG_INF)
            mx = torch.maximum(m, s.amax(-1))
            alpha = torch.exp2(m - mx)
            if not clear_hidden:
                alpha = torch.where(m <= fa.NEG_INF, torch.ones_like(alpha), alpha)
            p = torch.exp2(s - mx[..., None])
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bgrqk,bkgd->bgrqd", p.to(torch.bfloat16).float(), vt)
            m = mx
        out[:, :, :, q0:q0 + n] = acc / l.clamp_min(1e-30)[..., None]
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


# -- window and softcap: the reference's model attention -------------------------

# The masks and the softcap against the reference's naive and chunked
# attention (the function the kernel takes over): float32, 1e-5.
MODEL_F32_TOL = 1e-5
# (sq, skv, q_offset, h, kvh): equal lengths with GQA, and a query block
# at q_offset > 0 over a longer key sequence with one kv head.
MASK_SHAPES = [(160, 160, 0, 4, 2), (96, 160, 64, 4, 1)]


@pytest.mark.parametrize("window", [0, 8, 100])
@pytest.mark.parametrize("cap", [0.0, 5.0, 50.0])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("sq,skv,q_offset,h,kvh", MASK_SHAPES)
def test_masks_and_softcap_match_reference_model_attention(window, cap, causal,
                                                           sq, skv, q_offset, h, kvh):
    """The plain version, and the port's naive and chunked attention, over
    the grid of windows, softcaps and causal masks, against the
    reference's naive attention and its chunked attention with a
    q_chunk of 64 (its scan path).  Queries are scaled by 3 so that the
    softcap of 5 bends the scores."""
    q, k, v = _qkv(2, sq, h, kvh, 32, seed=sq + window + int(cap) + causal, skv=skv)
    q = 3 * q
    kw = dict(causal=causal, window=window, logit_softcap=cap, q_offset=q_offset)
    want = rattn.naive_attention(*_j(q, k, v), **kw)
    chunked = rattn.chunked_attention(*_j(q, k, v), q_chunk=64, **kw)
    np.testing.assert_allclose(_np(chunked), _np(want), rtol=MODEL_F32_TOL,
                               atol=MODEL_F32_TOL)
    got = [fa.flash_attention_plain(*_t(q, k, v), causal=causal, window=window,
                                    softcap=cap, q_offset=q_offset),
           attn.naive_attention(*_t(q, k, v), **kw),
           attn.chunked_attention(*_t(q, k, v), q_chunk=64, **kw)]
    for g in got:
        np.testing.assert_allclose(_np(g), _np(want), rtol=MODEL_F32_TOL,
                                   atol=MODEL_F32_TOL)


@pytest.mark.parametrize("window,cap", [(8, 0.0), (100, 5.0), (0, 50.0)])
def test_masks_and_softcap_match_reference_model_attention_bf16(window, cap):
    q, k, v = _qkv(1, 160, 4, 2, 32, seed=window + int(cap))
    kw = dict(window=window, logit_softcap=cap)
    want = rattn.chunked_attention(*_j(q, k, v, dtype=jnp.bfloat16), q_chunk=64, **kw)
    got = attn.chunked_attention(*_t(q, k, v, dtype=torch.bfloat16), **kw)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), _np(want), rtol=BF16_TOL, atol=BF16_TOL)


def test_a_row_that_sees_no_key_averages_v_as_the_reference():
    """Non-causal, window 4, q_offset 20 over 8 keys: every key is masked
    from every row, and the reference's softmax over equal masked scores
    averages V; so does the plain version."""
    q, k, v = _qkv(1, 8, 2, 2, 16, seed=1)
    want = rattn.naive_attention(*_j(q, k, v), causal=False, window=4, q_offset=20)
    got = fa.flash_attention_plain(*_t(q, k, v), causal=False, window=4, q_offset=20)
    np.testing.assert_allclose(_np(got), _np(want), rtol=F32_TOL, atol=F32_TOL)
    np.testing.assert_allclose(_np(got)[0, 0], v.mean(axis=1)[0], rtol=F32_TOL,
                               atol=F32_TOL)


@pytest.mark.parametrize("window,cap", [(-1, 0.0), (0, -1.0), (0, float("inf")),
                                        (0, float("nan"))])
def test_bad_window_or_softcap_is_refused(window, cap):
    q, k, v = _t(*_qkv(1, 8, 2, 2, 16, seed=0))
    with pytest.raises(ValueError, match="softcap"):
        ops.flash_attention(q, k, v, window=window, softcap=cap)


@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("causal,sq,skv,q_offset,window,cap", [
    (True, 1000, 1000, 0, 100, 5.0), (True, 300, 300, 0, 8, 0.0),
    (True, 200, 200, 0, 64, 50.0), (False, 130, 200, 0, 0, 5.0),
    (False, 160, 160, 0, 40, 0.0), (True, 77, 333, 256, 100, 0.0)])
def test_bf16_kernel_design_with_window_and_softcap(d, causal, sq, skv, q_offset,
                                                    window, cap):
    """The emulated bfloat16 route with the window's tile skip and the
    softcap, within a quarter of the card's tolerance of the plain
    version and within the row gate.  A window of 100 or 8 (not multiples
    of the 64-key tile) leaves the late rows of a query tile with first
    key tiles wholly hidden: their p = 1 sums must be cleared by the
    rescale at their first visible key."""
    q, k, v = _qkv(1, sq, 4, 2, d, seed=d + sq + window, skv=skv)
    qb, kb, vb = _t(3 * q, k, v, dtype=torch.bfloat16)
    kw = dict(causal=causal, q_offset=q_offset, window=window, softcap=cap)
    got = _np(_bf16_route_emulation(qb, kb, vb, **kw))
    plain = _np(fa.flash_attention_plain(*[a.float() for a in (qb, kb, vb)], **kw))
    _design_close(got, plain)
    assert _row_err(got, plain) <= ROW_TOL


def test_row_gate_rejects_hidden_sums_left_uncleared():
    """A kernel that let a wholly hidden first tile's p = 1 sums stand (no
    rescale at the row's first visible key) fails the row gate: a window
    of 8 over 300 tokens, where each query tile's late rows start on a
    hidden key tile."""
    q, k, v = _qkv(1, 300, 2, 1, 64, seed=3)
    qb, kb, vb = _t(q, k, v, dtype=torch.bfloat16)
    want = _np(fa.flash_attention_plain(*[a.float() for a in (qb, kb, vb)], window=8))
    assert _row_err(_np(_bf16_route_emulation(qb, kb, vb, window=8)), want) <= ROW_TOL
    bad = _np(_bf16_route_emulation(qb, kb, vb, window=8, clear_hidden=False))
    assert _row_err(bad, want) > ROW_TOL
