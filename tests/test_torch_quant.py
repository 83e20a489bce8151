"""Port int8 path (repro_torch.quant, int8 executor and profiler) held
against the reference (repro.quant.int8).

Every int8 op type runs in both packages on the same int8 inputs (made
with numpy; the graph travels as `OpGraph.to_json`), the reference
through its *jitted* op callable, as its executor runs it.  Integer
outputs must be EQUAL, with no tolerance.

The rule for transcendental activations (exp, log, sigmoid, swish, gelu,
tanh): their float round trip uses torch's own transcendental functions,
which may differ from XLA's in the last bit, and an element next to a
rounding boundary would then move by one quantization step.  A unary
round trip only ever sees the 256 int8 values, so
`test_unary_round_trip_on_every_int8_value` compares all of them: on the
host every kind agrees with the reference on every value, so the rule
allows no difference here and every op and graph test is exact.  (On the
card chip_smoke.py reports how many int8 values differ per kind.)
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import executor as rex  # noqa: E402
from repro.core.dataset import synthetic_graphs as ref_graphs  # noqa: E402
from repro.core.ir import OpGraph as RefGraph  # noqa: E402
from repro.core.profiler import DeviceSetting as RefSetting  # noqa: E402
from repro.core.profiler import ProfileSession as RefSession  # noqa: E402
from repro.pipeline.store import ProfileStore as RefStore  # noqa: E402
from repro.quant import int8 as rq  # noqa: E402

from repro_torch.core import executor as pex  # noqa: E402
from repro_torch.core.dataset import synthetic_graphs  # noqa: E402
from repro_torch.core.ir import OpGraph  # noqa: E402
from repro_torch.core.profiler import DeviceSetting, ProfileSession  # noqa: E402
from repro_torch.pipeline.store import ProfileStore  # noqa: E402
from repro_torch.quant import int8 as pq  # noqa: E402

UNARY = ["exp", "log", "sqrt", "square", "abs", "neg", "copy", "relu", "relu6",
         "hswish", "swish", "sigmoid", "gelu", "tanh", "identity", "div"]


def test_scales_are_the_reference_values():
    assert (pq.ACT_SCALE, pq.WEIGHT_SCALE) == (rq.ACT_SCALE, rq.WEIGHT_SCALE)
    assert pq.RELU6_Q == round(6.0 / rq.ACT_SCALE)


def _near_half_steps(n, seed):
    # Values on and one ulp beside quantization half-steps, where a
    # division and a reciprocal multiply round differently.
    rng = np.random.default_rng(seed)
    q = (rng.integers(-140, 140, n) + 0.5).astype(np.float32)
    x = (q * np.float32(rq.ACT_SCALE)).astype(np.float32)
    return np.concatenate([x, np.nextafter(x, np.float32(9)),
                           np.nextafter(x, np.float32(-9)),
                           rng.standard_normal(n).astype(np.float32) * 3])


def test_quantize_is_the_jitted_reciprocal_multiply():
    x = _near_half_steps(20000, seed=0)
    jitted = np.asarray(jax.jit(lambda a: rq.quantize_symmetric(a, rq.ACT_SCALE))(
        jnp.asarray(x)))
    eager = np.asarray(rq.quantize_symmetric(jnp.asarray(x), rq.ACT_SCALE))
    assert not np.array_equal(jitted, eager)      # the two forms do differ here
    got = pq.quantize_symmetric(torch.from_numpy(x), pq.ACT_SCALE)
    assert got.dtype == torch.int8
    assert np.array_equal(got.numpy(), jitted)


@pytest.mark.parametrize("fn,args", [
    ("dequantize", (rq.ACT_SCALE,)),
    ("requantize", (rq.ACT_SCALE * rq.WEIGHT_SCALE, rq.ACT_SCALE)),
    ("requantize", (rq.ACT_SCALE / 49, rq.ACT_SCALE)),
    ("rescale_int8", (rq.ACT_SCALE, rq.ACT_SCALE * 1.5)),
    ("rescale_int8", (0.1, 0.2))])
def test_scalar_helpers_equal_the_jitted_reference(fn, args):
    rng = np.random.default_rng(1)
    if fn == "requantize":
        a = rng.integers(-2 ** 20, 2 ** 20, 50000).astype(np.int32)
    else:
        a = np.arange(-128, 128, dtype=np.int8)
    want = np.asarray(jax.jit(lambda v: getattr(rq, fn)(v, *args))(jnp.asarray(a)))
    got = getattr(pq, fn)(torch.from_numpy(a), *args).numpy()
    assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("kind", UNARY)
def test_unary_round_trip_on_every_int8_value(kind):
    q = np.arange(-128, 128, dtype=np.int8)
    want = np.asarray(jax.jit(lambda v: rq.quantize_symmetric(
        rq._float_unary(kind)(rq.dequantize(v, rq.ACT_SCALE)), rq.ACT_SCALE))(
            jnp.asarray(q)))
    got = pq._lut_roundtrip(torch.from_numpy(q), kind).numpy()
    assert np.array_equal(got, want)


# -- one op at a time ---------------------------------------------------------

def _one_op(op_type, in_shapes, out_shapes, params, fused=()):
    g = RefGraph("one")
    ins = [g.add_input(s) for s in in_shapes]
    outs = g.add_op(op_type, ins, out_shapes, params)
    if fused:
        g.nodes[-1] = g.nodes[-1].with_fused(fused)
    for o in outs:
        g.mark_output(o)
    return g


def _check(g, seed=0):
    pg = OpGraph.from_json(g.to_json())
    rng = np.random.default_rng(seed)
    xs = [rng.integers(-127, 128, g.tensor(t).shape).astype(np.int8)
          for t in g.nodes[0].inputs]
    fn, _ = rq.build_quant_op_fn(g, g.nodes[0])
    want = jax.jit(fn)(*[jnp.asarray(x) for x in xs])
    pfn, _ = pq.build_quant_op_fn(pg, pg.nodes[0], device="cpu")
    got = pfn(*[torch.from_numpy(x) for x in xs])
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    assert len(want) == len(got)
    for w, o in zip(want, got):
        w = np.asarray(w)
        assert o.dtype == torch.int8 and w.dtype == np.int8
        assert tuple(o.shape) == w.shape
        assert np.array_equal(o.numpy(), w)


def _out_hw(h, k, s, padding):
    return -(-h // s) if padding == "SAME" else (h - k) // s + 1


CONV_CASES = [
    # (H, W, C, K, kernel, stride, padding, act)
    (16, 16, 8, 12, 3, 1, "SAME", "relu"),
    (16, 16, 8, 12, 3, 2, "SAME", None),
    (15, 15, 6, 8, 5, 2, "SAME", "relu6"),
    (16, 14, 8, 8, 4, 2, "SAME", "hswish"),
    (17, 17, 8, 12, 3, 2, "VALID", "swish"),
    (8, 8, 16, 32, 1, 1, "SAME", "sigmoid"),
    (9, 9, 16, 24, 1, 2, "SAME", "gelu"),
    (8, 8, 40, 20, 3, 1, "SAME", "tanh"),
]


@pytest.mark.parametrize("h,w,c,k,kern,s,pad,act", CONV_CASES)
def test_dense_conv2d(h, w, c, k, kern, s, pad, act):
    oh, ow = _out_hw(h, kern, s, pad), _out_hw(w, kern, s, pad)
    _check(_one_op("conv2d", [(2, h, w, c)], [(2, oh, ow, k)],
                   {"kernel_h": kern, "kernel_w": kern, "stride": s,
                    "groups": 1, "act": act, "padding": pad}))


def test_int8_winograd_op_is_a_plain_conv():
    _check(_one_op("winograd_conv2d", [(1, 9, 9, 8)], [(1, 9, 9, 12)],
                   {"kernel_h": 3, "kernel_w": 3, "stride": 1, "act": "relu"}))


@pytest.mark.parametrize("stride,naive", [(1, False), (2, False), (1, True)])
def test_grouped_conv2d(stride, naive):
    oh = _out_hw(16, 3, stride, "SAME")
    _check(_one_op("grouped_conv2d", [(1, 16, 16, 8)], [(1, oh, oh, 12)],
                   {"kernel_h": 3, "kernel_w": 3, "stride": stride,
                    "groups": 4, "act": "relu6", "naive_split": naive}))


@pytest.mark.parametrize("kern,s,pad,act", [(3, 1, "SAME", "relu6"),
                                            (5, 2, "SAME", "relu"),
                                            (3, 2, "VALID", "hswish"),
                                            (7, 1, "SAME", None)])
def test_dwconv2d(kern, s, pad, act):
    oh = _out_hw(14, kern, s, pad)
    _check(_one_op("dwconv2d", [(2, 14, 14, 8)], [(2, oh, oh, 8)],
                   {"kernel_h": kern, "kernel_w": kern, "stride": s,
                    "act": act, "padding": pad}))


@pytest.mark.parametrize("in_shape,out_shape,act", [
    ((2, 63), (2, 252), "relu"), ((1, 1, 1, 40), (1, 1, 1, 24), None),
    ((3, 17), (3, 5), "hswish")])
def test_fully_connected(in_shape, out_shape, act):
    _check(_one_op("fully_connected", [in_shape], [out_shape], {"act": act}))


@pytest.mark.parametrize("keep", [False, True])
def test_mean(keep):
    out = (2, 1, 1, 8) if keep else (2, 8)
    _check(_one_op("mean", [(2, 9, 9, 8)], [out], {"keepdims": keep}))


@pytest.mark.parametrize("kind", ["pool_avg", "pool_max"])
@pytest.mark.parametrize("h,k,s", [(16, 3, 2), (16, 2, 2), (15, 3, 1), (9, 5, 2)])
def test_pools(kind, h, k, s):
    oh = -(-h // s)
    _check(_one_op(kind, [(2, h, h, 4)], [(2, oh, oh, 4)],
                   {"kernel_h": k, "kernel_w": k, "stride": s}))


def test_concat_split_pad_shuffle():
    _check(_one_op("concat", [(1, 5, 5, 3), (1, 5, 5, 4)], [(1, 5, 5, 7)],
                   {"axis": -1}))
    _check(_one_op("split", [(1, 5, 5, 8)], [(1, 5, 5, 4), (1, 5, 5, 4)],
                   {"num_splits": 2, "axis": -1}))
    _check(_one_op("pad", [(1, 6, 6, 3)], [(1, 9, 7, 3)],
                   {"paddings": ((0, 0), (1, 2), (0, 1), (0, 0))}))
    _check(_one_op("channel_shuffle", [(1, 4, 4, 8)], [(1, 4, 4, 8)],
                   {"groups": 2}))


@pytest.mark.parametrize("kind", ["add", "sub", "maximum", "minimum", "mul"])
@pytest.mark.parametrize("n_in", [1, 2])
def test_elementwise_binary(kind, n_in):
    _check(_one_op("elementwise", [(2, 6, 6, 4)] * n_in, [(2, 6, 6, 4)],
                   {"ew_kind": kind, "n_inputs": n_in}))


@pytest.mark.parametrize("kind", ["exp", "sqrt", "neg", "tanh", "pow"])
def test_elementwise_unary(kind):
    _check(_one_op("elementwise", [(2, 6, 6, 4)], [(2, 6, 6, 4)],
                   {"ew_kind": kind}))


@pytest.mark.parametrize("act", ["relu", "relu6", "hswish", "sigmoid", "gelu"])
def test_activation(act):
    _check(_one_op("activation", [(2, 6, 6, 4)], [(2, 6, 6, 4)], {"act": act}))


@pytest.mark.parametrize("fused", [
    ("hswish",), ("add", "sqrt"), ("sqrt", "add@self"),
    ("relu6", "mul", "sigmoid", "sub@self", "exp"), ("maximum", "minimum"),
    ("activation", "elementwise_lm")])
def test_fused_tails(fused):
    n_extra = sum(1 for k in fused if k in ("add", "sub", "mul", "maximum",
                                            "minimum"))
    g = RefGraph("tail")
    x = g.add_input((1, 8, 8, 4))
    extras = [g.add_input((1, 8, 8, 6)) for _ in range(n_extra)]
    (y,) = g.add_op("conv2d", [x] + extras, [(1, 8, 8, 6)],
                    {"kernel_h": 3, "kernel_w": 3, "stride": 1, "groups": 1,
                     "act": None, "padding": "SAME", "n_inputs": 1})
    g.nodes[-1] = g.nodes[-1].with_fused(fused)
    g.mark_output(y)
    _check(g)


def test_dense_ops_go_through_the_gemm_grouped_ones_do_not(monkeypatch):
    calls = []
    real = pq.int8_matmul_packed

    def counting(*args, **kwargs):
        calls.append(args[0].shape)
        return real(*args, **kwargs)

    monkeypatch.setattr(pq, "int8_matmul_packed", counting)
    cases = [("conv2d", (1, 8, 8, 4), (1, 8, 8, 6), {"kernel_h": 3, "kernel_w": 3}, 1),
             ("fully_connected", (2, 16), (2, 5), {}, 1),
             ("dwconv2d", (1, 8, 8, 4), (1, 8, 8, 4), {"kernel_h": 3, "kernel_w": 3}, 0),
             ("grouped_conv2d", (1, 8, 8, 4), (1, 8, 8, 4),
              {"kernel_h": 3, "kernel_w": 3, "groups": 2}, 0)]
    for op, i, o, params, n in cases:
        g = OpGraph.from_json(_one_op(op, [i], [o], params).to_json())
        fn, _ = pq.build_quant_op_fn(g, g.nodes[0], device="cpu")
        calls.clear()
        fn(torch.zeros(i, dtype=torch.int8))
        assert len(calls) == n, op


def test_resize_is_not_an_int8_op_in_either_package():
    g = _one_op("resize", [(1, 4, 4, 2)], [(1, 8, 8, 2)], {"mode": "nearest"})
    with pytest.raises(NotImplementedError):
        rq.build_quant_op_fn(g, g.nodes[0])
    pg = OpGraph.from_json(g.to_json())
    with pytest.raises(NotImplementedError):
        pq.build_quant_op_fn(pg, pg.nodes[0], device="cpu")


# -- whole graphs and the profiler ---------------------------------------------

@pytest.mark.parametrize("mode", ["op_by_op", "fused_groups"])
@pytest.mark.parametrize("idx", [0, 1])
def test_int8_graph_executor_matches_reference(mode, idx):
    ref_g = ref_graphs(2, resolution=16)[idx]
    g = synthetic_graphs(2, resolution=16)[idx]
    rex_ = rex.GraphExecutor(ref_g, mode=mode, dtype="int8")
    pex_ = pex.GraphExecutor(g, mode=mode, dtype="int8", device="cpu")
    assert pex_.kernel_count() == rex_.kernel_count()
    ins_ref = rex_.example_inputs()
    ins = pex_.example_inputs()
    for a, b in zip(ins_ref, ins):
        assert b.dtype == torch.int8 and np.array_equal(np.asarray(a), b.numpy())
    want = rex_(*ins_ref, sync_per_op=mode == "op_by_op")
    got = pex_(*ins, sync_per_op=mode == "op_by_op")
    assert len(got) == len(want)
    for o, w in zip(got, want):
        assert o.dtype == torch.int8
        assert np.array_equal(o.numpy(), np.asarray(w))


def _schema(v):
    if isinstance(v, dict):
        return {k: _schema(w) for k, w in v.items()}
    if isinstance(v, list):
        return [_schema(w) for w in v[:1]]
    return type(v).__name__


def test_int8_profile_session_matches_reference_records(tmp_path):
    kw = dict(warmup=1, inner=1, repeats=1, e2e_inner=1, e2e_repeats=1)
    ref_set = RefSetting("h100_int8", "int8", "op_by_op", device="h100")
    setting = DeviceSetting("h100_int8", "int8", "op_by_op", device="h100")
    ref_store = RefStore(str(tmp_path / "ref.jsonl"))
    store = ProfileStore(str(tmp_path / "port.jsonl"))
    ref_recs = RefSession(store=ref_store, **kw).profile_suite(
        ref_graphs(2, resolution=16), ref_set)
    session = ProfileSession(store=store, device="cpu", **kw)
    recs = session.profile_suite(synthetic_graphs(2, resolution=16), setting)
    ref_store.close()
    store.close()
    assert session.measured_graphs == 2 and session.measured_ops > 0
    for r, p in zip(ref_recs, recs):
        assert (p.name, p.num_ops, p.num_kernels) == (r.name, r.num_ops,
                                                      r.num_kernels)
        assert [o.signature for o in p.ops] == [o.signature for o in r.ops]
        assert [o.op_type for o in p.ops] == [o.op_type for o in r.ops]
        assert [o.features for o in p.ops] == [o.features for o in r.ops]
        assert all(o.latency_s > 0 for o in p.ops) and p.e2e_s > 0
    lines = [json.loads(s) for s in open(tmp_path / "port.jsonl")]
    ref_lines = [json.loads(s) for s in open(tmp_path / "ref.jsonl")]
    assert [_schema(d) for d in lines] == [_schema(d) for d in ref_lines]
    assert len(RefStore(str(tmp_path / "port.jsonl"))) == len(ref_store)


# -- im2col patches for the int8 GEMM kernel ---------------------------------

# (kernel, stride, C): kh·kw·C and C not multiples of 16, as on the main path.
IM2COL_CASES = [(3, 1, 9), (3, 2, 5), (7, 2, 3), (5, 1, 7), (1, 2, 19), (3, 1, 16)]


@pytest.mark.parametrize("kern,s,c", IM2COL_CASES)
def test_im2col_patches_are_16_byte_aligned_rows_of_the_same_values(kern, s, c):
    rng = np.random.default_rng(kern * 10 + c)
    x = torch.from_numpy(rng.integers(-127, 128, (2, 11, 13, c)).astype(np.int8))
    xp = pq._pad_for(x, kern, kern, s, "SAME")
    cols, (b, oh, ow) = pq._im2col(xp, kern, kern, s)
    width = kern * kern * c
    assert cols.shape == (b * oh * ow, width) and cols.stride(1) == 1
    assert cols.stride(0) % pq.PATCH_ALIGN == 0 and cols.data_ptr() % pq.PATCH_ALIGN == 0
    # The same values as the contiguous gather of the windows.
    want = pq._windows(xp, kern, kern, s).permute(0, 1, 2, 4, 5, 3)
    assert torch.equal(cols, want.reshape(b * oh * ow, width))


@pytest.mark.parametrize("kern,s,c", IM2COL_CASES)
def test_dense_conv2d_on_aligned_patches_equals_the_jitted_reference(kern, s, c):
    oh, ow = _out_hw(11, kern, s, "SAME"), _out_hw(13, kern, s, "SAME")
    _check(_one_op("conv2d", [(2, 11, 13, c)], [(2, oh, ow, 10)],
                   {"kernel_h": kern, "kernel_w": kern, "stride": s,
                    "groups": 1, "act": "relu", "padding": "SAME"}), seed=c)
