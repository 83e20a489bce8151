"""Port executor/profiler (repro_torch) held against the reference (repro).

Every float32 op type of `build_op_fn` runs in both packages on the same
numpy inputs (the graph itself travels as `OpGraph.to_json`), with
``rtol=1e-5, atol=1e-6``: weights are the same bits (`make_array` /
`_weight_seed` are shared verbatim), but convolution, matmul and pool
sums run in a different order in XLA:CPU and in torch.  Whole graphs
compound those per-op differences over ~30 ops, so graph outputs use the
same bound relative to the output's scale (see `_close_graph`).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro.core import executor as rex  # noqa: E402
from repro.core.dataset import synthetic_graphs as ref_graphs  # noqa: E402
from repro.core.ir import OpGraph as RefGraph  # noqa: E402
from repro.core.profiler import DeviceSetting as RefSetting  # noqa: E402
from repro.core.profiler import ProfileSession as RefSession  # noqa: E402
from repro.pipeline.store import ProfileStore as RefStore  # noqa: E402

from repro_torch.core import executor as pex  # noqa: E402
from repro_torch.core.dataset import synthetic_graphs  # noqa: E402
from repro_torch.core.ir import OpGraph  # noqa: E402
from repro_torch.core.profiler import DeviceSetting, ProfileSession  # noqa: E402
from repro_torch.pipeline.store import ProfileStore  # noqa: E402
from repro_torch.utils import timing  # noqa: E402

RTOL, ATOL = 1e-5, 1e-6


def _one_op(op_type, in_shapes, out_shapes, params, fused=()):
    g = RefGraph("one")
    ins = [g.add_input(s) for s in in_shapes]
    outs = g.add_op(op_type, ins, out_shapes, params)
    if fused:
        g.nodes[-1] = g.nodes[-1].with_fused(fused)
    for o in outs:
        g.mark_output(o)
    return g


def _run_both(g, seed=0):
    """(reference outputs, port outputs) of the graph's single op."""
    pg = OpGraph.from_json(g.to_json())
    rng = np.random.default_rng(seed)
    xs = [rng.standard_normal(g.tensor(t).shape).astype(np.float32)
          for t in g.nodes[0].inputs]
    fn, _ = rex.build_op_fn(g, g.nodes[0])
    want = fn(*[jnp.asarray(x) for x in xs])
    pfn, _ = pex.build_op_fn(pg, pg.nodes[0], device="cpu")
    got = pfn(*[torch.from_numpy(x) for x in xs])
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    return [np.asarray(w) for w in want], [t.numpy() for t in got]


def _check(g, seed=0):
    want, got = _run_both(g, seed)
    assert len(want) == len(got)
    for w, o in zip(want, got):
        assert w.shape == o.shape
        np.testing.assert_allclose(o, w, rtol=RTOL, atol=ATOL)


def _out_hw(h, k, s, padding):
    return -(-h // s) if padding == "SAME" else (h - k) // s + 1


CONV_CASES = [
    # (H, W, C, K, kernel, stride, padding, act)
    (16, 16, 8, 12, 3, 1, "SAME", "relu"),
    (16, 16, 8, 12, 3, 2, "SAME", None),        # asymmetric: pad (0, 1)
    (15, 15, 6, 8, 5, 2, "SAME", "relu6"),      # odd size, k=5
    (16, 14, 8, 8, 4, 2, "SAME", None),         # even kernel: pad (1, 2)
    (16, 16, 8, 12, 3, 1, "VALID", None),
    (17, 17, 8, 12, 3, 2, "VALID", "relu"),
    (8, 8, 16, 32, 1, 1, "SAME", None),
]


@pytest.mark.parametrize("h,w,c,k,kern,s,pad,act", CONV_CASES)
def test_conv2d(h, w, c, k, kern, s, pad, act):
    oh, ow = _out_hw(h, kern, s, pad), _out_hw(w, kern, s, pad)
    _check(_one_op("conv2d", [(2, h, w, c)], [(2, oh, ow, k)],
                   {"kernel_h": kern, "kernel_w": kern, "stride": s,
                    "groups": 1, "act": act, "padding": pad}))


@pytest.mark.parametrize("naive", [False, True])
@pytest.mark.parametrize("stride", [1, 2])
def test_grouped_conv2d(naive, stride):
    oh = _out_hw(16, 3, stride, "SAME")
    _check(_one_op("grouped_conv2d", [(1, 16, 16, 8)], [(1, oh, oh, 12)],
                   {"kernel_h": 3, "kernel_w": 3, "stride": stride,
                    "groups": 4, "act": "relu", "naive_split": naive}))


@pytest.mark.parametrize("kern,s,pad", [(3, 1, "SAME"), (5, 2, "SAME"),
                                        (3, 2, "VALID"), (7, 1, "SAME")])
def test_dwconv2d(kern, s, pad):
    oh = _out_hw(14, kern, s, pad)
    _check(_one_op("dwconv2d", [(2, 14, 14, 8)], [(2, oh, oh, 8)],
                   {"kernel_h": kern, "kernel_w": kern, "stride": s,
                    "act": "relu6", "padding": pad}))


@pytest.mark.parametrize("h", [16, 15])
def test_winograd_conv2d(h):
    _check(_one_op("winograd_conv2d", [(1, h, h, 8)], [(1, h, h, 12)],
                   {"kernel_h": 3, "kernel_w": 3, "stride": 1, "act": "relu"}))


@pytest.mark.parametrize("in_shape,out_shape", [((2, 32), (2, 10)),
                                                ((1, 1, 1, 16), (1, 1, 1, 24))])
def test_fully_connected(in_shape, out_shape):
    _check(_one_op("fully_connected", [in_shape], [out_shape], {"act": "relu"}))


@pytest.mark.parametrize("keep", [False, True])
def test_mean(keep):
    out = (2, 1, 1, 8) if keep else (2, 8)
    _check(_one_op("mean", [(2, 9, 9, 8)], [out], {"keepdims": keep}))


@pytest.mark.parametrize("kind", ["pool_avg", "pool_max"])
@pytest.mark.parametrize("h,k,s", [(16, 3, 2), (16, 2, 2), (15, 3, 1),
                                   (15, 3, 2), (9, 5, 2)])
def test_pools_same_padding(kind, h, k, s):
    oh = -(-h // s)
    _check(_one_op(kind, [(2, h, h, 4)], [(2, oh, oh, 4)],
                   {"kernel_h": k, "kernel_w": k, "stride": s}))


def test_concat():
    _check(_one_op("concat", [(1, 5, 5, 3), (1, 5, 5, 4)], [(1, 5, 5, 7)],
                   {"axis": -1}))


def test_split():
    _check(_one_op("split", [(1, 5, 5, 8)], [(1, 5, 5, 4), (1, 5, 5, 4)],
                   {"num_splits": 2, "axis": -1}))


@pytest.mark.parametrize("pads", [((0, 0), (1, 1), (1, 1), (0, 0)),
                                  ((0, 0), (1, 2), (0, 1), (0, 0))])
def test_pad(pads):
    out = (1, 6 + sum(pads[1]), 6 + sum(pads[2]), 3)
    _check(_one_op("pad", [(1, 6, 6, 3)], [out], {"paddings": pads}))


def test_channel_shuffle():
    _check(_one_op("channel_shuffle", [(1, 4, 4, 8)], [(1, 4, 4, 8)],
                   {"groups": 2}))


UNOPS = ["exp", "log", "sqrt", "square", "abs", "neg", "copy"]
ACTS = ["relu", "relu6", "hswish", "swish", "sigmoid", "gelu", "tanh",
        "identity"]
BINOPS = ["add", "sub", "mul", "div", "maximum", "minimum", "pow", "equal",
          "greater", "less"]


@pytest.mark.parametrize("kind", UNOPS + ACTS)
def test_elementwise_unary(kind):
    _check(_one_op("elementwise", [(2, 6, 6, 4)], [(2, 6, 6, 4)],
                   {"ew_kind": kind}))


@pytest.mark.parametrize("kind", BINOPS)
def test_elementwise_binary(kind):
    _check(_one_op("elementwise", [(2, 6, 6, 4), (2, 6, 6, 4)], [(2, 6, 6, 4)],
                   {"ew_kind": kind}))


@pytest.mark.parametrize("kind", ["add", "mul", "equal"])
def test_elementwise_binary_on_itself(kind):
    _check(_one_op("elementwise", [(2, 6, 6, 4)], [(2, 6, 6, 4)],
                   {"ew_kind": kind}))


@pytest.mark.parametrize("act", ACTS)
def test_activation(act):
    # gelu is jax's tanh form (approximate="tanh"); swish is SiLU.
    _check(_one_op("activation", [(2, 6, 6, 4)], [(2, 6, 6, 4)], {"act": act}))


@pytest.mark.parametrize("src,dst", [(8, 16), (6, 16), (16, 6), (5, 7)])
def test_resize_nearest(src, dst):
    _check(_one_op("resize", [(1, src, src, 3)], [(1, dst, dst, 3)],
                   {"mode": "nearest"}))


@pytest.mark.parametrize("src,dst,legacy_agrees", [
    (8, 16, True), (6, 16, False), (16, 6, False), (5, 7, False)])
def test_resize_index_rule_is_torch_nearest_exact(src, dst, legacy_agrees):
    # jax.image.resize "nearest" samples floor((i + 0.5)·in/out): the
    # half-pixel rule of torch's "nearest-exact".  Torch's legacy
    # "nearest" (floor(i·in/out)) agrees only on exact ×2 upsampling.
    x = np.arange(src * src, dtype=np.float32).reshape(1, src, src, 1)
    g = _one_op("resize", [x.shape], [(1, dst, dst, 1)], {"mode": "nearest"})
    fn, _ = rex.build_op_fn(g, g.nodes[0])
    want = np.asarray(fn(jnp.asarray(x)))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    exact = F.interpolate(xt, size=(dst, dst), mode="nearest-exact")
    assert np.array_equal(exact.permute(0, 2, 3, 1).numpy(), want)
    legacy = F.interpolate(xt, size=(dst, dst), mode="nearest")
    assert np.array_equal(legacy.permute(0, 2, 3, 1).numpy(), want) \
        == legacy_agrees


@pytest.mark.parametrize("fused", [
    ("hswish",),
    ("add", "sqrt"),                     # binary tail consumes the extra input
    ("sqrt", "add@self"),                # diamond collapse: reads the base
    ("relu6", "mul", "sigmoid", "sub@self", "exp"),
    ("activation", "elementwise_lm"),
])
def test_fused_tails(fused):
    n_extra = sum(1 for k in fused if k in BINOPS)
    g = RefGraph("tail")
    x = g.add_input((1, 8, 8, 4))
    extras = [g.add_input((1, 8, 8, 6)) for _ in range(n_extra)]
    (y,) = g.add_op("conv2d", [x] + extras, [(1, 8, 8, 6)],
                    {"kernel_h": 3, "kernel_w": 3, "stride": 1, "groups": 1,
                     "act": None, "padding": "SAME", "n_inputs": 1})
    g.nodes[-1] = g.nodes[-1].with_fused(fused)
    g.mark_output(y)
    _check(g)


def test_binary_tail_without_operand_uses_half_output():
    # A binary fused kind with no extra operand left pairs with y·0.5.
    _check(_one_op("elementwise", [(1, 4, 4, 2)], [(1, 4, 4, 2)],
                   {"ew_kind": "abs"}, fused=("add", "mul")))


def test_unknown_op_type_raises():
    g = _one_op("elementwise", [(1, 2, 2, 1)], [(1, 2, 2, 1)], {"ew_kind": "abs"})
    pg = OpGraph.from_json(g.to_json())
    node = pg.nodes[0].with_type("attention")
    with pytest.raises(NotImplementedError):
        pex.build_op_fn(pg, node, device="cpu")


def test_tf32_is_switched_off_by_the_executor():
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    g = _one_op("elementwise", [(1, 2, 2, 1)], [(1, 2, 2, 1)], {"ew_kind": "abs"})
    pg = OpGraph.from_json(g.to_json())
    pex.build_op_fn(pg, pg.nodes[0], device="cpu")
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.backends.cuda.matmul.allow_tf32 is False


def test_weights_are_the_reference_bits():
    g = _one_op("conv2d", [(1, 8, 8, 4)], [(1, 8, 8, 6)],
                {"kernel_h": 3, "kernel_w": 3, "stride": 1, "groups": 1})
    pg = OpGraph.from_json(g.to_json())
    rw, rb = rex._conv_weights(g.nodes[0], g)
    pw, pb = pex._conv_weights(pg.nodes[0], pg)
    assert np.array_equal(rw, pw) and np.array_equal(rb, pb)
    assert pex._seed_from("abc", "w") == rex._seed_from("abc", "w")


# -- whole graphs ---------------------------------------------------------------

def _close_graph(got, want):
    # Per-op differences (rtol 1e-5) compound through ~30 ops; bound each
    # output by the same rtol/atol scaled to the output's magnitude.
    scale = max(1.0, float(np.max(np.abs(want))))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL * scale)


@pytest.mark.parametrize("mode", ["op_by_op", "fused_groups"])
@pytest.mark.parametrize("idx", [0, 1, 2])
def test_graph_executor_matches_reference(mode, idx):
    ref_g = ref_graphs(3, resolution=16)[idx]
    g = synthetic_graphs(3, resolution=16)[idx]
    assert g.fingerprint() == ref_g.fingerprint()
    rex_ = rex.GraphExecutor(ref_g, mode=mode)
    pex_ = pex.GraphExecutor(g, mode=mode, device="cpu")
    assert pex_.kernel_count() == rex_.kernel_count()
    ins_ref = rex_.example_inputs()
    ins = pex_.example_inputs()
    for a, b in zip(ins_ref, ins):
        assert np.array_equal(np.asarray(a), b.numpy())
    want = rex_(*ins_ref, sync_per_op=mode == "op_by_op")
    got = pex_(*ins, sync_per_op=mode == "op_by_op")
    assert len(got) == len(want)
    for o, w in zip(got, want):
        assert tuple(o.shape) == tuple(w.shape)
        _close_graph(o.numpy(), np.asarray(w))


def test_fused_groups_is_one_callable_per_fusion_group():
    shrunk = 0
    for g in synthetic_graphs(3, resolution=16):
        ex = pex.GraphExecutor(g, mode="fused_groups", device="cpu")
        assert ex.kernel_count() == len(ex.exec_graph.nodes) <= len(g.nodes)
        shrunk += ex.kernel_count() < len(g.nodes)
    assert shrunk > 0


# -- whole_jit: the reference jits the whole graph; on the host the port runs
# the op functions in one call (on the card: one CUDA-graph replay, held in
# tests/test_torch_cuda_kernels.py) ------------------------------------------------

def _whole_pair(dtype, idx):
    ref_g = ref_graphs(3, resolution=16)[idx]
    g = synthetic_graphs(3, resolution=16)[idx]
    return (rex.GraphExecutor(ref_g, mode="whole_jit", dtype=dtype),
            pex.GraphExecutor(g, mode="whole_jit", dtype=dtype, device="cpu"))


@pytest.mark.parametrize("dtype", ["float32", "int8"])
@pytest.mark.parametrize("idx", [0, 1, 2])
def test_whole_jit_matches_reference(dtype, idx):
    # XLA fuses across ops under the reference's whole-graph jit, so float32
    # sums differ in order: the `_close_graph` bound.  int8 outputs are
    # integers, which that bound holds exactly.
    rex_, pex_ = _whole_pair(dtype, idx)
    assert pex_.kernel_count() == rex_.kernel_count() == 1
    ins_ref = rex_.example_inputs()
    ins = pex_.example_inputs()
    for a, b in zip(ins_ref, ins):
        assert np.array_equal(np.asarray(a), b.numpy())
    want = rex_(*ins_ref)
    got = pex_(*ins)
    assert len(got) == len(want)
    for o, w in zip(got, want):
        assert tuple(o.shape) == tuple(w.shape)
        assert o.numpy().dtype == np.asarray(w).dtype
        _close_graph(o.numpy(), np.asarray(w))


@pytest.mark.parametrize("dtype", ["float32", "int8"])
@pytest.mark.parametrize("idx", [0, 1, 2])
def test_whole_jit_equals_op_by_op(dtype, idx):
    g = synthetic_graphs(3, resolution=16)[idx]
    whole = pex.GraphExecutor(g, mode="whole_jit", dtype=dtype, device="cpu")
    ops = pex.GraphExecutor(g, mode="op_by_op", dtype=dtype, device="cpu")
    assert whole.exec_graph is g and len(whole.op_fns) == ops.kernel_count()
    assert whole.kernel_count() == 1
    ins = ops.example_inputs()
    first = whole(*ins, sync_per_op=True)
    for got, want in zip(first, ops(*ins, sync_per_op=True)):
        assert torch.equal(got, want)
    again = whole(*ins)
    assert all(torch.equal(a, b) and a is not b for a, b in zip(first, again))
    assert whole.whole_graphs == {}         # captures only on the card


def test_profile_session_whole_jit_matches_reference_records(tmp_path):
    # The reference measures each op alone and times e2e through the whole
    # graph: same keys, signatures, features and kernel counts here.
    kw = dict(warmup=1, inner=1, repeats=1, e2e_inner=1, e2e_repeats=1)
    ref_set = RefSetting("h100_f32_whole", "float32", "whole_jit", device="h100")
    setting = DeviceSetting("h100_f32_whole", "float32", "whole_jit", device="h100")
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
        assert [(o.signature, o.op_type, o.features, o.fused) for o in p.ops] == \
            [(o.signature, o.op_type, o.features, o.fused) for o in r.ops]
        assert all(o.latency_s > 0 for o in p.ops) and p.e2e_s > 0
    import json
    lines = [json.loads(s) for s in open(tmp_path / "port.jsonl")]
    ref_lines = [json.loads(s) for s in open(tmp_path / "ref.jsonl")]
    keys = [(d["kind"], d.get("axis"), d.get("setting")) for d in lines]
    assert keys == [(d["kind"], d.get("axis"), d.get("setting")) for d in ref_lines]
    assert {d["setting"] for d in lines if d["kind"] == "arch"} == \
        {"h100:float32/whole_jit"}
    assert {d["axis"] for d in lines if d["kind"] == "op"} == {"h100:float32"}
    # Stores cross over: each package reads the other's whole_jit records.
    back = ProfileStore(str(tmp_path / "ref.jsonl"))
    for g, r in zip(synthetic_graphs(2, resolution=16), ref_recs):
        assert back.get_arch(setting, g.fingerprint()).e2e_s == r.e2e_s


# -- timing -----------------------------------------------------------------------

@pytest.mark.parametrize("warmup", [0, 1, 3])
def test_time_callable_honours_warmup(warmup):
    calls = []
    t = timing.time_callable(lambda: calls.append(1), warmup=warmup,
                             inner=4, repeats=2)
    assert len(calls) == warmup + 4 * 2 and t >= 0


def test_time_sequential_counts():
    calls = []
    fns = [(lambda: calls.append("a"), ()), (lambda: calls.append("b"), ())]
    timing.time_sequential(fns, warmup=0, inner=2, repeats=3)
    assert calls == ["a", "b"] * 6


# -- profiler ---------------------------------------------------------------------

def test_profile_session_matches_reference_records(tmp_path):
    # Same signatures, features, op/kernel counts and JSONL schema as the
    # reference; latencies are measured on different runtimes and are
    # not compared.
    kw = dict(warmup=1, inner=1, repeats=1, e2e_inner=1, e2e_repeats=1)
    ref_set = RefSetting("gpu_f32", "float32", "fused_groups", device="h100")
    setting = DeviceSetting("gpu_f32", "float32", "fused_groups", device="h100")
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
        assert [o.fused for o in p.ops] == [o.fused for o in r.ops]
        assert all(o.latency_s > 0 for o in p.ops) and p.e2e_s > 0
    import json
    ref_lines = [json.loads(s) for s in open(tmp_path / "ref.jsonl")]
    lines = [json.loads(s) for s in open(tmp_path / "port.jsonl")]
    assert len(lines) == len(ref_lines)

    def schema(v):
        if isinstance(v, dict):
            return {k: schema(w) for k, w in v.items()}
        if isinstance(v, list):
            return [schema(w) for w in v[:1]]
        return type(v).__name__
    assert [schema(d) for d in lines] == [schema(d) for d in ref_lines]
    # The reference's store reads what the port wrote, and vice versa.
    assert len(RefStore(str(tmp_path / "port.jsonl"))) == len(ref_store)
    assert len(ProfileStore(str(tmp_path / "ref.jsonl"))) == len(store)


def test_profile_session_warm_store_measures_nothing(tmp_path):
    kw = dict(warmup=0, inner=1, repeats=1, e2e_inner=1, e2e_repeats=1)
    setting = DeviceSetting("cpu_f32", "float32", "op_by_op")
    graphs = synthetic_graphs(1, resolution=16)
    store = ProfileStore(str(tmp_path / "s.jsonl"))
    ProfileSession(store=store, device="cpu", **kw).profile_suite(graphs, setting)
    store.close()
    again = ProfileSession(store=ProfileStore(str(tmp_path / "s.jsonl")),
                           device="cpu", **kw)
    again.profile_suite(graphs, setting)
    assert again.measured_ops == 0 and again.measured_graphs == 0
