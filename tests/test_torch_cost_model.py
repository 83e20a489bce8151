"""The port's roofline cost model (`core/cost_model.py`) and H100 profile.

Under ``get_device("tpu_v5e")`` the port's `op_cost`, `graph_cost` and
`synthetic_label` equal the reference's bit for bit (``==`` on floats),
on `synthetic_graphs(…, resolution=16)` and the real-world suite: the
formulas and the reference's per-kernel overhead are copied.  Under the
port's own ``h100`` profile, fusion never raises a graph's roofline
latency (the reference's property, tests/test_graph_properties.py), and
Alg. C.2 selects no Winograd kernel.
"""
import os

import pytest

hypothesis = pytest.importorskip("hypothesis")
from hypothesis import HealthCheck, given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from repro.core import cost_model as ref_cm  # noqa: E402
from repro.core import dataset as ref_dataset  # noqa: E402
from repro.core.selection import get_device as ref_device  # noqa: E402

from repro_torch.core import cost_model as cm  # noqa: E402
from repro_torch.core import dataset  # noqa: E402
from repro_torch.core.fusion import fuse_graph  # noqa: E402
from repro_torch.core.ir import OpGraph  # noqa: E402
from repro_torch.core.selection import (DEVICE_PROFILES, GPU_H100,  # noqa: E402
                                        apply_selection, get_device,
                                        select_conv_kernel)

settings.register_profile(
    "dev", max_examples=10, derandomize=True, deadline=None,
    suppress_health_check=[HealthCheck.too_slow])
settings.register_profile(
    "ci", max_examples=80, derandomize=True, deadline=None,
    suppress_health_check=[HealthCheck.too_slow])
settings.load_profile(os.environ.get("HYPOTHESIS_PROFILE", "dev"))


def _suites():
    return {"synthetic": (ref_dataset.synthetic_graphs(6, resolution=16),
                          dataset.synthetic_graphs(6, resolution=16)),
            "realworld": (ref_dataset.realworld_graphs(resolution=16),
                          dataset.realworld_graphs(resolution=16))}


SUITES = _suites()


@pytest.mark.parametrize("suite", sorted(SUITES))
@pytest.mark.parametrize("dtype", ["bf16", "int8"])
def test_op_cost_is_the_reference_bits_on_tpu_v5e(suite, dtype):
    ref_graphs, graphs = SUITES[suite]
    for rg, g in zip(ref_graphs, graphs):
        assert g.fingerprint() == rg.fingerprint()
        for rn, n in zip(rg.nodes, g.nodes):
            want = ref_cm.op_cost(rg, rn, ref_device("tpu_v5e"), dtype=dtype)
            got = cm.op_cost(g, n, get_device("tpu_v5e"), dtype=dtype)
            assert (got.flops, got.bytes_accessed, got.compute_s, got.memory_s,
                    got.total_s, got.bound) == \
                (want.flops, want.bytes_accessed, want.compute_s, want.memory_s,
                 want.total_s, want.bound)


@pytest.mark.parametrize("suite", sorted(SUITES))
@pytest.mark.parametrize("dtype", ["bf16", "int8"])
def test_graph_cost_is_the_reference_bits_on_tpu_v5e(suite, dtype):
    ref_graphs, graphs = SUITES[suite]
    for rg, g in zip(ref_graphs, graphs):
        assert cm.graph_cost(g, get_device("tpu_v5e"), dtype=dtype) == \
            ref_cm.graph_cost(rg, dtype=dtype)


@pytest.mark.parametrize("suite", sorted(SUITES))
@pytest.mark.parametrize("noise", [0.0, 0.15])
def test_synthetic_label_is_the_reference_bits_on_tpu_v5e(suite, noise):
    ref_graphs, graphs = SUITES[suite]
    for rg, g in zip(ref_graphs, graphs):
        for seed, (rn, n) in enumerate(zip(rg.nodes, g.nodes)):
            assert cm.synthetic_label(g, n, get_device("tpu_v5e"), noise=noise,
                                      seed=seed) == \
                ref_cm.synthetic_label(rg, rn, noise=noise, seed=seed)


def test_reference_overhead_kept_for_every_profile_but_the_h100():
    assert cm.KERNEL_OVERHEAD_S == ref_cm.KERNEL_OVERHEAD_S
    for name, dev in DEVICE_PROFILES.items():
        want = cm.H100_KERNEL_OVERHEAD_S if name == "h100" else ref_cm.KERNEL_OVERHEAD_S
        assert cm.kernel_overhead(dev) == want
    assert cm.H100_KERNEL_OVERHEAD_S > 0


def test_h100_profile_and_default():
    h100 = get_device("h100")
    assert (h100.kind, h100.peak_flops, h100.peak_int8_flops, h100.hbm_bw,
            h100.supports_winograd) == (GPU_H100, 989e12, 1979e12, 3.35e12, False)
    g = dataset.synthetic_graphs(1, resolution=16)[0]
    for n in g.nodes:
        assert cm.op_cost(g, n) == cm.op_cost(g, n, h100)
        c = cm.op_cost(g, n)
        assert c.total_s == max(c.compute_s, c.memory_s) + cm.H100_KERNEL_OVERHEAD_S
    assert cm.graph_cost(g) == cm.graph_cost(g, h100)


def _conv3x3(c, hw):
    g = OpGraph("conv3x3")
    x = g.add_input((1, hw, hw, c))
    (y,) = g.add_op("conv2d", [x], [(1, hw, hw, c)],
                    {"kernel_h": 3, "kernel_w": 3, "stride": 1, "groups": 1})
    g.mark_output(y)
    return g


@pytest.mark.parametrize("c,hw", [(64, 56), (128, 28), (256, 28), (96, 32)])
def test_h100_selects_no_winograd(c, hw):
    g = _conv3x3(c, hw)
    assert select_conv_kernel(get_device("mali_g76"), g.nodes[0], g) == "winograd_conv2d"
    assert select_conv_kernel(get_device("h100"), g.nodes[0], g) == "conv2d"


@pytest.mark.parametrize("suite", sorted(SUITES))
def test_h100_selection_keeps_every_conv_direct(suite):
    for g in SUITES[suite][1]:
        sel = apply_selection(g, get_device("h100"))
        assert "winograd_conv2d" not in sel.op_type_counts()
        # Alg. C.2's generic rules without Winograd, as the reference's CPU
        # profile runs them.
        assert [n.op_type for n in sel.nodes] == [
            n.op_type for n in apply_selection(g, get_device("cpu_xla")).nodes]


# -- tests/test_graph_properties.py's property on the port, h100 profile ----------

_EW_UNARY = ("sqrt", "abs", "square")
_EW_BINARY = ("add", "mul", "maximum")


@st.composite
def wild_graphs(draw):
    """The reference's fuzz strategy on the port's IR: arbitrary-fanout
    DAGs of shape-preserving ops, the same tensor twice into one binop
    included."""
    g = OpGraph("fuzz")
    c = draw(st.sampled_from((4, 8)))
    shape = (1, 8, 8, c)
    tensors = [g.add_input(shape)]
    for _ in range(draw(st.integers(2, 10))):
        kind = draw(st.sampled_from(("conv", "dw", "unary", "binary", "act")))
        src = tensors[draw(st.integers(0, len(tensors) - 1))]
        if kind == "conv":
            (y,) = g.add_op("conv2d", [src], [shape],
                            {"kernel_h": 3, "kernel_w": 3, "stride": 1,
                             "groups": 1, "act": None, "padding": "SAME"})
        elif kind == "dw":
            (y,) = g.add_op("dwconv2d", [src], [shape],
                            {"kernel_h": 3, "kernel_w": 3, "stride": 1,
                             "act": None, "padding": "SAME"})
        elif kind == "unary":
            (y,) = g.add_op("elementwise", [src], [shape],
                            {"ew_kind": draw(st.sampled_from(_EW_UNARY))})
        elif kind == "binary":
            rhs = tensors[draw(st.integers(0, len(tensors) - 1))]
            (y,) = g.add_op("elementwise", [src, rhs], [shape],
                            {"ew_kind": draw(st.sampled_from(_EW_BINARY))})
        else:
            (y,) = g.add_op("activation", [src], [shape],
                            {"act": draw(st.sampled_from(("relu", "sigmoid")))})
        tensors.append(y)
    consumed = {t for n in g.nodes for t in n.inputs}
    for t in tensors[1:]:
        if t not in consumed:
            g.mark_output(t)
    return g


@given(g=wild_graphs())
def test_fused_latency_at_most_sum_of_parts(g):
    h100 = get_device("h100")
    before = cm.graph_cost(g, h100)
    _, fused = fuse_graph(g)
    after = cm.graph_cost(fused, h100)
    assert after["latency_s"] <= before["latency_s"] * (1 + 1e-12) + 1e-15
