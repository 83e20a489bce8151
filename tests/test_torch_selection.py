"""Port kernel selection (repro_torch.core.selection) held against the
reference (repro.core.selection): the same Alg. C.2 rules over the same
graphs give the same op types, for every device profile.  Graph
construction only — nothing runs."""
import dataclasses

import pytest

from repro.core import selection as rsel
from repro.core.dataset import synthetic_graphs as ref_graphs
from repro.core.ir import OpGraph as RefGraph

from repro_torch.core import selection as psel
from repro_torch.core.dataset import synthetic_graphs
from repro_torch.core.ir import OpGraph


@pytest.fixture(scope="module")
def main_path_graphs():
    return ref_graphs(40, resolution=224), synthetic_graphs(40, resolution=224)


@pytest.mark.parametrize("device", sorted(rsel.DEVICE_PROFILES))
def test_apply_selection_matches_reference(main_path_graphs, device):
    refs, ports = main_path_graphs
    for rg, pg in zip(refs, ports):
        want = rsel.apply_selection(rg, rsel.get_device(device))
        got = psel.apply_selection(pg, psel.get_device(device))
        assert got.name == want.name
        assert [n.op_type for n in got.nodes] == [n.op_type for n in want.nodes]
        assert got.fingerprint() == want.fingerprint()


@pytest.mark.parametrize("device", sorted(rsel.DEVICE_PROFILES))
def test_device_profiles_are_copied_as_data(device):
    assert dataclasses.asdict(psel.get_device(device)) == \
        dataclasses.asdict(rsel.get_device(device))


def test_mali_selects_one_winograd_op_on_the_main_path(main_path_graphs):
    _, ports = main_path_graphs
    mali = psel.get_device("mali_g76")
    picked = []
    for g in ports:
        sel = psel.apply_selection(g, mali)
        for node in sel.nodes:
            if node.op_type == "winograd_conv2d":
                picked.append((sel.tensor(node.inputs[0]).shape,
                               sel.tensor(node.outputs[0]).shape[-1]))
    assert picked == [((1, 56, 56, 79), 77)]


def _conv(in_c, out_c, hw, k=3, stride=1, groups=1):
    g = RefGraph("c")
    x = g.add_input((1, hw, hw, in_c))
    (y,) = g.add_op("conv2d", [x], [(1, hw // stride, hw // stride, out_c)],
                    {"kernel_h": k, "kernel_w": k, "stride": stride,
                     "groups": groups})
    g.mark_output(y)
    return g, OpGraph.from_json(g.to_json())


@pytest.mark.parametrize("shape", [(64, 64, 56), (128, 128, 28), (256, 256, 14),
                                   (79, 77, 56), (64, 64, 56, 5), (64, 64, 56, 3, 2),
                                   (64, 64, 28, 3, 1, 4), (128, 128, 64),
                                   (32, 32, 64)])
@pytest.mark.parametrize("device", sorted(rsel.DEVICE_PROFILES))
def test_rules_agree_on_study_shapes(shape, device):
    rg, pg = _conv(*shape)
    rd, pd = rsel.get_device(device), psel.get_device(device)
    assert psel.check_winograd(pd, pg.nodes[0], pg) == \
        rsel.check_winograd(rd, rg.nodes[0], rg)
    assert psel.check_grouped_conv2d(pd, pg.nodes[0], pg) == \
        rsel.check_grouped_conv2d(rd, rg.nodes[0], rg)
    assert psel.select_conv_kernel(pd, pg.nodes[0], pg) == \
        rsel.select_conv_kernel(rd, rg.nodes[0], rg)
    assert psel.selection_summary(pg, pd) == rsel.selection_summary(rg, rd)
