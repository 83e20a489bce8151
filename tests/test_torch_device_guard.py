"""Every launch of the port's kernels runs on its operands' card.

A launch runs on the calling thread's current card, whatever stream it is
handed, and the shared-memory opt-ins are granted per card.  So each C
entry point in ``src/repro_torch/kernels/csrc/*.cu`` takes the card's
index just before its stream and makes it current first
(``host_launch::DeviceGuard``, ``csrc/host_launch.cuh``), and each ctypes
launch in ``kernels/*_cuda.py`` (a call ``lib.<kernel>_launch(...)``)
passes ``<t>.get_device()`` there, ``<t>`` a tensor whose ``data_ptr()``
it passes, with as many arguments as its ``argtypes`` declare and the C
function takes.  Checked on the sources, so it runs on the host;
`tests/test_torch_cuda_kernels.py` launches each wrapper from a new thread
on the card.
"""
import ast
import re
from pathlib import Path

import pytest

KERNELS = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "kernels"
WRAPPERS = sorted(KERNELS.glob("*_cuda.py"))
# Launch entry points per wrapper module (tree_gather has two kernels;
# flash_attention the forward and, from its second library, the backward;
# ssd_scan and ssd_intra the forward and the backward).
EXPECTED = {"tree_gather_cuda.py": 2, "int8_matmul_cuda.py": 1,
            "winograd_conv_cuda.py": 1, "flash_attention_cuda.py": 2,
            "moe_gmm_cuda.py": 1, "ssd_scan_cuda.py": 2, "ssd_intra_cuda.py": 2}
GUARD = "const host_launch::DeviceGuard guard(device);"


def _pointer_args(call: ast.Call) -> set:
    """Names ``t`` whose ``t.data_ptr()`` the call passes."""
    return {n.func.value.id for n in ast.walk(call)
            if isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)
            and n.func.attr == "data_ptr" and isinstance(n.func.value, ast.Name)}


def _device_of(arg: ast.expr):
    """``t`` for the argument ``t.get_device()``, else None."""
    if isinstance(arg, ast.Call) and not arg.args and isinstance(arg.func, ast.Attribute) \
            and arg.func.attr == "get_device" and isinstance(arg.func.value, ast.Name):
        return arg.func.value.id
    return None


def launches(source: str):
    """(launch name, arguments, passes its operand's card second to last)
    for each ``lib.*_launch(...)`` call in ``source``."""
    out = []
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute) \
                and node.func.attr.endswith("_launch") \
                and isinstance(node.func.value, ast.Name) and node.func.value.id == "lib":
            card = _device_of(node.args[-2]) if len(node.args) >= 2 else None
            out.append((node.func.attr, len(node.args),
                        card is not None and card in _pointer_args(node)))
    return out


def declared_arity(source: str) -> dict:
    """Launch name → number of ``argtypes`` its ``_declare`` sets."""
    out = {}
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.List):
            target = node.targets[0]
            if isinstance(target, ast.Attribute) and target.attr == "argtypes" \
                    and isinstance(target.value, ast.Attribute):
                out[target.value.attr] = len(node.value.elts)
    return out


def c_entry_points(source: str) -> dict:
    """C launch name → (parameter names, first statement of the body)."""
    out = {}
    for m in re.finditer(r'extern "C" int (\w+_launch)\(([^)]*)\)\s*\{\s*([^;]*;)', source):
        params = [p.split()[-1].lstrip("*") for p in m.group(2).split(",")]
        out[m.group(1)] = (params, " ".join(m.group(3).split()))
    return out


@pytest.mark.parametrize("path", WRAPPERS, ids=lambda p: p.name)
def test_every_launch_passes_its_operands_card(path):
    found = launches(path.read_text())
    assert len(found) == EXPECTED[path.name]
    assert all(ok for _, _, ok in found), found


@pytest.mark.parametrize("path", WRAPPERS, ids=lambda p: p.name)
def test_launch_arguments_match_argtypes_and_the_c_entry_point(path):
    src = path.read_text()
    arity = declared_arity(src)
    c_src = "".join((KERNELS / "csrc" / name).read_text() for name in
                    re.findall(r'CudaLibrary\("\w+", \("(\w+\.cu)",\)', src))
    entries = c_entry_points(c_src)
    for name, n_args, _ in launches(src):
        params, first = entries[name]
        assert arity[name] == n_args == len(params), (name, arity[name], n_args, params)
        assert params[-2:] == ["device", "stream"]
        assert first == GUARD


def test_every_c_entry_point_is_guarded():
    sources = sorted((KERNELS / "csrc").glob("*.cu"))
    entries = {}
    for p in sources:
        entries.update(c_entry_points(p.read_text()))
    assert len(entries) == sum(EXPECTED.values())
    assert all(first == GUARD and params[-2:] == ["device", "stream"]
               for params, first in entries.values()), entries


def test_every_wrapper_module_is_checked():
    assert sorted(p.name for p in WRAPPERS) == sorted(EXPECTED)


@pytest.mark.parametrize("body,ok", [
    ("err = lib.k_launch(x.data_ptr(), out.data_ptr(), x.get_device(), s)\n", True),
    ("err = lib.k_launch(x.data_ptr(), s)\n", False),
    ("err = lib.k_launch(x.data_ptr(), y.get_device(), s)\n", False),
    ("err = lib.k_launch(x.data_ptr(), 0, s)\n", False),
    ("err = lib.k_launch(x.data_ptr(), x.get_device(), 7, s)\n", False),
])
def test_checker_tells_a_passed_card_from_none(body, ok):
    assert [found[2] for found in launches(body)] == [ok]
