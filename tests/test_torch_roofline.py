"""The port's analytic step-cost model (`repro_torch.launch.roofline`)
against the reference's (``benchmarks/roofline.py``, loaded read-only
from its file), and the predictor twin ``examples/torch/predict_tpu_step.py``.

Tolerances: none.  The port's copy keeps the reference's float
expressions in their order, so every key of its dict is held with ``==``
over every arch × shape × mesh × microbatches × fsdp; the twin's printed
steps are held to the largest of the three terms of the same dict at the
card's rates, formatted as the twin formats them.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import itertools
import re
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

from repro.configs import ARCHS as RARCHS  # noqa: E402
from repro_torch.configs import ARCHS, INPUT_SHAPES, get_arch  # noqa: E402
from repro_torch.core.selection import DEVICE_PROFILES  # noqa: E402
from repro_torch.launch import roofline  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
MESHES = [{"data": 16, "model": 16}, {"data": 1, "model": 1}, {"data": 2, "model": 8}]
MICROBATCHES = (1, 16)
FSDP = (None, True, False)
LINE = re.compile(r"^  (\S+)\s+step ≈\s+([\d.]+) ms  \[(\w+)-bound\]  ≈ ([\d,]+) tok/s$")


def _load(name: str, path: Path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def reference():
    """``benchmarks/roofline.py`` as a module of its own (not run)."""
    return _load("reference_roofline", ROOT / "benchmarks" / "roofline.py")


def _grid():
    return itertools.product(INPUT_SHAPES, MESHES, MICROBATCHES, FSDP)


def test_the_archs_are_the_references():
    assert sorted(ARCHS) == sorted(RARCHS)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_analytic_costs_bit_equal_to_the_reference(reference, arch):
    for shape, mesh, mb, fsdp in _grid():
        want = reference.analytic_costs(arch, shape, mesh, microbatches=mb, fsdp=fsdp)
        got = roofline.analytic_costs(arch, shape, mesh, microbatches=mb, fsdp=fsdp)
        assert got.keys() == want.keys()
        for key in want:
            assert got[key] == want[key], (arch, shape, mesh, mb, fsdp, key)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_step_costs_of_a_depth_cut(reference, monkeypatch, arch):
    """`step_costs` on the config itself equals `analytic_costs` at full
    depth; on the config cut to half its layers it equals the reference's
    `analytic_costs` with its `get_arch` handing out the same cut."""
    full = get_arch(arch)
    cut = dataclasses.replace(full, num_layers=max(1, full.num_layers // 2))
    rcut = dataclasses.replace(RARCHS[arch], num_layers=cut.num_layers)
    monkeypatch.setattr(reference, "get_arch", lambda name: rcut)
    for shape, mesh, mb, fsdp in _grid():
        kw = dict(microbatches=mb, fsdp=fsdp)
        assert roofline.step_costs(full, INPUT_SHAPES[shape], mesh, **kw) == \
            roofline.analytic_costs(arch, shape, mesh, **kw)
        assert roofline.step_costs(cut, INPUT_SHAPES[shape], mesh, **kw) == \
            reference.analytic_costs(arch, shape, mesh, **kw)


def test_the_cards_rates():
    h100 = DEVICE_PROFILES["h100"]
    assert (roofline.PEAK_FLOPS, roofline.HBM_BW) == (h100.peak_flops, h100.hbm_bw)
    assert roofline.LINK_BW == 50e9
    assert h100.link_bw == 0.0          # the transfer descriptors' input stays unset


def test_step_terms_takes_the_largest():
    costs = {"ana_flops_dev": 2 * roofline.PEAK_FLOPS, "ana_bytes_dev": roofline.HBM_BW,
             "ana_coll_dev": 3 * roofline.LINK_BW}
    terms, dominant, step = roofline.step_terms(costs)
    assert terms == {"compute": 2.0, "memory": 1.0, "collective": 3.0}
    assert (dominant, step) == ("collective", 3.0)


@pytest.mark.parametrize("arch", ["qwen2-72b", "granite-moe-1b-a400m"])
def test_twin_prints_the_largest_term(monkeypatch, capsys, arch):
    """Each step line of the twin is the largest term of
    `analytic_costs` on the (16, 16) mesh at the card's rates, with its
    dominant term and tokens/s; its shapes and skips are the reference
    example's, in its order."""
    mesh = {"data": 16, "model": 16}
    _load("torch_predict_tpu_step", ROOT / "examples" / "torch" /
          "predict_tpu_step.py").main(["--arch", arch])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == f"{arch} on an H100 {mesh} mesh (256 cards):"
    steps = 0
    for line in lines[1:]:
        m = LINE.match(line)
        if m is None:
            assert " skipped: " in line, line
            continue
        shape, ms, dominant, tput = m.groups()
        ana = roofline.analytic_costs(arch, shape, mesh)
        terms, dom, step = roofline.step_terms(ana)
        assert step == max(terms.values())
        assert (ms, dominant, tput) == (f"{1e3 * step:.2f}", dom, f"{ana['tokens'] / step:,.0f}")
        steps += 1
    assert steps == 3 and lines[-1].startswith("  long_500k    skipped: ")

    monkeypatch.setattr(sys, "argv", ["predict_tpu_step.py", "--arch", arch])
    monkeypatch.setattr(sys, "path", list(sys.path))   # it puts the repo first
    _load("reference_predict_tpu_step", ROOT / "examples" / "predict_tpu_step.py").main()
    ref = capsys.readouterr().out.splitlines()
    assert [ln.split()[0] for ln in ref[1:]] == [ln.split()[0] for ln in lines[1:]]
    assert [ln for ln in ref if "skipped" in ln] == [ln for ln in lines if "skipped" in ln]
