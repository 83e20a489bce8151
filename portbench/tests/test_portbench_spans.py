"""The readers of the program's spans: None where a run has no such span,
the right value on a hand-made trace and span export, and every new
metric of its family printed by a traced run of a tiny cell on the CPU
(device times there are the CPU profiler's zeros and there are no device
intervals, so `trainstep.backward_ms` has nothing to read: the test reads
names, the host's time and the counters)."""
import time

import pytest
import torch

from portbench import core, spans
from portbench.drivers import train
from portbench.tests._tiny import tiny_cell

NEW = {"trainstep.forward_ms", "trainstep.optimizer_ms", "trainstep.backward_ms",
       "trainstep.host_ms", "head.loss_ms", "moe.dispatch_ms", "moe.fill_pct",
       "ssm.intra_ms"}
FAMILY = {"moe": NEW - {"ssm.intra_ms"}, "ssm": NEW - {"moe.dispatch_ms", "moe.fill_pct"}}


def _ctx(trace):
    return core.Context(tiny_cell("moe"), 2, 1.0, [], trace, core.peaks())


def _op(name, device_us):
    return core.OpCall(name, [], device_us)


def _hand_made():
    """Two profiled steps (µs on the profiler's clock): device busy 0–900
    and 1,000–1,800, each step's spans with their kernels' device time."""
    tr = core.Trace(window_s=0.002, steps=2)
    tr.device = [("k", 0.0, 900.0), ("k", 1000.0, 1800.0), ("k", 1100.0, 1200.0)]
    for _ in range(2):
        tr.ops += [_op("train.forward", 300.0), _op("train.optimizer", 100.0),
                   _op("lm.head", 20.0), _op("lm.head.bwd", 30.0),
                   _op("moe.route", 5.0), _op("moe.dispatch", 7.0),
                   _op("moe.combine", 8.0), _op("moe.dispatch.bwd", 9.0),
                   _op("moe.combine.bwd", 11.0), _op("ssm.intra", 40.0),
                   _op("ssm.intra.bwd", 60.0), _op("aten::mm", 1e6)]
    tr.host = [("train.step", 0.0, 700.0), ("train.sync", 500.0, 600.0),
               ("train.step", 1000.0, 1500.0), ("train.sync", 1200.0, 1300.0),
               ("portbench.step", 0.0, 2000.0)]
    return tr


def _span(name, tid, **attrs):
    return {"name": name, "tid": tid, "attrs": attrs}


# An earlier traced step (t0) and the two profiled ones (t1, t2).
EXPORT = [
    _span("train.step", "t0"), _span("moe.route", "t0", rows=100, filled=1),
    _span("moe.route", "t1", rows=100, filled=70, dropped=3, displaced=1),
    _span("moe.dispatch", "t1"), _span("train.step", "t1"),
    _span("moe.route", "t2", rows=300, filled=250, dropped=9, displaced=2),
    _span("train.step", "t2"),
]

WANT = {
    "trainstep.forward_ms": 0.3,
    "trainstep.optimizer_ms": 0.1,
    "trainstep.backward_ms": 0.85 - 0.3 - 0.1,
    "trainstep.host_ms": (700 + 500 - 200) / 2 / 1e3,
    "head.loss_ms": 0.05,
    "moe.dispatch_ms": 0.04,
    "moe.fill_pct": 100.0 * 320 / 400,
    "ssm.intra_ms": 0.1,
}


@pytest.mark.parametrize("metric", sorted(NEW))
def test_a_run_without_spans_reads_none(metric, monkeypatch):
    monkeypatch.setattr(spans, "program_spans", lambda: [])
    reader = core.metric_readers()[metric]
    plain = core.Trace(window_s=0.002, steps=2, device=[("k", 0.0, 900.0)],
                       ops=[_op("aten::mm", 900.0)],
                       host=[("portbench.step", 0.0, 1000.0)])
    assert reader.read(_ctx(None)) is None
    assert reader.read(_ctx(plain)) is None


@pytest.mark.parametrize("metric", sorted(NEW))
def test_a_hand_made_trace_reads_its_value(metric, monkeypatch):
    monkeypatch.setattr(spans, "program_spans", lambda: EXPORT)
    got = core.metric_readers()[metric].read(_ctx(_hand_made()))
    assert got == pytest.approx(WANT[metric], rel=1e-12)


def test_without_the_programs_tracer_the_export_is_none(monkeypatch):
    from repro_torch import obs

    monkeypatch.delattr(obs, "default")
    assert spans.program_spans() is None


@pytest.mark.parametrize("family", ["moe", "ssm"])
def test_a_traced_run_prints_its_familys_new_metrics(family):
    from repro_torch import obs

    before = len(obs.default().tracer.export())
    result, _ = train.run(tiny_cell(family), 2 ** 31 + 77, 0.2, True, torch.device("cpu"),
                          time.perf_counter())
    metrics = result["metrics"]
    want = FAMILY[family] - {"trainstep.backward_ms"}
    assert want == NEW & set(metrics)
    assert all(metrics[m]["unit"] == core.metric_readers()[m].UNIT for m in want)
    assert metrics["trainstep.host_ms"]["value"] > 0
    if family == "moe":
        assert 0 < metrics["moe.fill_pct"]["value"] <= 100
    names = {s["name"] for s in obs.default().tracer.export()[before:]}
    assert {"train.step", "train.forward", "train.backward", "train.optimizer",
            "train.sync", "lm.head", "lm.head.bwd"} <= names
    assert not any(n.startswith(("portbench.", "repro_torch::")) for n in names)
