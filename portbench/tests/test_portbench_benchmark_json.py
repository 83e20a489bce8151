"""BENCHMARK.json keeps to the benchmark's contract where a test can see
it: names and units of the allowed characters, every file it names under
the benchmark's folder, every per-layer metric read by a reader of the
same unit and moving an end-to-end metric its cells report."""
import json
import re

import pytest

from portbench import core

BENCH = json.loads((core.REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
E2E = {"train_tokens_per_s", "peak_mem_gib", "setup_s"}
NUMBERS = {"loss_gap", "grad_norm_gap", "grad_norm_gap_median", "change_gap"}


def _line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level():
    assert set(BENCH) == KEYS
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    cells = len(BENCH["workloads"])
    # A full check of 24 cells fits the driver's 43,200 s.
    assert (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert 1 <= cells <= 24 and len(json.dumps(BENCH)) <= 64 * 1024


def test_names_units_and_lines():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in BENCH[group]]
        assert len(names) == len(set(names)), group
        for e in BENCH[group]:
            assert NAME.match(e["name"]), e["name"]
            if "unit" in e:
                assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
            for key in ("why", "layer", "source"):
                if key in e:
                    assert _line(e[key]), (e["name"], key)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
        assert c["file"] == f"portbench/configs/{c['name']}.json"
        assert core.load_json("configs", c["name"])["reduced"] == c["reduced"]


def test_cells_match_their_files():
    configs = {c["name"] for c in BENCH["configs"]}
    pairs = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        spec = core.load_json("workloads", w["name"])
        assert {k: spec[k] for k in ("config", "traffic", "chips", "why")} == \
            {k: w[k] for k in ("config", "traffic", "chips", "why")}
        assert w["config"] in configs and w["chips"] == 1
        core.load_json("traffic", w["traffic"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        limits = spec["limits"]
        assert limits and set(limits) <= NUMBERS
        assert all(0 < v < 1 for v in limits.values()), limits
    assert configs == {w["config"] for w in BENCH["workloads"]}


def test_end_to_end_metrics():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert set(e2e) == E2E
    for m in e2e.values():
        assert set(m) == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert e2e["setup_s"]["bound"] <= 0.25


@pytest.mark.parametrize("metric", BENCH["per_layer"], ids=lambda m: m["name"])
def test_per_layer_metrics(metric):
    readers = core.metric_readers()
    cells = {w["name"] for w in BENCH["workloads"]}
    assert set(metric) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
    assert metric["moves"] in E2E - {"setup_s", "peak_mem_gib"}
    assert set(metric["workloads"]) <= cells and metric["workloads"]
    assert readers[metric["name"]].UNIT == metric["unit"]
    if "roofline" in metric["name"]:
        assert metric["name"].endswith("_roofline") and metric["unit"] == "%"


def test_every_reader_is_a_listed_metric():
    assert set(core.metric_readers()) == {m["name"] for m in BENCH["per_layer"]}


def test_every_cell_reports_a_per_layer_metric():
    for w in BENCH["workloads"]:
        assert any(w["name"] in m["workloads"] for m in BENCH["per_layer"])
