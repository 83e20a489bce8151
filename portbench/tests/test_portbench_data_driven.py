"""A configuration, a traffic mix, a cell and a per-layer metric are added
as new files, and the harness finds them by name without an edit."""
import json
import shutil

from portbench import core


def test_new_files_are_found_by_name(tmp_path):
    root = tmp_path / "portbench"
    shutil.copytree(core.ROOT, root, ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in root.rglob("*") if p.is_file()}

    cfg = core.load_json("configs", "granite-moe-1b-a400m", root)
    cfg["name"] = "granite-moe-1b-a400m-e64"
    cfg["arch"] = dict(cfg["arch"], num_experts=64)
    (root / "configs" / "granite-moe-1b-a400m-e64.json").write_text(json.dumps(cfg))
    mix = dict(core.load_json("traffic", "lm.4x4096", root), batch=8, seq=1024)
    (root / "traffic" / "lm.8x1024.json").write_text(json.dumps(mix))
    cell = dict(core.load_json("workloads", "granite-moe-1b.train.4x4096", root),
                config="granite-moe-1b-a400m-e64", traffic="lm.8x1024")
    (root / "workloads" / "granite-moe-e64.train.8x1024.json").write_text(json.dumps(cell))
    (root / "metrics" / "extra").mkdir()
    (root / "metrics" / "extra" / "window_tokens.py").write_text(
        'UNIT = "tokens"\n\n\ndef read(ctx):\n    mix = ctx.cell.traffic\n'
        '    return ctx.window_steps * mix["batch"] * mix["seq"]\n')

    for path, data in before.items():
        assert path.read_bytes() == data
    loaded = core.load_cell("granite-moe-e64.train.8x1024", root)
    assert loaded.config["arch"]["num_experts"] == 64
    assert loaded.traffic["batch"] == 8
    assert core.module("drivers", loaded.driver).run
    readers = core.metric_readers(root)
    assert readers["extra.window_tokens"].UNIT == "tokens"
    assert set(core.metric_readers()) < set(readers)
    ctx = core.Context(loaded, 2, 1.0, [], None, core.peaks(root))
    assert core.read_metrics(ctx, readers)["extra.window_tokens"] == {
        "value": 16384, "unit": "tokens"}
