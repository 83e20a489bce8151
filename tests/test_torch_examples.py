"""The port's examples (``examples/torch``), twins of ``examples/*.py``:
each runs its ``main`` at its smallest sizes with ``--device cpu`` in a
subprocess (stores and checkpoints under ``tmp_path``), exits 0 and
prints the reference's lines for each of its steps.  Two differ:
``predict_tpu_step`` allocates nothing and takes no ``--device``, and
``nas_latency_search`` runs in this process with its `ProfileSession`
bound to the seeded `CostModelProfileSession`, so its budget and fronts
follow no host timing and a second run prints the same lines.  They
import nothing of the reference (``tests/test_torch_isolation.py``)."""
from __future__ import annotations

import importlib.util
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]

# name → (arguments after --device cpu, lines the run must print)
CASES = {
    "quickstart": (["--graphs", "10", "--resolution", "16", "--store", "{tmp}/qs.jsonl"],
                   ["== 1-3. profile 10 synthetic NAS archs", "store: {",
                    "end-to-end latency MAPE on unseen archs:",
                    "repeat query served from cache: True",
                    "kernel mix after selection:"]),
    "nas_latency_search": (["--graphs", "6", "--generations", "2",
                            "--store", "{tmp}/nas.jsonl"],
                           ["latency budget:", "front MAPE vs measurement:",
                            "registered 'edge2' bank from 32 measurements",
                            "one per device per generation"]),
    "predict_tpu_step": ([], ["qwen2-72b on an H100", "mesh (256 cards):",
                              "train_4k     step ≈", "prefill_32k  step ≈",
                              "decode_32k   step ≈", "long_500k    skipped:"]),
    "transfer_new_device": (["--graphs", "7", "--store", "{tmp}/src.jsonl"],
                            ["source store:", "oracle (full target profile",
                             "LatencyService now serves", "compacted "]),
    "random_wired_search": (["--smoke"], ["widest fan-out in population",
                                          "random-wired smoke: OK"]),
    "autopilot_recalibration": ([], ["== 5. the audit log", "autopilot smoke: OK"]),
    "serve_latency": (["--clients", "4"], ["listening on 127.0.0.1:",
                                           "predicted decode step:", "done."]),
    "serve_lm": (["--requests", "3"], ["completed 3 requests / 36 tokens"]),
    "train_lm": (["--steps", "25", "--width", "64", "--ckpt-dir", "{tmp}/ckpt"],
                 ["model: qwen2-100m", "step   25  loss", "final loss"]),
}


# Examples that allocate nothing and take no --device.
NO_DEVICE = {"predict_tpu_step"}
# The one number of the NAS twin's output that is a host timing: the
# searches' wall time.
WALL_TIME = re.compile(r"\(\d+\.\d+s\)")


def _example(name: str):
    spec = importlib.util.spec_from_file_location(
        f"torch_example_{name}", ROOT / "examples" / "torch" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _nas_on_the_cost_model(argv, monkeypatch, capsys) -> str:
    """The NAS twin's ``main`` in this process, its `ProfileSession` the
    seeded `CostModelProfileSession` (on the host by construction, so the
    example's ``device`` keyword is dropped); returns what it printed."""
    from repro_torch.transfer import CostModelProfileSession

    mod = _example("nas_latency_search")

    def session(*, device, **kw):
        assert device == "cpu"
        return CostModelProfileSession(**kw)

    monkeypatch.setattr(mod, "ProfileSession", session)
    capsys.readouterr()
    mod.main(["--device", "cpu", *argv])
    return capsys.readouterr().out


@pytest.mark.parametrize("name", sorted(CASES))
def test_example_twin_runs_on_the_host(name, tmp_path, monkeypatch, capsys):
    args, lines = CASES[name]
    if name == "nas_latency_search":
        outs = []
        for run in ("a", "b"):
            (tmp_path / run).mkdir()
            outs.append(_nas_on_the_cost_model(
                [a.format(tmp=tmp_path / run) for a in args], monkeypatch, capsys))
        stdout = outs[0]
        assert WALL_TIME.sub("(…s)", outs[0]) == WALL_TIME.sub("(…s)", outs[1]), outs
    else:
        env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
        env.update(PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
        device = [] if name in NO_DEVICE else ["--device", "cpu"]
        cmd = [sys.executable, str(ROOT / "examples" / "torch" / f"{name}.py"),
               *device, *(a.format(tmp=tmp_path) for a in args)]
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300, env=env,
                              cwd=tmp_path)
        assert proc.returncode == 0, proc.stderr[-3000:]
        stdout = proc.stdout
    for line in lines:
        assert line in stdout, (line, stdout[-2000:])


def test_train_lm_twin_resumes_from_its_checkpoint(tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env.update(PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    cmd = [sys.executable, str(ROOT / "examples" / "torch" / "train_lm.py"),
           "--device", "cpu", "--width", "64", "--ckpt-dir", str(tmp_path / "ckpt")]
    first = subprocess.run(cmd + ["--steps", "2"], capture_output=True, text=True,
                           timeout=300, env=env)
    again = subprocess.run(cmd + ["--steps", "3"], capture_output=True, text=True,
                           timeout=300, env=env)
    assert first.returncode == 0 and again.returncode == 0, again.stderr[-3000:]
    assert "resumed from step 2" in again.stdout
