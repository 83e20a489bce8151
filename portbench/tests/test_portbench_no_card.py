"""run.py refuses to measure without a card: it exits non-zero and prints
no result, here and in a directory that holds only BENCHMARK.json and
the benchmark's folder."""
import os
import shutil
import subprocess
import sys

import pytest

from portbench import core

ARGS = ["--workload", "granite-moe-1b.train.4x4096", "--seed", str(2 ** 31 + 5),
        "--seconds", "1", "--trace", "0"]


def _run(cwd):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, "portbench/run.py", *ARGS], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_without_a_card_it_exits_non_zero_and_prints_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this process sees a card")
    out = _run(core.REPO)
    assert out.returncode != 0
    assert "{" not in out.stdout


def test_the_benchmark_alone_is_not_enough(tmp_path):
    shutil.copytree(core.ROOT, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(core.REPO / "BENCHMARK.json", tmp_path)
    out = _run(tmp_path)
    assert out.returncode != 0
    assert "{" not in out.stdout
