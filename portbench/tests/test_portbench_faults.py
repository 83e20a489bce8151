"""`correct` comes out false when the timed path is broken underneath, and
for the control: the run is driven on the CPU (the harness's look for a
card skipped) with a fault planted under the port's step (`faults.py`),
or the reference in float8 put in the program's place, and held to the
cell's own limits."""
import time

import pytest
import torch

from portbench.drivers import train
from portbench.faults import FAULTS
from portbench.tests._tiny import tiny_cell

CPU = torch.device("cpu")
SEED = 2 ** 31 + 4242

# The control's test runs at sizes chosen so that its float8 products show
# on the CPU (at the smallest test sizes their error is below the limits
# set on the card), on seeds of one rule for both families: SEED + 101·i.
# At these sizes the MoE control separates on 7 of the rule's first 8
# seeds (i = 3 does not); the SSM control on all 8.  The test takes the
# first three.  What shows the control separating at each cell's own size
# is the reading on the card (PERF.md §2: `calibrate.py`, 6 seeds a cell).
CONTROL = {
    "moe": dict(num_layers=4, d_model=256, num_heads=4, num_kv_heads=2, head_dim=64,
                d_ff=128, vocab_size=1024, num_experts=8, top_k=2),
    "ssm": dict(num_layers=8, d_model=256, vocab_size=1024, ssm_state=64, ssm_head_dim=64,
                ssm_chunk=64),
}


def _run(cell, wrap=None):
    return train.run(cell, SEED, 0.2, False, CPU, time.perf_counter(), wrap=wrap)


@pytest.mark.parametrize("family", ["moe", "ssm"])
def test_a_sound_run_is_correct(family):
    result, checks = _run(tiny_cell(family))
    assert result["correct"], checks
    assert result["attempted"] >= 1 and result["failed"] == 0


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("family", ["moe", "ssm"])
def test_a_planted_fault_makes_the_run_incorrect(family, fault):
    result, checks = _run(tiny_cell(family), FAULTS[fault])
    assert not result["correct"], checks


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("family", ["moe", "ssm"])
def test_the_float8_control_is_incorrect(family, seed):
    cell = tiny_cell(family)
    cell.config = dict(cell.config, arch=dict(cell.config["arch"], **CONTROL[family]))
    cell.traffic = dict(cell.traffic, seq=128)
    ref = train.reference_readings(cell, SEED + 101 * seed, CPU)
    control = train.reference_readings(cell, SEED + 101 * seed, CPU, "fp8")
    checks = train.compare(control, ref, cell.spec["limits"])
    assert any(c["value"] > c["limit"] for c in checks.values()), checks
