"""The work counts against numbers worked by hand at small shapes, and the
roofline and idle arithmetic on a made-up trace."""
import math

import pytest

from portbench import core
from portbench.counts import flash, gmm, moe, ssd_scan, ssm
from portbench.roofline import share_pct

MOE = dict(d_model=4, num_heads=2, num_kv_heads=1, head_dim=2, num_experts=4, top_k=2,
           d_ff=3, vocab_size=10, num_layers=1, compute_dtype="bfloat16")
SSM = dict(d_model=4, ssm_expand=2, ssm_head_dim=4, ssm_state=2, ssm_conv_width=2,
           ssm_chunk=2, vocab_size=10, num_layers=1)


def test_moe_step_flops_by_hand():
    # q, k, v, o 32 each... (2·4·4 + 2·2·4·2 + 2·4·4 = 96), router 32,
    # experts 2·3·2·4·3 = 144, head 2·4·10 = 80: 352 a token; 6 kept
    # pairs × 4·2·2 = 96 for attention; 3·352 + 96 = 1152 forward.
    assert moe.forward_flops(MOE, 1, 3) == 1152
    assert moe.step_flops(MOE, 2, 3) == 3 * 2 * 1152


def test_granite_step_near_the_issues_count():
    arch = core.load_json("configs", "granite-moe-1b-a400m")["arch"]
    assert 5.1e13 < moe.step_flops(arch, 4, 4096) < 5.3e13


def test_ssm_step_flops_by_hand():
    # in_proj 2·4·22 = 176, out_proj 64, conv 2·2·12 = 48, state share and
    # read 32 + 32: 352 a token; a chunk of 2 keeps 3 pairs × (4 + 16) plus
    # the recurrence's 32: 92; 4·352 + 2·92 = 1592, head 4·80 = 320.
    assert ssm.forward_flops(SSM, 1, 4) == 1912
    assert ssm.step_flops(SSM, 1, 4) == 3 * 1912


def test_gmm_work():
    assert gmm.work(gmm.OPS[0], [[2, 3, 4], [2, 4, 5]], MOE) == (240.0, 188.0)


def test_flash_work():
    assert flash.kept_pairs(3, 3) == 6
    assert flash.kept_pairs(2, 4) == 7
    shapes = [[1, 3, 2, 4], [1, 3, 1, 4], [1, 3, 1, 4]]
    assert flash.work(flash.OPS[0], shapes, MOE) == (192.0, 168.0)
    assert flash.work(flash.OPS[1], shapes + [[1, 3, 2, 4]] * 2, MOE) == (480.0, 312.0)
    with pytest.raises(ValueError):
        flash.work(flash.OPS[0], shapes, dict(MOE, sliding_window=2))


def test_ssd_scan_work():
    assert ssd_scan.work(ssd_scan.OPS[0], [[3, 1, 2, 2, 2], [3, 1, 2]], SSM) == (48.0, 240.0)
    x = [3, 1, 2, 2, 2]
    assert ssd_scan.work(ssd_scan.OPS[1], [x, [], x, [3, 1, 2]], SSM) == (96.0, 264.0)
    assert ssd_scan.work(ssd_scan.OPS[1], [x, [1, 2, 2, 2], x, [3, 1, 2]], SSM) == (96.0, 296.0)


def _ctx(trace, arch=MOE):
    cell = core.Cell("c", {}, {"arch": arch}, {"batch": 1, "seq": 3})
    return core.Context(cell, 1, 1.0, [], trace, core.peaks())


def test_roofline_share_is_least_time_over_device_time():
    pk = core.peaks()
    tr = core.Trace(window_s=1.0, steps=1, ops=[
        core.OpCall(gmm.OPS[0], [[2, 3, 4], [2, 4, 5]], 10.0),
        core.OpCall(gmm.OPS[0], [[2, 3, 4], [2, 4, 5]], 30.0),
        core.OpCall("aten::mm", [[2, 2], [2, 2]], 99.0)])
    least = 2 * max(240.0 / pk["bf16_flops_per_s"], 188.0 / pk["hbm_bytes_per_s"])
    assert share_pct(_ctx(tr), "gmm") == pytest.approx(100 * least / 40e-6)
    assert share_pct(_ctx(tr), "flash") is None
    assert share_pct(_ctx(None), "gmm") is None


def test_busy_is_the_union_and_idle_reads_it():
    tr = core.Trace(window_s=1e-4, steps=1,
                    device=[("a", 0.0, 30.0), ("b", 20.0, 40.0), ("c", 60.0, 70.0)],
                    host=[("portbench.step", 0.0, 100.0), ("aten::x", 41.0, 59.0)])
    assert tr.busy_s() == pytest.approx(50e-6)
    reader = core.metric_readers()["device.idle_pct"]
    ctx = _ctx(tr)
    assert reader.read(ctx) is None
    ctx.step_ms = [0.2, 0.1, 0.08]
    assert reader.read(ctx) == pytest.approx(50.0)
    bd = tr.breakdown()
    assert bd["device_ops"][0] == ["a", pytest.approx(30e-6)]
    assert bd["idle_gaps"] == [["aten::x", pytest.approx(20e-6)]]


def test_mfu_reader():
    arch = dict(MOE, family="moe")
    ctx = _ctx(None, arch)
    ctx.window_steps, ctx.window_s = 4, 2.0
    want = 100 * moe.step_flops(arch, 1, 3) * 4 / 2.0 / core.peaks()["bf16_flops_per_s"]
    assert core.metric_readers()["step.mfu"].read(ctx) == pytest.approx(want)
    assert math.isfinite(want)
