"""The port's multi-worker model and straggler monitor against the
reference's (`core/distributed_model.py`, `distributed/straggler.py`).

Both are numpy copies of the reference, so every case runs on both
packages and the numbers are held bit for bit (``==`` on floats and
lists): `tests/test_infra.py::TestStragglerModel`'s five cases,
parametrized over the two packages so each still counts, then
`graph_latency_multiworker`, `speedup_curve`, `WeightedSplitPlanner` and
a `StragglerMonitor` update trace on seeded inputs.
"""
import numpy as np
import pytest

pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st  # noqa: E402

from repro.core import distributed_model as ref_dm  # noqa: E402
from repro.distributed import straggler as ref_st  # noqa: E402

from repro_torch.core import distributed_model as port_dm  # noqa: E402
from repro_torch.distributed import StragglerMonitor as PortMonitor  # noqa: E402
from repro_torch.distributed import straggler as port_st  # noqa: E402

PACKAGES = {"reference": (ref_dm, ref_st.StragglerMonitor),
            "port": (port_dm, PortMonitor)}


# -- tests/test_infra.py::TestStragglerModel on both packages ---------------------

@pytest.mark.parametrize("name", sorted(PACKAGES))
class TestStragglerModel:
    def test_equal_split_degrades_with_slow_worker(self, name):
        """Paper Fig. 2: medium+small slower than medium alone."""
        dm, _ = PACKAGES[name]
        fast = [dm.Worker("m", 1.0)]
        mixed = [dm.Worker("m", 1.0), dm.Worker("s", 0.4)]
        assert dm.equal_split_latency(1.0, mixed) > dm.equal_split_latency(1.0, fast)

    def test_weighted_split_never_worse_than_equal(self, name):
        dm, _ = PACKAGES[name]
        for speeds in ([1.0, 0.3], [1.0, 1.0, 0.1], [0.5, 0.7, 0.9]):
            ws = [dm.Worker(f"w{i}", s) for i, s in enumerate(speeds)]
            eq = dm.equal_split_latency(1.0, ws)
            wt, shares = dm.weighted_split_latency(1.0, ws)
            assert wt <= eq + 1e-12
            assert abs(sum(shares) - 1) < 1e-9

    def test_sublinear_speedup_curve(self, name):
        dm, _ = PACKAGES[name]
        ops = [("conv2d", 1.0), ("elementwise", 0.2)]  # ew not parallelizable
        curve = dm.speedup_curve(ops, [1, 2, 4], sync_overhead=0.01)
        assert curve[1] == pytest.approx(1.0)
        assert 1.0 < curve[2] < 2.0      # sublinear (Amdahl + sync)
        assert curve[2] < curve[4] < 4.0

    @given(st.lists(st.floats(0.1, 10.0), min_size=2, max_size=6))
    @settings(max_examples=30, deadline=None)
    def test_planner_shares_proportional_to_speed(self, name, times):
        dm, _ = PACKAGES[name]
        shares = dm.WeightedSplitPlanner().plan(times)
        assert abs(sum(shares) - 1) < 1e-9
        # faster (smaller time) → share at least as large (ties allowed)
        for i in range(len(times)):
            for j in range(len(times)):
                if times[i] < times[j]:
                    assert shares[i] >= shares[j] - 1e-12

    def test_monitor_detects_straggler_and_plans(self, name):
        _, monitor = PACKAGES[name]
        m = monitor(n_groups=4)
        m.update([1.0, 1.0, 1.0, 2.0])
        assert m.degraded_groups() == [3]
        plan = m.microbatch_plan(16)
        assert sum(plan) == 16
        assert plan[3] < plan[0]
        assert m.predicted_speedup(16) > 1.0


# -- bit-equality on seeded inputs --------------------------------------------------

OP_TYPES = ("conv2d", "dwconv2d", "fully_connected", "elementwise", "pool_max",
            "concat", "matmul", "activation")


def _ops(seed, n=40):
    rng = np.random.default_rng(seed)
    types = rng.choice(OP_TYPES, size=n)
    lats = rng.lognormal(-9.0, 1.0, size=n)
    return [(str(t), float(v)) for t, v in zip(types, lats)]


def _workers(dm, seed):
    rng = np.random.default_rng(seed)
    k = int(rng.integers(1, 6))
    return [dm.Worker(f"w{i}", float(rng.uniform(0.2, 1.5)),
                      float(rng.uniform(0, 2e-5))) for i in range(k)]


@pytest.mark.parametrize("policy", ["equal", "weighted"])
@pytest.mark.parametrize("seed", range(4))
def test_graph_latency_multiworker_is_the_reference_bits(policy, seed):
    ops = _ops(seed)
    want = ref_dm.graph_latency_multiworker(ops, _workers(ref_dm, seed),
                                            policy=policy, overhead=3e-5)
    got = port_dm.graph_latency_multiworker(ops, _workers(port_dm, seed),
                                            policy=policy, overhead=3e-5)
    assert got == want


@pytest.mark.parametrize("policy", ["equal", "weighted"])
@pytest.mark.parametrize("seed", range(3))
def test_speedup_curve_is_the_reference_bits(policy, seed):
    ops = _ops(seed)
    kw = dict(speed=0.8, sync_overhead=1.5e-5, policy=policy)
    assert port_dm.speedup_curve(ops, [1, 2, 3, 4, 8], **kw) == \
        ref_dm.speedup_curve(ops, [1, 2, 3, 4, 8], **kw)


@pytest.mark.parametrize("seed", range(4))
def test_weighted_split_planner_is_the_reference_bits(seed):
    rng = np.random.default_rng(seed)
    times = list(rng.uniform(0.05, 3.0, size=int(rng.integers(2, 9))))
    total = int(rng.integers(len(times), 64))
    ref, port = ref_dm.WeightedSplitPlanner(0.02), port_dm.WeightedSplitPlanner(0.02)
    assert port.plan(times) == ref.plan(times)
    assert port.microbatch_plan(times, total) == ref.microbatch_plan(times, total)
    shares = ref.plan(times)
    assert port.predicted_step(times) == ref.predicted_step(times)
    assert port.predicted_step(times, shares) == ref.predicted_step(times, shares)


def test_equal_and_weighted_split_are_the_reference_bits():
    for seed in range(6):
        for par in (True, False):
            lat = float(np.random.default_rng(seed).uniform(1e-6, 1e-3))
            assert port_dm.equal_split_latency(lat, _workers(port_dm, seed), par) == \
                ref_dm.equal_split_latency(lat, _workers(ref_dm, seed), par)
            assert port_dm.weighted_split_latency(lat, _workers(port_dm, seed), par) == \
                ref_dm.weighted_split_latency(lat, _workers(ref_dm, seed), par)
    assert port_dm.PARALLELIZABLE_OPS == ref_dm.PARALLELIZABLE_OPS


def _monitor_trace(monitor, seed):
    rng = np.random.default_rng(seed)
    m = monitor(n_groups=4, ewma=0.25, degrade_threshold=1.2)
    trace = [(m.microbatch_plan(16), m.predicted_speedup(16), m.degraded_groups())]
    m.seed_from_predictions(list(rng.uniform(0.5, 1.5, 4)))
    for _ in range(6):
        m.update(list(rng.uniform(0.5, 2.5, 4)))
        trace.append((m.step_times.tolist(), m.degraded_groups(),
                      m.microbatch_plan(24), m.predicted_speedup(24)))
    return trace


@pytest.mark.parametrize("seed", range(3))
def test_straggler_monitor_trace_is_the_reference_bits(seed):
    assert _monitor_trace(PortMonitor, seed) == \
        _monitor_trace(ref_st.StragglerMonitor, seed)


def test_port_distributed_package_exports_only_the_monitor():
    import repro_torch.distributed as d

    # The package exports what the reference's exports (the sharding
    # rules and the train and serve steps, since the multi-device slice)
    # and the monitor.
    import repro.distributed as ref

    assert sorted(d.__all__) == sorted(ref.__all__ + ["StragglerMonitor"])
    assert port_st.StragglerMonitor is PortMonitor
    assert type(PortMonitor(n_groups=2).planner) is port_dm.WeightedSplitPlanner
