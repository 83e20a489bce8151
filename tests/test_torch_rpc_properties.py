"""Property tests of the port's micro-batcher (twin of tests/test_rpc_properties.py).

Arbitrary arrival orders, policies and tick sequences drive the port's
`MicroBatcher` synchronously under a `ManualClock` (no worker thread),
over a stub service that records every `predict_batch`.  The batcher
must answer every request exactly once and never cross-wire, keep every
flushed batch within ``max_batch`` and every (setting, family) group
FIFO, short-circuit cached requests, and replay the same script to the
same flush schedule — which must also equal the reference batcher's
schedule on the same drawn script.  The deterministic edge cases
(`PendingResult` timeouts, deadline boundaries) run without hypothesis.
"""
import time

import pytest

pytest.importorskip("torch")

from repro.core.profiler import DeviceSetting as RefSetting  # noqa: E402
from repro.rpc import batcher as ref_batcher  # noqa: E402

from repro_torch.core.profiler import DeviceSetting  # noqa: E402
from repro_torch.rpc.batcher import (BatchPolicy, ManualClock,  # noqa: E402
                                     MicroBatcher, PendingResult)
from repro_torch.rpc.protocol import E_TIMEOUT, RPCError  # noqa: E402

try:
    from hypothesis import given, settings, strategies as st
    HAS_HYPOTHESIS = True
except ImportError:                       # optional dev dependency
    HAS_HYPOTHESIS = False

SETTINGS = (("dev_a", "float32", "op_by_op"), ("dev_b", "int8", "op_by_op"))


class FakeGraph:
    """The batcher never inspects graphs: an opaque token suffices."""

    __slots__ = ("uid",)

    def __init__(self, uid):
        self.uid = uid


class StubService:
    """Deterministic predict_batch that records every call's composition."""

    def __init__(self, setting_cls, cached_uids=frozenset()):
        self.settings = tuple(setting_cls(*s) for s in SETTINGS)
        self.default_setting = self.settings[0]
        self.predictor = "gbdt"
        self.calls = []
        self.cached_uids = set(cached_uids)

    @staticmethod
    def value_of(uid, setting, family):
        return float(hash((uid, setting.dtype, family)) % 100003)

    def cache_peek(self, graph, setting, family):
        if graph.uid in self.cached_uids:
            return ("cached", graph.uid, self.value_of(graph.uid, setting, family))
        return None

    def predict_batch(self, graphs, setting, family):
        self.calls.append((setting.dtype, family, tuple(g.uid for g in graphs)))
        return [("fresh", g.uid, self.value_of(g.uid, setting, family)) for g in graphs]


PORT = (DeviceSetting, MicroBatcher, BatchPolicy, ManualClock)
REF = (RefSetting, ref_batcher.MicroBatcher, ref_batcher.BatchPolicy,
       ref_batcher.ManualClock)


def drive(events, policy_kw, pkg=PORT, cached=frozenset()):
    """Run one script; returns (service, [(graph, setting, cached?, future)], batcher).
    A submission whose token is in ``cached`` is answered by cache_peek."""
    setting_cls, batcher_cls, policy_cls, clock_cls = pkg
    svc = StubService(setting_cls)
    clock = clock_cls()
    b = batcher_cls(svc, policy_cls(**policy_kw), clock=clock, auto_start=False)
    futures = []
    for i, (kind, a, c) in enumerate(events):
        if kind == "submit":
            g = FakeGraph((a, c, i))                # unique per submission
            if c in cached:
                svc.cached_uids.add(g.uid)
            setting = svc.settings[a]
            futures.append((g, setting, c in cached, b.submit(g, setting)))
            b.run_pending()                          # size-triggered flushes
        elif kind == "advance":
            clock.advance(a)
            b.run_pending()                          # deadline-triggered flushes
        else:
            b.run_pending()
    b.flush_all()
    return svc, futures, b


# -- deterministic edge cases ---------------------------------------------------------

def test_unsettled_result_times_out_retryably_and_stays_open():
    p = PendingResult()
    t0 = time.monotonic()
    with pytest.raises(RPCError) as ei:
        p.result(timeout=0.02)
    assert ei.value.code == E_TIMEOUT and ei.value.retryable
    assert "0.02" in ei.value.message and not p.done()
    assert time.monotonic() - t0 < 1.0
    p._resolve("late answer")
    assert p.result(timeout=0) == "late answer"
    with pytest.raises(RuntimeError):
        p._resolve("again")


@pytest.mark.parametrize("wait,advances,due_at", [(0, [], 0), (2, [1, 1], 2),
                                                  (1, [10], 1)])
def test_deadline_boundaries_equal_reference(wait, advances, due_at):
    """``deadline <= now`` is due: one tick short nothing flushes, on or
    past it the request flushes once — in both packages alike."""
    out = []
    for setting_cls, batcher_cls, policy_cls, clock_cls in (PORT, REF):
        svc = StubService(setting_cls)
        clock = clock_cls()
        b = batcher_cls(svc, policy_cls(max_batch=8, max_wait_ticks=wait, max_queue=64),
                        clock=clock, auto_start=False)
        fut = b.submit(FakeGraph("edge"))
        served = [b.run_pending()]
        for t in advances:
            clock.advance(t)
            served.append(b.run_pending())
        served.append(b.run_pending())
        out.append((served, svc.calls, fut.result(0), b.stats()["answered"]))
    assert out[0] == out[1]
    served = out[0][0]
    assert sum(served) == 1 and out[0][3] == 1
    ticks = [0] + [sum(advances[:i + 1]) for i in range(len(advances))]
    assert ticks[served.index(1)] >= due_at


def test_advance_wakes_subscribers():
    clock = ManualClock()
    hits = []
    clock.subscribe(lambda: hits.append(clock.now()))
    assert clock.advance(3) == 3 and clock.advance(2) == 5
    assert hits == [3, 5]


# -- the property half -------------------------------------------------------------------

if HAS_HYPOTHESIS:
    EVENTS = st.lists(
        st.one_of(
            st.tuples(st.just("submit"), st.integers(0, 1), st.integers(0, 30)),
            st.tuples(st.just("advance"), st.integers(1, 4), st.just(0)),
            st.tuples(st.just("pump"), st.just(0), st.just(0))),
        min_size=1, max_size=40)
    POLICIES = st.fixed_dictionaries({"max_batch": st.integers(1, 6),
                                      "max_wait_ticks": st.integers(0, 4),
                                      "max_queue": st.just(10_000)})

    @settings(max_examples=120, deadline=None)
    @given(events=EVENTS, policy=POLICIES)
    def test_every_request_answered_exactly_once(events, policy):
        svc, futures, b = drive(events, policy)
        assert len(futures) == sum(1 for e in events if e[0] == "submit")
        for g, setting, _, fut in futures:
            assert fut.done()
            kind, uid, value = fut.result(0)
            assert uid == g.uid and value == StubService.value_of(uid, setting, "gbdt")
        st_ = b.stats()
        assert st_["answered"] == len(futures)
        assert st_["failed"] == st_["rejected"] == st_["queued"] == 0
        flushed = [uid for _, _, uids in svc.calls for uid in uids]
        assert len(flushed) == len(set(flushed)) == len(futures) - st_["short_circuits"]

    @settings(max_examples=120, deadline=None)
    @given(events=EVENTS, policy=POLICIES)
    def test_batches_bounded_and_fifo_per_group(events, policy):
        svc, futures, _ = drive(events, policy)
        served = {}
        for dtype, _family, uids in svc.calls:
            assert 1 <= len(uids) <= policy["max_batch"]
            served.setdefault(dtype, []).extend(uids)
        submitted = {}
        for g, setting, _, _fut in futures:
            submitted.setdefault(setting.dtype, []).append(g.uid)
        assert served == submitted

    @settings(max_examples=80, deadline=None)
    @given(events=EVENTS, policy=POLICIES)
    def test_schedule_replays_and_equals_reference(events, policy):
        svc1, futs1, b1 = drive(events, policy)
        svc2, _, _ = drive(events, policy)
        ref, rfuts, rb = drive(events, policy, pkg=REF)
        assert svc1.calls == svc2.calls == ref.calls
        assert [f.result(0) for *_, f in futs1] == [f.result(0) for *_, f in rfuts]
        assert b1.stats() == rb.stats()

    @settings(max_examples=80, deadline=None)
    @given(events=EVENTS, policy=POLICIES, cached=st.sets(st.integers(0, 30), max_size=10))
    def test_cache_short_circuits_never_enqueue(events, policy, cached):
        svc, futures, b = drive(events, policy, cached=cached)
        ref, _, _ = drive(events, policy, pkg=REF, cached=cached)
        flushed = {uid for _, _, uids in svc.calls for uid in uids}
        n_cached = 0
        for g, _setting, was_cached, fut in futures:
            kind, uid, _value = fut.result(0)
            assert uid == g.uid
            assert (kind == "cached") == was_cached
            if was_cached:
                n_cached += 1
                assert g.uid not in flushed
        assert b.stats()["short_circuits"] == n_cached
        assert svc.calls == ref.calls
else:
    def test_hypothesis_property_half_skipped():
        pytest.skip("hypothesis not installed: the property half is skipped "
                    "(the deterministic edge cases above still ran)")
