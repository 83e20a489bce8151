"""The port's RPC serving layer (repro_torch.rpc) held against the reference's.

Banks are trained by the reference on a store its hardware-free
`CostModelProfileSession` wrote, saved as JSON and loaded by both
packages (the port's hubs and services on ``device="cpu"``, every
service on the numpy tier unless a test says otherwise), so both sides
serve the same numbers.  Then:

  * the wire format: the port encodes the committed golden lines and the
    golden `PredictionReport` byte for byte;
  * the micro-batcher: the same arrival and tick scripts under a
    `ManualClock` give the same flush schedule, reports, stats, registry
    snapshot and spans in both packages (size, deadline, cache
    short-circuit, admission, fairness, every shedding tier);
  * chaos and resilience: `FaultPlan` schedules and tallies, backoff
    traces, `retry_call` outcomes and `CircuitBreaker` transitions are
    identical for the same seeds, and the port's client converges
    through a seeded dispatch storm with the closed-form backoff trace;
  * dispatch: the same request lines through both servers' stream
    transport give byte-identical response lines — health, the
    Prometheus exposition, rollovers (a lasso bank rebuilt on the hub's
    device), search fronts and typed errors;
  * a live TCP server on the port's ``torch`` host tier, the reference's
    mid-flood rollover under the port's autopilot, and `ServeEngine`
    taking its step estimate through the port's `LatencyClient`.

Every thread is joined with a timeout and every client has one.
"""
import io
import json
import os
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro import obs as ref_obs  # noqa: E402
from repro import rpc as ref_rpc  # noqa: E402
from repro import search as ref_search  # noqa: E402
from repro.core.composition import PredictorBank as RefBank  # noqa: E402
from repro.core.dataset import synthetic_graphs as ref_graphs  # noqa: E402
from repro.core.nas_space import NASSpaceConfig as RefSpace  # noqa: E402
from repro.core.nas_space import sample_architecture as ref_sample  # noqa: E402
from repro.core.profiler import DeviceSetting as RefSetting  # noqa: E402
from repro.pipeline import LatencyService as RefService  # noqa: E402
from repro.pipeline import PredictorHub as RefHub  # noqa: E402
from repro.pipeline import ProfileStore as RefStore  # noqa: E402
from repro.pipeline.store import setting_key as ref_setting_key  # noqa: E402
from repro.rpc import protocol as ref_protocol  # noqa: E402
from repro.transfer import CostModelProfileSession as RefCostSession  # noqa: E402

from repro_torch import obs, rpc, search, transfer  # noqa: E402
from repro_torch.core.composition import PredictorBank  # noqa: E402
from repro_torch.core.dataset import synthetic_graphs  # noqa: E402
from repro_torch.core.nas_space import NASSpaceConfig, sample_architecture  # noqa: E402
from repro_torch.core.profiler import DeviceSetting  # noqa: E402
from repro_torch.pipeline import LatencyService, PredictorHub, ProfileStore  # noqa: E402
from repro_torch.pipeline.service import PredictionReport  # noqa: E402
from repro_torch.pipeline.store import setting_key  # noqa: E402
from repro_torch.rpc import protocol  # noqa: E402
from repro_torch.rpc.protocol import RPCError  # noqa: E402

# One intra-op thread per xdist worker's share of the cores: these tests
# run beside the reference's wall-clock profiling tests.
torch.set_num_threads(max(1, (os.cpu_count() or 1)
                          // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
CPU = "cpu"
SOURCE = ("cpu_f32", "float32", "op_by_op")
UNKNOWN = ("other", "int8", "op_by_op")

PORT = SimpleNamespace(
    name="port", rpc=rpc, obs=obs, protocol=protocol, search=search,
    Setting=DeviceSetting, setting_key=setting_key,
    Hub=lambda: PredictorHub(device=CPU),
    Service=lambda hub, **kw: LatencyService(hub, device=CPU, **kw),
    bank=lambda d: PredictorBank.from_json(d, device=CPU),
    graph=lambda seed: sample_architecture(seed, NASSpaceConfig(resolution=16)))
REF = SimpleNamespace(
    name="ref", rpc=ref_rpc, obs=ref_obs, protocol=ref_protocol, search=ref_search,
    Setting=RefSetting, setting_key=ref_setting_key,
    Hub=RefHub, Service=RefService, bank=RefBank.from_json,
    graph=lambda seed: ref_sample(seed, RefSpace(resolution=16)))


@pytest.fixture(scope="module")
def banks():
    """Bank JSON trained by the reference: the served gbdt and lasso
    banks, two more for rollovers, and the median training e2e (the
    search budget)."""
    store = RefStore()
    sess = RefCostSession(store=store, seed=3)
    recs = sess.profile_suite(ref_graphs(8, resolution=16), RefSetting(*SOURCE))
    hub = RefHub()
    out = {"gbdt": hub.train(store, RefSetting(*SOURCE), "gbdt",
                             hparams={"n_stages": 20}, min_samples=3).to_json(),
           "lasso": hub.train(store, RefSetting(*SOURCE), "lasso",
                              min_samples=3).to_json()}
    out["gbdt2"] = RefHub().train(store, RefSetting(*SOURCE), "gbdt",
                                  hparams={"n_stages": 7}, min_samples=3, seed=2,
                                  save=False).to_json()
    out["lasso2"] = RefHub().train(store, RefSetting(*SOURCE), "lasso",
                                   hparams={"alpha": 1e-3, "iters": 200}, min_samples=3,
                                   save=False).to_json()
    out["budget_s"] = float(np.median([r.e2e_s for r in recs]))
    return out


def _service(pkg, banks, backend="numpy", **kw):
    hub = pkg.Hub()
    hub.register(pkg.Setting(*SOURCE), "gbdt", pkg.bank(banks["gbdt"]))
    hub.register(pkg.Setting(*SOURCE), "lasso", pkg.bank(banks["lasso"]))
    return pkg.Service(hub, default_setting=pkg.Setting(*SOURCE), predictor="gbdt",
                       inference_backend=backend, **kw)


def _join(threads, timeout=60.0):
    for t in threads:
        t.join(timeout=timeout)
    assert not any(t.is_alive() for t in threads), "a worker thread hung"


# -- the wire format against the golden files ----------------------------------------

@pytest.mark.parametrize("name", ["rpc_requests.jsonl", "rpc_traced.jsonl"])
def test_golden_requests_encode_byte_for_byte(name):
    with open(os.path.join(GOLDEN, name)) as f:
        lines = [ln.strip() for ln in f if ln.strip()]
    for line in lines:
        if '"method"' not in line:
            continue
        req = protocol.decode_request(line)
        assert protocol.encode_request(req) == line
        again = protocol.Request(id=req.id, method=req.method, params=req.params,
                                 trace=req.trace)
        assert protocol.encode_request(again) == \
            ref_protocol.encode_request(ref_protocol.decode_request(line))
        if "graph" in req.params:
            g = protocol.graph_from_wire(req.params["graph"])
            rg = ref_protocol.graph_from_wire(req.params["graph"])
            assert g.fingerprint() == rg.fingerprint()


@pytest.mark.parametrize("name", ["rpc_responses.jsonl", "rpc_traced.jsonl"])
def test_golden_responses_encode_byte_for_byte(name):
    with open(os.path.join(GOLDEN, name)) as f:
        lines = [ln.strip() for ln in f if ln.strip()]
    codes = set()
    for line in lines:
        if '"method"' in line:
            continue
        resp = protocol.decode_response(line)
        if not resp.ok:
            codes.add(resp.error.code)
            err = ref_protocol.decode_response(line).error
            assert (resp.error.code, resp.error.message, resp.error.retryable) == \
                (err.code, err.message, err.retryable)
        assert protocol.encode_response(resp) == line
    if name == "rpc_responses.jsonl":
        assert {protocol.E_OVERLOADED, protocol.E_UNKNOWN_METHOD,
                protocol.E_BAD_GRAPH, protocol.E_INTERNAL} <= codes


def test_golden_invalid_lines_rejected_with_the_committed_codes():
    with open(os.path.join(GOLDEN, "rpc_invalid.jsonl")) as f:
        cases = [json.loads(ln) for ln in f if ln.strip()]
    assert cases
    for case in cases:
        with pytest.raises(RPCError) as ei:
            protocol.decode_request(case["line"])
        assert ei.value.code == case["code"], case
    assert protocol.METHODS == ref_protocol.METHODS
    assert protocol.PROTOCOL_VERSION == ref_protocol.PROTOCOL_VERSION


def test_golden_prediction_report():
    with open(os.path.join(GOLDEN, "prediction_report.json")) as f:
        committed = json.load(f)
    rep = PredictionReport(graph_name="golden_net", fingerprint="0123456789abcdef",
                           setting="float32/op_by_op", predictor="gbdt", e2e_s=0.0125,
                           per_op=(("conv2d", 0.01),), overhead_s=0.0025,
                           num_ops=1, num_kernels=1)
    assert rep.to_json() == committed
    assert PredictionReport.from_json(committed) == rep
    assert json.dumps(protocol.report_from_json(committed).to_json(), sort_keys=True) == \
        json.dumps(committed, sort_keys=True)


# -- the micro-batcher: same scripts, same schedules ----------------------------------

POLICY = dict(max_batch=4, max_wait_ticks=2, max_queue=64)
SHED = dict(max_batch=32, max_wait_ticks=1, max_queue=10, shed_frac=0.5,
            shed_reject_ticks=2)
# (policy, events): ("submit", graph seed, family, setting) / ("warm",
# seed) / ("advance", ticks) / ("pump",) / ("flush",) / ("tier",) /
# ("close",).  The cases follow tests/test_rpc.py::TestBatcher and
# tests/test_chaos.py::TestSheddingTiers.
SCRIPTS = {
    "size_then_deadline": (POLICY, [("submit", s, None, SOURCE) for s in range(100, 110)]
                           + [("pump",), ("pump",), ("advance", 2), ("pump",)]),
    "cache_short_circuit": (POLICY, [("warm", 120), ("submit", 120, None, SOURCE),
                                     ("submit", 121, None, SOURCE), ("tier",),
                                     ("flush",)]),
    "admission": (dict(POLICY, max_queue=3),
                  [("submit", s, None, SOURCE) for s in range(130, 134)] + [("flush",)]),
    "fairness": (dict(POLICY, max_batch=8),
                 [("submit", s, "gbdt", SOURCE) for s in range(140, 143)]
                 + [("submit", s, "lasso", SOURCE) for s in range(143, 145)]
                 + [("advance", 2), ("pump",)]),
    "unknown_setting": (POLICY, [("submit", 150, None, UNKNOWN),
                                 ("submit", 151, None, SOURCE), ("flush",)]),
    "closed": (POLICY, [("submit", 152, None, SOURCE), ("close",),
                        ("submit", 153, None, SOURCE)]),
    "shed_cache_only": (SHED, [("submit", s, None, SOURCE) for s in range(160, 165)]
                        + [("tier",), ("submit", 165, None, SOURCE), ("warm", 166),
                           ("submit", 166, None, SOURCE), ("advance", 1), ("pump",),
                           ("tier",), ("submit", 167, None, SOURCE), ("flush",)]),
    "shed_reject": (SHED, [("submit", s, None, SOURCE) for s in range(170, 175)]
                    + [("advance", 3), ("tier",), ("advance", 1), ("tier",),
                       ("warm", 175), ("submit", 175, None, SOURCE), ("pump",),
                       ("tier",), ("submit", 176, None, SOURCE), ("flush",)]),
    "single_cliff": (dict(SHED, shed_frac=1.0, shed_reject_ticks=None, max_queue=3),
                     [("submit", s, None, SOURCE) for s in range(180, 184)]
                     + [("advance", 100), ("tier",), ("warm", 184),
                        ("submit", 184, None, SOURCE), ("flush",)]),
}


def _outcome(fut):
    err = fut.error()
    if err is not None:
        return ["error", err.code, err.message, err.retryable]
    return fut.result(0).to_json()


def _batcher_script(pkg, banks, case):
    policy, events = SCRIPTS[case]
    clock = pkg.rpc.ManualClock()
    bundle = pkg.obs.Observability(clock=clock, seed=0)
    svc = _service(pkg, banks, obs=bundle)
    calls, real = [], svc.predict_batch

    def spy(graphs, setting=None, predictor=None):
        calls.append((pkg.setting_key(setting or svc.default_setting), predictor,
                      [g.fingerprint() for g in graphs]))
        return real(graphs, setting, predictor)

    svc.predict_batch = spy
    b = pkg.rpc.MicroBatcher(svc, pkg.rpc.BatchPolicy(**policy), clock=clock,
                             auto_start=False, obs=bundle)
    futures, trail = [], []
    for ev in events:
        kind = ev[0]
        if kind == "submit":
            try:
                futures.append(b.submit(pkg.graph(ev[1]), pkg.Setting(*ev[3]), ev[2]))
                trail.append(["admitted", futures[-1].done(), b.queued()])
            except pkg.protocol.RPCError as exc:
                trail.append(["refused", exc.code, exc.message, exc.retryable])
        elif kind == "warm":
            svc.predict_e2e(pkg.graph(ev[1]))
        elif kind == "advance":
            clock.advance(ev[1])
        elif kind == "pump":
            trail.append(["pump", b.run_pending()])
        elif kind == "flush":
            trail.append(["flush", b.flush_all()])
        elif kind == "tier":
            trail.append(["tier", b.shed_tier()])
        else:
            b.close()
    b.close()
    return {"calls": calls, "trail": trail,
            "outcomes": [_outcome(f) for f in futures],
            "stats": b.stats(), "snap": bundle.snapshot_json(include_collected=False),
            "spans": json.dumps(bundle.tracer.export(), sort_keys=True),
            "prom": bundle.prometheus()}


@pytest.mark.parametrize("case", list(SCRIPTS))
def test_batcher_schedule_equals_reference(banks, case):
    port, ref = _batcher_script(PORT, banks, case), _batcher_script(REF, banks, case)
    for key in port:
        assert port[key] == ref[key], key
    st = port["stats"]
    assert st["submitted"] == st["answered"] + st["failed"]
    assert st["queued"] == 0
    assert set(st["flush_backends"]) <= {"numpy", "direct"}
    if case == "fairness":
        assert [(c[1], len(c[2])) for c in port["calls"]] == [("gbdt", 3), ("lasso", 2)]
    if case == "size_then_deadline":
        assert [len(c[2]) for c in port["calls"]] == [4, 4, 2]
    if case == "shed_reject":
        assert ["tier", "reject"] in port["trail"] and st["shed_rejected"] == 1


def test_exactly_once_guard_and_timeouts():
    p = rpc.PendingResult()
    with pytest.raises(RPCError) as ei:
        p.result(timeout=0)
    assert ei.value.code == protocol.E_TIMEOUT and ei.value.retryable and not p.done()
    p._resolve("x")
    assert p.result(0) == "x"
    with pytest.raises(RuntimeError):
        p._resolve("y")
    with pytest.raises(RuntimeError):
        p._fail(RPCError(protocol.E_INTERNAL, "again"))
    for bad in (dict(max_batch=0), dict(max_wait_ticks=-1), dict(max_queue=0),
                dict(shed_frac=0.0), dict(shed_reject_ticks=-1)):
        with pytest.raises(ValueError):
            rpc.BatchPolicy(**bad)
        with pytest.raises(ValueError):
            ref_rpc.BatchPolicy(**bad)


# -- chaos and resilience: the same seeds give the same schedules -----------------------

def _specs(pkg):
    F = pkg.rpc.FaultSpec
    return (F(site="flush", kind="error", rate=0.25), F(site="flush", kind="wedge", rate=0.15),
            F(site="dispatch", kind="delay", rate=0.3, delay_s=0.001),
            F(site="transport", kind="drop", rate=0.2),
            F(site="dispatch", kind="error", rate=0.1, code=pkg.protocol.E_UNAVAILABLE,
              message="chaos", retryable=True))


def _plan_script(pkg, seed):
    plan = pkg.rpc.FaultPlan(seed, _specs(pkg))
    out = {"preview": {s: plan.schedule(s, 300) for s in ("flush", "dispatch", "transport")}}
    consumed = []
    for i in range(240):
        site = ("flush", "dispatch", "transport")[i % 3]
        f = plan.decide(site)
        consumed.append(None if f is None else [f.kind, f.code, f.message, f.delay_s])
    out.update(consumed=consumed, injected=plan.injected(), stats=plan.stats(),
               events=[plan.events(s) for s in ("flush", "dispatch", "transport")])
    return out


@pytest.mark.parametrize("seed", [0, 7, 11, 42])
def test_fault_plan_equals_reference(seed):
    port, ref = _plan_script(PORT, seed), _plan_script(REF, seed)
    assert port == ref
    kinds = [k for k in port["preview"]["flush"] if k is not None]
    assert kinds and len(kinds) < 300
    assert rpc.chaos.KINDS == ref_rpc.chaos.KINDS
    assert (rpc.SITE_DISPATCH, rpc.SITE_FLUSH, rpc.SITE_TRANSPORT) == \
        (ref_rpc.SITE_DISPATCH, ref_rpc.SITE_FLUSH, ref_rpc.SITE_TRANSPORT)


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def sleep(self, s):
        self.t += s


def _resilience_script(pkg):
    P, E, R = pkg.rpc.RetryPolicy, pkg.protocol, pkg.protocol.RPCError
    out = {"schedules": [
        P(max_attempts=8, base_delay_s=0.1, max_delay_s=0.5, jitter=0.25,
          seed=9).backoff_schedule(),
        P(seed=3).backoff_schedule(), P(seed=3).backoff_schedule(attempts=12, seed=10),
        P(max_attempts=1).backoff_schedule(),
        P(base_delay_s=0.0, jitter=0.0, multiplier=1.0).backoff_schedule()]}

    def run(policy, attempt, breaker=None):
        clock, slept = FakeClock(), []

        def sleep(s):
            slept.append(s)
            clock.sleep(s)
        try:
            res = ["ok", pkg.rpc.retry_call(attempt, policy, sleep=sleep, clock=clock,
                                            breaker=breaker)]
        except R as exc:
            res = ["error", exc.code, exc.message, exc.retryable]
        return [res, slept, clock.t]

    def failing(n, code):
        left = [n]

        def attempt(budget):
            if left[0] > 0:
                left[0] -= 1
                raise R(code, f"left {left[0]}")
            return "done"
        return attempt

    pol = P(max_attempts=5, base_delay_s=0.05, seed=3, deadline_s=100.0)
    out["traces"] = [
        run(pol, failing(3, E.E_OVERLOADED)),
        run(pol, failing(9, E.E_UNAVAILABLE)),
        run(pol, failing(1, E.E_BAD_REQUEST)),
        run(P(max_attempts=100, base_delay_s=1.0, multiplier=1.0, jitter=0.0,
              deadline_s=3.5), failing(1000, E.E_UNAVAILABLE))]
    clock = FakeClock()
    br = pkg.rpc.CircuitBreaker(failure_threshold=3, reset_after_s=2.0, clock=clock)
    states = []
    for op in ("f", "f", "s", "f", "f", "f", "a", "t", "a", "a", "s", "f", "f", "f",
               "t", "a", "f", "a", "t", "a", "s"):
        if op == "f":
            br.record_failure()
        elif op == "s":
            br.record_success()
        elif op == "t":
            clock.t += 2.0
        else:
            states.append(br.allow())
        states.append(br.state())
    out["breaker"] = [states, br.opens]
    open_br = pkg.rpc.CircuitBreaker(failure_threshold=1, reset_after_s=10.0, clock=clock)
    open_br.record_failure()
    out["open_breaker"] = run(P(deadline_s=100.0), lambda b: "x", open_br)
    return out


def test_retry_backoff_and_breaker_equal_reference():
    port, ref = _resilience_script(PORT), _resilience_script(REF)
    assert port == ref
    assert port["traces"][0][0] == ["ok", "done"] and len(port["traces"][0][1]) == 3
    assert port["traces"][3][0][1] == protocol.E_TIMEOUT
    assert port["open_breaker"][0][1] == protocol.E_UNAVAILABLE
    for bad in (dict(max_attempts=0), dict(multiplier=0.5), dict(jitter=2.0),
                dict(deadline_s=0)):
        with pytest.raises(ValueError):
            rpc.RetryPolicy(**bad)


class StubService:
    """The batcher's whole interface to a service, on opaque tokens."""

    def __init__(self, setting):
        self.default_setting = setting
        self.predictor = "gbdt"
        self.cached = set()

    def cache_peek(self, graph, setting, family):
        return ("cached", graph) if graph in self.cached else None

    def predict_batch(self, graphs, setting, family):
        return [("fresh", g) for g in graphs]


def _storm(pkg, seed, wedge_rate, n):
    plan = pkg.rpc.FaultPlan(seed, [
        pkg.rpc.FaultSpec(site="flush", kind="error", rate=0.2,
                          code=pkg.protocol.E_UNAVAILABLE, message="injected"),
        pkg.rpc.FaultSpec(site="flush", kind="wedge", rate=wedge_rate)])
    clock = pkg.rpc.ManualClock()
    b = pkg.rpc.MicroBatcher(StubService(pkg.Setting(*SOURCE)),
                             pkg.rpc.BatchPolicy(max_batch=4, max_wait_ticks=1,
                                                 max_queue=4096),
                             clock=clock, auto_start=False, chaos=plan)
    futs = [b.submit(f"g{i}") for i in range(n)]
    rounds = []
    for _ in range(20 * n):
        clock.advance(1)
        rounds.append(b.run_pending())
        if all(f.done() for f in futs):
            break
    b.close()
    return {"rounds": rounds, "outcomes": [_outcome(f) if f.error() else f.result(0)
                                           for f in futs],
            "stats": b.stats(), "injected": plan.injected()}


@pytest.mark.parametrize("seed,wedge", [(13, 0.2), (21, 0.0), (5, 0.5)])
def test_batcher_chaos_storm_equals_reference(seed, wedge):
    port, ref = _storm(PORT, seed, wedge, 60), _storm(REF, seed, wedge, 60)
    assert port == ref
    st = port["stats"]
    ok = sum(1 for o in port["outcomes"] if o[0] == "fresh")
    assert ok + sum(1 for o in port["outcomes"] if o[0] == "error") == 60
    assert st["answered"] == ok and st["failed"] == 60 - ok
    assert st["wedged_flushes"] == port["injected"].get("flush/wedge", 0)


def test_wedge_storm_fails_typed_on_close():
    plan = rpc.FaultPlan(1, [rpc.FaultSpec(site="flush", kind="wedge", rate=1.0)])
    b = rpc.MicroBatcher(StubService(DeviceSetting(*SOURCE)),
                         rpc.BatchPolicy(max_batch=4, max_wait_ticks=0, max_queue=64),
                         clock=rpc.ManualClock(), auto_start=False, chaos=plan)
    futs = [b.submit(f"w{i}") for i in range(8)]
    assert b.run_pending() == 0 and b.queued() == 8
    b.close()
    assert all(f.done() and f.error().code == protocol.E_UNAVAILABLE for f in futs)
    assert b.stats()["failed"] == 8


def test_client_retries_converge_with_the_closed_form_backoff(banks):
    """tests/test_chaos.py::TestClientRetryConvergence on the port: the
    expected sleeps come from the port's plan, which equals the
    reference's."""
    plan = rpc.FaultPlan(97, [rpc.FaultSpec(site="dispatch", kind="error", rate=0.4,
                                            code=protocol.E_UNAVAILABLE,
                                            message="chaos says no")])
    ref_plan = ref_rpc.FaultPlan(97, [ref_rpc.FaultSpec(
        site="dispatch", kind="error", rate=0.4, code=ref_protocol.E_UNAVAILABLE,
        message="chaos says no")])
    pol = rpc.RetryPolicy(max_attempts=10, base_delay_s=0.01, seed=5, deadline_s=60.0)
    n_calls = 10
    sched = plan.schedule("dispatch", 50 * n_calls)
    assert sched == ref_plan.schedule("dispatch", 50 * n_calls)
    expected, i = [], 0
    for _ in range(n_calls):
        fails = 0
        while sched[i] == "error":
            i += 1
            fails += 1
        i += 1
        assert fails < pol.max_attempts
        expected += pol.backoff_schedule()[:fails]
    server = rpc.LatencyRPCServer(_service(PORT, banks), chaos=plan)
    host, port = server.start()
    slept = []
    cli = rpc.LatencyClient(host, port, timeout=30.0, retry=pol, sleep=slept.append)
    try:
        for _ in range(n_calls):
            assert ["float32/op_by_op", "gbdt"] in cli.call("available", {})["banks"]
    finally:
        cli.close()
        server.stop()
    assert expected and slept == expected
    assert cli.retries == len(expected) and plan.events("dispatch") == i


def test_transport_drops_heal_to_full_success(banks):
    svc = _service(PORT, banks)
    plan = rpc.FaultPlan(31, [rpc.FaultSpec(site="transport", kind="drop", rate=0.25)])
    server = rpc.LatencyRPCServer(svc, chaos=plan, policy=rpc.BatchPolicy(
        max_batch=8, max_wait_ticks=2, max_queue=4096))
    host, port = server.start()
    pol = rpc.RetryPolicy(max_attempts=8, base_delay_s=0.01, max_delay_s=0.05,
                          deadline_s=30.0, seed=2)
    cli = rpc.LatencyClient(host, port, timeout=5.0, retry=pol)
    gs = [PORT.graph(s) for s in range(700, 712)]
    try:
        reports = [cli.predict_e2e(g) for g in gs]
    finally:
        cli.close()
        server.stop()
    direct = _service(PORT, banks).predict_batch(gs)
    # A retried request whose first answer was dropped is a cache hit.
    assert [(r.fingerprint, r.e2e_s) for r in reports] == \
        [(d.fingerprint, d.e2e_s) for d in direct]
    assert plan.injected().get("transport/drop", 0) > 0 and cli.reconnects > 0


# -- dispatch: the same request lines through both servers' stream transport -----------

def _req(rid, method, params=None):
    return json.dumps({"v": 1, "id": rid, "method": method, "params": params or {}},
                      sort_keys=True, separators=(",", ":"))


def _dispatch_lines(pkg, banks):
    g = [pkg.graph(s).to_json() for s in range(200, 210)]
    src = "float32/op_by_op"
    return [
        _req("d01", "available"), _req("d02", "health"),
        _req("d03", "predict", {"graph": g[0]}),
        _req("d04", "predict", {"graph": g[0]}),
        _req("d05", "predict", {"graph": g[1], "predictor": "lasso"}),
        _req("d06", "predict_multi", {"graphs": [g[2], g[3]], "settings": [src]}),
        _req("d07", "predict", {"graph": g[4], "setting": "other:int8/op_by_op"}),
        _req("d08", "predictt"), '{"broken', _req("d09", "predict"),
        _req("d10", "predict", {"graph": {"name": "x"}}),
        _req("d11", "rollover", {"setting": src, "bank": banks["gbdt2"]}),
        _req("d12", "predict", {"graph": g[5]}),
        _req("d13", "predict", {"graph": g[0]}),
        _req("d14", "rollover", {"setting": src, "bank": banks["lasso2"],
                                 "family": "lasso"}),
        _req("d15", "predict", {"graph": g[6], "predictor": "lasso"}),
        _req("d16", "rollover", {"setting": src, "bank": {"not": "a bank"}}),
        _req("d17", "rollover", {}),
        _req("d18", "search_front"),
        _req("d19", "search_front", {"setting": src, "budget_s": banks["budget_s"],
                                     "limit": 2}),
        _req("d20", "search_front", {"setting": "int8/op_by_op"}),
        _req("d21", "search_front", {"budget_s": "soon"}),
        _req("d22", "metrics", {"format": "prometheus"}),
        _req("d23", "metrics", {"format": "xml"}),
        _req("d24", "metrics", {"timeline": True}),
        _req("d25", "health"), _req("d26", "stats")]


def _search_report(pkg, svc, budget_s):
    cfg = pkg.search.SearchConfig(population_size=12, generations=3, children_per_gen=10,
                                  tournament_size=4, seed=11, resolution=16,
                                  front_capacity=8)
    budgets = [pkg.search.DeviceBudget(pkg.Setting(*SOURCE), budget_s)]
    return pkg.search.SearchEngine(svc, budgets, cfg).run()


def _dispatch(pkg, banks):
    clock = pkg.rpc.ManualClock()
    bundle = pkg.obs.Observability(clock=clock, seed=4)
    svc = _service(pkg, banks, obs=bundle)
    report = _search_report(pkg, _service(pkg, banks), banks["budget_s"])
    server = pkg.rpc.LatencyRPCServer(
        svc, policy=pkg.rpc.BatchPolicy(max_batch=4, max_wait_ticks=1), clock=clock,
        auto_start_batcher=False, obs=bundle, search_report=report)
    lines = _dispatch_lines(pkg, banks)

    def feed():
        # The batcher has no worker: flush after each line is handled,
        # so every predict is answered before the next line is read.
        for line in lines:
            yield line + "\n"
            server.batcher.flush_all()
            clock.advance(1)

    wfile = io.StringIO()
    try:
        server.serve_stream(feed(), wfile, drain_timeout=10.0)
    finally:
        server.stop()
    return wfile.getvalue().splitlines(), svc


def _drop_lifetime(line):
    d = json.loads(line)
    if d.get("id") == "d26":
        d["result"]["service"]["device_residency"].pop("lifetime")
    return d


def test_dispatch_lines_equal_reference(banks):
    port, psvc = _dispatch(PORT, banks)
    ref, _ = _dispatch(REF, banks)
    assert len(port) == len(ref) == 27
    for a, b in zip(port, ref):
        if '"d26"' in a:          # stats: process-wide residency counters differ
            assert _drop_lifetime(a) == _drop_lifetime(b)
        else:
            assert a == b
    by_id = {}
    for line in port:
        r = protocol.decode_response(line)
        by_id.setdefault(r.id, r)
    assert by_id["d04"].result["report"]["from_cache"]
    assert by_id["d07"].error.code == protocol.E_UNKNOWN_SETTING
    assert by_id["d11"].ok and by_id["d14"].ok
    assert by_id["d12"].result["report"]["bank_epoch"] == by_id["d11"].result["epoch"]
    assert not by_id["d13"].result["report"]["from_cache"]   # a swap clears the cache
    # The lasso bank was rebuilt on the hub's device and serves there.
    lasso = psvc.hub.get(DeviceSetting(*SOURCE), "lasso")
    assert all(p.device == torch.device(CPU) for p in lasso.predictors.values())
    assert by_id["d15"].result["report"]["bank_epoch"] == by_id["d14"].result["epoch"]
    assert by_id["d16"].error.code == protocol.E_BAD_REQUEST
    assert by_id["d19"].result["total"] <= by_id["d18"].result["total"]
    assert by_id["d20"].error.code == protocol.E_UNKNOWN_SETTING
    text = by_id["d22"].result["text"]
    for name in ("rpc_batcher_submitted_total", "rpc_flush_backend_total",
                 "service_backend_runs_total", "repro_scrape_timestamp_seconds"):
        assert f"# TYPE {name} " in text
    assert by_id["d24"].error.code == protocol.E_UNAVAILABLE


def test_rollover_rebuilds_lasso_on_the_hub_device(banks, monkeypatch):
    """Without the hub's device a lasso bank would default to the card:
    with CUDA absent the rollover is refused as a bad payload."""
    svc = _service(PORT, banks)
    server = rpc.LatencyRPCServer(svc, auto_start_batcher=False)
    try:
        out = server._rollover({"setting": "float32/op_by_op", "bank": banks["lasso2"],
                                "family": "lasso"})
        assert out["epoch"] == svc.hub.epoch_of(DeviceSetting(*SOURCE), "lasso")
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        svc.hub.device = "cuda"
        with pytest.raises(RPCError) as ei:
            server._rollover({"setting": "float32/op_by_op", "bank": banks["lasso2"],
                              "family": "lasso"})
        assert ei.value.code == protocol.E_BAD_REQUEST
        assert "CUDA is not available" in ei.value.message
    finally:
        server.stop()


# -- a live TCP server on the port's torch host tier ------------------------------------

def test_socket_pipelined_requests_coalesce_on_the_torch_tier(banks):
    svc = _service(PORT, banks, backend="auto")
    server = rpc.LatencyRPCServer(svc, policy=rpc.BatchPolicy(
        max_batch=8, max_wait_ticks=50, max_queue=256))
    host, port = server.start()
    gs = [PORT.graph(s) for s in range(310, 326)]
    try:
        with rpc.LatencyClient(host, port, timeout=30.0) as cli:
            reports = cli.predict_pipelined(gs, DeviceSetting(*SOURCE))
            again = cli.predict_e2e(gs[0])
            banks_seen = cli.available()
        st = server.batcher.stats()
    finally:
        server.stop()
    direct = _service(PORT, banks, backend="torch").predict_batch(gs)
    # rtol 1e-5: the torch tier scores the same float32 leaves; only the
    # order of the float32 sum over trees depends on the rows a flush holds.
    np.testing.assert_allclose([r.e2e_s for r in reports], [d.e2e_s for d in direct],
                               rtol=1e-5)
    assert [r.fingerprint for r in reports] == [g.fingerprint() for g in gs]
    assert again.from_cache and again.e2e_s == reports[0].e2e_s
    assert ["float32/op_by_op", "gbdt"] in banks_seen
    assert st["answered"] == st["submitted"] == 17 and st["short_circuits"] == 1
    assert st["batches"] < 16 and st["max_batch_observed"] >= 2
    assert set(st["flush_backends"]) == {"torch"}
    assert svc.stats()["device_fused_runs"] == st["flush_backends"]["torch"]


def test_socket_errors_and_server_loss(banks):
    svc = _service(PORT, banks)
    server = rpc.LatencyRPCServer(svc)
    host, port = server.start()
    cli = rpc.LatencyClient(host, port, timeout=10.0)
    try:
        with pytest.raises(RPCError) as ei:
            cli.call("no_such_method", {})
        assert ei.value.code == protocol.E_UNKNOWN_METHOD
        with pytest.raises(RPCError) as ei:
            cli.predict_e2e(PORT.graph(340), DeviceSetting(*UNKNOWN))
        assert ei.value.code == protocol.E_UNKNOWN_SETTING
        multi = cli.predict_multi([PORT.graph(s) for s in (330, 331)],
                                  [DeviceSetting(*SOURCE)])
        assert list(multi) == ["float32/op_by_op"]
        server.stop()
        deadline = time.monotonic() + 5
        while time.monotonic() < deadline:
            try:
                cli.call("available", {}, timeout=0.2)
            except RPCError as exc:
                if exc.code == protocol.E_UNAVAILABLE:
                    break
            time.sleep(0.01)
        with pytest.raises(RPCError) as ei:
            cli.call("available", {}, timeout=0.5)
        assert ei.value.code == protocol.E_UNAVAILABLE and ei.value.retryable
    finally:
        cli.close()
        server.stop()
    with pytest.raises(RPCError) as ei:
        cli.call("available", {})
    assert not ei.value.retryable


# -- the closed loop behind the server (tests/test_autopilot.py TestMidFloodRollover) ----

TGT = ("edge_f32", "float32", "op_by_op", "edge0")


def _fleet():
    src, tgt = DeviceSetting(*SOURCE), DeviceSetting(*TGT)
    device = transfer.SyntheticDevice("edge0", seed=7, noise=0.05, curvature=0.1)
    graphs = synthetic_graphs(12, resolution=16)
    store = ProfileStore()
    sess = transfer.CostModelProfileSession(store=store, seed=1)
    for g in graphs:
        sess.profile_graph(g, src)
    hub = PredictorHub(device=CPU)
    hub.train(store, src, "gbdt", hparams={"n_stages": 30}, min_samples=3)
    transfer.TransferEngine(src, tgt, family="gbdt", seed=0).adapt(
        store, hub, transfer.ReplayProfileSession(store, device, src), 32)
    return store, graphs, hub, device


def _observe_round(store, svc, bundle, device, n=48):
    sess = transfer.ReplayProfileSession(store, device, DeviceSetting(*SOURCE))
    obs.attach_session_drift(sess, svc, bundle.drift)
    for rec in store.op_records(DeviceSetting(*SOURCE))[:n]:
        sess.measure_record(rec, DeviceSetting(*TGT))


def test_rollover_mid_flood_conserves_requests():
    threads_n, per = 8, 6
    clock = rpc.ManualClock()
    bundle = obs.Observability(clock=clock, seed=9, drift_threshold=0.5, drift_min_count=4)
    store, graphs, hub, device = _fleet()
    svc = LatencyService(hub, default_setting=DeviceSetting(*SOURCE), predictor="gbdt",
                         inference_backend="numpy", obs=bundle, device=CPU)
    tl = obs.MetricsTimeline(clock=clock, interval=1, capacity=256)
    tl.track("drift_score", bundle.drift.score)
    eng = obs.AlertEngine(tl, [obs.AlertRule("drift", series="drift_score",
                                             threshold=1.0, sustain=3)], obs=bundle)
    drifted = device.warp_shift(scale=2.4, seed_offset=3)
    ap = obs.RecalibrationAutopilot(bundle, eng, hub, store, DeviceSetting(*SOURCE),
                                    config=obs.AutopilotConfig(budget_k=48, cooldown=4.0,
                                                               seed=0))
    ap.register_device(DeviceSetting(*TGT), lambda: transfer.ReplayProfileSession(
        store, drifted, DeviceSetting(*SOURCE)))
    epoch0 = hub.epoch_of(DeviceSetting(*TGT), "gbdt")
    server = rpc.LatencyRPCServer(svc, obs=bundle, autopilot=ap, policy=rpc.BatchPolicy(
        max_batch=8, max_wait_ticks=5, max_queue=1024))
    host, port = server.start()
    errs, epochs_seen = [], set()

    def worker(t):
        try:
            with rpc.LatencyClient(host, port, timeout=30.0) as c:
                for i in range(per):
                    rep = c.predict_e2e(graphs[(t + i) % len(graphs)], DeviceSetting(*TGT))
                    epochs_seen.add(rep.bank_epoch)
                    assert rep.e2e_s > 0
                assert c.retries == 0
        except Exception as exc:                   # surfaced after the join
            errs.append(exc)

    threads = [threading.Thread(target=worker, args=(t,)) for t in range(threads_n)]
    try:
        for t in threads:
            t.start()
        deadline = time.monotonic() + 120
        while any(t.is_alive() for t in threads) and time.monotonic() < deadline:
            _observe_round(store, svc, bundle, drifted)
            clock.advance(1)
            ap.step()
        _join(threads)
        assert not errs, errs
        for _ in range(12):
            if ap.actions:
                break
            _observe_round(store, svc, bundle, drifted)
            clock.advance(1)
            ap.step()
        with rpc.LatencyClient(host, port, timeout=30.0) as probe:
            snap = probe.metrics()["snapshot"]
            out = probe.metrics(timeline=True, audit=True)
            health = probe.health()
    finally:
        server.stop()
    n = threads_n * per
    assert len(ap.actions) >= 1
    epoch1 = hub.epoch_of(DeviceSetting(*TGT), "gbdt")
    assert epoch1 > epoch0 and bundle.drift.score() < 1.0
    assert all(epoch0 <= e <= epoch1 for e in epochs_seen)
    c = snap["counters"]
    assert sum(c["rpc_batcher_submitted_total"].values()) == n
    assert sum(c["rpc_batcher_answered_total"].values()) == n
    assert sum(c.get("rpc_batcher_failed_total", {}).values()) == 0
    assert sum(c.get("rpc_batcher_rejected_total", {}).values()) == 0
    assert sum(c["autopilot_actions_total"].values()) == len(ap.actions)
    assert out["timeline"]["samples"] == tl.samples
    kinds = [e["kind"] for e in out["audit"]]
    assert "autopilot.rollover" in kinds and "alert.fire" in kinds
    assert health["autopilot"]["actions"] == len(ap.actions)
    assert health["metrics"]["drift_top"] is None or \
        health["metrics"]["drift_top"]["setting"] == "edge0:float32/op_by_op"
    assert "autopilot" in snap["collected"] and "tree_gather" in snap["collected"]
    assert snap["collected"]["alerts"]["consumed"] == tl.samples


def test_metrics_timeline_requires_autopilot():
    srv = rpc.LatencyRPCServer(
        LatencyService(PredictorHub(device=CPU), default_setting=DeviceSetting(*SOURCE),
                       device=CPU),
        obs=obs.Observability(), auto_start_batcher=False)
    try:
        for q in ({"timeline": True}, {"audit": True}):
            with pytest.raises(RPCError):
                srv._metrics(q)
    finally:
        srv.stop()


# -- ServeEngine over the wire -----------------------------------------------------------

class _StubModel:
    def init_cache(self, slots, max_len, device=None):
        return {"pos": 0}

    def decode_step(self, params, batch, cache):
        logits = torch.arange(8.0).repeat(batch["token"].shape[0], 1)
        return logits, {"pos": cache["pos"] + 1}


def test_serve_engine_takes_its_step_estimate_through_the_port_client(banks):
    from repro_torch.serving import ServeEngine

    svc = _service(PORT, banks)
    server = rpc.LatencyRPCServer(svc)
    host, port = server.start()
    step = PORT.graph(400)
    try:
        with rpc.LatencyClient(host, port, timeout=30.0) as cli:
            eng = ServeEngine(_StubModel(), params={}, batch_slots=2, max_len=16,
                              latency_service=cli, step_graph=step,
                              latency_setting=DeviceSetting(*SOURCE), device=CPU)
            eng.submit(np.array([1, 2, 3]), max_new_tokens=2)
            done = eng.run(max_steps=10)
    finally:
        server.stop()
    direct = _service(PORT, banks).predict_e2e(step, DeviceSetting(*SOURCE))
    assert eng.predicted_step_s == direct.e2e_s
    assert eng.stats()["prediction_source"] == "LatencyClient"
    assert eng.estimate_request_s(4, 8) == pytest.approx(direct.e2e_s * 11)
    assert len(done) == 1
