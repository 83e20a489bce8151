"""The port's observability layer (repro_torch.obs) held against the reference's.

Each test runs one script through both packages — the same seed, a manual
clock with the same ``now``/``advance`` interface as the reference's
`ManualClock` — and compares what comes out byte for byte: registry
snapshots, the Prometheus exposition (the committed golden file), span
exports, flight-recorder dumps, timelines, alert events and the audit
log.  The closed recalibration loop of `tests/test_autopilot.py` is rebuilt
on both packages (every service on the numpy tier, the port's hubs on the
host); its actions, audit, timeline, spans and hub epochs must be
identical.  Last, the port's `LatencyService` and `ServeEngine` keep their
counters in the registry under the reference's names and counts.  No test
reads the wall clock.
"""
import json
import os
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro import obs as ref_obs  # noqa: E402
from repro import transfer as ref_transfer  # noqa: E402
from repro.core.dataset import synthetic_graphs as ref_graphs  # noqa: E402
from repro.core.profiler import DeviceSetting as RefSetting  # noqa: E402
from repro.pipeline import LatencyService as RefService  # noqa: E402
from repro.pipeline import PredictorHub as RefHub  # noqa: E402
from repro.pipeline import ProfileStore as RefStore  # noqa: E402

from repro_torch import obs, transfer  # noqa: E402
from repro_torch.core.dataset import synthetic_graphs  # noqa: E402
from repro_torch.core.profiler import DeviceSetting  # noqa: E402
from repro_torch.pipeline import LatencyService, PredictorHub, ProfileStore  # noqa: E402

# One intra-op thread per xdist worker's share of the cores: these tests
# run beside the reference's wall-clock profiling tests.
torch.set_num_threads(max(1, (os.cpu_count() or 1)
                          // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

ROOT = os.path.join(os.path.dirname(__file__), "..")
GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "metrics_prometheus.txt")
CPU = "cpu"


class Clock:
    """A manual clock: ``now`` reads it, ``advance`` moves it."""

    def __init__(self, t: float = 0.0):
        self.t = float(t)

    def now(self) -> float:
        return self.t

    def advance(self, dt: float) -> float:
        self.t += float(dt)
        return self.t


# Both packages, one name each: (obs, transfer, DeviceSetting, hub, store,
# service, synthetic graphs, hub kwargs).
PORT = (obs, transfer, DeviceSetting, PredictorHub, ProfileStore, LatencyService,
        synthetic_graphs, {"device": CPU})
REF = (ref_obs, ref_transfer, RefSetting, RefHub, RefStore, RefService, ref_graphs, {})


def _svc_kw(pkg):
    return {"device": CPU} if pkg is PORT else {}


# -- registry and exposition --------------------------------------------------------

def _registry_script(o):
    reg = o.MetricsRegistry()
    ids = [reg.instance("service"), reg.instance("service"), reg.instance("engine")]
    reg.inc("req_total", 3, k="x")
    reg.inc("req_total", 2, k="y", svc="a")
    reg.set("depth", 7.25)
    reg.set_max("peak", 3.0)
    reg.set_max("peak", 2.0)
    reg.histogram("lat", buckets=o.log_buckets(1e-6, 10.0, 4))
    for v in np.geomspace(2e-6, 3.0, 37):
        reg.observe("lat", float(v), svc="a")
    reg.histogram("size", buckets=o.DEFAULT_SIZE_BUCKETS)
    for v in (1, 3, 64, 1000):
        reg.observe("size", v)
    reg.collect("extra", lambda: {"b": 2, "a": [1, 2.0]})
    return {"ids": ids, "snap": reg.snapshot_json(),
            "q": [reg.hist_quantile("lat", q, svc="a") for q in (0.1, 0.5, 0.99)],
            "stats": reg.hist_stats("lat", svc="a"),
            "labeled": reg.labeled_values("req_total", "k"),
            "total": reg.total("req_total"),
            "prom": o.to_prometheus(reg.snapshot(include_collected=False), now=77.0),
            "json": o.snapshot_to_json(reg.snapshot())}


def test_registry_and_exports_equal_reference():
    assert _registry_script(obs) == _registry_script(ref_obs)
    assert obs.DEFAULT_TIME_BUCKETS == ref_obs.DEFAULT_TIME_BUCKETS
    reg = obs.MetricsRegistry()
    reg.counter("x_total")
    with pytest.raises(ValueError, match="already registered"):
        reg.gauge("x_total")


def _golden_registry(o):
    """`tests/test_autopilot.py::TestPrometheusHelp.build`."""
    reg = o.MetricsRegistry()
    reg.inc("rpc_batcher_submitted_total", 5, batcher="batcher0")
    reg.inc("obs_flight_dumps_total", 2, reason="alert")
    reg.set("rpc_batcher_queue_depth", 3, batcher="batcher0")
    reg.histogram("rpc_batcher_flush_duration", buckets=(0.001, 0.01, 0.1))
    reg.observe("rpc_batcher_flush_duration", 0.005, batcher="batcher0")
    reg.inc("custom_widget_total", 1)
    return reg


def test_prometheus_matches_the_golden_bytes():
    with open(GOLDEN) as f:
        want = f.read()
    text = obs.to_prometheus(_golden_registry(obs).snapshot(include_collected=False),
                             now=1234.5)
    assert text == want
    assert "repro_scrape_timestamp_seconds 1234.5" in text
    assert obs.METRIC_HELP == ref_obs.METRIC_HELP
    assert "repro_scrape_timestamp_seconds" not in obs.to_prometheus(
        _golden_registry(obs).snapshot(include_collected=False))


def _string_literals(root, skip):
    out = set()
    for dirpath, _dirs, files in os.walk(root):
        for fn in files:
            path = os.path.join(dirpath, fn)
            if fn.endswith(".py") and os.path.abspath(path) != os.path.abspath(skip):
                with open(path) as f:
                    out.update(re.findall(r'"([a-z0-9_]+)"', f.read()))
    return out


def test_metric_help_orphans_equal_reference():
    """Every curated HELP entry is emitted by the port exactly where the
    reference emits it: the same literal scan of both trees finds the same
    orphans (names both packages build with f-strings, as the batcher does
    for most ``rpc_batcher_*`` counters, or never emit).  The map's own
    file is left out of the scan: its keys would match themselves."""
    port_src = os.path.join(ROOT, "src", "repro_torch")
    ref_src = os.path.join(ROOT, "src", "repro")
    port = _string_literals(port_src, os.path.join(port_src, "obs", "export.py"))
    ref = _string_literals(ref_src, os.path.join(ref_src, "obs", "export.py"))
    names = set(obs.METRIC_HELP) - {"repro_scrape_timestamp_seconds"}
    orphans = {n for n in names if n not in port}
    assert orphans == {n for n in names if n not in ref}
    assert len(orphans) < len(names)
    assert {"serve_steps_total", "serve_step_duration", "service_backend_runs_total",
            "rpc_batcher_queue_depth", "rpc_batcher_flush_duration",
            "rpc_client_requests_total", "rpc_client_retries_total"} <= names - orphans


# -- tracing and the flight recorder --------------------------------------------------

def _trace_script(o):
    clock = Clock()
    rec = o.FlightRecorder(capacity=4, max_dumps=2)
    tr = o.Tracer(clock=clock, seed=3, recorder=rec, capacity=8)
    with tr.span("outer", attrs={"k": 1}) as outer:
        clock.advance(1)
        with tr.span("inner"):
            clock.advance(0.5)
            tr.event("tick", attrs={"n": 2})
        ctx = tr.wire_context(outer)
    remote = tr.start_span("remote", trace=ctx)
    clock.advance(2)
    remote.end("error")
    with tr.activate(tr.start_span("ambient")) as amb:
        tr.start_span("child").end()
    amb.end()
    try:
        with tr.span("boom"):
            raise RuntimeError("x")
    except RuntimeError:
        pass
    for i in range(3):
        tr.start_span(f"fill{i}").end()
    dumps = [rec.dump(f"r{i}", {"i": i}) for i in range(3)]
    off = o.Tracer(enabled=False)
    return {"export": json.dumps(tr.export(), sort_keys=True),
            "dumps": json.dumps(dumps, sort_keys=True), "stats": rec.stats(),
            "valid": [o.validate_dump(d) for d in dumps],
            "noop": off.start_span("x") is o.NOOP_SPAN and
            off.wire_context(off.start_span("y")) is None}


def test_tracer_and_recorder_equal_reference():
    assert _trace_script(obs) == _trace_script(ref_obs)


# -- timeline, alerts, audit, drift ---------------------------------------------------

def _control_plane_script(o):
    clock = Clock()
    ob = o.Observability(clock=clock, seed=5, drift_threshold=0.25, drift_min_count=2)
    tl = o.MetricsTimeline(clock=clock, interval=1, capacity=8)
    cur = {"v": 0.0}
    tl.track("s", lambda: cur["v"])
    tl.track("score", ob.drift.score)
    tl.track_counter(ob.registry, "hits_total")
    tl.track_quantile(ob.registry, "lat", 0.5)
    ob.registry.histogram("lat", buckets=(0.1, 1.0, 10.0))
    rules = [o.AlertRule("r", series="s", threshold=1.0, sustain=2,
                         clear_threshold=0.5),
             o.AlertRule("d", series="s", threshold=5.0, mode="delta"),
             o.AlertRule("drift", series="score", threshold=1.0)]
    eng = o.AlertEngine(tl, rules, obs=ob)
    events = []
    for t, v in enumerate([0.2, 2.0, 2.0, 0.8, 0.4, 9.0, 9.0, 0.1, 3.0, 3.0], 1):
        clock.advance(1)
        cur["v"] = v
        ob.registry.inc("hits_total", t)
        ob.registry.observe("lat", 0.05 * t)
        ob.drift.observe("dev", "conv2d", 0.01, 0.01 * (1 + 0.3 * t))
        ob.drift.observe("dev", "dense", 0.02, 0.019)
        tl.sample()
        events.extend(eng.evaluate())
    return {"events": json.dumps(events, sort_keys=True),
            "audit": eng.audit.json_text(), "timeline": tl.json_text(),
            "windows": tl.windows("s", 3.0), "firing": eng.firing(),
            "stats": [tl.stats(), eng.stats()],
            "drift": json.dumps(ob.drift.snapshot(), sort_keys=True),
            "worst": ob.drift.worst_cells(3),
            "spans": json.dumps(ob.tracer.export(), sort_keys=True),
            "snap": ob.snapshot_json(), "prom": ob.prometheus()}


def test_timeline_alerts_audit_and_drift_equal_reference():
    port, ref = _control_plane_script(obs), _control_plane_script(ref_obs)
    assert port == ref
    assert json.loads(port["events"])          # the script fires something


def test_welford_equals_reference():
    xs = np.random.default_rng(0).standard_normal(50)
    a, b = obs.Welford(), ref_obs.Welford()
    for x in xs:
        a.add(float(x))
        b.add(float(x))
    assert a.to_json() == b.to_json()
    assert obs.Welford.from_json(json.loads(json.dumps(a.to_json()))).to_json() == \
        a.to_json()


# -- the service and the engine on the registry ---------------------------------------

SRC = ("cpu_f32", "float32", "op_by_op")


def _served(pkg, clock):
    o, tr, Setting, Hub, Store, Service, graphs_fn, hub_kw = pkg
    graphs = graphs_fn(10, resolution=16)
    store = Store()
    sess = tr.CostModelProfileSession(store=store, seed=1)
    for g in graphs:
        sess.profile_graph(g, Setting(*SRC))
    hub = Hub(**hub_kw)
    hub.train(store, Setting(*SRC), "gbdt", hparams={"n_stages": 10}, min_samples=3,
              fingerprints=[g.fingerprint() for g in graphs[:8]])
    bundle = o.Observability(clock=clock, seed=0)
    return graphs, store, hub, bundle


@pytest.mark.parametrize("backend", ["numpy", "device"])
def test_service_counts_and_spans_equal_reference(backend):
    outs = []
    for pkg in (PORT, REF):
        clock = Clock()
        graphs, _, hub, bundle = _served(pkg, clock)
        tier = ("numpy" if backend == "numpy" else
                "torch" if pkg is PORT else "jax")
        svc = pkg[5](hub, default_setting=pkg[2](*SRC), predictor="gbdt",
                     inference_backend=tier, obs=bundle, **_svc_kw(pkg))
        svc.predict_batch(graphs[:6])
        clock.advance(1)
        svc.predict_batch(graphs[4:])
        svc.cache_peek(graphs[0])
        svc.predict_e2e(graphs[1])
        stats = svc.stats()
        snap = json.loads(bundle.snapshot_json(include_collected=False))
        spans = bundle.tracer.export()
        outs.append((stats, snap, spans))
    (stats, snap, spans), (rstats, rsnap, rspans) = outs
    for k in ("size", "hits", "misses", "predict_batch_calls", "device_fused_runs",
              "hub_epoch"):
        assert stats[k] == rstats[k]
    tier_name = {"torch": "jax"} if backend == "device" else {}
    renamed = lambda d: {tier_name.get(k, k): v for k, v in d.items()}   # noqa: E731
    assert renamed(stats["backend_runs"]) == rstats["backend_runs"]
    counters = snap["counters"]
    assert set(counters) == set(rsnap["counters"]) >= {
        "service_predict_batch_calls_total", "service_cache_hits_total",
        "service_cache_misses_total", "service_device_fused_runs_total",
        "service_backend_runs_total"}
    for name, vals in counters.items():
        want = rsnap["counters"][name]
        if name == "service_backend_runs_total":
            vals = {k.replace("backend=torch", "backend=jax"): v for k, v in vals.items()}
        assert vals == want, name
    assert counters["service_predict_batch_calls_total"] == {"service=service0": 3}
    if backend == "device":
        for s in spans:
            if s["attrs"].get("backend") == "torch":
                s["attrs"]["backend"] = "jax"
    assert json.dumps(spans, sort_keys=True) == json.dumps(rspans, sort_keys=True)
    names = [s["name"] for s in spans]
    assert names.count("service.predict_batch") == 3
    kernel = [s for s in spans if s["name"] == "service.kernel"]
    assert len(kernel) == sum(stats["backend_runs"].values())
    assert all(s["status"] == "ok" for s in spans)


def test_service_span_ends_in_error_when_the_bank_is_missing():
    clock = Clock()
    bundle = obs.Observability(clock=clock, seed=0)
    svc = LatencyService(PredictorHub(device=CPU), default_setting=DeviceSetting(*SRC),
                         obs=bundle, device=CPU)
    with pytest.raises(KeyError):
        svc.predict_batch(synthetic_graphs(1, resolution=16))
    (span,) = bundle.tracer.export()
    assert (span["name"], span["status"]) == ("service.predict_batch", "error")
    assert svc.stats()["predict_batch_calls"] == 1 and svc.stats()["misses"] == 1


class _PortStub:
    def init_cache(self, slots, max_len, device=None):
        return {}

    def decode_step(self, params, batch, cache):
        return torch.zeros((batch["token"].shape[0], 4)), cache


def _ref_stub():
    import jax.numpy as jnp

    class Stub:
        def init_cache(self, slots, max_len):
            return {}

        def decode_step(self, params, batch, cache):
            return jnp.zeros((batch["token"].shape[0], 4)), cache
    return Stub()


@pytest.mark.parametrize("predicted", [None, 1.0])
def test_serve_engine_registry_and_drift_equal_reference(predicted):
    from repro.serving.engine import ServeEngine as RefEngine
    from repro_torch.serving.engine import ServeEngine

    outs = []
    for make in (lambda o: ServeEngine(_PortStub(), {}, batch_slots=2, obs=o,
                                       device=CPU),
                 lambda o: RefEngine(_ref_stub(), {}, batch_slots=2, obs=o)):
        bundle = (obs if not outs else ref_obs).Observability(seed=1)
        eng = make(bundle)
        eng.predicted_step_s = predicted
        eng.submit(np.array([1, 2], np.int32), max_new_tokens=2)
        eng.submit(np.array([3], np.int32), max_new_tokens=3)
        eng.run(max_steps=8)
        st = eng.stats()
        h = bundle.registry.hist_stats("serve_step_duration", engine="engine0")
        cell = bundle.drift.cell("serve", "decode_step")
        outs.append({"steps": st["steps"],
                     "counter": bundle.registry.get("serve_steps_total",
                                                    engine="engine0"),
                     "hist_count": h["count"], "sum_is_mean": (
                         st["measured_step_s"] == h["sum"] / st["steps"]),
                     "names": sorted(json.loads(bundle.snapshot_json(False))["counters"]),
                     "drift_n": None if cell is None else cell.n,
                     "drift_sign": None if cell is None else bool(cell.mean < 0)})
    assert outs[0] == outs[1]
    assert outs[0]["steps"] == outs[0]["counter"] == outs[0]["hist_count"] > 0
    assert outs[0]["drift_n"] == (outs[0]["steps"] if predicted else None)


def test_session_drift_equals_reference():
    outs = []
    for pkg in (PORT, REF):
        o, tr, Setting = pkg[0], pkg[1], pkg[2]
        graphs, _, hub, _ = _served(pkg, Clock())
        svc = pkg[5](hub, default_setting=Setting(*SRC), predictor="gbdt",
                     inference_backend="numpy", **_svc_kw(pkg))
        monitor = o.DriftMonitor(min_count=1)
        session = tr.CostModelProfileSession(store=pkg[4](), seed=3)
        o.attach_session_drift(session, svc, monitor)
        for g in pkg[6](3, resolution=16, seed0=321):
            session.profile_graph(g, Setting(*SRC))
        outs.append((json.dumps(monitor.snapshot(), sort_keys=True),
                     session.measured_ops))
    assert outs[0] == outs[1]
    assert json.loads(outs[0][0])["observations"] > 0


# -- the closed loop (tests/test_autopilot.py TestClosedLoop) on both packages ----------

TGT = ("edge_f32", "float32", "op_by_op", "edge0")
TGT_KEY = "edge0:float32/op_by_op"


def _closed_loop(pkg):
    o, tr, Setting, Hub, Store, Service, graphs_fn, hub_kw = pkg
    src, tgt = Setting(*SRC), Setting(*TGT)
    device = tr.SyntheticDevice("edge0", seed=7, noise=0.05, curvature=0.1)
    graphs = graphs_fn(12, resolution=16)
    store = Store()
    sess = tr.CostModelProfileSession(store=store, seed=1)
    for g in graphs:
        sess.profile_graph(g, src)
    hub = Hub(**hub_kw)
    hub.train(store, src, "gbdt", hparams={"n_stages": 30}, min_samples=3)
    tr.TransferEngine(src, tgt, family="gbdt", seed=0).adapt(
        store, hub, tr.ReplayProfileSession(store, device, src), 32)

    clock = Clock()
    bundle = o.Observability(clock=clock, seed=21, drift_threshold=0.5,
                             drift_min_count=4)
    svc = Service(hub, default_setting=src, predictor="gbdt",
                  inference_backend="numpy", obs=bundle, **_svc_kw(pkg))
    tl = o.MetricsTimeline(clock=clock, interval=1, capacity=256)
    tl.track("drift_score", bundle.drift.score)
    eng = o.AlertEngine(tl, [o.AlertRule("drift", series="drift_score",
                                         threshold=1.0, sustain=3)], obs=bundle)
    drifted = device.warp_shift(scale=2.4, seed_offset=3)
    ap = o.RecalibrationAutopilot(
        bundle, eng, hub, store, src,
        config=o.AutopilotConfig(budget_k=48, top_k_cells=3, cooldown=4.0,
                                 window=64.0, max_actions_per_window=2, seed=0))
    ap.register_device(tgt, lambda: tr.ReplayProfileSession(store, drifted, src))
    epoch0 = hub.epoch_of(tgt, "gbdt")
    for _ in range(10):
        rsess = tr.ReplayProfileSession(store, drifted, src)
        o.attach_session_drift(rsess, svc, bundle.drift)
        for rec in store.op_records(src)[:48]:
            rsess.measure_record(rec, tgt)
        clock.advance(1)
        ap.step()
    bank = hub.get(tgt, "gbdt")
    return {"epochs": (epoch0, hub.epoch_of(tgt, "gbdt")), "all_epochs": hub.epochs(),
            "actions": [dict(a) for a in ap.actions], "status": ap.status(),
            "audit": ap.audit.json_text(),
            "spans": json.dumps(bundle.tracer.export(), sort_keys=True),
            "timeline": tl.json_text(), "final_score": bundle.drift.score(),
            "snap": bundle.snapshot_json(include_collected=False),
            "bank": json.dumps(bank.to_json()),
            "scratch_device": getattr(hub, "device", None)}


def test_closed_loop_equals_reference():
    port, ref = _closed_loop(PORT), _closed_loop(REF)
    assert port.pop("scratch_device") == CPU and ref.pop("scratch_device") is None
    for key in port:
        assert port[key] == ref[key], key
    (act,) = port["actions"]
    assert act["setting"] == TGT_KEY and 0 < act["n_measurements"] <= 48
    assert port["epochs"][1] > port["epochs"][0]
    assert port["final_score"] < 1.0
    kinds = [e["kind"] for e in json.loads(port["audit"])]
    for k in ("alert.fire", "autopilot.plan", "autopilot.recalibrate",
              "autopilot.rollover", "autopilot.drift_reset"):
        assert kinds.count(k) == 1


def test_autopilot_error_is_audited_on_the_port():
    clock = Clock()
    bundle = obs.Observability(clock=clock, seed=2, drift_min_count=1)
    tl = obs.MetricsTimeline(clock=clock, interval=1)
    tl.track("drift_score", bundle.drift.score)
    eng = obs.AlertEngine(tl, [obs.AlertRule("drift", series="drift_score",
                                             threshold=1.0, clear_threshold=0.1)],
                          obs=bundle)
    ap = obs.RecalibrationAutopilot(bundle, eng, PredictorHub(device=CPU),
                                    ProfileStore(), DeviceSetting(*SRC),
                                    config=obs.AutopilotConfig(cooldown=100.0),
                                    rollout=lambda *_a: 1)
    calls = []
    ap.register_device(DeviceSetting(*TGT), lambda: calls.append(1))
    bundle.drift.observe(TGT_KEY, "conv2d", 0.01, 0.05)
    clock.advance(1)
    ap.step()
    assert ap.audit.events("autopilot.error") and not calls


# -- spans inside a training step (repro_torch.obs.tracing) ----------------------------

def _names(tracer):
    return [s["name"] for s in tracer.export()]


@pytest.mark.parametrize("mode", ["off", "tracer", "profiler"])
def test_train_spans_follow_the_switch(mode):
    """Off (a quiet tracer, no profiler): every site returns NOOP_SPAN and
    nothing is recorded.  With the tracer enabled, or under torch.profiler,
    the step's spans are recorded under one trace id, and under the
    profiler each is also listed as an op of its name (not a user
    annotation)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.obs import tracing

    tracer = obs.Tracer(clock=Clock(), seed=1, enabled=mode == "tracer")

    def step():
        with tracing.train_step(tracer) as root:
            with tracing.train_span("train.forward") as fwd:
                torch.ones(4).sum()
            return root, fwd

    if mode == "profiler":
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            root, fwd = step()
        events = {e.name: e.is_user_annotation for e in prof.events()}
        assert events["train.step"] is False and events["train.forward"] is False
    else:
        root, fwd = step()
    assert tracing.train_span("train.forward") is obs.NOOP_SPAN
    if mode == "off":
        assert root is obs.NOOP_SPAN and fwd is obs.NOOP_SPAN and tracer.export() == []
        return
    spans = tracer.export()
    assert [s["name"] for s in spans] == ["train.forward", "train.step"]
    assert spans[0]["parent"] == spans[1]["sid"] and spans[1]["parent"] is None
    assert len({s["tid"] for s in spans}) == 1 and all(s["status"] == "ok" for s in spans)


def test_train_span_on_another_thread_takes_the_stepping_threads_parent():
    """A span opened on a thread with no span of its own (the autograd
    engine's, on the card) is parented to the stepping thread's innermost
    span."""
    import threading

    from repro_torch.obs import tracing

    tracer = obs.Tracer(clock=Clock(), seed=1)
    with tracing.train_step(tracer):
        with tracing.train_span("train.backward"):
            worker = threading.Thread(target=lambda: tracing.train_span("x.bwd").__enter__()
                                      .__exit__(None, None, None))
            worker.start()
            worker.join(timeout=30)
    assert not worker.is_alive()
    by = {s["name"]: s for s in tracer.export()}
    assert by["x.bwd"]["parent"] == by["train.backward"]["sid"]


def _graph_names(t):
    seen, todo = set(), [t.grad_fn]
    while todo:
        fn = todo.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        todo.extend(f for f, _ in fn.next_functions)
    return {type(fn).__name__ for fn in seen}


@pytest.mark.parametrize("traced", [False, True])
def test_a_marked_region_spans_its_backward_and_keeps_the_bits(traced):
    """``inputs``/``output`` of a live span put identity nodes around the
    region, whose backward opens ``<name>.bwd`` when the output's gradient
    arrives and ends it once every input's is ready; values and gradients
    are the same bits as unmarked; off, no node is added."""
    from repro_torch.obs import tracing

    gen = torch.Generator().manual_seed(0)
    a = torch.randn(5, 3, generator=gen, requires_grad=True)
    b = torch.randn(3, 4, generator=gen, requires_grad=True)
    c = torch.arange(4.0)                         # needs no gradient

    def run():
        with tracing.train_span("r") as r:
            x, y, z = r.inputs(a * 2, b, c)
            out = r.output(torch.tanh(x @ y) + z)
        return out, torch.autograd.grad((out * out).sum(), [a, b])

    want, want_g = run()
    tracer = obs.Tracer(clock=Clock(), seed=1, enabled=traced)
    with tracing.train_step(tracer):
        with tracing.train_span("train.backward"):
            got, got_g = run()
    assert torch.equal(got, want) and all(torch.equal(g, w) for g, w in zip(got_g, want_g))
    marks = {"_RegionInBackward", "_RegionOutBackward"}
    assert (marks <= _graph_names(got)) == traced
    assert not marks & _graph_names(want)
    if traced:
        by = {s["name"]: s for s in tracer.export()}
        assert by["r.bwd"]["parent"] == by["train.backward"]["sid"]
        assert by["r.bwd"]["status"] == "ok" and by["r"]["parent"] == by["train.backward"]["sid"]
    else:
        assert tracer.export() == []


def test_export_reads_tensor_counters():
    from repro_torch.obs import tracing

    tracer = obs.Tracer(clock=Clock(), seed=1)
    with tracing.train_step(tracer):
        with tracing.train_span("moe.route") as sp:
            sp.set_attr("rows", 8)
            sp.set_attr("filled", (torch.arange(8) < 5).sum())
    first = tracer.export()
    assert first[0]["attrs"] == {"rows": 8, "filled": 5}
    assert type(first[0]["attrs"]["filled"]) is int and tracer.export() == first
