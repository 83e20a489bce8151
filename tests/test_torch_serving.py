"""The port's serving engine (repro_torch.serving.ServeEngine) held against
the reference engine (repro.serving.ServeEngine) on reduced Granite-MoE
with the reference's initial parameters, and its latency-prediction hook
on the port's own LatencyService.

Both engines run float32 compute with a float32 K/V cache, so the
per-step logits agree to 1e-5 (rtol and atol: the same function, float32
sums in another order) and the greedy tokens agree exactly.  The
reference engine's slot sharing is reproduced, not fixed: a slot's
prefill runs a whole decode step with token 0 in every other slot (every
slot's length advances and the other active slots get a token-0 K/V), a
freed slot's cache is not reset, and past ``max_len`` cache writes are
dropped while attention reads the whole cache.
"""
import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")
import jax  # noqa: E402

from repro.configs import get_arch as rget  # noqa: E402
from repro.models import build_model as rbuild  # noqa: E402
from repro.models import transformer as rtf  # noqa: E402
from repro.core.dataset import synthetic_graphs as ref_graphs  # noqa: E402
from repro.core.profiler import DeviceSetting as RefSetting  # noqa: E402
from repro.pipeline import ProfileStore as RefStore  # noqa: E402
from repro.serving import ServeEngine as RefEngine  # noqa: E402
from repro.transfer.synthetic import CostModelProfileSession  # noqa: E402

from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.convert import lm_params_from_reference  # noqa: E402
from repro_torch.core.dataset import synthetic_graphs  # noqa: E402
from repro_torch.core.profiler import DeviceSetting  # noqa: E402
from repro_torch.models import build_model, transformer  # noqa: E402
from repro_torch.pipeline import LatencyService  # noqa: E402
from repro_torch.rpc.protocol import RPCError  # noqa: E402
from repro_torch.serving import ServeEngine  # noqa: E402

# One intra-op thread per xdist worker's share of the cores: these tests
# run beside the reference's wall-clock profiling tests.
torch.set_num_threads(max(1, (os.cpu_count() or 1)
                          // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

TOL = 1e-5
ARCH = "granite-moe-1b-a400m"


@pytest.fixture(scope="module")
def models():
    rcfg = dataclasses.replace(rget(ARCH).reduced(), compute_dtype="float32")
    cfg = dataclasses.replace(get_arch(ARCH).reduced(), compute_dtype="float32")
    rm = dataclasses.replace(
        rbuild(rcfg), init_cache=lambda b, n: rtf.init_cache(rcfg, b, n, "float32"))
    m = dataclasses.replace(
        build_model(cfg),
        init_cache=lambda b, n, device: transformer.init_cache(
            cfg, b, n, "float32", device=device))
    rp = rm.init(jax.random.PRNGKey(1))
    p = lm_params_from_reference(jax.tree_util.tree_map(np.asarray, rp), cfg,
                                 device="cpu")
    return rm, rp, m, p


def _recording(engine, log, to_numpy):
    inner = engine._step

    def step(params, batch, cache):
        logits, cache = inner(params, batch, cache)
        log.append(to_numpy(logits))
        return logits, cache

    engine._step = step


def _engines(models, slots, max_len):
    rm, rp, m, p = models
    ref = RefEngine(rm, rp, batch_slots=slots, max_len=max_len)
    eng = ServeEngine(m, p, batch_slots=slots, max_len=max_len, device="cpu")
    logs = ([], [])
    _recording(ref, logs[0], lambda x: np.asarray(x, np.float32))
    _recording(eng, logs[1], lambda x: x.numpy())
    return ref, eng, logs


def _requests(n, seed, vocab=512):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, vocab, int(rng.integers(1, 9))).astype(np.int32),
             int(rng.integers(2, 7))) for _ in range(n)]


def _drive(engine, requests, max_steps=200):
    for prompt, new in requests:
        engine.submit(prompt, max_new_tokens=new)
    return engine.run(max_steps=max_steps)


def _same_caches(ref, eng):
    rc, c = ref.cache["layers"], eng.cache["layers"]
    np.testing.assert_array_equal(c["len"].numpy(), np.asarray(rc["len"]))
    for k in ("k", "v"):
        np.testing.assert_allclose(c[k].numpy(), np.asarray(rc[k]), rtol=TOL, atol=TOL)


def test_engine_matches_reference_engine(models):
    """More requests than slots, so freed slots are reused."""
    ref, eng, (ref_logits, logits) = _engines(models, slots=3, max_len=96)
    reqs = _requests(7, seed=0)
    ref_done, done = _drive(ref, reqs), _drive(eng, reqs)
    assert len(done) == len(ref_done) == 7
    assert [r.generated for r in done] == [r.generated for r in ref_done]
    assert all(len(r.generated) == new for r, (_, new) in zip(done, reqs))
    assert len(logits) == len(ref_logits)
    for got, want in zip(logits, ref_logits):
        np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    assert eng.stats()["steps"] == ref.stats()["steps"]
    assert set(eng.stats()) == set(ref.stats())
    _same_caches(ref, eng)


def test_prefill_of_one_slot_advances_every_slot(models):
    ref, eng, _ = _engines(models, slots=2, max_len=32)
    prompt = np.arange(1, 6, dtype=np.int32)
    for e in (ref, eng):
        e.submit(prompt, max_new_tokens=3)
        e._admit()
    c = eng.cache["layers"]
    # 4 replayed tokens: every layer's length is 4 in both slots, and the
    # idle slot 1 holds the K/V of token 0 at those positions.
    assert (c["len"] == 4).all()
    assert bool((c["k"][:, 1, :4].abs().sum(dim=(-1, -2)) > 0).all())
    assert bool((c["k"][:, 1, 4:] == 0).all())
    _same_caches(ref, eng)


def test_a_freed_slot_keeps_its_cache(models):
    ref, eng, _ = _engines(models, slots=1, max_len=48)
    reqs = [(np.array([3, 4, 5], np.int32), 2), (np.array([7, 8], np.int32), 2)]
    for e in (ref, eng):
        e.submit(*reqs[0])
        e.run()
    lens = eng.cache["layers"]["len"].clone()
    assert (lens == 4).all()                 # 2 replayed + 2 decode steps
    for e in (ref, eng):
        e.submit(*reqs[1])
        e._admit()
    assert (eng.cache["layers"]["len"] == lens + 1).all()   # not reset
    _same_caches(ref, eng)


def test_past_max_len_writes_are_dropped_as_in_the_reference(models):
    ref, eng, (ref_logits, logits) = _engines(models, slots=2, max_len=6)
    reqs = [(np.array([9, 10, 11, 12], np.int32), 6), (np.array([1], np.int32), 5)]
    ref_done, done = _drive(ref, reqs), _drive(eng, reqs)
    assert int(eng.cache["layers"]["len"].max()) > 6
    assert [r.generated for r in done] == [r.generated for r in ref_done]
    for got, want in zip(logits, ref_logits):
        np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    _same_caches(ref, eng)


# -- the latency-prediction hook ------------------------------------------------

class _StubModel:
    """Minimal decode-capable model for the engine's wiring."""

    def init_cache(self, slots, max_len, device):
        return {"pos": 0}

    def decode_step(self, params, batch, cache):
        tok = batch["token"].float()
        return torch.arange(8.0).repeat(tok.shape[0], 1) + tok, {"pos": cache["pos"] + 1}


@pytest.fixture(scope="module")
def service(tmp_path_factory):
    """A lasso bank on six size-varied graphs, as the reference's own
    serving test trains one (`tests/test_pipeline.py`), built on a store
    that the reference's hardware-free `CostModelProfileSession` wrote:
    `LatencyService.build` finds every graph there and measures nothing,
    so the predicted step does not depend on how loaded the host is."""
    setting = ("cpu_f32", "float32", "op_by_op")
    path = str(tmp_path_factory.mktemp("store") / "store.jsonl")
    ref_store = RefStore(path)
    CostModelProfileSession(store=ref_store).profile_suite(
        ref_graphs(6, resolution=16, seed0=70), RefSetting(*setting))
    ref_store.close()
    graphs = synthetic_graphs(6, resolution=16, seed0=70)
    svc = LatencyService.build(graphs, DeviceSetting(*setting), store=path,
                               predictor="lasso", device="cpu")
    assert svc.session.measured_graphs == 0
    return svc, DeviceSetting(*setting), graphs


def test_predicted_step_latency(service):
    svc, setting, graphs = service
    eng = ServeEngine(_StubModel(), params={}, batch_slots=2, max_len=16,
                      latency_service=svc, step_graph=graphs[0],
                      latency_setting=setting, device="cpu")
    assert eng.predicted_step_s is not None and eng.predicted_step_s > 0
    assert eng.predicted_step_s == svc.predict_e2e(graphs[0], setting).e2e_s
    assert eng.estimate_request_s(4, 8) == pytest.approx(eng.predicted_step_s * 11)
    eng.submit(np.array([1, 2, 3]), max_new_tokens=2)
    assert len(eng.run(max_steps=10)) == 1
    stats = eng.stats()
    assert stats["steps"] == 2 and stats["measured_step_s"] > 0
    assert stats["predicted_step_s"] == eng.predicted_step_s
    assert stats["prediction_source"] == "LatencyService"
    assert stats["measured_over_predicted"] == pytest.approx(
        stats["measured_step_s"] / eng.predicted_step_s)


def test_wire_payload_and_rpc_failure(service):
    svc, setting, graphs = service

    class Wire:
        def predict_e2e(self, graph, setting=None):
            return svc.predict_e2e(graph, setting).to_json()

    class Down:
        def predict_e2e(self, graph, setting=None):
            raise RPCError("overloaded", "shedding", retryable=True)

    eng = ServeEngine(_StubModel(), params={}, latency_service=Wire(),
                      step_graph=graphs[0], latency_setting=setting, device="cpu")
    assert eng.predicted_step_s == svc.predict_e2e(graphs[0], setting).e2e_s
    down = ServeEngine(_StubModel(), params={}, latency_service=Down(),
                       step_graph=graphs[0], latency_setting=setting, device="cpu")
    assert down.predicted_step_s is None and down.estimate_request_s(3, 2) is None
    down.submit(np.array([5]), max_new_tokens=1)
    assert len(down.run(max_steps=3)) == 1


def test_engine_without_service(service):
    eng = ServeEngine(_StubModel(), params={}, batch_slots=2, max_len=16,
                      device="cpu")
    assert eng.predicted_step_s is None
    assert eng.estimate_request_s(4, 8) is None
    assert eng.stats()["steps"] == 0 and eng.stats()["measured_step_s"] is None
