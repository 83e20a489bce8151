"""The port's NAS search (repro_torch.search) held against the reference's.

The pure-numpy pieces — genotype operators, the Pareto front, quality
proxies and budgets — are compared on seeded inputs.  Then one GBDT bank
per device setting, trained by the reference on stores its
hardware-free `CostModelProfileSession` wrote, is saved as JSON and
loaded by both packages' `LatencyService` on the numpy tier (the port's
on ``device="cpu"``).  Searches over the block, elastic and random-wired
families, under one and two budgets, must give the identical front,
generation stats and `predict_batch_calls` in both packages, and a port
checkpoint must resume bit-identically.  `SearchReport.verify` measures
the front with the port's `ProfileSession` on the host.
"""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro import search as ref_search  # noqa: E402
from repro.core.composition import PredictorBank as RefBank  # noqa: E402
from repro.core.dataset import synthetic_graphs as ref_graphs  # noqa: E402
from repro.core.nas_space import NASSpaceConfig as RefSpace  # noqa: E402
from repro.core.nas_space import RandomWiredConfig as RefRWConfig  # noqa: E402
from repro.core.nas_space import decode_genotype as ref_decode_genotype  # noqa: E402
from repro.core.nas_space import sample_random_wired as ref_sample_rw  # noqa: E402
from repro.core.profiler import DeviceSetting as RefSetting  # noqa: E402
from repro.pipeline import LatencyService as RefService  # noqa: E402
from repro.pipeline import PredictorHub as RefHub  # noqa: E402
from repro.pipeline import ProfileStore as RefStore  # noqa: E402
from repro.transfer.synthetic import CostModelProfileSession  # noqa: E402

from repro_torch import search  # noqa: E402
from repro_torch.core.composition import PredictorBank  # noqa: E402
from repro_torch.core.dataset import synthetic_graphs  # noqa: E402
from repro_torch.core.nas_space import NASSpaceConfig, RandomWiredConfig  # noqa: E402
from repro_torch.core.profiler import DeviceSetting, ProfileSession  # noqa: E402
from repro_torch.pipeline import LatencyService, PredictorHub  # noqa: E402

# One intra-op thread per xdist worker's share of the cores: these tests
# run beside the reference's wall-clock profiling tests.
torch.set_num_threads(max(1, (os.cpu_count() or 1)
                          // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

SOURCE = ("cpu_f32", "float32", "op_by_op")
TARGET = ("sim", "int8", "op_by_op", "sim")
SPACE, REF_SPACE = NASSpaceConfig(resolution=16), RefSpace(resolution=16)
RW = {"nodes_per_stage": 5}


def _rng(seed):
    return np.random.default_rng(seed), np.random.default_rng(seed)


# -- encoding ---------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 7, 42])
def test_random_genotypes_and_decode_equal_reference(seed):
    (r1, r2) = _rng(seed)
    for port_fn, ref_fn in ((search.random_genotype, ref_search.random_genotype),
                            (search.random_elastic_genotype,
                             ref_search.random_elastic_genotype)):
        gt, rgt = port_fn(r1, SPACE), ref_fn(r2, REF_SPACE)
        assert gt.to_json() == rgt.to_json() and gt.digest() == rgt.digest()
        assert search.decode(gt, SPACE).fingerprint() == \
            ref_search.decode(rgt, REF_SPACE).fingerprint()
    gt = search.random_wired(r1, RandomWiredConfig(**RW))
    rgt = ref_search.random_wired(r2, RefRWConfig(**RW))
    assert gt.to_json() == rgt.to_json()
    assert search.decode(gt, SPACE).fingerprint() == \
        ref_search.decode(rgt, REF_SPACE).fingerprint()


@pytest.mark.parametrize("family", ["block", "elastic", "random_wired"])
def test_mutation_and_crossover_chains_equal_reference(family):
    (r1, r2) = _rng(3)
    draw = {"block": (search.random_genotype, ref_search.random_genotype,
                      SPACE, REF_SPACE),
            "elastic": (search.random_elastic_genotype,
                        ref_search.random_elastic_genotype, SPACE, REF_SPACE),
            "random_wired": (search.random_wired, ref_search.random_wired,
                             RandomWiredConfig(**RW), RefRWConfig(**RW))}[family]
    a, ra = draw[0](r1, draw[2]), draw[1](r2, draw[3])
    b, rb = draw[0](r1, draw[2]), draw[1](r2, draw[3])
    for _ in range(12):
        a = search.mutate(a, r1, SPACE)
        ra = ref_search.mutate(ra, r2, REF_SPACE)
        c = search.crossover(a, b, r1, SPACE)
        rc = ref_search.crossover(ra, rb, r2, REF_SPACE)
        assert a.to_json() == ra.to_json() and c.to_json() == rc.to_json()
        assert search.repair(c, SPACE).to_json() == ref_search.repair(rc, REF_SPACE).to_json()
        if family == "elastic":
            a = search.shrink(a, r1, SPACE)
            ra = ref_search.shrink(ra, r2, REF_SPACE)
            b = search.grow(b, r1, SPACE)
            rb = ref_search.grow(rb, r2, REF_SPACE)
            assert b.to_json() == rb.to_json()
    assert search.decode(c, SPACE).fingerprint() == \
        ref_search.decode(rc, REF_SPACE).fingerprint()


# -- Pareto front ------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pareto_functions_equal_reference(seed):
    rng = np.random.default_rng(seed)
    pts = np.round(rng.random((40, 3)), 1)        # rounding makes ties
    assert [search.dominates(p, q) for p in pts for q in pts] == \
        [ref_search.dominates(p, q) for p in pts for q in pts]
    np.testing.assert_array_equal(search.nondominated_rank(pts),
                                  ref_search.nondominated_rank(pts))
    np.testing.assert_array_equal(search.crowding_distance(pts),
                                  ref_search.crowding_distance(pts))
    front, ref = search.ParetoFront(capacity=6), ref_search.ParetoFront(capacity=6)
    for i, p in enumerate(pts):
        assert front.add(f"k{i % 25}", p) == ref.add(f"k{i % 25}", p)
        assert front.to_json() == ref.to_json()
    again = search.ParetoFront.from_json(json.loads(json.dumps(ref.to_json())))
    assert again.to_json() == ref.to_json()


# -- objectives --------------------------------------------------------------------

def test_quality_proxies_and_budgets_equal_reference():
    graphs, rgraphs = synthetic_graphs(6, resolution=16), ref_graphs(6, resolution=16)
    for g, rg in zip(graphs, rgraphs):
        assert search.graph_flops(g) == ref_search.graph_flops(rg)
        assert search.graph_params(g) == ref_search.graph_params(rg)
        for name in ("flops", "balanced"):
            assert search.make_quality(name)(g) == ref_search.make_quality(name)(rg)
    (r1, r2) = _rng(5)
    for _ in range(6):
        gt, rgt = search.random_elastic_genotype(r1, SPACE), \
            ref_search.random_elastic_genotype(r2, REF_SPACE)
        assert search.make_quality("supernet")(gt) == \
            ref_search.make_quality("supernet")(rgt)
    assert sorted(search.QUALITIES) == sorted(ref_search.QUALITIES)

    budgets = [search.DeviceBudget(DeviceSetting(*SOURCE), 2e-3),
               search.DeviceBudget(DeviceSetting(*TARGET), 5e-3)]
    rbudgets = [ref_search.DeviceBudget(RefSetting(*SOURCE), 2e-3),
                ref_search.DeviceBudget(RefSetting(*TARGET), 5e-3)]
    assert [b.to_json() for b in budgets] == [b.to_json() for b in rbudgets]
    assert [b.key for b in budgets] == [b.key for b in rbudgets]
    lats = {b.key: np.random.default_rng(i).random(16) * 6e-3
            for i, b in enumerate(budgets)}
    scorer = search.LatencyScorer(object(), budgets)
    rscorer = ref_search.LatencyScorer(object(), rbudgets)
    np.testing.assert_array_equal(scorer.feasible_mask(lats), rscorer.feasible_mask(lats))
    np.testing.assert_array_equal(scorer.violation(lats), rscorer.violation(lats))


# -- the search loop on both packages' services -------------------------------------

@pytest.fixture(scope="module")
def banks():
    """Bank JSON per setting, trained by the reference on cost-model
    stores over chain graphs and random-wired graphs (so the bank has
    seen their join and resize op types); the median training e2e of the
    source setting sets the budgets."""
    rwc = RefRWConfig(**RW)
    graphs = ref_graphs(8, resolution=16) + [
        ref_decode_genotype(ref_sample_rw(s, rwc), REF_SPACE) for s in range(4)]
    out = {}
    for setting, seed in ((SOURCE, 3), (TARGET, 5)):
        store = RefStore()
        sess = CostModelProfileSession(store=store, seed=seed,
                                       flops_per_s=50e9 if seed == 3 else 20e9)
        recs = sess.profile_suite(graphs, RefSetting(*setting))
        hub = RefHub()
        bank = hub.train(store, RefSetting(*setting), "gbdt",
                         hparams={"n_stages": 20}, min_samples=3)
        out[setting] = (bank.to_json(), float(np.median([r.e2e_s for r in recs])))
    return out


def _services(banks):
    ref_hub, hub = RefHub(), PredictorHub(device="cpu")
    for setting, (d, _) in banks.items():
        ref_hub.register(RefSetting(*setting), "gbdt", RefBank.from_json(d))
        hub.register(DeviceSetting(*setting), "gbdt",
                     PredictorBank.from_json(d, device="cpu"))
    ref = RefService(ref_hub, default_setting=RefSetting(*SOURCE), predictor="gbdt",
                     inference_backend="numpy")
    port = LatencyService(hub, default_setting=DeviceSetting(*SOURCE),
                          predictor="gbdt", inference_backend="numpy", device="cpu")
    return ref, port


CASES = {
    "block": dict(quality="flops", scale=(1.0,)),
    "block_two_budgets": dict(quality="balanced", scale=(1.0, 1.0)),
    "elastic": dict(family="elastic", quality="supernet", scale=(4.0,)),
    "random_wired": dict(family="random_wired", rw=RW, scale=(20.0, 20.0)),
}


def _run(case, banks, ref, port, seed=11, generations=4):
    kw = dict(CASES[case])
    scale = kw.pop("scale")
    settings = [SOURCE, TARGET][:len(scale)]
    cfg = dict(population_size=10, generations=generations, children_per_gen=8,
               tournament_size=4, seed=seed, resolution=16, front_capacity=6, **kw)
    budgets = [search.DeviceBudget(DeviceSetting(*s), banks[s][1] * k)
               for s, k in zip(settings, scale)]
    rbudgets = [ref_search.DeviceBudget(RefSetting(*s), banks[s][1] * k)
                for s, k in zip(settings, scale)]
    eng = search.SearchEngine(port, budgets, search.SearchConfig(**cfg))
    reng = ref_search.SearchEngine(ref, rbudgets, ref_search.SearchConfig(**cfg))
    return eng, reng


@pytest.mark.parametrize("case", list(CASES))
def test_search_equals_reference(banks, case):
    ref, port = _services(banks)
    eng, reng = _run(case, banks, ref, port)
    rep, rrep = eng.run(), reng.run()
    assert len(rep.front) > 0
    assert rep.front_json() == rrep.front_json()
    assert [s.to_json() for s in rep.stats] == [s.to_json() for s in rrep.stats]
    assert rep.predict_batch_calls == rrep.predict_batch_calls
    assert rep.candidates_scored == rrep.candidates_scored
    # One predict_batch per device setting per generation that scored
    # something new (the reference's contract, tests/test_search.py).
    n_dev = len(CASES[case]["scale"])
    gens_with_new = sum(1 for s in rep.stats if s.new_scored > 0)
    assert rep.predict_batch_calls == port.predict_batch_calls == gens_with_new * n_dev
    assert port.stats()["backend_runs"].keys() == {"numpy"}


@pytest.mark.parametrize("case", ["block", "random_wired"])
def test_port_checkpoint_resumes_bit_identically(banks, case, tmp_path):
    ref, port = _services(banks)
    straight = _run(case, banks, ref, port, seed=31, generations=6)[0].run()
    eng = _run(case, banks, ref, port, seed=31, generations=6)[0]
    for _ in range(3):
        eng.step()
    path = str(tmp_path / "search.json")
    eng.save(path)
    resumed = search.SearchEngine.load(path, port).run()
    assert resumed.front_json() == straight.front_json()
    assert [s.to_json() for s in resumed.stats] == [s.to_json() for s in straight.stats]
    # The checkpoint is the reference's format: its engine resumes it too.
    ref_resumed = ref_search.SearchEngine.load(path, ref).run()
    assert ref_resumed.front_json() == straight.front_json()
    again = str(tmp_path / "again.json")
    search.SearchEngine.load(path, port).save(again)
    assert json.load(open(path)) == json.load(open(again))


def test_verify_measures_the_front_with_the_port_profiler(banks):
    _, port = _services(banks)
    rep = _run("block", banks, None, port)[0].run()
    session = ProfileSession(warmup=0, inner=1, repeats=1, e2e_inner=1,
                             e2e_repeats=1, device="cpu")
    out = rep.verify(session, DeviceSetting(*SOURCE))
    assert out["n_verified"] == len(rep.front) == session.measured_graphs > 0
    assert all(r["measured_s"] > 0 for r in out["rows"])
    assert np.isfinite(out["mape"])
    with pytest.raises(ValueError, match="not among the searched"):
        rep.verify(session, DeviceSetting("other", "int8", "op_by_op"))
