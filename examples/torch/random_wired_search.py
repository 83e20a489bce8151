"""Random-wired NAS on the port: latency prediction beyond chain
topologies (twin of ``examples/random_wired_search.py``).

Samples a seeded population of random-wired genotypes (WS/ER/BA graph
models, arbitrary fan-out, optional encoder-decoder skeletons), then
pushes it through the full pipeline the chain families use unchanged:

  decode → Alg. C.1 fusion → featurize → `predict_batch` (auto backend;
  on the card the tree kernel) → evolutionary search with
  checkpoint/resume.

Everything is seeded: the population, the cost-model profiling session,
the predictor, and the search are reproducible; the script runs the
search twice and from a mid-run checkpoint and asserts all three fronts
are identical (``--smoke`` only trims sizes).

  PYTHONPATH=src python examples/torch/random_wired_search.py [--smoke]      # on the card
  PYTHONPATH=src python examples/torch/random_wired_search.py --smoke --device cpu
"""
import argparse
import os
import tempfile

import numpy as np

from repro_torch.core.dataset import synthetic_graphs
from repro_torch.core.features import graph_features
from repro_torch.core.fusion import fuse_graph
from repro_torch.core.nas_space import (NASSpaceConfig, RandomWiredConfig,
                                        decode_genotype, sample_random_wired)
from repro_torch.core.profiler import DeviceSetting
from repro_torch.pipeline import LatencyService, PredictorHub, ProfileStore
from repro_torch.search import DeviceBudget, SearchConfig, SearchEngine
from repro_torch.transfer import CostModelProfileSession

SETTING = DeviceSetting("cpu_f32", "float32", "op_by_op")


def max_fanout(graph) -> int:
    uses: dict = {}
    for n in graph.nodes:
        for t in n.inputs:
            uses[t] = uses.get(t, 0) + 1
    return max(uses.values())


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--smoke", action="store_true",
                    help="small sizes for CI (same assertions)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    space = NASSpaceConfig(resolution=16)
    rwc = RandomWiredConfig(model="mixed", stages=2, nodes_per_stage=6,
                            stem_c=8, channel_scale=0.25, encdec_prob=0.25)
    n_pop = 64 if args.smoke else 128

    print(f"== sample + decode {n_pop} random-wired graphs ==")
    graphs = [decode_genotype(sample_random_wired(s, rwc), space)
              for s in range(n_pop)]
    widest = max(max_fanout(g) for g in graphs)
    assert widest >= 3, f"population never exceeds fan-out {widest}"
    print(f"   models mix WS/ER/BA; widest fan-out in population: {widest}")

    print("== fuse + featurize every graph ==")
    kernels_before = sum(g.num_ops() for g in graphs)
    fused = [fuse_graph(g)[1] for g in graphs]
    kernels_after = sum(f.num_ops() for f in fused)
    for f in fused:
        gf = graph_features(f)          # per-op-type feature matrices
        assert sum(m.shape[0] for m in gf.matrix.values()) == f.num_ops()
    print(f"   Alg. C.1: {kernels_before} ops -> {kernels_after} kernels "
          f"({100 * (1 - kernels_after / kernels_before):.0f}% fewer)")

    print("== train predictor (cost-model session) + predict_batch ==")
    store = ProfileStore()
    session = CostModelProfileSession(store=store, seed=3)
    train = synthetic_graphs(8, resolution=16) + graphs[:6]
    for g in train:
        session.profile_graph(g, SETTING)
    hub = PredictorHub(device=args.device)
    hub.train(store, SETTING, "gbdt", hparams={"n_stages": 20}, min_samples=3)
    svc = LatencyService(hub, default_setting=SETTING, predictor="gbdt",
                         device=args.device)
    lats = [r.e2e_s for r in svc.predict_batch(graphs)]   # auto backend
    assert all(np.isfinite(v) and v > 0 for v in lats)
    print(f"   predicted {len(lats)} graphs in one call "
          f"(backends: {svc.stats()['backend_runs']}); "
          f"median {1e3 * float(np.median(lats)):.2f} ms")

    print("== evolve under a latency budget, twice + resumed ==")
    budget = DeviceBudget(SETTING, float(np.median(lats)))
    cfg = SearchConfig(population_size=12 if args.smoke else 24,
                       generations=4 if args.smoke else 8,
                       children_per_gen=10 if args.smoke else 20,
                       seed=7, resolution=16, front_capacity=6,
                       family="random_wired", rw=rwc.to_json())
    r1 = SearchEngine(svc, [budget], cfg).run()
    r2 = SearchEngine(svc, [budget], cfg).run()
    assert r1.front_json() == r2.front_json(), "run-to-run mismatch"
    ck = os.path.join(tempfile.mkdtemp(), "rw_search.json")
    half = SearchEngine(svc, [budget], cfg)
    for _ in range(cfg.generations // 2):
        half.step()
    half.save(ck)
    resumed = SearchEngine.load(ck, svc).run()
    assert resumed.front_json() == r1.front_json(), "resume mismatch"
    assert r1.front, "no candidate met the budget"
    print(f"   scored {r1.candidates_scored} candidates "
          f"({r1.predict_batch_calls} predict_batch calls); front:")
    for m in r1.front:
        print(f"   {m.digest}  quality {m.quality:5.2f}  "
              f"{1e3 * m.latencies[budget.key]:6.2f} ms")
    print("random-wired smoke: OK" if args.smoke else "random-wired run: OK")


if __name__ == "__main__":
    main()
