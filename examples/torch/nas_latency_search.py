"""Latency-constrained NAS on the port, the paper's motivating application
(twin of ``examples/nas_latency_search.py``).

Evolutionary search over the synthetic NAS space with
`repro_torch.search`: candidates are never measured; every generation is
scored through ONE `LatencyService.predict_batch` call per device (paper
§1).  Two runs:

  1. single-device: evolve a latency/quality Pareto front under a budget
     on the profiled device, then verify the front by measuring it
     (through the same ProfileStore, so the measurements persist);
  2. two-device: adapt the profiled device to a synthetic second device
     with a 32-measurement transfer budget (`repro_torch.transfer`), then
     search under BOTH devices' budgets at once.

  PYTHONPATH=src python examples/torch/nas_latency_search.py            # on the card
  PYTHONPATH=src python examples/torch/nas_latency_search.py --device cpu
"""
import argparse
import os

import numpy as np

from repro_torch.core.dataset import synthetic_graphs
from repro_torch.core.profiler import DeviceSetting, ProfileSession
from repro_torch.pipeline import LatencyService
from repro_torch.search import DeviceBudget, SearchConfig, SearchEngine
from repro_torch.transfer import ReplayProfileSession, SyntheticDevice, TransferEngine

REPORTS = os.path.join(os.path.dirname(__file__), "..", "..", "reports")
SECOND = DeviceSetting("edge2", "float32", "op_by_op", device="edge2")


def show_front(report, keys) -> None:
    for m in report.front:
        lats = "  ".join(f"{k}: {1e3 * m.latencies[k]:6.2f} ms" for k in keys)
        print(f"  {m.digest}  quality {m.quality:5.2f}  {lats}")


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--graphs", type=int, default=25, help="training architectures")
    ap.add_argument("--generations", type=int, default=8)
    ap.add_argument("--store", default=None,
                    help="ProfileStore file (default: reports/torch_nas_search_<device>.jsonl)")
    return ap.parse_args(argv)


def main(argv=None) -> None:
    args = parse_args(argv)
    store = args.store or os.path.join(REPORTS, f"torch_nas_search_{args.device}.jsonl")
    setting = DeviceSetting(f"{args.device}_f32", "float32", "op_by_op")
    print(f"== profile {args.graphs} architectures to train the predictor ==")
    train_graphs = synthetic_graphs(args.graphs, resolution=32)
    svc = LatencyService.build(
        train_graphs, setting,
        store=store,
        session=ProfileSession(repeats=2, inner=3, device=args.device),
        predictor="gbdt", overhead_model="affine", device=args.device,
    )
    # Budget from THIS run's training suite (the store may also hold
    # records from earlier runs, e.g. previously verified fronts).
    e2e = np.asarray([svc.store.get_arch(setting, g.fingerprint()).e2e_s
                      for g in train_graphs])
    budget = DeviceBudget(setting, float(np.median(e2e) * 0.8))
    print(f"latency budget: {1e3 * budget.budget_s:.2f} ms")

    print("\n== single-device search (~200 candidates, zero measurements) ==")
    cfg = SearchConfig(population_size=32, generations=args.generations,
                       children_per_gen=24, seed=0, quality="flops", front_capacity=6)
    report = SearchEngine(svc, [budget], cfg).run()
    assert report.front, "no candidate met the budget"
    print(f"scored {report.candidates_scored} candidates with "
          f"{report.predict_batch_calls} predict_batch calls "
          f"({report.wall_time_s:.1f}s); front:")
    show_front(report, [budget.key])

    print("\n== verify the front by measurement (persisted to the store) ==")
    ver = report.verify(svc.session, setting)
    for row in ver["rows"]:
        err = abs(row["predicted_s"] - row["measured_s"]) / row["measured_s"]
        print(f"  {row['digest']}  predicted {1e3 * row['predicted_s']:6.2f} ms"
              f"  measured {1e3 * row['measured_s']:6.2f} ms  ({100 * err:.1f}%)")
    print(f"front MAPE vs measurement: {100 * ver['mape']:.1f}% "
          f"({ver['n_verified']} measurements for "
          f"{report.candidates_scored} candidates explored)")

    print("\n== adapt a second device with a 32-measurement budget ==")
    device = SyntheticDevice("edge2", seed=21, noise=0.1, base_scale=2.5)
    target_sess = ReplayProfileSession(svc.store, device, setting)
    result = TransferEngine(setting, SECOND, family="gbdt", seed=0).adapt(
        svc.store, svc.hub, target_sess, 32)
    print(f"registered {SECOND.device!r} bank from "
          f"{result.n_measurements} measurements")

    print("\n== two-device constrained search ==")
    # The second device is ~2.5× slower; give it a proportionally looser
    # budget so the joint constraint bites without being impossible.
    budgets = [budget, DeviceBudget(SECOND, budget.budget_s * 3.0)]
    report2 = SearchEngine(svc, budgets,
                           SearchConfig(population_size=32,
                                        generations=args.generations,
                                        children_per_gen=24, seed=1,
                                        quality="flops",
                                        front_capacity=6)).run()
    assert report2.front, "no candidate met both device budgets"
    print(f"scored {report2.candidates_scored} candidates "
          f"({report2.predict_batch_calls} predict_batch calls — "
          f"one per device per generation); front:")
    show_front(report2, [b.key for b in budgets])


if __name__ == "__main__":
    main()
