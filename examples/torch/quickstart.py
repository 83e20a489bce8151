"""Quickstart on the port: the paper's pipeline end to end (twin of
``examples/quickstart.py``).

1. sample synthetic NAS architectures (paper §4.3.2),
2. profile them on the device into a persistent ProfileStore (re-running
   this script is free: warm signatures are never re-measured),
3. train per-op-type predictors (paper §4.2) via LatencyService.build,
4. predict end-to-end latency of unseen architectures (the NAS-time use
   case; on the card the trees run in the hand-written tree kernel) and
   report MAPE,
5. deduce GPU-delegate kernels (fusion + selection) for one arch.

  PYTHONPATH=src python examples/torch/quickstart.py            # on the card
  PYTHONPATH=src python examples/torch/quickstart.py --device cpu
"""
import argparse
import os

from repro_torch.core.composition import mape
from repro_torch.core.dataset import synthetic_graphs
from repro_torch.core.fusion import fuse_graph
from repro_torch.core.profiler import DeviceSetting, ProfileSession
from repro_torch.core.selection import apply_selection, get_device
from repro_torch.pipeline import LatencyService

REPORTS = os.path.join(os.path.dirname(__file__), "..", "..", "reports")


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--graphs", type=int, default=30, help="architectures to profile")
    ap.add_argument("--resolution", type=int, default=32)
    ap.add_argument("--store", default=None,
                    help="ProfileStore file (default: reports/torch_quickstart_<device>.jsonl)")
    return ap.parse_args(argv)


def main(argv=None) -> LatencyService:
    args = parse_args(argv)
    store = args.store or os.path.join(REPORTS, f"torch_quickstart_{args.device}.jsonl")
    n_test = max(1, args.graphs // 5)
    print(f"== 1-3. profile {args.graphs} synthetic NAS archs into a store, train GBDT ==")
    graphs = synthetic_graphs(args.graphs, resolution=args.resolution)
    train, test = graphs[:-n_test], graphs[-n_test:]
    svc = LatencyService.build(
        graphs,
        DeviceSetting(f"{args.device}_f32", "float32", "op_by_op"),
        store=store,
        session=ProfileSession(repeats=2, inner=3, device=args.device),
        predictor="gbdt",
        overhead_model="affine",
        train_graphs=train,                    # hold out the last fifth
        device=args.device,
    )
    print(f"store: {svc.store.stats()}  "
          f"(new measurements this run: {svc.session.measured_ops})")

    print(f"\n== 4. predict the {n_test} unseen archs in one batched query ==")
    reports = svc.predict_batch(test)
    y_true = [svc.store.get_arch(svc.default_setting, g.fingerprint()).e2e_s
              for g in test]
    y_pred = [r.e2e_s for r in reports]
    print(f"end-to-end latency MAPE on unseen archs: "
          f"{100 * mape(y_true, y_pred):.1f}%")
    for g, r, yt in zip(test, reports, y_true):
        print(f"  {g.name:24s} measured {1e3 * yt:6.2f} ms   "
              f"predicted {1e3 * r.e2e_s:6.2f} ms")
    again = svc.predict_e2e(test[0])
    print(f"repeat query served from cache: {again.from_cache} "
          f"({svc.cache_info()})")

    print("\n== 5. kernel deduction for arch #0 on a Mali-class GPU ==")
    g = graphs[0]
    groups, _ = fuse_graph(g)
    sel = apply_selection(g, get_device("mali_g76"))
    print(f"ops: {g.num_ops()}  → kernels after fusion: {len(groups)}")
    print(f"kernel mix after selection: {sel.op_type_counts()}")
    return svc


if __name__ == "__main__":
    main()
