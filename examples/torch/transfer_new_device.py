"""Cross-device transfer on the port: serve a brand-new device from K
measurements (twin of ``examples/transfer_new_device.py``).

1. profile a source suite on the device into a persistent ProfileStore +
   train a source GBDT bank (re-running is free: warm store),
2. derive a synthetic target device (per-op-type latency warp of the
   source; stands in for a second phone),
3. build the *oracle*: fully profile the target + train from scratch
   (what transfer avoids paying),
4. sweep budgets K ∈ {8, 16, 32, 64}: TransferEngine.adapt → calibrated
   bank registered under the target's setting key, served by the same
   LatencyService with zero code changes,
5. compact the source store (append-only files accrete duplicates across
   re-runs).

  PYTHONPATH=src python examples/torch/transfer_new_device.py            # on the card
  PYTHONPATH=src python examples/torch/transfer_new_device.py --device cpu
"""
import argparse
import os

from repro_torch.core.composition import mape
from repro_torch.core.dataset import synthetic_graphs
from repro_torch.core.profiler import DeviceSetting, ProfileSession
from repro_torch.pipeline import LatencyService, PredictorHub, ProfileStore
from repro_torch.transfer import ReplayProfileSession, SyntheticDevice, TransferEngine

REPORTS = os.path.join(os.path.dirname(__file__), "..", "..", "reports")
TARGET = DeviceSetting("pixel_sim", "float32", "op_by_op", device="pixel_sim")
BUDGETS = (8, 16, 32, 64)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--graphs", type=int, default=14, help="source architectures")
    ap.add_argument("--store", default=None,
                    help="source ProfileStore file (default: "
                         "reports/torch_transfer_source_<device>.jsonl)")
    return ap.parse_args(argv)


def main(argv=None) -> None:
    args = parse_args(argv)
    path = args.store or os.path.join(REPORTS, f"torch_transfer_source_{args.device}.jsonl")
    source = DeviceSetting(f"{args.device}_f32", "float32", "op_by_op")
    n_test = max(1, round(args.graphs * 2 / 7))
    print("== 1. profile the source device suite + train its bank ==")
    graphs = synthetic_graphs(args.graphs, resolution=16)
    train, test = graphs[:-n_test], graphs[-n_test:]
    store = ProfileStore(path)
    session = ProfileSession(repeats=1, inner=2, store=store, device=args.device)
    for g in graphs:
        session.profile_graph(g, source)
    print(f"source store: {store.stats()} "
          f"(new measurements this run: {session.measured_ops})")
    hub = PredictorHub(device=args.device)
    hub.train(store, source, "gbdt", hparams={"n_stages": 50}, min_samples=3,
              fingerprints=[g.fingerprint() for g in train])

    print("\n== 2-3. synthetic target device + fully-profiled oracle ==")
    device = SyntheticDevice("pixel_sim", seed=7, noise=0.1, curvature=0.15)
    oracle_sess = ReplayProfileSession(store, device, source, store=ProfileStore())
    truth = {g.name: oracle_sess.profile_graph(g, TARGET).e2e_s for g in graphs}
    oracle_hub = PredictorHub(device=args.device)
    oracle_hub.train(oracle_sess.store, TARGET, "gbdt",
                     hparams={"n_stages": 50}, min_samples=3,
                     fingerprints=[g.fingerprint() for g in train])
    oracle_svc = LatencyService(oracle_hub, predictor="gbdt", device=args.device)
    y_true = [truth[g.name] for g in test]
    oracle_mape = mape(y_true, [oracle_svc.predict_e2e(g, TARGET).e2e_s for g in test])
    print(f"oracle (full target profile, {oracle_sess.measured_ops} op + "
          f"{oracle_sess.measured_graphs} e2e measurements): "
          f"MAPE {100 * oracle_mape:.1f}% on {len(test)} held-out archs")

    print("\n== 4. budget sweep: adapt with K target measurements ==")
    print(f"{'K':>4} {'measured':>9} {'e2e MAPE':>9} {'vs oracle':>10}  maps")
    for k in BUDGETS:
        target_sess = ReplayProfileSession(store, device, source)
        engine = TransferEngine(source, TARGET, family="gbdt", seed=0)
        result = engine.adapt(store, hub, target_sess, k)
        svc = LatencyService(hub, predictor="gbdt", device=args.device)
        m = mape(y_true, [svc.predict_e2e(g, TARGET).e2e_s for g in test])
        kinds = sorted(set(result.map_kinds.values())) or ["prior"]
        print(f"{k:>4} {result.n_measurements:>9} {100 * m:>8.1f}% "
              f"{m / max(oracle_mape, 1e-12):>9.2f}x  "
              f"{','.join(kinds)} ({result.composition})")

    svc = LatencyService(hub, default_setting=source, predictor="gbdt", device=args.device)
    r = svc.predict_e2e(test[0], TARGET)
    print(f"\nLatencyService now serves {svc.available()}")
    print(f"predict_e2e({test[0].name}, target) = {1e3 * r.e2e_s:.2f} ms "
          f"(source: {1e3 * svc.predict_e2e(test[0]).e2e_s:.2f} ms)")

    print("\n== 5. compact the source store ==")
    out = store.compact()
    print(f"compacted {path}: kept {out['kept']} records, "
          f"dropped {out['dropped']} stale lines")


if __name__ == "__main__":
    main()
