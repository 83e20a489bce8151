"""Serve latency predictions over RPC on the port: the repo as a *system*
(twin of ``examples/serve_latency.py``).

The paper's predictor is only useful at NAS/serving scale if many
clients can query it cheaply.  This example stands up the full stack
from `repro_torch.rpc` in one process and exercises it the way a fleet of
search workers would:

1. profile a training suite (deterministic cost-model source) and train
   a GBDT bank, exactly as `examples/torch/quickstart.py` does (the bank
   serves on the card: the tree kernel scores every batched predict),
2. start `LatencyRPCServer` on localhost: micro-batching front-end
   (max_batch 32, 2 ms max wait) over the JSONL protocol,
3. hammer it with 16 client threads × 16 candidate architectures
   through one pipelined `LatencyClient`, and show the batcher's view:
   requests coalesced per `predict_batch`, cache short-circuits,
   backend mix,
4. run a small predictor-in-the-loop NAS search, register its report,
   and query the *search front* over the same wire ("what meets a
   2/3-of-median budget on this device?"),
5. point a `ServeEngine` at the RPC client so its decode-step estimate
   travels through the same front-end.

  PYTHONPATH=src python examples/torch/serve_latency.py            # on the card
  PYTHONPATH=src python examples/torch/serve_latency.py --device cpu
"""
import argparse
import threading

import numpy as np
import torch

from repro_torch.core.dataset import synthetic_graphs
from repro_torch.core.nas_space import NASSpaceConfig, sample_architecture
from repro_torch.core.profiler import DeviceSetting
from repro_torch.pipeline import LatencyService, PredictorHub, ProfileStore
from repro_torch.rpc import BatchPolicy, LatencyClient, LatencyRPCServer
from repro_torch.search import DeviceBudget, SearchConfig, SearchEngine
from repro_torch.transfer import CostModelProfileSession

SETTING = DeviceSetting("cpu_f32", "float32", "op_by_op")
SPACE = NASSpaceConfig(resolution=16)
N_CLIENTS = 16
PER_CLIENT = 16


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--clients", type=int, default=N_CLIENTS)
    args = ap.parse_args(argv)
    n_clients = args.clients

    print("== 1. profile + train (cost-model source, deterministic) ==")
    store = ProfileStore()
    session = CostModelProfileSession(store=store, seed=3)
    train = synthetic_graphs(10, resolution=16)
    for g in train:
        session.profile_graph(g, SETTING)
    hub = PredictorHub(device=args.device)
    hub.train(store, SETTING, "gbdt", hparams={"n_stages": 40}, min_samples=3)
    service = LatencyService(hub, default_setting=SETTING, predictor="gbdt",
                             device=args.device)

    print("\n== 2. serve it: micro-batching RPC front-end ==")
    server = LatencyRPCServer(
        service, policy=BatchPolicy(max_batch=32, max_wait_ticks=2,
                                    max_queue=1024))
    host, port = server.start()
    print(f"listening on {host}:{port} "
          f"(policy: {server.batcher.policy})")

    print(f"\n== 3. {n_clients} threads x {PER_CLIENT} candidates over one "
          f"pipelined client ==")
    client = LatencyClient(host, port)
    candidates = [sample_architecture(100 + i, SPACE)
                  for i in range(n_clients * PER_CLIENT // 2)]  # 50% repeats

    def worker(tid):
        mine = [candidates[(tid * 13 + k) % len(candidates)]
                for k in range(PER_CLIENT)]
        reps = client.predict_pipelined(mine)
        assert [r.fingerprint for r in reps] == [g.fingerprint() for g in mine]

    threads = [threading.Thread(target=worker, args=(i,))
               for i in range(n_clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    st = client.stats()
    b = st["batcher"]
    print(f"answered {b['answered']} requests in {b['batches']} batched "
          f"predicts (avg batch {b['avg_batch']:.1f}, max "
          f"{b['max_batch_observed']}); cache short-circuits: "
          f"{b['short_circuits']}")
    print(f"service backend mix: {st['service']['backend_runs']}, "
          f"cache {st['service']['hits']} hits / "
          f"{st['service']['misses']} misses")

    print("\n== 4. NAS search served over the same wire ==")
    e2e = [store.get_arch(SETTING, g.fingerprint()).e2e_s for g in train]
    budget = float(np.median(e2e))
    cfg = SearchConfig(population_size=16, generations=4,
                       children_per_gen=12, seed=11, resolution=16,
                       front_capacity=8)
    report = SearchEngine(service, [DeviceBudget(SETTING, budget)], cfg).run()
    server.register_search_report(report)
    # Tighten to the front's own median latency — "of everything the
    # search found, what still fits half the headroom?"
    skey = "float32/op_by_op"
    tight = float(np.median([m.latencies[skey] for m in report.front]))
    front = client.search_front(budget_s=tight, limit=3)
    print(f"front: {len(report.front)} members; under {tight * 1e3:.2f} ms "
          f"on {front['setting']}: {front['total']} "
          f"(top {len(front['members'])} by quality)")
    for m in front["members"]:
        print(f"  {m['digest'][:10]}  quality={m['quality']:.2f}  "
              f"latency={m['latencies'][front['setting']] * 1e3:.2f} ms")

    print("\n== 5. ServeEngine's decode-step estimate via the client ==")

    class TinyModel:
        def init_cache(self, slots, max_len, device):
            return {"pos": 0}

        def decode_step(self, params, batch, cache):
            return (torch.arange(8.0, device=args.device)
                    .repeat(batch["token"].shape[0], 1),
                    {"pos": cache["pos"] + 1})

    from repro_torch.serving import ServeEngine
    step_graph = sample_architecture(999, SPACE)
    eng = ServeEngine(TinyModel(), params={}, batch_slots=2, max_len=16,
                      latency_service=client, step_graph=step_graph,
                      latency_setting=SETTING, device=args.device)
    print(f"predicted decode step: {eng.predicted_step_s * 1e3:.2f} ms "
          f"(source: {eng.stats()['prediction_source']}); "
          f"8-token request estimate: "
          f"{eng.estimate_request_s(4, 8) * 1e3:.2f} ms")

    client.close()
    server.stop()
    print("\ndone.")


if __name__ == "__main__":
    main()
