"""Closed-loop drift actuation on the port: timeline → alert → recalibrate
→ rollover (twin of ``examples/autopilot_recalibration.py``).

A deployed latency predictor goes stale when the device under it moves
(thermal throttling, a driver update).  This example runs the whole
closed loop deterministically, on a ManualClock:

1. profile a source device, train its GBDT bank, onboard a synthetic
   target device with a small transfer budget (the steady state),
2. wire the control plane: a MetricsTimeline sampling the drift score,
   an AlertRule (score > 1 sustained 3 windows), and a
   RecalibrationAutopilot subscribed to its fires,
3. inject drift: `warp_shift` derives the same device after a 2.4x
   uniform slowdown plus a per-op-type re-roll,
4. tick the loop: the score crosses the threshold, the rule sustains and
   fires, the autopilot concentrates a budget-K transfer on the worst
   drift cells and rolls the refreshed bank over (epoch bump),
5. print the audit log: the sequence of control-plane decisions the loop
   is reconstructed from.

Exits non-zero unless the epoch advanced and the post-rollover drift
score is back under the alert threshold.  The banks serve on the card
(``--device cpu``: on the host).

  PYTHONPATH=src python examples/torch/autopilot_recalibration.py
"""
import argparse

from repro_torch.core.dataset import synthetic_graphs
from repro_torch.core.profiler import DeviceSetting
from repro_torch.obs import (AlertEngine, AlertRule, AutopilotConfig,
                             MetricsTimeline, Observability,
                             RecalibrationAutopilot, attach_session_drift)
from repro_torch.pipeline import LatencyService, PredictorHub, ProfileStore
from repro_torch.rpc.batcher import ManualClock
from repro_torch.transfer import (CostModelProfileSession, ReplayProfileSession,
                                  SyntheticDevice, TransferEngine)

SOURCE = DeviceSetting("cpu_f32", "float32", "op_by_op")
TARGET = DeviceSetting("edge_f32", "float32", "op_by_op", device="edge_sim")
TICKS = 10


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    print("== 1. steady state: source bank + transferred target bank ==")
    graphs = synthetic_graphs(12, resolution=16)
    store = ProfileStore()
    src_sess = CostModelProfileSession(store=store, seed=1)
    for g in graphs:
        src_sess.profile_graph(g, SOURCE)
    hub = PredictorHub(device=args.device)
    hub.train(store, SOURCE, "gbdt", hparams={"n_stages": 30}, min_samples=3)
    device = SyntheticDevice("edge_sim", seed=7, noise=0.05, curvature=0.1)
    TransferEngine(SOURCE, TARGET, family="gbdt", seed=0).adapt(
        store, hub, ReplayProfileSession(store, device, SOURCE), 32)
    epoch0 = hub.epoch_of(TARGET, "gbdt")
    print(f"serving {sorted(k for k, _ in hub.banks)} at epoch {epoch0}")

    print("\n== 2. wire the control plane ==")
    clock = ManualClock()
    obs = Observability(clock=clock, seed=21, drift_threshold=0.5,
                        drift_min_count=4)
    svc = LatencyService(hub, default_setting=SOURCE, predictor="gbdt",
                         obs=obs, device=args.device)
    timeline = MetricsTimeline(clock=clock, interval=1, capacity=256)
    timeline.track("drift_score", obs.drift.score)
    engine = AlertEngine(timeline, [AlertRule(
        "drift", series="drift_score", threshold=1.0, sustain=3)], obs=obs)

    print("\n== 3. inject drift (uniform 2.4x + per-type re-roll) ==")
    drifted = device.warp_shift(scale=2.4, seed_offset=3)
    autopilot = RecalibrationAutopilot(
        obs, engine, hub, store, SOURCE,
        config=AutopilotConfig(budget_k=48, top_k_cells=3, cooldown=4.0,
                               seed=0))
    autopilot.register_device(
        TARGET, lambda: ReplayProfileSession(store, drifted, SOURCE))

    print("\n== 4. tick the loop ==")
    records = store.op_records(SOURCE)[:48]
    for tick in range(TICKS):
        sess = ReplayProfileSession(store, drifted, SOURCE)
        attach_session_drift(sess, svc, obs.drift)
        for rec in records:
            sess.measure_record(rec, TARGET)
        clock.advance(1)
        autopilot.step()
        score = timeline.latest("drift_score")
        firing = ",".join(engine.firing()) or "-"
        print(f"  t={clock.now():>2}  drift_score={score:6.2f}  "
              f"firing={firing:<6} actions={len(autopilot.actions)}")

    print("\n== 5. the audit log (the loop, reconstructable) ==")
    for ev in autopilot.audit.events():
        extra = {k: v for k, v in ev.items()
                 if k not in ("seq", "kind", "t", "tid", "sid")}
        print(f"  #{ev['seq']:<2} t={ev['t']:<3} {ev['kind']:<22} {extra}")

    epoch1 = hub.epoch_of(TARGET, "gbdt")
    final = obs.drift.score()
    act = autopilot.actions[0] if autopilot.actions else None
    print(f"\nepoch {epoch0} -> {epoch1}; final drift score {final:.2f}; "
          f"action: {act}")
    ok = (epoch1 > epoch0 and final < 1.0 and act is not None
          and act["n_measurements"] <= 64)
    print("autopilot smoke:", "OK" if ok else "FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
