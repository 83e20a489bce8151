"""Beyond-paper example on the port: predict a distributed step's latency
on H100 cards (twin of ``examples/predict_tpu_step.py``).

The paper predicts phone inference latency without the phone; here the
same composition predicts a 256-card step without the cards, from the
port's analytic cost model (`repro_torch.launch.roofline`) and the H100's
published rates, for every input shape of one architecture.  The dry run
(`repro_torch.launch.dryrun`) traces the same cells for the counts to
hold the model against.

Pure arithmetic on the configs: it allocates no tensor and launches
nothing, so it takes no ``--device`` and runs the same with or without a
card.

  PYTHONPATH=src python examples/torch/predict_tpu_step.py --arch qwen2-72b
"""
import argparse

from repro_torch.configs import INPUT_SHAPES, get_arch, shape_applicable
from repro_torch.launch.roofline import analytic_costs, step_terms


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-72b")
    args = ap.parse_args(argv)
    mesh = {"data": 16, "model": 16}
    cfg = get_arch(args.arch)
    print(f"{args.arch} on an H100 {mesh} mesh (256 cards):")
    for sname, shape in INPUT_SHAPES.items():
        ok, why = shape_applicable(cfg, shape)
        if not ok:
            print(f"  {sname:12s} skipped: {why.split(';')[0]}")
            continue
        ana = analytic_costs(args.arch, sname, mesh)
        _, dom, step = step_terms(ana)
        tput = ana["tokens"] / step
        print(f"  {sname:12s} step ≈ {1e3*step:9.2f} ms  "
              f"[{dom}-bound]  ≈ {tput:,.0f} tok/s")


if __name__ == "__main__":
    main()
