"""Read the numbers `correct` compares, for setting a cell's limits.

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,3 \
        [--control-seeds 1,2,3] [--fault-seeds 1,2,3] [--drop-seeds 1,2,3]

For each seed, in one process on the card: the port's first steps and
the reference's (the lower reading: sound runs); with ``--control-seeds``
also the control, the reference computed with float8 products in the
port's place; with ``--fault-seeds`` the port with each planted fault
(`faults.py`) but ``unchanged``, which reads 1 by construction; with
``--drop-seeds`` (MoE cells) also the reference that drops a pair past
its expert's capacity as published, against the reference and against
the port.  Prints one JSON line a reading: {"seed", "kind"} and every
number of `drivers.train.gaps`.  Not run by the benchmark's runs.
"""
import argparse
import copy
import gc
import json
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(REPO), str(REPO / "src")]

def program_readings(cell, seed, device, wrap=None):
    import torch
    from portbench.drivers import train

    model, state, step = train.build(cell, seed, device)
    if wrap is not None:
        step = wrap(step)
    state, readings = train.check_steps(cell, seed, state, step,
                                        train.Feed(cell, seed, device))
    out = train._floats(readings)
    del model, state, step, readings
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return out


def readings(cell, seed, device, control=False, faults=(), drop=False):
    """[(kind, {number: value})] for one seed."""
    from portbench.drivers import train
    from portbench.faults import FAULTS

    sound = program_readings(cell, seed, device)
    broken = {f: program_readings(cell, seed, device, FAULTS[f]) for f in faults}
    ref = train.reference_readings(cell, seed, device)
    out = [("program", sound)] + [(f"fault:{f}", r) for f, r in broken.items()]
    if control:
        out.append(("control:fp8", train.reference_readings(cell, seed, device, "fp8")))
    gaps = [(kind, train.gaps(r, ref)) for kind, r in out]
    if drop:
        published = copy.copy(cell)
        published.config = dict(cell.config, arch=dict(cell.config["arch"], overflow="drop"))
        dropped = train.reference_readings(published, seed, device)
        gaps += [("reference:drop", train.gaps(dropped, ref)),
                 ("program_vs:drop", train.gaps(sound, dropped))]
    return gaps


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--drop-seeds", default="")
    args = ap.parse_args(argv)
    import torch
    from portbench import core

    if not torch.cuda.is_available():
        print("calibrate.py needs an NVIDIA card", file=sys.stderr)
        return 2
    cell = core.load_cell(args.workload)
    device = torch.device("cuda", 0)
    ints = lambda s: [int(x) for x in s.split(",") if x]  # noqa: E731
    control, faults = set(ints(args.control_seeds)), set(ints(args.fault_seeds))
    drop = set(ints(args.drop_seeds))
    for seed in dict.fromkeys(ints(args.seeds) + sorted(control | faults | drop)):
        for kind, nums in readings(cell, seed, device, seed in control,
                                   ("half_batch", "answer_altered") if seed in faults else (),
                                   seed in drop):
            print(json.dumps({"workload": args.workload, "seed": seed, "kind": kind, **nums}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
