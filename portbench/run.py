"""Run one cell of the port's benchmark and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cell is ``workloads/<cell>.json``;
its driver does the work (`drivers/`).  The run needs an NVIDIA card:
without one, or with fewer than the cell asks for, it exits 2 and prints
no result.  It exits 3 and prints no result if JAX or the JAX package
was loaded in this process.  Otherwise the checks go to the last lines of
standard error and the result, one JSON object, to the last line of
standard output.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(REPO), str(REPO / "src")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from portbench import core

    cell = core.load_cell(args.workload)
    import torch

    chips = int(cell.spec["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} NVIDIA card(s); this process sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    driver = core.module("drivers", cell.driver)
    result, checks = driver.run(cell, args.seed, args.seconds, bool(args.trace),
                                torch.device("cuda", 0), T_START)
    found = core.forbidden_modules()
    if found:
        print(f"forbidden modules loaded in this process: {', '.join(found)}",
              file=sys.stderr)
        return 3
    core.emit(result, checks)
    return 0


if __name__ == "__main__":
    os.environ.setdefault("USE_FLAX", "0")
    sys.exit(main())
