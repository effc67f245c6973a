"""Readings for the limits of a cell's check: the program's on many seeds,
and the control's and the planted faults' where asked, one JSON line a
seed.  Not part of a benchmark run; run on the card from a checkout:

    python3 benchmark/calibrate.py --workload <cell> --seeds 1 2 3 --control 1 2 3 \\
        [--units 1] [--fault half_batch]

Each seed builds the cell's set-up, runs `--units` units (at least the
units a window checks) and checks them as a run does; seeds also in
`--control` read the control too, and `--fault` (training cells) adds the
reference with that fault in the program's place."""

import argparse
import json
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
sys.path[:0] = [str(BENCH), str(BENCH.parent)]

import harness  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", type=int, nargs="*", default=[])
    ap.add_argument("--units", type=int, default=1)
    ap.add_argument("--fault", default=None)
    args = ap.parse_args()
    import torch

    cell = harness.Cell(args.workload)
    for seed in args.seeds:
        t0 = time.perf_counter()
        session = cell.driver.Session(cell.config, cell.traffic, seed, "cuda")
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        units = max(args.units, session.min_units)
        for _ in range(units):
            session.run_unit()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        opts = {"control": seed in args.control}
        if args.fault and seed in args.control:
            opts["fault"] = args.fault
        readings = session.check(**opts)
        del session
        print(json.dumps({"seed": seed, "setup_s": t1 - t0, "unit_s": (t2 - t1) / units,
                          "check_s": time.perf_counter() - t2, "readings": readings}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
