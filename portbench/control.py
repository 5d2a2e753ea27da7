"""Readings of a cell's compared numbers over many seeds in one process, each
seed one run of the harness (``harness.execute``) with a short window: the
program as the cell runs it (the lower readings of the limits), or with
``--control`` the cell's lower-precision control in the program's place
(the upper readings; each of its lines has to read not correct).

    python3 portbench/control.py --workload <name> --seeds 11,12,13
        --seconds 8 [--control]

Prints one JSON line per seed.  Not run by the benchmark's runs.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--control", action="store_true")
    args = ap.parse_args(argv)
    import torch

    from portbench import harness

    if not torch.cuda.is_available():
        harness.log("no card")
        return 2
    cell = harness.find_cell(args.workload)
    harness.log(f"card {harness.power_limit()}")
    for seed in (int(s) for s in args.seeds.split(",")):
        notes = {}
        line = harness.execute(cell, seed, args.seconds, False, "cuda:0",
                               time.perf_counter(), control=args.control,
                               notes=notes)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control": args.control,
                          "correct": line["correct"],
                          "attempted": line["attempted"],
                          "failed": line["failed"], **notes}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
