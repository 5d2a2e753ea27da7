"""One run of one benchmark cell on the card:

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s>
        --trace <0|1> [--control]

(or ``python3 -m portbench.run ...`` from the checkout's root).  Prints the
result as the last line of stdout, and the compared numbers with their
limits as the last lines of stderr.  ``--control`` serves the cell's
lower-precision control in the program's place, which has to come out not
correct; the benchmark's runs never pass it.  Exits 2 without a result when the
machine has fewer cards than the cell asks for, 3 when a module of JAX or of
the JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# the kernel and compile caches of whatever the program builds stay inside
# the checkout, at fixed paths (the port's nvcc builds go to its own build/)
CACHE = ROOT / ".benchcache"
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
os.environ["CUDA_CACHE_PATH"] = str(CACHE / "cuda")
os.environ["USE_FLAX"] = "0"
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", action="store_true")
    args = ap.parse_args(argv)

    from portbench import harness

    cell = harness.find_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        harness.log(f"{args.workload} needs {cell.chips} card(s); "
                    f"cuda available: {torch.cuda.is_available()}")
        return 2
    torch.set_num_threads(4)
    harness.log(f"card {harness.power_limit()}, torch {torch.__version__}")
    try:
        line = harness.execute(cell, args.seed, args.seconds,
                               bool(args.trace), "cuda:0", T_START,
                               control=args.control)
    except SystemExit as err:
        harness.log(str(err))
        return 3
    harness.report(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
