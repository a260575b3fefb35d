"""Run one cell of BENCHMARK.json on this machine's card and print its
result as the last line of stdout.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Exits non-zero with no result line when no card is visible, or fewer than
the cell asks for, and when a module of JAX or of the JAX package is loaded
once the window has closed.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, "build", "benchmark", "cache")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    # caches of any CUDA tool chain the process loads stay in the checkout,
    # at fixed paths (the program's nvcc libraries go to build/ already)
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = os.path.join(CACHE, sub)
    sys.path.insert(0, ROOT)
    import torch

    from benchmark.harness import Cell, run_cell

    cell = Cell.load(args.workload, ROOT)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        sys.stderr.write(
            f"the cell needs {cell.chips} CUDA card(s); "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} visible\n"
        )
        return 2
    devices = tuple(torch.device("cuda", i) for i in range(cell.chips))
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), devices, T_PROCESS)
    sys.stdout.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
