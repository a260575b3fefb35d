"""The readings that the limits of limits/<cell>.json are set from: the
compared numbers of the program's runs (the lower readings) and of the
controls of the cell's reference module (the upper readings: for
histgrowth, the reference computed in float32 in the program's place), for
many seeds in one process.

    python3 benchmark/readings.py --cells A,B --seeds 1,2,3 --seconds 3 [--control 3]

For each seed and cell: the cell's inputs at its own size, a short window of
its traffic on the first card, every TSV against the reference; then, for
the first `--control` seeds, each control's table against the same
reference. One JSON line per seed and cell on stdout. The benchmark's runs
do not run this.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark import harness  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--cells", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--control", type=int, default=3)
    args = p.parse_args(argv)
    import torch

    from panacus_torch import cli

    harness.quiet_program_logs()
    devices = (torch.device("cuda", 0),)
    seeds = [int(s) for s in args.seeds.split(",")]
    for i, seed in enumerate(seeds):
        for name in args.cells.split(","):
            cell = harness.Cell.load(name)
            work = tempfile.mkdtemp(prefix="readings-")
            try:
                t0 = time.perf_counter()
                inputs = harness.prepare_inputs(cell, seed, work=work)
                cmds = harness.run_commands(cli.run_cli, inputs.argv, devices, args.seconds, work)
                t1 = time.perf_counter()
                ref = cell.reference
                want = ref.reference_tables(inputs.argv)
                program = harness.compare_outputs(cmds, ref, want)
                t2 = time.perf_counter()
                line = {"cell": name, "seed": seed, "commands": len(cmds), "program": program,
                        "reference_s": t2 - t1, "run_s": t1 - t0}
                if i < args.control:
                    line["control"] = {k: ref.compare(text, want)
                                       for k, text in ref.controls(inputs.argv, want).items()}
                    line["control_s"] = time.perf_counter() - t2
                print(json.dumps(line), flush=True)
            finally:
                shutil.rmtree(work, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
