"""The benchmark of panacus_torch: cells of BENCHMARK.json, each one graph
configuration under one traffic mix, run through the CLI entry in process.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything that belongs to one configuration, traffic mix, compared number,
per-layer metric or kernel sits in a file of its own, found by name:
configs/<config>.json, traffic/<traffic>.json, limits/<cell>.json,
metrics/<metric>.py, kernels/<kernel>.py. The plain reference that decides
`correct` is reference/ and imports nothing of the program.
"""
