#!/usr/bin/env python3
"""Where the time of panacus_torch's main path goes, on one NVIDIA GPU.

Run from the root of a checkout:

    python3 scripts/profile_torch_main_path.py [--out chiprun_out]

On chip_smoke.py's graph (bench.make_graph at its default size, generated
into build/chip_smoke/ if absent) it runs
`histgrowth -c all -H -q 0,0.5,1.0 -l 0,1,2` through panacus_torch's CLI in
this process:

- one first run, then three warm runs: wall and phase times of each;
- one warm run under torch.profiler: device time per kernel and per copy
  kind, summed from the trace, and the busy share of the wall; per phase
  scope (index, abaci_by_total, hists, growth: runtime.phase_timer's
  record_function scopes) the device's busy time and longest idle gap,
  and the streamed build's slab scopes (trace written to OUT/profile_trace.json);
- one warm run under cProfile: host functions by own time
  (OUT/profile_cprofile.txt);
- cold subprocesses: `import torch` alone, the port's CLI on cuda, and the
  same command through panacus_tpu with JAX_PLATFORMS=cpu (skipped when
  jax is not installed), whose TSV must equal the port's.

Then, for the group path, `ordered-histgrowth -c bp -H -q 0,0.5,1 -l 1,1,2`
and `similarity -c node -H`: one warm run each (wall and phases, the order
change's second abacus build among them) and one under torch.profiler
(device time and busy share; traces OUT/profile_trace_<command>.json).
"""

from __future__ import annotations

import argparse
import collections
import cProfile
import importlib.util
import io
import json
import os
import pstats
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402


def phases_line(label, wall, phases):
    names = (
        "index", "abaci_by_total", "hists", "growth", "order_change",
        "ordered_growth", "similarity",
    )
    split = ", ".join(f"{n} {phases.get(n, 0.0):.4f}" for n in names)
    print(f"[profile] {label}: wall {wall:.4f} s; phases (s): {split}")


def device_times(trace_path):
    """Device microseconds per (category, name) from a chrome trace."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    us = collections.Counter()
    for e in events:
        if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"):
            name = e["name"]
            if e["cat"] == "kernel":  # drop the parameter list
                name = name.replace("(anonymous namespace)::", "").split("(")[0]
            us[(e["cat"], name[:80])] += e["dur"]
    return us


def cold(cmd, env=None):
    t0 = time.perf_counter()
    r = subprocess.run(
        cmd, cwd=ROOT, env=env, capture_output=True, text=True, timeout=600
    )
    if r.returncode != 0:
        chip_smoke.fail(f"{cmd} exited {r.returncode}: {r.stderr[-2000:]}")
    return time.perf_counter() - t0, r.stdout


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join(ROOT, "chiprun_out"))
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        chip_smoke.fail("no CUDA device")
    os.makedirs(args.out, exist_ok=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    print(f"[profile] card (nvidia-smi name, power.limit): {smi}")
    gfa = chip_smoke.bench_graph()
    argv = chip_smoke.HISTGROWTH + [gfa]
    mb = os.path.getsize(gfa) / 1e6

    for label in ("first run", "warm run 1", "warm run 2", "warm run 3"):
        out, phases, wall = chip_smoke.drive(argv, "cuda")
        phases_line(f"{label} ({mb / wall:.1f} MB/s)", wall, phases)

    profiled_run(argv, os.path.join(args.out, "profile_trace.json"))

    pr = cProfile.Profile()
    pr.enable()
    _, _, wall = chip_smoke.drive(argv, "cuda")
    pr.disable()
    s = io.StringIO()
    pstats.Stats(pr, stream=s).sort_stats("tottime").print_stats(25)
    with open(os.path.join(args.out, "profile_cprofile.txt"), "w") as f:
        f.write(s.getvalue())
    print(f"[profile] cProfile run: wall {wall:.4f} s; by own time:")
    st = pstats.Stats(pr).sort_stats("tottime")
    for func in st.fcn_list[:10]:
        _, _, tottime, cumtime, _ = st.stats[func]
        where = f"{os.path.relpath(func[0], ROOT)}:{func[1]}({func[2]})"
        print(f"[profile]   {tottime:.4f} s own, {cumtime:.4f} s cum  {where}")

    t_import, _ = cold([sys.executable, "-c", "import torch"])
    print(f"[profile] cold `import torch`: {t_import:.3f} s")
    env = dict(os.environ, PANACUS_TORCH_DEVICE="cuda")
    t_port, out_port = cold([sys.executable, "-m", "panacus_torch"] + argv, env)
    print(f"[profile] cold CLI, panacus_torch on cuda: {t_port:.3f} s")
    if importlib.util.find_spec("jax") is None:
        print("[profile] cold CLI, panacus_tpu on the host CPU: skipped (no jax)")
    else:
        env = dict(os.environ, JAX_PLATFORMS="cpu")
        t_jax, out_jax = cold([sys.executable, "-m", "panacus_tpu"] + argv, env)
        same = chip_smoke.table(out_jax)[0] == chip_smoke.table(out_port)[0]
        print(
            f"[profile] cold CLI, panacus_tpu on the host CPU: {t_jax:.3f} s; "
            f"TSV equal to the port's: {same}"
        )
        if not same:
            chip_smoke.fail("panacus_tpu and panacus_torch TSVs differ")

    for name, cmd in (
        ("ordered", chip_smoke.ORDERED + ["-c", "bp"]),
        ("similarity", ["similarity", "-H", "-c", "node"]),
    ):
        out, phases, wall = chip_smoke.drive(cmd + [gfa], "cuda")
        phases_line(f"{' '.join(cmd[:3])}, warm run", wall, phases)
        profiled_run(cmd + [gfa], os.path.join(args.out, f"profile_trace_{name}.json"))
    return 0


def profiled_run(argv, trace):
    """One run under torch.profiler: device time by kind and kernel, the
    device's busy share of the wall, and per phase scope
    (runtime.phase_timer) its device-busy time and longest idle gap, with
    the streamed build's slab scopes."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, phases, wall = chip_smoke.drive(argv, "cuda")
    prof.export_chrome_trace(trace)
    phases_line(f"{' '.join(argv[:3])}, profiled run", wall, phases)
    us = device_times(trace)
    total = sum(us.values())
    print(
        f"[profile] device time {total / 1e3:.4f} ms in a {wall:.4f} s run: "
        f"busy {100 * total / 1e6 / wall:.3f}%, idle {100 - 100 * total / 1e6 / wall:.3f}%"
    )
    by_cat = collections.Counter()
    for (cat, name), t in us.items():
        by_cat[cat if cat != "gpu_memcpy" else name] += t
    for key, t in by_cat.most_common():
        print(f"[profile]   {key}: {t / 1e3:.4f} ms")
    for (cat, name), t in us.most_common(8):
        print(f"[profile]   top {cat} {name}: {t / 1e3:.4f} ms")
    chip_smoke.print_scopes("profile", chip_smoke.trace_scopes(trace), wall)


if __name__ == "__main__":
    sys.exit(main())
