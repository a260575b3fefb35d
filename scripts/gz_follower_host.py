"""Host-only timing: does panacus_tpu's gz follower pay for itself?

panacus_tpu reads a `.gz` GFA with a follower thread that classifies
lines, parses S lines and tokenizes P/W lines behind libdeflate's inflate
frontier (panacus_tpu/gz_pipeline.py); PANACUS_TPU_NO_GZ_OVERLAP=1 turns it
off, and then the whole buffer is inflated first and indexed after. The
port (panacus_torch) has no follower: it inflates, then indexes. This
script times, in turns on one gzip file, the index and the tokenize of
every path (GraphStorage construction plus all_path_item_runs, which the
follower's token cache serves when it has one):

- panacus_tpu with its follower;
- panacus_tpu with PANACUS_TPU_NO_GZ_OVERLAP=1;
- panacus_torch.

It needs the system libdeflate (without it neither package runs a
follower) and runs on the CPU only; its times are the host's, not a
device's.

    JAX_PLATFORMS=cpu python scripts/gz_follower_host.py [--nodes 300000]
        [--paths 90] [--rounds 7] [--dir build/gz_follower_host]
"""

from __future__ import annotations

import argparse
import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def timed(storage_cls, gz: str):
    """Seconds of (GraphStorage(gz), all_path_item_runs()) and whether a
    token cache served the runs."""
    t0 = time.perf_counter()
    g = storage_cls(gz, index_edges=False)
    t1 = time.perf_counter()
    runs = g.all_path_item_runs()
    t2 = time.perf_counter()
    assert runs is not None
    return t1 - t0, t2 - t1, getattr(g, "_pretok", None) is not None


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--nodes", type=int, default=300_000)
    ap.add_argument("--paths", type=int, default=90)
    ap.add_argument("--rounds", type=int, default=7)
    ap.add_argument("--dir", default=os.path.join(ROOT, "build", "gz_follower_host"))
    args = ap.parse_args()

    from panacus_torch import testgraphs
    from panacus_torch.gfa import GraphStorage as PortStorage
    from panacus_torch.runtime import effective_threads
    from panacus_tpu.gfa import GraphStorage as JaxStorage
    from panacus_tpu.native import _get_libdeflate

    if _get_libdeflate() is None:
        print("no system libdeflate: no follower runs here")
        return 1
    gfa = testgraphs.cached_graph(args.dir, args.nodes, args.paths)
    gz = gfa + ".gz"
    if not os.path.exists(gz):
        testgraphs.write_gzip(gfa, gz)
    print(
        f"{gfa}: {os.path.getsize(gfa)} bytes, one level-1 gzip member of "
        f"{os.path.getsize(gz)} bytes; {effective_threads()} host threads"
    )
    routes = {
        "panacus_tpu, follower": (JaxStorage, None),
        "panacus_tpu, PANACUS_TPU_NO_GZ_OVERLAP=1": (JaxStorage, "1"),
        "panacus_torch (no follower)": (PortStorage, None),
    }
    times = {name: [] for name in routes}
    for r in range(args.rounds + 1):  # round 0 warms the native builds
        for name, (cls, env) in routes.items():
            if env is None:
                os.environ.pop("PANACUS_TPU_NO_GZ_OVERLAP", None)
            else:
                os.environ["PANACUS_TPU_NO_GZ_OVERLAP"] = env
            res = timed(cls, gz)
            if r:
                times[name].append(res)
    os.environ.pop("PANACUS_TPU_NO_GZ_OVERLAP", None)
    for name, ts in times.items():
        index = statistics.median(t[0] for t in ts)
        tok = statistics.median(t[1] for t in ts)
        both = statistics.median(t[0] + t[1] for t in ts)
        print(
            f"{name}: median index {index:.4f} s, tokenize {tok:.4f} s, together "
            f"{both:.4f} s (token cache used in {sum(t[2] for t in ts)} of {len(ts)}); "
            "index+tokenize " + " ".join(f"{t[0] + t[1]:.4f}" for t in ts)
        )
    return 0


if __name__ == "__main__":
    sys.exit(main())
