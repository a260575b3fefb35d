"""The port's measuring program: end-to-end histgrowth throughput on the
make_graph graph, the group stages checked against a host oracle, and the
device roofline, in one run and one JSON line.

    python -m panacus_torch.bench

The counterpart of bench.py's counting modes (run_inner with the stage
table and the group tail of run_inner_tpu, and run_roofline with
_xor_read_bw) on the port. bench.py still measures only the JAX package.

Graph: testgraphs.make_graph at PANACUS_BENCH_NODES x PANACUS_BENCH_PATHS
(900,000 x 90 by default: 337 MB, HPRC chr22 pggb scale), cached in
build/chip_smoke/ with a one-member level-1 gzip beside it. Devices:
runtime.resolve_devices(), as the CLI takes them: every visible GPU by
default, the CPU under PANACUS_TORCH_DEVICE=cpu; without a card and
without that setting the run fails.

1. Stages: histgrowth (node + bp + edge hists and growth at -q 0,0.5,1.0
   -l 0,1,2) through the CLI's GraphBroker (GraphStorage, the haplotype
   mask, the streamed build or, where the tokenizer bails, the classic
   itemizer; construct_hists), then calc_all_growths, at `all` (6 reps),
   `node`, `edge` and `gz_node` (4 reps each), one warm-up each. A stage's
   MB/s is the uncompressed GFA's MB of every rep over their summed wall;
   the best and the median rep's MB/s stand beside it. Each stage records
   the route the broker's build took.
2. Group tail: GraphBroker with haplotype grouping, ordered growth (c=1,
   q=0) and the similarity matrix, cold and warm, then the ordered vector
   and the whole intersection matrix against a numpy oracle that parses
   the GFA's path lines itself.
3. Roofline (on a card only): pt_fused_hist over M 32 x 2^23 random words
   (1.07 GB) and one weight row below 2^20, exact against its plain
   version once, then timed by slope (kernel_times.slope_ms, call i reading
   weights + i); the raw-read control pt_xor_fold on the same bytes by
   probe.read_ceiling_bps in the same run. Rates count M and the weights
   read once.

Stderr carries the [bench] lines (every rep's wall); stdout one JSON line:
metric, value, unit, vs_baseline, stages (MB/s), stages_best,
stages_median, routes, host_mem_mbps, group_stages, device_bw_gbps,
device_bw_frac (of the card's HBM peak, null for a card
runtime.hbm_peak_bytes_per_s does not know), device_read_gbps,
device_frac_of_read, device. The device_* rates are null on the CPU. Any
failing stage, and a group result that disagrees with the oracle, raises:
the run exits non-zero and prints no JSON.
"""

from __future__ import annotations

import argparse
import functools
import gc
import json
import os
import statistics
import subprocess
import sys
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from . import kernel_times, probe, runtime, testgraphs
from .broker import GraphBroker, GraphState, Req
from .config import Grouping
from .hist import Hist
from .ops import hist_kernels as hk
from .ops import kernels
from .utils import CountType, Threshold, ThresholdContainer

# the reference panacus on the 402 MB HPRC chr22 pggb graph: 17 s node,
# 79 s edge (BASELINE.md)
BASELINE_ALL_MBPS = 402.0 / (17.0 + 79.0)
BASELINE_NODE_MBPS = 402.0 / 17.0
BASELINE_EDGE_MBPS = 402.0 / 79.0

N_NODES, N_PATHS = testgraphs.N_NODES, testgraphs.N_PATHS
GRAPH_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "build", "chip_smoke"
)
COUNTS = {"all": (Req.NODE, Req.BP, Req.EDGE), "node": (Req.NODE,), "edge": (Req.EDGE,)}
# (stage, count, gzip input, reference MB/s, reps)
STAGES = (
    ("all", "all", False, BASELINE_ALL_MBPS, 6),
    ("node", "node", False, BASELINE_NODE_MBPS, 4),
    ("edge", "edge", False, BASELINE_EDGE_MBPS, 4),
    ("gz_node", "node", True, BASELINE_NODE_MBPS, 4),
)
QUORUM, COVERAGE = "0,0.5,1.0", "0,1,2"
ROOF_WORDS, ROOF_ITEMS = 32, 1 << 23  # 1024 groups x 8.4M items = 1.07 GB
DEVICE_FIELDS = ("device_bw_gbps", "device_bw_frac", "device_read_gbps", "device_frac_of_read")


class BenchError(RuntimeError):
    pass


def run_histgrowth(gfa: str, count: str, devices):
    """One histgrowth run through the CLI's broker (GraphStorage, the
    haplotype mask, the streamed build or, where the tokenizer bails, the
    classic itemizer; construct_hists), then calc_all_growths; count: 'all'
    | 'node' | 'edge'. Returns (hists, growth count, (index, build, hist
    tail, growth) seconds, the broker's build route)."""
    gb = GraphBroker(devices)
    reqs = {Req.graph(gfa), Req.HIST, *COUNTS[count]}
    with runtime.phase_log() as phases:
        gb.change_graph_state(
            GraphState(graph=gfa, name="bench", grouping=Grouping.haplotype()),
            reqs,
            nice=False,
        )
    t0 = time.perf_counter()
    tc = ThresholdContainer.parse_params(QUORUM, COVERAGE)
    n_growth = sum(len(h.calc_all_growths(tc)) for h in gb.hists.values())
    t_growth = time.perf_counter() - t0
    times = (phases["index"], phases["abaci_by_total"], phases["hists"], t_growth)
    return gb.hists, n_growth, times, gb.build_route


def _timed_stage(name, fn, size_mb, baseline, reps):
    """One warm-up, then `reps` runs. Returns (MB/s over the summed walls of
    every rep, the best rep's MB/s, the median rep's, the routes every run
    took joined by ',', the last run's result)."""
    res = fn()
    routes = {res[3]}
    walls = []
    for rep in range(reps):
        gc.collect()
        t0 = time.perf_counter()
        res = fn()
        walls.append(time.perf_counter() - t0)
        routes.add(res[3])
        ph = res[2]
        sys.stderr.write(
            f"[bench] {name} pass {rep}: {size_mb:.1f} MB in {walls[-1]:.4f}s "
            f"(index {ph[0]:.4f}s, {res[3]} build {ph[1]:.4f}s, "
            f"device-tail {ph[2]:.4f}s, growth {ph[3]:.4f}s)\n"
        )
    mbps = size_mb * reps / sum(walls)
    best, median = size_mb / min(walls), size_mb / statistics.median(walls)
    sys.stderr.write(
        f"[bench] {name}: {mbps:.1f} MB/s over {reps} reps (best {best:.1f}, "
        f"median {median:.1f}; reference {baseline:.1f} MB/s => {mbps / baseline:.1f}x); "
        "walls " + " ".join(f"{w:.4f}" for w in walls) + "\n"
    )
    return mbps, best, median, ",".join(sorted(routes)), res


def _host_memory_health() -> float:
    """Fresh-anon-page touch throughput (MB/s), bench.py's: on a ballooned
    VM (firecracker with free-page reporting) page-fault service can degrade
    from microseconds to ~0.15 ms/4K page (>100x), which tanks every
    allocation-heavy stage regardless of code. Recording it makes a
    bad-window artifact interpretable: ~2000+ MB/s is a healthy window,
    <500 is degraded."""
    n = 64 << 20
    t0 = time.time()
    b = bytearray(n)
    mv = memoryview(b)
    for i in range(0, n, 4096):
        mv[i] = 1
    dt = time.time() - t0
    del mv, b
    return round(n / 1e6 / max(dt, 1e-9), 0)


# every byte but the decimal digits maps to a space
_DIGITS_ONLY = bytes(c if 48 <= c <= 57 else 32 for c in range(256))


def _path_lines(data: bytes):
    """(file offset, sample#hap, walk bytes) of every P and W line."""
    out = []
    for tag in (b"\nP\t", b"\nW\t"):
        at = data.find(tag)
        while at >= 0:
            end = data.find(b"\n", at + 1)
            end = len(data) if end < 0 else end
            fields = data[at + 3 : end].split(b"\t")
            if tag == b"\nP\t":
                sample, hap = fields[0].split(b"#")[:2]
                walk = fields[1]
            else:
                sample, hap, walk = fields[0], fields[1], fields[5]
            out.append((at, f"{sample.decode()}#{hap.decode()}", walk))
            at = data.find(tag, end)
    return sorted(out, key=lambda t: t[0])


def _oracle_membership(gfa: str) -> np.ndarray:
    """bool [haplotypes, nodes + 1] of a make_graph GFA, parsed here in
    numpy, apart from the port's tokenizer and grouping. make_graph names
    its nodes 1..n in S-line order, so a node's name is its item id; its
    paths are P lines `s<i>#<hap>#chr1` and W lines `s<i> <hap> chr1`. A
    group is sample#hap, the groups in the file order of their first path."""
    with open(gfa, "rb") as f:
        data = f.read()
    n_nodes = data.count(b"\nS\t") + data.startswith(b"S\t")
    rows: Dict[str, np.ndarray] = {}
    for _, group, walk in _path_lines(data):
        ids = np.fromstring(walk.translate(_DIGITS_ONLY), dtype=np.int64, sep=" ")
        rows.setdefault(group, np.zeros(n_nodes + 1, dtype=bool))[ids] = True
    return np.stack(list(rows.values()))


def _intersections(mem: np.ndarray, chunk: int = 1 << 17) -> np.ndarray:
    """int64 [groups, groups] of shared nodes, float32 products of column
    chunks (each chunk's counts stay below 2^24, so exact)."""
    out = np.zeros((len(mem), len(mem)), dtype=np.int64)
    for c in range(0, mem.shape[1], chunk):
        part = mem[:, c : c + chunk].astype(np.float32)
        out += (part @ part.T).astype(np.int64)
    return out


def run_group_tail(gfa: str, devices):
    """GraphBroker with haplotype grouping on the node count; ordered growth
    (c=1, q=0) and the similarity matrix, each cold and warm; then the
    ordered vector and the whole intersection matrix against a numpy
    oracle built from the GFA alone. Returns (the group_stages fields, the
    ordered vector, the intersection matrix); raises BenchError on a
    mismatch."""
    gb = GraphBroker(devices)
    t0 = time.perf_counter()
    gb.change_graph_state(
        GraphState(graph=gfa, name="bench", grouping=Grouping.haplotype()),
        {Req.graph(gfa), Req.NODE, Req.HIST, Req.abacus_by_group(CountType.NODE)},
        nice=False,
    )
    t_build = time.perf_counter() - t0
    ab = gb.get_abacus_by_group()

    def timed(fn):
        t1 = time.perf_counter()
        res = fn()
        return res, time.perf_counter() - t1

    def ordered():
        return np.asarray(ab.calc_growth(Threshold.absolute(1), Threshold.rel(0.0)))

    def similarity():
        return np.asarray(ab.similarity_matrix()[0])

    # the first calls pay the one-time costs (allocations, threshold copies)
    _, t_ordered_cold = timed(ordered)
    og, t_ordered = timed(ordered)
    _, t_sim_cold = timed(similarity)
    inter, t_sim = timed(similarity)
    del gb, ab

    t1 = time.perf_counter()
    mem = _oracle_membership(gfa)
    og_want = np.logical_or.accumulate(mem, axis=0).sum(axis=1).astype(np.float64)
    ordered_ok = bool(np.array_equal(og, og_want))
    sim_ok = inter.shape == (len(mem),) * 2 and bool(
        np.array_equal(inter.astype(np.int64), _intersections(mem))
    )
    t_oracle = time.perf_counter() - t1
    if not (ordered_ok and sim_ok):
        raise BenchError(
            f"group outputs disagree with the host oracle: ordered_ok={ordered_ok} "
            f"sim_ok={sim_ok} (device og[-1]={og[-1]}, host {og_want[-1]})"
        )
    sys.stderr.write(
        f"[bench] group abacus: ordered {t_ordered:.4f}s (cold {t_ordered_cold:.4f}s), "
        f"similarity {t_sim:.4f}s (cold {t_sim_cold:.4f}s); verified against the "
        f"host oracle from the GFA (ordered vector, whole {len(mem)}x{len(mem)} "
        f"intersection matrix) in {t_oracle:.2f}s\n"
    )
    fields = {
        "build_s": t_build,
        "ordered_cold_s": t_ordered_cold,
        "ordered_s": t_ordered,
        "similarity_cold_s": t_sim_cold,
        "similarity_s": t_sim,
        "ordered_last": float(og[-1]),
        "sim_trace": float(np.trace(inter)),
        "verified": True,
    }
    return fields, og, inter


def run_roofline(device: torch.device) -> Dict[str, Optional[float]]:
    """pt_fused_hist over the 1.07 GB M by slope, against the card's HBM
    peak and against pt_xor_fold's read of the same bytes in this run.
    Returns the four device_* fields: null on the CPU, device_bw_frac null
    on a card of unknown peak. Raises BenchError if the kernel's hist on
    this M differs from its plain version's."""
    fields: Dict[str, Optional[float]] = dict.fromkeys(DEVICE_FIELDS)
    if device.type != "cuda":
        sys.stderr.write(
            "[bench] roofline: left out on the CPU (PANACUS_TORCH_DEVICE=cpu); "
            "its fields are null\n"
        )
        return fields
    name = torch.cuda.get_device_name(device)
    n_bins = probe.n_bins_for(ROOF_WORDS)
    with torch.cuda.device(device):
        M, w = probe.make_inputs(device, ROOF_WORDS, ROOF_ITEMS, seed=0)
        if not torch.equal(hk.fused_hist(M, w, n_bins), hk.fused_hist_ref(M, w, n_bins)):
            raise BenchError("pt_fused_hist differs from its plain version on the roofline M")
        nbytes = probe.pass_bytes(M, w)
        # call i of a chain reads weights + i, a copy of its own
        fns = [
            functools.partial(hk.fused_hist, M, w + i, n_bins)
            for i in range(3 * kernel_times.K)
        ]
        bw = nbytes / (kernel_times.slope_ms(fns) / 1e3)
        del M, w, fns
        torch.cuda.empty_cache()
        read_bw = probe.read_ceiling_bps(device, ROOF_WORDS, ROOF_ITEMS, seed=0)
    peak = runtime.hbm_peak_bytes_per_s(name)
    fields["device_bw_gbps"] = bw / 1e9
    fields["device_read_gbps"] = read_bw / 1e9
    fields["device_frac_of_read"] = bw / read_bw
    if peak is None:
        sys.stderr.write(f"[bench] roofline: no HBM peak known for {name}; device_bw_frac is null\n")
    else:
        fields["device_bw_frac"] = bw / peak
    sys.stderr.write(
        f"[bench] roofline ({name}): {nbytes / 1e6:.0f} MB weighted hist => "
        f"{bw / 1e9:.1f} GB/s"
        + (f" = {bw / peak:.3f} of HBM peak ({peak / 1e9:.0f} GB/s)" if peak else "")
        + f"; raw xor read {read_bw / 1e9:.1f} GB/s => kernel at {bw / read_bw:.3f} "
        "of the measured read\n"
    )
    return fields


def device_info(devices):
    """{"name", "power_limit_w", "count"} of the cards from nvidia-smi, or
    "cpu"."""
    if devices[0].type != "cuda":
        return "cpu"
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    name, limit = (s.strip() for s in smi.rsplit(",", 1))
    return {
        "name": name,
        "power_limit_w": float(limit.split()[0]),
        "count": torch.cuda.device_count(),
    }


def run(gfa: str, devices) -> Tuple[dict, Dict[CountType, Hist]]:
    """Every measurement on `gfa` (its gzip beside it, written once):
    (the JSON object, the hists of the `all` stage's last run)."""
    devices = tuple(devices)
    if devices[0].type == "cuda":
        t0 = time.perf_counter()
        kernels.build_all()
        sys.stderr.write(f"[bench] kernel builds: {time.perf_counter() - t0:.3f} s\n")
    gz = gfa + ".gz"
    if not os.path.exists(gz):
        t0 = time.perf_counter()
        testgraphs.write_gzip(gfa, gz)
        sys.stderr.write(
            f"[bench] gzipped graph in {time.perf_counter() - t0:.1f}s "
            f"({os.path.getsize(gz) / 1e6:.0f} MB)\n"
        )
    size_mb = os.path.getsize(gfa) / 1e6
    mem_health = _host_memory_health()
    sys.stderr.write(f"[bench] host fresh-page touch: {mem_health:.0f} MB/s\n")

    stages, best, median, routes, hists = {}, {}, {}, {}, None
    for stage, count, gzipped, baseline, reps in STAGES:
        src = gz if gzipped else gfa
        stages[stage], best[stage], median[stage], routes[stage], res = _timed_stage(
            f"histgrowth {stage}",
            lambda c=count, s=src: run_histgrowth(s, c, devices),
            size_mb,
            baseline,
            reps,
        )
        if stage == "all":
            hists = res[0]
    out = {
        "metric": "histgrowth_all_throughput",
        "value": stages["all"],
        "unit": "MB/s",
        "vs_baseline": stages["all"] / BASELINE_ALL_MBPS,
        "stages": stages,
        "stages_best": best,
        "stages_median": median,
        "routes": routes,
        "host_mem_mbps": mem_health,
        "group_stages": run_group_tail(gfa, devices)[0],
        **run_roofline(devices[0]),
        "device": device_info(devices),
    }
    return out, hists


def main(argv: Optional[List[str]] = None) -> int:
    argparse.ArgumentParser(
        prog="python -m panacus_torch.bench", description=__doc__.split("\n\n")[0]
    ).parse_args(argv)
    devices = runtime.resolve_devices()
    gfa = testgraphs.cached_graph(GRAPH_DIR, N_NODES, N_PATHS)
    out, _ = run(gfa, devices)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
