"""Kernel times on the card: pt_fused_hist, pt_coverage,
pt_ordered_growth, pt_similarity and pt_limb_hist of this checkout, alone or
in turns with another build of the same C interface.

    python -m panacus_torch.kernel_times [--other DIR] [--graph] [--rounds R]
                                         [--kernels NAME ...]

Inputs (random bits and weights from a seeded torch.Generator on the card,
as chip_smoke.py makes them):
  edge M    3 x 3,604,480, 90 groups: the width of the main path's edge
            matrix; pt_fused_hist with two weight vectors (ones and
            bp-like lengths 1-16), pt_coverage, and pt_ordered_growth with
            unit weights at each (quorum, coverage floor) of
            ordered-histgrowth -q 0,0.5,1 -l 1,1,2
  1 GiB M   32 x 2^23, 1024 groups, one vector of ones (pt_fused_hist,
            pt_coverage)
  4096      128 x 2^20, 4096 groups, weights below 2^31 (pt_fused_hist,
            pt_coverage)
  and pt_ordered_growth beyond the edge M: the node M's width (3 x
  917,504) with bp-like weights at the same three (quorum, floor), 1024
  groups x 2^20, 4096 groups x 2^18 and 30,000 groups x 2^16 items with
  weights below 2^31 at (0, 1) and (0.5, 2)
  pt_similarity on the node M's width with bp-like weights (max(w) given,
  as the engine gives it) and on 1024 groups x 2^20 with weights below 2^31
  pt_limb_hist on the probe's inputs (panacus_torch.probe: M 32 x 2^23 of
  random bits, one weight vector below 2^20, 1.107 GB) on each route, the
  weight byte on the coarse operand (old), on the fine one (fh2) and the
  fine one with the coverage on the tensor cores (fhm), at 1, 2 and 3 limbs
With --graph also the path's own inputs: the arguments that
`histgrowth -c all -H` and `ordered-histgrowth -H -c edge` (same -q and
-l) hand the two wrappers on testgraphs.make_graph's graph, generated into
build/chip_smoke/ and captured from runs of the port's CLI on cuda.

--other DIR: a directory with another build's hist.cu, group.cu, probe.cu
and common.cuh (e.g. a parent commit's panacus_torch/csrc, unpacked with
git archive under build/). They are built with the same nvcc flags into
build/kernel_times/ and called as that build's wrappers called them: a
zeroed output, or a zeroed difference array, per call. Every result of the
other build must equal this checkout's (unless --unchecked: a copy with
parts taken out, timed only). Each round times other, this,
this, other.

Two times per call, in ms: `ev`, the median of single calls between CUDA
events with the L2 cache flushed before each (chip_smoke.py phase 2's
measure: the window holds the host's launch latency too); `slope`, the
per-call slope between chains of K and 3K calls, each chain queued behind a
device-side sleep that outlasts its queueing (doubled until it does) so
that it runs back to back, the calls rotating over
four copies of inputs smaller than 200 MB (each call finds its copy out of
the 50 MB L2 cache). Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import io
import os
import statistics
import subprocess
import sys
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import probe, testgraphs
from .ops import group_kernels as gk
from .ops import hist_kernels as hk
from .ops import kernels
from .ops import probe_kernels as pk

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORK = os.path.join(ROOT, "build", "kernel_times")
GRAPH_DIR = os.path.join(ROOT, "build", "chip_smoke")
K = 16
REPS = 5
SLEEP_CYCLES = 20_000_000  # about 10 ms of device clock: the first sleep a chain waits behind
COPIES_BELOW = 200 << 20  # inputs smaller than this rotate over four copies
ORDERED_QC = ((0.0, 1), (0.5, 1), (1.0, 2))  # ordered-histgrowth -q 0,0.5,1 -l 1,1,2
ORDERED_ARGV = ["ordered-histgrowth", "-H", "-q", "0,0.5,1", "-l", "1,1,2"]
KERNELS = ("pt_fused_hist", "pt_coverage", "pt_ordered_growth", "pt_similarity",
           "pt_limb_hist")
SOURCE_OF = {name: src for name, (src, _) in kernels._SIGNATURES.items()}
CHAIN_TRIES = 4  # a chain queued past the end of its sleep runs again, behind twice the sleep
HISTGROWTH_ARGV = ["histgrowth", "-c", "all", "-H", "-q", "0,0.5,1.0", "-l", "0,1,2"]


# -- inputs --------------------------------------------------------------------


def random_m(n_words, n_pad, n_groups, dev, g):
    """Random membership bits for n_groups groups; the sentinel item is empty."""
    M = torch.randint(
        -(2**31), 2**31, (n_words, n_pad), dtype=torch.int32, device=dev, generator=g
    )
    if n_groups % 32:
        M[-1] &= (1 << (n_groups % 32)) - 1
    M[:, 0] = 0
    return M


def random_w(n_pad, style, dev, g):
    """int32 item weights: all ones, bp-like node lengths 1-16, or anything
    below 2^31; the sentinel weighs 0."""
    if style == "ones":
        w = torch.ones(n_pad, dtype=torch.int32, device=dev)
    else:
        hi = 17 if style == "bp" else 2**31
        w = torch.randint(1, hi, (n_pad,), dtype=torch.int32, device=dev, generator=g)
    w[0] = 0
    return w


def thresholds(n_groups: int, quorum: float) -> torch.Tensor:
    """thr[g] = ceil((g + 1) * quorum), on the host in float64 as the engine
    takes them (and leaves them: the wrapper checks them there)."""
    thr = np.ceil(np.arange(1, n_groups + 1, dtype=np.int64) * quorum).astype(np.int32)
    return torch.from_numpy(thr)


@contextlib.contextmanager
def capture():
    """Record the arguments that the engine hands hist_kernels.fused_hist,
    hist_kernels.coverage, group_kernels.ordered_growth and
    group_kernels.similarity while the block runs; the calls go through
    (and count their launches) as before."""
    calls: Dict[str, list] = {"pt_fused_hist": [], "pt_coverage": [],
                              "pt_ordered_growth": [], "pt_similarity": []}
    fused_hist, coverage = hk.fused_hist, hk.coverage
    ordered_growth, similarity = gk.ordered_growth, gk.similarity

    def fused_hist_spy(M, W, n_bins):
        calls["pt_fused_hist"].append((M, W, n_bins))
        return fused_hist(M, W, n_bins)

    def coverage_spy(M):
        calls["pt_coverage"].append((M,))
        return coverage(M)

    def ordered_growth_spy(M, w, thr, c_min):
        calls["pt_ordered_growth"].append((M, w, thr, c_min))
        return ordered_growth(M, w, thr, c_min)

    def similarity_spy(M, w, w_max=None):
        calls["pt_similarity"].append((M, w, w_max))
        return similarity(M, w, w_max)

    hk.fused_hist, hk.coverage, gk.ordered_growth, gk.similarity = (
        fused_hist_spy, coverage_spy, ordered_growth_spy, similarity_spy)
    try:
        yield calls
    finally:
        hk.fused_hist, hk.coverage = fused_hist, coverage
        gk.ordered_growth, gk.similarity = ordered_growth, similarity


def path_inputs(gfa: str):
    """(fused_hist args of the edge pass, [ordered_growth args] of the edge
    run) from one run of each command through the port's CLI on the first
    card alone (one shard: the arguments are whole matrices)."""
    from .cli import run_cli

    with capture() as calls, contextlib.redirect_stdout(io.StringIO()):
        for argv in (HISTGROWTH_ARGV + [gfa], ORDERED_ARGV + ["-c", "edge", gfa]):
            if run_cli(argv, devices=(torch.device("cuda", 0),)) != 0:
                raise RuntimeError(f"{argv} failed")
    torch.cuda.synchronize()
    edge_hist = max(calls["pt_fused_hist"], key=lambda a: a[0].shape[1])
    return edge_hist, calls["pt_ordered_growth"]


# -- timing --------------------------------------------------------------------


def event_ms(fn: Callable[[], object], reps: int, flush: torch.Tensor) -> float:
    """Median ms of single calls between CUDA events, L2 flushed before each."""
    fn()  # warm-up
    times = []
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        times.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in times)


_sleep_cycles = SLEEP_CYCLES  # doubled for good when a chain outlasts it


def _chain_ms(fns: Sequence[Callable[[], object]], n: int) -> float:
    """ms of a chain of n calls queued behind a device-side sleep. The chain
    ran back to back only if the sleep was still running when its last call
    was queued (the event after the sleep had not completed); if not, the
    sleep doubles (for every later chain too) and the chain runs again, up
    to CHAIN_TRIES times."""
    global _sleep_cycles
    for _ in range(CHAIN_TRIES):
        torch.cuda._sleep(_sleep_cycles)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        t0 = time.perf_counter()
        for i in range(n):
            fns[i % len(fns)]()
        queued_ms = (time.perf_counter() - t0) * 1e3
        asleep = not start.query()
        end.record()
        end.synchronize()
        if asleep:
            return start.elapsed_time(end)
        _sleep_cycles *= 2
    raise RuntimeError(
        f"queueing {n} calls took {queued_ms:.2f} ms, past the end of a device-side "
        f"sleep of {_sleep_cycles // 2} cycles, {CHAIN_TRIES} times (the sleep doubling "
        f"each time): the chain did not run back to back"
    )


def slope_ms(fns: Sequence[Callable[[], object]], k: int = K) -> float:
    """ms per call: the slope between chains of k and 3k calls (medians of
    REPS chains each), rotating over fns."""
    _chain_ms(fns, k)
    _chain_ms(fns, 3 * k)
    t1, t3 = [], []
    for _ in range(REPS):
        t1.append(_chain_ms(fns, k))
        t3.append(_chain_ms(fns, 3 * k))
    dt = statistics.median(t3) - statistics.median(t1)
    if dt <= 0:
        raise RuntimeError(f"chain time does not grow with its length ({dt!r} ms)")
    return dt / (2 * k)


def copies(tensors: Sequence[torch.Tensor]) -> List[Tuple[torch.Tensor, ...]]:
    """The inputs and, where together they fit in COPIES_BELOW bytes, three
    more copies of them, for the slope's rotation."""
    nbytes = sum(t.numel() * t.element_size() for t in tensors)
    n = 4 if nbytes < COPIES_BELOW else 1
    return [tuple(tensors)] + [tuple(t.clone() for t in tensors) for _ in range(n - 1)]


# -- another build of the same C interface -------------------------------------

def build_other(csrc: str) -> Dict[str, ctypes.CDLL]:
    """Build the other csrc's hist.cu, group.cu and probe.cu into WORK, one
    nvcc each, all at once; returns source -> library."""
    with open(os.path.join(csrc, "common.cuh")) as f:
        common = f.read()
    texts = {}
    for tag in ("hist", "group", "probe"):
        with open(os.path.join(csrc, f"{tag}.cu")) as f:
            texts[tag] = f.read()
    procs = {}
    for tag, text in texts.items():
        d = os.path.join(WORK, tag)
        os.makedirs(d, exist_ok=True)
        for name, body in ((f"{tag}.cu", text), ("common.cuh", common)):
            with open(os.path.join(d, name), "w") as f:
                f.write(body)
        so = os.path.join(d, f"{tag}.so")
        procs[tag] = (so, subprocess.Popen(
            [kernels._nvcc(), *kernels.NVCC_FLAGS, "-o", so, os.path.join(d, f"{tag}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ))
    libs = {}
    for tag, (so, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on the other build's {tag}:\n{log}")
        print(f"other {tag} ptxas: {_ptxas(log)}")
        lib = ctypes.CDLL(so)
        for name, (src, argtypes) in kernels._SIGNATURES.items():
            if src == tag:
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
        libs[tag] = lib
    return libs


def _ptxas(log: str) -> List[str]:
    """Each kernel's registers, stack and spills from an nvcc -Xptxas -v log."""
    keep = ("Function properties", "spill", "Used")
    return [l.split(":", 1)[-1].strip() for l in log.splitlines() if any(k in l for k in keep)]


def _call(lib: ctypes.CDLL, name: str, *args) -> None:
    rc = getattr(lib, name)(*args)
    if rc != 0:
        raise RuntimeError(f"{name} of the other build failed: CUDA error {rc}")


def other_fused_hist(lib, M, W, n_bins):
    out = torch.zeros((W.shape[0], n_bins), dtype=torch.int64, device=M.device)
    _call(lib, "pt_fused_hist", M.data_ptr(), M.shape[0], M.shape[1], W.data_ptr(),
          W.shape[0], n_bins, out.data_ptr(), torch.cuda.current_stream().cuda_stream)
    return out


def other_coverage(lib, M):
    cov = torch.empty(M.shape[1], dtype=torch.int32, device=M.device)
    _call(lib, "pt_coverage", M.data_ptr(), M.shape[0], M.shape[1], cov.data_ptr(),
          torch.cuda.current_stream().cuda_stream)
    return cov


def other_similarity(lib, M, w, w_max):
    n_words, n_pad = M.shape
    planes = gk.n_planes(w_max)
    part_elems = ctypes.c_longlong()
    rc = lib.pt_similarity_scratch(n_words, n_pad, planes, ctypes.byref(part_elems))
    if rc != 0:
        raise RuntimeError(f"pt_similarity_scratch of the other build failed: CUDA error {rc}")
    part = torch.empty(part_elems.value, dtype=torch.int32, device=M.device)
    out = torch.empty((32 * n_words, 32 * n_words), dtype=torch.int64, device=M.device)
    _call(lib, "pt_similarity", M.data_ptr(), n_words, n_pad, w.data_ptr(), planes,
          part.data_ptr(), part_elems.value, out.data_ptr(),
          torch.cuda.current_stream().cuda_stream)
    return out


def other_limb_hist(lib, M, W, n_bins, n_limbs, weight_side, mma_cov):
    n_coarse = pk.n_coarse_for(n_bins)
    out = torch.zeros((n_limbs * W.shape[0], n_coarse * pk.FINE), dtype=torch.int64,
                      device=M.device)
    _call(lib, "pt_limb_hist", M.data_ptr(), M.shape[0], M.shape[1], W.data_ptr(),
          W.shape[0], n_limbs, n_coarse, int(weight_side == "coarse"), int(mma_cov), 0,
          0, out.data_ptr(), torch.cuda.current_stream().cuda_stream)
    return out


def other_ordered_growth(lib, M, w, thr, c_min):
    n_groups = thr.shape[0]
    diff = torch.zeros(n_groups + 1, dtype=torch.int64, device=M.device)
    out = torch.empty(n_groups, dtype=torch.int64, device=M.device)
    _call(lib, "pt_ordered_growth", M.data_ptr(), M.shape[0], M.shape[1], n_groups,
          w.data_ptr(), gk.thresholds_on(M.device, thr).data_ptr(), c_min,
          diff.data_ptr(), out.data_ptr(), torch.cuda.current_stream().cuda_stream)
    return out


# -- the run -------------------------------------------------------------------


def _cases(dev, path):
    """(label, kernel, this build's call, other build's call (lib -> fn),
    inputs): the calls take the inputs as arguments."""
    g = torch.Generator(device=dev)
    g.manual_seed(1)
    cases = []
    for label, n_words, n_pad, n_groups, wstyles in (
        ("edge M", 3, 3_604_480, 90, ("ones", "bp")),
        ("1 GiB M", 32, 1 << 23, 1024, ("ones",)),
        ("4096 groups", 128, 1 << 20, 4096, ("max31",)),
    ):
        M = random_m(n_words, n_pad, n_groups, dev, g)
        W = torch.stack([random_w(n_pad, s, dev, g) for s in wstyles])
        n_bins = n_groups + 2
        shape = f"{label} random ({n_words} x {n_pad}, {n_groups} groups, {'+'.join(wstyles)})"
        cases.append((shape, "pt_fused_hist", lambda M, W, b=n_bins: hk.fused_hist(M, W, b),
                      lambda lib, M, W, b=n_bins: other_fused_hist(lib, M, W, b), (M, W)))
        cases.append((shape, "pt_coverage", hk.coverage, other_coverage, (M,)))
        if label == "edge M":
            w = random_w(n_pad, "ones", dev, g)
            for q, c in ORDERED_QC:
                thr = thresholds(n_groups, q)
                cases.append((f"{label} random ({n_words} x {n_pad}, {n_groups} groups, "
                              f"ones) q={q} c={c}", "pt_ordered_growth",
                              lambda M, w, thr=thr, c=c: gk.ordered_growth(M, w, thr, c),
                              lambda lib, M, w, thr=thr, c=c: other_ordered_growth(lib, M, w, thr, c),
                              (M, w)))
    # ordered growth beyond the edge M: bp-like weights (one weight path a
    # lane), and the widths of assembly graphs grouped by path
    for label, n_words, n_pad, n_groups, wstyle, qcs in (
        ("node M", 3, 917_504, 90, "bp", ORDERED_QC),
        ("1024 groups", 32, 1 << 20, 1024, "max31", ((0.0, 1), (0.5, 2))),
        ("4096 groups", 128, 1 << 18, 4096, "max31", ((0.0, 1), (0.5, 2))),
        ("30000 groups", 938, 1 << 16, 30000, "max31", ((0.0, 1), (0.5, 2))),
    ):
        M = random_m(n_words, n_pad, n_groups, dev, g)
        w = random_w(n_pad, wstyle, dev, g)
        for q, c in qcs:
            thr = thresholds(n_groups, q)
            cases.append((f"{label} random ({n_words} x {n_pad}, {wstyle}) q={q} c={c}",
                          "pt_ordered_growth",
                          lambda M, w, thr=thr, c=c: gk.ordered_growth(M, w, thr, c),
                          lambda lib, M, w, thr=thr, c=c: other_ordered_growth(lib, M, w, thr, c),
                          (M, w)))
    for label, n_words, n_pad, n_groups, wstyle in (
        ("node M", 3, 917_504, 90, "bp"),
        ("1024 groups", 32, 1 << 20, 1024, "max31"),
    ):
        M = random_m(n_words, n_pad, n_groups, dev, g)
        w = random_w(n_pad, wstyle, dev, g)
        w_max = int(w.max())
        cases.append((f"{label} random ({n_words} x {n_pad}, {wstyle}, max(w) given)",
                      "pt_similarity",
                      lambda M, w, m=w_max: gk.similarity(M, w, m),
                      lambda lib, M, w, m=w_max: other_similarity(lib, M, w, m), (M, w)))
    # the probe's inputs: every route of pt_limb_hist at 1-3 limbs
    M, w = probe.make_inputs(dev, probe.N_WORDS, probe.N_ITEMS, 0)
    n_bins = probe.n_bins_for(probe.N_WORDS)
    for variant in ("old1", "old2", "old3", "fh21", "fh22", "fh23", "fhm1", "fhm2", "fhm3"):
        _, kw = probe.ROUTES[variant]
        cases.append((f"probe M ({probe.N_WORDS} x {probe.N_ITEMS}, 1 vector, {n_bins} bins) "
                       f"{variant}",
                      "pt_limb_hist",
                      lambda M, w, kw=kw, b=n_bins: pk.limb_hist(M, w, b, **kw),
                      lambda lib, M, w, kw=kw, b=n_bins: other_limb_hist(lib, M, w, b, **kw),
                      (M, w)))
    if path is not None:
        (M, W, n_bins), ordered = path
        shape = f"path edge M ({M.shape[0]} x {M.shape[1]}, {W.shape[0]} vectors)"
        cases.append((shape, "pt_fused_hist", lambda M, W, b=n_bins: hk.fused_hist(M, W, b),
                      lambda lib, M, W, b=n_bins: other_fused_hist(lib, M, W, b), (M, W)))
        for (q, c), (M, w, thr, c_min) in zip(ORDERED_QC, ordered):
            cases.append((f"path edge M q={q} c={c_min}", "pt_ordered_growth",
                          lambda M, w, thr=thr, c=c_min: gk.ordered_growth(M, w, thr, c),
                          lambda lib, M, w, thr=thr, c=c_min: other_ordered_growth(lib, M, w, thr, c),
                          (M, w)))
    return cases


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m panacus_torch.kernel_times",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", metavar="DIR", help="another build's csrc directory")
    ap.add_argument("--graph", action="store_true", help="add the path's own inputs")
    ap.add_argument("--unchecked", action="store_true",
                    help="time the other build without comparing its results (a "
                         "copy with parts taken out)")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--kernels", nargs="*", default=list(KERNELS), choices=KERNELS,
                    help="the kernels to time (default: all)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_times: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    print(f"kernel_times on {smi} (nvidia-smi name, power.limit); torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    t0 = time.perf_counter()
    builds = kernels.build_all(["hist", "group", "probe"])
    libs = build_other(args.other) if args.other else {}
    print(f"builds: {time.perf_counter() - t0:.1f} s", flush=True)
    for source, b in builds.items():
        print(f"this {source} ptxas: {_ptxas(b.log)}")
    path = None
    if args.graph:
        t0 = time.perf_counter()
        path = path_inputs(testgraphs.cached_graph(GRAPH_DIR))
        print(f"path inputs captured in {time.perf_counter() - t0:.1f} s", flush=True)

    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    for label, name, this_fn, other_fn, inputs in _cases(dev, path):
        if name not in args.kernels:
            continue
        builds: Dict[str, Callable] = {"this": this_fn}
        if libs:
            builds["other"] = lambda *a, lib=libs[SOURCE_OF[name]]: other_fn(lib, *a)
        want = this_fn(*inputs)
        if ("other" in builds and not args.unchecked
                and not torch.equal(builds["other"](*inputs), want)):
            print(f"FAIL {name} {label}: the other build's result differs", flush=True)
            return 1
        sets = copies(inputs)
        order = ["other", "this", "this", "other"] if libs else ["this"]
        ev: Dict[str, List[float]] = {b: [] for b in builds}
        sl: Dict[str, List[float]] = {b: [] for b in builds}
        for _ in range(args.rounds):
            for b in order:
                fn = builds[b]
                ev[b].append(event_ms(lambda: fn(*inputs), 10, flush))
                sl[b].append(slope_ms([lambda s=s: fn(*s) for s in sets]))
        parts = [
            f"{b} ev {statistics.median(ev[b]):.4f} slope {statistics.median(sl[b]):.4f}"
            for b in builds
        ]
        ratio = ""
        if "other" in builds:
            ratio = (f"; this/other slope "
                     f"{statistics.median(sl['this']) / statistics.median(sl['other']):.3f}, ev "
                     f"{statistics.median(ev['this']) / statistics.median(ev['other']):.3f}")
        print(f"[times] {name} {label}: " + " | ".join(parts) + ratio
              + f" (ms; slope rounds {[round(x, 4) for x in sl['this']]})", flush=True)
        del sets
    return 0


if __name__ == "__main__":
    sys.exit(main())
