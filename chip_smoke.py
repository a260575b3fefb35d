#!/usr/bin/env python3
"""GPU smoke run of panacus_torch, the PyTorch/CUDA port.

Run from the root of a checkout on a machine with one NVIDIA GPU or more:

    python3 chip_smoke.py

Phases, one or more lines each on stdout:

1. env: the card's name and power limit (nvidia-smi), torch and CUDA
   versions, and the nvcc builds of csrc/hist.cu, csrc/group.cu,
   csrc/probe.cu and csrc/parse.cu (one nvcc each, started together) with
   their ptxas summaries.
2. kernels: each kernel (pt_fused_hist, pt_coverage, pt_ordered_growth,
   pt_similarity) against its plain PyTorch version on the card at the
   shapes of the paths below and beyond, exact int64 equality, median
   times from CUDA events with L2 flushed and the slope of chains of
   calls queued behind a device-side sleep
   (panacus_torch.kernel_times.slope_ms: launch latency off the clock),
   beside the kernel's bound (the larger of its bytes over 3.35 TB/s and
   its operations over the card's peak for their type) and, for
   pt_similarity, beside one float64 torch.matmul of the unpacked P
   against P * W (library_ms, the yardstick; the port never calls it).
   pt_ordered_growth also runs past 65,534 groups (70,000 groups, its
   31-plane tier), exact against its plain version. pt_parse_pack runs on
   1024 random P and W step lists between bytes of other fields (the
   many-slab graph's path count), its M, every path's steps and bp and
   its error slot exact against its plain version (numpy on the host,
   parse_pack_ref), and with one byte of a list made bad: the error slot
   names that list in both. pt_parse_pack_edges runs on the same lists
   with the CSR adjacency of every pair of steps they walk (edge ids in a
   random order), its edge M and error slot exact against
   parse_pack_edges_ref, and with one pair left out of the adjacency: the
   error slot names the least list that walks it in both. Both parse
   kernels are timed by events and by slope beside their bounds.
3. main path: `histgrowth -c all -H -q 0,0.5,1.0 -l 0,1,2` through
   panacus_torch's CLI on cuda, on the panacus_torch.testgraphs.make_graph
   graph at its default size (900k nodes, 3.6M edges, 90 haplotype groups,
   ~340 MB of GFA, HPRC chr22 pggb scale; the bytes of bench.make_graph's):
   once unmasked, once restricted by a
   subset BED to a 1.5 Mbp region of the 45 P-line haplotypes (the
   classic itemizer, the path that reads per-item coverage). Launch counts
   are reset just before these two runs and read just after; both kernels
   must have run. The TSVs must equal the same commands run through the
   port on the CPU, and a small unmasked run must equal a numpy oracle.
   The unmasked run parses its node and edge rows on the card, one
   pt_parse_pack and one pt_parse_pack_edges; it runs once more with the
   device route turned off (the host tokenizer and edge pack, M uploaded),
   and its TSV must be the same.
4. group path: on the same graph, `ordered-histgrowth -H -q 0,0.5,1
   -l 1,1,2` with -c bp and -c edge, and `similarity -H` with -c node and
   -c bp, on cuda. Launch counts are reset just before these four runs and
   read just after: pt_ordered_growth must run at least 3 times per ordered
   run and pt_similarity at least once per similarity run; the builds that
   count nodes (every run but -c edge) parse their step lists on the
   card, one pt_parse_pack a build, and the -c edge run one
   pt_parse_pack_edges a build and no pt_parse_pack. Each TSV must
   equal the port's run on the CPU; a small ordered run and a small
   coverage table must equal numpy oracles.
4b. path kernels: the arguments that phases 3 and 4 handed
   pt_fused_hist (the unmasked edge pass), pt_ordered_growth (the three
   thresholds of ordered-histgrowth -c edge), pt_similarity (similarity
   -c node), pt_parse_pack (the build of similarity -c node: every step
   list of the graph, as phase 9's -c node builds hand it) and
   pt_parse_pack_edges (the build of the unmasked -c all: every step list
   and the graph's CSR adjacency), captured during those runs: each kernel
   against its plain version on them, exact, timed by events and by slope,
   beside its bound. Then pt_fused_hist on the node and the edge M that
   the unmasked -c all's device route leaves against those the host route
   uploads: the same bytes, timed by events (L2 flushed) and by slope on
   either, and timed right after each route's own last writes to M
   replayed (both parses into zeroed M; M's copies from pinned memory).
5. probe: the raw-read control and the hist-formulation probes
   (csrc/probe.cu: pt_xor_fold, pt_word_fold, pt_limb_hist), every route
   (panacus_torch.probe.ROUTES) against its plain version on the card on
   the probe's own inputs, M 32 x 2^23 with its one weight vector, and on
   two vectors of any int32, at salt 0 and at a salt that wraps the weights
   negative, exact; then `python -m panacus_torch.probe`'s interleaved run
   of every variant on those inputs (1.107 GB a pass; each distinct call
   timed once) for 3 rounds, with the launch counts
   reset just before it and read just after: each of the three kernels
   must have run. It prints each variant's GB/s and ratio to `read`, and
   the measured read ceiling beside the card's name and power limit.
   Every kernel of the JSON line gets its share of that ceiling
   (share_of_read: its bytes over its time, over the read's bytes/s)
   beside its share of the datasheet bound.
6. report path: on the graph of phase 3, through panacus_torch's CLI on
   cuda: `info -H`, `info -S`, `info -H` restricted by phase 3's subset
   BED, `node-distribution`, `report --json` of a YAML with two runs (run
   1, `grouping: Haplotype`: Info, Hist all, Growth, CoverageLine,
   NodeDistribution, OrderedGrowth edge; run 2, `grouping: Sample`: Hist,
   Growth, Similarity node, which one run cannot hold beside ordered growth
   on edges), `render` of that JSON and `report` of the same YAML as HTML.
   Launch counts are reset just before these runs and read just after:
   node-distribution must launch pt_coverage, the report pt_fused_hist,
   pt_ordered_growth (3 times or more) and pt_similarity. Each output must
   equal the port's CPU run of the same command: TSVs apart from `#` lines,
   the JSON (strict: no NaN) apart from the `#` lines of its tables, the
   HTML apart from its <footer> line; `render` renders each device's JSON
   on that device. A small `info -S` on cuda must equal a numpy oracle.
7. sharded: the membership matrices split along the item axis over a
   tuple of devices, one shard each: four shards on the first card, and
   one shard on each card where two or more are visible. Engine level:
   the main path's edge M (3 x 3,604,480) and the 1 GiB M (1024 groups x
   2^23), built from the host matrix on the first card alone and on each
   tuple: coverage, hist_multi (ones, bp), ordered growth (q=0/0.5/1,
   c=1/1/2) and similarity must be exactly equal, each kernel launched k
   times as often, once on each shard (counts printed per shard); then 5
   warm op sets of each, in turns with the first card alone. The 1 GiB
   hist is timed per shard (CUDA events on its card) and for the whole
   set (host wall: the launches, the copies back, the int64 merge), in
   turns with one device. CountingEngine.build from 8M (item, group) pairs
   on cuda must equal the host-packed M and the CPU build. The host time
   of a MembershipStream at the edge M's shape is split into the zero
   fills, the pinned rows, issuing the copies, waiting for them and one
   bp-sized weight upload, 5 warm runs of each tuple in turns. CLI level:
   histgrowth -c all, ordered-histgrowth -c edge and similarity -c node
   (as in phases 3-4) on each tuple, 5 runs each in turns with the first
   card alone: every TSV equal to phases 3-4's, the launches k times one
   card's, each shard's those of the one-card run's matrix; the walls and
   pipeline phases as medians and samples. Then
   testgraphs.dryrun_multichip on each tuple. It prints "devices:
   <distinct> distinct of <k> shards".
8. multi-process: the port's CLI as 2 ranks of a torch.distributed
   process group, launched as torchrun launches them
   (panacus_torch.parallel.launch, each rank one process that runs every
   command): `histgrowth -c all`, `ordered-histgrowth -c edge`,
   `similarity -c node` and the subset-masked `histgrowth -c all` of
   phases 3-4 on the graph of phase 3, and `table -c node -H` on the
   dryrun graph. Each rank tokenizes only its group range, M is
   assembled across the ranks and the hand kernels run on each rank's
   columns. Rank 0's TSVs must equal the one-process runs of phases 3-4
   (the table: a one-process run here), rank 1 must write nothing, and
   every rank must have launched pt_fused_hist on CUDA shards (the
   launches each rank process counted from 0). Layouts: 2 ranks sharing
   the first card (gloo) and, with two or more GPUs visible, 2 ranks with
   their own cards (NCCL). Per rank it prints the devices, the backend,
   the payload share it tokenized, the walls, the phases and the
   launches. A rank that fails or hangs fails the phase.

9. front end: `histgrowth -H` at bench.py's four stages, `-c all`, `-c
   node`, `-c edge` and `-c node` on a single-member level-1 gzip of the
   graph (testgraphs.write_gzip), on cuda:0, FRONT_RUNS warm runs of each
   taken in turns: on the graph of phase 3 (90 groups, 3 slabs; `-q
   0,0.5,1.0 -l 0,1,2`) and on make_graph(n_nodes=80_000, n_paths=1024)
   (1024 groups, 32 slabs; `-q 0,1.0 -l 0,2`, see FRONT_QL). Each TSV
   must equal the port's CPU run of the same command, and each run must
   launch pt_fused_hist (counted from 0 for each run) through the
   streamed build, pt_parse_pack once where it counts nodes (all, node,
   gz_node) and pt_parse_pack_edges once where it counts edges (all,
   edge). It prints the median walls, MB/s on the uncompressed bytes,
   the phases index and abaci_by_total, the launches and the gz inflate
   route (libdeflate or zlib); then one warm `-c all` under
   torch.profiler: the phase scopes it finds, the device's busy time and
   longest idle gap in each, and the build scopes of the streamed build.
10. bench: `panacus_torch.bench.run` in process on the graph of phase 3,
   on the default devices (every visible GPU), with the launch counts
   reset just before it and read just after: the stages all / node / edge
   / gz_node, the group tail against its numpy oracle, and the roofline
   (pt_fused_hist over 1.07 GB by slope against pt_xor_fold's read). It
   prints the bench's JSON line and fails unless every stage took the
   streamed build, the `all` hists equal the hist columns of `histgrowth
   -a -c all -H` on cuda (and their growth its growth columns), the group
   stages were verified, pt_fused_hist, pt_ordered_growth, pt_similarity
   and pt_xor_fold each ran, and device_frac_of_read is at most 1.05.

Phases 3, 4 and 6 run on the first card alone (one shard), whatever the
number of cards, so their launch counts and times compare across machines.

The line before the last is a JSON object with one entry per kernel (its
launches are those of the path it belongs to, `report_launches` those
of phase 6, `multiprocess_launches` those of phase 8's first layout,
summed over its ranks, `front_end_launches` those of phase 9 and
`bench_launches` those of phase 10; its times at the largest shape that path hands it, by events
as `ms` and, where taken, by slope as `slope_ms`; under `path`, phase
4b's times); the last line is
{"ok": true, "device": {...}}. Any failed phase exits non-zero without that
line, as does a run without a CUDA device or outside a checkout. Generated
graphs go to build/chip_smoke/.
"""

from __future__ import annotations

import contextlib
import io
import json
import logging
import math
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, "build", "chip_smoke")
HISTGROWTH = ["histgrowth", "-c", "all", "-H", "-q", "0,0.5,1.0", "-l", "0,1,2"]
ORDERED = ["ordered-histgrowth", "-H", "-q", "0,0.5,1", "-l", "1,1,2"]
SOURCE = {
    "pt_fused_hist": "panacus_torch/csrc/hist.cu",
    "pt_coverage": "panacus_torch/csrc/hist.cu",
    "pt_ordered_growth": "panacus_torch/csrc/group.cu",
    "pt_similarity": "panacus_torch/csrc/group.cu",
    "pt_xor_fold": "panacus_torch/csrc/probe.cu",
    "pt_word_fold": "panacus_torch/csrc/probe.cu",
    "pt_limb_hist": "panacus_torch/csrc/probe.cu",
    "pt_parse_pack": "panacus_torch/csrc/parse.cu",
    "pt_parse_pack_edges": "panacus_torch/csrc/parse.cu",
}
REPLACES = {
    "pt_fused_hist": "panacus_tpu/ops/pallas_kernels.py:199",
    "pt_coverage": "panacus_tpu/ops/engine.py:152",
    "pt_ordered_growth": "panacus_tpu/ops/engine.py:212",
    "pt_similarity": "panacus_tpu/ops/engine.py:302",
    "pt_xor_fold": "bench.py:220 (_xor_read_bw.run, body kern :202)",
    "pt_word_fold": (
        "scripts/kernel_probe.py:61 (pc_only), :83 (pcl_only), :112 (pcm_only); "
        "scripts/kernel_interleave.py:104 (_simple: _pc/_pcx/_pcm_kernel)"
    ),
    "pt_limb_hist": (
        "scripts/kernel_probe.py:153 (coarse), :197 (fh2), :249 (fhm); "
        "scripts/kernel_interleave.py:165 (_fh2)"
    ),
    "pt_parse_pack": "none (panacus_tpu parses the step lists on the host)",
    "pt_parse_pack_edges": "none (panacus_tpu packs the edge rows on the host)",
}
# published peaks of one H100 SXM (dense): HBM bytes/s, int8 tensor-core
# operations/s, and 32-bit operations/s outside the tensor cores (the table's
# float32 rate, taken for the integer popcounts, shifts and adds)
HBM_BPS = 3.35e12
INT8_TC_OPS = 1979e12
SCALAR_OPS = 67e12


def bound(nbytes: float, ops: float, peak_ops: float):
    """(bound_ms, bound_by): the least time for nbytes moved at HBM_BPS and
    ops done at peak_ops."""
    t_bytes, t_ops = nbytes / HBM_BPS * 1e3, ops / peak_ops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def drive(argv, device: str, devices=None):
    """One run of the port's CLI on `device` ("cuda" or "cpu"): (stdout,
    phase seconds, wall). On cuda the membership matrices go to `devices`
    (a tuple of cards, one item shard each), by default the first card
    alone, so that the launch counts and times of phases 3-6 do not depend
    on how many cards are visible."""
    import torch

    from panacus_torch.cli import run_cli
    from panacus_torch.runtime import PhaseLog

    os.environ["PANACUS_TORCH_DEVICE"] = device
    if device == "cuda" and devices is None:
        devices = (torch.device("cuda", 0),)
    handler = PhaseLog()
    logging.getLogger("panacus").addHandler(handler)
    buf = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            rc = run_cli(argv, devices=devices)
        if device == "cuda":
            for d in set(devices):
                torch.cuda.synchronize(d)
    finally:
        logging.getLogger("panacus").removeHandler(handler)
    wall = time.perf_counter() - t0
    if rc != 0:
        fail(f"{argv} on {device} exited {rc}")
    return buf.getvalue(), handler.phases, wall


def table(out: str):
    """TSV body without `#` lines, and its rows split into cells."""
    body = [l for l in out.splitlines() if l and not l.startswith("#")]
    return "\n".join(body), [l.split("\t") for l in body]


def phase_env():
    import torch

    from panacus_torch.ops import kernels

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True,
        text=True,
        timeout=60,
        check=True,
    ).stdout.strip()
    print(f"[env] card (nvidia-smi name, power.limit): {smi}")
    print(
        f"[env] torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}"
    )
    t0 = time.perf_counter()
    builds = kernels.build_all()
    print(f"[env] nvcc builds (one per source, in parallel): {time.perf_counter() - t0:.3f} s")
    for source, b in builds.items():
        ptxas = [l.strip() for l in b.log.splitlines() if "Used" in l]
        print(
            f"[env] nvcc build of {kernels.SOURCES[source]}: {b.seconds:.3f} s "
            f"({'built' if b.seconds else 'already built'}); ptxas: {ptxas}"
        )
    return smi


# (label, n_words, n_items_pad, n_groups, n_vecs, weights)
SHAPES = [
    ("node M of the main path", 3, 917_504, 90, 2, "ones+bp"),
    ("edge M of the main path", 3, 3_604_480, 90, 2, "ones+bp"),
    ("1 GiB M", 32, 1 << 23, 1024, 1, "ones"),
    ("4096 groups", 128, 1 << 20, 4096, 1, "max31"),
]
MAIN_SHAPE = 1  # the largest M the main path hands the kernels


def phase_kernels(dev):
    """Kernel vs plain version at each shape; returns per-kernel results."""
    import numpy as np
    import torch

    from panacus_torch.kernel_times import copies, event_ms, random_m, slope_ms
    from panacus_torch.ops import hist_kernels as hk

    g = torch.Generator(device=dev)
    g.manual_seed(1)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    res = {name: {"max_abs_err": 0} for name in ("pt_fused_hist", "pt_coverage")}
    for i, (label, n_words, n_pad, n_groups, n_vecs, wstyle) in enumerate(SHAPES):
        n_bins = n_groups + 2
        M = random_m(n_words, n_pad, n_groups, dev, g)
        if wstyle == "max31":
            W = torch.randint(
                0, 2**31, (n_vecs, n_pad), dtype=torch.int32, device=dev,
                generator=g,
            )
        else:
            W = torch.ones((n_vecs, n_pad), dtype=torch.int32, device=dev)
            if n_vecs > 1:  # bp-like node lengths
                W[1] = torch.randint(
                    1, 17, (n_pad,), dtype=torch.int32, device=dev, generator=g
                )
        W[:, 0] = 0
        got_h, want_h = hk.fused_hist(M, W, n_bins), hk.fused_hist_ref(M, W, n_bins)
        got_c, want_c = hk.coverage(M), hk.coverage_ref(M)
        torch.cuda.synchronize()
        err_h = int((got_h - want_h).abs().max())
        err_c = int((got_c - want_c).abs().max())
        if err_h or err_c or not torch.equal(got_h, want_h):
            fail(f"{label}: kernel != plain (hist err {err_h}, coverage err {err_c})")
        if want_h.sum() != W.sum(dtype=torch.int64):
            fail(f"{label}: histogram loses weight")
        sets = copies((M, W))
        t = {
            "pt_fused_hist": (
                event_ms(lambda: hk.fused_hist(M, W, n_bins), 20, flush),
                event_ms(lambda: hk.fused_hist_ref(M, W, n_bins), 5, flush),
                slope_ms([lambda s=s: hk.fused_hist(s[0], s[1], n_bins) for s in sets]),
            ),
            "pt_coverage": (
                event_ms(lambda: hk.coverage(M), 20, flush),
                event_ms(lambda: hk.coverage_ref(M), 5, flush),
                slope_ms([lambda s=s: hk.coverage(s[0]) for s in sets]),
            ),
        }
        del sets
        for name, (ms, plain_ms, slope) in t.items():
            # read M (and W) once, write the histograms or the coverage once;
            # per item a popcount and an add per word, an add per vector
            if name == "pt_fused_hist":
                nbytes = M.numel() * 4 + W.numel() * 4 + n_vecs * n_bins * 8
                ops = n_pad * (2 * n_words + n_vecs)
            else:
                nbytes = M.numel() * 4 + n_pad * 4
                ops = n_pad * 2 * n_words
            bound_ms, bound_by = bound(nbytes, ops, SCALAR_OPS)
            print(
                f"[kernels] {name} {label} ({n_words} x {n_pad}, {n_bins} bins, "
                f"{n_vecs if name == 'pt_fused_hist' else 0} weight vectors): "
                f"exact; kernel {ms:.4f} ms by events ({nbytes / ms / 1e6:.1f} GB/s), "
                f"{slope:.4f} ms by slope; plain {plain_ms:.4f} ms; bound "
                f"{bound_ms:.4f} ms ({nbytes / 1e6:.1f} MB, {bound_by}), "
                f"{bound_ms / ms:.3f} of it reached by events, {bound_ms / slope:.3f} "
                f"by slope; library: none (torch has no popcount)"
            )
            if i == MAIN_SHAPE:
                res[name].update(
                    ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                    library_ms=None, slope_ms=slope, at=f"{n_words}x{n_pad}",
                    _bytes=nbytes,
                )
        del M, W, got_h, want_h, got_c, want_c
    text, descs, n_spans = parse_inputs(np.random.default_rng(1), 1024, 2000)
    text, descs = text.to(dev), descs.to(dev)
    lens = torch.randint(1, 17, (PARSE_ITEMS + 1,), dtype=torch.int32, device=dev, generator=g)
    args = (text, descs, lens, PARSE_ITEMS, n_spans, 3)
    res["pt_parse_pack"] = check_parse("1024 random step lists", args, flush)
    bad = text.clone()
    span = int(descs[n_spans // 2, 2])
    bad[int(descs[n_spans // 2, 0]) + 1] = ord("x")
    check_parse("1024 random step lists, one byte bad", (bad,) + args[1:], flush, bad_span=span)
    host = (text.cpu(), descs.cpu())
    row_off, adj_ent, _ = parse_adjacency(*host, PARSE_ITEMS, np.random.default_rng(2))
    args = (text, descs, row_off.to(dev), adj_ent.to(dev), PARSE_ITEMS, 3)
    res["pt_parse_pack_edges"] = check_parse_edges("1024 random step lists", args, flush)
    row_off, adj_ent, span = parse_adjacency(*host, PARSE_ITEMS, np.random.default_rng(2), drop=True)
    args = (text, descs, row_off.to(dev), adj_ent.to(dev), PARSE_ITEMS, 3)
    check_parse_edges("1024 random step lists, one pair with no L line", args, flush, bad_span=span)
    del text, descs, lens, bad, row_off, adj_ent, args
    return res


PARSE_ITEMS = 634_000  # node ids of the random step lists: the hg configuration's nodes


def parse_inputs(rng, n_lists, max_tokens):
    """(text, descs, n_spans) on the host: n_lists good P and W step lists
    of up to max_tokens ids of 1 to 6 digits, in a random span order, each
    after a few bytes of other fields (',', '>', digits and orientations
    among them)."""
    import numpy as np
    import torch

    data, descs = [], []
    at = 0
    for span in rng.permutation(n_lists).tolist():
        k = int(rng.integers(1, max_tokens + 1))
        ids = np.minimum(rng.integers(1, 10 ** rng.integers(1, 7, size=k)), PARSE_ITEMS)
        orient = rng.integers(0, 2, size=k)
        walk = bool(rng.integers(0, 2))
        if walk:
            body = "".join(f"{'><'[o]}{i}" for i, o in zip(ids.tolist(), orient.tolist()))
        else:
            body = ",".join(f"{i}{'+-'[o]}" for i, o in zip(ids.tolist(), orient.tolist()))
        gap = "\tP\t9,>1+<\t"[: int(rng.integers(0, 12))]
        at += len(gap)
        word, bit = int(rng.integers(-1, 3)), int(rng.integers(0, 32))
        descs.append([at, at + len(body), span, bit | int(walk) << 8 | word << 16])
        data.append(gap + body)
        at += len(body)
    text = np.frombuffer(("".join(data) + "\t*\n").encode(), dtype=np.uint8).copy()
    return torch.from_numpy(text), torch.tensor(descs, dtype=torch.int64), n_lists


def check_parse(label, args, flush, bad_span=None):
    """pt_parse_pack on args = (text, descs, node_lens, n_items, n_spans,
    n_words) on the card against parse_pack_ref on host copies: M, each
    span's steps and bp and the error slot equal (the slot naming bad_span,
    or no span); then, where no token is bad, timed by events and by slope
    beside its bound. Returns its numbers for the kernels line."""
    import torch

    from panacus_torch.kernel_times import copies, event_ms, slope_ms
    from panacus_torch.ops import parse_kernels as pk

    text, descs, lens, n_items, n_spans, n_words = args

    def outputs(device):
        M = torch.zeros((n_words, n_items + 1), dtype=torch.int32, device=device)
        acc = torch.zeros(1 + 2 * n_spans, dtype=torch.int64, device=device)
        acc[0] = int(pk.ERR_NONE)
        return M, acc

    M, acc = outputs(text.device)
    pk.parse_pack(text, descs, M, lens, n_items, acc)
    hM, hacc = outputs("cpu")
    host = [t.cpu() for t in (text, descs, lens)]
    t0 = time.perf_counter()
    pk.parse_pack(host[0], host[1], hM, host[2], n_items, hacc)
    plain_ms = (time.perf_counter() - t0) * 1e3
    want_err = int(pk.ERR_NONE) if bad_span is None else bad_span
    if int(hacc[0]) != want_err or int(acc[0]) != want_err:
        fail(f"pt_parse_pack {label}: error slot {int(acc[0])}, plain {int(hacc[0])}, not {want_err}")
    if bad_span is not None:
        print(f"[kernels] pt_parse_pack {label}: the kernel's and the plain error slot "
              f"name span {bad_span}")
        return None
    if not torch.equal(acc.cpu(), hacc) or not torch.equal(M.cpu(), hM):
        fail(f"pt_parse_pack {label}: kernel != plain (M or a path's steps or bp)")
    ms = event_ms(lambda: pk.parse_pack(text, descs, M, lens, n_items, acc), 10, flush)
    slope = slope_ms([lambda s=s: pk.parse_pack(s[0], s[1], M, lens, n_items, acc)
                      for s in copies((text, descs))])
    # read the text, the descriptors and node_lens once, write M and acc
    # once; a compare a byte
    nbytes = (text.numel() + descs.numel() * 8 + lens.numel() * 4 + M.numel() * 4
              + acc.numel() * 8)
    bound_ms, bound_by = bound(nbytes, text.numel(), SCALAR_OPS)
    steps = int(hacc[1 : 1 + n_spans].sum())
    print(
        f"[kernels] pt_parse_pack {label} ({text.numel() / 1e6:.2f} MB of text, "
        f"{descs.shape[0]} lists, {steps} steps, {n_words} x {n_items + 1} M): exact; "
        f"kernel {ms:.4f} ms by events ({text.numel() / ms / 1e6:.1f} GB/s of text), "
        f"{slope:.4f} ms by slope; plain {plain_ms:.1f} ms (numpy on the host); bound "
        f"{bound_ms:.4f} ms ({nbytes / 1e6:.1f} MB, {bound_by}), {bound_ms / ms:.3f} of it "
        f"by events, {bound_ms / slope:.3f} by slope; library: none"
    )
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=None, slope_ms=slope, at=f"{text.numel()} bytes, {descs.shape[0]} lists",
                _bytes=nbytes)


def parse_adjacency(text, descs, n_items, rng, drop=False):
    """(row_off, adj_ent, span) on the host: the CSR adjacency of the L
    lines that hold every pair of consecutive steps of the good lists of
    (text, descs), laid out as native.build_edge_adj lays it (row u: (vkey
    << 32) | edge id, by vkey; int64), with edge ids in a random order.
    With `drop`, one pair is left out, and span is the least list that
    walks it (else None)."""
    import numpy as np
    import torch

    from panacus_torch.ops import parse_kernels as pk

    s = text.numpy()
    keys, spans = [], []
    for begin, end, span, meta in descs.numpy().tolist():
        ids, orient = pk.list_steps(s[begin:end], bool(meta >> 8 & 1), n_items)
        u, v = ids[:-1], ids[1:]
        o1, o2 = orient[:-1].astype(np.int64), orient[1:].astype(np.int64)
        swap = (u > v) | ((u == v) & (o1 == 1))
        vkey = np.where(swap, u, v) << 2 | np.where(swap, o2 ^ 1, o1) << 1 | np.where(swap, o1 ^ 1, o2)
        keys.append(np.where(swap, v, u) << 32 | vkey)
        spans.append(np.full(len(u), span))
    keys, spans = np.concatenate(keys), np.concatenate(spans)
    missing = None
    if drop:
        gone = keys[len(keys) // 2]
        missing = int(spans[keys == gone].min())
        keys = keys[keys != gone]
    keys = np.unique(keys)
    eids = rng.permutation(len(keys)) + 1
    row_off = np.zeros(n_items + 2, dtype=np.int64)
    row_off[1:] = np.cumsum(np.bincount(keys >> 32, minlength=n_items + 1))
    adj_ent = (keys & 0xFFFFFFFF) << 32 | eids
    return torch.from_numpy(row_off), torch.from_numpy(adj_ent), missing


def check_parse_edges(label, args, flush, bad_span=None):
    """pt_parse_pack_edges on args = (text, descs, row_off, adj_ent,
    n_items, n_words) on the card against parse_pack_edges_ref on host
    copies: the edge M and the error slot equal (the slot naming bad_span,
    or no span); then, where every pair has its edge, timed by events and
    by slope beside its bound. Returns its numbers for the kernels line."""
    import torch

    from panacus_torch.kernel_times import copies, event_ms, slope_ms
    from panacus_torch.ops import parse_kernels as pk

    text, descs, row_off, adj_ent, n_items, n_words = args

    def outputs(device):
        M = torch.zeros((n_words, adj_ent.numel() + 1), dtype=torch.int32, device=device)
        err = torch.full((1,), int(pk.ERR_NONE), dtype=torch.int64, device=device)
        return M, err

    M, err = outputs(text.device)
    pk.parse_pack_edges(text, descs, M, row_off, adj_ent, n_items, err)
    hM, herr = outputs("cpu")
    host = [t.cpu() for t in (text, descs, row_off, adj_ent)]
    t0 = time.perf_counter()
    pk.parse_pack_edges(host[0], host[1], hM, host[2], host[3], n_items, herr)
    plain_ms = (time.perf_counter() - t0) * 1e3
    want_err = int(pk.ERR_NONE) if bad_span is None else bad_span
    if int(herr[0]) != want_err or int(err[0]) != want_err:
        fail(f"pt_parse_pack_edges {label}: error slot {int(err[0])}, plain {int(herr[0])}, "
             f"not {want_err}")
    if bad_span is not None:
        print(f"[kernels] pt_parse_pack_edges {label}: the kernel's and the plain error slot "
              f"name span {bad_span}")
        return None
    if not torch.equal(M.cpu(), hM):
        fail(f"pt_parse_pack_edges {label}: kernel != plain (edge M)")
    ms = event_ms(lambda: pk.parse_pack_edges(text, descs, M, row_off, adj_ent, n_items, err),
                  10, flush)
    slope = slope_ms([lambda s=s: pk.parse_pack_edges(s[0], s[1], M, s[2], s[3], n_items, err)
                      for s in copies((text, descs, row_off, adj_ent))])
    # read the text, the descriptors and the adjacency once, write the edge
    # M and the error slot once; a compare a byte
    nbytes = (text.numel() + descs.numel() * 8 + row_off.numel() * 8 + adj_ent.numel() * 8
              + M.numel() * 4 + 8)
    bound_ms, bound_by = bound(nbytes, text.numel(), SCALAR_OPS)
    print(
        f"[kernels] pt_parse_pack_edges {label} ({text.numel() / 1e6:.2f} MB of text, "
        f"{descs.shape[0]} lists, {adj_ent.numel()} edges, {int(hM.ne(0).sum())} of "
        f"{n_words} x {adj_ent.numel() + 1} M words set): exact; kernel {ms:.4f} ms by events "
        f"({text.numel() / ms / 1e6:.1f} GB/s of text), {slope:.4f} ms by slope; plain "
        f"{plain_ms:.1f} ms (numpy on the host); bound {bound_ms:.4f} ms "
        f"({nbytes / 1e6:.1f} MB, {bound_by}), {bound_ms / ms:.3f} of it by events, "
        f"{bound_ms / slope:.3f} by slope; library: none"
    )
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=None, slope_ms=slope, at=f"{text.numel()} bytes, {descs.shape[0]} lists",
                _bytes=nbytes)


# (label, n_words, n_items_pad, n_groups, weights, (quorum, c_min) pairs,
#  whether similarity runs there)
GROUP_SHAPES = [
    ("node M of the group path", 3, 917_504, 90, "bp", [(0.0, 1), (0.5, 1), (1.0, 2)], True),
    ("edge M of the group path", 3, 3_604_480, 90, "ones", [(0.0, 1), (0.5, 1), (1.0, 2)], True),
    ("1024 groups", 32, 1 << 20, 1024, "max31", [(0.0, 1), (0.5, 2)], True),
    ("4096 groups, items cut to 2^18", 128, 1 << 18, 4096, "max31", [(0.0, 1), (0.5, 2)], False),
    ("4096 groups, items cut to 2^16", 128, 1 << 16, 4096, "max31", [], True),
    ("70,000 groups, items cut to 2^10", 2188, 1 << 10, 70_000, "max31",
     [(0.0, 1), (0.5, 2)], False),
]
# the shapes whose times go into the kernels line: the largest M that the
# group path hands each kernel (ordered -c edge; similarity -c node|bp)
GROUP_MAIN = {"pt_ordered_growth": (1, (0.5, 1)), "pt_similarity": (0, None)}


def ordered_bound(M, n_groups: int):
    """(bound_ms, bound_by, bytes) of pt_ordered_growth on M: read M, W and
    the thresholds once, write the curve once; a popcount per word and a
    step per set bit of each item."""
    from panacus_torch.ops import hist_kernels as hk

    n_words, n_pad = M.shape
    nbytes = (M.numel() + n_pad + n_groups) * 4 + n_groups * 8
    ops = n_pad * n_words + int(hk.coverage(M).sum())
    return (*bound(nbytes, ops, SCALAR_OPS), nbytes)


def library_similarity(M, w, got, flush):
    """The yardstick for pt_similarity: one float64 torch.matmul of the
    unpacked P [32 n_words, items] against P * W over all items, the unpack
    outside the timed window. Exact here (every sum stays below 2^53).
    Returns (median ms, whether it equals the kernel's result)."""
    import torch

    from panacus_torch.kernel_times import event_ms
    from panacus_torch.ops import group_kernels as gk

    P = gk._unpack(M, 32 * M.shape[0]).to(torch.float64)
    PW = P * w.to(torch.float64)
    ms = event_ms(lambda: torch.matmul(P, PW.T), 3, flush)
    same = torch.equal(torch.matmul(P, PW.T).to(torch.int64), got)
    del P, PW
    return ms, same


def phase_group_kernels(dev):
    """pt_ordered_growth and pt_similarity against their plain versions,
    exact, with their bounds and, for pt_similarity, the library call;
    returns per-kernel results."""
    import torch

    from panacus_torch.kernel_times import (
        copies, event_ms, random_m, random_w, slope_ms, thresholds,
    )
    from panacus_torch.ops import group_kernels as gk

    g = torch.Generator(device=dev)
    g.manual_seed(2)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    res = {name: {"max_abs_err": 0} for name in GROUP_MAIN}

    def check(name, label, got, want, fn, plain, key, reps):
        err = int((got - want).abs().max()) if got.numel() else 0
        if err or not torch.equal(got, want):
            fail(f"{name} {label} {key}: kernel != plain (max abs err {err})")
        ms, plain_ms = event_ms(fn, reps, flush), event_ms(plain, 3, flush)
        print(
            f"[kernels] {name} {label} {key}: exact; kernel {ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms"
        )
        return ms, plain_ms

    for i, (label, n_words, n_pad, n_groups, wstyle, qcs, sim) in enumerate(GROUP_SHAPES):
        M = random_m(n_words, n_pad, n_groups, dev, g)
        w = random_w(n_pad, wstyle, dev, g)
        label = f"{label} ({n_words} x {n_pad}, {n_groups} groups, {wstyle} weights)"
        for q, c in qcs:
            thr = thresholds(n_groups, q)
            got = gk.ordered_growth(M, w, thr, c)
            want = gk.ordered_growth_ref(M, w, thr, c)
            torch.cuda.synchronize()
            t = check(
                "pt_ordered_growth", label, got, want,
                lambda: gk.ordered_growth(M, w, thr, c),
                lambda: gk.ordered_growth_ref(M, w, thr, c),
                f"q={q} c={c}", 10,
            )
            sets = copies((M, w))
            slope = slope_ms([lambda s=s: gk.ordered_growth(s[0], s[1], thr, c) for s in sets])
            del sets
            bound_ms, bound_by, nbytes = ordered_bound(M, n_groups)
            print(
                f"[kernels] pt_ordered_growth {label} q={q} c={c}: {slope:.4f} ms "
                f"by slope; bound {bound_ms:.4f} ms ({nbytes / 1e6:.1f} MB, "
                f"{bound_by}), {bound_ms / t[0]:.3f} of it reached by events, "
                f"{bound_ms / slope:.3f} by slope; library: none (torch has no "
                f"popcount)"
            )
            if GROUP_MAIN["pt_ordered_growth"] == (i, (q, c)):
                res["pt_ordered_growth"].update(
                    ms=t[0], plain_ms=t[1], bound_ms=bound_ms, bound_by=bound_by,
                    library_ms=None, slope_ms=slope,
                    at=f"{n_words}x{n_pad} q={q} c={c}", _bytes=nbytes,
                )
        if sim:
            # the wrapper reads max(w) itself here; the timed calls are given
            # it, as the engine gives it from its host copy of the weights
            got, want = gk.similarity(M, w), gk.similarity_ref(M, w)
            torch.cuda.synchronize()
            w_max = int(w.max())
            t = check(
                "pt_similarity", label, got, want,
                lambda: gk.similarity(M, w, w_max),
                lambda: gk.similarity_ref(M, w), "", 5,
            )
            read_ms = event_ms(lambda: gk.similarity(M, w), 5, flush)
            slope = slope_ms([lambda s=s: gk.similarity(s[0], s[1], w_max)
                              for s in copies((M, w))])
            lib_ms, lib_same = library_similarity(M, w, got, flush)
            # read M and W once, write S once; 2 operations per item and
            # group pair g <= h on each byte plane, on the int8 tensor cores
            planes = gk.n_planes(w_max)
            nbytes = (M.numel() + n_pad) * 4 + got.numel() * 8
            ops = 2 * n_groups * (n_groups + 1) // 2 * n_pad * planes
            bound_ms, bound_by = bound(nbytes, ops, INT8_TC_OPS)
            print(
                f"[kernels] pt_similarity {label}: library (float64 matmul) "
                f"{lib_ms:.4f} ms ({'equal' if lib_same else 'NOT equal'} to "
                f"the kernel), kernel {lib_ms / t[0]:.2f}x faster; bound "
                f"{bound_ms:.4f} ms ({planes} byte planes, {ops / 1e12:.3f} "
                f"int8 TOP, {nbytes / 1e6:.1f} MB, {bound_by}), "
                f"{bound_ms / t[0]:.3f} of it reached by events, "
                f"{bound_ms / slope:.3f} by slope ({slope:.4f} ms); with the "
                f"wrapper's own read of max(w) {read_ms:.4f} ms"
            )
            if GROUP_MAIN["pt_similarity"][0] == i:
                res["pt_similarity"].update(
                    ms=t[0], plain_ms=t[1], bound_ms=bound_ms, bound_by=bound_by,
                    library_ms=lib_ms, slope_ms=slope, at=f"{n_words}x{n_pad}",
                    _bytes=nbytes,
                )
            del got, want
        del M, w
    return res


def bench_graph() -> str:
    """The testgraphs.make_graph graph at its default size (the bytes of
    bench.make_graph's), generated once into build/chip_smoke/ and reused."""
    from panacus_torch import testgraphs as tg

    t0 = time.perf_counter()
    gfa = tg.cached_graph(WORK)
    if time.perf_counter() - t0 > 1:
        print(f"[main] generated {gfa} in {time.perf_counter() - t0:.1f} s")
    return gfa


def subset_bed():
    """(path, number of paths) of the subset BED of phase 3: a 1.5 Mbp
    region of each P-line haplotype of the bench graph."""
    from panacus_torch import testgraphs as tg

    subset = os.path.join(WORK, "subset.bed")
    n_subset = (tg.N_PATHS + 1) // 2  # haplotype 0 of each sample: P lines
    # a path spells ~3.4 bp per graph node (gaps 1-4, node lengths 1-16):
    # bp 1.0M-2.5M of each at the default 900k nodes
    lo, hi = tg.N_NODES * 10 // 9, tg.N_NODES * 25 // 9
    with open(subset, "w") as f:
        for k in range(n_subset):
            f.write(f"s{k}#0#chr1\t{lo + 7 * k}\t{hi + 11 * k}\n")
    return subset, n_subset


def check_growth_table(out: str, n_groups: int, what: str) -> str:
    """The histgrowth TSV body: 4 header rows, n_groups + 1 count rows of
    9 columns after the index, every growth value finite."""
    body, rows = table(out)
    if len(rows) != 4 + n_groups + 1 or any(len(r) != 10 for r in rows):
        fail(f"{what} TSV has an unexpected shape ({len(rows)} rows)")
    for r in rows[5:]:
        if not all(math.isfinite(float(x)) for x in r[1:]):
            fail(f"{what}: non-finite growth value in row {r[0]}")
    return body


def phase_main_path(dev, single):
    """Drive the main path on cuda; check it against cpu and an oracle.

    The main path is the histgrowth command on the full-size graph twice:
    unmasked (the streamed build, one pt_fused_hist pass for node+bp and
    one for edge) and restricted to a region of the 45 P-line haplotypes
    by a subset BED (the classic itemizer: one engine per count type, and
    pt_coverage for the bp of nodes the region cuts). The unmasked run goes
    into `single` for phase 7."""
    import numpy as np

    from panacus_torch import testgraphs as tg
    from panacus_torch.kernel_times import capture
    from panacus_torch.ops import kernels

    gfa = bench_graph()
    subset, n_subset = subset_bed()
    unmasked = HISTGROWTH + [gfa]
    masked = HISTGROWTH + ["-s", subset, gfa]

    kernels.reset_launches()
    # the arguments of each call, for phase 4b
    with capture() as calls, capture_parse() as parse_calls:
        out_big, phases, wall = drive(unmasked, "cuda")
    counts_unmasked = dict(kernels.launches)
    single["histgrowth -c all"] = (unmasked, table(out_big)[0], counts_unmasked,
                                   per_matrix(calls), wall)
    out_masked, phases_masked, wall_masked = drive(masked, "cuda")
    single["subset-masked histgrowth -c all"] = (masked, table(out_masked)[0], None, None,
                                                 wall_masked)
    launches = dict(kernels.launches)
    counts_masked = {k: launches[k] - counts_unmasked[k] for k in launches}

    mb = os.path.getsize(gfa) / 1e6
    for what, w, ph in (
        ("histgrowth -c all", wall, phases),
        ("subset-masked histgrowth -c all", wall_masked, phases_masked),
    ):
        print(
            f"[main] {what} on cuda: {mb:.1f} MB of GFA in {w:.3f} s "
            f"({mb / w:.1f} MB/s); phases (s): index {ph.get('index', 0):.3f}, "
            f"abacus build {ph.get('abaci_by_total', 0):.3f}, "
            f"hist tail {ph.get('hists', 0):.3f}, growth {ph.get('growth', 0):.3f}"
        )
    print(
        f"[main] launches: unmasked {counts_unmasked}, subset-masked "
        f"{counts_masked}, main path {launches}"
    )
    if counts_unmasked["pt_fused_hist"] < 2:
        fail("histgrowth -c all launched pt_fused_hist fewer than 2 times")
    if (counts_unmasked["pt_parse_pack"], counts_unmasked["pt_parse_pack_edges"]) != (1, 1):
        fail("unmasked histgrowth -c all did not parse its node and edge rows on the card once each")
    if counts_masked["pt_parse_pack"] or counts_masked["pt_parse_pack_edges"]:
        fail("subset-masked histgrowth -c all parsed its step lists on the card")
    launches = {name: launches[name] for name in ("pt_fused_hist", "pt_coverage",
                                                  "pt_parse_pack_edges")}
    for name, n in launches.items():
        if n < 1:
            fail(f"{name} was not launched on the main path")
    with capture() as host_calls, device_route_off():  # the M that the host uploads
        out_host = drive(unmasked, "cuda")[0]
    if table(out_host)[0] != table(out_big)[0]:
        fail("histgrowth -c all on the host route differs from the device route")

    body = check_growth_table(out_big, tg.N_PATHS, "histgrowth")
    body_masked = check_growth_table(out_masked, n_subset, "masked histgrowth")
    if body != table(drive(unmasked, "cpu")[0])[0]:
        fail("histgrowth TSV on cuda differs from the port's run on cpu")
    if body_masked != table(drive(masked, "cpu")[0])[0]:
        fail("masked histgrowth TSV on cuda differs from the port's run on cpu")
    print("[main] cuda TSVs == cpu TSVs (histgrowth -c all, unmasked and subset-masked)")

    small = os.path.join(WORK, "dryrun.gfa")
    visits, lens, edges = tg._write_dryrun_gfa(small)
    _, node_hist, bp_hist, edge_hist = tg._oracle(visits, lens, edges)
    _, rows = table(drive(["hist", "-c", "all", "-S", small], "cuda")[0])
    got = np.array([[int(x) for x in r[1:]] for r in rows[4:]], dtype=np.int64)
    want = np.stack([node_hist, bp_hist, edge_hist], axis=1)
    if not np.array_equal(got, want):
        fail(f"small hist on cuda != numpy oracle:\n{got}\n{want}")
    print("[main] small hist -c all -S on cuda == numpy oracle")
    # the edge pass: the largest M the path hands pt_fused_hist
    edge_hist = max(calls["pt_fused_hist"], key=lambda a: a[0].shape[1])
    routes = (calls["pt_fused_hist"], host_calls["pt_fused_hist"], parse_calls)
    return launches, edge_hist, routes


def check_ordered_table(out: str, n_groups: int, n_thresholds: int, what: str) -> str:
    """The ordered-histgrowth TSV body: 4 header rows, one row per group of
    n_thresholds finite values; the quorum-0 coverage-1 column (the first)
    never decreases."""
    body, rows = table(out)
    if len(rows) != 4 + n_groups or any(len(r) != 1 + n_thresholds for r in rows):
        fail(f"{what} TSV has an unexpected shape ({len(rows)} rows)")
    vals = [[float(x) for x in r[1:]] for r in rows[4:]]
    if not all(math.isfinite(v) for r in vals for v in r):
        fail(f"{what}: non-finite ordered growth value")
    first = [r[0] for r in vals]
    if first != sorted(first) or first[-1] <= 0:
        fail(f"{what}: the quorum-0 ordered growth is not a growing curve")
    return body


def check_similarity_table(out: str, n_groups: int, what: str) -> str:
    """The similarity TSV body: a symmetric n_groups x n_groups matrix of
    values in [0, 1] with ones on the diagonal."""
    import numpy as np

    body, rows = table(out)
    if len(rows) != 1 + n_groups or any(len(r) != 1 + n_groups for r in rows):
        fail(f"{what} TSV has an unexpected shape ({len(rows)} rows)")
    S = np.array([[float(x) for x in r[1:]] for r in rows[1:]])
    if not (np.all(S >= 0) and np.all(S <= 1) and np.array_equal(S, S.T)):
        fail(f"{what}: not a symmetric matrix of values in [0, 1]")
    if not np.all(np.diagonal(S) == 1):
        fail(f"{what}: the diagonal is not 1")
    return body


def phase_group_path(dev, single):
    """Drive the group path on cuda; check it against cpu and oracles.

    ordered-histgrowth (-c bp and -c edge) and similarity (-c node and -c
    bp) on the full-size graph with 90 haplotype groups. Every ordered run
    sets its order, which builds the abaci a second time (as panacus_tpu
    does): the phase order_change times that second build. The -c edge
    ordered run and the -c node similarity run go into `single` for phase
    7."""
    import numpy as np

    from panacus_torch import testgraphs as tg
    from panacus_torch.kernel_times import capture
    from panacus_torch.ops import kernels

    gfa = bench_graph()
    runs = [
        ("ordered-histgrowth -c bp", ORDERED + ["-c", "bp", gfa]),
        ("ordered-histgrowth -c edge", ORDERED + ["-c", "edge", gfa]),
        ("similarity -c node", ["similarity", "-H", "-c", "node", gfa]),
        ("similarity -c bp", ["similarity", "-H", "-c", "bp", gfa]),
    ]
    mb = os.path.getsize(gfa) / 1e6
    kernels.reset_launches()
    outs = []
    for what, argv in runs:
        before = dict(kernels.launches)
        with capture() as calls, capture_parse() as parse_calls:  # for phase 4b
            out, ph, wall = drive(argv, "cuda")
        if what == "ordered-histgrowth -c edge":
            ordered_edge = calls["pt_ordered_growth"]
        if what == "similarity -c node":
            similarity_node = calls["pt_similarity"]
            parse_node = parse_calls["pt_parse_pack"]
        delta = {k: kernels.launches[k] - before[k] for k in kernels.launches}
        if what in SHARDED_RUNS:
            single[what] = (argv, table(out)[0], delta, per_matrix(calls), wall)
        outs.append((what, argv, out, delta))
        print(
            f"[group] {what} -H on cuda: {mb:.1f} MB of GFA in {wall:.3f} s; "
            f"phases (s): index {ph.get('index', 0):.3f}, abacus builds "
            f"{ph.get('abaci_by_total', 0):.3f}, of which the order change's "
            f"second finish() {ph.get('order_change', 0):.3f}, ordered growth "
            f"{ph.get('ordered_growth', 0):.3f}, similarity "
            f"{ph.get('similarity', 0):.3f}; launches {delta}"
        )
    launches = dict(kernels.launches)
    for what, argv, out, delta in outs:
        if what.startswith("ordered") and delta["pt_ordered_growth"] < 3:
            fail(f"{what} launched pt_ordered_growth fewer than 3 times")
        if what.startswith("similarity") and delta["pt_similarity"] < 1:
            fail(f"{what} did not launch pt_similarity")
        # one parse a build, of its node or its edge rows (an ordered run
        # builds twice)
        builds = 2 if what.startswith("ordered") else 1
        edge = what.endswith("-c edge")
        want = {"pt_parse_pack": 0 if edge else builds, "pt_parse_pack_edges": builds if edge else 0}
        if {k: delta[k] for k in want} != want:
            fail(f"{what} launched {({k: delta[k] for k in want})}, not {want}")
        if what.startswith("ordered"):
            body = check_ordered_table(out, tg.N_PATHS, 3, what)
        else:
            body = check_similarity_table(out, tg.N_PATHS, what)
        t0 = time.perf_counter()
        if body != table(drive(argv, "cpu")[0])[0]:
            fail(f"{what} TSV on cuda differs from the port's run on cpu")
        print(f"[group] {what}: cuda TSV == cpu TSV (cpu run {time.perf_counter() - t0:.3f} s)")

    small = os.path.join(WORK, "dryrun.gfa")
    visits, lens, edges = tg._write_dryrun_gfa(small)
    node_mem, *_ = tg._oracle(visits, lens, edges)
    qc = [(0.0, 1), (0.0, 2), (0.5, 1)]
    argv = ["ordered-histgrowth", "-c", "node", "-S", "-q", "0,0,0.5", "-l", "1,2,1", small]
    _, rows = table(drive(argv, "cuda")[0])
    got = np.array([[float(x) for x in r[1:]] for r in rows[4:]])
    w1 = np.ones(node_mem.shape[1], dtype=np.int64)
    w1[0] = 0
    want = np.stack(
        [tg._oracle_ordered(node_mem, w1, c, q) for q, c in qc], axis=1
    )
    if not np.array_equal(got, want):
        fail(f"small ordered-histgrowth on cuda != numpy oracle:\n{got}\n{want}")
    print("[group] small ordered-histgrowth -c node -S on cuda == numpy oracle")

    argv = ["table", "-c", "node", "-S", small]
    body, rows = table(drive(argv, "cuda")[0])
    if body != table(drive(argv, "cpu")[0])[0]:
        fail("table TSV on cuda differs from the port's run on cpu")
    counts = np.zeros((tg.DRYRUN_SAMPLES, node_mem.shape[1]), dtype=np.int64)
    for p, v in enumerate(visits):
        counts[p // 2, v] += 1
    got = np.array([[int(x) for x in r[1:]] for r in rows[1:]])
    if not np.array_equal(got, counts[:, 1:].T):
        fail("small table -c node -S != numpy oracle")
    print("[group] small table -c node -S on cuda == cpu == numpy oracle")
    return launches, ordered_edge, similarity_node, parse_node


@contextlib.contextmanager
def capture_parse():
    """Record the arguments that the streamed build hands
    parse_kernels.parse_pack, as (text, descs, node_lens, n_items, n_spans,
    n_words), and parse_kernels.parse_pack_edges, as (text, descs, row_off,
    adj_ent, n_items, n_words), while the block runs; the calls go through
    as before."""
    from panacus_torch.ops import parse_kernels

    calls = {"pt_parse_pack": [], "pt_parse_pack_edges": []}
    parse_pack, parse_pack_edges = parse_kernels.parse_pack, parse_kernels.parse_pack_edges

    def spy(text, descs, M, node_lens, n_items, acc):
        calls["pt_parse_pack"].append(
            (text, descs, node_lens, n_items, (len(acc) - 1) // 2, M.shape[0]))
        return parse_pack(text, descs, M, node_lens, n_items, acc)

    def spy_edges(text, descs, M, row_off, adj_ent, n_items, err):
        calls["pt_parse_pack_edges"].append((text, descs, row_off, adj_ent, n_items, M.shape[0]))
        return parse_pack_edges(text, descs, M, row_off, adj_ent, n_items, err)

    parse_kernels.parse_pack, parse_kernels.parse_pack_edges = spy, spy_edges
    try:
        yield calls
    finally:
        parse_kernels.parse_pack, parse_kernels.parse_pack_edges = parse_pack, parse_pack_edges


@contextlib.contextmanager
def device_route_off():
    """Builds take the host's route while the block runs (the host
    tokenizer and packs, M uploaded), as where stream.parse_on_device
    refuses them."""
    from panacus_torch import stream

    on = stream.parse_on_device
    stream.parse_on_device = lambda *a, **k: False
    try:
        yield
    finally:
        stream.parse_on_device = on


def phase_path_kernels(dev, edge_hist, ordered_edge, similarity_node, parse_node, routes, res):
    """pt_fused_hist, pt_ordered_growth, pt_similarity, pt_parse_pack and
    pt_parse_pack_edges on the arguments that phases 3 and 4 handed them
    (the path's own edge M, weights and thresholds; the node M and its
    weights; every step list of the graph and its adjacency): exact against
    their plain versions, timed by events and by slope; adds each one's
    numbers under "path" in res. Then pt_fused_hist on the two routes' M
    (compare_hist_routes), under "routes"."""
    import torch

    from panacus_torch.kernel_times import ORDERED_QC, copies, event_ms, slope_ms
    from panacus_torch.ops import group_kernels as gk
    from panacus_torch.ops import hist_kernels as hk

    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    M, W, n_bins = edge_hist
    label = f"path edge M ({M.shape[0]} x {M.shape[1]}, {W.shape[0]} weight vector(s))"
    got, want = hk.fused_hist(M, W, n_bins), hk.fused_hist_ref(M, W, n_bins)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        fail(f"pt_fused_hist {label}: kernel != plain")
    ms = event_ms(lambda: hk.fused_hist(M, W, n_bins), 20, flush)
    slope = slope_ms([lambda s=s: hk.fused_hist(s[0], s[1], n_bins) for s in copies((M, W))])
    nbytes = M.numel() * 4 + W.numel() * 4 + W.shape[0] * n_bins * 8
    bound_ms, bound_by = bound(nbytes, M.shape[1] * (2 * M.shape[0] + W.shape[0]), SCALAR_OPS)
    print(
        f"[path] pt_fused_hist {label}: exact; {ms:.4f} ms by events, {slope:.4f} "
        f"by slope; bound {bound_ms:.4f} ms ({nbytes / 1e6:.1f} MB, {bound_by}), "
        f"{bound_ms / slope:.3f} of it by slope"
    )
    res["pt_fused_hist"]["path"] = {"ms": ms, "slope_ms": slope, "bound_ms": bound_ms,
                                    "at": f"{M.shape[0]}x{M.shape[1]}, {W.shape[0]} vector(s)"}
    res["pt_ordered_growth"]["path"] = {}
    if len(ordered_edge) != len(ORDERED_QC):
        fail(f"ordered-histgrowth -c edge made {len(ordered_edge)} calls, not {len(ORDERED_QC)}")
    for (q, c), (M, w, thr, c_min) in zip(ORDERED_QC, ordered_edge):
        got, want = gk.ordered_growth(M, w, thr, c_min), gk.ordered_growth_ref(M, w, thr, c_min)
        torch.cuda.synchronize()
        if c_min != c or not torch.equal(got, want):
            fail(f"pt_ordered_growth path edge M q={q} c={c}: kernel != plain")
        ms = event_ms(lambda: gk.ordered_growth(M, w, thr, c_min), 10, flush)
        slope = slope_ms([lambda s=s: gk.ordered_growth(s[0], s[1], thr, c_min)
                          for s in copies((M, w))])
        bound_ms, bound_by, nbytes = ordered_bound(M, thr.shape[0])
        print(
            f"[path] pt_ordered_growth path edge M ({M.shape[0]} x {M.shape[1]}) q={q} "
            f"c={c}: exact; {ms:.4f} ms by events, {slope:.4f} by slope; bound "
            f"{bound_ms:.4f} ms ({nbytes / 1e6:.1f} MB, {bound_by}), "
            f"{bound_ms / slope:.3f} of it by slope"
        )
        res["pt_ordered_growth"]["path"][f"q={q} c={c}"] = {
            "ms": ms, "slope_ms": slope, "bound_ms": bound_ms}
    if len(similarity_node) != 1:
        fail(f"similarity -c node made {len(similarity_node)} calls, not 1")
    M, w, w_max = similarity_node[0]
    got, want = gk.similarity(M, w, w_max), gk.similarity_ref(M, w)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        fail("pt_similarity path node M: kernel != plain")
    ms = event_ms(lambda: gk.similarity(M, w, w_max), 10, flush)
    slope = slope_ms([lambda s=s: gk.similarity(s[0], s[1], w_max) for s in copies((M, w))])
    planes = gk.n_planes(int(w.max()) if w_max is None else w_max)
    nbytes = (M.numel() + M.shape[1]) * 4 + got.numel() * 8
    ops = 2 * (32 * M.shape[0]) * (32 * M.shape[0] + 1) // 2 * M.shape[1] * planes
    bound_ms, bound_by = bound(nbytes, ops, INT8_TC_OPS)
    print(
        f"[path] pt_similarity path node M ({M.shape[0]} x {M.shape[1]}, {planes} byte "
        f"planes): exact; {ms:.4f} ms by events, {slope:.4f} by slope; bound "
        f"{bound_ms:.4f} ms ({nbytes / 1e6:.1f} MB, {bound_by}), {bound_ms / slope:.3f} "
        f"of it by slope"
    )
    res["pt_similarity"]["path"] = {"ms": ms, "slope_ms": slope, "bound_ms": bound_ms,
                                    "at": f"{M.shape[0]}x{M.shape[1]}, {planes} planes"}
    if len(parse_node) != 1:
        fail(f"the build of similarity -c node made {len(parse_node)} parse calls, not 1")
    got = check_parse("path: similarity -c node's step lists", parse_node[0], flush)
    res["pt_parse_pack"]["path"] = {k: got[k] for k in ("ms", "slope_ms", "bound_ms", "at")}
    parse_edges = routes[2]["pt_parse_pack_edges"]
    if len(parse_edges) != 1:
        fail(f"the build of histgrowth -c all made {len(parse_edges)} edge parse calls, not 1")
    got = check_parse_edges("path: histgrowth -c all's step lists", parse_edges[0], flush)
    res["pt_parse_pack_edges"]["path"] = {k: got[k] for k in ("ms", "slope_ms", "bound_ms", "at")}
    res["pt_fused_hist"]["routes"] = compare_hist_routes(*routes, flush)


def compare_hist_routes(device_route, host_route, parses, flush):
    """pt_fused_hist on the node and the edge M that the unmasked -c all's
    device route left (rows ORed in by pt_parse_pack and
    pt_parse_pack_edges) against those the host route uploaded: the same M
    and weights; each call timed by events (L2 flushed) and by slope on
    either route's tensors; then each route's last writes to M replayed
    before the two calls, as a command runs them (the device route: both
    parses into zeroed M; the host route: M's copies from pinned memory),
    and each call timed by events right after, REPLAYS times, medians."""
    import torch

    from panacus_torch.kernel_times import event_ms, slope_ms
    from panacus_torch.ops import hist_kernels as hk
    from panacus_torch.ops import parse_kernels as pk

    if len(device_route) != len(host_route) or len(device_route) < 2:
        fail(f"histgrowth -c all made {len(device_route)} / {len(host_route)} pt_fused_hist "
             f"calls on the device / host route")
    for (Md, Wd, nd), (Mh, Wh, nh) in zip(device_route, host_route):
        if nd != nh or not (torch.equal(Md, Mh) and torch.equal(Wd, Wh)):
            fail("pt_fused_hist: the device route's M or weights differ from the host route's")
    # the node pass reads the narrowest M, the edge pass the widest
    by_width = sorted(range(len(device_route)), key=lambda i: device_route[i][0].shape[1])
    device_route = [device_route[by_width[0]], device_route[by_width[-1]]]
    host_route = [host_route[by_width[0]], host_route[by_width[-1]]]
    out = {}
    for what, (Md, W, n_bins), (Mh, _, _) in zip(("node", "edge"), device_route, host_route):
        out[what] = {
            f"{route}_{how}": t
            for route, M in (("device", Md), ("host", Mh))
            for how, t in (
                ("ms", event_ms(lambda M=M: hk.fused_hist(M, W, n_bins), 20, flush)),
                ("slope_ms", slope_ms([lambda M=M: hk.fused_hist(M, W, n_bins)])),
            )
        }
    (node_M, node_W, node_bins), (edge_M, edge_W, edge_bins) = device_route
    text, descs, lens, n_items, n_spans, _ = parses["pt_parse_pack"][0]
    _, _, row_off, adj_ent, _, _ = parses["pt_parse_pack_edges"][0]
    Mn, Me = torch.zeros_like(node_M), torch.zeros_like(edge_M)
    acc = torch.zeros(1 + 2 * n_spans, dtype=torch.int64, device=Mn.device)
    err = torch.zeros(1, dtype=torch.int64, device=Mn.device)
    pinned = [M.cpu().pin_memory() for M in (node_M, edge_M)]

    def device_writes():
        Mn.zero_()
        Me.zero_()
        acc.zero_()
        acc[0] = err[0] = int(pk.ERR_NONE)
        pk.parse_pack(text, descs, Mn, lens, n_items, acc)
        pk.parse_pack_edges(text, descs, Me, row_off, adj_ent, n_items, err)

    def host_writes():
        Mn.copy_(pinned[0], non_blocking=True)
        Me.copy_(pinned[1], non_blocking=True)

    for route, writes in (("device", device_writes), ("host", host_writes)) * 2:
        times = []
        for _ in range(REPLAYS):
            writes()
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
            ev[0].record()
            hk.fused_hist(Mn, node_W, node_bins)
            ev[1].record()
            hk.fused_hist(Me, edge_W, edge_bins)
            ev[2].record()
            times.append(ev)
        torch.cuda.synchronize()
        if not (torch.equal(Mn, node_M) and torch.equal(Me, edge_M)):
            fail(f"pt_fused_hist: the {route} route's replayed writes left another M")
        for i, what in enumerate(("node", "edge")):
            ms = statistics.median(e[i].elapsed_time(e[i + 1]) for e in times)
            out[what].setdefault(f"{route}_after_writes_ms", []).append(ms)
    for what, t in out.items():
        print(
            f"[path] pt_fused_hist {what} M, device route / host route (same M, exact): "
            f"{t['device_ms']:.4f} / {t['host_ms']:.4f} ms by events (L2 flushed), "
            f"{t['device_slope_ms']:.4f} / {t['host_slope_ms']:.4f} by slope; right after the "
            f"route's writes, in two turns: "
            + " / ".join(", ".join(f"{x:.4f}" for x in t[f"{r}_after_writes_ms"])
                         for r in ("device", "host"))
            + " ms"
        )
    return out


REPLAYS = 20  # replays of each route's writes before the two pt_fused_hist calls


# phase 6: the report path, a report of two runs on the graph of phase 3
REPORT_YAML = """\
- graph: {gfa}
  grouping: Haplotype
  analyses:
    - !Info
    - !Hist
      count_type: All
    - !Growth
      coverage: 1,1,2
      quorum: 0,0.5,1
    - !CoverageLine
      count_type: Node
    - !NodeDistribution
    - !OrderedGrowth
      count_type: Edge
      coverage: 1,1,2
      quorum: 0,0.5,1
- graph: {gfa}
  name: by sample
  grouping: Sample
  analyses:
    - !Hist
      count_type: All
    - !Growth
      coverage: 1,2
      quorum: 0,0.5
    - !Similarity
      count_type: Node
"""
# the least launches of each kernel in a command of phase 6
REPORT_LAUNCHES = {
    "node-distribution": {"pt_coverage": 1},
    "report --json": {"pt_fused_hist": 1, "pt_ordered_growth": 3, "pt_similarity": 1},
}


def report_body(out: str, kind: str):
    """What must equal between two runs of one command: a TSV without its
    `#` lines, the report JSON (parsed strictly) without the `#` lines of its
    tables, the HTML without its <footer> line."""
    if kind == "tsv":
        return table(out)[0]
    if kind == "html":
        return [l for l in out.splitlines() if not l.startswith("<footer>")]

    def no_const(x):
        fail(f"non-finite constant {x} in the report JSON")

    sections = json.loads(out, parse_constant=no_const)
    for sec in sections:
        if sec["table"] is not None:
            sec["table"] = [l for l in sec["table"].split("\n")
                            if not l.lstrip("`").startswith("#")]
    return sections


def info_rows(out: str):
    """The info TSV as {(feature, category, countable): value}."""
    return {tuple(r[:3]): r[3] for r in table(out)[1][1:]}


def phase_report_path(dev):
    """Drive the report path on cuda; check it against cpu and an oracle.
    Returns the launches of each kernel in this phase."""
    import numpy as np

    from panacus_torch import testgraphs as tg
    from panacus_torch.ops import kernels

    gfa = bench_graph()
    subset = os.path.join(WORK, "subset.bed")  # phase 3's
    yaml = os.path.join(WORK, "report.yaml")
    report_json = os.path.join(WORK, "report.json")  # each device's in turn
    with open(yaml, "w") as f:
        f.write(REPORT_YAML.format(gfa=gfa))
    runs = [
        ("info -H", ["info", "-H", gfa], "tsv"),
        ("info -S", ["info", "-S", gfa], "tsv"),
        ("subset-masked info -H", ["info", "-H", "-s", subset, gfa], "tsv"),
        ("node-distribution", ["node-distribution", gfa], "tsv"),
        ("report --json", ["report", "--json", yaml], "json"),
        ("render", ["render", report_json], "html"),
        ("report (HTML)", ["report", yaml], "html"),
    ]
    print(f"[report] {os.path.getsize(gfa) / 1e6:.1f} MB of GFA, on cuda:")
    kernels.reset_launches()
    outs = {}
    for what, argv, kind in runs:
        before = dict(kernels.launches)
        out, ph, wall = drive(argv, "cuda")
        delta = {k: kernels.launches[k] - before[k] for k in kernels.launches}
        outs[what] = out
        if what == "report --json":
            with open(report_json, "w") as f:
                f.write(out)
        phases = ", ".join(f"{k} {v:.3f}" for k, v in ph.items()) or "none"
        print(
            f"[report] {what} on cuda: {wall:.3f} s; phases (s): {phases}; "
            f"{len(out) / 1e6:.1f} MB out; launches "
            f"{ {k: n for k, n in delta.items() if n} }"
        )
        for name, least in REPORT_LAUNCHES.get(what, {}).items():
            if delta[name] < least:
                fail(f"{what} launched {name} {delta[name]} times, fewer than {least}")
    launches = dict(kernels.launches)

    rows = info_rows(outs["info -H"])
    if (rows[("graph", "total", "node")] != str(tg.N_NODES)
            or rows[("graph", "total", "path")] != str(tg.N_PATHS)
            or rows[("graph", "total", "group")] != str(tg.N_PATHS)):
        fail("info -H does not count the graph's nodes, paths and groups")
    _, nd = table(outs["node-distribution"])
    if sum(int(r[3]) for r in nd[1:]) != tg.N_NODES:
        fail("node-distribution does not bin every node once")
    sections = report_body(outs["report --json"], "json")
    kinds = {sec["analysis"] for sec in sections}
    if len({sec["run_name"] for sec in sections}) != 2 or len(kinds) < 7:
        fail(f"the report holds {len(kinds)} analyses of {len(sections)} sections")
    for what, argv, kind in runs:
        t0 = time.perf_counter()
        cpu = drive(argv, "cpu")[0]
        if what == "report --json":
            with open(report_json, "w") as f:
                f.write(cpu)
        if report_body(outs[what], kind) != report_body(cpu, kind):
            fail(f"{what} on cuda differs from the port's run on cpu")
        print(f"[report] {what}: cuda output == cpu output ({kind}; cpu run "
              f"{time.perf_counter() - t0:.3f} s)")

    small = os.path.join(WORK, "dryrun.gfa")
    visits, lens, edges = tg._write_dryrun_gfa(small)
    rows = info_rows(drive(["info", "-S", small], "cuda")[0])
    n_visits = [len(v) for v in visits]
    want = {
        ("graph", "total", "node"): tg.DRYRUN_NODES,
        ("graph", "total", "bp"): int(lens.sum()),
        ("graph", "total", "edge"): len(edges),
        ("graph", "total", "path"): len(visits),
        ("graph", "total", "group"): tg.DRYRUN_SAMPLES,
        ("path", "longest", "node"): max(n_visits),
        ("path", "shortest", "node"): min(n_visits),
        # a group sums the P line of its sample only: the W line carries
        # coordinates, and info skips such paths, as panacus does
        # (info.rs:544-547)
        **{("group", f"s{k}", "node"): n_visits[2 * k] for k in range(tg.DRYRUN_SAMPLES)},
        **{("group", f"s{k}", "bp"): int(lens[visits[2 * k]].sum())
           for k in range(tg.DRYRUN_SAMPLES)},
    }
    bad = {k: (rows.get(k), v) for k, v in want.items() if rows.get(k) != str(v)}
    if bad:
        fail(f"small info -S on cuda != numpy oracle: {bad}")
    print("[report] small info -S on cuda == numpy oracle")
    return launches


# phase 5: the probe path, at the probe's default shape (M 32 x 2^23)
PROBE_ROUNDS = 3
PROBE_KERNELS = ("pt_xor_fold", "pt_word_fold", "pt_limb_hist")
# the variant whose time stands for each kernel in the JSON line
PROBE_MAIN = {"pt_xor_fold": "read", "pt_word_fold": "pc", "pt_limb_hist": "fh23"}
PROBE_SALTS = (0, 2**31 - 5)  # the second wraps W + salt negative


def check_probe_routes(M, W):
    """Every route of the three probe kernels on M and W against its plain
    version, exact, at each of PROBE_SALTS (the folds only when W is one
    vector, all they take). The plain output of each function is computed
    once: the route flags (mma_cov, weight_side) do not change it. Returns
    the max abs error of each kernel."""
    import torch

    from panacus_torch import probe

    err = {name: 0 for name in PROBE_KERNELS}
    for salt in PROBE_SALTS:
        plain = {}
        for variant, (name, kw) in probe.ROUTES.items():
            if name not in err or (W.shape[0] > 1 and name != "pt_limb_hist"):
                continue
            key = (name, kw.get("op"), kw.get("n_limbs"))
            if key not in plain:
                plain[key] = probe.pass_fn(variant, M, W, plain=True)(salt)
            got, want = probe.pass_fn(variant, M, W)(salt), plain[key]
            torch.cuda.synchronize()
            e = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
            if e or not torch.equal(got, want):
                fail(f"{name} ({variant}) on {W.shape[0]} vector(s), salt {salt}: "
                     f"kernel != plain (max abs err {e})")
            err[name] = max(err[name], e)
    return err


def phase_probe(dev, smi):
    """The probe kernels against their plain versions at the probe's shape,
    then the probe path; returns (per-kernel results, launches, read
    ceiling in bytes/s)."""
    import torch

    from panacus_torch import probe
    from panacus_torch.kernel_times import event_ms
    from panacus_torch.ops import kernels

    M, w = probe.make_inputs(dev, probe.N_WORDS, probe.N_ITEMS, 0)
    g = torch.Generator(device=dev)
    g.manual_seed(4)
    W2 = torch.randint(
        -(2**31), 2**31, (2, probe.N_ITEMS), dtype=torch.int32, device=dev, generator=g
    )
    t0 = time.perf_counter()
    err = check_probe_routes(M, w)
    for name, e in check_probe_routes(M, W2).items():
        err[name] = max(err[name], e)
    del W2
    routes = sorted(v for v, (name, _) in probe.ROUTES.items() if name in PROBE_KERNELS)
    print(f"[probe] every route ({' '.join(routes)}) == plain at {probe.N_WORDS} x "
          f"{probe.N_ITEMS}, the probe's one weight vector and two vectors of any "
          f"int32, salts {PROBE_SALTS}")
    for mma in (False, True):
        if not probe.parity(M, w, mma):
            fail(f"pt_limb_hist (mma_cov={mma}) recombined != pt_fused_hist")
    print(f"[probe] pt_limb_hist recombined == pt_fused_hist (both coverage "
          f"routes); checks took {time.perf_counter() - t0:.1f} s")

    nbytes = probe.pass_bytes(M, w)
    t0 = time.perf_counter()
    kernels.reset_launches()
    times = probe.run(list(probe.VARIANTS), PROBE_ROUNDS, M, w,
                      out=lambda s: print(f"[probe] {s}"))
    launches = {name: kernels.launches[name] for name in PROBE_KERNELS}
    med = probe.summary(times, nbytes, out=lambda s: print(f"[probe] {s}"))
    print(f"[probe] launches on the probe path: {launches}; "
          f"{time.perf_counter() - t0:.1f} s")
    for name, n in launches.items():
        if n < 1:
            fail(f"{name} was not launched on the probe path")
    read_bps = nbytes / med["read"]
    print(
        f"[probe] measured read ceiling (pt_xor_fold, slope of CUDA-event "
        f"chains, M {probe.N_WORDS} x {probe.N_ITEMS}): {read_bps / 1e9:.1f} GB/s, "
        f"{read_bps / HBM_BPS:.4f} of the datasheet's 3.35 TB/s; card: {smi}"
    )

    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    res = {}
    for name, main_variant in PROBE_MAIN.items():
        ms = med[main_variant] * 1e3
        plain_ms = event_ms(lambda: probe.pass_fn(main_variant, M, w, plain=True)(0), 3, flush)
        work_bytes, ops, tensor_cores = probe.pass_work(main_variant, M, w)
        bound_ms, bound_by = bound(work_bytes, ops, INT8_TC_OPS if tensor_cores else SCALAR_OPS)
        print(
            f"[probe] {name} ({main_variant}): kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms; bound {bound_ms:.4f} ms ({bound_by}), "
            f"{bound_ms / ms:.3f} of it reached; library: none"
        )
        variants = [v for v in med if probe.route(v)[0] == name]
        res[name] = {
            "max_abs_err": err[name], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "at": f"{probe.N_WORDS}x{probe.N_ITEMS} ({main_variant})",
            "variants_ms": {v: med[v] * 1e3 for v in variants},
            "_bytes": work_bytes,
        }
    del M, w, flush
    return res, launches, read_bps


# phase 7: the membership matrix split over item shards
SHARDED_RUNS = ("histgrowth -c all", "ordered-histgrowth -c edge", "similarity -c node")
# (label, n_groups, n_items): the main path's edge M (3 x 3,604,480) and
# the 1 GiB M of phase 2 (1024 groups x 2^23)
SHARDED_SHAPES = [
    ("edge M of the main path", 90, 3_604_480 - 1),
    ("1 GiB M", 1024, (1 << 23) - 1),
]
SHARDED_QC = [(0.0, 1), (0.5, 1), (1.0, 2)]
N_PAIRS = 8_000_000  # occurrence pairs of the build check, with duplicates
SHARDED_ROUNDS = 5  # warm samples of each shard tuple, taken in turns


def per_matrix(calls):
    """From kernel_times.capture's calls: for each kernel, the number of
    calls on each distinct M (a whole matrix, or one shard), sorted."""
    out = {}
    for name, args in calls.items():
        n = {}
        for a in args:
            n[id(a[0])] = n.get(id(a[0]), 0) + 1
        out[name] = sorted(n.values())
    return out


def shard_configs():
    """The shard tuples phase 7 runs: four shards on the first card, and
    one shard on each card where two or more are visible."""
    import torch

    first = torch.device("cuda", 0)
    configs = [(first,) * 4]
    n = torch.cuda.device_count()
    if n > 1:
        configs.append(tuple(torch.device("cuda", i) for i in range(n)))
    return configs


def describe(devices) -> str:
    return f"devices: {len(set(devices))} distinct of {len(devices)} shards"


def engine_ops(eng, bp):
    """coverage, hist_multi (ones and bp), ordered growth at SHARDED_QC and
    similarity (bp) of one engine: (results, wall s)."""
    t0 = time.perf_counter()
    out = [eng.coverage(), *eng.hist_multi([None, bp])]
    out += [eng.ordered_growth(bp, q, c) for q, c in SHARDED_QC]
    out.append(eng.similarity(bp))
    return out, time.perf_counter() - t0


def counted(fn):
    """Run fn with the launch counts set to 0 just before and read just
    after, the arguments of each call captured: (fn's result, launches,
    calls)."""
    from panacus_torch.kernel_times import capture
    from panacus_torch.ops import kernels

    kernels.reset_launches()
    with capture() as calls:
        res = fn()
    return res, dict(kernels.launches), calls


def check_scaled(what, k, launches, one):
    """Each kernel launched k times as often on k shards as on one, but for
    the step-list parse, which only a build on one device runs
    (stream.parse_on_device): it must not run on k > 1 shards."""
    parse = ("pt_parse_pack", "pt_parse_pack_edges")
    bad = {
        n: (launches[n], one[n])
        for n in one
        if launches[n] != (0 if n in parse and k > 1 else k * one[n])
    }
    if bad:
        fail(f"{what}: launches on {k} shards are not {k} x one device's: {bad}")


def samples(xs, scale=1.0, fmt="%.4f") -> str:
    """The median of xs and every sample, in the order taken."""
    return (fmt % (statistics.median(xs) * scale)) + " [" + ", ".join(
        fmt % (x * scale) for x in xs) + "]"


def phase_sharded_engine(configs, flush):
    """Engine level: each shape on the first card alone and on each shard
    tuple, outputs exactly equal, launches k times one device's, each
    shard's count printed; then SHARDED_ROUNDS warm op sets of each, in
    turns. The 1 GiB hist is timed per shard and for the whole set, in
    turns with one device. Then CountingEngine.build from occurrence pairs
    on cuda against the host-packed M and the CPU build."""
    import numpy as np
    import torch

    from panacus_torch.kernel_times import event_ms, random_m
    from panacus_torch.ops import hist_kernels as hk
    from panacus_torch.ops.engine import CountingEngine

    first = configs[0][0]  # the first card
    g = torch.Generator(device=first)
    g.manual_seed(7)
    rng = np.random.default_rng(7)
    for label, n_groups, n_items in SHARDED_SHAPES:
        n_words = (n_groups + 31) // 32
        M = random_m(n_words, n_items + 1, n_groups, first, g).cpu().numpy().view(np.uint32)
        bp = rng.integers(1, 17, n_items + 1)
        bp[0] = 0
        one = CountingEngine.from_host_state(M, n_items, n_groups, first)
        (want, wall_one), launches_one, _ = counted(lambda: engine_ops(one, bp))
        print(f"[sharded] {label} ({n_words} x {n_items + 1}) on cuda:0 alone: first "
              f"op set {wall_one:.3f} s; launches "
              f"{ {n: c for n, c in launches_one.items() if c} }")
        engines = []
        for devs in configs:
            eng = CountingEngine.from_host_state(M, n_items, n_groups, devs)
            (got, wall), launches, calls = counted(lambda: engine_ops(eng, bp))
            for a, b in zip(got, want):
                if a.shape != b.shape or not np.array_equal(a, b):
                    fail(f"{label} on {len(devs)} shards differs from one device")
            k = len(devs)
            check_scaled(label, k, launches, launches_one)
            index = {id(m): s for s, m in enumerate(eng.shards)}
            per_shard = {}
            for name, args in calls.items():
                if args:
                    n = [0] * k
                    for a in args:
                        n[index[id(a[0])]] += 1
                    per_shard[name] = n
            print(f"[sharded] {label} on {k} shards ({describe(devs)}): coverage, "
                  f"hist_multi, ordered growth q,c={SHARDED_QC} and similarity == "
                  f"one device's; first op set {wall:.3f} s (cold on cards not used "
                  f"before); launches per shard {per_shard}")
            engines.append(eng)
        # warm op sets, in turns: one device, then each tuple
        walls = [[] for _ in range(1 + len(engines))]
        for _ in range(SHARDED_ROUNDS):
            for i, eng in enumerate([one] + engines):
                walls[i].append(engine_ops(eng, bp)[1])
        print(f"[sharded] {label}: op set, {SHARDED_ROUNDS} warm runs in turns, s: "
              f"cuda:0 alone {samples(walls[0])}; " + "; ".join(
                  f"{describe(devs)} {samples(w)}" for devs, w in zip(configs, walls[1:])))
        if label == "1 GiB M":
            for devs, eng in zip(configs, engines):
                per = []
                for m in eng.shards:
                    W = torch.ones((1, m.shape[1]), dtype=torch.int32, device=m.device)
                    with torch.cuda.device(m.device):
                        per.append(event_ms(lambda m=m, W=W: hk.fused_hist(m, W, n_groups + 2),
                                            10, flush[m.device]))
                set_walls, one_walls = [], []
                for _ in range(10):
                    for e, ws in ((eng, set_walls), (one, one_walls)):
                        t0 = time.perf_counter()
                        e.hist()
                        ws.append(time.perf_counter() - t0)
                print(f"[sharded] 1 GiB hist (all-ones) on {len(devs)} shards "
                      f"({describe(devs)}): pt_fused_hist per shard "
                      f"{['%.4f' % t for t in per]} ms by events; the whole set (launch, "
                      f"copy back, merge), 10 in turns with one device, ms: "
                      f"{samples(set_walls, 1e3)}; one device {samples(one_walls, 1e3)}")
        del engines, eng, one, M

    # build from occurrence pairs: the edge M's shape, 8M pairs with duplicates
    n_groups, n_items = SHARDED_SHAPES[0][1:]
    items = rng.integers(0, n_items + 1, N_PAIRS)
    groups = rng.integers(0, n_groups, N_PAIRS)
    cpu = CountingEngine(n_items, n_groups, torch.device("cpu")).build(items, groups)
    M = np.zeros((cpu.n_words, cpu.n_items_pad), dtype=np.uint32)
    np.bitwise_or.at(M, (groups >> 5, items), np.uint32(1) << (groups & 31).astype(np.uint32))
    if not np.array_equal(cpu.shards[0].numpy().view(np.uint32), M):
        fail("CountingEngine.build on the CPU != the host-packed M")
    for devs in [(first,)] + configs:
        t0 = time.perf_counter()
        eng = CountingEngine(n_items, n_groups, devs).build(items, groups)
        got = np.concatenate([m.cpu().numpy() for m in eng.shards], axis=1).view(np.uint32)
        wall = time.perf_counter() - t0
        if not (np.array_equal(got[:, : n_items + 1], M[:, : n_items + 1])
                and not got[:, n_items + 1 :].any()):
            fail(f"CountingEngine.build on {len(devs)} cuda shards != the host-packed M")
        print(f"[sharded] build from {N_PAIRS} pairs on {len(devs)} shards "
              f"({describe(devs)}): == host-packed M == CPU build; {wall:.3f} s")


def phase_sharded_upload(configs):
    """Where a k-shard engine spends its host time on the CLI's way of
    filling M (MembershipStream) at the edge M's shape, on the first card
    alone and on each tuple, SHARDED_ROUNDS in turns after one cold round:
    the zero fills of the shards, the pinned host rows, issuing the copies
    of each word's row (k a word), waiting for them, and one upload of
    bp-sized weights (`_w_dev`, as every weighted op makes). The assembled
    shards must equal the rows."""
    import numpy as np
    import torch

    from panacus_torch.ops.engine import MembershipStream

    _, n_groups, n_items = SHARDED_SHAPES[0]
    rng = np.random.default_rng(11)
    one = (configs[0][0],)
    tuples = [one] + configs
    steps = ("zero fills", "pinned rows", "issue copies", "copies done", "weights")
    times = [{st: [] for st in steps} for _ in tuples]
    rows = bp = None
    for r in range(1 + SHARDED_ROUNDS):
        for i, devs in enumerate(tuples):
            cards = sorted(set(devs), key=lambda d: d.index)

            def sync():
                for d in cards:
                    torch.cuda.synchronize(d)

            t = [time.perf_counter()]
            stream = MembershipStream(n_items, n_groups, devs)
            sync()
            t.append(time.perf_counter())
            eng = stream.engine
            if rows is None:
                rows = rng.integers(0, 2**32, (eng.n_words, eng.n_items_pad), dtype=np.uint32)
                rows[:, n_items + 1 :] = 0
                bp = rng.integers(1, 17, n_items + 1)
                bp[0] = 0
            host = [stream.host_row(w) for w in range(eng.n_words)]
            t.append(time.perf_counter())
            for w, row in enumerate(host):
                row[:] = rows[w]
            t.append(time.perf_counter())  # the host's fill is not one of the steps
            for w, row in enumerate(host):
                stream.feed(w, row)
            t.append(time.perf_counter())
            eng = stream.finalize()
            sync()
            t.append(time.perf_counter())
            eng._w_dev(bp)
            sync()
            t.append(time.perf_counter())
            if r == 0:
                got = np.concatenate([m.cpu().numpy() for m in eng.shards], axis=1)
                if not np.array_equal(got.view(np.uint32), rows):
                    fail(f"MembershipStream on {len(devs)} shards != the rows fed")
                continue
            d = [t[1] - t[0], t[2] - t[1], t[4] - t[3], t[5] - t[4], t[6] - t[5]]
            for st, x in zip(steps, d):
                times[i][st].append(x)
            del stream, eng, host
    for devs, ts in zip(tuples, times):
        print(f"[sharded] MembershipStream of the edge M ({len(rows)} x {rows.shape[1]}) "
              f"on {len(devs)} shard(s) ({describe(devs)}) == the rows; warm, ms, "
              f"median [samples]: " + "; ".join(
                  f"{st} {samples(ts[st], 1e3, '%.3f')}" for st in steps))


def phase_sharded_cli(configs, single):
    """CLI level: the commands of SHARDED_RUNS through the port's CLI with
    M split over each shard tuple, in turns with the first card alone,
    SHARDED_ROUNDS times each: each TSV equal to the one-card run's of
    phases 3-4, each kernel launched k times as often, each shard's
    launches those of the one-card run's matrix. The walls and each
    pipeline phase are printed as medians and samples."""
    from panacus_torch.testgraphs import dryrun_multichip

    one = (configs[0][0],)
    tuples = [one] + configs
    for what in SHARDED_RUNS:
        argv, body, launches_one, per_one, wall_first = single[what]
        print(f"[sharded] {what} -H, first run on the first card alone "
              f"(phases 3-4): {wall_first:.3f} s")
        walls = [[] for _ in tuples]
        phases = [{} for _ in tuples]
        shown = set()
        for _ in range(SHARDED_ROUNDS):
            for i, devs in enumerate(tuples):
                k = len(devs)
                (out, ph, wall), launches, calls = counted(lambda: drive(argv, "cuda", devs))
                if table(out)[0] != body:
                    fail(f"{what} on {k} shards: TSV differs from the one-card run")
                check_scaled(what, k, launches, launches_one)
                per_shard = per_matrix(calls)
                for name, counts in per_one.items():
                    if per_shard[name] != sorted(counts * k):
                        fail(f"{what} on {k} shards: {name} launches per shard "
                             f"{per_shard[name]}, one card's matrices {counts}")
                walls[i].append(wall)
                for n, x in ph.items():
                    phases[i].setdefault(n, []).append(x)
                if i not in shown:
                    shown.add(i)
                    print(f"[sharded] {what} -H on {k} shard(s) ({describe(devs)}): TSV "
                          f"== phases 3-4's; launches "
                          f"{ {n: c for n, c in launches.items() if c} }, per shard "
                          f"{ {n: c for n, c in per_shard.items() if c} }")
        for devs, w, ph in zip(tuples, walls, phases):
            print(f"[sharded] {what} -H on {len(devs)} shard(s) ({describe(devs)}), "
                  f"{SHARDED_ROUNDS} runs in turns, s: wall {samples(w, fmt='%.3f')}; "
                  + "; ".join(f"{n} {samples(x, fmt='%.3f')}" for n, x in ph.items()))
    for devs in configs:
        print(f"[sharded] {dryrun_multichip(devs)}")


def phase_sharded(single):
    """Phase 7. `single` holds the one-card runs of SHARDED_RUNS from phases
    3-4."""
    import torch

    configs = shard_configs()
    print(f"[sharded] {torch.cuda.device_count()} card(s) visible; shard tuples: "
          + "; ".join(describe(d) for d in configs))
    t0 = time.perf_counter()
    flush = {d: torch.empty(256 << 20, dtype=torch.uint8, device=d)
             for d in {d for c in configs for d in c}}
    phase_sharded_engine(configs, flush)
    del flush
    phase_sharded_upload(configs)
    phase_sharded_cli(configs, single)
    print(f"[sharded] phase 7 took {time.perf_counter() - t0:.1f} s")


# phase 8: the CLI as two processes of a process group
MULTI_RUNS = SHARDED_RUNS + ("subset-masked histgrowth -c all",)
MULTI_RANKS = 2
# the least launches of each kernel on each shard of a rank, per command
MULTI_LEAST = {
    "histgrowth -c all": {"pt_fused_hist": 2},
    "ordered-histgrowth -c edge": {"pt_ordered_growth": 3},
    "similarity -c node": {"pt_similarity": 1},
    "subset-masked histgrowth -c all": {"pt_fused_hist": 1},
}


def multi_layouts():
    """(label, extra environment) of each layout phase 8 runs."""
    import torch

    visible = os.environ.get("CUDA_VISIBLE_DEVICES")
    first = visible.split(",")[0] if visible else "0"
    out = [("2 ranks sharing the first card", {"CUDA_VISIBLE_DEVICES": first})]
    if torch.cuda.device_count() >= 2:
        out.append(("2 ranks with their own cards", {}))
    return out


def phase_multiprocess(single):
    """Phase 8. `single` holds the one-process runs of MULTI_RUNS from phases
    3-4. Returns each kernel's launches, summed over the ranks, in the
    first layout."""
    from panacus_torch.parallel.launch import launch

    t_phase = time.perf_counter()
    small = os.path.join(WORK, "dryrun.gfa")
    table_argv = ["table", "-c", "node", "-H", small]
    table_body = table(drive(table_argv, "cuda")[0])[0]
    runs = [(what, single[what][0], single[what][1], single[what][4]) for what in MULTI_RUNS]
    runs.append(("table -c node -H (dryrun graph)", table_argv, table_body, None))
    spec = os.path.join(WORK, "multiprocess_commands.json")
    with open(spec, "w") as f:
        json.dump([argv for _, argv, _, _ in runs], f)
    first_launches = None
    for label, extra in multi_layouts():
        report = os.path.join(WORK, "multiprocess")
        env = {**os.environ, "PANACUS_TORCH_DEVICE": "cuda", **extra}
        t0 = time.perf_counter()
        outs = launch(
            [sys.executable, "-m", "panacus_torch.parallel.launch", report, spec],
            MULTI_RANKS,
            env=env,
            cwd=ROOT,
            timeout=420,
        )
        wall = time.perf_counter() - t0
        ranks = []
        for r in range(MULTI_RANKS):
            with open(f"{report}.{r}.json") as f:
                ranks.append(json.load(f))
        print(f"[multi] {label}: {MULTI_RANKS} ranks in {wall:.3f} s of wall "
              "(process start, torch import, process group, every command)")
        if outs[1][0]:
            fail(f"{label}: rank 1 wrote to stdout: {outs[1][0][:200]!r}")
        totals = {}
        for r, info in enumerate(ranks):
            if info["rank"] != r or info["world_size"] != MULTI_RANKS:
                fail(f"{label}: rank {r} reports rank {info['rank']} of {info['world_size']}")
            if not all(d.startswith("cuda") for d in info["devices"]):
                fail(f"{label}: rank {r} counted on {info['devices']}")
            print(f"[multi] {label}: rank {r} on {', '.join(info['devices'])}, device "
                  f"collectives on {info['backend']}")
            for (what, _, body, wall_one), res in zip(runs, info["commands"]):
                got = table(res["out"])[0]
                if r == 0 and got != body:
                    fail(f"{label}: {what} TSV of rank 0 differs from the one-process run")
                if r > 0 and res["out"]:
                    fail(f"{label}: rank {r} wrote output for {what}")
                launched = {k: v for k, v in res["launches"].items() if v}
                for k, v in launched.items():
                    totals[k] = totals.get(k, 0) + v
                for name, least in MULTI_LEAST.get(what, {}).items():
                    if res["launches"][name] < least * len(info["devices"]):
                        fail(f"{label}: {what} on rank {r} launched {name} "
                             f"{res['launches'][name]} times on {len(info['devices'])} shards")
                share = (f"{res['payload'][0] / res['payload'][1]:.4f} of "
                         f"{res['payload'][1]} path payload bytes" if res["payload"] else "n/a")
                one = f" (one process, phases 3-4: {wall_one:.3f} s)" if wall_one else ""
                print(f"[multi] {label}: rank {r} {what}: {res['wall']:.3f} s{one}; tokenized "
                      f"{share}; phases (s) " + ", ".join(
                          f"{n} {x:.3f}" for n, x in res["phases"].items())
                      + f"; launches {launched}")
        if totals.get("pt_fused_hist", 0) < MULTI_RANKS:
            fail(f"{label}: pt_fused_hist was not launched on every rank")
        print(f"[multi] {label}: rank 0 TSVs == the one-process TSVs; rank 1 wrote "
              f"nothing; launches over both ranks {totals}")
        if first_launches is None:
            first_launches = totals
    print(f"[multi] phase 8 took {time.perf_counter() - t_phase:.1f} s")
    return first_launches


# phase 9: the front end of the main path, at bench.py's four stages

# the many-slab graph: 1024 paths, which -H makes 1024 groups in 32 slabs
# (assembly graphs grouped by path), about the main graph's bytes
MANY_SLABS = (80_000, 1024)
# growth thresholds of each graph's commands. The many-slab graph leaves
# out the (quorum 0.5, coverage 1) pair: at 1024 groups its growth
# recurrence takes seconds a count type on the host (ROADMAP item 6) and
# would drown the front end that this phase measures.
FRONT_QL = {
    "main": ["-q", "0,0.5,1.0", "-l", "0,1,2"],
    "many-slab": ["-q", "0,1.0", "-l", "0,2"],
}
FRONT_RUNS = 5  # warm runs of each command, taken in turns
SCOPES = ("index", "abaci_by_total", "hists", "growth")


class FrontLog(logging.Handler):
    """The front end's log lines: the gz route, each streamed build, and
    every warning."""

    PREFIXES = ("gz ingest:", "streamed membership build:")

    def __init__(self):
        super().__init__()
        self.lines = []
        self.warnings = []

    def emit(self, record):
        if str(record.msg).startswith(self.PREFIXES):
            self.lines.append(record.getMessage())
        if record.levelno >= logging.WARNING:
            self.warnings.append(record.getMessage())


def drive_logged(argv):
    """drive(argv, "cuda") with every kernel's launches counted from 0:
    (stdout, phases, wall, launches of every kernel, FrontLog)."""
    from panacus_torch.ops import kernels

    handler = FrontLog()
    logging.getLogger("panacus").addHandler(handler)
    kernels.reset_launches()
    try:
        out, phases, wall = drive(argv, "cuda")
    finally:
        logging.getLogger("panacus").removeHandler(handler)
    return out, phases, wall, dict(kernels.launches), handler


def union(intervals):
    """Merged, sorted (start, end) intervals."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def busy_in(busy, a, b):
    """(device-busy us inside [a, b], longest idle gap us inside it)."""
    t, gap, cur = 0.0, 0.0, a
    for x, y in busy:
        if y <= a or x >= b:
            continue
        x, y = max(x, a), min(y, b)
        gap = max(gap, x - cur)
        t += y - x
        cur = y
    return t, max(gap, b - cur)


def trace_scopes(trace_path: str):
    """From a chrome trace of one CLI run: each phase scope (runtime's
    phase_timer) with its wall, the device's busy time inside it and its
    longest idle gap (us); the build scopes of the streamed build (on the
    host's route `build.tokenize` and `build.pack`, one a slab; on the
    device route `build.stage`, then `build.parse` and `build.wait` a
    pass): their number and summed wall (us); the device's busy time in
    all."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    busy = union(
        (e["ts"], e["ts"] + e["dur"])
        for e in events
        if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")
    )
    notes = [e for e in events if e.get("cat") == "user_annotation"]
    phases = {}
    for e in notes:
        if e["name"] in SCOPES:
            t, gap = busy_in(busy, e["ts"], e["ts"] + e["dur"])
            w, b, g = phases.get(e["name"], (0.0, 0.0, 0.0))
            phases[e["name"]] = (w + e["dur"], b + t, max(g, gap))
    kinds = ("tokenize", "pack", "stage", "parse", "wait")
    slabs = {k: [e["dur"] for e in notes if e["name"] == "build." + k] for k in kinds}
    return {
        "phases": phases,
        "n_slab_scopes": {k: len(v) for k, v in slabs.items()},
        "slab_us": {k: sum(v) for k, v in slabs.items()},
        "busy_us": sum(b - a for a, b in busy),
    }


def print_scopes(tag: str, scopes, wall: float) -> None:
    for name in SCOPES:
        if name in scopes["phases"]:
            w, b, g = scopes["phases"][name]
            print(
                f"[{tag}]   scope {name}: {w / 1e3:.4f} ms, device busy "
                f"{b / 1e3:.4f} ms ({100 * b / max(w, 1e-9):.3f}%), longest idle gap "
                f"{g / 1e3:.4f} ms"
            )
    print(
        f"[{tag}]   build scopes {scopes['n_slab_scopes']}, summed "
        + ", ".join(f"{k} {v / 1e3:.4f} ms" for k, v in scopes["slab_us"].items())
    )
    print(
        f"[{tag}]   device busy {scopes['busy_us'] / 1e3:.4f} ms of a {wall:.4f} s run: "
        f"{100 * scopes['busy_us'] / 1e6 / wall:.4f}% busy"
    )


def phase_front_end():
    """histgrowth at bench.py's stages all / node / edge / gz_node (the
    node count of a single-member level-1 gzip of the graph) on cuda:0, on
    the main graph (90 groups, 3 slabs) and on a many-slab graph (1024
    groups, 32 slabs). Every TSV must equal the port's CPU run of the same
    command and every run must launch pt_fused_hist through the streamed
    build. Then one warm `-c all` under torch.profiler. Returns the
    launches of each kernel in the phase."""
    from panacus_torch import testgraphs as tg
    from panacus_torch.ops import kernels

    t_phase = time.perf_counter()
    graphs = {"main": bench_graph()}
    t0 = time.perf_counter()
    graphs["many-slab"] = tg.cached_graph(WORK, *MANY_SLABS)
    if time.perf_counter() - t0 > 1:
        print(f"[front] generated {graphs['many-slab']} in {time.perf_counter() - t0:.1f} s")
    total = {name: 0 for name in kernels.launches}
    for label, gfa in graphs.items():
        gz = gfa + ".gz"
        if not os.path.exists(gz):
            t0 = time.perf_counter()
            tg.write_gzip(gfa, gz)
            print(
                f"[front] {label}: wrote one level-1 gzip member, "
                f"{os.path.getsize(gz) / 1e6:.1f} MB, in {time.perf_counter() - t0:.1f} s"
            )
        mb = os.path.getsize(gfa) / 1e6
        n_groups = MANY_SLABS[1] if label == "many-slab" else tg.N_PATHS
        base = ["histgrowth", "-H"] + FRONT_QL[label]
        cmds = {
            "all": base + ["-c", "all", gfa],
            "node": base + ["-c", "node", gfa],
            "edge": base + ["-c", "edge", gfa],
            "gz_node": base + ["-c", "node", gz],
        }
        refs = {}
        for name, argv in cmds.items():
            body, rows = table(drive(argv, "cpu")[0])
            if len(rows) != 4 + n_groups + 1:
                fail(f"{label} {name}: CPU TSV has {len(rows)} rows, not {4 + n_groups + 1}")
            refs[name] = body
        runs = {}
        for _ in range(FRONT_RUNS):
            for name, argv in cmds.items():
                out, phases, wall, launches, log_ = drive_logged(argv)
                what = f"{label} histgrowth {name}"
                if table(out)[0] != refs[name]:
                    fail(f"{what}: TSV on cuda differs from the port's run on cpu")
                if launches["pt_fused_hist"] < 1:
                    fail(f"{what} did not launch pt_fused_hist")
                want = {"pt_parse_pack": int(name != "edge"),
                        "pt_parse_pack_edges": int(name in ("all", "edge"))}
                if {k: launches[k] for k in want} != want:
                    fail(f"{what} launched {({k: launches[k] for k in want})}, not {want}")
                if not any(l.startswith("streamed membership build:") for l in log_.lines):
                    fail(f"{what} did not take the streamed build")
                if log_.warnings:
                    fail(f"{what} logged warnings: {log_.warnings}")
                for k, v in launches.items():
                    total[k] += v
                runs.setdefault(name, []).append((wall, phases, launches, log_))
        print(
            f"[front] {label} graph: {mb:.1f} MB of GFA, {n_groups} groups "
            f"({-(-n_groups // 32)} slabs), {' '.join(base[2:])}; every TSV == cpu"
        )
        for name, rs in runs.items():
            walls = [w for w, _, _, _ in rs]
            med = statistics.median(walls)
            idx = statistics.median(p.get("index", 0.0) for _, p, _, _ in rs)
            build = statistics.median(p.get("abaci_by_total", 0.0) for _, p, _, _ in rs)
            print(
                f"[front]   {name:7s}: median wall {med:.4f} s "
                f"({mb / med:.1f} MB/s), index {idx:.4f} s, abaci_by_total {build:.4f} s, "
                f"pt_fused_hist {rs[0][2]['pt_fused_hist']}, pt_parse_pack "
                f"{rs[0][2]['pt_parse_pack']} a run; walls "
                + " ".join(f"{w:.4f}" for w in walls)
            )
        route = [l for l in runs["gz_node"][0][3].lines if l.startswith("gz ingest:")]
        print(f"[front]   gz route: {route}")

    # one warm -c all under the profiler
    from torch.profiler import ProfilerActivity, profile

    argv = ["histgrowth", "-H"] + FRONT_QL["main"] + ["-c", "all", graphs["main"]]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        out, phases, wall, launches, log_ = drive_logged(argv)
    trace = os.path.join(WORK, "front_end_trace.json")
    prof.export_chrome_trace(trace)
    for k, v in launches.items():
        total[k] += v
    scopes = trace_scopes(trace)
    missing = [n for n in SCOPES if n not in scopes["phases"]]
    print(
        f"[front] traced main histgrowth -c all: wall {wall:.4f} s; phase scopes found "
        f"{sorted(scopes['phases'])}, missing {missing}"
    )
    print_scopes("front", scopes, wall)
    # the device route: one stage, a parse and a wait for the node rows and
    # for the edge rows, no slab of the host's tokenizer
    want = {"tokenize": 0, "pack": 0, "stage": 1, "parse": 2, "wait": 2}
    if missing or scopes["n_slab_scopes"] != want:
        fail(f"the trace lacks phase scopes or has other build scopes than {want}: "
             f"{scopes['phases'].keys()}, {scopes['n_slab_scopes']}")
    print(f"[front] launches in phase 9: {total}")
    print(f"[front] phase 9 took {time.perf_counter() - t_phase:.1f} s")
    return total


# phase 10: panacus_torch.bench in process, on the graph of phase 3

BENCH_KERNELS = ("pt_fused_hist", "pt_ordered_growth", "pt_similarity", "pt_xor_fold")
# a kernel cannot read faster than the raw read of the same bytes in the same
# run: a reading above this is a fault of the timing
FRAC_OF_READ_MAX = 1.05


def phase_bench():
    """panacus_torch.bench.run on the graph of phase 3, on the default devices
    (every visible GPU), with every kernel's launches counted from 0. Fails
    unless all four stages took the streamed build, the `all` stage's node,
    bp and edge hists equal the hist columns of `histgrowth -a -c all -H` on
    cuda (and their growth its floored growth columns), the group stages
    were verified, pt_fused_hist, pt_ordered_growth, pt_similarity and
    pt_xor_fold each ran, and device_frac_of_read <= FRAC_OF_READ_MAX.
    Returns the launches of each kernel in the bench's run."""
    from panacus_torch import bench, runtime
    from panacus_torch.ops import kernels
    from panacus_torch.utils import CountType, ThresholdContainer

    t_phase = time.perf_counter()
    os.environ["PANACUS_TORCH_DEVICE"] = "cuda"
    gfa = bench_graph()
    kernels.reset_launches()
    out, hists = bench.run(gfa, runtime.resolve_devices())
    launches = dict(kernels.launches)
    print(f"[bench] json: {json.dumps(out)}")
    print(f"[bench] launches: {launches}")
    if sorted(out["routes"]) != sorted(s[0] for s in bench.STAGES) or set(
        out["routes"].values()
    ) != {"streamed"}:
        fail(f"a bench stage did not take the streamed build: {out['routes']}")
    if out["group_stages"]["verified"] is not True:
        fail("the bench's group stages were not verified")
    for name in BENCH_KERNELS:
        if launches[name] < 1:
            fail(f"the bench did not launch {name}")
    if not out["device_frac_of_read"] <= FRAC_OF_READ_MAX:
        fail(f"device_frac_of_read {out['device_frac_of_read']} > {FRAC_OF_READ_MAX}")

    argv = ["histgrowth", "-a", "-c", "all", "-H", "-q", bench.QUORUM, "-l",
            bench.COVERAGE, gfa]
    _, rows = table(drive(argv, "cuda")[0])
    order = (CountType.NODE, CountType.BP, CountType.EDGE)
    got = [[int(x) for x in r[1:4]] for r in rows[4:]]
    if got != [list(r) for r in zip(*(hists[ct].coverage for ct in order))]:
        fail("the bench's hists differ from the hist columns of histgrowth -a on cuda")
    tc = ThresholdContainer.parse_params(bench.QUORUM, bench.COVERAGE)
    cols = [g for ct in order for g in hists[ct].calc_all_growths(tc)]
    for i, r in enumerate(rows[5:], start=1):
        if [float(x) for x in r[4:]] != [math.floor(g[i]) for g in cols]:
            fail(f"the bench's growth differs from histgrowth -a on cuda in row {i}")
    print("[bench] routes all streamed; hists and growth == histgrowth -a -c all -H on "
          f"cuda; group stages verified; launches of {', '.join(BENCH_KERNELS)} >= 1; "
          f"device_frac_of_read {out['device_frac_of_read']:.4f} <= {FRAC_OF_READ_MAX}")
    print(f"[bench] phase 10 took {time.perf_counter() - t_phase:.1f} s")
    return launches


def main() -> int:
    if not os.path.isdir(os.path.join(ROOT, "panacus_torch")):
        fail("panacus_torch not found: run from the root of a checkout")
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device")
    sys.path.insert(0, ROOT)
    dev = torch.device("cuda", 0)
    smi = phase_env()
    res = phase_kernels(dev)
    res.update(phase_group_kernels(dev))
    single = {}  # the one-card runs that phase 7 repeats on shards
    launches, edge_hist, routes = phase_main_path(dev, single)
    group_launches, ordered_edge, similarity_node, parse_node = phase_group_path(dev, single)
    for name in ("pt_ordered_growth", "pt_similarity", "pt_parse_pack"):
        launches[name] = group_launches[name]
    phase_path_kernels(dev, edge_hist, ordered_edge, similarity_node, parse_node, routes, res)
    del edge_hist, ordered_edge, similarity_node, parse_node, routes
    probe_res, probe_launches, read_bps = phase_probe(dev, smi)
    res.update(probe_res)
    launches.update(probe_launches)
    report_launches = phase_report_path(dev)
    phase_sharded(single)
    multi_launches = phase_multiprocess(single)
    del single
    front_launches = phase_front_end()
    bench_launches = phase_bench()
    for name, r in res.items():
        r["report_launches"] = report_launches[name]
        r["multiprocess_launches"] = multi_launches.get(name, 0)
        r["front_end_launches"] = front_launches[name]
        r["bench_launches"] = bench_launches[name]
    for name, r in res.items():
        r["share_of_read"] = r.pop("_bytes") / (r["ms"] / 1e3) / read_bps
        print(f"[probe] {name}: {r['share_of_read']:.4f} of the measured read, "
              f"{r['bound_ms'] / r['ms']:.4f} of its datasheet bound")
    if any(m == "jax" or m.startswith("jax.") for m in sys.modules):
        fail("jax was imported")
    print(
        json.dumps(
            {
                "kernels": [
                    {
                        "name": name,
                        "route": "cuda",
                        "source": SOURCE[name],
                        "replaces": REPLACES[name],
                        "launches": launches[name],
                        **r,
                    }
                    for name, r in res.items()
                ]
            }
        )
    )
    print(
        json.dumps(
            {
                "ok": True,
                "device": {
                    "platform": "gpu",
                    "kind": torch.cuda.get_device_name(0),
                    "count": torch.cuda.device_count(),
                },
            }
        )
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
