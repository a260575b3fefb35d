"""Synthetic GFA graphs and numpy oracles for the port's smoke runs and tests.

The port's copies of the JAX package's graph generators and oracles, so
that `chip_smoke.py` needs nothing outside panacus_torch:

- `make_graph` with GEN_VERSION, N_NODES and N_PATHS: bench.py's
  pggb-like graph (HPRC chr22 pggb scale at the default 900,000 nodes and
  90 paths; PANACUS_BENCH_NODES / PANACUS_BENCH_PATHS cut it). The bytes
  equal bench.make_graph's at the same size, so measurements on either
  graph compare.
- `_write_dryrun_gfa`, `_oracle` and `_oracle_ordered`: __graft_entry__.py's
  600-node graph (DRYRUN_NODES; DRYRUN_SAMPLES samples x 2 haplotypes) and
  its independent numpy recomputations of membership, hists and ordered
  growth.

numpy only.
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np

N_NODES = int(os.environ.get("PANACUS_BENCH_NODES", 900_000))
N_PATHS = int(os.environ.get("PANACUS_BENCH_PATHS", 90))
MAX_GAP = 4
SEED = 7
GEN_VERSION = 5  # bench.py's generator version; bump both together

DRYRUN_NODES = 600
DRYRUN_SAMPLES = 4


def make_graph(path: str) -> None:
    """Deterministic pggb-like graph at chr22-pggb scale by default
    (~340 MB; the reference baseline graph is 402 MB): path lines dominate
    the bytes, integer node names, short segments. N_PATHS / 2 samples x 2
    haplotypes; haplotype 0 is a P line (PanSN name), haplotype 1 a W line
    — HPRC graphs carry both spellings. Each path walks the node line with
    gaps in 1..MAX_GAP and every (u, u+g) pair is declared as an L line, so
    paths are edge-consistent by construction."""
    rng = np.random.default_rng(SEED)
    t0 = time.time()
    lens = rng.integers(1, 17, size=N_NODES)
    seq_pool = ("ACGT" * 5)[:16]
    n_edges = sum(N_NODES - g for g in range(1, MAX_GAP + 1))
    gap_pool = rng.integers(
        1, MAX_GAP + 1, size=N_NODES + N_PATHS, dtype=np.int64
    )

    def join_lines(parts, sep=b"\n"):
        return sep.join(parts.tolist()) + sep

    with open(path, "wb") as f:
        f.write(b"H\tVN:Z:1.0\n")
        names = np.arange(1, N_NODES + 1).astype("S12")
        seqs = np.array(
            [seq_pool[:k].encode() for k in range(1, 17)], dtype="S16"
        )[lens - 1]
        s_lines = np.char.add(np.char.add(b"S\t", names), b"\t")
        f.write(join_lines(np.char.add(s_lines, seqs)))
        del s_lines, seqs
        for g in range(1, MAX_GAP + 1):
            eu = names[: N_NODES - g]
            ev = names[g:]
            l_lines = np.char.add(
                np.char.add(np.char.add(b"L\t", eu), b"\t+\t"),
                np.char.add(ev, b"\t+\t0M"),
            )
            f.write(join_lines(l_lines))
            del l_lines
        for p in range(N_PATHS):
            sample, hap = p // 2, p % 2
            visits = 1 + np.cumsum(gap_pool[p : p + N_NODES])
            visits = visits[: np.searchsorted(visits, N_NODES, side="right")]
            if hap == 0:
                toks = np.char.add(visits.astype("S12"), b"+")
                f.write(f"P\ts{sample}#0#chr1\t".encode())
                f.write(join_lines(toks, sep=b",")[:-1])
                f.write(b"\t*\n")
            else:
                toks = np.char.add(b">", visits.astype("S12"))
                f.write(f"W\ts{sample}\t1\tchr1\t*\t*\t".encode())
                f.write(b"".join(toks.tolist()))
                f.write(b"\n")
    sys.stderr.write(
        f"[testgraphs] generated {path}: {os.path.getsize(path) / 1e6:.1f} MB, "
        f"{n_edges} edges, in {time.time() - t0:.1f}s\n"
    )


def cached_graph(directory: str) -> str:
    """The path of make_graph's graph at the current N_NODES and N_PATHS in
    `directory`, generated there once and reused (the file name carries the
    generator version and the size)."""
    os.makedirs(directory, exist_ok=True)
    gfa = os.path.join(directory, f"bench_v{GEN_VERSION}_{N_NODES}_{N_PATHS}.gfa")
    if not os.path.exists(gfa):
        make_graph(gfa + ".tmp")
        os.replace(gfa + ".tmp", gfa)
    return gfa


def _write_dryrun_gfa(path: str):
    """Deterministic small GFA: DRYRUN_NODES integer-named segments, 8 paths
    (DRYRUN_SAMPLES samples x 2 haplotypes; haplotype 0 as a PanSN P line,
    haplotype 1 as a W line), L lines for every consecutive visit pair.
    Returns the oracle inputs: per-path sorted node visits, node lengths
    and the sorted edge list."""
    rng = np.random.default_rng(42)
    lens = rng.integers(1, 17, size=DRYRUN_NODES + 1)  # 1-based
    lens[0] = 0
    visits_per_path = []
    edge_set = set()
    lines = ["H\tVN:Z:1.0"]
    for v in range(1, DRYRUN_NODES + 1):
        lines.append(f"S\t{v}\t{'A' * int(lens[v])}")
    for p in range(2 * DRYRUN_SAMPLES):
        k = int(rng.integers(DRYRUN_NODES // 3, DRYRUN_NODES))
        visits = np.sort(
            rng.choice(np.arange(1, DRYRUN_NODES + 1), size=k, replace=False)
        )
        visits_per_path.append(visits)
        for a, b in zip(visits[:-1], visits[1:]):
            edge_set.add((int(a), int(b)))
    for a, b in sorted(edge_set):
        lines.append(f"L\t{a}\t+\t{b}\t+\t0M")
    for p, visits in enumerate(visits_per_path):
        sample, hap = p // 2, p % 2
        if hap == 0:
            toks = ",".join(f"{v}+" for v in visits)
            lines.append(f"P\ts{sample}#0#chr1\t{toks}\t*")
        else:
            toks = "".join(f">{v}" for v in visits)
            lines.append(f"W\ts{sample}\t1\tchr1\t0\t100\t{toks}")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return visits_per_path, lens, sorted(edge_set)


def _oracle(visits_per_path, lens, edges):
    """Independent numpy recomputation of membership/coverage per group
    (grouping by sample: haplotypes 0+1 of sample s share group s).
    Returns (node membership [groups, nodes + 1], node, bp and edge hists)."""
    n_groups = DRYRUN_SAMPLES
    node_mem = np.zeros((n_groups, DRYRUN_NODES + 1), dtype=bool)
    edge_idx = {e: i for i, e in enumerate(edges)}
    edge_mem = np.zeros((n_groups, len(edges)), dtype=bool)
    for p, visits in enumerate(visits_per_path):
        g = p // 2
        node_mem[g, visits] = True
        for a, b in zip(visits[:-1], visits[1:]):
            edge_mem[g, edge_idx[(int(a), int(b))]] = True
    node_cov = node_mem.sum(axis=0)[1:]
    edge_cov = edge_mem.sum(axis=0)
    node_hist = np.bincount(node_cov, minlength=n_groups + 1)
    bp_hist = np.bincount(
        node_cov, weights=lens[1:].astype(np.float64), minlength=n_groups + 1
    ).astype(np.int64)
    edge_hist = np.bincount(edge_cov, minlength=n_groups + 1)
    return node_mem, node_hist, bp_hist, edge_hist


def _oracle_ordered(node_mem, weights, c_min, quorum):
    """Ordered growth oracle (reference semantics, abacus.rs:988-1032):
    at group position j an item counts iff its running #present-groups
    meets ceil((last-present-group+1)*quorum) and total coverage >= c."""
    n_groups, n = node_mem.shape
    total = node_mem.sum(axis=0)
    res = np.zeros(n_groups, dtype=np.int64)
    for j in range(n_groups):
        pre = node_mem[: j + 1]
        cum = pre.sum(axis=0)
        lp = np.full(n, -1)
        for g in range(j + 1):
            lp[pre[g]] = g
        thr = np.where(lp >= 0, np.ceil((lp + 1) * quorum), n_groups + 9)
        ok = (cum >= np.maximum(thr, 1)) & (total >= c_min)
        res[j] = int(weights[ok].sum())
    return res
