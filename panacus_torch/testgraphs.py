"""Synthetic GFA graphs and numpy oracles for the port's smoke runs and tests.

The port's copies of the JAX package's graph generators and oracles, so
that `chip_smoke.py` needs nothing outside panacus_torch:

- `make_graph` with GEN_VERSION, N_NODES and N_PATHS: bench.py's
  pggb-like graph (HPRC chr22 pggb scale at the default 900,000 nodes and
  90 paths; PANACUS_BENCH_NODES / PANACUS_BENCH_PATHS cut it, its
  n_nodes and n_paths arguments give other sizes). The bytes equal
  bench.make_graph's at the same size, so measurements on either graph
  compare. `write_gzip` compresses a graph as bench.py's gz stage does:
  one gzip member at level 1.
- `_write_dryrun_gfa`, `_oracle` and `_oracle_ordered`: __graft_entry__.py's
  600-node graph (DRYRUN_NODES; DRYRUN_SAMPLES samples x 2 haplotypes) and
  its independent numpy recomputations of membership, hists and ordered
  growth.
- `dryrun_multichip`: the counterpart of __graft_entry__.dryrun_multichip,
  the port's broker on that graph with M split over a tuple of devices.

numpy only at import (dryrun_multichip loads the port's broker).
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


def make_graph(path: str, n_nodes: int = None, n_paths: int = None) -> None:
    """Deterministic pggb-like graph at chr22-pggb scale by default
    (~340 MB; the reference baseline graph is 402 MB): path lines dominate
    the bytes, integer node names, short segments. n_paths / 2 samples x 2
    haplotypes; haplotype 0 is a P line (PanSN name), haplotype 1 a W line
    — HPRC graphs carry both spellings. Each path walks the node line with
    gaps in 1..MAX_GAP and every (u, u+g) pair is declared as an L line, so
    paths are edge-consistent by construction. n_nodes and n_paths default
    to N_NODES and N_PATHS (then the bytes are bench.make_graph's)."""
    n_nodes = N_NODES if n_nodes is None else int(n_nodes)
    n_paths = N_PATHS if n_paths is None else int(n_paths)
    rng = np.random.default_rng(SEED)
    t0 = time.time()
    lens = rng.integers(1, 17, size=n_nodes)
    seq_pool = ("ACGT" * 5)[:16]
    n_edges = sum(n_nodes - g for g in range(1, MAX_GAP + 1))
    gap_pool = rng.integers(
        1, MAX_GAP + 1, size=n_nodes + n_paths, dtype=np.int64
    )

    def join_lines(parts, sep=b"\n"):
        return sep.join(parts.tolist()) + sep

    with open(path, "wb") as f:
        f.write(b"H\tVN:Z:1.0\n")
        names = np.arange(1, n_nodes + 1).astype("S12")
        seqs = np.array(
            [seq_pool[:k].encode() for k in range(1, 17)], dtype="S16"
        )[lens - 1]
        s_lines = np.char.add(np.char.add(b"S\t", names), b"\t")
        f.write(join_lines(np.char.add(s_lines, seqs)))
        del s_lines, seqs
        for g in range(1, MAX_GAP + 1):
            eu = names[: n_nodes - g]
            ev = names[g:]
            l_lines = np.char.add(
                np.char.add(np.char.add(b"L\t", eu), b"\t+\t"),
                np.char.add(ev, b"\t+\t0M"),
            )
            f.write(join_lines(l_lines))
            del l_lines
        for p in range(n_paths):
            sample, hap = p // 2, p % 2
            visits = 1 + np.cumsum(gap_pool[p : p + n_nodes])
            visits = visits[: np.searchsorted(visits, n_nodes, side="right")]
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


def cached_graph(directory: str, n_nodes: int = None, n_paths: int = None) -> str:
    """The path of make_graph's graph at n_nodes and n_paths (by default
    N_NODES and N_PATHS) in `directory`, generated there once and reused
    (the file name carries the generator version and the size)."""
    n_nodes = N_NODES if n_nodes is None else n_nodes
    n_paths = N_PATHS if n_paths is None else n_paths
    os.makedirs(directory, exist_ok=True)
    gfa = os.path.join(directory, f"bench_v{GEN_VERSION}_{n_nodes}_{n_paths}.gfa")
    if not os.path.exists(gfa):
        make_graph(gfa + ".tmp", n_nodes, n_paths)
        os.replace(gfa + ".tmp", gfa)
    return gfa


def write_gzip(src: str, dst: str, chunk: int = 16 << 20) -> str:
    """Write `src` to `dst` as ONE gzip member at level 1, as bench.py's
    gz stage compresses its graph (`gzip -1`), through zlib in chunks.
    Returns dst."""
    import zlib

    comp = zlib.compressobj(1, zlib.DEFLATED, 31)  # wbits 31: a gzip member
    with open(src, "rb") as f, open(dst + ".tmp", "wb") as out:
        while True:
            block = f.read(chunk)
            if not block:
                break
            out.write(comp.compress(block))
        out.write(comp.flush())
    os.replace(dst + ".tmp", dst)
    return dst


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


def dryrun_multichip(devices) -> str:
    """The port's counting path, GraphBroker on the dryrun GFA with every
    engine split over `devices` (a tuple, one item shard each; e.g. every
    visible GPU, or one device named several times), checked against the
    numpy oracles (node, bp and edge hists, the m = n union growth, ordered
    growth at three thresholds, the similarity intersections) and against
    the same broker, and the same engine ops on the same M, on the first
    device alone. A subset + exclude BED run (the classic itemizer's
    build) is held against its single-device run too. Raises
    AssertionError on a mismatch; returns a one-line summary."""
    import tempfile

    from .broker import GraphBroker, GraphState, Req
    from .config import Grouping
    from .ops.engine import CountingEngine, as_devices
    from .utils import CountType, Threshold, ThresholdContainer

    devices = as_devices(devices)
    with tempfile.TemporaryDirectory() as td:
        gfa = os.path.join(td, "dryrun.gfa")
        visits, lens, edges = _write_dryrun_gfa(gfa)
        node_mem, node_hist, bp_hist, edge_hist = _oracle(visits, lens, edges)
        reqs = {
            Req.graph(gfa), Req.NODE, Req.BP, Req.EDGE, Req.HIST,
            Req.abacus_by_group(CountType.NODE),
        }
        gb = GraphBroker(devices)
        gb.change_graph_state(
            GraphState(graph=gfa, name="dryrun", grouping=Grouping.sample()),
            reqs,
            nice=False,
        )
        eng = gb.get_abacus_by_total(CountType.NODE).engine
        assert eng.devices == devices and len(eng.shards) == len(devices), (
            "the broker's engine is not split over the devices"
        )
        assert all(m.device == d for m, d in zip(eng.shards, devices))

        hists = gb.get_hists()
        for ct, want in (
            (CountType.NODE, node_hist),
            (CountType.BP, bp_hist),
            (CountType.EDGE, edge_hist),
        ):
            got = np.asarray(hists[ct].coverage)
            assert np.array_equal(got, want), (ct, got, want)
        tc = ThresholdContainer.parse_params(quorum="0", coverage="1")
        growth = hists[CountType.NODE].calc_all_growths(tc)[0]
        assert abs(growth[-1] - float(node_hist[1:].sum())) < 1e-6

        ab = gb.get_abacus_by_group()
        w1 = np.ones(DRYRUN_NODES + 1, dtype=np.int64)
        w1[0] = 0
        for c, q in [(1, 0.0), (2, 0.0), (1, 0.5)]:
            got = np.asarray(ab.calc_growth(Threshold.absolute(c), Threshold.rel(q)))
            want = _oracle_ordered(node_mem, w1, c, q).astype(np.float64)
            assert np.array_equal(got, want), (c, q, got, want)
        inter, _ = ab.similarity_matrix()
        want_inter = node_mem.astype(np.int64) @ node_mem.astype(np.int64).T
        assert np.array_equal(inter.astype(np.int64), want_inter)

        # the same ops on the same M, on the first device alone
        M = np.concatenate([m.cpu().numpy() for m in eng.shards], axis=1)
        e1 = CountingEngine.from_host_state(
            M.view(np.uint32), eng.n_items, eng.n_groups, devices[:1]
        )
        assert np.array_equal(eng.hist(None), e1.hist(None))
        og = eng.ordered_growth(w1, 0.5, 1)
        assert np.array_equal(og, e1.ordered_growth(w1, 0.5, 1))
        assert np.array_equal(eng.similarity(w1), e1.similarity(w1))
        assert np.array_equal(eng.coverage(), e1.coverage())

        # subset + exclude: the classic itemizer's build, on the shards and
        # on the first device alone
        p_bp = [int(lens[v].sum()) for v in visits[0::2]]
        subset = os.path.join(td, "subset.bed")
        exclude = os.path.join(td, "exclude.bed")
        with open(subset, "w") as f:
            f.write(
                f"s0#0#chr1\t3\t{p_bp[0] - 7}\ns1#0#chr1\t0\t{p_bp[1]}\n"
                "s2#0#chr1\t0\t10\ns2#0#chr1\t20\t50\ns3#0#chr1\n"
            )
        with open(exclude, "w") as f:
            f.write("s1#0#chr1\t5\t9\n")
        masked = {}
        for devs in (devices, devices[:1]):
            gbm = GraphBroker(devs)
            gbm.change_graph_state(
                GraphState(graph=gfa, name="dryrun-masked", subset=subset,
                           exclude=exclude, grouping=Grouping.sample()),
                {Req.graph(gfa), Req.NODE, Req.BP, Req.HIST},
                nice=False,
            )
            mh = gbm.get_hists()
            masked[len(devs)] = [
                np.asarray(mh[ct].coverage) for ct in (CountType.NODE, CountType.BP)
            ]
        m_node, m_bp = masked[len(devices)]
        assert all(np.array_equal(a, b) for a, b in zip(masked[len(devices)], masked[1]))
        assert not np.array_equal(m_node, node_hist), "the mask did not engage"

    distinct = len(set(devices))
    return (
        f"dryrun_multichip ok: {len(devices)} shards on {distinct} distinct "
        f"device(s) ({', '.join(map(str, devices))}), broker on the dryrun GFA "
        f"({DRYRUN_NODES} nodes, {len(edges)} edges, {2 * DRYRUN_SAMPLES} paths): "
        f"node hist={node_hist.tolist()}, bp hist={bp_hist.tolist()}, "
        f"edge hist={edge_hist.tolist()}, growth[-1]={growth[-1]:.1f}, "
        f"ordered[-1]={og[-1]}, sim trace={np.trace(inter):.0f}; masked node "
        f"hist={m_node.tolist()} bp hist={m_bp.tolist()} (oracle-exact, "
        f"sharded == single-device)"
    )
