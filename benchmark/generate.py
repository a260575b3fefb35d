"""Seeded synthetic pangenome graphs in the shape a configuration file states.

    python3 benchmark/generate.py CONFIG_JSON SEED OUT_DIR

A configuration that names a `"writer"` is written by writers/<writer>.py,
whose `write_graph(cfg, seed, path, threads=0)` writes the graph and returns
its facts as this module's does (it may import benchmark.generate for the
helpers). Without the key, this module's own writer, below, writes it.

Integer node names 1..n_nodes in S-line order. Each node belongs to one of
the configuration's `node_classes`, drawn with its `share`; a class gives
the node's segment length (uniform over `segment_bp` [lo, hi], random ACGT)
and its frequency: 1 for "all", else a draw from Beta(a, b). Every
haplotype holds each node with the node's frequency, independently, and
walks the nodes it holds forward as one PanSN P line
(`sample#hap#seqid`); a node that no haplotype drew goes to one haplotype
drawn at random, so every node lies on a path. The L lines are exactly the
steps the paths take (`u + v + 0M`, sorted), as in a graph induced from its
sequences. The file is S lines, L lines, then the P lines sample by sample.

Beside GRAPH.gfa the run writes GRAPH.gfa.json (counts, samples, path
names). A graph of the same configuration file and seed already in OUT_DIR
is reused; of the others of that configuration the newest KEEP stay, so
the runs of one set of seeds generate each graph once. Prints the graph's
path. numpy only.
"""

from __future__ import annotations

import hashlib
import importlib.util
import json
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from typing import List, Tuple

import numpy as np

GEN_VERSION = 3  # bump when the bytes for a given configuration and seed change
KEEP = 8  # graphs of a configuration kept in OUT_DIR
HERE = os.path.dirname(os.path.abspath(__file__))
WRITERS = os.path.join(HERE, "writers")

_BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


def rows(n: int, parts) -> np.ndarray:
    """uint8 bytes of n rows, each the concatenation of `parts` in order: a
    bytes constant, an int64 array of n values >= 0 (decimal), or a pair
    (lengths, flat uint8 bytes) of n variable-length fields. The rows are
    laid out in a fixed-width table, each field in columns of its own at
    its widest, and the padding is dropped at the end."""
    widths = []
    for p in parts:
        if isinstance(p, bytes):
            widths.append(len(p))
        elif isinstance(p, tuple):
            widths.append(int(np.max(p[0], initial=0)))
        else:
            widths.append(len(str(int(np.max(p, initial=0)))))
    table = np.empty((n, sum(widths)), dtype=np.uint8)
    keep = np.ones((n, sum(widths)), dtype=bool)
    at = 0
    for p, w in zip(parts, widths):
        if isinstance(p, bytes):
            table[:, at : at + w] = np.frombuffer(p, dtype=np.uint8)
        elif isinstance(p, tuple):
            mask = np.arange(w) < np.asarray(p[0])[:, None]
            table[:, at : at + w][mask] = p[1]
            keep[:, at : at + w] = mask
        else:
            x = np.asarray(p, dtype=np.uint64)
            for j in range(at + w - 1, at - 1, -1):
                q = x // 10
                table[:, j] = x - q * 10 + 48
                if j < at + w - 1:
                    keep[:, j] = x > 0  # a leading zero is padding
                x = q
        at += w
    return table[keep]


def haplotypes(cfg) -> List[Tuple[str, int, str]]:
    """(sample, hap, seqid) of every haplotype, sample by sample."""
    out = []
    for e in cfg["haplotypes"]:
        names = (
            [e["sample"]]
            if "sample" in e
            else [f"{e['sample_prefix']}{i:05d}" for i in range(e["samples"])]
        )
        out += [(s, int(h), e["seqid"]) for s in names for h in e["haps"]]
    return out


def _nodes(cfg: dict, rng) -> Tuple[np.ndarray, np.ndarray]:
    """(segment lengths, frequencies) of the nodes."""
    n = int(cfg["n_nodes"])
    classes = cfg["node_classes"]
    share = np.array([c["share"] for c in classes], dtype=np.float64)
    kind = rng.choice(len(classes), size=n, p=share / share.sum())
    lens = np.zeros(n, dtype=np.int64)
    freq = np.ones(n, dtype=np.float64)
    for k, c in enumerate(classes):
        at = np.flatnonzero(kind == k)
        lo, hi = c["segment_bp"]
        lens[at] = rng.integers(lo, hi + 1, size=len(at), dtype=np.int64)
        if c["frequency"] != "all":
            a, b = c["frequency"]
            freq[at] = rng.beta(a, b, size=len(at))
    return lens, freq


def _walks(freq: np.ndarray, n_haps: int, rng) -> List[np.ndarray]:
    """The 1-based node names each haplotype walks, in order."""
    n = len(freq)
    held = np.empty((n_haps, n), dtype=bool)
    for h in range(n_haps):
        held[h] = rng.random(n) < freq
    lone = np.flatnonzero(~held.any(axis=0))
    held[rng.integers(0, n_haps, size=len(lone)), lone] = True
    return [np.flatnonzero(row) + 1 for row in held]


def write_graph(cfg: dict, seed: int, path: str, threads: int = 0) -> dict:
    """Write the configuration's graph for `seed` to `path`; returns its
    facts. The draws are made in one order on one thread; the lines are
    formatted on `threads` threads (0: every core)."""
    rng = np.random.default_rng([int(seed), GEN_VERSION])
    n = int(cfg["n_nodes"])
    lens, freq = _nodes(cfg, rng)
    seq = _BASES[rng.integers(0, 4, size=int(lens.sum()), dtype=np.uint8)]
    haps = haplotypes(cfg)
    walks = _walks(freq, len(haps), rng)
    names = np.arange(1, n + 1, dtype=np.int64)
    keys = np.unique(np.concatenate([w[:-1] * (n + 1) + w[1:] for w in walks]))
    path_names = [f"{s}#{h}#{seqid}" for s, h, seqid in haps]

    def p_line(k):
        return b"".join((f"P\t{path_names[k]}\t".encode(),
                         rows(len(walks[k]), [walks[k], b"+,"])[:-1].tobytes(), b"\t*\n"))

    with open(path, "wb") as f, ThreadPoolExecutor(threads or os.cpu_count() or 1) as pool:
        f.write(b"H\tVN:Z:1.0\n")
        f.write(rows(n, [b"S\t", names, b"\t", (lens, seq), b"\n"]).data)
        del seq
        f.write(rows(len(keys), [b"L\t", keys // (n + 1), b"\t+\t", keys % (n + 1), b"\t+\t0M\n"]).data)
        for data in pool.map(p_line, range(len(haps))):
            f.write(data)
        f.flush()
        os.fsync(f.fileno())  # no write-back left for the timed window
    path_bp = [int(lens[w - 1].sum()) for w in walks]
    return {
        "n_nodes": n,
        "n_edges": int(len(keys)),
        "total_bp": int(lens.sum()),
        "path_bp_mean": float(np.mean(path_bp)),
        "path_steps": int(sum(len(w) for w in walks)),
        "samples": list(dict.fromkeys(s for s, *_ in haps)),
        "haplotypes": list(dict.fromkeys(f"{s}#{h}" for s, h, _ in haps)),
        "path_names": path_names,
        "gfa_bytes": os.path.getsize(path),
    }


def writer(cfg: dict):
    """The write_graph of the configuration: its writer's, or this module's."""
    name = cfg.get("writer")
    if name is None:
        return write_graph
    if not isinstance(name, str) or not name.isidentifier():
        raise ValueError(f"no graph writer {name!r}")
    spec = importlib.util.spec_from_file_location(
        f"benchmark_writer_{name}", os.path.join(WRITERS, name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.write_graph


def graph_path(config_path: str, seed: int, out_dir: str) -> str:
    """The cache path of the graph of this configuration file and seed."""
    with open(config_path, "rb") as f:
        key = hashlib.sha256(f.read()).hexdigest()[:12]
    name = os.path.splitext(os.path.basename(config_path))[0]
    return os.path.join(out_dir, f"{name}-v{GEN_VERSION}-{key}-s{int(seed)}.gfa")


def ensure_graph(config_path: str, seed: int, out_dir: str) -> str:
    """Generate (or reuse) the graph and its facts; keep the newest KEEP
    graphs of the configuration."""
    with open(config_path) as f:
        cfg = json.load(f)
    os.makedirs(out_dir, exist_ok=True)
    gfa = graph_path(config_path, seed, out_dir)
    if not os.path.exists(gfa + ".json"):
        t0 = time.perf_counter()
        facts = writer(cfg)(cfg, seed, gfa + ".tmp")
        os.replace(gfa + ".tmp", gfa)
        with open(gfa + ".json", "w") as f:
            json.dump(facts, f)
        sys.stderr.write(
            f"[generate] {gfa}: {facts['gfa_bytes'] / 1e6:.1f} MB, {facts['n_nodes']} nodes, "
            f"{facts['n_edges']} edges, {facts['total_bp']} bp, {facts['path_steps']} steps, "
            f"{facts['path_bp_mean']:.0f} bp a path, {len(facts['path_names'])} paths "
            f"in {time.perf_counter() - t0:.3f} s\n"
        )
    os.utime(gfa + ".json")
    prefix = os.path.splitext(os.path.basename(config_path))[0] + "-v"
    mine = [os.path.join(out_dir, x) for x in os.listdir(out_dir)
            if x.startswith(prefix) and x.endswith(".gfa.json")]
    for old in sorted(mine, key=os.path.getmtime, reverse=True)[KEEP:]:
        for p in (old, old[: -len(".json")]):
            if os.path.exists(p):
                os.remove(p)
    return gfa


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(HERE))  # a writer imports benchmark.generate
    if len(sys.argv) != 4:
        sys.exit(__doc__.split("\n\n")[1])
    print(ensure_graph(sys.argv[1], int(sys.argv[2]), sys.argv[3]))
