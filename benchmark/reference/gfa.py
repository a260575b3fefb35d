"""A plain GFA reader for the reference: items and group memberships.

Reads S, L and P lines of a plain GFA with integer segment names (the
benchmark's generator writes them so) in numpy; a W line raises. Items are
the segments in S-line order and the L lines in file order; an edge
traversed in either direction is the same item. A path's group is its
sample (`-S`), its sample#haplotype (`-H`), or its name; a PanSN P line
`a#b#c` has sample a and haplotype b. numpy only.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List

import numpy as np

_TAB, _NL = 9, 10


def parse_ints(buf: np.ndarray, starts: np.ndarray, ends: np.ndarray) -> np.ndarray:
    """int64 values of the decimal fields buf[starts[i]:ends[i]]."""
    lens = ends - starts
    if len(lens) and (lens.min() < 1 or lens.max() > 18):
        raise ValueError("a numeric field is empty or too long")
    val = np.zeros(len(starts), dtype=np.int64)
    for k in range(int(lens.max(initial=0))):
        m = lens > k
        d = buf[starts[m] + k].astype(np.int64) - 48
        if d.size and (d.min() < 0 or d.max() > 9):
            raise ValueError("a numeric field holds a non-digit")
        val[m] = val[m] * 10 + d
    return val


def _fields(buf: np.ndarray, tabs: np.ndarray, start: int, end: int) -> List[bytes]:
    lo, hi = np.searchsorted(tabs, [start, end])
    cuts = [start, *tabs[lo:hi].tolist(), end]
    return [buf[a + (i > 0) : b].tobytes() for i, (a, b) in enumerate(zip(cuts[:-1], cuts[1:]))]


@dataclass
class Path:
    name: str
    sample: str
    haplotype: str
    nodes: np.ndarray  # item index of each visit
    reverse: np.ndarray  # bool, each visit's orientation


@dataclass
class Graph:
    node_len: np.ndarray  # bp of each segment, S-line order
    edge_keys: np.ndarray  # sorted canonical keys of the L lines
    edge_order: np.ndarray  # the L line (file position) of each sorted key
    paths: List[Path] = field(default_factory=list)

    @property
    def n_nodes(self) -> int:
        return len(self.node_len)

    @property
    def n_edges(self) -> int:
        return len(self.edge_keys)

    def edge_key(self, u, ru, v, rv) -> np.ndarray:
        """The canonical key of u->v (node indices, reverse flags): the
        smaller of the edge's key and its reverse complement's."""
        n2 = 2 * self.n_nodes
        a = (2 * u + ru) * n2 + (2 * v + rv)
        b = (2 * v + (1 - rv)) * n2 + (2 * u + (1 - ru))
        return np.minimum(a, b)

    def path_edges(self, p: Path) -> np.ndarray:
        """Edge item index of each step of the path; a step with no L line
        raises."""
        u, v = p.nodes[:-1], p.nodes[1:]
        ru, rv = p.reverse[:-1].astype(np.int64), p.reverse[1:].astype(np.int64)
        keys = self.edge_key(u, ru, v, rv)
        at = np.searchsorted(self.edge_keys, keys)
        at_c = np.minimum(at, len(self.edge_keys) - 1)
        if len(keys) and not np.array_equal(self.edge_keys[at_c], keys):
            raise ValueError(f"path {p.name} steps over an edge with no L line")
        return self.edge_order[at_c]

    def groups(self, grouping: str) -> Dict[str, List[Path]]:
        """Paths by group, groups in the file order of their first path."""
        key = {
            "sample": lambda p: p.sample,
            "haplotype": lambda p: f"{p.sample}#{p.haplotype}",
            "path": lambda p: p.name,
        }[grouping]
        out: Dict[str, List[Path]] = {}
        for p in self.paths:
            out.setdefault(key(p), []).append(p)
        return out


def read_gfa(path: str) -> Graph:
    buf = np.fromfile(path, dtype=np.uint8)
    if len(buf) == 0 or buf[-1] != _NL:
        buf = np.concatenate((buf, np.array([_NL], dtype=np.uint8)))
    ends = np.flatnonzero(buf == _NL)
    starts = np.concatenate(([0], ends[:-1] + 1))
    keep = ends > starts
    starts, ends = starts[keep], ends[keep]
    kind = buf[starts]
    tabs = np.flatnonzero(buf == _TAB)

    # S lines: name, then the sequence up to the next tab or the line's end
    s_st, s_en = starts[kind == ord("S")], ends[kind == ord("S")]
    name_end = tabs[np.searchsorted(tabs, s_st + 2)]
    names = parse_ints(buf, s_st + 2, name_end)
    seq_st = name_end + 1
    nxt = np.searchsorted(tabs, seq_st)
    seq_en = np.minimum(tabs[np.minimum(nxt, len(tabs) - 1)], s_en)
    seq_en = np.where(nxt < len(tabs), seq_en, s_en)
    if np.any((seq_en - seq_st == 1) & (buf[seq_st] == ord("*"))):
        raise ValueError("a segment without its sequence ('*') is not read here")
    index_of = np.full(int(names.max(initial=0)) + 1, -1, dtype=np.int64)
    if len(np.unique(names)) != len(names):
        raise ValueError("a segment name repeats")
    index_of[names] = np.arange(len(names))
    node_len = seq_en - seq_st

    def node_index(ids):
        if len(ids) and (ids.max() >= len(index_of) or np.any(index_of[ids] < 0)):
            raise ValueError("a path or link names an undeclared segment")
        return index_of[ids]

    # L lines: u, its orientation, v, its orientation
    l_st = starts[kind == ord("L")]
    t = [tabs[np.searchsorted(tabs, l_st) + k] for k in range(5)]
    u = node_index(parse_ints(buf, t[0] + 1, t[1]))
    v = node_index(parse_ints(buf, t[2] + 1, t[3]))
    ru = (buf[t[1] + 1] == ord("-")).astype(np.int64)
    rv = (buf[t[3] + 1] == ord("-")).astype(np.int64)
    g = Graph(node_len, np.zeros(0, dtype=np.int64), np.zeros(0, dtype=np.int64))
    keys = g.edge_key(u, ru, v, rv)
    g.edge_order = np.argsort(keys, kind="stable")
    g.edge_keys = keys[g.edge_order]
    if len(keys) and np.any(g.edge_keys[1:] == g.edge_keys[:-1]):
        raise ValueError("an L line repeats an edge")

    if np.any(kind == ord("W")):
        raise ValueError("the reference reads P lines, not W lines")
    for st, en in zip(starts[kind == ord("P")].tolist(), ends[kind == ord("P")].tolist()):
        f = _fields(buf, tabs, st, en)
        name = f[1].decode()
        parts = name.split("#")
        sample, hap = (parts[0], parts[1]) if len(parts) >= 3 else (name, name)
        lo = st + len(f[0]) + len(f[1]) + 2
        hi = lo + len(f[2])
        seps = lo + np.flatnonzero(buf[lo:hi] == ord(","))
        tok_st = np.concatenate(([lo], seps + 1))
        tok_en = np.concatenate((seps, [hi]))  # each token ends in + or -
        ids = parse_ints(buf, tok_st, tok_en - 1)
        rev = buf[tok_en - 1] == ord("-")
        g.paths.append(Path(name, sample, hap, node_index(ids), rev))
    return g
