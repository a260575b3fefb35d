"""The similarity table a command should write, and the comparison with what
it wrote: the reference module of the `similarity` traffic.

A command is a `similarity` argv as panacus takes it. Its table (upstream
similarity.rs:119-236, as SURVEY C19 sets it out):

- each group's node set, the union of its paths' nodes (reference/gfa.py);
- the intersections |A & B| and the sizes |A| as int64;
- Jaccard as the exact rational inter / (a + b - inter), rounded once to
  float32 (to nearest, ties to even); 0 where the union is empty;
- rows and columns in the dendrogram's leaf order: the linkage (`-m`,
  centroid by default) of the Euclidean distances between the float32 rows;
  each observation goes to the place where it first appears in the merge
  steps (a step's first cluster, then its second, where either is a single
  observation), which is where upstream's in-place permutation by the
  sorted appearance indices (similarity.rs:165-219) puts it;
- a header row, `group` and the labels, then a row a label, each cell as
  Rust's Display prints an f32: the shortest decimal that reads back as the
  same f32, with no exponent and no trailing `.0`. A `#` line is a comment.

`compare` reads one written TSV against the expected table and returns:

- layout_off: 1 when the header word, the set of row or column labels, or
  the row or column counts differ, else 0;
- cells_off: cells, looked up by their pair of labels, whose text differs;
- order_off: 1 when the row or the column labels are not in the expected
  order, else 0.

Over the commands of a window each is summed (COMBINE). The controls: the
intersections accumulated in bfloat16, and the expected table with its
order reversed.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List

import numpy as np

from .gfa import read_gfa
from .tables import GROUP_FACTS, GROUPINGS

METHODS = ("single", "complete", "average", "weighted", "ward", "centroid", "median")
COMBINE = {"layout_off": "sum", "cells_off": "sum", "order_off": "sum"}
ITEM_BLOCK = 1 << 16  # items a block of the intersection product
BF16_K = 16  # items an accumulation step of the bfloat16 control: one k-step of a bf16 MMA


@dataclass
class Command:
    gfa: str
    grouping: str = "path"
    method: str = "centroid"


def parse_command(argv: List[str]) -> Command:
    """The flags the benchmark's traffic can use; any other flag raises."""
    if argv[0] != "similarity":
        raise ValueError(f"this reference has no {argv[0]!r}")
    cmd = Command("")
    it = iter(argv[1:])
    for a in it:
        if a in GROUPINGS:
            cmd.grouping = GROUPINGS[a]
        elif a in ("-c", "--count"):
            if next(it) != "node":
                raise ValueError("the similarity reference counts nodes only")
        elif a in ("-m", "--method"):
            cmd.method = next(it)
            if cmd.method not in METHODS:
                raise ValueError(f"no cluster method {cmd.method!r}")
        elif a.startswith("-"):
            raise ValueError(f"the reference does not take {a!r}")
        else:
            cmd.gfa = a
    return cmd


def shape(argv: List[str], facts: dict) -> dict:
    """The work of one command, from the argv and the graph's facts."""
    cmd = parse_command(argv)
    return {
        "counts": ("node",),
        "n_groups": len(facts[GROUP_FACTS[cmd.grouping]]),
        "n_nodes": facts["n_nodes"],
        "n_edges": facts["n_edges"],
    }


@dataclass
class Table:
    labels: List[str]  # in the table's order, rows and columns alike
    cells: List[List[str]]  # cells[i][j]: the text of (labels[i], labels[j])


def node_sets(cmd: Command):
    """(group labels in the file order of their first path, bool [G, n_nodes])."""
    g = read_gfa(cmd.gfa)
    groups = g.groups(cmd.grouping)
    held = np.zeros((len(groups), g.n_nodes), dtype=bool)
    for k, paths in enumerate(groups.values()):
        for p in paths:
            held[k, p.nodes] = True
    return list(groups), held


def intersections(held: np.ndarray) -> np.ndarray:
    """int64 |A & B| for every pair of rows. Each block is a float64 product,
    exact since every sum in it is an integer below 2^53."""
    n_groups, n_items = held.shape
    if n_items >= 2**53:
        raise ValueError("too many items for an exact float64 block")
    out = np.zeros((n_groups, n_groups), dtype=np.int64)
    for lo in range(0, n_items, ITEM_BLOCK):
        b = held[:, lo : lo + ITEM_BLOCK].astype(np.float64)
        out += (b @ b.T).astype(np.int64)
    return out


def round_f32(p: int, q: int) -> np.float32:
    """The rational p / q, 0 <= p <= q, rounded once to float32: to nearest,
    ties to even. 1/q is far above float32's smallest normal here."""
    if p == 0:
        return np.float32(0.0)
    e = 24 + q.bit_length() - p.bit_length()  # m = floor(p 2^e / q) in [2^23, 2^25)
    m, r = divmod(p << e, q)
    while m >= 1 << 24:
        e -= 1
        m, r = divmod(p << e, q)
    if 2 * r > q or (2 * r == q and m & 1):
        m += 1  # 2^24 at most: still exact
    return np.float32(m * 2.0**-e)


def jaccard_exact(inter: np.ndarray) -> np.ndarray:
    n = len(inter)
    sizes = [int(x) for x in np.diagonal(inter)]
    out = np.zeros((n, n), dtype=np.float32)
    for i in range(n):
        for j in range(n):
            a = int(inter[i, j])
            union = sizes[i] + sizes[j] - a
            out[i, j] = round_f32(a, union) if union else np.float32(0.0)
    return out


def bf16(x: np.ndarray) -> np.ndarray:
    """float32 values rounded to the nearest bfloat16 (ties to even), as
    float32; finite, non-negative values."""
    u = x.astype(np.float32).view(np.uint32)
    u = (u + np.uint32(0x7FFF) + ((u >> np.uint32(16)) & np.uint32(1))) & np.uint32(0xFFFF0000)
    return u.view(np.float32)


def jaccard_bf16(held: np.ndarray) -> np.ndarray:
    """The control: the intersections accumulated in a bfloat16 accumulator,
    BF16_K items a step (each step's partial exact), and Jaccard in float32
    from them."""
    n_groups, n_items = held.shape
    acc = np.zeros((n_groups, n_groups), dtype=np.float32)
    chunk = BF16_K * 1024
    for lo in range(0, n_items, chunk):
        b = held[:, lo : lo + chunk].astype(np.float32)
        pad = -b.shape[1] % BF16_K
        b = np.pad(b, ((0, 0), (0, pad))).reshape(n_groups, -1, BF16_K).transpose(1, 0, 2)
        for part in b @ b.transpose(0, 2, 1):
            acc = bf16(acc + part)
    sizes = np.diagonal(acc)
    union = sizes[:, None] + sizes[None, :] - acc
    with np.errstate(divide="ignore", invalid="ignore"):
        out = (acc / union).astype(np.float32)
    return np.where(union > 0, out, np.float32(0.0))


def leaf_order(table: np.ndarray, method: str) -> List[int]:
    """Observations in the order in which they first appear in the merge
    steps of the linkage of the rows' Euclidean distances."""
    n = len(table)
    if n < 2:
        return list(range(n))
    from scipy.cluster.hierarchy import linkage
    from scipy.spatial.distance import pdist

    steps = linkage(pdist(table.astype(np.float64), "euclidean"), method=method)
    order = []
    for a, b in steps[:, :2].astype(np.int64).tolist():
        order += [c for c in (a, b) if c < n]
    return order


def fmt_f32(x) -> str:
    """Rust's Display of an f32: the shortest round-trip decimal, positional."""
    return np.format_float_positional(np.float32(x), unique=True, trim="-")


def table_of(labels: List[str], jac: np.ndarray, method: str) -> Table:
    order = leaf_order(jac, method)
    return Table([labels[i] for i in order], [[fmt_f32(jac[i, j]) for j in order] for i in order])


def reference_tables(argv: List[str], dtype=None) -> Table:
    """The expected table: exact, or (dtype "bfloat16") the control's."""
    cmd = parse_command(argv)
    labels, held = node_sets(cmd)
    if dtype is None:
        jac = jaccard_exact(intersections(held))
    elif dtype == "bfloat16":
        jac = jaccard_bf16(held)
    else:
        raise ValueError(f"no control in {dtype!r}")
    return table_of(labels, jac, cmd.method)


def write_tsv(t: Table) -> str:
    lines = ["\t".join(["group"] + t.labels)]
    lines += ["\t".join([label] + row) for label, row in zip(t.labels, t.cells)]
    return "\n".join(lines) + "\n"


def reversed_order(t: Table) -> Table:
    return Table(t.labels[::-1], [row[::-1] for row in t.cells[::-1]])


def controls(argv: List[str], want: Table) -> Dict[str, str]:
    return {"bfloat16": write_tsv(reference_tables(argv, "bfloat16")),
            "order_reversed": write_tsv(reversed_order(want))}


def compare(text: str, want: Table) -> Dict[str, float]:
    """The three numbers of the module's docstring for one written table."""
    lines = [ln.split("\t") for ln in text.splitlines() if ln and not ln.startswith("#")]
    out = {"layout_off": 0, "cells_off": 0, "order_off": 0}
    head, body = (lines[0], lines[1:]) if lines else ([], [])
    cols, rows = head[1:], [r[0] for r in body]
    if (
        head[:1] != ["group"]
        or sorted(cols) != sorted(want.labels)
        or sorted(rows) != sorted(want.labels)
        or any(len(r) != len(head) for r in body)
    ):
        out["layout_off"] = 1
        return out
    out["order_off"] = int(cols != want.labels or rows != want.labels)
    at = {c: j + 1 for j, c in enumerate(cols)}
    by_label = dict(zip(rows, body))
    for a, cells in zip(want.labels, want.cells):
        row = by_label[a]
        out["cells_off"] += sum(row[at[b]] != x for b, x in zip(want.labels, cells))
    return out
