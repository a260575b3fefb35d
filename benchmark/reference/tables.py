"""The tables a command should write, and the comparison with what it wrote:
the reference module of the histgrowth traffic (the harness's default).

A command is a `histgrowth` argv as panacus takes it. Its table has four
header rows (panacus, count, coverage, quorum) and a column a growth curve;
the rows are m = 0..n (growth is NaN at 0). Cells are floored; a `#` line
is a comment.

`compare` reads one written TSV against the expected table and returns:

- layout_off: 1 when the header rows or the row names differ, else 0;
- cells_off: cells that differ from NaN in the NaN row, or are no integer;
- growth_gap: the largest distance of an exact growth value from the unit
  interval [cell, cell + 1) of its floored cell (0 when every floor is the
  exact one).

Over the commands of a window the first two are summed, growth_gap is the
largest (COMBINE). The control is the table computed in float32.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from fractions import Fraction
from typing import Dict, List

import numpy as np

from . import counts
from .gfa import Graph, read_gfa

GROUPINGS = {"-S": "sample", "--groupby-sample": "sample", "-H": "haplotype",
             "--groupby-haplotype": "haplotype"}
GROUP_FACTS = {"sample": "samples", "haplotype": "haplotypes", "path": "path_names"}  # facts keys


@dataclass
class Command:
    subcommand: str
    gfa: str
    count: str = "node"
    grouping: str = "path"
    coverage: str = "1"
    quorum: str = "0"


def parse_command(argv: List[str]) -> Command:
    """The flags the benchmark's traffic can use; any other flag raises."""
    if argv[0] != "histgrowth":
        raise ValueError(f"the reference has no {argv[0]!r}")
    cmd = Command(argv[0], "")
    it = iter(argv[1:])
    for a in it:
        if a in GROUPINGS:
            cmd.grouping = GROUPINGS[a]
        elif a in ("-c", "--count"):
            cmd.count = next(it)
        elif a in ("-l", "--coverage"):
            cmd.coverage = next(it)
        elif a in ("-q", "--quorum"):
            cmd.quorum = next(it)
        elif a.startswith("-"):
            raise ValueError(f"the reference does not take {a!r}")
        else:
            cmd.gfa = a
    return cmd


def _fmt_float(x: float) -> str:
    s = repr(float(x))
    return s[:-2] if s.endswith(".0") else s


def thresholds(cmd: Command):
    """[(coverage, quorum)] as ((value, relative), (value, relative)), with
    the header strings of each."""
    cs = [(float(int(x)), False) for x in cmd.coverage.split(",")]
    qs = [(float(x), True) for x in cmd.quorum.split(",")]
    if len(cs) != len(qs):
        if len(qs) == 1:
            qs = qs * len(cs)
        elif len(cs) == 1:
            cs = cs * len(qs)
        else:
            raise ValueError("coverage and quorum lists differ in length")
    return [
        (c, q, str(int(c[0])), _fmt_float(q[0])) for c, q in zip(cs, qs)
    ]


@dataclass
class Table:
    headers: List[tuple]  # (kind, count, coverage, quorum) a column
    rows: List[str]
    columns: List[list] = field(default_factory=list)  # int, Fraction or None (NaN)


def expected(cmd: Command, g: Graph, dtype=None) -> Table:
    """The table of `cmd` on `g`: exact, or (the control) computed in
    `dtype`, its values floats."""
    groups = g.groups(cmd.grouping)
    n = len(groups)
    kinds = counts.COUNTS if cmd.count == "all" else (cmd.count,)
    ths = thresholds(cmd)
    t = Table(headers=[], rows=[str(i) for i in range(n + 1)])
    hists = {}
    for k in kinds:
        cov = counts.coverage(g, groups, k)
        w = g.node_len if k == "bp" else None
        hists[k] = counts.hist(cov, w, n, np.int64 if dtype is None else dtype)
    for k in kinds:
        for c, q, cs, qs in ths:
            t.headers.append(("growth", k, cs, qs))
            t.columns.append([None] + counts.growth(hists[k], c, q, dtype))
    return t


def write_tsv(t: Table) -> str:
    """`t` as panacus writes a table: floored cells, NaN for none."""
    lines = [
        "\t".join([label] + [h[r] for h in t.headers])
        for r, label in enumerate(("panacus", "count", "coverage", "quorum"))
    ]
    for r, name in enumerate(t.rows):
        cells = ["NaN" if col[r] is None else str(math.floor(col[r])) for col in t.columns]
        lines.append("\t".join([name] + cells))
    return "\n".join(lines) + "\n"


def compare(text: str, want: Table) -> Dict[str, float]:
    """The three numbers of the module's docstring for one written table."""
    lines = [ln.split("\t") for ln in text.splitlines() if ln and not ln.startswith("#")]
    out = {"layout_off": 0, "cells_off": 0, "growth_gap": 0.0}
    head, body = lines[:4], lines[4:]
    headers = list(zip(*[r[1:] for r in head])) if len(head) == 4 else []
    if (
        [r[0] for r in head] != ["panacus", "count", "coverage", "quorum"]
        or [tuple(h) for h in headers] != want.headers
        or [r[0] for r in body] != want.rows
        or any(len(r) != len(want.headers) + 1 for r in body)
    ):
        out["layout_off"] = 1
        return out
    for j, col in enumerate(want.columns):
        for r, x in enumerate(col):
            cell = body[r][j + 1]
            if x is None:
                out["cells_off"] += cell != "NaN"
                continue
            try:
                v = int(cell)
            except ValueError:
                out["cells_off"] += 1
                continue
            gap = max(Fraction(0), v - Fraction(x), Fraction(x) - (v + 1))
            out["growth_gap"] = max(out["growth_gap"], float(gap))
    return out


COMBINE = {"layout_off": "sum", "cells_off": "sum", "growth_gap": "max"}


def reference_tables(argv: List[str], dtype=None) -> Table:
    cmd = parse_command(argv)
    return expected(cmd, read_gfa(cmd.gfa), dtype)


def controls(argv: List[str], want: Table) -> Dict[str, str]:
    return {"float32": write_tsv(reference_tables(argv, np.float32))}


def shape(argv: List[str], facts: dict) -> dict:
    """The work of one command, from the argv and the graph's facts."""
    cmd = parse_command(argv)
    return {
        "counts": counts.COUNTS if cmd.count == "all" else (cmd.count,),
        "n_groups": len(facts[GROUP_FACTS[cmd.grouping]]),
        "n_nodes": facts["n_nodes"],
        "n_edges": facts["n_edges"],
        "n_thresholds": len(thresholds(cmd)),
    }
