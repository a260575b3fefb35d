"""Graph / path / group statistics (reference: src/analyses/info.rs:14-597).

Connected components run on scipy's union-find over the canonical edge
table instead of the reference's per-node DFS — same component sizes,
host-side, O(E α(N)).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Set, Tuple

import numpy as np

from ..io_utils import write_argv_comment
from ..report.sections import AnalysisSection, bar, table_item
from ..utils import (
    averageu32,
    fmt_f32,
    fmt_float,
    median_already_sorted,
    n50_already_sorted,
)
from . import Analysis


class Info(Analysis):
    def __init__(self, parameter):
        super().__init__(parameter)
        self._graph_info = None
        self._path_info = None
        self._group_info = None

    def get_type(self) -> str:
        return "Info"

    def get_graph_requirements(self) -> Set:
        from ..broker import Req

        return {Req.NODE, Req.EDGE, Req.BP, Req.PATH_LENS}

    def _set_info(self, gb) -> None:
        if self._graph_info is not None:
            return
        self._graph_info = _graph_info(gb)
        self._path_info = _path_info(gb)
        self._group_info = _group_info(gb)

    def generate_table(self, gb) -> str:
        self._set_info(gb)
        res = write_argv_comment()
        res += self._to_string()
        return res

    def _to_string(self) -> str:
        g = self._graph_info
        p = self._path_info
        lines = [
            "feature\tcategory\tcountable\tvalue",
            f"graph\ttotal\tnode\t{g['node_count']}",
            f"graph\ttotal\tbp\t{g['basepairs']}",
            f"graph\ttotal\tedge\t{g['edge_count']}",
            f"graph\ttotal\tpath\t{p['no_paths']}",
            f"graph\ttotal\tgroup\t{g['group_count']}",
            f"graph\ttotal\t0-degree node\t{g['number_0_degree']}",
            f"graph\ttotal\tcomponent\t{g['connected_components']}",
            f"graph\tlargest\tcomponent\t{g['largest_component']}",
            f"graph\tsmallest\tcomponent\t{g['smallest_component']}",
            f"graph\tmedian\tcomponent\t{fmt_float(g['median_component'])}",
            f"node\taverage\tbp\t{fmt_f32(g['average_node'])}",
            f"node\taverage\tdegree\t{fmt_f32(g['average_degree'])}",
            f"node\tlongest\tbp\t{g['largest_node']}",
            f"node\tshortest\tbp\t{g['shortest_node']}",
            f"node\tmedian\tbp\t{fmt_float(g['median_node'])}",
            f"node\tN50 node\tbp\t{g['n50_node']}",
            f"node\tmax\tdegree\t{g['max_degree']}",
            f"node\tmin\tdegree\t{g['min_degree']}",
            f"path\taverage\tbp\t{fmt_f32(p['bp_avg'])}",
            f"path\taverage\tnode\t{fmt_f32(p['node_avg'])}",
            f"path\tlongest\tbp\t{p['bp_max']}",
            f"path\tlongest\tnode\t{p['node_max']}",
            f"path\tshortest\tbp\t{p['bp_min']}",
            f"path\tshortest\tnode\t{p['node_min']}",
        ]
        res = "\n".join(lines)
        if self._group_info is not None:
            for k in sorted(self._group_info.keys()):
                node_tot, bp_tot = self._group_info[k]
                res += f"\ngroup\t{k}\tbp\t{bp_tot}\n"
                res += f"group\t{k}\tnode\t{node_tot}"
        return res

    def generate_report_section(self, gb) -> List[AnalysisSection]:
        self._set_info(gb)
        table = f"`{self.generate_table(gb)}`"
        run_name = gb.get_run_name()
        run_id = f"{gb.get_run_id()}-info"
        safe = run_id.lower().replace(" ", "-").replace("|", "-").replace("\\", "-")
        header = ["feature", "category", "countable", "value"]
        g = self._graph_info
        p = self._path_info
        graph_rows = [
            ["graph", "total", "node", str(g["node_count"])],
            ["graph", "total", "bp", str(g["basepairs"])],
            ["graph", "total", "edge", str(g["edge_count"])],
            ["graph", "total", "path", str(p["no_paths"])],
            ["graph", "total", "group", str(g["group_count"])],
            ["graph", "total", "0-degree node", str(g["number_0_degree"])],
            ["graph", "total", "component", str(g["connected_components"])],
            ["graph", "largest", "component", str(g["largest_component"])],
            ["graph", "smallest", "component", str(g["smallest_component"])],
            ["graph", "median", "component", fmt_float(g["median_component"])],
        ]
        node_rows = [
            ["node", "average", "bp", fmt_f32(g["average_node"])],
            ["node", "average", "degree", fmt_f32(g["average_degree"])],
            ["node", "longest", "bp", str(g["largest_node"])],
            ["node", "shortest", "bp", str(g["shortest_node"])],
            ["node", "median", "bp", fmt_float(g["median_node"])],
            ["node", "N50 node", "bp", str(g["n50_node"])],
            ["node", "max", "degree", str(g["max_degree"])],
            ["node", "min", "degree", str(g["min_degree"])],
        ]
        path_rows = [
            ["path", "average", "bp", fmt_f32(p["bp_avg"])],
            ["path", "average", "node", fmt_f32(p["node_avg"])],
            ["path", "longest", "bp", str(p["bp_max"])],
            ["path", "longest", "node", str(p["node_max"])],
            ["path", "shortest", "bp", str(p["bp_min"])],
            ["path", "shortest", "node", str(p["node_min"])],
        ]
        sections = []
        for suffix, countable, rid, rows in [
            ("graph", "Graph Info", "info-1-table", graph_rows),
            ("node", "Node Info", "info-2-table", node_rows),
            ("path", "Path Info", "info-3-table", path_rows),
        ]:
            sections.append(
                AnalysisSection(
                    id=f"{safe}-{suffix}",
                    analysis="Pangenome Info",
                    run_name=run_name,
                    run_id=run_id,
                    countable=countable,
                    table=table,
                    items=[table_item(rid, header, _dedup_rows(rows))],
                )
            )
        sections.append(
            AnalysisSection(
                id=f"{safe}-group",
                analysis="Pangenome Info",
                run_name=run_name,
                run_id=run_id,
                countable="Group Info",
                table=table,
                items=[
                    self._group_bar(run_id, "node"),
                    self._group_bar(run_id, "bp"),
                ],
            )
        )
        return sections

    def _group_bar(self, graph: str, countable: str):
        groups = self._group_info
        idx = 0 if countable == "node" else 1
        labels = list(groups.keys())
        values = [float(groups[k][idx]) for k in labels]
        if len(labels) > 100:
            labels, binned = _bin_values([groups[k][idx] for k in groups])
            values = [float(v) for v in binned]
        return bar(
            id=f"info-{graph}-group-{countable}",
            name=countable,
            x_label="groups",
            y_label=f"#{countable}s",
            labels=labels,
            values=values,
            log_toggle=True,
        )


def _dedup_rows(values: List[List[str]]) -> List[List[str]]:
    """Blank out leading cells equal to the previous row
    (reference: info.rs:366-380)."""
    new = [row[:] for row in values]
    prev = values[0]
    for j in range(1, len(values)):
        for i, col in enumerate(values[j]):
            if col == prev[i]:
                new[j][i] = ""
            else:
                break
        prev = values[j]
    return new


def _bin_values(vals: List[int]) -> Tuple[List[str], List[int]]:
    """50-bin fallback for >100 groups (reference: info.rs:275-296)."""
    if not vals:
        return [], []
    n_bins = 50
    mx, mn = max(vals), min(vals)
    bin_size = max(int(round((mx - mn) / n_bins)), 1)
    edges = list(range(mn, mx, bin_size))
    bins = [(s, s + bin_size) for s in edges]
    values = [sum(1 for a in vals if s <= a < e) for s, e in bins]
    names = [f"{s}-{e}" for s, e in bins]
    return names, values


def _graph_info(gb) -> Dict:
    degree = gb.get_degree()[1:]
    node_lens = gb.get_node_lens()[1:]
    node_lens_sorted = np.sort(node_lens)[::-1]
    comp_sizes = _connected_components(gb)
    comp_sizes.sort()
    return {
        "node_count": gb.get_node_count(),
        "edge_count": gb.get_edge_count(),
        "average_degree": averageu32(degree),
        "max_degree": int(degree.max()),
        "min_degree": int(degree.min()),
        "number_0_degree": int((degree == 0).sum()),
        "connected_components": len(comp_sizes),
        "largest_component": int(comp_sizes.max()) if len(comp_sizes) else 0,
        "smallest_component": int(comp_sizes.min()) if len(comp_sizes) else 0,
        "median_component": median_already_sorted(comp_sizes),
        "largest_node": int(node_lens_sorted.max()),
        "shortest_node": int(node_lens_sorted.min()),
        "average_node": averageu32(node_lens_sorted),
        "median_node": median_already_sorted(node_lens_sorted),
        "n50_node": n50_already_sorted(node_lens_sorted),
        "basepairs": int(gb.get_node_lens().astype(np.uint64).sum()),
        "group_count": gb.get_group_count(),
    }


def _connected_components(gb) -> np.ndarray:
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components as cc

    n = gb.get_node_count()
    g = gb.graph_aux
    u = g.edges_u - 1
    v = g.edges_v - 1
    data = np.ones(len(u), dtype=np.int8)
    adj = coo_matrix((data, (u, v)), shape=(n, n))
    n_comp, labels = cc(adj, directed=False)
    return np.bincount(labels, minlength=n_comp).astype(np.int64)


def _path_info(gb) -> Dict:
    paths_len = gb.get_path_lens()
    node_lens = [x[0] for x in paths_len.values()]
    bp_lens = [x[1] for x in paths_len.values()]
    return {
        "no_paths": len(paths_len),
        "node_max": max(node_lens),
        "node_min": min(node_lens),
        "node_avg": averageu32(np.array(node_lens, dtype=np.uint32)),
        "bp_max": max(bp_lens),
        "bp_min": min(bp_lens),
        "bp_avg": averageu32(np.array(bp_lens, dtype=np.uint32)),
    }


def _group_info(gb) -> Dict[str, Tuple[int, int]]:
    groups = gb.get_groups()
    out: Dict[str, List[int]] = {}
    for k, v in gb.get_path_lens().items():
        # the reference looks the *coordinate-bearing* key up in the
        # coordinate-free group map, silently skipping sub-paths
        # (reference: info.rs:544-547) — replicated for parity
        if k not in groups:
            continue
        g = groups[k]
        acc = out.setdefault(g, [0, 0])
        acc[0] += v[0]
        acc[1] += v[1]
    return {k: (v[0], v[1]) for k, v in out.items()}
