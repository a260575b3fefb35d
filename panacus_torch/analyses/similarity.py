"""Pairwise group similarity heatmap (reference: src/analyses/similarity.rs:16-254).

Intersections come from the membership matrix on the device
(ops.engine.CountingEngine.similarity, the pt_similarity kernel); Jaccard
and hierarchical clustering run host-side with scipy (same 7 linkage
methods as the reference's kodama).
"""

from __future__ import annotations

from typing import List, Set

import numpy as np

from ..io_utils import write_metadata_comments
from ..report.sections import AnalysisSection, heatmap
from ..native import format_f32_table
from ..runtime import phase_timer, span
from . import Analysis


class Similarity(Analysis):
    def __init__(self, parameter):
        super().__init__(parameter)
        self._table = None
        self._labels = None

    def get_type(self) -> str:
        return "Similarity"

    def get_graph_requirements(self) -> Set:
        from ..broker import Req

        req = {Req.abacus_by_group(self.parameter.count_type)}
        req |= self.count_to_input_req(self.parameter.count_type)
        return req

    def _set_table(self, gb) -> None:
        if self._table is not None:
            return
        with phase_timer("similarity"):
            self._compute_table(gb)

    def _compute_table(self, gb) -> None:
        ab = gb.get_abacus_by_group()
        inter, sizes = ab.similarity_matrix()
        g = len(ab.groups)
        labels = list(ab.groups)
        denom = sizes.reshape(-1, 1) + sizes.reshape(1, -1) - inter
        with np.errstate(divide="ignore", invalid="ignore"):
            table = (inter / denom).astype(np.float32)
        table = np.nan_to_num(table, nan=0.0)

        order = _cluster_order(table, self.parameter.cluster_method)
        table = table[np.ix_(order, order)]
        labels = [labels[i] for i in order]
        self._table = table
        self._labels = labels

    def prepare(self, gb) -> None:
        self._set_table(gb)

    def generate_table(self, gb) -> str:
        self._set_table(gb)
        header = "".join(["group"] + [f"\t{g}" for g in self._labels] + ["\n"])
        with span("write.format", cells=self._table.size):
            body = format_f32_table(self._table, self._labels)
        return write_metadata_comments() + header + body

    def generate_report_section(self, gb) -> List[AnalysisSection]:
        self._set_table(gb)
        k = self.parameter.count_type
        table = f"`{self.generate_table(gb)}`"
        run_id = f"{gb.get_run_id()}-similarity"
        id_prefix = "sim-heat-" + run_id.lower().replace(" ", "-").replace(
            "|", "-"
        ).replace("\\", "-")
        return [
            AnalysisSection(
                id=f"{id_prefix}-{k}",
                analysis="Similarity Heatmap",
                table=table,
                run_name=gb.get_run_name(),
                run_id=run_id,
                countable=str(k),
                items=[
                    heatmap(
                        id=f"{id_prefix}-{k}",
                        name=gb.get_fname(),
                        x_labels=self._labels,
                        y_labels=self._labels,
                        values=[[float(x) for x in row] for row in self._table],
                    )
                ],
            )
        ]


def _cluster_order(table: np.ndarray, method: str) -> List[int]:
    """Dendrogram leaf order, matching the reference's observation-appearance
    walk over kodama's merge steps (similarity.rs:165-181, 207-219)."""
    n = len(table)
    if n < 2:
        return list(range(n))
    from scipy.cluster.hierarchy import linkage
    from scipy.spatial.distance import pdist

    condensed = pdist(table.astype(np.float64), metric="euclidean")
    Z = linkage(condensed, method=method)
    appearance: List[int] = []
    for row in Z:
        a, b = int(row[0]), int(row[1])
        if a < n:
            appearance.append(a)
        if b < n:
            appearance.append(b)
    # appearance[k] = observation; reference sorts (position, obs) by obs and
    # keeps positions, then applies as a permutation
    order = sorted(range(len(appearance)), key=lambda i: appearance[i])
    return _apply_reference_permutation(order, n)


def _apply_reference_permutation(order: List[int], n: int) -> List[int]:
    """The reference applies `sort_by_indices` (similarity.rs:196-205) which
    permutes list[i] <-> list[indices[i]] in-place — reproduce its net effect
    on an identity list."""
    lst = list(range(n))
    idx = list(order)
    for i in range(len(idx)):
        while i != idx[i]:
            new_i = idx[i]
            idx[i], idx[new_i] = idx[new_i], idx[i]
            lst[i], lst[new_i] = lst[new_i], lst[i]
    return lst
