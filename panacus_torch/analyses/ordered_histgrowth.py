"""Ordered growth analysis (reference: src/analyses/ordered_histgrowth.rs:15-200).

The growth itself is a device scan over the membership matrix
(ops.engine.CountingEngine.ordered_growth, the pt_ordered_growth kernel)."""

from __future__ import annotations

import logging
from typing import List, Set

from ..io_utils import write_metadata_comments, write_ordered_table
from ..report.sections import AnalysisSection, multi_bar
from ..runtime import phase_timer
from ..utils import ThresholdContainer
from . import Analysis

log = logging.getLogger("panacus")


class OrderedHistgrowth(Analysis):
    def __init__(self, parameter):
        super().__init__(parameter)
        self._inner = None

    def get_type(self) -> str:
        return "OrderedHistgrowth"

    def get_graph_requirements(self) -> Set:
        from ..broker import Req

        req = {Req.abacus_by_group(self.parameter.count_type)}
        req |= self.count_to_input_req(self.parameter.count_type)
        return req

    def _set_inner(self, gb) -> None:
        if self._inner is not None:
            return
        quorum = self.parameter.quorum or "0"
        coverage = self.parameter.coverage or "1"
        hist_aux = ThresholdContainer.parse_params(quorum, coverage)
        ab = gb.get_abacus_by_group()
        growths = []
        with phase_timer("ordered_growth"):
            for c, q in zip(hist_aux.coverage, hist_aux.quorum):
                log.info(
                    "calculating ordered growth for coverage >= %s and "
                    "quorum >= %s",
                    c,
                    q,
                )
                growths.append([float("nan")] + ab.calc_growth(c, q))
        self._inner = (growths, hist_aux)

    def prepare(self, gb) -> None:
        self._set_inner(gb)

    def generate_table(self, gb) -> str:
        if gb is None:
            return ""
        self._set_inner(gb)
        growths, hist_aux = self._inner
        ab = gb.get_abacus_by_group()
        log.info("reporting ordered-growth table")
        res = write_metadata_comments()
        header_cols = [["panacus", "count", "coverage", "quorum"]]
        for c, q in zip(hist_aux.coverage, hist_aux.quorum):
            header_cols.append(
                ["ordered-growth", str(ab.count), c.get_string(), q.get_string()]
            )
        res += write_ordered_table(header_cols, growths, ab.groups)
        return res

    def generate_report_section(self, gb) -> List[AnalysisSection]:
        self._set_inner(gb)
        growths, hist_aux = self._inner
        ab = gb.get_abacus_by_group()
        growth_labels = [
            f"coverage ≥ {hist_aux.coverage[i].get_string()}, quorum ≥ "
            f"{hist_aux.quorum[i].get_string()}%"
            for i in range(len(hist_aux.coverage))
        ]
        table = f"`{self.generate_table(gb)}`"
        run_id = f"{gb.get_run_id()}-orderedgrowth"
        id_prefix = "pan-ordered-growth-" + run_id.lower().replace(
            " ", "-"
        ).replace("|", "-").replace("\\", "-")
        return [
            AnalysisSection(
                id=id_prefix,
                analysis="Ordered Growth",
                run_name=gb.get_run_name(),
                run_id=run_id,
                countable=str(self.parameter.count_type),
                table=table,
                items=[
                    multi_bar(
                        id=id_prefix,
                        names=growth_labels,
                        x_label="taxa",
                        y_label=f"{self.parameter.count_type}s",
                        labels=list(ab.groups),
                        # NaN is not valid JSON; zero the leading sentinel
                        # (the JS renderer skips index 0, like Growth)
                        values=[
                            [0.0 if x != x else float(x) for x in row]
                            for row in growths
                        ],
                        log_toggle=False,
                    )
                ],
            )
        ]
