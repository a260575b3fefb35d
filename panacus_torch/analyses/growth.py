"""Pangenome growth analysis (reference: src/analyses/growth.rs:23-312)."""

from __future__ import annotations

import sys
from typing import List, Optional, Set, Tuple

from ..hist import Hist
from ..io_utils import parse_hists, write_argv_comment, write_table
from ..report.sections import AnalysisSection, multi_bar
from ..runtime import phase_timer
from ..utils import CountType, Threshold, ThresholdContainer
from . import Analysis


class Growth(Analysis):
    def __init__(self, parameter):
        super().__init__(parameter)
        self._inner = None

    def get_type(self) -> str:
        return "Growth"

    def _thresholds(self) -> ThresholdContainer:
        quorum = self.parameter.quorum or "0"
        coverage = self.parameter.coverage or "1"
        return ThresholdContainer.parse_params(quorum, coverage)

    def _set_inner(self, gb) -> None:
        if self._inner is not None:
            return
        hist_aux = self._thresholds()
        if gb is None:
            raise NotImplementedError("growth without graph needs a hist file")
        with phase_timer("growth"):
            growths = [
                (h.count, h.calc_all_growths(hist_aux))
                for h in gb.get_hists().values()
            ]
        self._inner = (growths, [], hist_aux, None)

    def prepare(self, gb) -> None:
        self._set_inner(gb)

    def generate_table(self, gb) -> str:
        self._set_inner(gb)
        growths, comments, hist_aux, hists = self._inner
        res = "".join(c + "\n" for c in comments)
        res += write_argv_comment()
        header_cols = [["panacus", "count", "coverage", "quorum"]]
        output_columns: List[List[float]] = []
        use_hists = (
            hists if hists is not None else list(gb.get_hists().values())
        )
        if self.parameter.add_hist:
            for h in use_hists:
                output_columns.append([float(x) for x in h.coverage])
                header_cols.append(["hist", str(h.count), "", ""])
        for count, g in growths:
            output_columns.extend(g)
            for c, q in zip(hist_aux.coverage, hist_aux.quorum):
                header_cols.append(
                    ["growth", str(count), c.get_string(), q.get_string()]
                )
        res += write_table(header_cols, output_columns)
        return res

    def generate_table_from_hist(self, file: str) -> str:
        """The no-graph fast path: TSV hist in, growth TSV out
        (reference: growth.rs:190-262)."""
        hist_aux = self._thresholds()
        with open(file, "rb") as f:
            coverages, comments = parse_hists(f)
        hists = [Hist(count, cov) for count, cov in coverages]
        growths = [(h.count, h.calc_all_growths(hist_aux)) for h in hists]
        res = "".join(c + "\n" for c in comments)
        res += write_argv_comment()
        header_cols = [["panacus", "count", "coverage", "quorum"]]
        output_columns: List[List[float]] = []
        if self.parameter.add_hist:
            for h in hists:
                output_columns.append([float(x) for x in h.coverage])
                header_cols.append(["hist", str(h.count), "", ""])
        for count, g in growths:
            output_columns.extend(g)
            for c, q in zip(hist_aux.coverage, hist_aux.quorum):
                header_cols.append(
                    ["growth", str(count), c.get_string(), q.get_string()]
                )
        res += write_table(header_cols, output_columns)
        return res

    def generate_report_section(self, gb) -> List[AnalysisSection]:
        self._set_inner(gb)
        growths, _comments, hist_aux, _hists = self._inner
        growth_labels = [
            f"coverage ≥ {hist_aux.coverage[i].get_string()}, quorum ≥ "
            f"{_quorum_pct(hist_aux.quorum[i])}%"
            for i in range(len(hist_aux.coverage))
        ]
        table = f"`{self.generate_table(gb)}`"
        run_id = f"{gb.get_run_id()}-growth"
        id_prefix = "pan-growth-" + _safe(run_id)
        out = []
        for k, v in growths:
            out.append(
                AnalysisSection(
                    id=f"{id_prefix}-{k}",
                    analysis="Pangenome Growth",
                    run_name=gb.get_run_name(),
                    run_id=run_id,
                    countable=str(k),
                    table=table,
                    items=[
                        multi_bar(
                            id=f"{id_prefix}-{k}",
                            names=growth_labels,
                            x_label="taxa",
                            y_label=f"#{k}s",
                            labels=[str(i) for i in range(1, len(v[0]))],
                            values=[
                                [0.0 if x != x else float(x) for x in row]
                                for row in v
                            ],
                            log_toggle=False,
                        )
                    ],
                )
            )
        return out

    def get_graph_requirements(self) -> Set:
        from ..broker import Req

        return {Req.HIST}


def _quorum_pct(t: Threshold) -> str:
    from ..utils import fmt_float

    if t.relative:
        return fmt_float(t.value * 100.0)
    return str(int(t.value) * 100)


def _safe(s: str) -> str:
    return s.lower().replace(" ", "-").replace("|", "-").replace("\\", "-")
