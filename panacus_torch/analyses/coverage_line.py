"""Allele-count (log-log) coverage line (reference: src/analyses/coverage_line.rs:14-149).
YAML-only analysis, like the reference."""

from __future__ import annotations

from typing import List, Set

from ..io_utils import write_metadata_comments, write_table_with_start_index
from ..report.sections import AnalysisSection, line
from . import Analysis


class CoverageLine(Analysis):
    def get_type(self) -> str:
        return "CoverageLine"

    def get_graph_requirements(self) -> Set:
        from ..broker import Req

        req = {Req.HIST}
        req |= self.count_to_input_req(self.parameter.count_type)
        return req

    def generate_table(self, gb) -> str:
        if gb is None:
            raise ValueError("CoverageLine analysis needs a graph")
        res = write_metadata_comments()
        header_cols = [["panacus", "count", "", ""]]
        output_columns = []
        for h in gb.get_hists().values():
            output_columns.append([float(x) for x in h.coverage[1:]])
            header_cols.append(["hist", str(h.count), "", ""])
        res += write_table_with_start_index(header_cols, output_columns, 1)
        return res

    def generate_report_section(self, gb) -> List[AnalysisSection]:
        if gb is None:
            raise ValueError("CoverageLine analysis needs a graph")
        table = f"`{self.generate_table(gb)}`"
        run_id = f"{gb.get_run_id()}-coverageline"
        id_prefix = "coverage-line-" + run_id.lower().replace(" ", "-").replace(
            "|", "-"
        ).replace("\\", "-")
        out = []
        for k, v in gb.get_hists().items():
            values = list(v.coverage)
            while values and values[-1] == 0:
                values.pop()
            values = [float(c) for c in values[1:]]
            out.append(
                AnalysisSection(
                    id=f"{id_prefix}-{k}",
                    analysis="Coverage Line",
                    table=table,
                    run_name=gb.get_run_name(),
                    run_id=run_id,
                    countable=str(k),
                    items=[
                        line(
                            id=f"{id_prefix}-{k}",
                            name=gb.get_fname(),
                            x_label="Allele count",
                            y_label=f"#{k}s",
                            x_values=[float(i) for i in range(1, len(values) + 1)],
                            y_values=values,
                            log_x=True,
                            log_y=True,
                        )
                    ],
                )
            )
        return out
