"""Node coverage/length distribution hexbins
(reference: src/analyses/node_distribution.rs:15-121)."""

from __future__ import annotations

from typing import List, Set

import numpy as np

from ..report.hexbin import hexbin_arrays
from ..report.sections import AnalysisSection, hexbin_item
from ..utils import CountType, fmt_float
from . import Analysis


class NodeDistribution(Analysis):
    def __init__(self, parameter):
        super().__init__(parameter)
        self._bins = None

    def get_type(self) -> str:
        return "NodeDistribution"

    def get_graph_requirements(self) -> Set:
        from ..broker import Req

        return {Req.NODE}

    def _set_table(self, gb) -> None:
        if self._bins is not None:
            return
        countables = gb.get_abacus_by_total(CountType.NODE).countable[1:]
        node_lens = gb.get_node_lens()[1:]
        log_lens = np.log10(node_lens.astype(np.float64))
        ids = np.arange(1, len(countables) + 1, dtype=np.int64)
        self._bins = hexbin_arrays(
            ids, countables.astype(np.float64), log_lens, 15, 9
        )

    def generate_table(self, gb) -> str:
        self._set_table(gb)
        out = ["Bin\tCoverage\tLog-Length\tLog-Size\n"]
        for i, b in enumerate(self._bins):
            out.append(
                f"{i}\t{fmt_float(b['x'])}\t{fmt_float(b['y'])}\t{b['size']}\n"
            )
        return "".join(out)

    def generate_report_section(self, gb) -> List[AnalysisSection]:
        table = f"`{self.generate_table(gb)}`"
        run_id = f"{gb.get_run_id()}-nodedistribution"
        id_prefix = "node-dist-" + run_id.lower().replace(" ", "-").replace(
            "|", "-"
        ).replace("\\", "-")
        return [
            AnalysisSection(
                id=f"{id_prefix}-node",
                analysis="Node distribution",
                table=table,
                run_name=gb.get_run_name(),
                run_id=run_id,
                countable="node",
                items=[
                    hexbin_item(
                        id=f"{id_prefix}-node",
                        bins=[
                            {
                                "size": b["size"],
                                "x": b["x"],
                                "y": b["y"],
                                "content": b["content"],
                            }
                            for b in self._bins
                        ],
                    )
                ],
            )
        ]
