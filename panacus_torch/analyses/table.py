"""Coverage table export (reference: src/analyses/table.rs:10-78)."""

from __future__ import annotations

from typing import Set

from panacus_tpu.analyses import table as _tpu_table

from ..broker import Req
from . import TorchAnalysis


class Table(TorchAnalysis, _tpu_table.Table):
    def get_graph_requirements(self) -> Set:
        count = self.parameter.count_type
        return {
            Req.abacus_by_group(count),
            Req.group_table(count),
        } | self.count_to_input_req(count)
