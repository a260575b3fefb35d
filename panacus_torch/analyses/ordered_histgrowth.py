"""Ordered growth analysis (reference: src/analyses/ordered_histgrowth.rs:15-200)."""

from __future__ import annotations

from typing import Set

from panacus_tpu.analyses import ordered_histgrowth as _tpu_ordered

from ..broker import Req
from ..runtime import phase_timer
from . import TorchAnalysis


class OrderedHistgrowth(TorchAnalysis, _tpu_ordered.OrderedHistgrowth):
    def _set_inner(self, gb) -> None:
        with phase_timer("ordered_growth"):
            super()._set_inner(gb)

    def get_graph_requirements(self) -> Set:
        count = self.parameter.count_type
        return {Req.abacus_by_group(count)} | self.count_to_input_req(count)
