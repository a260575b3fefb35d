"""Analysis layer: pull-based analyses over a GraphBroker
(reference: src/analyses.rs:17-40).

The port's copy of panacus_tpu/analyses, on the port's broker: every
analysis kind of the YAML schema."""

from __future__ import annotations

from typing import TYPE_CHECKING, List, Optional, Set

from ..config import AnalysisParameter
from ..report.sections import AnalysisSection
from ..utils import CountType

if TYPE_CHECKING:
    from ..broker import GraphBroker


class Analysis:
    def __init__(self, parameter: AnalysisParameter):
        self.parameter = parameter

    def get_type(self) -> str:
        raise NotImplementedError

    def prepare(self, gb: "GraphBroker") -> None:
        """Compute what generate_table formats, so that the formatting can
        be timed apart; analyses that compute in generate_table itself
        leave it."""

    def generate_table(self, gb: Optional["GraphBroker"]) -> str:
        raise NotImplementedError

    def generate_report_section(
        self, gb: Optional["GraphBroker"]
    ) -> List[AnalysisSection]:
        raise NotImplementedError

    def get_graph_requirements(self) -> Set:
        raise NotImplementedError

    @staticmethod
    def count_to_input_req(count: CountType) -> Set:
        from ..broker import Req

        if count == CountType.BP:
            return {Req.BP}
        if count == CountType.NODE:
            return {Req.NODE}
        if count == CountType.EDGE:
            return {Req.EDGE}
        return {Req.BP, Req.NODE, Req.EDGE}


def construct_analysis(parameter: AnalysisParameter) -> Analysis:
    from .coverage_line import CoverageLine
    from .growth import Growth
    from .hist import HistAnalysis
    from .info import Info
    from .node_distribution import NodeDistribution
    from .ordered_histgrowth import OrderedHistgrowth
    from .similarity import Similarity
    from .table import Table

    registry = {
        "hist": HistAnalysis,
        "growth": Growth,
        "table": Table,
        "node_distribution": NodeDistribution,
        "info": Info,
        "ordered_growth": OrderedHistgrowth,
        "coverage_line": CoverageLine,
        "similarity": Similarity,
    }
    cls = registry.get(parameter.kind)
    if cls is None:
        raise ValueError(f"unknown analysis kind: {parameter.kind}")
    return cls(parameter)
