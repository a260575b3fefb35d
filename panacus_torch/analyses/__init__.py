"""Analyses on the port's broker.

Each analysis subclasses panacus_tpu's and overrides only the methods
that reach panacus_tpu.broker or panacus_tpu.hist (which would start JAX)
or that time a phase; tables and report sections are the JAX package's
own code.
"""

from __future__ import annotations

from typing import Set

from panacus_tpu.utils import CountType

from ..broker import Req


class TorchAnalysis:
    """Mixin: requirement atoms from the port's broker."""

    @staticmethod
    def count_to_input_req(count: CountType) -> Set:
        if count == CountType.BP:
            return {Req.BP}
        if count == CountType.NODE:
            return {Req.NODE}
        if count == CountType.EDGE:
            return {Req.EDGE}
        return {Req.BP, Req.NODE, Req.EDGE}


def construct_analysis(parameter):
    from .growth import Growth
    from .hist import HistAnalysis
    from .ordered_histgrowth import OrderedHistgrowth
    from .similarity import Similarity
    from .table import Table

    registry = {
        "hist": HistAnalysis,
        "growth": Growth,
        "ordered_growth": OrderedHistgrowth,
        "similarity": Similarity,
        "table": Table,
    }
    cls = registry.get(parameter.kind)
    if cls is None:
        raise NotImplementedError(
            f"the {parameter.kind} analysis is not yet ported to panacus_torch"
        )
    return cls(parameter)
