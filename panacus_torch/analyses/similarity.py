"""Pairwise group similarity (reference: src/analyses/similarity.rs:16-254)."""

from __future__ import annotations

from typing import Set

from panacus_tpu.analyses import similarity as _tpu_similarity

from ..broker import Req
from ..runtime import phase_timer
from . import TorchAnalysis


class Similarity(TorchAnalysis, _tpu_similarity.Similarity):
    def _set_table(self, gb) -> None:
        with phase_timer("similarity"):
            super()._set_table(gb)

    def get_graph_requirements(self) -> Set:
        count = self.parameter.count_type
        return {Req.abacus_by_group(count)} | self.count_to_input_req(count)
