"""Task pipeline: AnalysisRun -> tasks -> execution against one GraphBroker.

Port of panacus_tpu/pipeline.py for table output (reference:
src/analysis_parameter.rs:117-151, src/lib.rs:235-311); HTML/JSON reports
are not ported yet.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import IO, List, Optional, Set, Union

import torch

from panacus_tpu.config import AnalysisRun, Grouping

from .analyses import construct_analysis
from .broker import GraphBroker, GraphState, Req
from .runtime import phase_timer

log = logging.getLogger("panacus")


@dataclass
class GraphStateChange:
    graph: str
    name: Optional[str]
    reqs: Set
    nice: bool
    subset: str
    exclude: str
    grouping: Optional[Grouping]


@dataclass
class OrderChange:
    order: Optional[str]


@dataclass
class AnalysisTask:
    analysis: object  # an analysis of panacus_torch.analyses


Task = Union[GraphStateChange, OrderChange, AnalysisTask]


def convert_to_tasks(runs: List[AnalysisRun]) -> List[Task]:
    runs = sorted(runs, key=lambda r: r.sort_key())
    tasks: List[Task] = []
    for run in runs:
        run_tasks: List[Task] = []
        reqs: Set = {Req.graph(run.graph)}
        for p in sorted(run.analyses, key=lambda a: a.sort_key()):
            a = construct_analysis(p)
            reqs |= a.get_graph_requirements()
            # every ordered growth sets its order, which rebuilds the abaci
            # (panacus_tpu/pipeline.py:67-77)
            if p.kind == "ordered_growth":
                run_tasks.append(OrderChange(p.order))
            run_tasks.append(AnalysisTask(a))
        tasks.append(
            GraphStateChange(
                graph=run.graph,
                name=run.name,
                reqs=reqs,
                nice=run.nice,
                subset=run.subset,
                exclude=run.exclude,
                grouping=run.grouping,
            )
        )
        tasks.extend(run_tasks)
    return tasks


def execute_pipeline(tasks: List[Task], out: IO[str], device: torch.device) -> None:
    """Apply the graph state changes in order, then write the table of the
    last analysis (reference: src/lib.rs:235-311)."""
    if not tasks:
        log.warning("No instructions supplied")
        return
    gb = GraphBroker(device)
    for task in tasks:
        if isinstance(task, GraphStateChange):
            log.info("Executing graph change: %s", task.reqs)
            gb.change_graph_state(
                GraphState(
                    graph=task.graph,
                    name=task.name,
                    subset=task.subset,
                    exclude=task.exclude,
                    grouping=task.grouping,
                ),
                task.reqs,
                task.nice,
            )
        elif isinstance(task, OrderChange):
            log.info("Executing order change: %s", task.order)
            with phase_timer("order_change"):
                gb.change_order(task.order or "")
    if isinstance(tasks[-1], AnalysisTask):
        out.write(tasks[-1].analysis.generate_table(gb))
        out.write("\n")
