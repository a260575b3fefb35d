"""Task pipeline: AnalysisRun -> tasks -> execution against one GraphBroker.

Port of panacus_tpu/pipeline.py (reference: src/analysis_parameter.rs:117-151,
src/lib.rs:235-311): the table of the last analysis, or every analysis's
report sections as JSON or as one HTML report. The tasks print as
panacus_tpu's do, which is what `report --dry-run` shows.
"""

from __future__ import annotations

import json as json_mod
import logging
from dataclasses import dataclass
from typing import IO, List, Optional, Set, Union

from .analyses import Analysis, construct_analysis
from .broker import GraphBroker, GraphState, Req
from .config import AnalysisParameter, AnalysisRun, Grouping
from .ops.engine import DeviceArg
from .report.sections import AnalysisSection
from .runtime import phase_timer, span

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

    def __repr__(self) -> str:
        return (
            f'GraphStateChange("{self.graph}", {self.name!r}, "{self.subset}", '
            f'"{self.exclude}", {self.grouping}, {sorted(map(str, self.reqs))}, '
            f"{self.nice})"
        )


@dataclass
class OrderChange:
    order: Optional[str]

    def __repr__(self) -> str:
        return f"OrderChange({self.order!r})"


@dataclass
class AnalysisTask:
    analysis: Analysis

    def __repr__(self) -> str:
        return f"Analysis {self.analysis.get_type()}"


@dataclass
class CustomSectionTask:
    name: str
    file: str

    def __repr__(self) -> str:
        return f'CustomSection("{self.name}", "{self.file}")'


Task = Union[GraphStateChange, OrderChange, AnalysisTask, CustomSectionTask]


def analysis_to_tasks(p: AnalysisParameter):
    """(reference: analysis_parameter.rs:224-258)"""
    if p.kind == "custom":
        return [CustomSectionTask(p.name, p.file)], set()
    a = construct_analysis(p)
    reqs = a.get_graph_requirements()
    tasks: List[Task] = []
    # every ordered growth sets its order, which rebuilds the abaci
    if p.kind == "ordered_growth":
        tasks.append(OrderChange(p.order))
    tasks.append(AnalysisTask(a))
    return tasks, reqs


def convert_to_tasks(runs: List[AnalysisRun]) -> List[Task]:
    runs = sorted(runs, key=lambda r: r.sort_key())
    tasks: List[Task] = []
    for run in runs:
        run_tasks: List[Task] = []
        reqs: Set = set()
        for p in sorted(run.analyses, key=lambda a: a.sort_key()):
            t, r = analysis_to_tasks(p)
            run_tasks.extend(t)
            reqs |= r
        reqs.add(Req.graph(run.graph))
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


def execute_pipeline(
    tasks: List[Task],
    out: IO[str],
    devices: DeviceArg,
    shall_write_html: bool = False,
    json: bool = False,
) -> None:
    """Apply the tasks in order against one broker on `devices` (M split
    over them), then write the JSON report, the HTML report or the last
    analysis's table (reference: src/lib.rs:235-311). The table's
    formatting and write are the span `cli.write`; the analysis's own
    phase runs before it."""
    if not tasks:
        log.warning("No instructions supplied")
        return
    report: List[AnalysisSection] = []
    gb = GraphBroker(devices)
    try:
        for task in tasks:
            if isinstance(task, AnalysisTask):
                log.info("Executing Analysis: %s", task.analysis.get_type())
                if json or shall_write_html:
                    report.extend(task.analysis.generate_report_section(gb))
            elif isinstance(task, CustomSectionTask):
                from .report.custom import generate_custom_section

                report.extend(generate_custom_section(gb, task.name, task.file))
            elif isinstance(task, GraphStateChange):
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
        if json:
            out.write(json_mod.dumps([s.to_json_dict() for s in report], indent=2))
            out.write("\n")
        elif shall_write_html:
            from .report.html import generate_report

            out.write(generate_report(report, "<Placeholder Filename>"))
            out.write("\n")
        elif isinstance(tasks[-1], AnalysisTask):
            analysis = tasks[-1].analysis
            analysis.prepare(gb)
            with span("cli.write") as sp:
                table = analysis.generate_table(gb)
                out.write(table)
                out.write("\n")
                sp.add(bytes=len(table) + 1)
    finally:
        # the broker holds the graph, its item tables and the device
        # matrices: release them here, inside the span, rather than at the
        # return; the graph's upload worker is joined first, on every exit
        with span("cli.release"):
            gb.close()
            del gb, report
