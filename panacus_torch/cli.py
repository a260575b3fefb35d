"""Command-line entry of the port: `python -m panacus_torch <subcommand>`.

The parser and the translation of arguments into analysis runs
(build_parser, get_instructions) are the port's copy of panacus_tpu/cli.py
(reference: src/lib.rs:77-222, src/commands/*.rs), so the port takes the
same flags and runs the same ten subcommands: report, render, hist,
growth (on a graph or a hist TSV), histgrowth, info, ordered-histgrowth,
table, node-distribution and similarity. Counting runs on the devices that
runtime.resolve_devices names (PANACUS_TORCH_DEVICE: every visible GPU,
or the CPU), the membership matrices split over them.

Under torchrun (WORLD_SIZE > 1) every process runs the same command:
run_cli joins the process group first (runtime.init_distributed), each
process tokenizes its share of the paths (parallel.ingest), and only rank
0 writes the output, as panacus_tpu's run_cli does under jax.distributed
(cli.py:447-458):

    torchrun --nproc-per-node 2 -m panacus_torch histgrowth -c all -H graph.gfa
"""

from __future__ import annotations

import argparse
import io
import logging
import sys
from typing import TYPE_CHECKING, List, Optional

from .config import AnalysisParameter, AnalysisRun, Grouping
from .runtime import (
    init_distributed,
    resolve_devices,
    set_num_threads,
    shutdown_distributed,
    span,
    world,
)
from .utils import CountType

if TYPE_CHECKING:
    from .ops.engine import DeviceArg

log = logging.getLogger("panacus")

COUNT_CHOICES = ["node", "bp", "edge", "all"]
COUNT_CHOICES_NO_ALL = ["node", "bp", "edge"]
CLUSTER_CHOICES = [
    "single",
    "complete",
    "average",
    "weighted",
    "ward",
    "centroid",
    "median",
]


_GFA_HELP = (
    "graph in GFA1 format, accepts also compressed (.gz) file"
)


def _add_common_graph_args(
    p: argparse.ArgumentParser, gfa_meta="GFA_FILE", gfa_help=_GFA_HELP
):
    p.add_argument("gfa_file", metavar=gfa_meta, help=gfa_help)
    p.add_argument(
        "-s",
        "--subset",
        metavar="FILE",
        default="",
        help="Produce counts by subsetting the graph to a given list of "
        "paths (1-column list) or path coordinates (3- or 12-column BED "
        "file)",
    )
    p.add_argument(
        "-e",
        "--exclude",
        metavar="FILE",
        default="",
        help="Exclude bp/node/edge in growth count that intersect with "
        "paths (1-column list) or path coordinates (3- or 12-column "
        "BED-file) provided by the given file; all intersecting "
        "bp/node/edge will be excluded also in other paths not part of "
        "the given list",
    )
    p.add_argument(
        "-g",
        "--groupby",
        metavar="FILE",
        default="",
        help="Merge counts from paths by path-group mapping from given "
        "tab-separated two-column file",
    )
    p.add_argument(
        "-H",
        "--groupby-haplotype",
        action="store_true",
        help="Merge counts from paths belonging to same haplotype",
    )
    p.add_argument(
        "-S",
        "--groupby-sample",
        action="store_true",
        help="Merge counts from paths belonging to same sample",
    )


_ORDER_HELP = (
    "The ordered histogram will be produced according to order of "
    "paths/groups in the supplied file (1-column list). If this option is "
    "not used, the order is determined by the rank of paths/groups in the "
    "subset list, and if that option is not used, the order is determined "
    "by the rank of paths/groups in the GFA file."
)
_COUNT_HELP = "Graph quantity to be counted"
_TOTAL_HELP = "Summarize by totaling presence/absence over all groups"


def _add_threshold_args(p: argparse.ArgumentParser):
    p.add_argument(
        "-l",
        "--coverage",
        default="1",
        help="Ignore all countables with a coverage lower than the "
        "specified threshold. The coverage of a countable corresponds to "
        "the number of path/walk that contain it. Repeated appearances of "
        "a countable in the same path/walk are counted as one. You can "
        "pass a comma-separated list of coverage thresholds, each one "
        "will produce a separated growth curve (e.g., --coverage 2,3). "
        "Use --quorum to set a threshold in conjunction with each "
        "coverage (e.g., --quorum 0.5,0.9)",
    )
    p.add_argument(
        "-q",
        "--quorum",
        default="0",
        help="Unlike the --coverage parameter, which specifies a minimum "
        "constant number of paths for all growth point m (1 <= m <= "
        "num_paths), --quorum adjusts the threshold based on m. At each "
        "m, a countable is counted in the average growth if the countable "
        "is contained in at least floor(m*quorum) paths. Example: A "
        "quorum of 0.9 requires a countable to be in 90%% of paths for "
        "each subset size m. A quorum of 1 (100%%) requires presence in "
        "all paths of the subset, corresponding to the core. Default: 0, "
        "a countable counts if it is present in any path at each growth "
        "point. Specify multiple quorum values with a comma-separated "
        "list (e.g., --quorum 0.5,0.9).",
    )


def build_parser() -> argparse.ArgumentParser:
    # global flags usable before or after the subcommand, like clap's
    # .global(true) args (reference: src/lib.rs:94-111)
    common = argparse.ArgumentParser(add_help=False)
    common.add_argument(
        "-t",
        "--threads",
        type=int,
        default=0,
        metavar="COUNT",
        help="Set the number of threads used (default: use all threads)",
    )
    common.add_argument(
        "-v",
        "--verbose",
        action="store_true",
        help="Emit debug-level log output",
    )

    ap = argparse.ArgumentParser(prog="panacus", parents=[common])
    subparsers = ap.add_subparsers(dest="command", required=True)

    class _Sub:
        def add_parser(self, name, **kw):
            kw.setdefault("parents", [common])
            return subparsers.add_parser(name, **kw)

    sub = _Sub()

    p = sub.add_parser("render", help="Render an html report from JSON result files")
    p.add_argument(
        "json_files", nargs="+", help="Specifies one or more JSON files"
    )

    p = sub.add_parser("report", help="Create an html report from a YAML config file")
    p.add_argument("yaml_file", nargs="?", help="Specifies yaml config")
    p.add_argument(
        "-d",
        "--dry-run",
        action="store_true",
        help="If set, no actual computation is done, only the planned "
        "computation will be shown",
    )
    p.add_argument(
        "-j",
        "--json",
        action="store_true",
        help="Instead of an HTML report, a json result will be delivered. "
        "These can later be combined and rendered as a single HTML.",
    )

    p = sub.add_parser("hist", help="Calculate coverage histogram")
    _add_common_graph_args(p)
    p.add_argument(
        "-c",
        "--count",
        default="node",
        choices=COUNT_CHOICES,
        help=_COUNT_HELP,
    )

    p = sub.add_parser("growth", help="Calculate growth curve from coverage histogram")
    _add_common_graph_args(
        p,
        gfa_meta="FILE",
        gfa_help="EITHER graph in GFA1 format, accepts also compressed "
        "(.gz) file OR a histogram as a .tsv",
    )
    p.add_argument(
        "-a",
        "--hist",
        action="store_true",
        help="Also include histogram in output (ONLY IN GFA MODE)",
    )
    _add_threshold_args(p)

    p = sub.add_parser(
        "histgrowth", help="Run hist and growth. Return the growth curve"
    )
    _add_common_graph_args(p)
    p.add_argument(
        "-a",
        "--hist",
        action="store_true",
        help="Also include histogram in output",
    )
    p.add_argument(
        "-c",
        "--count",
        default="node",
        choices=COUNT_CHOICES,
        help=_COUNT_HELP,
    )
    _add_threshold_args(p)

    p = sub.add_parser("info", help="Return general graph and paths info")
    _add_common_graph_args(p)

    p = sub.add_parser(
        "ordered-histgrowth",
        help="Calculate growth curve based on group file order",
    )
    _add_common_graph_args(p)
    p.add_argument("-O", "--order", metavar="FILE", help=_ORDER_HELP)
    p.add_argument(
        "-c",
        "--count",
        default="node",
        choices=COUNT_CHOICES_NO_ALL,
        help=_COUNT_HELP,
    )
    _add_threshold_args(p)

    p = sub.add_parser("table", help="Compute coverage table for count type")
    _add_common_graph_args(p)
    p.add_argument("-a", "--total", action="store_true", help=_TOTAL_HELP)
    p.add_argument("-O", "--order", metavar="FILE", help=_ORDER_HELP)
    p.add_argument(
        "-c",
        "--count",
        default="node",
        choices=COUNT_CHOICES_NO_ALL,
        help=_COUNT_HELP,
    )

    p = sub.add_parser(
        "node-distribution", help="Return hexbin node distribution list"
    )
    p.add_argument("gfa_file", metavar="GFA_FILE", help=_GFA_HELP)
    p.add_argument(
        "-r",
        "--radius",
        type=int,
        default=20,
        help="Radius of the hexagons used to bin",
    )

    p = sub.add_parser("similarity", help="Compute similarity table for count type")
    _add_common_graph_args(p)
    p.add_argument("-a", "--total", action="store_true", help=_TOTAL_HELP)
    p.add_argument(
        "-c",
        "--count",
        default="node",
        choices=COUNT_CHOICES_NO_ALL,
        help=_COUNT_HELP,
    )
    p.add_argument(
        "-m",
        "--method",
        default="centroid",
        choices=CLUSTER_CHOICES,
        help="Method for clustering results",
    )

    return ap


def _grouping_from_args(args) -> Optional[Grouping]:
    if getattr(args, "groupby_sample", False):
        return Grouping.sample()
    if getattr(args, "groupby_haplotype", False):
        return Grouping.haplotype()
    if getattr(args, "groupby", ""):
        return Grouping.custom(args.groupby)
    return None


def _run_from_args(args, analyses: List[AnalysisParameter]) -> AnalysisRun:
    return AnalysisRun(
        graph=args.gfa_file,
        name=None,
        subset=getattr(args, "subset", "") or "",
        exclude=getattr(args, "exclude", "") or "",
        grouping=_grouping_from_args(args),
        nice=False,
        analyses=analyses,
    )


def get_instructions(args) -> List[AnalysisRun]:
    cmd = args.command
    if cmd == "hist":
        return [
            _run_from_args(
                args,
                [
                    AnalysisParameter(
                        kind="hist", count_type=CountType.parse(args.count)
                    )
                ],
            )
        ]
    if cmd == "growth":
        return [
            _run_from_args(
                args,
                [
                    AnalysisParameter(
                        kind="growth",
                        coverage=args.coverage,
                        quorum=args.quorum,
                        add_hist=args.hist,
                    )
                ],
            )
        ]
    if cmd == "histgrowth":
        return [
            _run_from_args(
                args,
                [
                    AnalysisParameter(
                        kind="hist", count_type=CountType.parse(args.count)
                    ),
                    AnalysisParameter(
                        kind="growth",
                        coverage=args.coverage,
                        quorum=args.quorum,
                        add_hist=args.hist,
                    ),
                ],
            )
        ]
    if cmd == "info":
        return [_run_from_args(args, [AnalysisParameter(kind="info")])]
    if cmd == "ordered-histgrowth":
        return [
            _run_from_args(
                args,
                [
                    AnalysisParameter(
                        kind="ordered_growth",
                        coverage=args.coverage,
                        quorum=args.quorum,
                        count_type=CountType.parse(args.count),
                        order=args.order,
                    )
                ],
            )
        ]
    if cmd == "table":
        return [
            _run_from_args(
                args,
                [
                    AnalysisParameter(
                        kind="table",
                        count_type=CountType.parse(args.count),
                        total=args.total,
                        order=args.order,
                    )
                ],
            )
        ]
    if cmd == "node-distribution":
        return [
            AnalysisRun(
                graph=args.gfa_file,
                name=None,
                subset="",
                exclude="",
                grouping=None,
                nice=False,
                analyses=[
                    AnalysisParameter(
                        kind="node_distribution", radius=args.radius
                    )
                ],
            )
        ]
    if cmd == "similarity":
        return [
            _run_from_args(
                args,
                [
                    AnalysisParameter(
                        kind="similarity",
                        count_type=CountType.parse(args.count),
                        cluster_method=args.method,
                    )
                ],
            )
        ]
    return []


EXAMPLE_YAML = """
# Missing YAML file!
#
# Example YAML:
# To get started copy this into a .yaml file and edit it

- graph: ../graphs/test_graph.gfa
  grouping: Haplotype
  analyses:
    - !Hist
      count_type: Bp
    - !Growth
      coverage: 1,1,2
      quorum: 0,0.9,0

# For more information see the panacus wiki
"""


def run_cli(argv: Optional[List[str]] = None, devices: Optional[DeviceArg] = None) -> int:
    """Run one subcommand; `devices` are those the membership matrices are
    split over (None: runtime.resolve_devices()). The whole of it is the
    span `command`, the root of every span it opens."""
    with span("command"):
        return _run(argv, devices)


def _run(argv: Optional[List[str]], devices: Optional[DeviceArg]) -> int:
    with span("cli.parse"):
        args = build_parser().parse_args(argv)
        logging.basicConfig(
            level=logging.DEBUG if args.verbose else logging.INFO,
            format="[%(asctime)s %(levelname)s %(name)s] %(message)s",
            stream=sys.stderr,
        )
        set_num_threads(args.threads)
    out = sys.stdout
    # a multi-process run joins its process group before the first device
    # touch; every rank runs every collective, rank 0 alone writes
    if init_distributed() and world()[0] != 0:
        out = io.StringIO()

    if args.command == "render":
        import json as json_mod

        from .report.html import generate_report
        from .report.sections import AnalysisSection

        full_report = []
        for fp in args.json_files:
            with open(fp) as f:
                full_report.extend(
                    AnalysisSection.from_json_dict(d) for d in json_mod.load(f)
                )
        out.write(generate_report(full_report, args.json_files[0]))
        out.write("\n")
        return 0

    # growth on a hist TSV: the no-graph fast path (reference: lib.rs:144-174)
    if args.command == "growth" and args.gfa_file.endswith("tsv"):
        if (
            args.subset
            or args.exclude
            or args.groupby
            or args.groupby_sample
            or args.groupby_haplotype
        ):
            raise SystemExit(
                "subset, exclude and groupby can only be used in graph mode "
                "(with a .gfa or .gfa.gz file)"
            )
        from .analyses.growth import Growth

        growth = Growth(
            AnalysisParameter(
                kind="growth",
                coverage=args.coverage,
                quorum=args.quorum,
                add_hist=args.hist,
            )
        )
        out.write(growth.generate_table_from_hist(args.gfa_file))
        out.write("\n")
        return 0

    with span("cli.parse"):
        from .pipeline import convert_to_tasks, execute_pipeline

        shall_write_html = False
        dry_run = False
        json = False
        if args.command == "report":
            shall_write_html = True
            dry_run = args.dry_run
            json = args.json
            if args.yaml_file is None:
                out.write(EXAMPLE_YAML + "\n")
                return 0
            from .config import load_config_file

            instructions = load_config_file(args.yaml_file)
        else:
            instructions = get_instructions(args)

        tasks = convert_to_tasks(instructions)
        log.info("%s", tasks)
    if dry_run:
        # one task per line, as panacus_tpu prints the plan (the reference
        # pretty-prints the task vector with {:#?}, src/lib.rs:213-217; an
        # empty Vec prints as "[]" on one line)
        if not tasks:
            out.write("[]\n")
            return 0
        out.write("[\n")
        for t in tasks:
            out.write(f"    {t!r},\n")
        out.write("]\n")
        return 0
    if devices is None:
        devices = resolve_devices()
    execute_pipeline(tasks, out, devices, shall_write_html, json)
    out.flush()
    return 0


def main() -> None:
    try:
        rc = run_cli()
    finally:
        shutdown_distributed()
    sys.exit(rc)
