"""Command-line entry of the port: `python -m panacus_torch <subcommand>`.

The parser and the translation of arguments into analysis runs are
panacus_tpu's (build_parser, get_instructions), so the port takes the same
flags. Ported subcommands: hist, growth (on a graph or a hist TSV),
histgrowth, ordered-histgrowth, similarity and table; every other
subcommand exits with status 2. Counting runs on
the device that runtime.resolve_device names (PANACUS_TORCH_DEVICE).
"""

from __future__ import annotations

import logging
import sys
from typing import List, Optional

from panacus_tpu.cli import build_parser, get_instructions
from panacus_tpu.config import AnalysisParameter

from .runtime import resolve_device, set_num_threads

log = logging.getLogger("panacus")

PORTED = (
    "hist",
    "growth",
    "histgrowth",
    "ordered-histgrowth",
    "similarity",
    "table",
)


def run_cli(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    logging.basicConfig(
        level=logging.DEBUG if args.verbose else logging.INFO,
        format="[%(asctime)s %(levelname)s %(name)s] %(message)s",
        stream=sys.stderr,
    )
    if args.command not in PORTED:
        print(
            f"panacus_torch: {args.command} is not yet ported to panacus_torch",
            file=sys.stderr,
        )
        return 2
    set_num_threads(args.threads)
    out = sys.stdout

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

    from .pipeline import convert_to_tasks, execute_pipeline

    tasks = convert_to_tasks(get_instructions(args))
    log.info("%s", tasks)
    execute_pipeline(tasks, out, resolve_device())
    out.flush()
    return 0


def main() -> None:
    sys.exit(run_cli())
