"""cli_other_ms: the mean ms a command of the window spends outside every
phase of runtime.phase_timer: the argument parse, the pipeline's set-up,
the table writer. The harness's clock around run_cli less the time that
some phase covers."""

import statistics


def read(run):
    cmds = run.ok()
    if not cmds:
        return None
    return 1e3 * statistics.fmean(c.wall_s - c.in_phases_s for c in cmds)
