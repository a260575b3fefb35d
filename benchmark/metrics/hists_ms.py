"""hists_ms: the program's phase `hists` (runtime.phase_timer), mean ms a
command of the window."""


def read(run):
    return run.phase_ms("hists")
