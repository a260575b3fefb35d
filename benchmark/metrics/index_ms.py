"""index_ms: the program's phase `index` (runtime.phase_timer), mean ms a
command of the window."""


def read(run):
    return run.phase_ms("index")
