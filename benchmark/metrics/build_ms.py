"""build_ms: the program's phase `abaci_by_total` (runtime.phase_timer), mean ms a
command of the window."""


def read(run):
    return run.phase_ms("abaci_by_total")
