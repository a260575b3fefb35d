"""stage_ms: the spans `build.stage` (the device route's one copy of the
GFA's bytes from the first step list to the last to the card) summed,
mean ms a command of the traced window (0 where the builds parsed on the
host); None where no build counts node slabs, as in a program without the
device route."""

from benchmark.spans import mean_ms, window


def read(run):
    w = window(run)
    if w is None or not any("node_slabs" in r.counts for r in w[0]):
        return None
    return mean_ms(run, "build.stage")
