"""scan_ms: the span `index.scan` (the threaded line scan and the line
classifier of gfa.GraphStorage), mean ms a command of the traced window."""

from benchmark.spans import mean_ms


def read(run):
    return mean_ms(run, "index.scan")
