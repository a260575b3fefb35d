"""write_ms: the span `cli.write` (the last analysis's table formatted and
written to the output), mean ms a command of the traced window."""

from benchmark.spans import mean_ms


def read(run):
    return mean_ms(run, "cli.write")
