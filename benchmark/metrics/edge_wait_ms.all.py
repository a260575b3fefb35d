"""edge_wait_ms.all: the span `edge_index.wait` (the stream build waiting
for the L-line indexer to finish), mean ms a command of the traced window,
in the -c all cells; a command that did not wait counts 0."""

from benchmark.spans import mean_ms


def read(run):
    return mean_ms(run, "edge_index.wait")
