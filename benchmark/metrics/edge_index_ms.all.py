"""edge_index_ms.all: the span `edge_index` (the L-line indexer, on its
worker thread beside the S and P parse and the stream build), mean ms a
command of the traced window, in the -c all cells."""

from benchmark.spans import mean_ms


def read(run):
    return mean_ms(run, "edge_index")
