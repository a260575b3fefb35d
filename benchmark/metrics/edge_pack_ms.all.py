"""edge_pack_ms.all: the spans `build.edge_pack` (the second pass that packs
the edge rows of slabs tokenized before the edge index was ready), mean ms
a command of the traced window, in the -c all cells; 0 where none ran."""

from benchmark.spans import mean_ms


def read(run):
    return mean_ms(run, "build.edge_pack")
