"""index_ms.all: index_ms (phase `index`, mean ms a command) in the -c all
cells, where the L-line edge indexer runs beside the S and P parse and
gfa_mbps is no end-to-end metric."""


def read(run):
    return run.phase_ms("index")
