"""build_ms.all: build_ms (phase `abaci_by_total`, mean ms a command) in the
-c all cells, where the edge pack runs beside the node pack and gfa_mbps is
no end-to-end metric."""


def read(run):
    return run.phase_ms("abaci_by_total")
