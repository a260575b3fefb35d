"""stage_ms.node: stage_ms (the spans `build.stage` summed, mean ms a command
of the traced window; None where no build counts node slabs) in the -c node
histgrowth cell, where gfa_mbps is no end-to-end metric."""

from benchmark.spans import mean_ms, window


def read(run):
    w = window(run)
    if w is None or not any("node_slabs" in r.counts for r in w[0]):
        return None
    return mean_ms(run, "build.stage")
