"""index_ms.node: index_ms (phase `index`, mean ms a command) in the -c node
histgrowth cell, where gfa_mbps is no end-to-end metric."""


def read(run):
    return run.phase_ms("index")
