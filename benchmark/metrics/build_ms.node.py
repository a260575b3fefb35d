"""build_ms.node: build_ms (phase `abaci_by_total`, mean ms a command) in the
-c node histgrowth cell, where gfa_mbps is no end-to-end metric."""


def read(run):
    return run.phase_ms("abaci_by_total")
