"""gfa_mbps.node: gfa_mbps, GFA MB of every command completed in the traced
window over the window's wall, in the -c node histgrowth cell, whose runs
spread too widely between processes and machines for gfa_mbps to hold a
bound end to end there: it is a reading, and moves the cell's
host_peak_rss_mb."""


def read(run):
    return run.gfa_mbps() if run.window_s > 0 else None
