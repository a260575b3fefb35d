"""gfa_mbps.all: gfa_mbps, GFA MB of every command completed in the traced
window over the window's wall, in the cells whose runs spread too widely
between processes for gfa_mbps to hold a bound end to end (-c all): there it
is a reading, and moves the cell's host_peak_rss_mb."""


def read(run):
    return run.gfa_mbps() if run.window_s > 0 else None
