"""device_idle_share.all: device_idle_share (% of the traced window with no
kernel, copy or fill on the card) in the -c all cells, where gfa_mbps is no
end-to-end metric."""


def read(run):
    if run.trace is None or run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s() / run.trace.window_s)
