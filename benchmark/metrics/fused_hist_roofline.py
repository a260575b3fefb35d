"""fused_hist_roofline: pt_fused_hist's share of its roofline over the
traced window (kernels/pt_fused_hist.py's bytes at the HBM peak)."""


def read(run):
    return run.roofline("pt_fused_hist")
