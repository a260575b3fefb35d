"""fused_hist_roofline.all: fused_hist_roofline (pt_fused_hist's share of its
roofline over the traced window) in the -c all cells, where it reads the
edge M beside the node M and gfa_mbps is no end-to-end metric."""


def read(run):
    return run.roofline("pt_fused_hist")
