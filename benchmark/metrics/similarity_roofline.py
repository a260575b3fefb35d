"""similarity_roofline: pt_similarity's share of its roofline over the traced
window (kernels/pt_similarity.py's bytes at the HBM peak)."""


def read(run):
    return run.roofline("pt_similarity")
