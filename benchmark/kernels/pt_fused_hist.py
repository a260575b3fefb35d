"""pt_fused_hist (panacus_torch/csrc/hist.cu): the coverage histograms of a
membership matrix M, one uint32 word a 32 groups an item, under int32 weight
rows. The least bytes of one command's hists: M of the nodes once when node
or bp is counted, the bp weights once, M of the edges once when edge is
counted, each int64 histogram written once. A node count needs no weight
row."""

import math

KERNELS = ("fused_hist_kernel", "fused_hist_warp_kernel")


def matches(name: str) -> bool:
    return any(k in name for k in KERNELS)


def least_bytes(shape: dict) -> int:
    words = math.ceil(shape["n_groups"] / 32)
    counts = shape["counts"]
    hist = 8 * (shape["n_groups"] + 1)
    node_rows = [c for c in counts if c in ("node", "bp")]
    total = 0
    if node_rows:
        total += 4 * words * shape["n_nodes"] + hist * len(node_rows)
    if "bp" in counts:
        total += 4 * shape["n_nodes"]
    if "edge" in counts:
        total += 4 * words * shape["n_edges"] + hist
    return total
