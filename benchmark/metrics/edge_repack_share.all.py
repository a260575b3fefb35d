"""edge_repack_share.all: % of the edge slabs whose rows were packed in the
second pass, from the stash, rather than inside the tokenizer's pass: the
counts `edge_slabs_repacked` over `edge_slabs` of the spans
`abaci_by_total` in the traced window, in the -c all cells."""

from benchmark.spans import count_share


def read(run):
    return count_share(run, "abaci_by_total", "edge_slabs_repacked", "edge_slabs")
