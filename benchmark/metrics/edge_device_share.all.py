"""edge_device_share.all: % of the edge slabs whose rows the card wrote
(the device route's edge pass) rather than the host's tokenizer pass: the
counts `edge_slabs_on_device` over `edge_slabs` of the spans
`abaci_by_total` in the traced window, in the -c all cells; None where no
build counts edge slabs, or on a program without the count."""

from benchmark.spans import count_share, window


def read(run):
    w = window(run)
    if w is None or not any("edge_slabs_on_device" in r.counts for r in w[0]):
        return None
    return count_share(run, "abaci_by_total", "edge_slabs_on_device", "edge_slabs")
