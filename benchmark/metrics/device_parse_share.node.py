"""device_parse_share.node: device_parse_share (% of the streamed build's node
slabs parsed on the card, from the counts of the spans `abaci_by_total` in
the traced window) in the -c node histgrowth cell, where gfa_mbps is no
end-to-end metric."""

from benchmark.spans import count_share


def read(run):
    return count_share(run, "abaci_by_total", "node_slabs_on_device", "node_slabs")
