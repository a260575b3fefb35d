"""device_parse_share: % of the streamed build's node slabs whose step lists
were parsed on the card: the counts `node_slabs_on_device` over
`node_slabs` of the spans `abaci_by_total` in the traced window; None where
no build counts node slabs."""

from benchmark.spans import count_share


def read(run):
    return count_share(run, "abaci_by_total", "node_slabs_on_device", "node_slabs")
