"""inflate_mbps: inflated MB (1e6 bytes) a second of the spans
`index.inflate`: their count `bytes` summed over their time summed, in the
traced window; None where no span carries the count `bytes_in`, as in a
program without that span."""

from benchmark.spans import window


def read(run):
    w = window(run)
    if w is None:
        return None
    got = [r for r in w[0] if r.name == "index.inflate" and "bytes_in" in r.counts]
    ns = sum(r.end_ns - r.start_ns for r in got)
    if not ns:
        return None
    return sum(r.counts.get("bytes", 0) for r in got) / 1e6 / (ns / 1e9)
