"""inflate_share: % of the commands' time spent inflating: the spans
`index.inflate` summed over the window's `command` spans summed; None where
no span carries the count `bytes_in`, as in a program without that span."""

from benchmark.spans import window


def read(run):
    w = window(run)
    if w is None or not any("bytes_in" in r.counts for r in w[0]):
        return None
    got, commands = w
    inflate = sum(r.end_ns - r.start_ns for r in got if r.name == "index.inflate")
    total = sum(r.end_ns - r.start_ns for r in commands.values())
    return 100.0 * inflate / total
