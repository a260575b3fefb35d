"""upload_early_share: % of the device route's step-list uploads that the
build found already started by the index: the counts `uploads_early` over
`uploads` of the spans `abaci_by_total` in the traced window (0 where the
builds parsed on the host and uploaded nothing); None where no build
counts uploads, as in a program without that upload."""

from benchmark.spans import count_share, window


def read(run):
    w = window(run)
    if w is None or not any("uploads" in r.counts for r in w[0]):
        return None
    return count_share(run, "abaci_by_total", "uploads_early", "uploads") or 0.0
