"""upload_ms: the spans `index.upload` (the step-list upload that the index
starts on a worker thread: the copy to the card), summed, mean ms a command of the traced window; None where no
build counts `uploads`, as in a program without that upload."""

from benchmark.spans import mean_ms, window


def read(run):
    w = window(run)
    if w is None or not any("uploads" in r.counts for r in w[0]):
        return None
    return mean_ms(run, "index.upload")
