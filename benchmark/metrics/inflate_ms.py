"""inflate_ms: the spans `index.inflate` (a .gfa.gz inflated into one buffer
by gfa._read_gz_streamed, libdeflate or zlib), summed, mean ms a command of
the traced window; None where no span carries the count `bytes_in`, as in a
program without that span."""

from benchmark.spans import mean_ms, window


def read(run):
    w = window(run)
    if w is None or not any("bytes_in" in r.counts for r in w[0]):
        return None
    return mean_ms(run, "index.inflate")
