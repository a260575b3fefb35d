"""format_ms: the spans `write.format` (the similarity table's body
formatted by one call into the program's C layer, inside `cli.write`),
summed, mean ms a command of the traced window; None where no span carries
the count `cells`, as in a program that formats the table cell by cell."""

from benchmark.spans import mean_ms, window


def read(run):
    w = window(run)
    if w is None or not any("cells" in r.counts for r in w[0]):
        return None
    return mean_ms(run, "write.format")
