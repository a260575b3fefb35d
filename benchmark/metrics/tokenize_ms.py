"""tokenize_ms: the spans `build.tokenize` (the streamed build's tokenizer,
one a slab) summed, mean ms a command of the traced window."""

from benchmark.spans import mean_ms


def read(run):
    return mean_ms(run, "build.tokenize")
