"""command_self_ms: the span `command` (all of cli.run_cli) less the union
of its children, mean ms a command of the traced window: what no span of
the program names, the in-program counterpart of cli_other_ms."""

from benchmark.spans import self_ms


def read(run):
    return self_ms(run, "command")
