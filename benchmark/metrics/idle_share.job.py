"""Per cent of the traced window of job jobs in which no operation (kernel,
copy or fill) ran on the card: 1 - the union of the profiler's device
intervals over the window."""

from benchmark.readers import idle_share


def read(rec):
    return idle_share(rec)
