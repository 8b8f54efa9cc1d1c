"""Per cent of the traced window of count jobs in which the card is idle
while no span of the program's is open on the main thread (nor the
benchmark's own ``harness`` span), at each idle gap's middle: the idle time
that the program's spans do not name."""

from benchmark.program_spans import idle_unspanned_share


def read(rec):
    return idle_unspanned_share(rec)
