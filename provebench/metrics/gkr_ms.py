"""ms a proof of the card's time in the GKR segment over the window: the
program's timing ``gkr.device``, between the CUDA events that the segment's
graph records at its start and end on every replay."""

from harness import span_ms

LAYER = "RAP stage"
UNIT = "ms/proof"
SOURCE = "program_span"
MOVES = "prove_s"


def read(run):
    return span_ms(run, "gkr.device")
