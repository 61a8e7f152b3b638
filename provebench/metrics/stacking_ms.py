"""ms a proof in the program's span ``prove_stacked_reduction`` over the
window: the stacked reduction's graph replayed, ending in a sync."""

from harness import span_ms

LAYER = "stacked reduction"
UNIT = "ms/proof"
SOURCE = "program_span"
MOVES = "prove_s"


def read(run):
    return span_ms(run, "prove_stacked_reduction")
