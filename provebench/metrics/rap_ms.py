"""ms a proof in the program's span ``prove_rap_constraints`` over the
window: the GKR and batch graphs replayed, ending in a sync."""

from harness import span_ms

LAYER = "RAP stage"
UNIT = "ms/proof"
SOURCE = "program_span"
MOVES = "prove_s"


def read(run):
    return span_ms(run, "prove_rap_constraints")
