"""ms a proof in the program's span ``prove_whir`` over the window: the
WHIR graph replayed, ending in a sync."""

from harness import span_ms

LAYER = "WHIR"
UNIT = "ms/proof"
SOURCE = "program_span"
MOVES = "prove_s"


def read(run):
    return span_ms(run, "prove_whir")
