"""ms a proof in the program's span ``prover.main_trace_commit`` over the
window: the stacked commit's graph replayed, ending in a sync."""

from harness import span_ms

LAYER = "stacked commit"
UNIT = "ms/proof"
SOURCE = "program_span"
MOVES = "prove_s"


def read(run):
    return span_ms(run, "prover.main_trace_commit")
