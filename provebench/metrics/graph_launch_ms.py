"""ms a proof of the host's graph launches over the window: the program's
span ``fused.launch`` around each ``CUDAGraph.replay()`` call, summed over a
proof's graphs."""

from harness import span_ms

LAYER = "fused prover"
UNIT = "ms/proof"
SOURCE = "program_span"
MOVES = "prove_s"


def read(run):
    return span_ms(run, "fused.launch")
