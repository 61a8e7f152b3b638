"""ms a proof of the card's time in Merkle builds over the window: the
program's timing ``pcs.merkle.device``, the sum over a proof of every
Merkle build's interval (the main commit's tree and each WHIR round's
codeword tree: kernels B, C and D), each between CUDA events of its own
that the segment's graph records on every replay."""

from harness import span_ms

LAYER = "kernels"
UNIT = "ms/proof"
SOURCE = "program_span"
MOVES = "prove_s"


def read(run):
    return span_ms(run, "pcs.merkle.device")
