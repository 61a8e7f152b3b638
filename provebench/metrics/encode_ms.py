"""ms a proof of the card's time in RS encodes over the window: the
program's timing ``pcs.encode.device``, the sum over a proof of every RS
encode's interval (the main commit's and each WHIR round's codeword: the
chunk iDFTs, the padding and kernel A or A′), each between CUDA events of
its own that the segment's graph records on every replay."""

from harness import span_ms

LAYER = "kernels"
UNIT = "ms/proof"
SOURCE = "program_span"
MOVES = "prove_s"


def read(run):
    return span_ms(run, "pcs.encode.device")
