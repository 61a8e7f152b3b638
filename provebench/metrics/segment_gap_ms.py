"""ms a proof in which the card is between segments over the window: the
program's timing ``segments.gap.device``, the first segment's start event to
the last one's end, less the five segments' device times. It is the card's
wait for the host's sync after a segment and the next graph's launch."""

from harness import span_ms

LAYER = "fused prover"
UNIT = "ms/proof"
SOURCE = "program_span"
MOVES = "prove_s"


def read(run):
    return span_ms(run, "segments.gap.device")
