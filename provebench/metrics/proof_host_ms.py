"""ms a proof of the host's own work around the replay over the window: the
program's spans ``fused.refresh`` (the trace copied into the graphs'
inputs), ``proof_fetch`` (the one copy of the proof's values) and
``proof_build`` (the ``Proof`` built from them). Nothing when the run saw
any of the three missing."""

from harness import span_ms

LAYER = "fused prover"
UNIT = "ms/proof"
SOURCE = "program_span"
MOVES = "prove_s"
SPANS = ("fused.refresh", "proof_fetch", "proof_build")


def read(run):
    parts = [span_ms(run, name) for name in SPANS]
    return None if None in parts else sum(parts)
