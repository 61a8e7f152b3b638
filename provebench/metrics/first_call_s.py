"""Seconds of set-up's first ``prove_fused`` call of the cell's shape, ending
in a synchronize: eager warm-up, capture, instantiation and one replay
(``FusedGraphs.stats`` splits it on an earlier line)."""

LAYER = "fused prover"
UNIT = "s"
SOURCE = "host_clock"
MOVES = "setup_s"


def read(run):
    return run.first_call_s
