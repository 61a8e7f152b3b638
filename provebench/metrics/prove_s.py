"""Seconds a proof: the window's first proof's start to its last proof's
end (the last that started inside ``--seconds``), over those proofs. It
holds each trace's making and hand-over, the replay, the one fetch and the
host's build of the ``Proof``."""

UNIT = "s/proof"
SOURCE = "host_clock"


def read(run):
    return run.window_s / run.proofs if run.proofs else None
