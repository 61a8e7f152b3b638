"""Typed prover-side error taxonomy.

Peer of the reference's ``crates/stark-backend/src/prover/error.rs``: every
prover stage raises a stage-scoped exception type under a common
:class:`ProverError` root, so callers can match on the failing subsystem
(the reference's ``RefProverError`` enum) instead of parsing messages.
Proving is a synchronous call returning a result — errors are exceptions,
not recovery states (SURVEY §5: no checkpoint/elastic machinery to mirror).
"""

from __future__ import annotations


class ProverError(Exception):
    """Root of the prover-side error taxonomy (``RefProverError``)."""


class StackedPcsError(ProverError):
    """Stacked layout / Merkle tree / RS code errors (``StackedPcsError``)."""


class SumcheckError(ProverError):
    """Sumcheck engine input-shape errors (``SumcheckError``)."""


class LogupZerocheckError(ProverError):
    """GKR + batch-constraint stage errors (``LogupZerocheckError``)."""


class StackedReductionError(ProverError):
    """Stacked opening reduction errors (``StackedReductionError``)."""


class WhirProverError(ProverError):
    """WHIR opening prover errors (``WhirProverError``)."""
