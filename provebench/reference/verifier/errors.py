"""Typed verifier error taxonomy.

Python-idiomatic peer of the reference's per-stage ``thiserror`` enums
(``crates/stark-backend/src/verifier/mod.rs:20``,
``verifier/proof_shape.rs:12-190``, ``verifier/batch_constraints.rs:25``,
``verifier/fractional_sumcheck_gkr.rs:12``, ``verifier/stacked_reduction.rs:19``,
``verifier/whir.rs:324``): each failure mode is its OWN exception class with
structured fields, a reference-parity message template, and value equality —
so callers (and tests) can match on the exact variant and inspect
expected/actual without parsing strings.

Class hierarchy: ``VerifierError`` is the root; one abstract base per stage
(``ProofShapeError``, ``GkrError``, ``BatchConstraintError``,
``StackedReductionError``, ``WhirError``) mirrors the reference's
``#[from]`` nesting — catching the stage base catches every variant of that
stage, catching ``VerifierError`` catches everything.
"""

from __future__ import annotations


class VerifierError(Exception):
    """Root of the verifier error taxonomy.

    Subclasses set ``template`` (a ``str.format`` string over their keyword
    fields). Instances compare equal iff they are the same variant with the
    same fields — the Python analog of the reference enums' ``PartialEq``.
    Plain-string construction (``VerifierError("msg")``) is still accepted
    for ad-hoc sites.
    """

    template: str = ""

    def __init__(self, *args, **fields):
        self.fields = fields
        if self.template and fields:
            msg = self.template.format(**fields)
        elif args:
            msg = args[0]
        else:
            msg = self.template or self.__class__.__name__
        super().__init__(msg)

    def __eq__(self, other):
        return type(self) is type(other) and self.args == other.args

    def __hash__(self):
        return hash((type(self), self.args))


# ---------------------------------------------------------------------------
# Top-level verification failures (verifier/mod.rs:20-45)


class SystemParamsMismatch(VerifierError):
    template = "system params mismatch between proof context and verifying key"


class EmptyTraces(VerifierError):
    template = "proof has no traces"


class TraceHeightsTooLarge(VerifierError):
    template = (
        "trace heights violate linear constraint {constraint_idx}: "
        "{total} >= threshold {threshold}"
    )


class PreprocessedTraceHeightMismatch(VerifierError):
    template = (
        "AIR {air_idx}: preprocessed hypercube dim + l_skip = {expected} "
        "but trace log_height = {actual}"
    )


# ---------------------------------------------------------------------------
# Proof shape (verifier/proof_shape.rs:12-190)


class ProofShapeError(VerifierError):
    """Base for structural (pre-indexing) proof-shape failures."""


class VDataLengthMismatch(ProofShapeError):
    template = (
        "proof trace_vdata length ({len}) does not match number of AIRs "
        "({num_airs})"
    )


class PublicValuesLengthMismatch(ProofShapeError):
    template = (
        "proof public_values length ({len}) does not match number of AIRs "
        "({num_airs})"
    )


class RequiredAirNoVData(ProofShapeError):
    template = "AIR {air_idx} is required, but trace_vdata[{air_idx}] is None"


class PublicValuesNoVData(ProofShapeError):
    template = (
        "AIR {air_idx} has no TraceVData, but a non-zero amount of public "
        "values"
    )


class CachedCommitmentsMismatch(ProofShapeError):
    template = (
        "TraceVData for AIR {air_idx} should have {expected} cached "
        "commitments, but has {actual}"
    )


class LogHeightOutOfBounds(ProofShapeError):
    template = (
        "AIR {air_idx} should have log_height <= l_skip + n_stack = {bound}, "
        "but has {actual}"
    )


class PublicValuesCountMismatch(ProofShapeError):
    template = (
        "AIR {air_idx} should have {expected} public values, but has {actual}"
    )


class StackingLayoutInvalid(ProofShapeError):
    template = "stacking layout construction failed: {reason}"


class TotalStackedWidthOutOfBounds(ProofShapeError):
    template = (
        "total stacked width across commits ({actual}) exceeds w_stack "
        "({w_stack})"
    )


class GkrShapeMismatch(ProofShapeError):
    template = (
        "GKR proof shape: {what} should have {expected} entries, but has "
        "{actual}"
    )


class BatchShapeMismatch(ProofShapeError):
    template = (
        "batch constraint proof shape: {what} should have {expected} "
        "entries, but has {actual}"
    )


class ColumnOpeningsMismatch(ProofShapeError):
    template = (
        "column openings for trace {trace_idx} ({what}) should have "
        "{expected} entries, but has {actual}"
    )


class StackingShapeMismatch(ProofShapeError):
    template = (
        "stacking proof shape: {what} should have {expected} entries, but "
        "has {actual}"
    )


class WhirShapeMismatch(ProofShapeError):
    template = (
        "WHIR proof shape: {what} should have {expected} entries, but has "
        "{actual}"
    )


class ElementShapeMismatch(ProofShapeError):
    template = "{context}: expected array shape {expected}, got {actual}"


class NonCanonicalElement(ProofShapeError):
    template = "{context}: non-canonical field element (dtype or limb >= P)"


# ---------------------------------------------------------------------------
# GKR fractional-sumcheck verification (verifier/fractional_sumcheck_gkr.rs:12)


class GkrError(VerifierError):
    """Base for GKR fractional-sumcheck verification failures."""


class GkrInvalidZeroRoundValue(GkrError):
    template = "zero-round proof: q0_claim should be 1"


class GkrZeroCheckFailed(GkrError):
    template = "zero-check failed: numerator at root should be zero"


class GkrRootConsistencyFailed(GkrError):
    template = "denominator consistency check failed at root"


class GkrLayerConsistencyFailed(GkrError):
    template = "layer consistency check failed at round {round}"


class GkrIncorrectLayerCount(GkrError):
    template = "expected {expected} GKR layers, got {actual}"


class GkrIncorrectSumcheckPolyCount(GkrError):
    template = "expected {expected} GKR sumcheck polynomial groups, got {actual}"


class GkrIncorrectSubroundCount(GkrError):
    template = "GKR round {round} expected {expected} sub-rounds, got {actual}"


# ---------------------------------------------------------------------------
# Batch constraints (verifier/batch_constraints.rs:25)


class BatchConstraintError(VerifierError):
    """Base for batched zerocheck+LogUp verification failures."""


class InvalidLogupPowWitness(BatchConstraintError):
    template = "invalid logup_pow_witness"


class GkrQ0NotOne(BatchConstraintError):
    template = "q0 claim should be one with no interactions"


class GkrNumeratorMismatch(BatchConstraintError):
    template = "GKR numerator evaluation claim does not match"


class GkrDenominatorMismatch(BatchConstraintError):
    template = "GKR denominator evaluation claim does not match"


class SumClaimMismatch(BatchConstraintError):
    template = "sum claim mismatch at sumcheck round {round}"


class InconsistentClaims(BatchConstraintError):
    template = "final batch-constraint claims are inconsistent"


class RoundPolyEvalCountMismatch(BatchConstraintError):
    template = (
        "round {round} poly should have {expected} evaluations, got {actual}"
    )


class UnivariateCoeffCountMismatch(BatchConstraintError):
    template = "expected {expected} univariate round coeffs, got {actual}"


# ---------------------------------------------------------------------------
# Stacked reduction (verifier/stacked_reduction.rs:19)


class StackedReductionError(VerifierError):
    """Base for stacked-opening-reduction verification failures."""


class S0Mismatch(StackedReductionError):
    template = "s_0 does not match s_0 polynomial evaluation sum"


class FinalSumMismatch(StackedReductionError):
    template = "s_n(u_n) does not match claimed q(u) sum"


# ---------------------------------------------------------------------------
# WHIR (verifier/whir.rs:324)


class WhirError(VerifierError):
    """Base for WHIR opening verification failures."""


class FinalPolyDegree(WhirError):
    template = "final polynomial has wrong degree"


class MuPoWInvalid(WhirError):
    template = "mu batching proof-of-work witness check failed"


class FoldingPoWInvalid(WhirError):
    template = "folding proof-of-work witness check failed (round {round})"


class QueryPhasePoWInvalid(WhirError):
    template = "query phase proof-of-work witness check failed (round {round})"


class FinalPolyConstraint(WhirError):
    """Raised when the final constrained-RS-code membership sum check fails.

    Per-query final-poly evaluation mismatches are folded into this same sum
    check (there is no separate per-query comparison), so this is the single
    terminal WHIR consistency error.
    """

    template = "final poly is not in the final constrained RS code"


class MerkleVerify(WhirError):
    template = "merkle verification failed ({context})"
