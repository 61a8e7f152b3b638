"""Proof extraction from a pure Fiat-Shamir transcript stream.

Peer of the reference's ``verifier/transcript_extractor.rs``: given the
verifying key, the per-AIR trace metadata, and a recorded transcript event
log (``Transcript(record=True)``), reconstruct every transcript-borne proof
field — commitments, GKR claims and round polys, batch-constraint coeffs,
column openings, stacking openings, WHIR commits/OOD values/final poly —
without ever touching a ``Proof`` object. This is the recursion-facing
capability: a recursive verifier receives the FS stream as witness and
re-derives the proof content from it; only the Merkle query openings (which
are checked against commitments, not absorbed) travel separately.

The walk mirrors the verifier's observe/sample order exactly
(``verifier/__init__.py`` preamble, ``gkr.py``, ``batch_constraints.py``,
``stacked_reduction.py``, ``whir.py``) with all counts derived from shapes
(vk widths, trace log-heights, SystemParams) — the same derivations as
``proof_shape.verify_proof_shape``.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from ..fields.babybear import P
from ..keygen import MultiStarkVerifyingKey
from ..params import calculate_n_logup
from ..proof import (
    BatchConstraintProof,
    GkrLayerClaims,
    GkrProof,
    Proof,
    StackingProof,
    TraceVData,
    WhirProof,
)
from .proof_shape import ProofShapeError
from ..prover.stacked_pcs import StackedLayout


class ExtractionError(Exception):
    """Base of the typed extraction taxonomy (peer of the reference's
    ``TranscriptExtractionError`` enum, ``transcript_extractor.rs:46-66``).
    Variants carry structured fields and compare by value, like the
    verifier's :mod:`.errors` tree."""

    def __init__(self, **fields):
        self.fields = fields
        super().__init__(
            f"{type(self).__name__}("
            + ", ".join(f"{k}={v!r}" for k, v in fields.items())
            + ")"
        )

    def __eq__(self, other):
        return type(self) is type(other) and self.fields == other.fields

    def __hash__(self):
        return hash((type(self), tuple(sorted(self.fields.items()))))


class StreamExhausted(ExtractionError):
    """The event log ended while the walk still expected entries."""

    def __init__(self, position: int, want: str):
        super().__init__(position=position, want=want)


class UnexpectedEntryKind(ExtractionError):
    """Log entry kind differs from the verifier's event at that position."""

    def __init__(self, position: int, expected: str, actual: str):
        super().__init__(position=position, expected=expected, actual=actual)


class ValueMismatch(ExtractionError):
    """A transcript-carried value disagrees with verifier-known context
    (vk pre-hash, presence flag, preprocessed commit, public value)."""

    def __init__(self, label: str, position: int | None = None):
        super().__init__(label=label, position=position)


class TrailingEntries(ExtractionError):
    """Reference ``TranscriptExtractionError::TrailingEntries``: the walk
    completed but the log has unconsumed events."""

    def __init__(self, position: int, remaining: int):
        super().__init__(position=position, remaining=remaining)


class _Stream:
    def __init__(self, log: Sequence):
        self.log = list(log)
        self.pos = 0

    def _next(self, kind: str) -> int:
        if self.pos >= len(self.log):
            raise StreamExhausted(position=self.pos, want=kind)
        k, v = self.log[self.pos]
        if k != kind:
            raise UnexpectedEntryKind(
                position=self.pos, expected=kind, actual=k
            )
        self.pos += 1
        return v

    def observe(self) -> int:
        return self._next("observe")

    def sample(self) -> int:
        return self._next("sample")

    def ef(self) -> np.ndarray:
        return np.array([self.observe() for _ in range(4)], dtype=np.uint64)

    def digest(self) -> np.ndarray:
        return np.array([self.observe() for _ in range(8)], dtype=np.uint64)

    def sample_ext(self) -> None:
        for _ in range(4):
            self.sample()

    def pow_check(self, bits: int) -> int:
        """check_witness: one observed witness + one sample (when bits>0)."""
        if bits == 0:
            return 0
        w = self.observe()
        self.sample()
        return w

    def done(self) -> bool:
        return self.pos == len(self.log)


def whir_hints_from_proof(proof: Proof) -> "WhirProofHints":
    """The Merkle-bound WHIR objects of an existing proof, for splicing into
    an extraction (reference ``WhirProofHints::from``)."""
    w = proof.whir_proof
    return WhirProofHints(
        initial_round_opened_rows=w.initial_round_opened_rows,
        initial_round_merkle_proofs=w.initial_round_merkle_proofs,
        codeword_opened_values=w.codeword_opened_values,
        codeword_merkle_proofs=w.codeword_merkle_proofs,
    )


class WhirProofHints:
    """Out-of-band hints completing an extracted proof (peer of reference
    ``transcript_extractor.rs:118``). The WHIR transcript does not observe
    query openings or Merkle authentication paths — they are bound by the
    Merkle roots and the sampled indices instead (a different accepted
    opening would imply a hash collision or Merkle equivocation) — so
    extraction takes them out-of-band; with hints supplied, the extracted
    proof passes the FULL verifier."""

    __slots__ = (
        "initial_round_opened_rows",
        "initial_round_merkle_proofs",
        "codeword_opened_values",
        "codeword_merkle_proofs",
    )

    def __init__(
        self,
        initial_round_opened_rows,
        initial_round_merkle_proofs,
        codeword_opened_values,
        codeword_merkle_proofs,
    ):
        self.initial_round_opened_rows = initial_round_opened_rows
        self.initial_round_merkle_proofs = initial_round_merkle_proofs
        self.codeword_opened_values = codeword_opened_values
        self.codeword_merkle_proofs = codeword_merkle_proofs


def extract_proof_from_transcript(
    mvk: MultiStarkVerifyingKey,
    trace_vdata: List[Optional[TraceVData]],
    public_values: List[List[int]],
    log: Sequence,
    whir_hints: Optional[WhirProofHints] = None,
) -> Proof:
    """Rebuild the transcript-borne proof content from a recorded verifier
    (or prover) event log. Query-opening fields are left empty unless
    `whir_hints` supplies the Merkle-bound objects."""
    params = mvk.params
    l_skip = params.l_skip
    s = _Stream(log)

    # ---- preamble (verifier/__init__.py:70-92) ---------------------------
    pre_hash = s.digest()
    if not np.array_equal(pre_hash, np.asarray(mvk.pre_hash, dtype=np.uint64)):
        raise ValueMismatch("vk pre-hash", position=s.pos)
    common_main_commit = s.digest()
    num_airs = len(mvk.per_air)
    out_vdata: List[Optional[TraceVData]] = [None] * num_airs
    for air_id, avk in enumerate(mvk.per_air):
        vdata = trace_vdata[air_id]
        if not avk.is_required:
            flag = s.observe()
            if flag != (1 if vdata is not None else 0):
                raise ValueMismatch(f"AIR {air_id} presence flag", position=s.pos)
        if vdata is not None:
            cached = []
            if avk.preprocessed_data is not None:
                prep_commit = s.digest()
                if not np.array_equal(
                    prep_commit,
                    np.asarray(avk.preprocessed_data.commit, np.uint64),
                ):
                    raise ValueMismatch("preprocessed commit", position=s.pos)
                log_height = vdata.log_height
            else:
                log_height = s.observe()
            for _ in vdata.cached_commitments:
                cached.append(s.digest())
            out_vdata[air_id] = TraceVData(
                log_height=log_height, cached_commitments=cached
            )
        for pv in public_values[air_id]:
            if s.observe() != pv % P:
                raise ValueMismatch(f"AIR {air_id} public value", position=s.pos)

    trace_id_to_air_id = sorted(
        (a for a in range(num_airs) if trace_vdata[a] is not None),
        key=lambda a: (-trace_vdata[a].log_height, a),
    )
    num_traces = len(trace_id_to_air_id)
    n_per_trace = [
        trace_vdata[a].log_height - l_skip for a in trace_id_to_air_id
    ]

    # ---- GKR + batch constraints (batch_constraints.py / gkr.py) ---------
    logup_pow_witness = s.pow_check(params.logup.pow_bits)
    s.sample_ext()  # alpha
    s.sample_ext()  # beta

    total_interactions = 0
    for t_idx, air_id in enumerate(trace_id_to_air_id):
        n_lift = max(n_per_trace[t_idx], 0)
        num_int = len(mvk.per_air[air_id].symbolic_constraints.interactions)
        total_interactions += num_int << (l_skip + n_lift)
    n_logup = calculate_n_logup(l_skip, total_interactions)

    q0_claim = np.array([1, 0, 0, 0], dtype=np.uint64)
    claims_per_layer: List[GkrLayerClaims] = []
    sumcheck_polys: List[List[List[np.ndarray]]] = []
    xi_len = 0
    if total_interactions > 0:
        total_rounds = l_skip + n_logup
        q0_claim = s.ef()
        claims_per_layer.append(
            GkrLayerClaims(
                p_xi_0=s.ef(), q_xi_0=s.ef(), p_xi_1=s.ef(), q_xi_1=s.ef()
            )
        )
        s.sample_ext()  # mu_1
        for rnd in range(1, total_rounds):
            s.sample_ext()  # lam
            round_polys = []
            for _ in range(rnd):
                evals = [s.ef(), s.ef(), s.ef()]
                s.sample_ext()  # r_sub
                round_polys.append(evals)
            sumcheck_polys.append(round_polys)
            claims_per_layer.append(
                GkrLayerClaims(
                    p_xi_0=s.ef(), q_xi_0=s.ef(), p_xi_1=s.ef(), q_xi_1=s.ef()
                )
            )
            s.sample_ext()  # mu
        xi_len = total_rounds
    if not n_per_trace:
        raise ValueMismatch("no traces (all trace_vdata None)")
    n_max = max(max(n_per_trace), 0)
    n_global = max(n_max, n_logup)
    for _ in range(l_skip + n_global - xi_len):
        s.sample_ext()  # xi extension
    s.sample_ext()  # lam

    numerator_term_per_air = []
    denominator_term_per_air = []
    for _ in range(num_traces):
        numerator_term_per_air.append(s.ef())
        denominator_term_per_air.append(s.ef())
    s.sample_ext()  # mu

    s_deg = params.max_constraint_degree + 1
    uni_len = s_deg * ((1 << l_skip) - 1) + 1
    univariate_round_coeffs = [s.ef() for _ in range(uni_len)]
    s.sample_ext()  # r0
    sumcheck_round_polys = []
    for _ in range(n_max):
        sumcheck_round_polys.append([s.ef() for _ in range(s_deg)])
        s.sample_ext()

    # column openings: all common-main parts first, then per-trace others
    def take_part(width: int, need_rot: bool) -> List[np.ndarray]:
        flat = []
        for _ in range(width):
            claim = s.ef()
            claim_rot = s.ef()
            if need_rot:
                flat.extend([claim, claim_rot])
            else:
                flat.append(claim)
        return flat

    column_openings: List[List[List[np.ndarray]]] = []
    for air_id in trace_id_to_air_id:
        avk = mvk.per_air[air_id]
        column_openings.append(
            [take_part(avk.params.width.common_main, avk.params.need_rot)]
        )
    for t_idx, air_id in enumerate(trace_id_to_air_id):
        avk = mvk.per_air[air_id]
        widths = (
            [avk.params.width.preprocessed] if avk.preprocessed_data else []
        ) + list(avk.params.width.cached_mains)
        for w in widths:
            column_openings[t_idx].append(take_part(w, avk.params.need_rot))

    # ---- stacked reduction (stacked_reduction.py) ------------------------
    s.sample_ext()  # lam
    stack_uni_len = 2 * ((1 << l_skip) - 1) + 1
    stacking_uni = [s.ef() for _ in range(stack_uni_len)]
    s.sample_ext()  # u0
    stacking_rounds = []
    for _ in range(params.n_stack):
        stacking_rounds.append([s.ef(), s.ef()])
        s.sample_ext()

    common_dims = []
    for a in trace_id_to_air_id:
        common_dims.append(
            (mvk.per_air[a].params.width.common_main, trace_vdata[a].log_height)
        )
    try:
        layouts = [
            StackedLayout.new(l_skip, params.log_stacked_height, common_dims)
        ]
        for a in trace_id_to_air_id:
            avk = mvk.per_air[a]
            lh = trace_vdata[a].log_height
            if avk.preprocessed_data is not None:
                layouts.append(
                    StackedLayout.new(
                        l_skip,
                        params.log_stacked_height,
                        [(avk.params.width.preprocessed, lh)],
                    )
                )
            for cw in avk.params.width.cached_mains:
                layouts.append(
                    StackedLayout.new(l_skip, params.log_stacked_height, [(cw, lh)])
                )
    except ValueError as e:  # pragma: no cover
        raise ProofShapeError(str(e))
    stacking_openings = [
        [s.ef() for _ in range(layout.width)] for layout in layouts
    ]

    # ---- WHIR (whir.py) ---------------------------------------------------
    whir = params.whir
    k = whir.k
    num_rounds = params.num_whir_rounds()
    mu_pow_witness = s.pow_check(whir.mu_pow_bits)
    s.sample_ext()  # mu
    whir_sumcheck_polys = []
    codeword_commits = []
    ood_values = []
    folding_pow_witnesses = []
    query_phase_pow_witnesses = []
    final_poly = []
    for whir_round in range(num_rounds):
        is_last = whir_round == num_rounds - 1
        for _ in range(k):
            whir_sumcheck_polys.append([s.ef(), s.ef()])
            folding_pow_witnesses.append(s.pow_check(whir.folding_pow_bits))
            s.sample_ext()  # alpha
        if not is_last:
            codeword_commits.append(s.digest())
            s.sample_ext()  # z0
            ood_values.append(s.ef())
        else:
            final_poly = [
                s.ef() for _ in range(1 << params.log_final_poly_len())
            ]
        query_phase_pow_witnesses.append(s.pow_check(whir.query_phase_pow_bits))
        for _ in range(whir.rounds[whir_round].num_queries):
            s.sample()  # sample_bits
        s.sample_ext()  # gamma

    if not s.done():
        raise TrailingEntries(position=s.pos, remaining=len(s.log) - s.pos)

    return Proof(
        common_main_commit=common_main_commit,
        trace_vdata=out_vdata,
        public_values=public_values,
        gkr_proof=GkrProof(
            logup_pow_witness=logup_pow_witness,
            q0_claim=q0_claim,
            claims_per_layer=claims_per_layer,
            sumcheck_polys=sumcheck_polys,
        ),
        batch_constraint_proof=BatchConstraintProof(
            numerator_term_per_air=numerator_term_per_air,
            denominator_term_per_air=denominator_term_per_air,
            univariate_round_coeffs=univariate_round_coeffs,
            sumcheck_round_polys=sumcheck_round_polys,
            column_openings=column_openings,
        ),
        stacking_proof=StackingProof(
            univariate_round_coeffs=stacking_uni,
            sumcheck_round_polys=stacking_rounds,
            stacking_openings=stacking_openings,
        ),
        whir_proof=WhirProof(
            mu_pow_witness=mu_pow_witness,
            whir_sumcheck_polys=whir_sumcheck_polys,
            codeword_commits=codeword_commits,
            ood_values=ood_values,
            folding_pow_witnesses=folding_pow_witnesses,
            query_phase_pow_witnesses=query_phase_pow_witnesses,
            initial_round_opened_rows=(
                whir_hints.initial_round_opened_rows
                if whir_hints is not None
                else [[] for _ in layouts]
            ),
            initial_round_merkle_proofs=(
                whir_hints.initial_round_merkle_proofs
                if whir_hints is not None
                else [[] for _ in layouts]
            ),
            codeword_opened_values=(
                whir_hints.codeword_opened_values
                if whir_hints is not None
                else []
            ),
            codeword_merkle_proofs=(
                whir_hints.codeword_merkle_proofs
                if whir_hints is not None
                else []
            ),
            final_poly=final_poly,
        ),
    )
