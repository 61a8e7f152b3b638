"""Proving/verifying key generation.

Mirrors the reference keygen flow (``crates/stark-backend/src/keygen/``):
per-AIR symbolic constraint extraction into a deduplicated DAG, preprocessed
trace commitment through the stacked PCS, synthesis + minimization of
trace-height linear constraints from interaction count-weights, and a
weak-Fiat-Shamir-protecting pre-hash binding the whole verifying key.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .air import Air
from .fields.babybear import P
from .hash.poseidon2 import hash_slice_np
from .params import SystemParams
from .symbolic import ConstraintsDag, SymbolicAirBuilder


@dataclass
class TraceWidth:
    preprocessed: Optional[int]
    cached_mains: List[int]
    common_main: int

    def main_widths(self) -> List[int]:
        out = list(self.cached_mains)
        if self.common_main != 0:
            out.append(self.common_main)
        return out

    def main_width(self) -> int:
        return sum(self.cached_mains) + self.common_main

    def total_width(self) -> int:
        return (self.preprocessed or 0) + self.main_width()


@dataclass
class LinearConstraint:
    """sum_i coefficients[i] * lifted_height_i < threshold."""

    coefficients: List[int]
    threshold: int

    def is_implied_by(self, other: "LinearConstraint") -> bool:
        return self.threshold >= other.threshold and all(
            a <= b for a, b in zip(self.coefficients, other.coefficients)
        )


@dataclass
class VerifierPreprocessedData:
    commit: np.ndarray  # digest (8,) canonical
    hypercube_dim: int  # log_height - l_skip (may be negative)
    stacking_width: int


@dataclass
class StarkVerifyingParams:
    width: TraceWidth
    num_public_values: int
    need_rot: bool


@dataclass
class StarkVerifyingKey:
    preprocessed_data: Optional[VerifierPreprocessedData]
    params: StarkVerifyingParams
    symbolic_constraints: ConstraintsDag
    max_constraint_degree: int
    is_required: bool
    # ("preprocessed"|"main", part, offset, index) per variable never
    # referenced by any constraint/interaction (keygen/types.rs:128
    # `unused_variables`); offset 1 entries only appear when need_rot.
    unused_variables: List[Tuple[str, int, int, int]] = field(default_factory=list)

    def num_parts(self) -> int:
        return (
            1
            + (1 if self.preprocessed_data is not None else 0)
            + len(self.params.width.cached_mains)
        )


@dataclass
class MultiStarkVerifyingKey:
    params: SystemParams
    per_air: List[StarkVerifyingKey]
    trace_height_constraints: List[LinearConstraint]
    pre_hash: np.ndarray  # digest (8,)


@dataclass
class StarkProvingKey:
    air_name: str
    vk: StarkVerifyingKey
    # preprocessed committed data (set at transport; backend-specific type)
    preprocessed_data: Optional[object]


@dataclass
class MultiStarkProvingKey:
    params: SystemParams
    per_air: List[StarkProvingKey]
    trace_height_constraints: List[LinearConstraint]
    max_constraint_degree: int
    vk_pre_hash: np.ndarray

    def get_vk(self) -> MultiStarkVerifyingKey:
        return MultiStarkVerifyingKey(
            params=self.params,
            per_air=[pk.vk for pk in self.per_air],
            trace_height_constraints=self.trace_height_constraints,
            pre_hash=self.vk_pre_hash,
        )


class KeygenError(Exception):
    pass


# ---------------------------------------------------------------------------


def _air_widths(air: Air) -> TraceWidth:
    prep = air.preprocessed_trace()
    return TraceWidth(
        preprocessed=None if prep is None else int(prep.shape[1]),
        cached_mains=list(air.cached_main_widths()),
        common_main=air.common_main_width(),
    )


def run_symbolic(air: Air, width: TraceWidth) -> SymbolicAirBuilder:
    builder = SymbolicAirBuilder(
        preprocessed_width=width.preprocessed,
        cached_widths=width.cached_mains,
        common_width=width.common_main,
        num_public_values=air.num_public_values(),
    )
    air.eval(builder)
    return builder


def keygen_air(
    air: Air, params: SystemParams, is_required: bool
) -> Tuple[StarkVerifyingKey, Optional[np.ndarray]]:
    """Returns (vk, preprocessed trace or None). The preprocessed commitment
    is computed by the caller (backend-specific device commit)."""
    width = _air_widths(air)
    if width.main_width() == 0:
        raise KeygenError(f"AIR {air.name()} has zero main trace width")
    builder = run_symbolic(air, width)
    if not builder.constraints and not builder.interactions:
        raise KeygenError(
            f"AIR {air.name()} must have at least one constraint or interaction"
        )
    for i, it in enumerate(builder.interactions):
        if len(it.message) == 0:
            raise KeygenError(f"AIR {air.name()} interaction {i} has empty message")
        if len(it.message) + 1 > params.logup.max_message_length():
            raise KeygenError(
                f"AIR {air.name()} interaction {i} message too long"
            )
    dag = builder.build_dag()
    degree = dag.max_constraint_degree()
    if degree > params.max_constraint_degree:
        raise KeygenError(
            f"AIR {air.name()} constraint degree {degree} exceeds "
            f"{params.max_constraint_degree}"
        )
    max_rot = dag.max_rotation()
    assert max_rot <= 1, "only rotations by one row are supported"
    need_rot = max_rot == 1
    vk = StarkVerifyingKey(
        preprocessed_data=None,  # filled by caller if preprocessed
        params=StarkVerifyingParams(
            width=width,
            num_public_values=air.num_public_values(),
            need_rot=need_rot,
        ),
        symbolic_constraints=dag,
        max_constraint_degree=degree,
        is_required=is_required,
        unused_variables=_unused_vars_of_dag(dag, width, need_rot),
    )
    return vk, air.preprocessed_trace()


def synthesize_trace_height_constraints(
    vks: Sequence[StarkVerifyingKey], params: SystemParams
) -> List[LinearConstraint]:
    num_airs = len(vks)
    per_bus = {}
    num_interactions = []
    for air_idx, vk in enumerate(vks):
        interactions = vk.symbolic_constraints.interactions
        num_interactions.append(len(interactions))
        for it in interactions:
            c = per_bus.setdefault(
                it.bus_index, LinearConstraint([0] * num_airs, P)
            )
            c.coefficients[air_idx] += it.count_weight
    all_constraints = [per_bus[b] for b in sorted(per_bus)]
    all_constraints.append(
        LinearConstraint(num_interactions, params.logup.max_interaction_count)
    )
    minimized: List[LinearConstraint] = []
    for c in all_constraints:
        if any(c.is_implied_by(m) for m in minimized):
            continue
        minimized = [m for m in minimized if not m.is_implied_by(c)] + [c]
    return minimized


def compute_vk_pre_hash(
    params: SystemParams,
    vks: Sequence[StarkVerifyingKey],
    constraints: Sequence[LinearConstraint],
    pre_hasher=None,
) -> np.ndarray:
    """Reference-parity weak-FS pre-hash (``keygen/mod.rs:198-216``):
    hash_slice over the bytes of ``CODEC_VERSION (4 LE) ++ u64 LE length ++
    postcard(pre_vk)``, each byte lifted to a field element. ``pre_hasher``
    overrides the hash for the outer BN254 scheme
    (``hasher.rs`` MultiFieldHasher path)."""
    from .postcard_vk import versioned_pre_vk_bytes

    data = versioned_pre_vk_bytes(params, vks, constraints)
    elems = np.frombuffer(data, dtype=np.uint8).astype(np.uint64)
    if pre_hasher is not None:
        return pre_hasher(elems)
    return _memo_hash(data, elems)


# A directory where pre-hashes are kept by the sha256 of the bytes they hash
# (None: always hash). The sponge over a large AIR's pre-vk bytes is
# sequential, tens of thousands of numpy permutations (~20 s for the
# Keccak-f AIR's), so a run takes it from the first run in its checkout.
PRE_HASH_DIR = None


def _memo_hash(data: bytes, elems: np.ndarray) -> np.ndarray:
    import hashlib
    import json
    import os

    if PRE_HASH_DIR is None:
        return hash_slice_np(elems)
    path = os.path.join(PRE_HASH_DIR, f"pre_hash-{hashlib.sha256(data).hexdigest()}.json")
    if os.path.isfile(path):
        with open(path) as f:
            return np.array(json.load(f), dtype=np.uint64)
    digest = hash_slice_np(elems)
    os.makedirs(PRE_HASH_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "w") as f:
        json.dump([int(v) for v in digest], f)
    os.replace(tmp, path)
    return digest


class MultiStarkKeygenBuilder:
    """Collects AIRs, then generates the multi-STARK pk/vk pair.

    The ``committer`` callable commits a preprocessed trace on the backend:
    (trace (h, w) canonical numpy) -> (commit digest, prover data object,
    stacking_width).
    """

    def __init__(self, params: SystemParams, committer):
        self.params = params
        self.committer = committer
        self.pre_hasher = None  # hash-scheme hook (swirl/hash/scheme.py)
        self._airs: List[Tuple[Air, bool]] = []

    def add_air(self, air: Air) -> int:
        self._airs.append((air, False))
        return len(self._airs) - 1

    def add_required_air(self, air: Air) -> int:
        self._airs.append((air, True))
        return len(self._airs) - 1

    def generate_pk(self) -> MultiStarkProvingKey:
        per_air: List[StarkProvingKey] = []
        for air, is_required in self._airs:
            vk, prep_trace = keygen_air(air, self.params, is_required)
            prep_data = None
            if prep_trace is not None:
                h = int(prep_trace.shape[0])
                assert h & (h - 1) == 0 and h > 0
                commit, data, stacking_width = self.committer(prep_trace)
                vk.preprocessed_data = VerifierPreprocessedData(
                    commit=commit,
                    hypercube_dim=h.bit_length() - 1 - self.params.l_skip,
                    stacking_width=stacking_width,
                )
                prep_data = data
            per_air.append(
                StarkProvingKey(air_name=air.name(), vk=vk, preprocessed_data=prep_data)
            )
        vks = [pk.vk for pk in per_air]
        constraints = synthesize_trace_height_constraints(vks, self.params)
        pre_hash = compute_vk_pre_hash(
            self.params, vks, constraints, pre_hasher=self.pre_hasher
        )
        return MultiStarkProvingKey(
            params=self.params,
            per_air=per_air,
            trace_height_constraints=constraints,
            max_constraint_degree=self.params.max_constraint_degree,
            vk_pre_hash=pre_hash,
        )


def _unused_vars_of_dag(
    dag: ConstraintsDag, width: TraceWidth, need_rot: bool
) -> List[Tuple[str, int, int, int]]:
    """Variables never referenced at a given (entry, part, offset, index).

    Exact peer of the reference ``find_unused_vars`` (``keygen/mod.rs:371``):
    usage is tracked per rotation offset (0 = local row, 1 = next row), and
    offset-1 entries are only reported when the AIR uses rotations at all
    (need_rot). Emission order matches the reference: preprocessed by
    (index, offset), then main by (part, index, offset).
    """
    used = set()
    for n in dag.nodes:
        if n[0] == "var" and n[1] in ("preprocessed", "main"):
            used.add((n[1], n[2], n[3], n[4]))  # (entry, part, offset, index)
    unused: List[Tuple[str, int, int, int]] = []
    for i in range(width.preprocessed or 0):
        for off in range(2):
            if ("preprocessed", 0, off, i) not in used and (off == 0 or need_rot):
                unused.append(("preprocessed", 0, off, i))
    for part, w in enumerate(width.main_widths()):
        for i in range(w):
            for off in range(2):
                if ("main", part, off, i) not in used and (off == 0 or need_rot):
                    unused.append(("main", part, off, i))
    return unused


def find_unused_vars(air: Air) -> List[Tuple[str, int, int, int]]:
    """Trace cells never referenced by any constraint or interaction, as
    (entry, part, offset, index) — see :func:`_unused_vars_of_dag`."""
    width = _air_widths(air)
    builder = run_symbolic(air, width)
    dag = builder.build_dag()
    max_rot = dag.max_rotation()
    return _unused_vars_of_dag(dag, width, max_rot == 1)
