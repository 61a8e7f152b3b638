"""Device-memory estimates for proving: the segmentation planner.

The port's copy of ``swirl/memory_metering.py`` (the reference's
``memory_metering.rs``): callers use it to decide how much work fits in one
proof on one card. The formulas are the JAX package's, with the port's
buffer sizes, and with the port's own buffers where the per-span peaks on
the card (``chip_smoke.py``) showed them:

- main traces live on the device for the whole prove (int64 tensors, 8 B
  an element);
- each commitment caches the stacked matrix and the RS codeword matrix
  (the codeword backs WHIR's query openings), unless the
  :class:`~swirl_torch.prover.backend.ProverConfig` drops them;
- the batch-constraint phase holds folded EF part matrices (local + rotated)
  whose size is main_cells * D_EF / 2^l_skip per opening, plus the round-0
  coset-evaluation grid (num_cosets * lifted cells, base field, and the EF
  accumulator); a constraint DAG of at least ``VECTORIZE_THRESHOLD`` nodes
  runs through the level-scheduled interpreter, whose buffer holds
  ``max_live`` values a grid point next to the next level's buffer
  (``interpreter_values``);
- the GKR phase holds the full fraction-tree layer stack: 2x the input
  leaves, each leaf a (p, q) EF pair, and the first layer's sub-round
  (the eq table, the split columns, their values at X and the EF
  products' int64 temporaries: two more layers);
- WHIR first builds f from the stacked matrix's RS message and its zeta
  transform (4 copies of the stacked matrix at once), then holds f_evals
  and w_evals (2^m EF each), the first folded codeword three times (the
  NTT's coefficient planes in and out and the codeword) and its leaf
  digests, plus the trees;
- the commit (not in the JAX package's model, whose XLA program donates
  its buffers) holds the stacked matrix, the zero-padded RS message, the
  NTT's output and its scratch (three codeword matrices) and the leaf
  digests of the whole codeword (8 int64 words a row) at once; it can set
  the peak of a tall codeword with few columns (the leaf).

``ALLOCATOR_ALLOWANCE`` takes the place of the JAX package's XLA scratch
allowance: the caching allocator's rounding and the eager temporaries that
the formulas do not name (the chunked interpreter's operands, whatever a
stage keeps from the one before).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from .params import SystemParams

BASE_FIELD_SIZE = 8  # a canonical int64 tensor element
EXT_DEGREE = 4  # an EF4 element: 4 of them, 32 B
DIGEST_SIZE = 8 * BASE_FIELD_SIZE  # a Merkle layer is an (8, n) int64 tensor
# 1 GiB: above the largest residual of a stage's peak over its named
# buffers, 0.29 GB (the leaf's GKR span), in the per-span peaks of the app,
# leaf and Keccak proves on one NVIDIA H100 80GB HBM3 at 700 W
# (chip_smoke.py; PERF.md section 5)
ALLOCATOR_ALLOWANCE = 1 << 30


@dataclass
class ProvingMemoryCounts:
    main_cells_with_rot: int
    main_cells_without_rot: int
    interaction_cells: int
    # max_live x lifted height of the largest interpreted DAG (0 when every
    # DAG is evaluated node by node); see :func:`counts_for`
    interpreter_values: int = 0
    # the tallest trace's log height: the save-memory policy segments round
    # 0 only from 2^(l_skip + 13) rows (None: as if it did)
    max_log_height: Optional[int] = None

    @property
    def main_cells(self) -> int:
        return self.main_cells_with_rot + self.main_cells_without_rot


@dataclass
class ProvingMemoryEstimate:
    total: int
    main: int
    stacked_matrix: int
    rs_code_matrix: int
    batch_constraint: int
    gkr: int
    whir: int
    secondary_peak: int
    commit: int


@dataclass
class ProvingMemoryConfig:
    l_skip: int
    n_stack: int
    log_blowup: int
    k_whir: int
    max_constraint_degree: int
    cache_stacked_matrix: bool = True
    cache_rs_code_matrix: bool = True
    # chunked round-0 coset grids (8 segments); see ProverConfig
    zerocheck_save_memory: bool = False

    @staticmethod
    def from_params(
        params: SystemParams,
        cache_stacked_matrix: bool = True,
        cache_rs_code_matrix: bool = True,
        zerocheck_save_memory: bool = False,
    ) -> "ProvingMemoryConfig":
        return ProvingMemoryConfig(
            l_skip=params.l_skip,
            n_stack=params.n_stack,
            log_blowup=params.log_blowup,
            k_whir=params.k_whir,
            max_constraint_degree=params.max_constraint_degree,
            cache_stacked_matrix=cache_stacked_matrix,
            cache_rs_code_matrix=cache_rs_code_matrix,
            zerocheck_save_memory=zerocheck_save_memory,
        )

    @property
    def log_stacked_height(self) -> int:
        return self.l_skip + self.n_stack

    def main_memory_bytes(self, main_cells: int) -> int:
        return main_cells * BASE_FIELD_SIZE

    def _stacked_cells(self, main_cells: int) -> int:
        h = 1 << self.log_stacked_height
        return -(-main_cells // h) * h

    def stacked_matrix_memory_bytes(self, main_cells: int) -> int:
        if not self.cache_stacked_matrix:
            return 0
        return self._stacked_cells(main_cells) * BASE_FIELD_SIZE

    def rs_code_matrix_memory_bytes(self, main_cells: int) -> int:
        return (
            self._stacked_cells(main_cells)
            * (1 << self.log_blowup)
            * BASE_FIELD_SIZE
        )

    def batch_constraint_memory_bytes(self, counts: ProvingMemoryCounts) -> int:
        # folded EF part matrices: height/2^l_skip rows of EF per column,
        # doubled for rotated variants
        per_cell = EXT_DEGREE * BASE_FIELD_SIZE
        folded = (
            counts.main_cells_with_rot * 2 + counts.main_cells_without_rot
        ) * per_cell >> self.l_skip
        # round-0 coset grid: num_cosets lifted copies in base field (plus
        # the EF accumulator of the same footprint), and the interpreter's
        # buffer beside the next level's at every grid point; the
        # save-memory policy materializes 1/8 of it at a time
        num_cosets = max(self.max_constraint_degree - 1, 1)
        round0 = counts.main_cells * num_cosets * (
            BASE_FIELD_SIZE + EXT_DEGREE * BASE_FIELD_SIZE
        ) + 2 * counts.interpreter_values * num_cosets * BASE_FIELD_SIZE
        from .prover import logup_zerocheck

        min_log = self.l_skip + logup_zerocheck._SAVE_MEMORY_MIN_CHUNKS_LOG
        if self.zerocheck_save_memory and (
            counts.max_log_height is None or counts.max_log_height >= min_log
        ):
            round0 //= 8
        return max(folded, round0) + ALLOCATOR_ALLOWANCE

    def gkr_memory_bytes(self, interaction_cells: int) -> int:
        if interaction_cells == 0:
            return 0
        leaf_bytes = 2 * EXT_DEGREE * BASE_FIELD_SIZE  # (p, q) EF pair
        logical = 1 << (interaction_cells.bit_length())
        # full layer stack = 2x leaves; eq table + fold scratch ~ one layer;
        # the first sub-round's columns and EF temporaries ~ two layers
        return 5 * logical * leaf_bytes + ALLOCATOR_ALLOWANCE

    def whir_memory_bytes(self, main_cells: int = 0) -> int:
        m = 1 << self.log_stacked_height
        codeword_h = m << self.log_blowup
        f_and_w = 2 * m * EXT_DEGREE * BASE_FIELD_SIZE
        g_codeword = (codeword_h >> 1) * EXT_DEGREE * BASE_FIELD_SIZE
        g_digests = (codeword_h >> 1) * DIGEST_SIZE
        trees = 2 * DIGEST_SIZE * (codeword_h >> self.k_whir)
        # f from the RS message of the stacked matrix, then the rounds
        initial = 4 * self._stacked_cells(main_cells) * BASE_FIELD_SIZE
        rounds = f_and_w + 3 * g_codeword + g_digests
        return max(initial, rounds) + trees + ALLOCATOR_ALLOWANCE

    def commit_memory_bytes(self, main_cells: int) -> int:
        """The main-trace commit: traces, the stacked matrix, three
        codeword matrices and the leaf digests of the codeword."""
        stacked = self._stacked_cells(main_cells)
        codeword_h = 1 << (self.log_stacked_height + self.log_blowup)
        return (
            self.main_memory_bytes(main_cells)
            + stacked * BASE_FIELD_SIZE
            + 3 * self.rs_code_matrix_memory_bytes(main_cells)
            + codeword_h * DIGEST_SIZE
            + ALLOCATOR_ALLOWANCE
        )

    def estimate(self, counts: ProvingMemoryCounts) -> ProvingMemoryEstimate:
        main_cells = counts.main_cells
        main = self.main_memory_bytes(main_cells)
        stacked = self.stacked_matrix_memory_bytes(main_cells)
        rs = self.rs_code_matrix_memory_bytes(main_cells)
        batch = self.batch_constraint_memory_bytes(counts)
        gkr = self.gkr_memory_bytes(counts.interaction_cells)
        whir = self.whir_memory_bytes(main_cells)
        commit = self.commit_memory_bytes(main_cells)
        batch_or_gkr = max(batch, gkr)
        if self.cache_rs_code_matrix:
            secondary = rs + max(whir, batch_or_gkr)
        else:
            secondary = max(rs + whir, batch_or_gkr)
        total = max(main + stacked + secondary, commit)
        return ProvingMemoryEstimate(
            total=total,
            main=main,
            stacked_matrix=stacked,
            rs_code_matrix=rs,
            batch_constraint=batch,
            gkr=gkr,
            whir=whir,
            secondary_peak=secondary,
            commit=commit,
        )


def counts_for(vk, heights) -> ProvingMemoryCounts:
    """The counts of one prove: ``vk`` a
    :class:`~swirl_torch.keygen.MultiStarkVerifyingKey`, ``heights`` the
    trace height of each AIR (None for an AIR without a trace). Cached and
    preprocessed columns count as main cells."""
    from .prover.dag_eval import VECTORIZE_THRESHOLD
    from .prover.dag_vectorized import get_schedule

    with_rot = without_rot = interactions = interpreted = 0
    tallest = None
    for avk, h in zip(vk.per_air, heights):
        if h is None:
            continue
        tallest = max(tallest or 0, h.bit_length() - 1)
        cells = h * avk.params.width.total_width()
        if avk.params.need_rot:
            with_rot += cells
        else:
            without_rot += cells
        dag = avk.symbolic_constraints
        interactions += h * len(dag.interactions)
        if len(dag.nodes) >= VECTORIZE_THRESHOLD:
            lifted = max(h, 1 << vk.params.l_skip)
            interpreted = max(interpreted, get_schedule(dag).max_live * lifted)
    return ProvingMemoryCounts(with_rot, without_rot, interactions, interpreted, tallest)


def fits_in_hbm(
    params: SystemParams, counts: ProvingMemoryCounts, hbm_bytes: int = 80 * 10**9
) -> bool:
    """Segmentation predicate: does this workload fit on one card (by
    default an H100's 80 GB)?"""
    cfg = ProvingMemoryConfig.from_params(params)
    return cfg.estimate(counts).total <= hbm_bytes
