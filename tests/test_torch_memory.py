"""The memory policy of the torch port (swirl_torch) on the CPU.

``ProverConfig`` (the port's copy of ``swirl/prover/backend.py:90-102``)
resolves ``zerocheck_save_memory`` as the reference does; proofs with the
stacked matrix and the RS codewords dropped (recomputed where they are
read) equal the golden bytes on both transcripts; round 0's coset grids
in 8 row segments give the same bytes as the full grid on both
transcripts, with the segment threshold lowered as
``tests/test_e2e_extra.py`` lowers it; and the port's copy of
``swirl/memory_metering.py`` keeps the relations of
``tests/test_memory_metering.py`` with the port's buffer sizes. Tolerance:
exact equality (proof bytes, integer byte counts).
"""

import dataclasses

import pytest

import jax

jax.config.update("jax_platforms", "cpu")

from swirl_torch import memory_metering as mm  # noqa: E402
from swirl_torch.codec import encode_proof  # noqa: E402
from swirl_torch.engine import StarkEngine  # noqa: E402
from swirl_torch.params import test_system_params_small as small_params  # noqa: E402
from swirl_torch.prover import logup_zerocheck  # noqa: E402
from swirl_torch.prover.backend import ProverConfig, ProvingContext  # noqa: E402
from swirl_torch.prover.device_transcript import DeviceTranscript  # noqa: E402
from swirl_torch.testing.fixtures import FibonacciAir, SelfInteractionAir  # noqa: E402
from swirl_torch.testing.golden import golden_cases, paths_for  # noqa: E402

TRANSCRIPTS = ["host", "device"]


def _prove(params, airs, ctxs, config, transcript: str, verify: bool = True):
    """keygen, contexts and prove on the CPU under ``config``; returns the
    proof's bytes and the proving context."""
    eng = StarkEngine(params, config, device="cpu")
    pk, vk = eng.keygen(airs)
    ctx = ProvingContext([eng.context_for(i, cm, pvs, c) for i, (cm, pvs, c) in enumerate(ctxs)])
    proof = eng.prove(eng.transport_pk(pk), ctx, DeviceTranscript("cpu") if transcript == "device" else None)
    if verify:
        eng.verify(vk, proof)
    return encode_proof(proof), ctx, pk


def test_default_config_follows_log_blowup():
    """zerocheck_save_memory=None resolves to log_blowup == 1 (the port's
    copy of ``test_save_memory_default_follows_blowup``); a set value
    stays."""
    eng = StarkEngine(small_params(2, 4, 2), device="cpu")  # log_blowup = 1
    assert eng.params.log_blowup == 1
    assert eng.backend.config.zerocheck_save_memory is True
    assert eng.proving_memory_config().zerocheck_save_memory is True
    assert eng.backend.config.cache_stacked_matrix and eng.backend.config.cache_rs_code_matrix
    from swirl_torch.params import leaf_params_with_100_bits_security

    leaf = StarkEngine(leaf_params_with_100_bits_security(25), device="cpu")
    assert leaf.params.log_blowup != 1
    assert leaf.backend.config.zerocheck_save_memory is False
    off = StarkEngine(small_params(2, 4, 2), ProverConfig(zerocheck_save_memory=False), device="cpu")
    assert off.backend.config.zerocheck_save_memory is False


@pytest.mark.parametrize("transcript", TRANSCRIPTS)
@pytest.mark.parametrize("name", ["interactions", "cached_preprocessed"])
def test_caches_off_proof_equals_golden(name, transcript):
    """With both caches off the committed data keeps no stacked matrix and
    no codewords (main, cached and preprocessed commits alike), and the
    proof still equals the golden bytes, which the cached proof equals
    (``tests/test_torch_prove.py``)."""
    params, airs, ctxs = golden_cases()[name]()
    cfg = ProverConfig(cache_stacked_matrix=False, cache_rs_code_matrix=False)
    got, ctx, pk = _prove(params, airs, ctxs, cfg, transcript)
    with open(paths_for(name)["proof"], "rb") as f:
        assert got == f.read()
    committed = [cd.data for _, tc in ctx.per_trace for cd in tc.cached_mains]
    committed += [a.preprocessed_data.data for a in pk.per_air if a.preprocessed_data is not None]
    if name == "cached_preprocessed":
        assert len(committed) >= 2  # a cached main and a preprocessed trace
    for data in committed:
        assert data.matrix is None and data.rs_matrix is None
        assert data.get_rs_matrix().shape == (data.layout.width, data.layout.height << params.log_blowup)


def _fib_case():
    params, airs, ctxs = golden_cases()["fib"]()
    return params, airs, ctxs


def _self_interaction_case():
    air = SelfInteractionAir(4)
    return small_params(2, 5, 2), [air], [(air.generate_trace(32), [], [])]


def _mixed_heights_case():
    """A 64-row trace with rotations, segmented, beside an 8-row trace with
    interactions, which is shorter than a segment and is not segmented."""
    fib, inter = FibonacciAir(), SelfInteractionAir(4)
    return (
        small_params(2, 6, 3),
        [fib, inter],
        [(fib.generate_trace(0, 1, 64), fib.pvs(0, 1, 64), []), (inter.generate_trace(8, seed=2), [], [])],
    )


CASES = {"fib": _fib_case, "self_interaction": _self_interaction_case, "mixed_heights": _mixed_heights_case}


@pytest.mark.parametrize("transcript", TRANSCRIPTS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_segmented_round0_equals_full_grid(monkeypatch, case, transcript):
    """Round 0's grids in 8 row segments (the threshold lowered to 2^3
    chunks, as ``tests/test_e2e_extra.py:195`` does) give the full grid's
    bytes; the segments take rotated rows across their ends."""
    monkeypatch.setattr(logup_zerocheck, "_SAVE_MEMORY_MIN_CHUNKS_LOG", 3)
    segments = []
    real = logup_zerocheck._row_segment

    def counted(m, lo, rows, is_rot):
        segments.append((lo, rows, is_rot))
        return real(m, lo, rows, is_rot)

    monkeypatch.setattr(logup_zerocheck, "_row_segment", counted)
    params, airs, ctxs = CASES[case]()
    full, _, _ = _prove(params, airs, ctxs, ProverConfig(zerocheck_save_memory=False), transcript, verify=False)
    assert not segments
    chunked, _, _ = _prove(params, airs, ctxs, ProverConfig(zerocheck_save_memory=True), transcript)
    assert chunked == full
    assert {lo for lo, _, _ in segments} == {i * segments[0][1] for i in range(8)}
    if case == "fib":
        assert any(rot for _, _, rot in segments)
        with open(paths_for("fib")["proof"], "rb") as f:
            assert chunked == f.read()


@pytest.mark.parametrize("is_rot", [False, True])
def test_row_segment_is_a_slice_of_the_rotated_matrix(is_rot):
    import torch

    m = torch.arange(3 * 16).reshape(3, 16)
    whole = torch.roll(m, -1, dims=1) if is_rot else m
    parts = [logup_zerocheck._row_segment(m, lo, 4, is_rot) for lo in range(0, 16, 4)]
    assert torch.equal(torch.cat(parts, dim=1), whole)


# ---- the memory model: the relations of tests/test_memory_metering.py ----


def _cfg(**kw) -> mm.ProvingMemoryConfig:
    base = dict(l_skip=2, n_stack=6, log_blowup=1, k_whir=2, max_constraint_degree=3)
    base.update(kw)
    return mm.ProvingMemoryConfig(**base)


def _counts(with_rot=1 << 12, without_rot=0, interactions=0, **kw):
    return mm.ProvingMemoryCounts(
        main_cells_with_rot=with_rot, main_cells_without_rot=without_rot, interaction_cells=interactions, **kw
    )


def test_port_buffer_sizes():
    assert mm.BASE_FIELD_SIZE == 8  # an int64 tensor element
    assert mm.EXT_DEGREE * mm.BASE_FIELD_SIZE == 32
    assert mm.DIGEST_SIZE == 64  # a Merkle layer is (8, n) int64


def test_dropped_rs_code_matrix_is_phase_disjoint():
    est = _cfg(cache_rs_code_matrix=False).estimate(_counts())
    assert est.secondary_peak == max(est.rs_code_matrix + est.whir, max(est.batch_constraint, est.gkr))


def test_cached_rs_code_matrix_is_additive():
    est = _cfg(cache_rs_code_matrix=True).estimate(_counts())
    assert est.secondary_peak == est.rs_code_matrix + max(est.whir, max(est.batch_constraint, est.gkr))


def test_batch_constraint_memory_uses_integer_formula():
    cfg = _cfg()
    counts = _counts(with_rot=1000, without_rot=24)
    per_cell = mm.EXT_DEGREE * mm.BASE_FIELD_SIZE
    folded = (1000 * 2 + 24) * per_cell >> cfg.l_skip
    num_cosets = cfg.max_constraint_degree - 1
    round0 = 1024 * num_cosets * (mm.BASE_FIELD_SIZE + per_cell)
    assert cfg.batch_constraint_memory_bytes(counts) == max(folded, round0) + mm.ALLOCATOR_ALLOWANCE
    # the interpreter's buffer and the next level's, per coset, in base field
    inter = _counts(with_rot=1000, without_rot=24, interpreter_values=5000)
    assert cfg.batch_constraint_memory_bytes(inter) == (
        round0 + 2 * 5000 * num_cosets * mm.BASE_FIELD_SIZE + mm.ALLOCATOR_ALLOWANCE
    )


def test_stacked_matrix_and_whir_components_are_counted_separately():
    est = _cfg().estimate(_counts())
    assert est.stacked_matrix > 0 and est.whir > 0
    assert est.total == max(est.main + est.stacked_matrix + est.secondary_peak, est.commit)
    assert est.total == est.main + est.stacked_matrix + est.secondary_peak


def test_commit_sets_the_peak_of_a_tall_narrow_codeword():
    """A tall codeword of 16 columns at blowup 4 and constraints of degree
    2: the commit's three codeword matrices and leaf digests (8 words a
    row) outweigh every later phase."""
    cfg = _cfg(n_stack=18, log_blowup=2, k_whir=4, max_constraint_degree=2)
    est = cfg.estimate(_counts(with_rot=1 << 24))
    assert est.total == est.commit > est.main + est.stacked_matrix + est.secondary_peak
    codeword_h = 1 << (cfg.log_stacked_height + cfg.log_blowup)
    assert est.commit == (
        est.main + (1 << 24) * mm.BASE_FIELD_SIZE + 3 * est.rs_code_matrix
        + codeword_h * mm.DIGEST_SIZE + mm.ALLOCATOR_ALLOWANCE
    )


def test_no_cache_stacked_matrix_drops_component():
    assert _cfg(cache_stacked_matrix=False).estimate(_counts()).stacked_matrix == 0


def test_gkr_memory_zero_without_interactions():
    cfg = _cfg()
    assert cfg.gkr_memory_bytes(0) == 0
    assert cfg.gkr_memory_bytes(1 << 10) > 0


@pytest.mark.parametrize("log_height,segmented", [(None, True), (14, False), (15, True)])
def test_save_memory_divides_round0_only_where_the_prover_segments(log_height, segmented):
    """The save-memory policy takes 1/8 of round 0 only for a trace of at
    least 2^(l_skip + 13) rows, as the prover segments."""
    counts = _counts(with_rot=1 << 20, max_log_height=log_height)
    on = _cfg(zerocheck_save_memory=True).batch_constraint_memory_bytes(counts)
    off = _cfg(zerocheck_save_memory=False).batch_constraint_memory_bytes(counts)
    assert (on < off) == segmented


def test_round0_is_the_largest_air_segmented_by_its_own_height():
    """Round 0 runs AIR by AIR, each segmented by its own height: the batch
    term is the largest AIR's round 0. The sum over AIRs segmented by the
    tallest trace fell below one unsegmented AIR's grid."""
    cfg = _cfg(zerocheck_save_memory=True)  # l_skip 2: segments from 2^15 rows
    tall, wide = (1 << 15) * 4, (1 << 14) * 64  # segmented; not segmented
    counts = _counts(with_rot=tall + wide, max_log_height=15, round0_airs=((tall, 0, 15), (wide, 0, 14)))
    per_cell = (cfg.max_constraint_degree - 1) * (mm.BASE_FIELD_SIZE + mm.EXT_DEGREE * mm.BASE_FIELD_SIZE)
    assert cfg.round0_memory_bytes(tall, 0, 15) == tall * per_cell // 8
    assert cfg.round0_memory_bytes(wide, 0, 14) == wide * per_cell
    assert cfg.batch_constraint_memory_bytes(counts) == wide * per_cell + mm.ALLOCATOR_ALLOWANCE
    assert (tall + wide) * per_cell // 8 < wide * per_cell
    # with no AIRs listed, the counts are one AIR, as before
    whole = dataclasses.replace(counts, round0_airs=())
    folded = (tall + wide) * 2 * mm.EXT_DEGREE * mm.BASE_FIELD_SIZE >> cfg.l_skip
    assert cfg.batch_constraint_memory_bytes(whole) == (
        max(folded, (tall + wide) * per_cell // 8) + mm.ALLOCATOR_ALLOWANCE
    )


def test_counts_for_lists_each_air_for_round0():
    """counts_for lists each AIR's lifted cells, interpreter values and log
    height; the 8-row AIR is lifted to 2^l_skip rows only where it is
    shorter. The estimate's batch phase is what round 0's span may hold."""
    params, airs, ctxs = _mixed_heights_case()
    eng = StarkEngine(params, device="cpu")
    _, vk = eng.keygen(airs)
    counts = mm.counts_for(vk, [64, 8])
    assert counts.round0_airs == ((64 * 2, 0, 6), (max(8, 1 << params.l_skip) * 4, 0, 3))
    assert mm.counts_for(vk, [None, 8]).round0_airs == ((max(8, 1 << params.l_skip) * 4, 0, 3),)
    est = eng.proving_memory_config().estimate(counts)
    assert est.batch_phase == est.main + est.stacked_matrix + est.rs_code_matrix + est.batch_constraint
    off = mm.ProvingMemoryConfig.from_params(params, cache_rs_code_matrix=False).estimate(counts)
    assert off.batch_phase == off.main + off.stacked_matrix + off.batch_constraint


def test_counts_for_and_the_engine_config():
    """counts_for reads the vk's widths, rotations, interactions and the
    interpreter's max_live; the engine's config carries its policy."""
    from swirl_torch.prover.dag_eval import VECTORIZE_THRESHOLD

    params, airs, ctxs = _mixed_heights_case()
    eng = StarkEngine(params, ProverConfig(cache_rs_code_matrix=False), device="cpu")
    _, vk = eng.keygen(airs)
    counts = mm.counts_for(vk, [64, 8])
    assert counts.main_cells_with_rot == 64 * 2
    assert counts.main_cells_without_rot == 8 * 4
    assert counts.interaction_cells == 8 * 2
    assert counts.max_log_height == 6
    assert all(len(a.symbolic_constraints.nodes) < VECTORIZE_THRESHOLD for a in vk.per_air)
    assert counts.interpreter_values == 0
    assert mm.counts_for(vk, [None, 8]).main_cells == 32
    cfg = eng.proving_memory_config()
    assert (cfg.cache_stacked_matrix, cfg.cache_rs_code_matrix) == (True, False)
    assert cfg.estimate(counts).total > 0
    assert mm.fits_in_hbm(params, counts)
