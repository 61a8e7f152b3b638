"""The port's fused prover (``swirl_torch/prover/fused.py``) on the CPU,
where every mode runs its five segments eagerly through the plain kernels.

- Every mode on the golden cases ``fib``, ``interactions``,
  ``preprocessed``, ``cached_preprocessed`` and ``reth_subset``: the bytes
  equal ``tests/golden/<case>.proof.bin``, the JAX package's proofs, and
  the port's verifier accepts them.
- One host read a prove, the fetch, on a small and a larger case; a
  second prove makes no tensor from host data (on the card, a copy that
  would wait for the stream and break a capture).
- The cache key: public values and cached commitments are part of it, and
  two contexts of one shape prove their own bytes; a refresh refuses
  cached mains committed under another memory policy (same key, other
  tensors). A proving key keeps
  ``CACHE_ENTRIES`` captures, and a replay reads copies of the cached
  mains, refreshed from the caller's context (the capture itself runs on
  the card only: ``tests/test_torch_kernels_cuda.py``).
- Refusals: a non-zero LogUp sum at the fetch, the BN254 outer backend,
  an unknown mode.
- The JAX package's ``prove_fused(mode="eager")`` on ``fib`` against the
  port's bytes (``slow``: about two minutes of the JAX engine's dispatch).

``reth_subset`` runs its segmented and jit modes in the ``slow`` tier
(``--runslow``): on the CPU all three modes are one code path, and its
prove takes about 10 s there.

Tolerance: exact equality (bytes).
"""

import numpy as np
import pytest
import torch

import jax

jax.config.update("jax_platforms", "cpu")

from swirl_torch.codec import encode_proof  # noqa: E402
from swirl_torch.engine import StarkEngine  # noqa: E402
from swirl_torch.prover.backend import ProvingContext  # noqa: E402
from swirl_torch.prover.errors import ProverError  # noqa: E402
from swirl_torch.prover import fused as fused_mod  # noqa: E402
from swirl_torch.prover.fused import MODES, ctx_cache_key, prove_fused  # noqa: E402
from swirl_torch.testing.golden import golden_cases, paths_for  # noqa: E402
from swirl_torch.testing.host_reads import HostReads  # noqa: E402

GOLDEN = ("fib", "interactions", "preprocessed", "cached_preprocessed", "reth_subset")


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def _case(name):
    """(params, airs, ctxs) of a golden case; ``reth_subset`` as
    ``tests/test_torch_reth.py`` builds it."""
    if name != "reth_subset":
        return golden_cases()[name]()
    from test_torch_reth import golden_case

    params, airs, traces = golden_case("swirl_torch")
    return params, airs, [(t, [], []) for t in traces]


def _setup(params, airs, ctxs):
    eng = StarkEngine(params, device="cpu")
    pk, vk = eng.keygen(airs)
    ctx = ProvingContext([eng.context_for(i, cm, pvs, cached) for i, (cm, pvs, cached) in enumerate(ctxs)])
    return eng, vk, eng.transport_pk(pk), ctx


@pytest.fixture(scope="module")
def golden():
    """name -> (engine, vk, dpk, ctx), built once a case."""
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = _setup(*_case(name))
        return cache[name]

    return get


# on the CPU the three modes run one code path; a reth_subset prove there
# takes about 10 s (kernel F's plain grind), so two of its modes are slow
CASES = [
    pytest.param(case, mode, marks=[pytest.mark.slow] if case == "reth_subset" and mode != "eager" else [])
    for case in GOLDEN for mode in MODES
]


@pytest.mark.parametrize("case,mode", CASES)
def test_fused_golden_bytes(golden, case, mode):
    """The proof's bytes are the golden file's, read in one copy; the
    port's verifier accepts them (once a case: the bytes are equal)."""
    eng, vk, dpk, ctx = golden(case)
    with HostReads() as reads:
        proof = prove_fused(eng.backend, dpk, ctx, mode=mode)
    assert encode_proof(proof) == _read(paths_for(case)["proof"])
    assert reads.reads["total"] == reads.reads["proof_fetch"] == 1
    if mode == "eager":
        eng.verify(vk, proof)


# (log height, width, interactions, constraints) per AIR, n_stack: the
# large case of tests/test_torch_device_stages.py (a trace that runs out of
# rounds, one below 2^l_skip rows, one without interactions, a DAG of over
# 128 nodes), two more rounds in each stage than the small one
SHAPES = {
    "small": (((6, 6, 2, 4), (3, 5, 2, 4), (1, 4, 0, 4)), 5),
    "large": (((8, 6, 2, 4), (5, 5, 2, 60), (1, 4, 0, 4)), 7),
}


def _synthetic(shapes, n_stack, seed=0):
    from swirl_torch.fields.babybear import P
    from swirl_torch.params import test_system_params_small
    from swirl_torch.testing.synthetic import SyntheticAir, uniform_shape

    rng = np.random.default_rng(seed)
    airs, ctxs = [], []
    for log_h, width, interactions, constraints in shapes:
        air = SyntheticAir(uniform_shape(log_h, width, constraints, interactions, degree=3))
        trace = rng.integers(0, P, (1 << log_h, air.common_main_width()), dtype=np.uint64)
        trace[:, 0] = 0  # the kill column: every constraint holds, every bus balances
        airs.append(air)
        ctxs.append((trace, [], []))
    return test_system_params_small(2, n_stack, 3), airs, ctxs


@pytest.mark.parametrize("size", ["small", "large"])
def test_fused_reads_once_whatever_the_rounds(size):
    """One host read a prove in every mode, at two sizes; the bytes equal
    the Coordinator's on a device transcript; the second prove and the
    third make no tensor from host data."""
    from swirl_torch.prover.device_transcript import DeviceTranscript

    eng, vk, dpk, ctx = _setup(*_synthetic(*SHAPES[size]))
    want = encode_proof(eng.prove(dpk, ctx, DeviceTranscript("cpu")))
    for mode in MODES:
        with HostReads() as reads:
            proof = prove_fused(eng.backend, dpk, ctx, mode=mode)
        assert encode_proof(proof) == want
        assert dict(reads.reads) == {"total": 1, "stark_prove_excluding_trace": 1, "proof_fetch": 1}
        if mode != MODES[0]:
            assert reads.writes["total"] == 0


def test_fused_cache_not_stale_across_public_values(golden):
    """Two public-value pairs, one shape: two cache keys, each prove its own
    bytes (the Coordinator's), each verified (``tests/test_fused.py``)."""
    from swirl_torch.testing.fixtures import FibonacciAir

    eng, vk, dpk, _ = golden("fib")
    air = FibonacciAir()
    keys = set()
    for a, b in [(0, 1), (2, 5)]:
        ctx = ProvingContext([eng.context_for(0, air.generate_trace(a, b, 64), air.pvs(a, b, 64))])
        keys.add(ctx_cache_key(ctx.sorted_for_stacking()))
        fused = prove_fused(eng.backend, dpk, ctx, mode="jit")
        assert encode_proof(fused) == encode_proof(eng.prove(dpk, ctx))
        eng.verify(vk, fused)
    assert len(keys) == 2


def test_fused_context_with_another_cached_commitment(golden):
    """``cached_preprocessed`` with another cached trace: another cache key,
    and the bytes of the Coordinator's prove of that context."""
    from swirl_torch.testing.fixtures import MultiCachedAir

    eng, vk, dpk, ctx = golden("cached_preprocessed")
    common, cached = MultiCachedAir.generate_traces(16, seed=6)
    other = ProvingContext([eng.context_for(0, common, [], cached), ctx.per_trace[1]])
    assert ctx_cache_key(other.sorted_for_stacking()) != ctx_cache_key(ctx.sorted_for_stacking())
    proof = prove_fused(eng.backend, dpk, other, mode="segmented")
    assert encode_proof(proof) == encode_proof(eng.prove(dpk, other))
    eng.verify(vk, proof)


def test_fused_cache_keeps_one_capture_a_proving_key():
    """A hit captures nothing; a new key drops the oldest entry before it
    captures (each entry holds a pool about the eager prove's size)."""
    from types import SimpleNamespace

    assert fused_mod.CACHE_ENTRIES == 1
    mpk, made = SimpleNamespace(), []

    def capture(key):
        made.append(key)
        assert len(mpk._fused_cache) < fused_mod.CACHE_ENTRIES  # the old pool is dropped first
        return SimpleNamespace(key=key)

    first = fused_mod.cached_entry(mpk, "a", lambda: capture("a"))
    assert fused_mod.cached_entry(mpk, "a", lambda: capture("a")) is first
    second = fused_mod.cached_entry(mpk, "b", lambda: capture("b"))
    assert list(mpk._fused_cache) == ["b"] and second.key == "b"
    assert fused_mod.cached_entry(mpk, "a", lambda: capture("a")) is not first
    assert made == ["a", "b", "a"] and list(mpk._fused_cache) == ["a"]
    fused_mod.release_fused(mpk)
    assert not hasattr(mpk, "_fused_cache")


def test_fused_replay_reads_copies_of_the_cached_mains(golden):
    """The entry's cached mains are copies (a tensor held twice is copied
    once), and a refresh from a fresh context of the same cached trace
    writes that context's values into them, as into the common traces."""
    eng, _, dpk, ctx = golden("cached_preprocessed")
    ctx = ctx.sorted_for_stacking()
    cached = [tc.cached_mains for _, tc in ctx.per_trace]
    static = fused_mod.static_cached(cached)
    walk, own = fused_mod.cached_tensors(static), fused_mod.cached_tensors(cached)
    assert walk and len(walk) == len(own)
    assert all(s is not c and s.data_ptr() != c.data_ptr() and torch.equal(s, c) for s, c in zip(walk, own))
    assert len({id(s) for s in walk}) == len({id(c) for c in own})
    entry = fused_mod.FusedGraphs(
        groups=[], static=[torch.zeros_like(tc.common_main) for _, tc in ctx.per_trace], cached=static,
        flat=None, layout=None, build=None, sync_each=False,
    )
    for s in walk:
        s.zero_()
    _, _, _, again = _setup(*_case("cached_preprocessed"))
    again = again.sorted_for_stacking()
    entry.replay(again, torch.device("cpu"))
    fresh = fused_mod.cached_tensors([tc.cached_mains for _, tc in again.per_trace])
    assert all(torch.equal(s, c) and s is not c for s, c in zip(walk, fresh))
    assert all(torch.equal(s, tc.common_main) for s, (_, tc) in zip(entry.static, again.per_trace))


def test_fused_refresh_refuses_cached_mains_of_another_policy(golden):
    """The cache key holds the prover's memory policy and the cached
    commitments, but a cached main carries the policy it was committed
    under: the same commitment committed with both caches off holds fewer
    tensors (no stacked matrix, no codeword). A refresh of an entry
    captured on the cached policy's tensors refuses such a context instead
    of pairing its tensors by position."""
    from swirl_torch.prover.backend import ProverConfig

    eng, _, dpk, ctx = golden("cached_preprocessed")
    ctx = ctx.sorted_for_stacking()
    entry = fused_mod.FusedGraphs(
        groups=[], static=[tc.common_main.clone() for _, tc in ctx.per_trace],
        cached=fused_mod.static_cached([tc.cached_mains for _, tc in ctx.per_trace]),
        flat=None, layout=None, build=None, sync_each=False,
    )
    params, _, ctxs = golden_cases()["cached_preprocessed"]()
    lean = StarkEngine(params, prover_config=ProverConfig(cache_stacked_matrix=False, cache_rs_code_matrix=False),
                       device="cpu")
    other = ProvingContext([lean.context_for(i, *c) for i, c in enumerate(ctxs)]).sorted_for_stacking()
    assert fused_mod.graph_key(eng.backend, other, "segmented") == fused_mod.graph_key(eng.backend, ctx, "segmented")
    mine = fused_mod.cached_tensors(entry.cached)
    theirs = fused_mod.cached_tensors([tc.cached_mains for _, tc in other.per_trace])
    assert len(theirs) < len(mine)
    with pytest.raises(ProverError, match="count or shape"):
        entry.refresh(other)
    assert all(torch.equal(s, c) for s, c in zip(mine, fused_mod.cached_tensors([tc.cached_mains for _, tc in ctx.per_trace])))
    entry.refresh(ctx)  # the capturing policy's context still pairs


@pytest.mark.parametrize("mode", MODES)
def test_fused_refuses_a_nonzero_logup_sum_at_the_fetch(mode):
    """The unbalanced receiver of ``tests/test_torch_prove.py``, the debug
    check off: the GKR zero check raises after the one fetch."""
    from swirl_torch.testing.fixtures import DummyInteractionAir

    params, airs, ctxs = golden_cases()["interactions"]()
    recv = np.array(ctxs[1][0], dtype=np.uint64)
    recv[0, 1] = 8  # (7, 9) -> (8, 9)
    eng, _, dpk, ctx = _setup(params, airs, [ctxs[0], (DummyInteractionAir.make_trace(recv.tolist()), [], [])])
    with HostReads() as reads, pytest.raises(ValueError, match="fractional sum is non-zero"):
        prove_fused(eng.backend, dpk, ctx, mode=mode)
    assert reads.reads["total"] == reads.reads["proof_fetch"] == 1


def test_fused_refuses_the_outer_scheme_and_an_unknown_mode(golden):
    eng, _, dpk, ctx = golden("fib")
    with pytest.raises(ValueError, match="unknown mode"):
        prove_fused(eng.backend, dpk, ctx, mode="aot")
    params, airs, ctxs = golden_cases()["outer"]()
    outer = StarkEngine(params, hash_scheme="bn254-outer", device="cpu")
    pk, _ = outer.keygen(airs)
    octx = ProvingContext([outer.context_for(i, *c) for i, c in enumerate(ctxs)])
    with pytest.raises(ProverError, match="host transcript"):
        prove_fused(outer.backend, outer.transport_pk(pk), octx, mode="eager")


def test_device_transcript_save_restore_goes_on():
    """A transcript saved mid-stream (host felts still buffered) and
    restored goes on exactly as one that was never cut."""
    from swirl_torch.prover.device_transcript import DeviceTranscript

    def events(t, cut):
        t.observe_commit(np.arange(8, dtype=np.uint64))
        t.observe_slice(torch.arange(5, dtype=torch.int64))
        t.observe(7)
        if cut:
            t = DeviceTranscript.restore(*t.save())
        t.observe(9)
        return t, [t.sample_ext(), t.sample_bits_batch(6, 3), t.grind(3)]

    a, got = events(DeviceTranscript("cpu"), True)
    b, want = events(DeviceTranscript("cpu"), False)
    assert all(torch.equal(x, y) for x, y in zip(got, want))
    assert torch.equal(a.state, b.state) and (a.absorb_idx, a.sample_idx) == (b.absorb_idx, b.sample_idx)


def test_pack_unpack_round_trip():
    from swirl_torch.fields import field as F

    values = [torch.arange(6).reshape(2, 3), np.uint64(5), torch.tensor(-1), torch.zeros((0, 4), dtype=torch.int64)]
    flat, layout = F.pack(values)
    got = F.unpack(layout, F.to_host(flat))
    assert [np.asarray(g).shape for g in got] == [(2, 3), (), (), (0, 4)]
    assert np.array_equal(got[0], np.arange(6).reshape(2, 3)) and got[1] == 5
    assert int(got[2]) == 2**64 - 1  # kernel F's -1, which the builds refuse


@pytest.mark.slow
def test_fused_fib_equals_the_jax_fused_prover():
    """``swirl.prover.fused.prove_fused(mode="eager")`` on ``fib``: the same
    bytes as the port's fused prove."""
    from swirl.codec import encode_proof as jencode
    from swirl.engine import StarkEngine as JEngine
    from swirl.prover.backend import ProvingContext as JContext
    from swirl.prover.fused import prove_fused as jprove_fused
    from swirl.testing.golden import golden_cases as jgolden

    params, airs, ctxs = jgolden()["fib"]()
    jeng = JEngine(params)
    jpk, _ = jeng.keygen(airs)
    jctx = JContext([jeng.context_for(i, *c) for i, c in enumerate(ctxs)])
    want = jencode(jprove_fused(jeng.backend, jeng.transport_pk(jpk), jctx, mode="eager"))
    eng, _, dpk, ctx = _setup(*golden_cases()["fib"]())
    assert encode_proof(prove_fused(eng.backend, dpk, ctx, mode="eager")) == want
