"""End-to-end conformance of the torch port on the CPU: the shapes of
``tests/test_e2e.py`` and ``tests/test_e2e_extra.py``, each proved through
``swirl_torch`` with ``device="cpu"`` and ``run_test`` (debug check, prove,
then the port's own verifier), and the refusals the reference expects.

Byte equality with the JAX engine on a few of these shapes, and the
pipeline stage tests, are in ``tests/test_torch_e2e_jax.py``.
"""

import numpy as np
import pytest

from swirl_torch.engine import StarkEngine
from swirl_torch.params import test_system_params_small as small_params
from swirl_torch.prover.backend import ProvingContext
from swirl_torch.testing.fixtures import (
    DummyInteractionAir,
    FibonacciAir,
    FibonacciSelectorAir,
    MixtureAir,
    MultiCachedAir,
    SelfInteractionAir,
)


def _engine(*params):
    return StarkEngine(small_params(*params), device="cpu")


def fib_case(engine, n, a0=1, b0=1):
    trace = FibonacciAir.generate_trace(a0, b0, n)
    return engine.run_test([FibonacciAir()], [(trace, FibonacciAir.pvs(a0, b0, n), [])])


@pytest.mark.parametrize("n", [1, 2, 4, 16])
def test_fibonacci_heights(n):
    """Height 1, below 2^l_skip = 4 (lifted), equal to it, and above."""
    fib_case(_engine(2, 3, 3), n)


def test_sender_receiver_balanced():
    sender = DummyInteractionAir(2, is_send=True, bus_index=3)
    receiver = DummyInteractionAir(2, is_send=False, bus_index=3)
    send_rows = [[2, 7, 9], [1, 3, 4], [0, 0, 0], [0, 0, 0]]
    recv_rows = [[1, 7, 9], [1, 7, 9], [1, 3, 4]] + [[0, 0, 0]] * 5
    _engine(2, 4, 3).run_test(
        [sender, receiver],
        [
            (DummyInteractionAir.make_trace(send_rows), [], []),
            (DummyInteractionAir.make_trace(recv_rows), [], []),
        ],
    )


@pytest.mark.parametrize("widths", [(4,), (7,), (8,), (4, 7, 8)])
def test_self_interaction(widths):
    """One AIR per width, each on a bus of its own, heights 8, 16, 32."""
    airs = [SelfInteractionAir(w, bus_index=i) for i, w in enumerate(widths)]
    ctxs = [(a.generate_trace(8 << i, seed=i), [], []) for i, a in enumerate(airs)]
    _engine(2, 6, 3).run_test(airs, ctxs)


def test_mixed_heights():
    fib, mix = FibonacciAir(), MixtureAir(3)
    _engine(2, 5, 3).run_test(
        [fib, mix],
        [
            (FibonacciAir.generate_trace(1, 2, 32), FibonacciAir.pvs(1, 2, 32), []),
            (mix.generate_trace(8), [], []),
        ],
    )


def test_mixture_with_interactions():
    fib, self_int = FibonacciAir(), SelfInteractionAir(4)
    _engine(2, 5, 3).run_test(
        [fib, self_int],
        [
            (FibonacciAir.generate_trace(1, 1, 8), FibonacciAir.pvs(1, 1, 8), []),
            (self_int.generate_trace(16), [], []),
        ],
    )


def test_fib_selector():
    air = FibonacciSelectorAir([i % 2 == 0 for i in range(16)])
    _engine(2, 4, 3).run_test([air], [(air.generate_trace(1, 1), air.pvs(1, 1), [])])


def test_cached_trace():
    air = DummyInteractionAir(2, is_send=True, bus_index=0, partitioned=True)
    recv = DummyInteractionAir(2, is_send=False, bus_index=0)
    fields = np.array([[7, 9], [3, 4], [0, 0], [0, 0]], dtype=np.uint64)
    counts = np.array([[2], [1], [0], [0]], dtype=np.uint64)
    recv_rows = [[2, 7, 9], [1, 3, 4], [0, 0, 0], [0, 0, 0]]
    _engine(2, 4, 3).run_test(
        [air, recv],
        [(counts, [], [fields]), (DummyInteractionAir.make_trace(recv_rows), [], [])],
    )


def test_two_cached_parts():
    common, cached = MultiCachedAir.generate_traces(16)
    _engine(2, 4, 2).run_test([MultiCachedAir()], [(common, [], cached)])


def _prove_subset(engine, airs, present, required=None):
    """Keygen over ``airs``, prove only the (air_id, trace, pvs) of
    ``present``; returns (vk, proof)."""
    pk, vk = engine.keygen(airs, required=required)
    ctx = ProvingContext([engine.context_for(i, t, pvs, []) for i, t, pvs in present])
    return vk, engine.prove(engine.transport_pk(pk), ctx)


def test_absent_optional_air():
    eng = _engine(2, 4, 3)
    trace = FibonacciAir.generate_trace(1, 1, 16)
    vk, proof = _prove_subset(eng, [FibonacciAir(), MixtureAir(3)], [(0, trace, FibonacciAir.pvs(1, 1, 16))])
    assert proof.trace_vdata[1] is None
    eng.verify(vk, proof)


def test_present_subset_with_interactions():
    """An absent AIR beside one with interactions: the bus balances among
    the present traces."""
    eng = _engine(2, 4, 3)
    self_int = SelfInteractionAir(4)
    vk, proof = _prove_subset(eng, [MixtureAir(3), self_int], [(1, self_int.generate_trace(8), [])])
    eng.verify(vk, proof)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_params(seed):
    rng = np.random.default_rng(seed)
    l_skip = int(rng.integers(1, 4))
    k_whir = int(rng.integers(2, 4))
    n_stack = int(rng.integers(3, 6))
    n = 1 << int(rng.integers(2, min(l_skip + n_stack, 5)))
    fib_case(_engine(l_skip, n_stack, k_whir), n, 1, 2)


def test_l_skip_5():
    """32-point univariate-skip chunks."""
    fib_case(_engine(5, 2, 2), 64)


def test_l_skip_6_lifted():
    """A height-16 trace lifted into the 64-point chunk."""
    fib_case(_engine(6, 2, 2), 16)


def test_required_air_missing_is_refused():
    from swirl_torch.verifier.errors import RequiredAirNoVData

    eng = _engine(2, 4, 3)
    trace = FibonacciAir.generate_trace(1, 1, 16)
    vk, proof = _prove_subset(
        eng, [FibonacciAir(), MixtureAir(3)], [(0, trace, FibonacciAir.pvs(1, 1, 16))],
        required=[False, True],
    )
    with pytest.raises(RequiredAirNoVData):
        eng.verify(vk, proof)


def test_stacking_overflow_is_refused():
    """A trace taller than the stacked height 2^5."""
    from swirl_torch.prover.errors import StackedPcsError

    with pytest.raises(StackedPcsError):
        fib_case(_engine(2, 3, 2), 64)


def test_l_skip_above_the_bound_is_refused():
    from swirl_torch.prover.errors import ProverError

    with pytest.raises(ProverError):
        _engine(10, 2, 2)


def test_unbalanced_fails_without_debug():
    """The reference's ``test_unbalanced_fails``: with the debug check off,
    the prover refuses the non-zero LogUp sum."""
    sender = DummyInteractionAir(2, is_send=True, bus_index=3)
    receiver = DummyInteractionAir(2, is_send=False, bus_index=3)
    send_rows = [[2, 7, 9], [0, 0, 0], [0, 0, 0], [0, 0, 0]]
    recv_rows = [[1, 7, 9], [0, 0, 0], [0, 0, 0], [0, 0, 0]]
    with pytest.raises(ValueError, match="fractional sum is non-zero"):
        _engine(2, 4, 3).run_test(
            [sender, receiver],
            [
                (DummyInteractionAir.make_trace(send_rows), [], []),
                (DummyInteractionAir.make_trace(recv_rows), [], []),
            ],
            debug=False,
        )

