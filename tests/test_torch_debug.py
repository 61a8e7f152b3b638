"""The port's pre-prove checks against the JAX package's on the CPU.

``swirl_torch.debug`` evaluates every constraint on every row and balances
the buses with tensor ops; ``swirl.debug`` walks the rows on the host. On
the same AIRs and traces both must pass, or both must raise
``AssertionError`` with the same text: the first failing constraint's row,
or the whole LogUp imbalance report. Each package builds its own AIRs,
params and contexts (the reference through its own JAX-CPU engine).

``swirl_torch.sanitize`` mirrors ``tests/test_sanitize.py``: a poisoned
int64 trace is caught at the prover's first stage boundary with
``SWIRL_SANITIZE=1``, a clean prove passes, and with the switch off the
check does nothing.
"""

import importlib

import numpy as np
import pytest
import torch

import jax

jax.config.update("jax_platforms", "cpu")

from swirl_torch import debug as tdebug  # noqa: E402
from swirl_torch import sanitize  # noqa: E402
from swirl_torch.engine import StarkEngine  # noqa: E402
from swirl_torch.fields.babybear import P  # noqa: E402
from swirl_torch.prover.backend import AirContext, ProvingContext  # noqa: E402


def _fib_broken(fx, params):
    """Fibonacci with one value changed at row 5: the first constraint to
    fail is a transition (a_next = b) at row 5."""
    air = fx.FibonacciAir()
    trace = air.generate_trace(1, 1, 16)
    trace[5, 1] = (trace[5, 1] + 1) % P
    return params(2, 4, 3), [air], [(trace, air.pvs(1, 1, 16), [])]


def _fib_bad_pvs(fx, params):
    """Fibonacci with a wrong last public value: only the last row fails."""
    air = fx.FibonacciAir()
    pvs = air.pvs(1, 1, 16)
    pvs[2] = (pvs[2] + 1) % P
    return params(2, 4, 3), [air], [(air.generate_trace(1, 1, 16), pvs, [])]


def _mixture_broken(fx, params):
    """A width-5 MixtureAir (col 4 = col 0 * col 1) broken at rows 9 and 3
    of two AIRs: the first AIR in context order reports."""
    airs = [fx.MixtureAir(5), fx.MixtureAir(3)]
    traces = [airs[0].generate_trace(16, seed=2), airs[1].generate_trace(8, seed=3)]
    traces[0][9, 4] = (traces[0][9, 4] + 1) % P
    traces[1][3, 2] = (traces[1][3, 2] + 1) % P
    return params(2, 4, 3), airs, [(t, [], []) for t in traces]


def _interactions_unbalanced(fx, params):
    """The golden interactions pair with a receiver row no sender matches
    ((7, 9) -> (8, 9)): two unbalanced messages."""
    sender = fx.DummyInteractionAir(2, is_send=True, bus_index=3)
    receiver = fx.DummyInteractionAir(2, is_send=False, bus_index=3)
    send = [[2, 7, 9], [1, 3, 4], [0, 0, 0], [0, 0, 0]]
    recv = [[1, 8, 9], [1, 7, 9], [1, 3, 4]] + [[0, 0, 0]] * 5
    mk = fx.DummyInteractionAir.make_trace
    return params(2, 4, 3), [sender, receiver], [(mk(send), [], []), (mk(recv), [], [])]


def _many_unbalanced(fx, params):
    """Three buses: on bus 1, 25 messages sent twice each and one received
    (the report lists 20 and counts the rest; a count of P - 1 cancels
    (24, 124)); on bus 0 messages of two lengths (a 1-word receive never
    matches a 2-word send); bus 2 balances."""
    mk = fx.DummyInteractionAir.make_trace
    airs = [
        fx.DummyInteractionAir(2, is_send=True, bus_index=1),
        fx.DummyInteractionAir(2, is_send=False, bus_index=1),
        fx.DummyInteractionAir(2, is_send=True, bus_index=0),
        fx.DummyInteractionAir(1, is_send=False, bus_index=0),
        fx.DummyInteractionAir(1, is_send=True, bus_index=2),
        fx.DummyInteractionAir(1, is_send=False, bus_index=2),
    ]
    send1 = [[1 + i % 3, i % 25, 100 + i % 25] for i in range(50)] + [[0, 0, 0]] * 14
    send1[49] = [P - 1, 24, 124]
    recv1 = [[1, 0, 100]] + [[0, 0, 0]] * 7
    ctxs = [
        (mk(send1), [], []),
        (mk(recv1), [], []),
        (mk([[1, 5, 0], [2, 5, 6], [0, 0, 0], [0, 0, 0]]), [], []),
        (mk([[1, 5], [2, 5], [0, 0], [0, 0]]), [], []),
        (mk([[3, 11], [0, 0]]), [], []),
        (mk([[1, 11], [2, 11], [0, 0], [0, 0]]), [], []),
    ]
    return params(2, 6, 3), airs, ctxs


def _valid_mixture(fx, params):
    """Balanced self-interactions at three widths beside a MixtureAir and a
    Fibonacci: every check passes."""
    airs = [fx.SelfInteractionAir(w, bus_index=i) for i, w in enumerate([4, 7, 8])]
    ctxs = [(a.generate_trace(8 << i, seed=i), [], []) for i, a in enumerate(airs)]
    fib, mix = fx.FibonacciAir(), fx.MixtureAir(3)
    airs += [fib, mix]
    ctxs += [(fib.generate_trace(1, 2, 32), fib.pvs(1, 2, 32), []), (mix.generate_trace(8), [], [])]
    return params(2, 6, 3), airs, ctxs


def _selector_broken(fx, params):
    """Fibonacci with a preprocessed selector, broken at row 3: a copy
    row's constraint fails there."""
    air = fx.FibonacciSelectorAir([i % 3 != 2 for i in range(16)])
    trace = air.generate_trace(1, 1)
    trace[3, 0] = (trace[3, 0] + 1) % P
    return params(2, 6, 3), [air], [(trace, air.pvs(1, 1), [])]


CASES = {
    "fib_broken": _fib_broken,
    "fib_bad_public_value": _fib_bad_pvs,
    "mixture_broken": _mixture_broken,
    "selector_broken": _selector_broken,
    "interactions_unbalanced": _interactions_unbalanced,
    "many_unbalanced": _many_unbalanced,
    "valid_mixture": _valid_mixture,
}


def _verdict(pkg, build):
    """The debug check's AssertionError text (None if it passes) for the
    case ``build`` made from the package ``pkg``."""
    fx = importlib.import_module(f"{pkg}.testing.fixtures")
    params = importlib.import_module(f"{pkg}.params").test_system_params_small
    engine_mod = importlib.import_module(f"{pkg}.engine")
    params, airs, ctxs = build(fx, params)
    eng = engine_mod.StarkEngine(params, device="cpu") if pkg == "swirl_torch" else engine_mod.StarkEngine(params)
    pk, _ = eng.keygen(airs)
    ctx_mod = importlib.import_module(f"{pkg}.prover.backend")
    ctx = ctx_mod.ProvingContext([eng.context_for(i, t, pv, c) for i, (t, pv, c) in enumerate(ctxs)])
    try:
        eng.debug(airs, pk, ctx)
    except AssertionError as e:
        return str(e)
    return None


@pytest.mark.parametrize("name", sorted(CASES))
def test_debug_check_matches_jax(name):
    got = _verdict("swirl_torch", CASES[name])
    want = _verdict("swirl", CASES[name])
    assert got == want
    if name.startswith("valid"):
        assert got is None
    else:
        assert got is not None


def test_debug_check_messages():
    """The port's messages, word for word, where the reference's are known."""
    assert _verdict("swirl_torch", _fib_broken) == (
        "constraint 2 of AIR FibonacciAir (id 0) failed at row 5"
    )
    report = _verdict("swirl_torch", _interactions_unbalanced)
    assert report.splitlines() == [
        "LogUp bus imbalance detected:",
        "  bus 3:",
        "    message (7, 9): net count 1 (mod p 1)",
        "      DummyInteractionAir (air 0): +2",
        "      DummyInteractionAir (air 1): -1",
        "    message (8, 9): net count -1 (mod p 2013265920)",
        "      DummyInteractionAir (air 1): -1",
    ]
    many = _verdict("swirl_torch", _many_unbalanced)
    assert "    ... and 4 more unbalanced messages" in many
    assert "(24, 124)" not in many
    assert "    message (5,): net count -3 (mod p 2013265918)" in many
    assert "    message (0, 100): net count 2 (mod p 2)" in many
    assert "bus 2" not in many


def test_disable_debug_turns_the_check_off():
    tdebug.disable_debug()
    try:
        assert _verdict("swirl_torch", _fib_broken) is None
    finally:
        tdebug.enable_debug()
    assert _verdict("swirl_torch", _fib_broken) is not None


def test_run_test_debug_checks_before_proving():
    """``run_test`` refuses a broken trace in its debug check, before the
    prover sees it."""
    fx = importlib.import_module("swirl_torch.testing.fixtures")
    params, airs, ctxs = _fib_broken(fx, importlib.import_module("swirl_torch.params").test_system_params_small)
    with pytest.raises(AssertionError, match="failed at row 5"):
        StarkEngine(params, device="cpu").run_test(airs, ctxs)


def _fib_engine():
    from swirl_torch.params import test_system_params_small
    from swirl_torch.testing.fixtures import FibonacciAir

    eng = StarkEngine(test_system_params_small(2, 6, 3), device="cpu")
    air = FibonacciAir()
    return eng, air, air.generate_trace(0, 1, 64), air.pvs(0, 1, 64)


def test_poison_fill_is_out_of_domain(monkeypatch):
    buf = sanitize.poison_fill((4, 8))
    assert buf.dtype == torch.int64 and bool((buf == sanitize.POISON).all())
    monkeypatch.setenv("SWIRL_SANITIZE", "1")
    with pytest.raises(sanitize.SanitizerError, match=r"4294967295 at buf\[0, 0\]"):
        sanitize.check_canonical(buf, "buf")
    neg = torch.zeros(3, 5, dtype=torch.int64)
    neg[2, 1] = -1
    with pytest.raises(sanitize.SanitizerError, match=r"-1 at neg\[2, 1\]"):
        sanitize.check_canonical(neg, "neg")
    host = np.zeros((2, 3), dtype=np.uint64)
    host[1, 2] = P
    with pytest.raises(sanitize.SanitizerError, match=r"at host\[1, 2\]"):
        sanitize.check_canonical(host, "host")
    sanitize.check_canonical(torch.full((2, 2), P - 1, dtype=torch.int64), "edge")


def test_sanitizer_disabled_is_noop(monkeypatch):
    monkeypatch.delenv("SWIRL_SANITIZE", raising=False)
    sanitize.check_canonical(sanitize.poison_fill((2, 2)), "buf")  # no raise


def test_clean_prove_passes_with_sanitizer_armed(monkeypatch):
    eng, air, trace, pvs = _fib_engine()
    monkeypatch.setenv("SWIRL_SANITIZE", "1")
    vk, proof = eng.run_test([air], [(trace, pvs, [])])
    eng.verify(vk, proof)


def test_poisoned_device_trace_is_caught(monkeypatch):
    """A raw (w, h) int64 tensor handed to ``context_for`` bypasses the host
    conversion; the armed sanitizer catches it before the commit."""
    eng, air, trace, pvs = _fib_engine()
    pk, _ = eng.keygen([air])
    dpk = eng.transport_pk(pk)
    poisoned = sanitize.poison_fill((2, 64))
    ctx = ProvingContext([eng.context_for(0, poisoned, pvs, [])])
    assert isinstance(ctx.per_trace[0][1], AirContext)
    monkeypatch.setenv("SWIRL_SANITIZE", "1")
    with pytest.raises(sanitize.SanitizerError, match=r"common_main\[0\]\[0, 0\]"):
        eng.prove(dpk, ctx)


def test_device_matrix_round_trip_matches_jax():
    """``from_device_matrix`` undoes ``to_device_matrix``: (h, w) canonical
    host -> (w, h) tensor -> (h, w), as the JAX package's pair does."""
    from swirl.prover.backend import from_device_matrix as jax_from
    from swirl.prover.backend import to_device_matrix as jax_to
    from swirl_torch.prover.backend import from_device_matrix, to_device_matrix

    host = np.random.default_rng(8).integers(0, P, (16, 5), dtype=np.uint64)
    dev = to_device_matrix(host, "cpu")
    assert dev.shape == (5, 16) and dev.dtype == torch.int64
    back = from_device_matrix(dev)
    assert back.dtype == np.uint64 and np.array_equal(back, host)
    assert np.array_equal(back, jax_from(jax_to(host)))
