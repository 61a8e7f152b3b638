"""Zerocheck and the stacked opening reduction on the port's device
transcript, on the CPU.

- The device EF4 arithmetic (``swirl_torch.fields.field``: ``einv``,
  ``ext_mul_small``, ``epowers``, ``ext_sum``, ``ext_from_base``) and the
  device polynomial math (``swirl_torch.tpoly``) against the JAX package's
  ``swirl/fields/text.py`` and ``swirl/tpoly.py`` (Montgomery values
  converted), with a batch dimension on the port's side: bit-equal.
- Whole proves on ``DeviceTranscript("cpu")`` against the host transcript:
  the same proof bytes and final sponge, accepted by ``swirl.verifier``,
  for SyntheticAirs with a trace that runs out of rounds early (the tilde
  regimes of both stages, one through the level-scheduled DAG
  interpreter), a trace below 2^l_skip rows (lifted), a trace without
  interactions, and the rotation every SyntheticAir needs; and the golden
  Fibonacci case (no interactions: no GKR).
- The host reads of each stage span (``swirl_torch.testing.host_reads``):
  the same fixed numbers at two sizes, so no round reads the host.

Tolerance: exact equality (finite field, bytes).
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402

from swirl import tpoly as jtpoly  # noqa: E402
from swirl.fields import jfield as jf  # noqa: E402
from swirl.fields import text  # noqa: E402
from swirl_torch import tpoly  # noqa: E402
from swirl_torch.fields import ext as hext  # noqa: E402
from swirl_torch.fields import field as F  # noqa: E402
from swirl_torch.fields.babybear import GENERATOR, P  # noqa: E402

U64 = np.uint64


def _rand(rng, shape):
    return rng.integers(0, P, shape, dtype=U64)


def _t(a):
    return F.const_arr(a)


def _j(a):
    return jnp.asarray(jf.const_arr(np.asarray(a, U64)))


def _h(x) -> np.ndarray:
    return jf.to_host(x)


def _each(fn, *batched):
    """The JAX function on each batch entry of numpy inputs, stacked."""
    return np.stack([_h(fn(*(_j(a[i]) for a in batched))) for i in range(batched[0].shape[0])])


# ------------------------------------------------------------ EF4 values ---

_LANE = st.one_of(st.just(0), st.just(1), st.just(P - 1), st.integers(0, P - 1))


@settings(max_examples=40, deadline=None)
@given(st.lists(st.lists(_LANE, min_size=4, max_size=4), min_size=1, max_size=6))
def test_einv_matches_jax_on_every_lane(values):
    """F.einv against text.einv (zero maps to zero on both) and against the
    host's hext.einv where the value is not zero."""
    a = np.asarray(values, U64)
    got = F.to_host(F.einv(_t(a)))
    for i in range(a.shape[0]):
        assert np.array_equal(got[i], _h(text.einv(_j(a[i]))))
        if a[i].any():
            assert np.array_equal(got[i], hext.einv(a[i]))
        else:
            assert not got[i].any()


def test_batch_einv_matches_jax():
    a = _rand(np.random.default_rng(1), (9, 4))
    assert np.array_equal(F.to_host(F.einv(_t(a))), _h(text.batch_einv(_j(a))))


def test_small_field_ops_match_jax():
    rng = np.random.default_rng(2)
    a, b = _rand(rng, (5, 3, 4)), _rand(rng, (3, 4))
    assert np.array_equal(F.to_host(F.ext_mul_small(_t(a), _t(b))), hext.emul(a, b))
    assert np.array_equal(F.to_host(F.ext_mul_small(_t(a), _t(b))), _h(text.emul(_j(a), _j(b))))
    assert np.array_equal(F.to_host(F.ext_sum(_t(a), axis=1)), _h(text.esum(_j(a), axis=1)))
    base = _rand(rng, (6,))
    assert np.array_equal(F.to_host(F.ext_from_base(_t(base))), _h(text.from_base(_j(base))))
    for n in (1, 5, 9, 16):
        got = F.to_host(F.epowers(_t(b), n))  # (3, n, 4)
        assert np.array_equal(got, _each(lambda x: text.epowers(x, n), b))


# ------------------------------------------------------ polynomial math ---

B = 3  # the port's batch: the JAX function runs once per entry


def _cases(rng, l_skip):
    pt = lambda *s: _rand(rng, (B,) + s + (4,))  # noqa: E731
    lag_pts = (0, 1, 2, 5, 7)
    return {
        "eval_eq_mle": ((pt(5), pt(5)), tpoly.eval_eq_mle, jtpoly.eval_eq_mle),
        "evals_eq_hypercube": ((pt(3),), tpoly.evals_eq_hypercube, jtpoly.evals_eq_hypercube),
        "eval_eq_uni": (
            (pt(), pt()),
            lambda x, y: tpoly.eval_eq_uni(l_skip, x, y),
            lambda x, y: jtpoly.eval_eq_uni(l_skip, x, y),
        ),
        "eval_eq_uni_at_one": (
            (pt(),),
            lambda x: tpoly.eval_eq_uni_at_one(l_skip, x),
            lambda x: jtpoly.eval_eq_uni_at_one(l_skip, x),
        ),
        **{
            f"eval_in_uni_{n}": (
                (pt(),),
                lambda z, n=n: tpoly.eval_in_uni(l_skip, n, z),
                lambda z, n=n: jtpoly.eval_in_uni(l_skip, n, z),
            )
            for n in (-2, -1, 0, 1)
        },
        "eval_eq_sharp_uni": (
            (pt(l_skip), pt()),
            lambda xi, z: tpoly.eval_eq_sharp_uni(l_skip, xi, z),
            lambda xi, z: jtpoly.eval_eq_sharp_uni(l_skip, xi, z),
        ),
        "eq_uni_poly": (
            (pt(),),
            lambda x: tpoly.eq_uni_poly(l_skip, x),
            lambda x: jtpoly.eq_uni_poly(l_skip, x),
        ),
        "eq_sharp_uni_poly": ((pt(l_skip),), tpoly.eq_sharp_uni_poly, jtpoly.eq_sharp_uni_poly),
        "horner_eval": ((pt(7), pt()), tpoly.horner_eval, jtpoly.horner_eval),
        "lagrange_coeffs": (
            (pt(len(lag_pts)),),
            lambda e: tpoly.lagrange_coeffs(lag_pts, e),
            lambda e: jtpoly.lagrange_coeffs(lag_pts, e),
        ),
        "dft_ef": ((pt(8),), tpoly.dft_ef, jtpoly.dft_ef),
        "idft_ef": ((pt(8),), tpoly.idft_ef, jtpoly.idft_ef),
        "from_geometric_cosets_evals": (
            (pt(1 << l_skip, 3),),
            lambda e: tpoly.from_geometric_cosets_evals(e, GENERATOR, GENERATOR),
            lambda e: jtpoly.from_geometric_cosets_evals(e, GENERATOR, GENERATOR),
        ),
        "powers_ef": ((pt(),), lambda x: F.epowers(x, 11), lambda x: jtpoly.powers_ef(x, 11)),
    }


_NAMES = sorted(_cases(np.random.default_rng(0), 2))


@pytest.mark.parametrize("l_skip", [2, 3])
@pytest.mark.parametrize("name", _NAMES)
def test_tpoly_matches_jax(name, l_skip):
    inputs, port, ref = _cases(np.random.default_rng(l_skip), l_skip)[name]
    got = F.to_host(port(*(_t(a) for a in inputs)))
    assert np.array_equal(got, _each(ref, *inputs))


@pytest.mark.parametrize("l_skip", [2, 3])
def test_barycentric_weights_match_the_host_weights(l_skip):
    from swirl.prover.sumcheck import barycentric_weights_host

    r = _rand(np.random.default_rng(9), (B, 4))
    got = F.to_host(tpoly.barycentric_weights(l_skip, _t(r)))
    assert np.array_equal(got, np.stack([barycentric_weights_host(l_skip, x) for x in r]))


# ------------------------------------------------------ the two stages ---

# (log height, width, interactions, constraints) per AIR, n_stack
SHAPES = {
    # the second trace runs out of zerocheck rounds after one (its tail and
    # its views' tilde regime in the stacked reduction), the third is below
    # 2^l_skip rows and has no interactions
    "small": (((6, 6, 2, 4), (3, 5, 2, 4), (1, 4, 0, 4)), 5),
    # two more rounds in each stage; the exhausted trace's 60 constraints
    # make a DAG of over 128 nodes (the level-scheduled interpreter)
    "large": (((8, 6, 2, 4), (5, 5, 2, 60), (1, 4, 0, 4)), 7),
}


def _synthetic(shapes, n_stack):
    from swirl_torch.engine import StarkEngine
    from swirl_torch.params import test_system_params_small
    from swirl_torch.prover.backend import ProvingContext
    from swirl_torch.testing.synthetic import SyntheticAir, uniform_shape

    rng = np.random.default_rng(n_stack)
    airs, traces = [], []
    for log_h, width, interactions, constraints in shapes:
        air = SyntheticAir(uniform_shape(log_h, width, constraints, interactions, degree=3))
        trace = _rand(rng, (1 << log_h, air.common_main_width()))
        trace[:, 0] = 0  # the kill column: every constraint holds, every bus balances
        airs.append(air)
        traces.append(trace)
    eng = StarkEngine(test_system_params_small(2, n_stack, 3), device="cpu")
    pk, vk = eng.keygen(airs)
    ctx = ProvingContext([eng.context_for(i, t, [], []) for i, t in enumerate(traces)])
    return eng, vk, eng.transport_pk(pk), ctx


def _golden_fib():
    from swirl_torch.engine import StarkEngine
    from swirl_torch.prover.backend import ProvingContext
    from swirl_torch.testing.golden import golden_cases

    params, airs, ctxs = golden_cases()["fib"]()
    eng = StarkEngine(params, device="cpu")
    pk, vk = eng.keygen(airs)
    ctx = ProvingContext([eng.context_for(i, *c) for i, c in enumerate(ctxs)])
    return eng, vk, eng.transport_pk(pk), ctx


@pytest.fixture(scope="module", params=["small", "large", "fib"])
def proved(request):
    """(case, vk, host proof, device proof, host and device final sponges,
    device host reads, the DAG sizes) of one case."""
    from swirl_torch.prover.device_transcript import DeviceTranscript
    from swirl_torch.testing.host_reads import HostReads
    from swirl_torch.transcript import Transcript

    torch.set_num_threads(1)
    case = request.param
    eng, vk, dpk, ctx = _golden_fib() if case == "fib" else _synthetic(*SHAPES[case])
    host = Transcript()
    want = eng.prove(dpk, ctx, host)
    dt = DeviceTranscript("cpu")
    with HostReads() as reads:
        got = eng.prove(dpk, ctx, dt)
    nodes = [len(a.symbolic_constraints.nodes) for a in vk.per_air]
    return case, vk, want, got, host, dt.to_host(), reads, nodes


def test_device_transcript_proof_equals_the_host_one(proved):
    """Proof bytes and the final sponge (state and cursors) equal, and
    ``swirl.verifier`` accepts the bytes."""
    from swirl.codec import decode_proof, decode_vk
    from swirl.verifier import verify
    from swirl_torch.codec import encode_proof, encode_vk

    case, vk, want, got, host, dev, _, nodes = proved
    assert encode_proof(got) == encode_proof(want)
    assert np.array_equal(dev.state, host.state)
    assert (dev.absorb_idx, dev.sample_idx) == (host.absorb_idx, host.sample_idx)
    if case == "large":
        assert max(nodes) >= 128  # the exhausted trace's DAG, through the interpreter
    jvk = decode_vk(encode_vk(vk))
    verify(jvk.params, jvk, decode_proof(encode_proof(got)))


def test_stage_host_reads_do_not_grow_with_the_rounds(proved):
    """The same reads per span in every case, whatever its rounds: none
    inside a round loop. Without interactions GKR does not run, and the
    RAP stage reads once. Every tensor from host data inside a stage was
    made by an earlier prove (the host transcript's), so none is made."""
    from swirl_torch.testing.host_reads import STAGE_READS

    case, *_, reads, _ = proved
    want = dict(STAGE_READS)
    if case == "fib":
        del want["fractional_sumcheck"]
        want["prove_rap_constraints"] = 1
    assert {k: reads.reads[k] for k in want} == want
    assert reads.reads["fractional_sumcheck"] == want.get("fractional_sumcheck", 0)
    stages = ("prove_rap_constraints", "prove_stacked_reduction", "prove_whir")
    assert all(reads.writes[k] == 0 for k in stages)
