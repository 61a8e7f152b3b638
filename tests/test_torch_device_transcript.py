"""The port's device transcript (``swirl_torch.prover.device_transcript``)
on the CPU, where kernels E and F run their plain PyTorch versions.

- Event for event against the port's host ``Transcript`` and against the
  JAX package's ``DeviceTranscript`` (Montgomery values converted): random
  schedules (hypothesis), every entry cursor, ``sample_ext`` across a
  permutation (sample cursor 1 to 3), vectors of more than 8 full blocks,
  grinds of 1 to 8 bits (the smallest witness), ``sample_bits_batch``
  against sequential ``sample_bits``.
- The GKR and WHIR stages on it against the host transcript: equal
  results and exit state.
- The four golden proofs on it: byte-identical to ``tests/golden``.
- Its host reads (``swirl_torch.testing.host_reads``): GKR at most two
  whatever its layer count, WHIR's the same for two shapes of different
  query counts and tree depths.
- Kernel E's layout, a state word a lane, by its step model: the
  permutation against the plain one (and, ``slow``, the JAX package's
  jitted permutation), its launch loop against ``duplex_plain``.

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

from swirl.prover.device_transcript import DeviceTranscript as JaxDeviceTranscript  # noqa: E402
from swirl_torch.fields import field as F  # noqa: E402
from swirl_torch.fields.babybear import P  # noqa: E402
from swirl_torch.hash import poseidon2 as p2  # noqa: E402
from swirl_torch.prover import device_transcript as dtm  # noqa: E402
from swirl_torch.prover.device_transcript import DeviceTranscript  # noqa: E402
from swirl_torch.testing.host_reads import HostReads  # noqa: E402
from swirl_torch.transcript import Transcript  # noqa: E402

U64 = np.uint64
MONT = (1 << 32) % P


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The sponge's plain versions are small ops; one intra-op thread keeps
    them from contending with the suite's other workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rand(rng, shape):
    return rng.integers(0, P, shape, dtype=np.uint64)


# --------------------------------------------------------- the schedules ---

# an event: (name, argument); vectors are numpy, observed as tensors on the
# device transcript and as host values on the host one
_EVENTS = st.one_of(
    st.tuples(st.just("observe"), st.integers(0, 2 * P)),
    st.tuples(st.just("observe_slice"), st.integers(1, 80)),
    st.tuples(st.just("observe_host"), st.integers(1, 40)),
    st.tuples(st.just("observe_ext"), st.just(4)),
    st.tuples(st.just("observe_commit"), st.just(8)),
    st.tuples(st.just("sample"), st.just(0)),
    st.tuples(st.just("sample_ext"), st.just(0)),
    st.tuples(st.just("sample_bits"), st.integers(0, 30)),
    st.tuples(st.just("sample_bits_batch"), st.integers(0, 20)),
    st.tuples(st.just("grind"), st.integers(1, 8)),
    st.tuples(st.just("check_witness"), st.integers(0, 6)),
)


def _run_host(schedule, seed):
    """Each event on the port's host transcript; returns the samples (as
    canonical numpy) and the exit (state, absorb_idx, sample_idx)."""
    rng = np.random.default_rng(seed)
    t, out = Transcript(), []
    for name, arg in schedule:
        if name == "observe":
            t.observe(arg)
        elif name in ("observe_slice", "observe_host"):
            t.observe_slice(_rand(rng, (arg,)))
        elif name in ("observe_ext", "observe_commit"):
            getattr(t, name)(_rand(rng, (arg,)))
        elif name == "sample":
            out.append(np.array([t.sample()], U64))
        elif name == "sample_ext":
            out.append(t.sample_ext())
        elif name == "sample_bits":
            out.append(np.array([t.sample_bits(arg)], U64))
        elif name == "sample_bits_batch":
            out.append(np.array([t.sample_bits(7) for _ in range(arg)], U64).reshape(-1))
        elif name == "grind":
            out.append(np.array([t.grind(arg)], U64))
        elif name == "check_witness":
            t.check_witness(arg, int(rng.integers(0, 64)))
    return out, (t.state, t.absorb_idx, t.sample_idx)


def _run_device(schedule, seed):
    rng = np.random.default_rng(seed)
    t, out = DeviceTranscript("cpu"), []
    for name, arg in schedule:
        if name == "observe":
            t.observe(arg)
        elif name == "observe_slice":
            t.observe_slice(F.const_arr(_rand(rng, (arg,))))
        elif name == "observe_host":
            t.observe_slice(_rand(rng, (arg,)))
        elif name in ("observe_ext", "observe_commit"):
            getattr(t, name)(F.const_arr(_rand(rng, (arg,))))
        elif name == "sample":
            out.append(t.sample())
        elif name == "sample_ext":
            out.append(t.sample_ext())
        elif name == "sample_bits":
            out.append(t.sample_bits(arg))
        elif name == "sample_bits_batch":
            out.append(t.sample_bits_batch(7, arg))
        elif name == "grind":
            out.append(t.grind(arg))
        elif name == "check_witness":
            t.check_witness(arg, torch.tensor(int(rng.integers(0, 64))))
    host = t.to_host()
    return [F.to_host(o).reshape(-1) for o in out], (host.state, host.absorb_idx, host.sample_idx)


def _mont(v):
    return (np.asarray(v, U64) * U64(MONT)) % U64(P)


def _run_jax(schedule, seed):
    """The JAX package's device transcript: device vectors in Montgomery
    form, samples converted back; its ``sample_bits`` and ``grind`` are
    canonical."""
    rng = np.random.default_rng(seed)
    t, out = JaxDeviceTranscript(), []
    canon = lambda x: F.to_host(F.from_jax(np.asarray(x).reshape(-1)))  # noqa: E731
    for name, arg in schedule:
        if name == "observe":
            t.observe(arg)
        elif name == "observe_slice":
            t.observe_slice(jnp.asarray(_mont(_rand(rng, (arg,))), jnp.uint32))
        elif name == "observe_host":
            t.observe_slice(_rand(rng, (arg,)))
        elif name in ("observe_ext", "observe_commit"):
            getattr(t, name)(jnp.asarray(_mont(_rand(rng, (arg,))), jnp.uint32))
        elif name == "sample":
            out.append(canon(t.sample()))
        elif name == "sample_ext":
            out.append(canon(t.sample_ext()))
        elif name == "sample_bits":
            out.append(np.asarray(t.sample_bits(arg), U64).reshape(-1))
        elif name == "sample_bits_batch":
            out.append(np.asarray(t.sample_bits_batch(7, arg), U64).reshape(-1))
        elif name == "grind":
            out.append(np.asarray(t.grind(arg), U64).reshape(-1))
        elif name == "check_witness":
            t.check_witness(arg, int(rng.integers(0, 64)))
    return out, (canon(t.state), t.absorb_idx, t.sample_idx)


def _same(a, b):
    (outs_a, (sa, ia, ja)), (outs_b, (sb, ib, jb)) = a, b
    assert len(outs_a) == len(outs_b)
    for x, y in zip(outs_a, outs_b):
        assert np.array_equal(np.asarray(x, U64), np.asarray(y, U64))
    assert np.array_equal(np.asarray(sa, U64), np.asarray(sb, U64)) and (ia, ja) == (ib, jb)


@settings(max_examples=15, deadline=None, database=None)
@given(st.lists(_EVENTS, min_size=1, max_size=12), st.integers(0, 1 << 30))
def test_random_schedules_match_the_host_transcript(schedule, seed):
    _same(_run_device(schedule, seed), _run_host(schedule, seed))


@settings(max_examples=5, deadline=None, database=None)
@given(st.lists(_EVENTS, min_size=1, max_size=10), st.integers(0, 1 << 30))
def test_random_schedules_match_the_jax_device_transcript(schedule, seed):
    _same(_run_device(schedule, seed), _run_jax(schedule, seed))


def _to_cursor(a, s):
    """Events from a fresh transcript to the cursors (a, s): a full block
    (permutes), 8 - s single samples, then a absorbs."""
    return [("observe_host", 8)] + [("sample", 0)] * (8 - s) + [("observe", 3)] * a


@pytest.mark.parametrize("s", range(9))
@pytest.mark.parametrize("a", [0, 3, 7])
def test_every_entry_cursor(a, s):
    """sample_ext and a GKR sub-round's absorb of 12 then squeeze of 4 from
    each (absorb, sample) cursor; at a = 0 and s = 1 to 3 sample_ext squeezes
    across a permutation."""
    schedule = _to_cursor(a, s) + [("sample_ext", 0), ("observe_slice", 12), ("sample_ext", 0)]
    device = _run_device(schedule, a * 16 + s)
    _same(device, _run_host(schedule, a * 16 + s))
    _same(device, _run_jax(schedule, a * 16 + s))


@pytest.mark.parametrize("a", [0, 5])
def test_vectors_of_more_than_eight_blocks(a):
    schedule = [("observe", 1)] * a + [("observe_slice", 8 * 11 + 3), ("sample_ext", 0),
                                       ("observe_slice", 8 * 9), ("sample", 0)]
    _same(_run_device(schedule, a), _run_host(schedule, a))
    _same(_run_device(schedule, a), _run_jax(schedule, a))


@pytest.mark.parametrize("bits", range(1, 9))
def test_grind_finds_the_smallest_witness(bits):
    """The host grind is the native library's scan, or numpy's: the
    smallest witness; the plain grind gives the same witness and state."""
    schedule = [("observe_host", 5), ("grind", bits), ("sample_ext", 0)]
    _same(_run_device(schedule, bits), _run_host(schedule, bits))
    st0 = F.const_arr(_rand(np.random.default_rng(bits), (16,)))
    _, w = p2.grind_plain(st0, 2, bits)
    states = st0.repeat(int(w) + 1, 1)
    states[:, 2] = torch.arange(int(w) + 1)
    hits = (p2.permute_plain(states)[:, 7] & ((1 << bits) - 1)) == 0
    assert hits[-1] and not hits[:-1].any()  # every smaller candidate misses, w hits


@pytest.mark.parametrize("a,s", [(0, 0), (0, 5), (4, 8), (7, 2)])
def test_sample_bits_batch_is_sequential_sample_bits(a, s):
    prefix = _to_cursor(a, s)
    batch, seq = DeviceTranscript("cpu"), DeviceTranscript("cpu")
    for t in (batch, seq):
        t.load(_host_after(prefix))
    got = batch.sample_bits_batch(13, 19)
    want = torch.stack([seq.sample_bits(13) for _ in range(19)])
    assert torch.equal(got, want)
    hb, hs = batch.to_host(), seq.to_host()
    assert np.array_equal(hb.state, hs.state) and (hb.absorb_idx, hb.sample_idx) == (hs.absorb_idx, hs.sample_idx)


def _host_after(schedule):
    rng = np.random.default_rng(0)
    t = Transcript()
    for name, arg in schedule:
        if name == "observe_host":
            t.observe_slice(_rand(rng, (arg,)))
        elif name == "observe":
            t.observe(arg)
        else:
            t.sample()
    return t


def test_duplex_absorb_sample_ext_matches_jax():
    from swirl.prover.device_transcript import duplex_absorb_sample_ext as jax_absorb

    rng = np.random.default_rng(3)
    state, flat = _rand(rng, (16,)), _rand(rng, (20,))
    st_t, r = dtm.duplex_absorb_sample_ext(F.const_arr(state), F.const_arr(flat))
    j_state, j_r = jax_absorb(jnp.asarray(_mont(state), jnp.uint32), jnp.asarray(_mont(flat), jnp.uint32))
    assert torch.equal(st_t, F.from_jax(np.asarray(j_state)))
    assert torch.equal(r, F.from_jax(np.asarray(j_r)))


def _row_states():
    """Random states, all 0 and all P - 1."""
    rng = np.random.default_rng(21)
    edges = np.stack([np.zeros(16, U64), np.full(16, P - 1, U64)])
    return F.const_arr(np.concatenate([_rand(rng, (30, 16)), edges]))


def test_row_permutation_model_matches_plain():
    """Kernel E's permutation, a word a lane (``permute_row``), by the model
    with every bound asserted, equals the plain permutation."""
    st = _row_states()
    assert torch.equal(p2.permute_row_model(st), p2.permute_plain(st))


# kernel E's launches by the model: (absorb cursor, sample cursor, device
# felts, host felts, squeezes, bits): a GKR sub-round, absorbs of 8m - 1, 8m
# and 8m + 1 felts from the first word and from the middle of a block, host
# felts after device felts, a run of masked squeezes
_DUPLEX_MODEL_CASES = [(5, 5, 12, 0, 4, -1), (0, 4, 95, 0, 4, -1), (0, 4, 96, 0, 0, -1), (0, 4, 97, 0, 4, -1),
                       (3, 8, 93, 0, 1, -1), (3, 8, 88, 5, 4, -1), (7, 2, 0, 1, 3, -1), (0, 7, 0, 0, 20, 19)]


@pytest.mark.parametrize("case", _DUPLEX_MODEL_CASES)
def test_duplex_model_matches_plain(case):
    """Kernel E's loop by the model (each lane's word of a block, the next
    block's felt fetched before the permutation) equals ``duplex_plain``."""
    a, s, k, n_host, n_squeeze, bits = case
    rng = np.random.default_rng(k + n_host)
    st = F.const_arr(_rand(rng, (16,)))
    absorb = F.const_arr(_rand(rng, (k,))) if k else None
    host = [int(v) for v in _rand(rng, (n_host,))]
    got = p2.duplex_model(st, absorb, host, a, s, n_squeeze, bits)
    want = p2.duplex_plain(st, absorb, host, a, s, n_squeeze, bits)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.slow
def test_row_permutation_model_matches_jax_permute():
    """The row model equals the JAX package's jitted permutation (the device
    transcript's), on Montgomery words."""
    from swirl.hash import jposeidon2 as jp2

    st = _row_states()
    want = np.asarray(jax.jit(jp2.permute)(jnp.asarray(_mont(F.to_host(st)), jnp.uint32)))
    assert torch.equal(p2.permute_row_model(st), F.from_jax(want.reshape(-1)).reshape(st.shape))


def test_handoff_round_trip():
    host = _host_after(_to_cursor(3, 6))
    t = DeviceTranscript.from_host(host, "cpu")
    back = t.to_host()
    assert np.array_equal(back.state, host.state)
    assert (back.absorb_idx, back.sample_idx) == (3, 6)
    with pytest.raises(ValueError):
        t.grind(31)
    with pytest.raises(ValueError):
        t.observe_ext(torch.zeros(3, dtype=torch.int64))


# ---------------------------------------------------------------- stages ---


def _gkr_input(rng, log_n, balanced):
    p = np.zeros((1 << log_n, 4), U64)
    p[:, 0] = _rand(rng, (1 << log_n,))
    q = _rand(rng, (1 << log_n, 4))
    if balanced:  # the second half cancels the first
        half = 1 << (log_n - 1)
        p[half:] = (P - p[:half]) % P
        q[half:] = q[:half]
    return F.const_arr(p), F.const_arr(q)


def _prefixed(t):
    t.observe_slice(np.arange(11, dtype=U64))
    return t


@pytest.mark.parametrize("log_n,balanced", [(4, False), (7, True)])
def test_gkr_on_the_device_transcript(log_n, balanced):
    """Equal result and exit state to the host transcript's, and at most
    two host reads (the root's zero check, the one copy at the end) for 4
    or 7 layers."""
    from swirl_torch.prover.gkr import fractional_sumcheck

    p, q = _gkr_input(np.random.default_rng(log_n), log_n, balanced)
    host = _prefixed(Transcript())
    want = fractional_sumcheck(host, p, q, assert_zero=balanced)
    dt = DeviceTranscript.from_host(_prefixed(Transcript()), "cpu")
    with HostReads() as reads:
        got = fractional_sumcheck(dt, p, q, assert_zero=balanced)
    assert reads.reads["total"] <= 2
    assert _equal(got.fractional_sum, want.fractional_sum)
    assert _equal(got.sumcheck_polys, want.sumcheck_polys) and _equal(got.xi, want.xi)
    assert _equal([vars(c) for c in got.claims_per_layer], [vars(c) for c in want.claims_per_layer])
    back = dt.to_host()
    assert np.array_equal(back.state, host.state)
    assert (back.absorb_idx, back.sample_idx) == (host.absorb_idx, host.sample_idx)


def _equal(a, b) -> bool:
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    return np.array_equal(np.asarray(a, U64), np.asarray(b, U64))


def _whir_case(log_h, queries, seed):
    """Params with ``queries`` per WHIR round at k = 2 and two stacked
    commitments of height 2^log_h, with the opening point u."""
    from swirl_torch.params import (
        LogUpSecurityParameters, SystemParams, WhirConfig, WhirProximityStrategy, WhirRoundConfig)
    from swirl_torch.prover.stacked_pcs import stacked_commit

    l_skip, k = 2, 2
    whir = WhirConfig(k=k, rounds=tuple(WhirRoundConfig(n) for n in queries), mu_pow_bits=3,
                      query_phase_pow_bits=2, folding_pow_bits=1, proximity=WhirProximityStrategy("unique"))
    params = SystemParams(l_skip=l_skip, n_stack=log_h - l_skip, w_stack=1 << 12, log_blowup=1, whir=whir,
                          logup=LogUpSecurityParameters(1 << 30, 7, 2), max_constraint_degree=3)
    rng = np.random.default_rng(seed)
    committed = [stacked_commit(l_skip, log_h - l_skip, 1, k, [F.const_arr(_rand(rng, (w, 1 << log_h)))])[1]
                 for w in (3, 2)]
    u = [_rand(rng, (4,)) for _ in range(log_h)]
    return params, committed, u


def _whir_on(transcript, case):
    from swirl_torch.prover.whir import prove_whir_opening

    return prove_whir_opening(transcript, *case)


@pytest.mark.parametrize("log_h,queries", [(6, (3, 2)), (7, (7, 5, 3))])
def test_whir_on_the_device_transcript(log_h, queries):
    """Equal proof and exit state to the host transcript's; one host read
    (the proof's copy at the end) whatever the queries and the depth."""
    case = _whir_case(log_h, queries, log_h)
    host = _prefixed(Transcript())
    want = _whir_on(host, case)
    dt = DeviceTranscript.from_host(_prefixed(Transcript()), "cpu")
    with HostReads() as reads:
        got = _whir_on(dt, case)
    assert reads.reads["total"] == 1
    assert _equal(vars(got), vars(want))
    back = dt.to_host()
    assert np.array_equal(back.state, host.state)
    assert (back.absorb_idx, back.sample_idx) == (host.absorb_idx, host.sample_idx)


# ---------------------------------------------------------------- proofs ---


@pytest.mark.parametrize("name", ["fib", "interactions", "preprocessed", "cached_preprocessed"])
def test_golden_proofs_on_the_device_transcript(name):
    from swirl_torch.codec import encode_proof
    from swirl_torch.engine import StarkEngine
    from swirl_torch.testing.golden import golden_cases, paths_for

    params, airs, ctxs = golden_cases()[name]()
    t = DeviceTranscript("cpu")
    _, proof = StarkEngine(params, device="cpu").run_test(airs, ctxs, t)
    with open(paths_for(name)["proof"], "rb") as f:
        assert encode_proof(proof) == f.read()


def test_prover_refuses_a_transcript_on_another_device():
    from swirl_torch.engine import StarkEngine
    from swirl_torch.prover.errors import ProverError
    from swirl_torch.testing.golden import golden_cases

    params, airs, ctxs = golden_cases()["fib"]()
    t = DeviceTranscript("meta")
    with pytest.raises(ProverError, match="transcript is on meta"):
        StarkEngine(params, device="cpu").run_test(airs, ctxs, t, debug=False)
