"""Kernel K (``swirl_torch/csrc/gkr.cu``), GKR's layer sumcheck a pass a
sub-round, on the CPU: its plain version against the sequence it replaced
(the round evaluation, then the folds), a model of the kernel's own
arithmetic (Montgomery products, the evaluations carried at R^-2, the
fold's four entries a thread) against the plain version, the eq table, the
launch plan, and ``fractional_sumcheck`` on a ``DeviceTranscript("cpu")``
against the former loop and the JAX package. The kernel itself runs in
``tests/test_torch_kernels_cuda.py``. Tolerance: exact equality (finite
field).
"""

import numpy as np
import pytest
import torch

import jax

jax.config.update("jax_platforms", "cpu")

from swirl_torch import metrics  # noqa: E402
from swirl_torch.fields import field as F  # noqa: E402
from swirl_torch.fields.babybear import P  # noqa: E402
from swirl_torch.prover import gkr  # noqa: E402
from swirl_torch.prover.device_transcript import DeviceTranscript  # noqa: E402
from swirl_torch.prover.sumcheck import eq_hypercube, fold_mle, interp_mle_at_int  # noqa: E402
from swirl_torch.transcript import Transcript  # noqa: E402

U64 = np.uint64
R = (1 << 32) % P
RINV = pow(R, P - 2, P)
R2 = R * R % P
W11 = 11 * R % P
R3 = R2 * R % P


def _rand(rng, shape):
    return F.const_arr(rng.integers(0, P, shape, dtype=U64))


# -- the sequence the kernel replaced ------------------------------------------


def _evals_then_fold(cols, lam):
    """The round polynomial at X = 1, 2, 3 of the five columns, as the
    layer loop computed it before the kernel."""
    out = []
    for x in (1, 2, 3):
        e, a0, b0, a1, b1 = (interp_mle_at_int(c, x) for c in cols)
        p_prev = F.add(F.ext_mul(a0, b1), F.ext_mul(a1, b0))
        q_prev = F.ext_mul(b0, b1)
        val = F.ext_mul(e, F.add(p_prev, F.ext_mul(lam, q_prev)))
        out.append(F.ext_sum(val, axis=0))
    return torch.stack(out)


def _former_fractional_sumcheck(tr, p, q):
    """The layer loop before the kernel, on a host transcript: (claims,
    round polynomials, xi) as host arrays."""
    layers = [(p, q)]
    while layers[-1][0].shape[0] > 1:
        a, b = layers[-1]
        layers.append((F.add(F.ext_mul(a[0::2], b[1::2]), F.ext_mul(a[1::2], b[0::2])),
                       F.ext_mul(b[0::2], b[1::2])))
    layers.reverse()
    total = len(layers) - 1
    tr.observe_ext(F.to_host(layers[0][1][0]))
    p1, q1 = layers[1]
    claims = [F.to_host(torch.stack([p1[0], q1[0], p1[1], q1[1]]))]
    tr.observe_slice(claims[0])
    xi = F.const_arr(tr.sample_ext())[None]
    polys = []
    for rnd in range(1, total):
        lam = F.const_arr(tr.sample_ext())
        a, b = layers[rnd + 1]
        cols = [eq_hypercube(xi, "cpu"), a[0::2], b[0::2], a[1::2], b[1::2]]
        rho = []
        for _ in range(rnd):
            polys.append(F.to_host(_evals_then_fold(cols, lam)))
            tr.observe_slice(polys[-1])
            r = F.const_arr(tr.sample_ext())
            rho.append(r)
            cols = [fold_mle(c, r) for c in cols]
        claims.append(F.to_host(torch.stack([c[0] for c in cols[1:]])))
        tr.observe_slice(claims[-1])
        xi = torch.cat([F.const_arr(tr.sample_ext())[None], torch.stack(rho)])
    return claims, polys, F.to_host(xi)


# -- a model of the kernel's arithmetic ----------------------------------------


def _mont(a, b):
    return (a * b % U64(P)) * U64(RINV) % U64(P)


def _add(a, b):
    return (a + b) % U64(P)


def _sub(a, b):
    return (a + U64(P) - b) % U64(P)


def _factor(b):
    """(b R, 11 b R) of a (4,) value: the form a challenge takes."""
    m = _mont(b, U64(R2))
    return m, _mont(m, U64(W11))


def _fmul(x, f):
    """x b for a factor (m, w) of b, at x's scale; x: (k, 4)."""
    m, w = f
    x0, x1, x2, x3 = (x[:, j] for j in range(4))
    return np.stack([
        _add(_add(_mont(x0, m[0]), _mont(x1, w[3])), _add(_mont(x2, w[2]), _mont(x3, w[1]))),
        _add(_add(_mont(x0, m[1]), _mont(x1, m[0])), _add(_mont(x2, w[3]), _mont(x3, w[2]))),
        _add(_add(_mont(x0, m[2]), _mont(x1, m[1])), _add(_mont(x2, m[0]), _mont(x3, w[3]))),
        _add(_add(_mont(x0, m[3]), _mont(x1, m[2])), _add(_mont(x2, m[1]), _mont(x3, m[0]))),
    ], axis=1)


def _rmul(x, y):
    """x y / R of two (k, 4) values."""
    x0, x1, x2, x3 = (x[:, j] for j in range(4))
    y0, y1, y2, y3 = (y[:, j] for j in range(4))
    h0 = _add(_add(_mont(x1, y3), _mont(x2, y2)), _mont(x3, y1))
    h1 = _add(_mont(x2, y3), _mont(x3, y2))
    h2 = _mont(x3, y3)
    w = U64(W11)
    return np.stack([
        _add(_mont(x0, y0), _mont(h0, w)),
        _add(_add(_mont(x0, y1), _mont(x1, y0)), _mont(h1, w)),
        _add(_add(_mont(x0, y2), _mont(x1, y1)), _add(_mont(x2, y0), _mont(h2, w))),
        _add(_add(_mont(x0, y3), _mont(x1, y2)), _add(_mont(x2, y1), _mont(x3, y0))),
    ], axis=1)


def _fold(t0, t1, f):
    return _add(t0, _fmul(_sub(t1, t0), f))


def _k_model(cols, r, lam):
    """One pass of kernel K on host arrays, as its threads compute it: each
    pair k folds the source's entries 4k .. 4k + 3 (or takes 2k, 2k + 1 on
    a first pass), then s(1), s(2), s(3) at R^-2, summed and multiplied by
    R^3 at the end."""
    src = [F.to_host(c) for c in cols]
    fr = None if r is None else _factor(F.to_host(r))
    if lam is None:
        return np.stack([_fold(c[0:1], c[1:2], fr)[0] for c in src[1:]]), None
    if r is None:
        t0, t1 = [c[0::2] for c in src], [c[1::2] for c in src]
        out = src
    else:
        t0 = [_fold(c[0::4], c[1::4], fr) for c in src]
        t1 = [_fold(c[2::4], c[3::4], fr) for c in src]
        out = [np.stack([a, b], axis=1).reshape(-1, 4) for a, b in zip(t0, t1)]
    fl = _factor(F.to_host(lam))
    d = [_sub(b, a) for a, b in zip(t0, t1)]
    v = list(t1)
    evals = []
    for x in range(3):
        if x:
            v = [_add(a, b) for a, b in zip(v, d)]
        pq = _add(_rmul(v[1], v[4]), _rmul(v[3], v[2]))
        val = _rmul(v[0], _add(pq, _fmul(_rmul(v[2], v[4]), fl)))
        evals.append(_mont(val.sum(axis=0) % U64(P), U64(R3)))
    return out, np.stack(evals)


def _eq_model(xi):
    """Kernel K's eq table on host arrays: per group of four entries the
    product over the high bits, then the two low bits by doubling."""
    x = F.to_host(xi)
    n = x.shape[0]
    one = np.array([1, 0, 0, 0], U64)
    w = [[_factor(_sub(one, x[i])) for i in range(n)], [_factor(x[i]) for i in range(n)]]
    low = min(n, 2)
    out = np.zeros((1 << n, 4), U64)
    for g in range(1 << (n - low)):
        hi = one[None]
        for i in range(low, n):
            hi = _fmul(hi, w[(g >> (i - low)) & 1][i])
        vs = [_fmul(hi, w[b1][1]) for b1 in (0, 1)] if low == 2 else [hi]
        for j, v in enumerate(vs):
            for b0 in (0, 1):
                out[(g << low) + 2 * j + b0] = _fmul(v, w[b0][0])[0]
    return out


def _columns(rng, n):
    return [_rand(rng, (n, 4)) for _ in range(5)]


# -- the tests -------------------------------------------------------------------


@pytest.mark.parametrize("m", [1, 2, 4, 8, 64, 1024])
def test_plain_pass_is_the_evaluation_then_the_fold(m):
    """A pass that folds 2m entries at r and evaluates the next sub-round
    gives what the former order gave (evaluate a sub-round, fold, evaluate
    the next); a first pass evaluates the m entries as they are; the last
    (m = 1) gives the folded p0, q0, p1, q1."""
    rng = np.random.default_rng(m)
    cols, r, lam = _columns(rng, 2 * m), _rand(rng, (4,)), _rand(rng, (4,))
    folded = [fold_mle(c, r) for c in cols]
    if m == 1:
        claims, none = gkr.gkr_round_plain(cols, r)
        assert none is None and torch.equal(claims, torch.stack([c[0] for c in folded[1:]]))
        return
    got, evals = gkr.gkr_round_plain(cols, r, lam)
    assert all(torch.equal(a, b) for a, b in zip(got, folded))
    assert torch.equal(evals, _evals_then_fold(folded, lam))
    same, first = gkr.gkr_round_plain(folded, None, lam)
    assert same == folded and torch.equal(first, _evals_then_fold(folded, lam))


@pytest.mark.parametrize("m", [1, 2, 4, 8, 64, 1024])
def test_kernel_arithmetic_model_matches_plain(m):
    """The kernel's arithmetic, modelled on host integers, gives the plain
    version's folds, evaluations and claims bit for bit; the first pass
    reads p0, q0, p1, q1 as the stride-2 views of a layer's p and q."""
    rng = np.random.default_rng(100 + m)
    cols, r, lam = _columns(rng, 2 * m), _rand(rng, (4,)), _rand(rng, (4,))
    want, want_evals = gkr.gkr_round_plain(cols, r, lam if m > 1 else None)
    got, got_evals = _k_model(cols, r, lam if m > 1 else None)
    if m == 1:
        assert np.array_equal(got, F.to_host(want))
        return
    assert all(np.array_equal(a, F.to_host(b)) for a, b in zip(got, want))
    assert np.array_equal(got_evals, F.to_host(want_evals))
    p, q = _rand(rng, (2 * m, 4)), _rand(rng, (2 * m, 4))
    layer = [cols[0][:m], p[0::2], q[0::2], p[1::2], q[1::2]]
    assert np.array_equal(_k_model(layer, None, lam)[1], F.to_host(gkr.gkr_round_plain(layer, None, lam)[1]))


def test_kernel_arithmetic_on_the_largest_values():
    """Every entry and challenge P - 1: the model's lazy forms stay exact."""
    cols = [torch.full((8, 4), P - 1, dtype=torch.int64) for _ in range(5)]
    r = lam = torch.full((4,), P - 1, dtype=torch.int64)
    want, want_evals = gkr.gkr_round_plain(cols, r, lam)
    got, got_evals = _k_model(cols, r, lam)
    assert all(np.array_equal(a, F.to_host(b)) for a, b in zip(got, want))
    assert np.array_equal(got_evals, F.to_host(want_evals))


@pytest.mark.parametrize("n", [1, 2, 3, 6, 10])
def test_eq_table_matches_eq_hypercube(n):
    """The GKR eq table, as the kernel builds it and on the CPU, is
    ``eq_hypercube``'s doubling table."""
    xi = _rand(np.random.default_rng(n), (n, 4))
    want = eq_hypercube(xi, "cpu")
    assert torch.equal(gkr.gkr_eq(xi), want)
    assert np.array_equal(_eq_model(xi), F.to_host(want))


@pytest.mark.parametrize("work,sms,blocks", [
    (1, 132, 1), (256, 132, 1), (257, 132, 2), (1 << 14, 132, 64), (1 << 16, 132, 256), (1 << 20, 132, 264),
    (1 << 20, 1, 2),
])
def test_launch_plan_comes_from_the_shape(work, sms, blocks):
    """One block up to a block's threads, then a block a THREADS pairs up
    to MIN_BLOCKS an SM."""
    assert gkr.round_blocks(work, sms) == blocks


def test_plain_pass_refuses_a_pass_that_does_nothing():
    with pytest.raises(ValueError):
        gkr.gkr_round_plain(_columns(np.random.default_rng(0), 2))


def _balanced_input(rng, log_n):
    p = np.zeros((1 << log_n, 4), U64)
    half = 1 << (log_n - 1)
    p[:half, 0] = rng.integers(0, P, half, dtype=U64)
    p[half:] = (P - p[:half]) % P
    q = rng.integers(0, P, (1 << log_n, 4), dtype=U64)
    q[half:] = q[:half]
    return p, q


@pytest.mark.parametrize("log_n", [6, 10])
def test_fractional_sumcheck_on_the_device_transcript(log_n):
    """On a ``DeviceTranscript("cpu")``: the former loop's claims, round
    polynomials, point and sponge state, and the JAX package's; no sub-round
    counted as the kernel's."""
    from swirl.prover.gkr import fractional_sumcheck as jfrac
    from swirl.fields import jfield as jf
    from swirl.transcript import Transcript as JaxTranscript

    p, q = _balanced_input(np.random.default_rng(log_n), log_n)
    dt = DeviceTranscript.from_host(Transcript(), "cpu")
    with metrics.run_with_metric_collection() as c:
        got = gkr.fractional_sumcheck(dt, F.const_arr(p), F.const_arr(q), assert_zero=True)
    assert c.snapshot()["gkr_kernel_subrounds"] == 0
    host = Transcript()
    claims, polys, xi = _former_fractional_sumcheck(host, F.const_arr(p), F.const_arr(q))
    got_claims = [np.stack([c.p_xi_0, c.q_xi_0, c.p_xi_1, c.q_xi_1]) for c in got.claims_per_layer]
    got_polys = [np.asarray(e, U64) for layer in got.sumcheck_polys for e in layer]
    assert len(got_claims) == len(claims) == log_n and len(got_polys) == len(polys) == log_n * (log_n - 1) // 2
    assert all(np.array_equal(np.asarray(a, U64), b) for a, b in zip(got_claims, claims))
    assert all(np.array_equal(a, b) for a, b in zip(got_polys, polys))
    assert np.array_equal(F.to_host(got.xi), xi)
    back = dt.to_host()
    assert np.array_equal(back.state, host.state) and (back.absorb_idx, back.sample_idx) == (
        host.absorb_idx, host.sample_idx)
    tj = JaxTranscript()
    want = jfrac(tj, jf.const_arr(p), jf.const_arr(q), assert_zero=True)
    assert np.array_equal(back.state, tj.state)
    assert np.array_equal(F.to_host(got.xi), np.asarray(want.xi, U64))
    assert all(np.array_equal(np.asarray(a, U64), np.asarray(b, U64))
               for a, b in zip(got_polys, [e for layer in want.sumcheck_polys for e in layer]))
    for a, b in zip(got.claims_per_layer, want.claims_per_layer):
        assert all(np.array_equal(getattr(a, f), getattr(b, f)) for f in ("p_xi_0", "p_xi_1", "q_xi_0", "q_xi_1"))
