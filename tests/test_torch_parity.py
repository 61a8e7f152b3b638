"""Module parity of the torch port (swirl_torch) against the JAX package.

The same inputs, made with numpy from a seed, go through each JAX function
and its port; the JAX side runs on the CPU through its jnp paths (the
Pallas kernels are off there, and tests/test_poly_ntt.py holds those paths
to the Pallas interpreter). On these CPU tensors every port wrapper runs
its plain PyTorch version. Tolerance: exact equality (finite field).
"""

import numpy as np
import pytest
import torch

import jax

jax.config.update("jax_platforms", "cpu")

from swirl.fields import ext as hext  # noqa: E402
from swirl.fields import jfield as jf  # noqa: E402
from swirl.fields.babybear import P  # noqa: E402
from swirl.hash import jposeidon2 as jp2  # noqa: E402
from swirl.hash.poseidon2 import compress_np, hash_rows_np, permute_np  # noqa: E402
from swirl.prover import ntt as jntt  # noqa: E402
from swirl.prover import stacked_pcs as jspcs  # noqa: E402
from swirl.prover import sumcheck as jsc  # noqa: E402
from swirl_torch import tpoly  # noqa: E402
from swirl_torch.fields import field as F  # noqa: E402
from swirl_torch.hash import poseidon2 as tp2  # noqa: E402
from swirl_torch.prover import ntt as tntt  # noqa: E402
from swirl_torch.prover import stacked_pcs as tspcs  # noqa: E402
from swirl_torch.prover import sumcheck as tsc  # noqa: E402
from swirl_torch.prover.ntt import ntt_four_step_plain  # noqa: E402

U64 = np.uint64


def _rand(rng, shape, near_p: bool = False):
    lo = P - 64 if near_p else 0
    return rng.integers(lo, P, shape, dtype=U64)


def _t(a):
    return F.const_arr(a)


def _j(a):
    return jf.const_arr(a)


# ---------------------------------------------------------------- field ---

FIELD_OPS = {
    "add": (lambda a, b: F.add(_t(a), _t(b)), lambda a, b: hext.eadd(a, b)),
    "sub": (lambda a, b: F.sub(_t(a), _t(b)), lambda a, b: hext.esub(a, b)),
    "neg": (lambda a, b: F.neg(_t(a)), lambda a, b: hext.eneg(a)),
    "mul": (lambda a, b: F.mul(_t(a), _t(b)), lambda a, b: (a * b) % U64(P)),
    "ext_mul": (lambda a, b: F.ext_mul(_t(a), _t(b)), lambda a, b: hext.emul(a, b)),
    "ext_scale": (
        lambda a, b: F.ext_scale(_t(a), _t(b[:, 0])),
        lambda a, b: hext.escale(a, b[:, 0]),
    ),
    "ext_sum": (lambda a, b: F.ext_sum(_t(a), 0), lambda a, b: hext.esum(a, 0)),
}


@pytest.mark.parametrize("near_p", [False, True])
@pytest.mark.parametrize("op", sorted(FIELD_OPS))
def test_field_op_matches_host_field(op, near_p):
    """Values near P make every EF product overflow int64 unless each
    product is reduced before the sums and the x^4 = 11 fold."""
    rng = np.random.default_rng(11)
    a, b = _rand(rng, (257, 4), near_p), _rand(rng, (257, 4), near_p)
    if not near_p:
        a[:3] = 0  # zero operands (neg of 0, sub to 0)
    ours, ref = FIELD_OPS[op]
    assert np.array_equal(F.to_host(ours(a, b)), np.asarray(ref(a, b), U64))


def test_field_powers_and_from_jax():
    rng = np.random.default_rng(3)
    vals = _rand(rng, (5, 7))
    assert np.array_equal(F.to_host(F.from_jax(np.asarray(_j(vals)))), vals)
    got = F.to_host(F.powers(12345, 37))
    assert [int(x) for x in got] == [pow(12345, i, P) for i in range(37)]


# ------------------------------------------------------------- poseidon2 ---


def test_permute_matches_numpy():
    s = _rand(np.random.default_rng(1), (33, 16))
    assert np.array_equal(F.to_host(tp2.permute_plain(_t(s))), permute_np(s))


# permute_model follows csrc/poseidon2.cu step for step (the diagonal by
# halvings and the 2^-k shift form, the tree sum, lazy products) and asserts
# every bound the kernel relies on; the card cannot run here.
DIAG_SHIFTS = (1, 2, 3, 4, 8, 27)


def _edge_values():
    """0, P - 1, and 2^k - 1, 2^k, 2^k + 1 for each shift k of the diagonal."""
    vals = {0, 1, P - 2, P - 1}
    for k in DIAG_SHIFTS:
        vals |= {(1 << k) - 1, 1 << k, (1 << k) + 1}
    return np.array(sorted(v % P for v in vals), dtype=U64)


def _model_states():
    edges = _edge_values()
    states = [_rand(np.random.default_rng(21), (40, 16)), np.zeros((1, 16), U64), np.full((1, 16), P - 1, U64)]
    states.append(np.stack([np.full(16, v, U64) for v in edges]))  # every lane at one edge value
    states.append(np.stack([np.roll(np.resize(edges, 16), i) for i in range(len(edges))]))  # mixed lanes
    return np.concatenate(states)


def test_permute_model_matches_plain_and_numpy():
    s = _model_states()
    got = F.to_host(tp2.permute_model(_t(s)))
    assert np.array_equal(got, F.to_host(tp2.permute_plain(_t(s))))
    assert np.array_equal(got, permute_np(s))


def test_permute_quad_model_matches_plain_and_numpy():
    """Kernel D's permutation split over a quad of lanes."""
    s = _model_states()
    got = F.to_host(tp2.permute_quad_model(_t(s)))
    assert np.array_equal(got, F.to_host(tp2.permute_plain(_t(s))))
    assert np.array_equal(got, permute_np(s))


@pytest.mark.parametrize("k", DIAG_SHIFTS)
def test_div2k_model_matches_field_mul(k):
    x = np.concatenate([_edge_values(), _rand(np.random.default_rng(k), (500,))])
    inv = pow(2, (P - 1 - k) % (P - 1), P)  # 2^-k
    want = F.to_host(F.mul(_t(x), _t(np.full_like(x, inv))))
    assert np.array_equal(F.to_host(tp2.div2k_model(_t(x), k)), want)


@pytest.mark.parametrize("w", [1, 3, 8, 13, 16, 20])
def test_hash_cols_matches_sponge(w):
    """Widths that are not multiples of 8 keep the unabsorbed lanes."""
    m = _rand(np.random.default_rng(w), (w, 9))
    assert np.array_equal(F.to_host(tp2.hash_cols(_t(m))), hash_rows_np(m.T).T)


def test_compress_cols_matches_numpy():
    rng = np.random.default_rng(2)
    left, right = _rand(rng, (10, 8)), _rand(rng, (10, 8))
    pairs = np.concatenate([left.T, right.T])
    assert np.array_equal(F.to_host(tp2.compress_cols(_t(pairs))).T, compress_np(left, right))


@pytest.mark.parametrize("log_n", [1, 4, 7])
def test_merkle_tower_matches_jax(log_n):
    d = _rand(np.random.default_rng(log_n), (8, 1 << log_n))
    want = [jf.to_host(x) for x in jp2.merkle_tower(_j(d))]
    got = [F.to_host(x) for x in tp2.merkle_tower(_t(d))]
    assert len(got) == len(want) == log_n
    assert all(np.array_equal(g, w) for g, w in zip(got, want))


# ------------------------------------------------------------------- ntt ---


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("log_n", [0, 1, 4, 9, 11])
def test_ntt_matches_jax(log_n, inverse):
    x = _rand(np.random.default_rng(log_n), (3, 1 << log_n))
    want = jf.to_host(jntt.ntt(_j(x), inverse=inverse))
    assert np.array_equal(F.to_host(tntt.ntt(_t(x), inverse=inverse)), want)


@pytest.mark.parametrize("fn", ["ntt", "intt", "coset_ntt", "zeta", "mobius"])
def test_ext_transforms_match_jax(fn):
    x = _rand(np.random.default_rng(5), (2, 32, 4))
    calls = {
        "ntt": (lambda m, x: m.ntt(x, ext=True)),
        "intt": (lambda m, x: m.intt(x, ext=True)),
        "coset_ntt": (lambda m, x: m.coset_ntt(x, 31 * 31, ext=True)),
        "zeta": (lambda m, x: m.zeta_transform(x, 5, ext=True)),
        "mobius": (lambda m, x: m.mobius_transform(x, 3, ext=True)),
    }[fn]
    want = jf.to_host(calls(jntt, _j(x)))
    assert np.array_equal(F.to_host(calls(tntt, _t(x))), want)


def test_base_zeta_mobius_roundtrip_match_jax():
    x = _rand(np.random.default_rng(6), (4, 64))
    z = tntt.zeta_transform(_t(x), 6)
    assert np.array_equal(F.to_host(z), jf.to_host(jntt.zeta_transform(_j(x), 6)))
    assert np.array_equal(F.to_host(tntt.mobius_transform(z, 6)), x)


# A′'s split: the plain model of ntt.cu's four-step index algebra (sub-NTTs,
# two-level twiddle, transposes) against ntt_plain and the JAX package's
# ntt. The JAX recursion itself cannot run below 2^27: its inner split
# needs 128 lanes.
FOUR_STEP = [(10, 1), (10, 5), (11, 5), (12, 3), (12, 6), (13, 6), (13, 12), (14, 7)]


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("log_n,log_n1", FOUR_STEP)
def test_four_step_model_matches_ntt(log_n, log_n1, inverse):
    x = _rand(np.random.default_rng(log_n * 31 + log_n1), (2, 1 << log_n))
    x[0, :7] = P - 1  # the largest canonical values
    got = F.to_host(ntt_four_step_plain(_t(x), log_n1, inverse))
    assert np.array_equal(got, F.to_host(tntt.ntt_plain(_t(x), inverse)))
    assert np.array_equal(got, jf.to_host(jntt.ntt(_j(x), inverse=inverse)))


# ----------------------------------------------------------- stacked pcs ---

LAYOUT_SWEEP = [
    (2, 6, [(3, 5), (2, 3), (1, 1)]),
    (2, 6, [(1, 6), (4, 2)]),
    (3, 8, [(2, 8), (5, 4), (0, 2), (3, 0)]),
    (4, 22, [(64, 20)]),
    (0, 7, [(8, 7), (4, 3), (2, 3)]),
]


@pytest.mark.parametrize("l_skip,log_h,dims", LAYOUT_SWEEP)
def test_stacked_layout_matches_jax(l_skip, log_h, dims):
    want = jspcs.StackedLayout.new(l_skip, max(log_h, l_skip), dims)
    got = tspcs.StackedLayout.new(l_skip, max(log_h, l_skip), dims)
    assert (got.height, got.width, got.mat_starts) == (want.height, want.width, want.mat_starts)
    assert [(m, c, s.col_idx, s.row_idx, s.log_height) for m, c, s in got.sorted_cols] == [
        (m, c, s.col_idx, s.row_idx, s.log_height) for m, c, s in want.sorted_cols
    ]


@pytest.mark.parametrize("heights", [(64,), (32, 16, 2)])
def test_stacked_commit_matches_jax(heights):
    """Same traces (carried from the JAX arrays with from_jax): same stacked
    matrix, codewords, Merkle layers and root."""
    rng = np.random.default_rng(len(heights))
    j_traces = [_j(_rand(rng, (3, h))) for h in heights]
    t_traces = [F.from_jax(np.asarray(t)) for t in j_traces]
    j_root, j_data = jspcs.stacked_commit(2, 4, 1, 2, j_traces)
    t_root, t_data = tspcs.stacked_commit(2, 4, 1, 2, t_traces)
    assert np.array_equal(t_root, np.asarray(j_root, U64))
    assert np.array_equal(F.to_host(t_data.matrix), jf.to_host(j_data.matrix))
    assert np.array_equal(F.to_host(t_data.rs_matrix), jf.to_host(j_data.rs_matrix))
    assert len(t_data.tree.layers) == len(j_data.tree.layers)
    for a, b in zip(t_data.tree.layers, j_data.tree.layers):
        assert np.array_equal(F.to_host(a), jf.to_host(b))
    idx = [0, 3, 5]
    assert np.array_equal(
        F.to_host(t_data.tree.batch_query_proofs_arr(torch.as_tensor(idx))),
        np.asarray(j_data.tree.batch_query_proofs(idx)),
    )


# -------------------------------------------------------------- sumcheck ---


def test_eq_tables_match_jax():
    rng = np.random.default_rng(8)
    xi = _rand(rng, (5, 4))
    assert np.array_equal(F.to_host(tsc.eq_hypercube(xi, "cpu")), jf.to_host(jsc.eq_hypercube_dev(xi)))
    assert np.array_equal(
        F.to_host(tsc.mobius_eq_hypercube(xi, "cpu")), jf.to_host(jsc.mobius_eq_hypercube_dev(xi))
    )
    z = xi[0]
    assert np.array_equal(
        F.to_host(tsc.eq_pows_hypercube(z, 4, "cpu")),
        jf.to_host(jsc.eq_pows_hypercube_dev(z, 4, base_field=False)),
    )
    zb = _rand(rng, (6,))
    assert np.array_equal(
        F.to_host(tsc.eq_pows_base_batch(_t(zb), 4)), jf.to_host(jsc.eq_pows_base_batch_dev(_j(zb), 4))
    )


@pytest.mark.parametrize("height,is_rot", [(64, False), (64, True), (2, True)])
def test_fold_and_coset_grid_match_jax(height, is_rot):
    rng = np.random.default_rng(height)
    mat = _rand(rng, (3, height))
    r = _rand(rng, (4,))
    w = jsc.barycentric_weights_host(3, r)
    assert np.array_equal(F.to_host(tpoly.barycentric_weights(3, _t(r))), w)
    got = tsc.fold_ple(_t(mat), 3, is_rot, _t(w))
    assert np.array_equal(F.to_host(got), jf.to_host(jsc.fold_ple(_j(mat), 3, is_rot, _j(w))))
    shifts = [31, 961]
    assert np.array_equal(
        F.to_host(tsc.coset_eval_chunks(_t(mat), 3, shifts, is_rot)),
        jf.to_host(jsc.coset_eval_chunks(_j(mat), 3, shifts, is_rot)),
    )
    assert np.array_equal(
        F.to_host(tsc.selectors_matrix(height, 3, "cpu")),
        jf.to_host(jsc.selectors_matrix(height, 3)),
    )
    ef = _rand(rng, (3, 8, 4))
    assert np.array_equal(
        F.to_host(tsc.fold_mle(_t(ef), _t(r))), jf.to_host(jsc.fold_mle(_j(ef), _j(r)))
    )
    assert np.array_equal(
        F.to_host(tsc.interp_mle_at_int(_t(ef), 3)), jf.to_host(jsc.interp_mle_at_int(_j(ef), 3))
    )


# ------------------------------------------------------------------- gkr ---


def test_fractional_sumcheck_matches_jax():
    """Same (p, q) input and transcript state: same claims, round polys,
    challenge point and final sponge state (natural order on the port, the
    JAX host path's own layout on the reference)."""
    from swirl.prover.gkr import fractional_sumcheck as jfrac
    from swirl.transcript import Transcript as JaxTranscript
    from swirl_torch.prover.gkr import fractional_sumcheck as tfrac
    from swirl_torch.transcript import Transcript

    rng = np.random.default_rng(21)
    p = np.zeros((32, 4), U64)
    p[:, 0] = _rand(rng, (32,))
    q = _rand(rng, (32, 4))
    tj, tt = JaxTranscript(), Transcript()
    want = jfrac(tj, _j(p), _j(q), assert_zero=False)
    got = tfrac(tt, _t(p), _t(q), assert_zero=False)
    assert np.array_equal(tt.state, tj.state)
    assert np.array_equal(np.asarray(got.xi), np.asarray(want.xi))
    assert np.array_equal(np.asarray(got.sumcheck_polys[-1]), np.asarray(want.sumcheck_polys[-1]))
    for a, b in zip(got.claims_per_layer, want.claims_per_layer):
        assert all(np.array_equal(getattr(a, f), getattr(b, f)) for f in ("p_xi_0", "p_xi_1", "q_xi_0", "q_xi_1"))


# -------------------------------------------------------------- dag eval ---


def test_constraint_accumulation_matches_jax():
    """Base-mode (round 0) and ext-mode (MLE rounds) constraint sums of a
    SyntheticAir DAG on random columns."""
    import swirl
    import swirl_torch

    from swirl.prover import dag_eval as jde
    from swirl_torch.prover import dag_eval as tde

    def dag_of(pkg):
        from importlib import import_module

        syn = import_module(f"{pkg.__name__}.testing.synthetic")
        params = import_module(f"{pkg.__name__}.params")
        keygen = import_module(f"{pkg.__name__}.keygen")
        air = syn.SyntheticAir(syn.uniform_shape(4, 6, num_constraints=5, num_interactions=2, degree=3))
        vk, _ = keygen.keygen_air(air, params.test_system_params_small(2, 4, 3), False)
        return vk.symbolic_constraints

    jdag, tdag = dag_of(swirl), dag_of(swirl_torch)
    rng = np.random.default_rng(4)
    lam = _rand(rng, (5, 4))
    for ext in (False, True):
        shape = (6, 8, 4) if ext else (6, 8)
        local, nxt, sels = _rand(rng, shape), _rand(rng, shape), _rand(rng, (3,) + shape[1:])
        jev = jde.DeviceEvaluator(_j(sels), None, [(_j(local), _j(nxt))], [], ext)
        tev = tde.DeviceEvaluator(_t(sels), None, [(_t(local), _t(nxt))], [], ext)
        want = jf.to_host(jde.acc_constraints_device(jdag, jev, _j(lam)))
        assert np.array_equal(F.to_host(tde.acc_constraints(tdag, tev, _t(lam))), want)
