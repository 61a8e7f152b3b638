"""The torch port's monomial engine (``swirl_torch/prover/monomial.py``)
against the JAX package's (``swirl/prover/monomial.py``) and against the
port's DAG interpreter.

The expansions equal JAX's on the fixtures, the app's SyntheticAir, keccak-f
and reth segment 13's KeccakfPermAir shape; the constraint sums equal JAX's
monomial engine and the port's interpreter in base and EF mode at 8-16 rows
(keccak-f against JAX's interpreter: JAX's monomial loop takes one eager op
a factor of its 53,834 monomials); the blowup guard fires as JAX's; and
the ops of one call do not grow with the monomial count. Inputs come from
numpy seeds. Tolerance: exact equality (finite field).
"""

from importlib import import_module

import numpy as np
import pytest
import torch

import jax

jax.config.update("jax_platforms", "cpu")

import swirl  # noqa: E402
import swirl_torch  # noqa: E402
from swirl.fields import jfield as jf  # noqa: E402
from swirl.prover import dag_eval as jde  # noqa: E402
from swirl.prover import monomial as jmono  # noqa: E402
from swirl_torch.fields import field as F  # noqa: E402
from swirl_torch.fields.babybear import P  # noqa: E402
from swirl_torch.prover import dag_eval as tde  # noqa: E402
from swirl_torch.prover import monomial as tmono  # noqa: E402

from chip_smoke import AtenOps  # noqa: E402

U64 = np.uint64
SEGMENT_13_KECCAKF_PERM = dict(air_name="KeccakfPermAir", log_height=16, common_main_width=2634,
                               num_constraints=3183, num_interactions=2, num_distinct_buses=2,
                               max_constraint_degree=3, interaction_message_lens=[1, 1],
                               interaction_count_weights=[0, 0])


def _air(pkg, name):
    if name == "keccak":
        return import_module(f"{pkg.__name__}.models.keccak").KeccakAir()
    fx = import_module(f"{pkg.__name__}.testing.fixtures")
    syn = import_module(f"{pkg.__name__}.testing.synthetic")
    if name == "fib":
        return fx.FibonacciAir()
    if name == "self_interaction":
        return fx.SelfInteractionAir(width=6)
    if name == "app_synthetic":
        return syn.SyntheticAir(syn.uniform_shape(4, 64, num_constraints=16, num_interactions=8, degree=3))
    if name == "keccakf_perm":
        return syn.SyntheticAir(syn.SyntheticShape(**SEGMENT_13_KECCAKF_PERM))
    raise ValueError(name)


def _dag(pkg, name):
    keygen = import_module(f"{pkg.__name__}.keygen")
    air = _air(pkg, name)
    return keygen.run_symbolic(air, keygen._air_widths(air)).build_dag()


@pytest.fixture(scope="module")
def expanded():
    """{name: (JAX dag, port dag, JAX expansion, port expansion)}."""
    out = {}
    for name in ("fib", "self_interaction", "app_synthetic", "keccak", "keccakf_perm"):
        jdag, tdag = _dag(swirl, name), _dag(swirl_torch, name)
        out[name] = (jdag, tdag, jmono.expand_monomials(jdag), tmono.expand_monomials(tdag))
    return out


@pytest.mark.parametrize("name", ["fib", "self_interaction", "app_synthetic", "keccak", "keccakf_perm"])
def test_expansion_matches_jax(expanded, name):
    _, tdag, want, got = expanded[name]
    assert got.leaves == want.leaves
    assert got.constraints == want.constraints
    assert len(got.constraints) == len(tdag.constraint_idx)
    assert all(n[0] in ("var", "sel") for n in got.leaves)
    counts = {"keccak": 53834, "keccakf_perm": 6365, "app_synthetic": 31}
    if name in counts:
        assert got.num_monomials() == counts[name]


def _inputs(tdag, rows: int, ext: bool, seed: int):
    width = 1 + max(n[4] for n in tdag.nodes if n[0] == "var" and n[1] == "main")
    rng = np.random.default_rng(seed)
    tail = (rows, 4) if ext else (rows,)
    sels, local, nxt = (rng.integers(0, P, (k,) + tail, dtype=U64) for k in (3, width, width))
    lam = rng.integers(0, P, (max(len(tdag.constraint_idx), 1), 4), dtype=U64)
    return sels, local, nxt, lam


def _evaluators(tdag, rows, ext, seed, public=()):
    sels, local, nxt, lam = _inputs(tdag, rows, ext, seed)
    t = F.const_arr
    tev = tde.DeviceEvaluator(t(sels), None, [(t(local), t(nxt))], list(public), ext)
    jev = jde.DeviceEvaluator(jf.const_arr(sels), None, [(jf.const_arr(local), jf.const_arr(nxt))],
                              list(public), ext)
    return tev, jev, lam


CASES = [(n, rows, ext) for n, rows in (("fib", 16), ("self_interaction", 8), ("app_synthetic", 16))
         for ext in (False, True)]


@pytest.mark.parametrize("name,rows,ext", CASES, ids=[f"{n}-{r}-{'ext' if e else 'base'}" for n, r, e in CASES])
def test_constraint_sum_matches_jax_and_interpreter(expanded, name, rows, ext):
    jdag, tdag, jexp, texp = expanded[name]
    public = [1, 1, 5] if name == "fib" else []
    tev, jev, lam = _evaluators(tdag, rows, ext, seed=rows + ext, public=public)
    got = tmono.acc_constraints_monomial(texp, tev, F.const_arr(lam))
    assert got.shape == (rows, 4) and got.device.type == "cpu"
    want = jf.to_host(jmono.acc_constraints_monomial(jexp, jev, jf.const_arr(lam)))
    assert np.array_equal(F.to_host(got), want)
    assert torch.equal(got, tde.acc_constraints(tdag, tev, F.const_arr(lam)))


@pytest.mark.parametrize("name,ext", [("keccak", False), ("keccak", True), ("keccakf_perm", False)],
                         ids=["keccak-base", "keccak-ext", "keccakf_perm-base"])
def test_constraint_sum_matches_interpreters(expanded, name, ext):
    jdag, tdag, _, texp = expanded[name]
    tev, jev, lam = _evaluators(tdag, 8, ext, seed=7)
    got = tmono.acc_constraints_monomial(texp, tev, F.const_arr(lam))
    assert torch.equal(got, tde.acc_constraints(tdag, tev, F.const_arr(lam)))
    if not ext:
        want = jf.to_host(jde.acc_constraints_device(jdag, jev, jf.const_arr(lam)))
        assert np.array_equal(F.to_host(got), want)


def test_constraint_sum_in_groups(expanded, monkeypatch):
    """Products and the weighted sum taken a few terms at a time give the
    same values (the grouping only bounds the memory)."""
    _, tdag, _, texp = expanded["keccak"]
    tev, _, lam = _evaluators(tdag, 8, False, seed=9)
    whole = tmono.acc_constraints_monomial(texp, tev, F.const_arr(lam))
    monkeypatch.setattr(tmono, "TERM_CHUNK_ELEMS", 8 * 333)
    assert torch.equal(tmono.acc_constraints_monomial(texp, tev, F.const_arr(lam)), whole)


def test_constant_terms():
    """A constraint with a constant term, one that cancels to zero and one
    through a public value."""
    from swirl_torch.symbolic import SymbolicAirBuilder

    b = SymbolicAirBuilder(preprocessed_width=None, cached_widths=[], common_width=2, num_public_values=1)
    row = b.common_main.local
    b.assert_zero(row[0] * row[1] + 7)
    b.assert_zero(row[0] - row[0])
    b.assert_zero(b.public_values[0] * row[1] - 3)
    dag = b.build_dag()
    exp = tmono.expand_monomials(dag)
    for ext in (False, True):
        rng = np.random.default_rng(11 + ext)
        tail = (4, 4) if ext else (4,)
        sels, local, nxt = (F.const_arr(rng.integers(0, P, (k,) + tail, dtype=U64)) for k in (3, 2, 2))
        ev = tde.DeviceEvaluator(sels, None, [(local, nxt)], [12345], ext)
        lam = F.const_arr(rng.integers(0, P, (len(dag.constraint_idx), 4), dtype=U64))
        assert torch.equal(tmono.acc_constraints_monomial(exp, ev, lam), tde.acc_constraints(dag, ev, lam))


def test_blowup_guard():
    """A wide power chain (a0 + ... + a7)^9 expands past MAX_MONOMIALS in
    both packages."""
    from swirl.symbolic import SymbolicAirBuilder as JBuilder
    from swirl_torch.symbolic import SymbolicAirBuilder as TBuilder

    for builder, mod in ((JBuilder, jmono), (TBuilder, tmono)):
        b = builder(preprocessed_width=None, cached_widths=[], common_width=8, num_public_values=0)
        row = b.common_main.local
        acc = row[0]
        for i in range(1, 8):
            acc = acc + row[i]
        prod = acc
        for _ in range(8):
            prod = prod * acc
        b.assert_zero(prod)
        with pytest.raises(mod.MonomialBlowup):
            mod.expand_monomials(b.build_dag())
    assert tmono.MAX_MONOMIALS == jmono.MAX_MONOMIALS


@pytest.mark.parametrize("ext", [False, True])
def test_ops_do_not_grow_with_monomials(ext):
    """A SyntheticAir of 130 and of 1,300 degree-3 constraints (262 and
    2,602 monomials): one call dispatches the same ops."""
    syn = import_module("swirl_torch.testing.synthetic")
    keygen = import_module("swirl_torch.keygen")
    counts, sizes = [], []
    for c in (130, 1300):
        air = syn.SyntheticAir(syn.uniform_shape(5, 16, num_constraints=c, num_interactions=2, degree=3))
        dag = keygen.run_symbolic(air, keygen._air_widths(air)).build_dag()
        exp = tmono.expand_monomials(dag)
        tev, _, lam = _evaluators(dag, 8, ext, seed=c)
        lam = F.const_arr(lam)
        want = tmono.acc_constraints_monomial(exp, tev, lam)  # the cached index tensors
        with AtenOps() as ops:
            got = tmono.acc_constraints_monomial(exp, tev, lam)
        counts.append(ops.n)
        sizes.append(exp.num_monomials())
        assert torch.equal(got, want) and torch.equal(got, tde.acc_constraints(dag, tev, lam))
    assert sizes[1] > 9 * sizes[0]
    assert counts[0] == counts[1], counts
