"""The torch port's level-scheduled constraint-DAG interpreter
(``swirl_torch/prover/dag_vectorized.py``) and the engine dispatch in
``swirl_torch/prover/dag_eval.py`` against the JAX package.

Two DAGs above the 128-node threshold: keccak-f's (40,535 nodes, 3,182
constraints, no interactions) and a SyntheticAir's (187 nodes with 8
interactions, so the interaction sums go through the interpreter too). The
schedules equal the reference's; the interpreter equals the port's node by
node evaluation on every output node; the constraint and interaction sums
equal JAX's on the same numpy inputs from a seed; and the SyntheticAir's
proof bytes equal the JAX engine's. Tolerance: exact equality (finite
field).
"""

import gc
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
from swirl.prover import dag_vectorized as jdv  # noqa: E402
from swirl_torch.fields import ef4 as tef4  # noqa: E402
from swirl_torch.fields import field as F  # noqa: E402
from swirl_torch.fields.babybear import P  # noqa: E402
from swirl_torch.prover import dag_eval as tde  # noqa: E402
from swirl_torch.prover import dag_vectorized as tdv  # noqa: E402
from swirl_torch.symbolic import eval_dag_nodes  # noqa: E402

U64 = np.uint64
BATCH = 8
SYNTHETIC = dict(num_constraints=32, num_interactions=8, degree=3)


def _air(pkg, name, log_height=5):
    if name == "keccak":
        return import_module(f"{pkg.__name__}.models.keccak").KeccakAir()
    syn = import_module(f"{pkg.__name__}.testing.synthetic")
    return syn.SyntheticAir(syn.uniform_shape(log_height, 16, **SYNTHETIC))


def _dag(pkg, name):
    params = import_module(f"{pkg.__name__}.params").test_system_params_small(2, 5, 3)
    vk, _ = import_module(f"{pkg.__name__}.keygen").keygen_air(_air(pkg, name), params, False)
    return vk.symbolic_constraints


@pytest.fixture(scope="module")
def dags():
    """{name: (JAX dag, port dag)}, built once: keccak's keygen and JAX's
    first evaluation on it are the costly steps."""
    return {name: (_dag(swirl, name), _dag(swirl_torch, name)) for name in ("keccak", "synthetic")}


def _inputs(tdag, ext: bool, seed: int):
    """Canonical numpy (sels, local, next) at a batch of BATCH rows."""
    width = 1 + max(n[4] for n in tdag.nodes if n[0] == "var" and n[1] == "main")
    rng = np.random.default_rng(seed)
    tail = (BATCH, 4) if ext else (BATCH,)
    return tuple(rng.integers(0, P, (k,) + tail, dtype=U64) for k in (3, width, width))


def _evaluators(tdag, ext: bool, seed: int):
    sels, local, nxt = _inputs(tdag, ext, seed)
    t = F.const_arr
    tev = tde.DeviceEvaluator(t(sels), None, [(t(local), t(nxt))], [], ext)
    jev = jde.DeviceEvaluator(jf.const_arr(sels), None, [(jf.const_arr(local), jf.const_arr(nxt))], [], ext)
    return tev, jev


def test_dag_sizes(dags):
    """Both DAGs lie above the threshold, so both take the interpreter."""
    for name, nodes, constraints, interactions in (("keccak", 40535, 3182, 0), ("synthetic", 187, 32, 8)):
        jdag, tdag = dags[name]
        assert len(tdag.nodes) == len(jdag.nodes) == nodes >= tde.VECTORIZE_THRESHOLD
        assert len(tdag.constraint_idx) == constraints and len(tdag.interactions) == interactions


@pytest.mark.parametrize("name", ["keccak", "synthetic"])
def test_schedule_matches_jax(dags, name):
    jdag, tdag = dags[name]
    got, want = tdv.compile_schedule(tdag), jdv.compile_schedule(jdag)
    assert got.leaf_kinds == want.leaf_kinds
    assert got.out_pos == want.out_pos and got.max_live == want.max_live
    assert len(got.levels) == len(want.levels) and len(got.keeps) == len(want.keeps)
    for g, w in zip(got.levels, want.levels):
        assert list(g) == list(w)
        for op in g:
            assert all(np.array_equal(a, b) for a, b in zip(g[op], w[op]))
    assert all(np.array_equal(a, b) for a, b in zip(got.keeps, want.keeps))
    if name == "keccak":
        assert (len(got.levels), len(got.leaf_kinds), got.max_live) == (29, 2875, 17904)


@pytest.mark.parametrize("name,ext", [("keccak", False), ("synthetic", False), ("synthetic", True)],
                         ids=["keccak-base", "synthetic-base", "synthetic-ext"])
def test_interpreter_matches_node_by_node(dags, name, ext):
    """Every output node of the interpreter equals the port's own node by
    node evaluation. (Keccak's ext mode, some seconds node by node on a
    CPU, is held by the 64-row Keccak proof of ``test_torch_keccak.py``,
    whose multilinear rounds run it and which both verifiers accept.)"""
    tdag = dags[name][1]
    tev, _ = _evaluators(tdag, ext, seed=1)
    values = tdv.eval_dag_vectorized(tdag, tev)
    nodes = eval_dag_nodes(tdag, tev)
    outs = sorted(values.sched.out_pos)
    shape = values.buf.shape[1:]
    want = torch.stack([nodes[i].expand(shape) for i in outs])
    assert torch.equal(values.gather(outs), want)
    assert all(torch.equal(values[i], want[k]) for k, i in enumerate(outs[:50]))


@pytest.mark.parametrize("name,ext", [("keccak", False), ("synthetic", True)], ids=["keccak-base", "synthetic-ext"])
def test_constraint_sum_matches_jax(dags, name, ext):
    jdag, tdag = dags[name]
    tev, jev = _evaluators(tdag, ext, seed=2)
    lam = np.random.default_rng(3).integers(0, P, (len(tdag.constraint_idx), 4), dtype=U64)
    want = jf.to_host(jde.acc_constraints_device(jdag, jev, jf.const_arr(lam)))
    assert np.array_equal(F.to_host(tde.acc_constraints(tdag, tev, F.const_arr(lam))), want)


def test_constraint_sum_in_groups(dags, monkeypatch):
    """The weighted sum taken a few constraints at a time gives the same
    values (the grouping only bounds the memory of the terms)."""
    tdag = dags["keccak"][1]
    tev, _ = _evaluators(tdag, False, seed=2)
    lam = F.const_arr(np.random.default_rng(3).integers(0, P, (len(tdag.constraint_idx), 4), dtype=U64))
    whole = tde.acc_constraints(tdag, tev, lam)
    monkeypatch.setattr(tef4, "TERM_CHUNK_ELEMS", 4 * BATCH * 100)
    monkeypatch.setattr(tdv, "ROW_CHUNK_ELEMS", BATCH * 1000)
    assert torch.equal(tde.acc_constraints(tdag, tev, lam), whole)


@pytest.mark.parametrize("ext", [False, True], ids=["base", "ext"])
def test_interaction_sums_match_jax(dags, ext):
    """acc_interactions and interactions_pq of the 187-node DAG (through the
    interpreter) against acc_interactions_device and interactions_pq_device."""
    jdag, tdag = dags["synthetic"]
    tev, jev = _evaluators(tdag, ext, seed=4)
    rng = np.random.default_rng(5)
    k = len(tdag.interactions)
    beta_pows = rng.integers(0, P, (1 + max(len(it.message) for it in tdag.interactions), 4), dtype=U64)
    bus_terms, eq_3bs = (rng.integers(0, P, (k, 4), dtype=U64) for _ in range(2))
    t, j = F.const_arr, jf.const_arr
    got = tde.acc_interactions(tdag, tev, t(beta_pows), t(bus_terms), t(eq_3bs))
    want = jde.acc_interactions_device(jdag, jev, j(beta_pows), j(bus_terms), j(eq_3bs))
    for g, w in zip(got, want):
        assert np.array_equal(F.to_host(g), jf.to_host(w))
    got = tde.interactions_pq(tdag, tev, t(beta_pows), t(bus_terms))
    want = jde.interactions_pq_device(jdag, jev, j(beta_pows), j(bus_terms))
    assert len(got) == len(want) == k
    for (gc_, gh), (wc, wh) in zip(got, want):
        assert np.array_equal(F.to_host(gc_), jf.to_host(wc))
        assert np.array_equal(F.to_host(gh), jf.to_host(wh))


def test_dispatch_by_dag_size(dags):
    """At least 128 nodes: the interpreter; fewer: node by node."""
    small = import_module("swirl_torch.testing.synthetic")
    air = small.SyntheticAir(small.uniform_shape(3, 4, num_constraints=2, num_interactions=1, degree=2))
    params = import_module("swirl_torch.params").test_system_params_small(2, 5, 3)
    small_dag = import_module("swirl_torch.keygen").keygen_air(air, params, False)[0].symbolic_constraints
    assert len(small_dag.nodes) < tde.VECTORIZE_THRESHOLD
    tev, _ = _evaluators(small_dag, False, seed=6)
    assert isinstance(tde._eval_nodes_device(small_dag, tev), list)
    tdag = dags["synthetic"][1]
    tev, _ = _evaluators(tdag, False, seed=6)
    assert isinstance(tde._eval_nodes_device(tdag, tev), tdv.NodeValues)


def test_schedule_cache_follows_the_dag_object():
    """The cache is keyed on the DAG object: a DAG freed and another built
    (which Python may place at the same id) each get their own schedule,
    and the freed DAG's entry goes with it."""
    first = _dag(swirl_torch, "synthetic")
    key = id(first)
    sched = tdv.get_schedule(first)
    assert tdv.get_schedule(first) is sched
    del first
    gc.collect()
    assert key not in tdv._schedule_cache
    syn = import_module("swirl_torch.testing.synthetic")
    params = import_module("swirl_torch.params").test_system_params_small(2, 5, 3)
    keygen = import_module("swirl_torch.keygen")
    for width in (16, 17, 18):  # other DAGs, any of which may reuse the id
        air = syn.SyntheticAir(syn.uniform_shape(5, width, num_constraints=33, num_interactions=8, degree=3))
        other = keygen.keygen_air(air, params, False)[0].symbolic_constraints
        got = tdv.get_schedule(other)
        assert got is not sched
        assert got.out_pos == tdv.compile_schedule(other).out_pos
        del other
        gc.collect()


def test_synthetic_proof_matches_jax_bytes():
    """The SyntheticAir proved by both packages on the CPU, at 2^3 rows (the
    DAG does not depend on the height; one multilinear round keeps the JAX
    engine's compiles to about 35 s on a CPU): round 0 and the multilinear round
    evaluate the 187 nodes through each package's interpreter, and the
    proof bytes are equal."""
    from swirl.codec import encode_proof as jax_encode_proof
    from swirl.engine import StarkEngine as JaxEngine
    from swirl_torch.codec import encode_proof
    from swirl_torch.engine import StarkEngine

    air, jair = _air(swirl_torch, "synthetic", 3), _air(swirl, "synthetic", 3)
    trace = np.random.default_rng(7).integers(0, P, (8, air.common_main_width()), dtype=U64)
    trace[:, 0] = 0  # the kill column: every constraint holds, every bus balances
    params = (2, 1, 3)  # l_skip 2, stacked height 2^3
    small = "{}.params"
    eng = StarkEngine(import_module(small.format("swirl_torch")).test_system_params_small(*params), device="cpu")
    vk, proof = eng.run_test([air], [(trace, [], [])])
    assert len(vk.per_air[0].symbolic_constraints.nodes) == 187
    _, jproof = JaxEngine(import_module(small.format("swirl")).test_system_params_small(*params)).run_test(
        [jair], [(trace, [], [])], debug=False)
    assert encode_proof(proof) == jax_encode_proof(jproof)
