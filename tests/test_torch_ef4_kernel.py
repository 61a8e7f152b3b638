"""Kernel L (``swirl_torch/csrc/ef4.cu``), the batch sumcheck's EF4 product
and product-and-sum, on the CPU: a numpy model of the kernel's arithmetic
(Montgomery products, the sums at R^-1, the fix-up product) and of
its layout (the wrapper's coalesced dims and strides, the sum's columns,
lanes, blocks and last-block reduction) against ``F.ext_mul`` and
``F.ext_sum(F.ext_mul(...))`` at the batch phase's shapes; the plain
weighted sum against the grouping it replaced; and the batch phase with
the model in the kernel's place, byte for byte, with its counters. The
kernel itself runs in ``tests/test_torch_kernels_cuda.py``. Tolerance:
exact equality (finite field).
"""

import math

import numpy as np
import pytest
import torch

from swirl_torch import metrics
from swirl_torch.fields import ef4
from swirl_torch.fields import field as F
from swirl_torch.fields.babybear import P
from swirl_torch.prover import dag_eval as de
from swirl_torch.prover import logup_zerocheck as lz

U64 = np.uint64
R = (1 << 32) % P
RINV = pow(R, P - 2, P)
R2 = R * R % P
W11 = 11 * R % P
SMS = 132  # the H100's, as the wrapper reads them on the card


# -- a model of the kernel ----------------------------------------------------


def _mont(a, b):
    return (np.asarray(a, U64) * np.asarray(b, U64) % U64(P)) * U64(RINV) % U64(P)


def _add(a, b):
    return (a + b) % U64(P)


def _rmul(x, y):
    """x y / R of two (n, 4) values."""
    x0, x1, x2, x3 = (x[:, j] for j in range(4))
    y0, y1, y2, y3 = (y[:, j] for j in range(4))
    h0 = _add(_add(_mont(x1, y3), _mont(x2, y2)), _mont(x3, y1))
    h1 = _add(_mont(x2, y3), _mont(x3, y2))
    h2 = _mont(x3, y3)
    return np.stack([
        _add(_mont(x0, y0), _mont(h0, W11)),
        _add(_add(_mont(x0, y1), _mont(x1, y0)), _mont(h1, W11)),
        _add(_add(_mont(x0, y2), _mont(x1, y1)), _add(_mont(x2, y0), _mont(h2, W11))),
        _add(_add(_mont(x0, y3), _mont(x1, y2)), _add(_mont(x2, y1), _mont(x3, y0))),
    ], axis=1)


def _storage(t):
    """t's whole storage as canonical words, and t's first word in it."""
    n = t.untyped_storage().nbytes() // 8
    flat = torch.empty(0, dtype=torch.int64).set_(t.untyped_storage(), 0, (n,), (1,))
    return flat.numpy().astype(U64), t.storage_offset()


def _load(t, words):
    """The EF4 elements at word offsets ``words`` of t's storage, each two
    16-byte loads: the address is checked as the kernel needs it."""
    store, _ = _storage(t)
    assert t.data_ptr() % 16 == 0 or t.numel() == 0
    assert np.all((words - t.storage_offset()) % 2 == 0)
    return np.stack([store[words + q] for q in range(4)], axis=1)


def model_mul(a, b, calls=None):
    """Kernel L's product: the wrapper's layout, a thread an element e, its
    index split by the coalesced dims into each operand's offset, (a b / R)
    R."""
    shape, ops, dims = ef4.mul_layout(a, b)
    n = math.prod(shape[:-1])
    out = np.zeros((n, 4), U64)
    if n:
        if calls is not None:
            calls.append(("mul", tuple(shape)))
        assert len(dims) <= ef4.MUL_DIMS
        offs = [np.full(n, t.storage_offset(), np.int64) for t in ops]
        rest = np.arange(n, dtype=np.int64)
        for size, st in reversed(dims):
            i, rest = rest % size, rest // size
            for o, s in zip(offs, st):
                o += i * s
        c = _rmul(_load(ops[0], offs[0]), _load(ops[1], offs[1]))
        out = _mont(c, R2)
    return torch.from_numpy(out.astype(np.int64)).reshape(shape)


def model_mul_sum(v, w, index=None, ext=True, sms=SMS, calls=None):
    """Kernel L's product-and-sum: the wrapper's layout and plan, the terms
    each (block y, lane) takes, the block sums, the partials and the last
    block's split reduction."""
    v, w, index, batch = ef4.sum_layout(v, w, index, ext)
    k, m = w.shape[0], math.prod(batch)
    if m == 0 or k == 0:
        return torch.zeros(batch + (4,), dtype=torch.int64)
    if calls is not None:
        calls.append(("mul_sum", k, m))
    tj, gy = ef4.sum_plan(m, k, sms)
    lanes, per_block = ef4.THREADS // tj, -(-k // gy)
    assert tj & (tj - 1) == 0 and (gy == 1 or m <= tj)
    rows = index.numpy() if index is not None else np.arange(k)
    row_words = v.storage_offset() + rows * v.stride(0)  # s_row: row_i * row_stride
    wn = w.numpy().astype(U64)
    # term (i, j) on the (block, lane) that takes it: block i // per_block,
    # lane t % lanes of the block's t-th term; a term w_i v / R
    i = np.arange(k)
    by = i // per_block
    lane = (i - by * per_block) % lanes
    words = (row_words[:, None] + (4 if ext else 1) * np.arange(m)[None, :]).reshape(-1)
    ws = np.repeat(wn, m, 0)
    terms = _rmul(_load(v, words), ws) if ext else _mont(_storage(v)[0][words][:, None], ws)
    acc = np.zeros((gy, lanes, m, 4), U64)
    np.add.at(acc, (by, lane), terms.reshape(k, m, 4))  # below 2^64: k canonical summands
    acc %= U64(P)
    block = acc.sum(axis=1) % U64(P)  # the lanes meet in shared memory
    if gy == 1:
        out = block[0]
    else:  # the last block: the partials summed over split lanes of blocks
        words = 4 * m
        partials = block.reshape(gy, words)
        if words < ef4.THREADS:
            split = ef4.THREADS // words
            by_lane = [partials[lane::split].sum(axis=0) % U64(P) for lane in range(split)]
            out = (np.sum(by_lane, axis=0) % U64(P)).reshape(m, 4)
        else:
            out = (partials.sum(axis=0) % U64(P)).reshape(m, 4)
    out = _mont(out, R2)  # the fix-up: times R
    return torch.from_numpy(out.astype(np.int64)).reshape(batch + (4,))


# -- cases ----------------------------------------------------------------------


def _rand(rng, shape, fill=None):
    a = rng.integers(0, P, shape, dtype=U64) if fill is None else np.full(shape, fill, U64)
    return F.const_arr(a)


def _stride2(t):
    return t[..., 1::2, :]


MUL_CASES = {
    # (a, b) from a generator
    "equal": lambda r, f: (_rand(r, (5, 7, 4), f), _rand(r, (5, 7, 4), f)),
    "challenge": lambda r, f: (_rand(r, (33, 4), f), _rand(r, (4,), f)),
    "challenge-first": lambda r, f: (_rand(r, (4,), f), _rand(r, (3, 33, 4), f)),
    "weights": lambda r, f: (_rand(r, (6, 1, 4), f), _rand(r, (6, 10, 4), f)),
    "stride-2": lambda r, f: (_stride2(_rand(r, (64, 4), f)), _rand(r, (32, 4), f)),
    "stride-2-columns": lambda r, f: (_stride2(_rand(r, (3, 16, 4), f)), _stride2(_rand(r, (3, 16, 4), f))),
    "row-of-table": lambda r, f: (_rand(r, (9, 4), f)[5], _rand(r, (17, 4), f)),
    "point": lambda r, f: (_rand(r, (4,), f), _rand(r, (4,), f)),
    "one-row": lambda r, f: (_rand(r, (1, 4), f), _rand(r, (1, 1, 4), f)),
    "zero-rows": lambda r, f: (_rand(r, (0, 4), f), _rand(r, (4,), f)),
    "four-dims": lambda r, f: (_rand(r, (2, 1, 3, 5, 4), f), _stride2(_rand(r, (2, 2, 1, 10, 4), f))),
    "unaligned": lambda r, f: (_rand(r, (41,), f)[1:].reshape(10, 4), _rand(r, (10, 4), f)),
}


@pytest.mark.parametrize("fill", [None, P - 1], ids=["random", "all-p-minus-1"])
@pytest.mark.parametrize("case", sorted(MUL_CASES))
def test_mul_model_equals_ext_mul(case, fill):
    """The model of the product, at the batch phase's shapes and beside
    them, equals ``F.ext_mul``, which the CPU path of ``ef4.mul`` is."""
    a, b = MUL_CASES[case](np.random.default_rng(len(case)), fill)
    want = F.ext_mul(a, b)
    assert torch.equal(ef4.mul(a, b), want)
    got = model_mul(a, b)
    assert got.shape == want.shape and torch.equal(got, want)


def test_mul_model_at_every_length():
    """A table of m rows by a challenge and by a table, m = 1..1024."""
    rng = np.random.default_rng(7)
    for m in (1, 2, 3, 7, 31, 255, 256, 257, 1000, 1024):
        a, b, c = _rand(rng, (m, 4)), _rand(rng, (4,)), _rand(rng, (m, 4))
        assert torch.equal(model_mul(a, b), F.ext_mul(a, b))
        s = _stride2(_rand(rng, (2 * m, 4)))
        assert torch.equal(model_mul(s, c), F.ext_mul(s, c))


def _former_sum(v, w, ext):
    """The sums the batch phase formed before the kernel."""
    w = w.reshape((w.shape[0],) + (1,) * (v.dim() - 1 - int(ext)) + (4,))
    return F.ext_sum(F.ext_mul(v, w) if ext else F.mul(v[..., None], w), axis=0)


SUM_CASES = {
    # (v, w, index, ext): a case of the batch phase, cut to a CPU's size
    "round0-grid": lambda r, f: (_rand(r, (200, 48, 4), f), _rand(r, (200, 4), f), None, True),
    "round0-grid-column-weights": lambda r, f: (_rand(r, (64, 32, 4), f), _rand(r, (64, 1, 4), f), None, True),
    "eq-weighted": lambda r, f: (_rand(r, (3000, 4), f), _rand(r, (3000, 4), f), None, True),
    "eq-weighted-short": lambda r, f: (_rand(r, (5, 4), f), _rand(r, (5, 4), f), None, True),
    "constraints-ext": lambda r, f: (_rand(r, (40, 300, 4), f), _rand(r, (16, 4), f),
                                     F.const_arr(r.integers(0, 40, 16, dtype=U64)), True),
    "constraints-base": lambda r, f: (_rand(r, (40, 6, 70), f), _rand(r, (16, 4), f),
                                      F.const_arr(r.integers(0, 40, 16, dtype=U64)), False),
    "constraints-one-point": lambda r, f: (_rand(r, (40, 1, 4), f), _rand(r, (32, 4), f),
                                           F.const_arr(r.integers(0, 40, 32, dtype=U64)), True),
    "many-terms-base": lambda r, f: (_rand(r, (2000, 3), f), _rand(r, (2000, 4), f), None, False),
    "bus": lambda r, f: (_rand(r, (8, 4), f), _rand(r, (8, 4), f), None, True),
    "wide": lambda r, f: (_rand(r, (3, 1024, 4), f), _rand(r, (3, 4), f), None, True),
    "no-terms": lambda r, f: (_rand(r, (4, 10, 4), f), _rand(r, (0, 4), f),
                              torch.zeros(0, dtype=torch.int64), True),
    "no-columns": lambda r, f: (_rand(r, (4, 0, 4), f), _rand(r, (4, 4), f), None, True),
}


@pytest.mark.parametrize("fill", [None, P - 1], ids=["random", "all-p-minus-1"])
@pytest.mark.parametrize("case", sorted(SUM_CASES))
def test_mul_sum_model_equals_ext_sum_of_ext_mul(case, fill):
    """The model of the product-and-sum equals the plain version and the
    form it replaced: ``F.ext_sum(F.ext_mul(v, w), 0)`` (base x EF4 for
    base v), the rows gathered by index."""
    v, w, index, ext = SUM_CASES[case](np.random.default_rng(len(case)), fill)
    want = _former_sum(v if index is None else v.index_select(0, index), w, ext)
    assert torch.equal(ef4.mul_sum(v, w, index=index, ext=ext), want)
    got = model_mul_sum(v, w, index, ext)
    assert got.shape == want.shape and torch.equal(got, want)


@pytest.mark.parametrize("m,k", [(1, 1 << 13), (48, 512), (64, 700), (200, 300)])
def test_mul_sum_model_across_blocks(m, k):
    """Terms split over blocks (gy > 1), their partials summed by the last
    block's split lanes, at the plan of the H100 and of a card of 2 SMs."""
    rng = np.random.default_rng(m + k)
    v = _rand(rng, (k, m, 4)) if m > 1 else _rand(rng, (k, 4))
    w = _rand(rng, (k, 4))
    want = _former_sum(v, w, True)
    for sms in (SMS, 2):
        tj, gy = ef4.sum_plan(m, k, sms)
        assert gy > 1 and m <= tj
        assert torch.equal(model_mul_sum(v, w, sms=sms), want)


def test_sum_plan():
    """Columns a block, and blocks over the terms only where one block holds
    every column, at least TERMS_A_LANE terms a lane and 2 blocks an SM."""
    assert ef4.sum_plan(1, 16, SMS) == (1, 1)
    assert ef4.sum_plan(1, 1 << 15, SMS) == (1, 32)
    assert ef4.sum_plan(48, 1 << 16, SMS) == (64, 2 * SMS)
    assert ef4.sum_plan(256, 1 << 20, SMS) == (256, 2 * SMS)
    assert ef4.sum_plan(257, 1 << 20, SMS) == (256, 1)
    assert ef4.sum_plan(1 << 21, 16, SMS) == (256, 1)


def test_mul_plan_coalesces_dims():
    """Size-1 dims drop out and dims that the strides allow merge: a stride-2
    view stays one dim, (k, 1, 4) weights against (k, rows, 4) two."""
    big = torch.zeros(3, 16, 4, dtype=torch.int64)
    shape, ops, dims = ef4.mul_layout(big[:, 1::2], torch.zeros(3, 8, 4, dtype=torch.int64))
    assert dims == [(24, [8, 4])]
    shape, ops, dims = ef4.mul_layout(torch.zeros(6, 1, 4, dtype=torch.int64), torch.zeros(6, 10, 4, dtype=torch.int64))
    assert dims == [(6, [4, 40]), (10, [0, 4])]
    shape, ops, dims = ef4.mul_layout(torch.zeros(4, dtype=torch.int64), torch.zeros(5, 7, 4, dtype=torch.int64))
    assert dims == [(35, [0, 4])]


# -- the weighted sums of the DAG's nodes ---------------------------------------


def _synthetic_dag(degree=3):
    from swirl_torch.keygen import keygen_air
    from swirl_torch.params import test_system_params_small
    from swirl_torch.testing.synthetic import SyntheticAir, uniform_shape

    air = SyntheticAir(uniform_shape(4, 16, 32, 8, degree=degree))
    return keygen_air(air, test_system_params_small(2, 5, 3, max_constraint_degree=degree), False)[0] \
        .symbolic_constraints


def _evaluator(dag, ext, rng, batch=(12,)):
    width = 1 + max(n[4] for n in dag.nodes if n[0] == "var")
    tail = (4,) if ext else ()
    t = lambda shape: _rand(rng, shape)  # noqa: E731
    return de.DeviceEvaluator(t((3,) + batch + tail), None, [(t((width,) + batch + tail),
                                                              t((width,) + batch + tail))], [], ext)


def _former_weighted_sum_gather(nodes, indices, weights, ev):
    """``_weighted_sum_gather`` as it was before the kernel: gathers and
    products in groups of TERM_CHUNK_ELEMS, one remainder at the end."""
    batch = tuple(ev.batch_shape())
    group = max(1, ef4.TERM_CHUNK_ELEMS // (4 * torch.Size(batch).numel() or 1))
    pos = nodes.positions(indices)
    acc = torch.zeros(batch + (4,), dtype=F.DTYPE)
    for g in range(0, len(indices), group):
        vals = nodes.buf.index_select(0, pos[g : g + group])
        w = weights[g : g + len(vals)].reshape((len(vals),) + (1,) * len(batch) + (4,))
        term = F.ext_mul(vals, w) if ev.ext_mode else F.mul(vals[..., None], w)
        acc = acc + term.sum(0)
    return acc % P


@pytest.mark.parametrize("ext", [False, True], ids=["base", "ext"])
def test_weighted_sum_gather_equals_former_grouping(ext, monkeypatch):
    """The interpreter's weighted sums through ``ef4.mul_sum`` (the plain
    path, in groups) and through the kernel's model (one call, rows
    gathered) equal the former grouped gathers and products, at a group of
    five terms and at one group."""
    dag = _synthetic_dag()
    rng = np.random.default_rng(11)
    ev = _evaluator(dag, ext, rng)
    nodes = de._eval_nodes_device(dag, ev)
    k = len(dag.constraint_idx)
    lam = _rand(rng, (k + 3, 4))
    for chunk in (ef4.TERM_CHUNK_ELEMS, 4 * 12 * 5):
        monkeypatch.setattr(ef4, "TERM_CHUNK_ELEMS", chunk)
        want = _former_weighted_sum_gather(nodes, dag.constraint_idx, lam, ev)
        assert torch.equal(de._weighted_sum_gather(nodes, dag.constraint_idx, lam, ev), want)
    pos = nodes.positions(dag.constraint_idx)
    assert torch.equal(model_mul_sum(nodes.buf, lam[:k], index=pos, ext=ext), want)


# -- the batch phase with the model in the kernel's place -----------------------


def _prove(degree, log_h=5):
    """An app-shaped SyntheticAir (64 columns, 16 constraints, 8
    interactions) of 2^log_h rows, proved on the CPU: (proof bytes, the
    collector's counters)."""
    from swirl_torch.codec import encode_proof
    from swirl_torch.engine import StarkEngine
    from swirl_torch.prover.backend import ProvingContext
    from swirl_torch.params import test_system_params_small
    from swirl_torch.testing.synthetic import SyntheticAir, uniform_shape

    air = SyntheticAir(uniform_shape(log_h, 64, 16, 8, degree=degree))
    trace = np.random.default_rng(degree).integers(0, P, (1 << log_h, air.common_main_width()), dtype=U64)
    trace[:, 0] = 0  # the kill column: every constraint holds, every bus balances
    eng = StarkEngine(test_system_params_small(2, 6, 3, max_constraint_degree=degree), device="cpu")
    pk, _ = eng.keygen([air])
    dpk = eng.transport_pk(pk)
    ctx = ProvingContext([eng.context_for(0, trace, [], [])])
    with metrics.run_with_metric_collection() as c:
        proof = eng.prove(dpk, ctx)
    return encode_proof(proof), c.snapshot()


@pytest.mark.parametrize("degree", [3, 4])
def test_batch_phase_with_the_kernel_model(degree, monkeypatch):
    """The batch phase with the kernel's model in ``ef4.mul`` and
    ``ef4.mul_sum``'s place proves the plain path's bytes, at degree 3 (the
    app's) and 4 (the leaf's). Its counters: no launch on the CPU, and the
    ``F.ext_mul`` calls left in the phase, every one ``fold_mle``'s, two a
    round here (the selectors and the main trace: the AIR reads no next
    row). The eq tables are kernel K's (``gkr_eq``) on the card, so their
    plain doubling on the CPU is not counted."""
    want, counters = _prove(degree)
    rounds = 5 - 2  # log_h - l_skip
    assert counters["batch_ef4_launches"] == 0
    assert counters["batch_ef4_aten"] == 2 * rounds

    calls, callers, inside = [], [], []
    monkeypatch.setattr(ef4, "mul", lambda a, b: model_mul(a, b, calls))
    monkeypatch.setattr(ef4, "mul_sum", lambda v, w, index=None, ext=True: model_mul_sum(
        v, w, index, ext, calls=calls))
    ext_mul, batch_phase, gkr_eq = F.ext_mul, lz.prove_batch_phase, lz.gkr_eq

    def counted_ext_mul(a, b):
        if inside and inside[-1]:
            import inspect

            callers.append(inspect.stack()[1].function)
        return ext_mul(a, b)

    def batch(*args, **kwargs):
        inside.append(True)
        try:
            return batch_phase(*args, **kwargs)
        finally:
            inside.pop()

    def eq_table(xi):
        inside.append(False)
        try:
            return gkr_eq(xi)
        finally:
            inside.pop()

    monkeypatch.setattr(F, "ext_mul", counted_ext_mul)
    monkeypatch.setattr(lz, "prove_batch_phase", batch)
    monkeypatch.setattr(lz, "gkr_eq", eq_table)
    got, counters = _prove(degree)
    assert got == want
    assert counters["batch_ef4_aten"] == 2 * rounds == len(callers)
    assert set(callers) == {"fold_mle"}
    kinds = {c[0] for c in calls}
    assert kinds == {"mul", "mul_sum"} and len(calls) > 100
