"""The torch port's generic field zoo (``swirl_torch/fields/generic.py``)
against the JAX package's (``swirl/fields/generic.py``) and a Python-int
oracle, on the CPU.

Every field of ``FIELDS``: add, sub and mul of random operands (numpy,
from a seed) and of the edge values, through ``to_host``, equal JAX's and
the oracle's; a * a^-1 = 1 by the oracle, and the base fields' inverses
equal JAX's (an inverse is unique, so the oracle holds the extensions';
JAX's eager Fermat chain in an extension takes 10-20 s on a CPU).
Goldilocks' carries at 0, 1, p - 1, 2^32 - 1, 2^32 and the values whose
limbs are all ones. Tolerance: exact equality (finite field).
"""

import numpy as np
import pytest

import jax

jax.config.update("jax_platforms", "cpu")

from swirl.fields import generic as jg  # noqa: E402
from swirl_torch.fields import generic as tg  # noqa: E402

import chip_smoke  # noqa: E402

N = 67  # not a power of two
GL = tg.GL_P
GL_EDGES = [0, 1, 2, GL - 1, GL - 2, (1 << 32) - 1, 1 << 32, (1 << 32) + 1, GL - (1 << 32),
            (1 << 63), GL - 1 - ((1 << 32) - 1)]


def _p(name):
    return GL if name in ("goldilocks", "gl3") else tg.FIELDS[name].base.p if name in ("bb5", "bb6", "kb5", "kb6") \
        else tg.FIELDS[name].p


def _d(name):
    return {"bb5": 5, "bb6": 6, "kb5": 5, "kb6": 6, "gl3": 3}.get(name, 1)


def _reduction(name):
    if name == "gl3":
        return (1, 1, 0)  # X^3 = X + 1
    return tg.FIELDS[name].reduction


def _oracle_mul(name, a, b):
    """Column-wise products by Python ints: (d, n) or (n,) host arrays."""
    reduction = _reduction(name) if _d(name) > 1 else None
    out = chip_smoke.field_oracle_mul(_p(name), reduction, a, b)
    return out if reduction is None else np.array(out, dtype=object).T


def _values(name, seed, edges=()):
    p, d = _p(name), _d(name)
    rng = np.random.default_rng(seed)
    vals = [int(x) for x in rng.integers(0, p if p < 1 << 63 else 1 << 63, N * d, dtype=np.uint64)]
    if p > 1 << 63:  # the top bit of a Goldilocks value
        vals = [(v | (int(b) << 63)) % p for v, b in zip(vals, rng.integers(0, 2, N * d))]
    vals[: len(edges)] = list(edges)
    arr = np.array(vals, dtype=np.uint64)
    return arr if d == 1 else arr.reshape(d, N)


def _ports(name):
    return tg.FIELDS[name], jg.FIELDS[name]


def _to_dev(name, field, vals, **kw):
    return field.to_dev(vals, **kw) if name in ("goldilocks", "gl3") else field.to_monty(vals, **kw)


def _edges(name):
    p = _p(name)
    if name == "goldilocks":
        return GL_EDGES
    if name == "gl3":
        return GL_EDGES[:N]
    return [0, 1, p - 1, p - 2, 2]


@pytest.mark.parametrize("name", list(tg.FIELDS))
def test_add_sub_mul_match_jax_and_oracle(name):
    t, j = _ports(name)
    p = _p(name)
    a = _values(name, 1, _edges(name))
    b = _values(name, 2, list(reversed(_edges(name))))
    ta, tb = _to_dev(name, t, a, device="cpu"), _to_dev(name, t, b, device="cpu")
    ja, jb = _to_dev(name, j, a), _to_dev(name, j, b)
    assert ta.device.type == "cpu" and ta.dtype == tg.DTYPE
    assert np.array_equal(t.to_host(ta), a)
    for op in ("add", "sub", "mul"):
        got = t.to_host(getattr(t, op)(ta, tb))
        assert np.array_equal(got, j.to_host(getattr(j, op)(ja, jb))), op
        if op == "mul":
            want = _oracle_mul(name, a, b)
        else:
            sign = 1 if op == "add" else -1
            want = np.vectorize(lambda x, y: (int(x) + sign * int(y)) % p, otypes=[object])(a, b)
        assert np.array_equal(got.astype(object), np.asarray(want, dtype=object)), op


@pytest.mark.parametrize("name", list(tg.FIELDS))
def test_inverse(name):
    t, j = _ports(name)
    a = _values(name, 3)
    d = _d(name)
    if d == 1:
        a[a == 0] = 1
    else:
        a[0, (a == 0).all(0)] = 1
    ta = _to_dev(name, t, a, device="cpu")
    inv = t.to_host(t.inv(ta))
    one = _oracle_mul(name, a, inv)
    want_one = np.zeros_like(a, dtype=object)
    if d == 1:
        want_one[:] = 1
    else:
        want_one[0] = 1
    assert np.array_equal(np.asarray(one, dtype=object), want_one)
    assert np.array_equal(t.to_host(t.mul(ta, t.inv(ta))).astype(object), want_one)
    if d == 1:  # an inverse is unique, so the oracle's check above holds the extensions
        assert np.array_equal(inv, j.to_host(j.inv(_to_dev(name, j, a))))


@pytest.mark.parametrize("x", [0, 1, 2, (1 << 16) - 1, (1 << 16), (1 << 32) - 1])
@pytest.mark.parametrize("y", [0, 1, (1 << 31) + 5, (1 << 32) - 1])
def test_mul_full_carries(x, y):
    import torch

    hi, lo = tg._mul_full(torch.tensor([x]), torch.tensor([y]))
    assert (int(hi) << 32) | int(lo) == x * y
    assert 0 <= int(hi) < 1 << 32 and 0 <= int(lo) < 1 << 32


def test_goldilocks_neg_and_edges():
    t = tg.Goldilocks
    a = np.array(GL_EDGES, dtype=np.uint64)
    ta = t.to_dev(a, device="cpu")
    got = t.to_host(t.neg(ta))
    assert [int(v) for v in got] == [(-int(v)) % GL for v in a]
    j = jg.Goldilocks
    assert np.array_equal(got, j.to_host(j.neg(j.to_dev(a))))
    sq = t.to_host(t.mul(ta, ta))
    assert [int(v) for v in sq] == [int(v) * int(v) % GL for v in a]


def test_fields_inventory():
    assert list(tg.FIELDS) == list(jg.FIELDS) == [
        "babybear", "koalabear", "bb5", "bb6", "kb5", "kb6", "goldilocks", "gl3"]
    for name in ("bb5", "bb6", "kb5", "kb6"):
        t, j = _ports(name)
        assert (t.base.p, t.d, t.reduction) == (j.base.p, j.d, j.reduction)
