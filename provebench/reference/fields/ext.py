"""Quartic binomial extension field EF = F_p[x]/(x^4 - 11), host-side (numpy).

EF values are uint64 arrays with trailing dimension 4 (canonical coefficients,
little-endian in the basis 1, x, x^2, x^3). Mirrors Plonky3's
``BinomialExtensionField<BabyBear, 4>`` used by the reference config
(``crates/stark-sdk/src/config/baby_bear_poseidon2.rs:37``).
"""

from __future__ import annotations

import numpy as np

from .babybear import EXT_W, P, U64

D = 4


def ezero(shape=()) -> np.ndarray:
    return np.zeros(tuple(np.atleast_1d(shape)) + (D,) if shape else (D,), dtype=U64)


def eone() -> np.ndarray:
    out = np.zeros(D, dtype=U64)
    out[0] = 1
    return out


def from_base(a) -> np.ndarray:
    """Embed base-field value(s) into EF: trailing dim 4 with coeff 0 = a."""
    a = np.asarray(a, U64)
    out = np.zeros(a.shape + (D,), dtype=U64)
    out[..., 0] = a % U64(P)
    return out


def from_coeffs(cs) -> np.ndarray:
    a = np.asarray(cs, U64) % U64(P)
    assert a.shape[-1] == D
    return a


def eadd(a, b):
    return (np.asarray(a, U64) + np.asarray(b, U64)) % U64(P)


def esub(a, b):
    return (np.asarray(a, U64) + U64(P) - np.asarray(b, U64)) % U64(P)


def eneg(a):
    return (U64(P) - np.asarray(a, U64)) % U64(P)


def emul(a, b) -> np.ndarray:
    """Schoolbook product with reduction x^4 = W. Broadcasts leading dims."""
    a = np.asarray(a, U64)
    b = np.asarray(b, U64)
    a0, a1, a2, a3 = (a[..., i] for i in range(4))
    b0, b1, b2, b3 = (b[..., i] for i in range(4))
    W = U64(EXT_W)
    p = U64(P)
    # each product < 2^62; sums of <= 4 reduced products fit in u64
    m = lambda x, y: (x * y) % p
    c0 = (m(a0, b0) + W * ((m(a1, b3) + m(a2, b2) + m(a3, b1)) % p)) % p
    c1 = (m(a0, b1) + m(a1, b0) + W * ((m(a2, b3) + m(a3, b2)) % p)) % p
    c2 = (m(a0, b2) + m(a1, b1) + m(a2, b0) + W * m(a3, b3)) % p
    c3 = (m(a0, b3) + m(a1, b2) + m(a2, b1) + m(a3, b0)) % p
    return np.stack([c0 % p, c1 % p, c2 % p, c3 % p], axis=-1)


def escale(a, s):
    """EF value(s) times base-field scalar(s)."""
    a = np.asarray(a, U64)
    s = np.asarray(s, U64)
    return (a * s[..., None]) % U64(P)


def epow(a: np.ndarray, e: int) -> np.ndarray:
    result = eone().copy()
    base = np.asarray(a, U64)
    ee = int(e)
    while ee > 0:
        if ee & 1:
            result = emul(result, base)
        base = emul(base, base)
        ee >>= 1
    return result


def einv(a: np.ndarray) -> np.ndarray:
    """Inverse via Frobenius norm: a^{-1} = conj / N(a).

    Uses a^{-1} = a^{p^3 + p^2 + p} / a^{p^3+p^2+p+1} where the denominator is
    in the base field. For simplicity (host-side, scalar-ish) we use
    square-and-multiply a^{q-2} with q = p^4: slower but obviously correct.
    """
    a = np.asarray(a, U64)
    if np.all(a == 0):
        raise ZeroDivisionError("extension field inverse of zero")
    # a^(p^4 - 2)
    return epow(a, P**4 - 2)


def is_zero(a) -> bool:
    return bool(np.all(np.asarray(a, U64) % U64(P) == 0))


def eeq(a, b) -> bool:
    return bool(
        np.all((np.asarray(a, U64) % U64(P)) == (np.asarray(b, U64) % U64(P)))
    )


def epowers(a: np.ndarray, n: int) -> np.ndarray:
    """[1, a, a^2, ..., a^{n-1}] with shape (n, 4)."""
    out = np.zeros((n, D), dtype=U64)
    if n == 0:
        return out
    out[0] = eone()
    for i in range(1, n):
        out[i] = emul(out[i - 1], a)
    return out


def esum(a: np.ndarray, axis=0) -> np.ndarray:
    """Sum of EF array along axis (trailing dim is coeffs)."""
    a = np.asarray(a, U64)
    if a.shape[axis] == 0:
        shape = list(a.shape)
        del shape[axis]
        return np.zeros(shape, dtype=U64)
    # chunked accumulate to stay within u64: each element < 2^31, u64 allows 2^33 adds
    return a.sum(axis=axis, dtype=np.uint64) % U64(P)


def edot(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Dot product sum_i a_i * b_i for (n,4) arrays."""
    return esum(emul(a, b), axis=0)
