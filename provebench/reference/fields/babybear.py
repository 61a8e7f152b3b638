"""BabyBear base field, host-side (numpy, canonical representation).

The prime is ``p = 2^31 - 2^27 + 1 = 2013265921`` with two-adicity 27 and
multiplicative generator 31 (matching Plonky3 ``p3-baby-bear`` conventions;
cf. reference ``crates/stark-backend`` which pins Plonky3 v0.4.3).

Host values are canonical integers in ``[0, p)`` stored as ``np.uint64``
scalars/arrays, or plain python ints. Products of two canonical values fit in
``u64`` (``p^2 < 2^62``), so ``(a * b) % P`` is exact.

This module is the *host* field used by the verifier, transcript, keygen and
all protocol-small polynomial math. The device (JAX/TPU) field with Montgomery
``uint32`` arithmetic lives in the JAX package; the port's torch field is
:mod:`swirl_torch.fields.field`.
"""

from __future__ import annotations

import numpy as np

P = 2013265921  # 2^31 - 2^27 + 1
TWO_ADICITY = 27
GENERATOR = 31  # multiplicative generator of F_p^*
# Degree-4 binomial extension F_p[x] / (x^4 - W). Plonky3 uses W = 11.
EXT_W = 11
EXT_DEGREE = 4

U64 = np.uint64


def finv(a):
    """Inverse by Fermat; works on scalars and arrays."""
    if np.isscalar(a) or np.asarray(a).ndim == 0:
        ai = int(a)
        if ai == 0:
            raise ZeroDivisionError("field inverse of zero")
        return pow(ai, P - 2, P)
    return fpow_arr(np.asarray(a, U64), P - 2)


def fpow_arr(a: np.ndarray, e: int) -> np.ndarray:
    """Elementwise a**e mod P by square-and-multiply."""
    result = np.ones_like(a)
    base = a % U64(P)
    ee = int(e)
    while ee > 0:
        if ee & 1:
            result = (result * base) % U64(P)
        base = (base * base) % U64(P)
        ee >>= 1
    return result


def batch_inverse(a: np.ndarray) -> np.ndarray:
    """Montgomery batch inversion (single pass of prefix products)."""
    a = np.asarray(a, U64).ravel()
    n = a.shape[0]
    if n == 0:
        return a
    prefix = np.empty(n, dtype=U64)
    acc = 1
    for i in range(n):
        prefix[i] = acc
        acc = (acc * int(a[i])) % P
    inv_acc = pow(int(acc), P - 2, P)
    out = np.empty(n, dtype=U64)
    for i in range(n - 1, -1, -1):
        out[i] = (int(prefix[i]) * inv_acc) % P
        inv_acc = (inv_acc * int(a[i])) % P
    return out


def two_adic_generator(bits: int) -> int:
    """Generator of the order-2^bits subgroup of F_p^*.

    Computed as ``GENERATOR^((p-1) / 2^bits)`` (same derivation as Plonky3's
    ``TwoAdicField::two_adic_generator`` for MontyField31).
    """
    assert 0 <= bits <= TWO_ADICITY
    return pow(GENERATOR, (P - 1) >> bits, P)


def roots_of_unity(bits: int) -> np.ndarray:
    """[w^0, w^1, ..., w^{2^bits - 1}] for w = two_adic_generator(bits)."""
    n = 1 << bits
    w = two_adic_generator(bits)
    out = np.empty(n, dtype=U64)
    acc = 1
    for i in range(n):
        out[i] = acc
        acc = (acc * w) % P
    return out
