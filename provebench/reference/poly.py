"""Host-side polynomial utilities shared by the verifier and the prover's
host orchestration (numpy, canonical representation).

Covers the equality-kernel zoo of the SWIRL protocol (cf. reference
``crates/stark-backend/src/poly_common.rs`` and ``prover/poly.rs``):

- multilinear eq / Möbius-adjusted eq kernels and their hypercube tables,
- the univariate-skip domain kernels eq_D(x,y), eq_D(x,1), the lift
  indicator in_{D,n}, the eq# kernel, the prismatic rotation kernel,
- univariate polynomial helpers: Horner, Lagrange interpolation, small DFTs
  over EF with base-field twiddles, interpolation from geometric cosets.

Everything here is "protocol-small" (degree ~ d * 2^l_skip); bulk work lives
on device.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

from .fields import ext
from .fields.babybear import (
    P,
    U64,
    batch_inverse,
    finv,
    roots_of_unity,
    two_adic_generator,
)

EF = np.ndarray  # (..., 4) canonical uint64


# ---------------------------------------------------------------------------
# eq kernels (multilinear)
# ---------------------------------------------------------------------------


def eval_eq_mle(x: np.ndarray, y: np.ndarray) -> EF:
    """prod_i (x_i y_i + (1-x_i)(1-y_i)) for EF vectors (n,4)."""
    x = np.asarray(x, U64).reshape(-1, 4)
    y = np.asarray(y, U64).reshape(-1, 4)
    assert x.shape == y.shape
    acc = ext.eone()
    one = ext.eone()
    for xi, yi in zip(x, y):
        t = ext.emul(xi, yi)
        term = ext.eadd(ext.esub(ext.eadd(one, ext.eadd(t, t)), xi), ext.eneg(yi))
        acc = ext.emul(acc, term)
    return acc


def eval_mobius_eq_mle(u: np.ndarray, x: np.ndarray) -> EF:
    """prod_i ((1-2u_i)(1-x_i) + u_i x_i)."""
    u = np.asarray(u, U64).reshape(-1, 4)
    x = np.asarray(x, U64).reshape(-1, 4)
    acc = ext.eone()
    one = ext.eone()
    for ui, xi in zip(u, x):
        w0 = ext.esub(one, ext.eadd(ui, ui))
        term = ext.eadd(ext.emul(w0, ext.esub(one, xi)), ext.emul(ui, xi))
        acc = ext.emul(acc, term)
    return acc


def evals_eq_hypercube(x: np.ndarray) -> np.ndarray:
    """eq(x, y) for all y in H_n: (2^n, 4), mask bit i <-> x[i]."""
    x = np.asarray(x, U64).reshape(-1, 4)
    n = x.shape[0]
    out = np.zeros((1 << n, 4), dtype=U64)
    out[0] = ext.eone()
    for i in range(n):
        lo = out[: 1 << i].copy()
        out[1 << i : 2 << i] = ext.emul(lo, x[i])
        out[: 1 << i] = ext.emul(lo, ext.esub(ext.eone(), x[i]))
    return out


def evals_mobius_eq_hypercube(u: np.ndarray) -> np.ndarray:
    """mobius_eq kernel table over H_n: per-bit weights (1-2u_i, u_i)."""
    u = np.asarray(u, U64).reshape(-1, 4)
    n = u.shape[0]
    out = np.zeros((1 << n, 4), dtype=U64)
    out[0] = ext.eone()
    one = ext.eone()
    for i in range(n):
        w0 = ext.esub(one, ext.eadd(u[i], u[i]))
        lo = out[: 1 << i].copy()
        out[1 << i : 2 << i] = ext.emul(lo, u[i])
        out[: 1 << i] = ext.emul(lo, w0)
    return out


def eval_mle_evals_at_point(evals: np.ndarray, x: np.ndarray) -> EF:
    """Evaluate an MLE given by hypercube evals (2^n, 4) at x ((n, 4))."""
    evals = np.asarray(evals, U64).reshape(-1, 4).copy()
    x = np.asarray(x, U64).reshape(-1, 4)
    assert evals.shape[0] == 1 << x.shape[0]
    n = evals.shape[0]
    for xj in reversed(x):
        n >>= 1
        lo, hi = evals[:n], evals[n : 2 * n]
        evals[:n] = ext.eadd(lo, ext.emul(ext.esub(hi, lo), xj))
    return evals[0]


def eval_eq_rot_cube(x: np.ndarray, y: np.ndarray):
    """(eq(x,y), rot-kernel(x,y)) on the hypercube (recursive formula)."""
    x = np.asarray(x, U64).reshape(-1, 4)
    y = np.asarray(y, U64).reshape(-1, 4)
    one = ext.eone()
    rot = ext.eone()
    eq = ext.eone()
    for xi, yi in zip(reversed(x), reversed(y)):
        rot = ext.eadd(
            ext.emul(ext.emul(xi, ext.esub(one, yi)), eq),
            ext.emul(ext.emul(ext.esub(one, xi), yi), rot),
        )
        eq = ext.emul(
            eq,
            ext.eadd(
                ext.emul(xi, yi), ext.emul(ext.esub(one, xi), ext.esub(one, yi))
            ),
        )
    return eq, rot


# ---------------------------------------------------------------------------
# univariate-skip domain kernels
# ---------------------------------------------------------------------------


def _exp_powers_of_2(x: EF, count: int) -> List[EF]:
    out = [np.asarray(x, U64)]
    for _ in range(count - 1):
        out.append(ext.emul(out[-1], out[-1]))
    return out


def eval_eq_uni(l_skip: int, x: EF, y: EF) -> EF:
    """eq_D(x, y): Lagrange-diagonal kernel of the size-2^l_skip subgroup."""
    res = ext.eone()
    one = ext.eone()
    if l_skip > 0:
        xs = _exp_powers_of_2(x, l_skip)
        ys = _exp_powers_of_2(y, l_skip)
        for xp, yp in zip(xs, ys):
            res = ext.eadd(
                ext.emul(ext.eadd(xp, yp), res),
                ext.emul(ext.esub(xp, one), ext.esub(yp, one)),
            )
    half_l = pow((P + 1) // 2, l_skip, P)
    return ext.escale(res, half_l)


def eval_eq_uni_at_one(l_skip: int, x: EF) -> EF:
    res = ext.eone()
    one = ext.eone()
    if l_skip > 0:
        for xp in _exp_powers_of_2(x, l_skip):
            res = ext.emul(res, ext.eadd(xp, one))
    return ext.escale(res, pow((P + 1) // 2, l_skip, P))


def eval_in_uni(l_skip: int, n: int, z: EF) -> EF:
    """Lift indicator in_{D,n}(z): 1 if n >= 0, else eq_{|n|}(z^{2^(l+n)}, 1)."""
    if n >= 0:
        return ext.eone()
    zp = _exp_powers_of_2(z, l_skip + n + 1)[-1]  # z^(2^(l_skip+n))
    return eval_eq_uni_at_one(-n, zp)


def eval_eq_prism(l_skip: int, x: Sequence[EF], y: Sequence[EF]) -> EF:
    return ext.emul(
        eval_eq_uni(l_skip, x[0], y[0]),
        eval_eq_mle(np.asarray(x[1:], U64), np.asarray(y[1:], U64))
        if len(x) > 1
        else ext.eone(),
    )


def eval_rot_kernel_prism(l_skip: int, x: Sequence[EF], y: Sequence[EF]) -> EF:
    """Prismatic rotation kernel kappa_rot(x, y) = delta_{x, rot(y)}."""
    omega = two_adic_generator(l_skip)
    x = np.asarray(x, U64)
    y = np.asarray(y, U64)
    if len(x) > 1:
        eq_cube, rot_cube = eval_eq_rot_cube(x[1:], y[1:])
    else:
        eq_cube, rot_cube = ext.eone(), ext.eone()
    y0w = ext.escale(y[0], omega)
    term1 = ext.emul(eval_eq_uni(l_skip, x[0], y0w), eq_cube)
    term2 = ext.emul(
        ext.emul(eval_eq_uni_at_one(l_skip, x[0]), eval_eq_uni_at_one(l_skip, y0w)),
        ext.esub(rot_cube, eq_cube),
    )
    return ext.eadd(term1, term2)


def eval_eq_sharp_uni(l_skip: int, xi_1: np.ndarray, z: EF) -> EF:
    """eq#: sum over omega in D of eq_D(z, omega) * eq(xi_1, bits(omega))."""
    xi_1 = np.asarray(xi_1, U64).reshape(-1, 4)
    assert xi_1.shape[0] == l_skip
    omega_pows = roots_of_unity(l_skip)
    eq_tab = evals_eq_hypercube(xi_1)
    res = ext.ezero()
    for k in range(1 << l_skip):
        term = eval_eq_uni(l_skip, z, ext.from_base(int(omega_pows[k])))
        res = ext.eadd(res, ext.emul(term, eq_tab[k]))
    return res


def eq_uni_poly(l_skip: int, x: EF) -> np.ndarray:
    """eq_D(x, Z) as coefficients in Z: (2^l_skip, 4).

    eq_D(x, z) = 1/N * sum_{k=1..N} x^k z^{N-k}; coefficient of z^j is
    x^{N-j} / N for j >= 1 and 1/N for j = 0.
    """
    n = 1 << l_skip
    n_inv = pow(n, P - 2, P)
    pows = ext.epowers(np.asarray(x, U64), n + 1)  # x^0..x^n
    coeffs = np.zeros((n, 4), dtype=U64)
    # eq_D(x, z) = (1/N) * (1 + sum_{j>=1} x^{N-j} z^j)
    coeffs[0] = ext.escale(ext.eone(), n_inv)
    for j in range(1, n):
        coeffs[j] = ext.escale(pows[n - j], n_inv)
    return coeffs


def eq_sharp_uni_poly(xi_1: np.ndarray) -> np.ndarray:
    """eq#(xi_1, Z) in coefficient form: iDFT of the eq(xi_1, -) table."""
    evals = evals_eq_hypercube(np.asarray(xi_1, U64))
    return idft_ef(evals)


# ---------------------------------------------------------------------------
# univariate polynomial helpers (EF coefficients as (k, 4) arrays)
# ---------------------------------------------------------------------------


def horner_eval(coeffs: np.ndarray, x: EF) -> EF:
    coeffs = np.asarray(coeffs, U64).reshape(-1, 4)
    acc = ext.ezero()
    for c in reversed(coeffs):
        acc = ext.eadd(ext.emul(acc, x), c)
    return acc


def interpolate_linear_at_01(evals, x: EF) -> EF:
    p = ext.esub(evals[1], evals[0])
    return ext.eadd(ext.emul(p, x), evals[0])


def interpolate_quadratic_at_012(evals, x: EF) -> EF:
    s1 = ext.esub(evals[1], evals[0])
    s2 = ext.esub(evals[2], evals[1])
    half = (P + 1) // 2
    pq = ext.escale(ext.esub(s2, s1), half)
    q = ext.esub(s1, pq)
    return ext.eadd(ext.emul(ext.eadd(ext.emul(pq, x), q), x), evals[0])


def interpolate_cubic_at_0123(evals, x: EF) -> EF:
    inv6 = pow(6, P - 2, P)
    s1 = ext.esub(evals[1], evals[0])
    s2 = ext.esub(evals[2], evals[0])
    s3 = ext.esub(evals[3], evals[0])
    d3 = ext.esub(s3, ext.escale(ext.esub(s2, s1), 3))
    p_ = ext.escale(d3, inv6)
    q_ = ext.esub(ext.escale(ext.esub(s2, d3), (P + 1) // 2), s1)
    r_ = ext.esub(ext.esub(s1, p_), q_)
    acc = ext.eadd(ext.emul(ext.eadd(ext.emul(ext.eadd(ext.emul(p_, x), q_), x), r_), x), evals[0])
    return acc


def lagrange_interpolate_at_integers(evals: np.ndarray, x: EF) -> EF:
    """Interpolate through (i, evals[i]) for i = 0..d and evaluate at x."""
    evals = np.asarray(evals, U64).reshape(-1, 4)
    d = evals.shape[0] - 1
    fact = [1] * (d + 1)
    for i in range(1, d + 1):
        fact[i] = fact[i - 1] * i % P
    invfact = [finv(f) for f in fact]
    pref = [ext.eone()]
    for i in range(d):
        pref.append(ext.emul(pref[-1], ext.esub(x, ext.from_base(i))))
    suf = [ext.eone()]
    for i in range(d):
        suf.append(ext.emul(suf[-1], ext.esub(ext.from_base(d - i), x)))
    acc = ext.ezero()
    for i in range(d + 1):
        term = ext.emul(pref[i], suf[d - i])
        scale = invfact[i] * invfact[d - i] % P
        acc = ext.eadd(acc, ext.escale(ext.emul(term, evals[i]), scale))
    return acc


def lagrange_coeffs(points: Sequence[int], evals: np.ndarray) -> np.ndarray:
    """Coefficient form through base-field points with EF evals: (k, 4)."""
    evals = np.asarray(evals, U64).reshape(-1, 4)
    k = evals.shape[0]
    assert len(points) == k
    if k == 0:
        return np.zeros((0, 4), dtype=U64)
    coeffs = np.zeros((k, 4), dtype=U64)
    for i in range(k):
        if ext.is_zero(evals[i]):
            continue
        # L_i(x) = prod_{j != i} (x - p_j) / (p_i - p_j), base-field coeffs
        li = np.zeros(k, dtype=U64)
        li[0] = 1
        deg = 0
        denom = 1
        for j in range(k):
            if j == i:
                continue
            pj = int(points[j]) % P
            denom = denom * ((int(points[i]) - pj) % P) % P
            deg += 1
            for t in range(deg, 0, -1):
                li[t] = (li[t - 1] + (P - pj) * li[t]) % P
            li[0] = li[0] * (P - pj) % P
        scale = finv(denom)
        weights = (li * U64(scale)) % U64(P)  # (k,) base field
        coeffs = ext.eadd(coeffs, ext.escale(np.broadcast_to(evals[i], (k, 4)), weights))
    return coeffs


# ---------------------------------------------------------------------------
# small DFTs over EF (base-field twiddles), O(N^2) vectorized
# ---------------------------------------------------------------------------


def _twiddle_matrix(n: int, inverse: bool) -> np.ndarray:
    log_n = n.bit_length() - 1
    assert 1 << log_n == n
    w = two_adic_generator(log_n)
    if inverse:
        w = finv(w)
    idx = (np.arange(n)[:, None] * np.arange(n)[None, :]) % n
    pw = np.empty(n, dtype=U64)
    acc = 1
    for i in range(n):
        pw[i] = acc
        acc = acc * w % P
    return pw[idx]


def dft_ef(coeffs: np.ndarray) -> np.ndarray:
    """evals[i] = poly(w^i); coeffs (n, 4) EF -> (n, 4)."""
    coeffs = np.asarray(coeffs, U64).reshape(-1, 4)
    n = coeffs.shape[0]
    if n <= 1:
        return coeffs.copy()
    W = _twiddle_matrix(n, False)
    prod = (coeffs[None, :, :] * W[:, :, None]) % U64(P)
    return prod.sum(axis=1, dtype=np.uint64) % U64(P)


def idft_ef(evals: np.ndarray) -> np.ndarray:
    evals = np.asarray(evals, U64).reshape(-1, 4)
    n = evals.shape[0]
    if n <= 1:
        return evals.copy()
    W = _twiddle_matrix(n, True)
    prod = (evals[None, :, :] * W[:, :, None]) % U64(P)
    out = prod.sum(axis=1, dtype=np.uint64) % U64(P)
    return (out * U64(finv(n))) % U64(P)


def from_geometric_cosets_evals(
    evals: np.ndarray, shift: int, init: int
) -> np.ndarray:
    """Interpolate a polynomial of degree < height*width from evaluations on
    the cosets ``init * shift^i * D`` for i = 0..width-1 (D the size-`height`
    two-adic subgroup). evals[(row, col)] = poly(init * shift^col * w^row),
    shape (height, width, 4). Returns coefficients (height*width, 4).

    Algorithm (cf. reference ``prover/poly.rs:621``): per-coset iDFT gives the
    remainder mod X^height - (init*shift^col)^height after unshifting; then a
    cross-coset Lagrange interpolation per coefficient degree recovers the
    full coefficient vector.
    """
    evals = np.asarray(evals, U64)
    height, width = evals.shape[0], evals.shape[1]
    if height == 0 or width == 0:
        return np.zeros((0, 4), dtype=U64)
    # 1) per-coset iDFT (columns are cosets)
    coeff_cols = np.stack([idft_ef(evals[:, c]) for c in range(width)], axis=1)
    # 2) unshift: coefficient t of coset c is scaled by (init * shift^c)^t
    for c in range(width):
        s_inv = finv(init * pow(shift, c, P) % P)
        acc = 1
        for t in range(height):
            coeff_cols[t, c] = ext.escale(coeff_cols[t, c], acc)
            acc = acc * s_inv % P
    # 3) cross-coset interpolation at points (init*shift^c)^height
    pts = [
        pow(init * pow(shift, c, P) % P, height, P) for c in range(width)
    ]
    out = np.zeros((height * width, 4), dtype=U64)
    for t in range(height):
        poly_c = lagrange_coeffs(pts, coeff_cols[t])  # (width, 4)
        for c in range(width):
            out[c * height + t] = poly_c[c]
    return out


def univariate_from_evals_on_subgroup(evals: np.ndarray) -> np.ndarray:
    """Coefficients from evaluations on the full two-adic subgroup (iDFT)."""
    return idft_ef(evals)


def sum_over_subgroup_from_coeffs(coeffs: np.ndarray, l_skip: int) -> EF:
    """sum_{z in D} poly(z) = |D| * (c_0 + c_{|D|} + c_{2|D|} + ...)."""
    coeffs = np.asarray(coeffs, U64).reshape(-1, 4)
    n = 1 << l_skip
    acc = ext.ezero()
    for j in range(0, coeffs.shape[0], n):
        acc = ext.eadd(acc, coeffs[j])
    return ext.escale(acc, n % P)


def powers_ef(x: EF, n: int) -> np.ndarray:
    return ext.epowers(x, n)
