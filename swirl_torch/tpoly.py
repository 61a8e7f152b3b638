"""Protocol-small polynomial math on device values: the peer of
``swirl/tpoly.py``, on canonical int64 torch tensors with a trailing EF
dimension of 4.

The provers' round polynomials, points and eq kernels stay on the device,
so a stage on the device transcript reads nothing back inside its rounds.
Each function takes leading batch dimensions, so that one call serves every
trace, column or view of a group. Static data (integer points, subgroup
roots, coset shifts) becomes a constant matrix made once per device
(:func:`~swirl_torch.fields.field.cached_const`), and the value-dependent
part is a handful of tensor ops. :mod:`swirl_torch.poly` (host numpy) stays
the specification and the verifier's implementation; every function here
gives its values bit for bit. The peer of ``powers_ef`` is
:func:`~swirl_torch.fields.field.epowers`.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from .fields import field as F
from .fields.babybear import P, U64, finv, roots_of_unity, two_adic_generator

HALF = (P + 1) // 2
emul = F.ext_mul_small


def _one(x):
    return F.ext_one(x.device)


def _prod(terms, dim: int = -2):
    """Product of EF values along ``dim`` (a batch dimension), pairwise."""
    terms = terms.movedim(dim, -2)
    while terms.shape[-2] > 1:
        if terms.shape[-2] % 2:
            pad = _one(terms).expand(terms.shape[:-2] + (1, 4))
            terms = torch.cat([terms, pad], dim=-2)
        terms = emul(terms[..., 0::2, :], terms[..., 1::2, :])
    if terms.shape[-2] == 0:
        return _one(terms).expand(terms.shape[:-2] + (4,))
    return terms[..., 0, :]


def squares(x, count: int):
    """[x, x^2, x^4, ..., x^(2^(count-1))] of (..., 4) points, a list."""
    out = [x] if count else []
    for _ in range(count - 1):
        out.append(emul(out[-1], out[-1]))
    return out


def from_base_const(values, device) -> torch.Tensor:
    """Static base-field values as a cached (k, 4) EF constant."""
    values = tuple(int(v) % P for v in values)

    def make():
        out = np.zeros((len(values), 4), dtype=U64)
        out[:, 0] = values
        return out

    return F.cached_const(("from_base", values), make, device)


# -- eq kernels ---------------------------------------------------------------


def eval_eq_mle(x, y):
    """prod_i (1 + 2 x_i y_i - x_i - y_i): (..., n, 4) points -> (..., 4)."""
    x, y = torch.broadcast_tensors(x, y)
    t = emul(x, y)
    return _prod(F.sub(F.add(F.add(t, t), _one(x)), F.add(x, y)))


def evals_eq_hypercube(x):
    """eq(x, y) over H_n, bit i of y's index for variable i:
    (..., n, 4) -> (..., 2^n, 4)."""
    out = _one(x).expand(x.shape[:-2] + (1, 4))
    for i in range(x.shape[-2]):
        xi = x[..., i : i + 1, :]
        out = torch.cat([emul(out, F.sub(_one(x), xi)), emul(out, xi)], dim=-2)
    return out


def eval_eq_uni(l_skip: int, x, y):
    """eq_D(x, y), the Lagrange-diagonal kernel of the 2^l_skip subgroup."""
    x, y = torch.broadcast_tensors(x, y)
    res = _one(x).expand(x.shape)
    one = _one(x)
    if l_skip > 0:
        for xp, yp in zip(squares(x, l_skip), squares(y, l_skip)):
            res = F.add(emul(F.add(xp, yp), res), emul(F.sub(xp, one), F.sub(yp, one)))
    return F.mul(res, pow(HALF, l_skip, P))


def eval_eq_uni_at_one(l_skip: int, x):
    res = _one(x).expand(x.shape)
    if l_skip > 0:
        for xp in squares(x, l_skip):
            res = emul(res, F.add(xp, _one(x)))
    return F.mul(res, pow(HALF, l_skip, P))


def eval_in_uni(l_skip: int, n: int, z):
    """Lift indicator in_{D,n}(z): 1 if n >= 0, else eq_{|n|}(z^(2^(l+n)), 1)."""
    if n >= 0:
        return _one(z).expand(z.shape)
    return eval_eq_uni_at_one(-n, squares(z, l_skip + n + 1)[-1])


def eval_eq_sharp_uni(l_skip: int, xi_1, z):
    """eq#: sum over omega in D of eq_D(z, omega) * eq(xi_1, bits(omega));
    xi_1 (..., l_skip, 4), z (..., 4)."""
    eq_tab = evals_eq_hypercube(xi_1)
    omegas = from_base_const(roots_of_unity(l_skip), z.device)
    terms = eval_eq_uni(l_skip, z[..., None, :], omegas)
    return F.ext_sum(emul(terms, eq_tab), axis=-2)


def eq_uni_poly(l_skip: int, x):
    """eq_D(x, Z) as coefficients in Z: (..., 2^l_skip, 4), coefficient j
    x^(N-j) / N for j >= 1 and 1/N for j = 0."""
    n = 1 << l_skip
    pows = F.epowers(x, n)  # x^0 .. x^(n-1)
    coeffs = torch.cat([pows[..., :1, :], pows[..., 1:, :].flip(-2)], dim=-2)
    return F.mul(coeffs, pow(n, P - 2, P))


def eq_sharp_uni_poly(xi_1):
    """eq#(xi_1, Z) in coefficient form: the iDFT of the eq(xi_1, -) table."""
    return idft_ef(evals_eq_hypercube(xi_1))


# -- univariate polynomials (EF coefficients on dimension -2) -----------------


def horner_eval(coeffs, x):
    """sum_i c_i x^i: (..., k, 4) coefficients at (..., 4) points, by a
    power table (log-depth) and one product."""
    k = coeffs.shape[-2]
    return F.ext_sum(emul(coeffs, F.epowers(x, k)), axis=-2)


def _matmul(mat, evals):
    """out[..., j, :] = sum_i mat[j, i] * evals[..., i, :] for a (k_out,
    k_in) base-field constant."""
    return F.ext_sum(F.mul(evals[..., None, :, :], mat[:, :, None]), axis=-2)


def _lagrange_matrix(points: tuple) -> np.ndarray:
    """(k, k) with coeffs[j] = sum_i evals[i] * mat[j, i]: row j holds the
    degree-j coefficients of the Lagrange basis (peer of ``tpoly.py``
    _lagrange_matrix :125, transposed)."""
    k = len(points)
    mat = np.zeros((k, k), dtype=U64)
    for i in range(k):
        li = [1] + [0] * (k - 1)
        deg, denom = 0, 1
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
        mat[:, i] = [c * scale % P for c in li]
    return mat


def lagrange_coeffs(points: Sequence[int], evals):
    """Coefficients of the polynomial through the static base-field
    ``points`` with EF values evals (..., k, 4)."""
    points = tuple(int(p) % P for p in points)
    mat = F.cached_const(("lagrange", points), lambda: _lagrange_matrix(points), evals.device)
    return _matmul(mat, evals)


def _twiddle_matrix(n: int, inverse: bool) -> np.ndarray:
    """W[i, j] = w^(ij), the iDFT's scaled by 1/n."""
    w = two_adic_generator(n.bit_length() - 1)
    if inverse:
        w = finv(w)
    pw = [pow(w, e, P) for e in range(n)]
    idx = (np.arange(n)[:, None] * np.arange(n)[None, :]) % n
    tw = np.asarray(pw, dtype=U64)[idx]
    return (tw * U64(finv(n))) % U64(P) if inverse else tw


def _dft(values, inverse: bool):
    n = values.shape[-2]
    if n <= 1:
        return values
    mat = F.cached_const(("twiddles", n, inverse), lambda: _twiddle_matrix(n, inverse), values.device)
    return _matmul(mat, values)


def dft_ef(coeffs):
    """evals[i] = poly(w^i): (..., n, 4) -> (..., n, 4)."""
    return _dft(coeffs, False)


def idft_ef(evals):
    return _dft(evals, True)


def _unshift_scales(height: int, width: int, shift: int, init: int) -> np.ndarray:
    """(width, height): coefficient t of coset c scaled by (init shift^c)^-t."""
    out = np.zeros((width, height), dtype=U64)
    for c in range(width):
        s_inv = finv(init * pow(shift, c, P) % P)
        out[c] = [pow(s_inv, t, P) for t in range(height)]
    return out


def from_geometric_cosets_evals(evals, shift: int, init: int):
    """Coefficients (..., height * width, 4) of the polynomial of degree
    below height * width from its values evals (..., height, width, 4) on
    the cosets init * shift^c * D (D the size-``height`` subgroup): an iDFT
    per coset, the unshift, then Lagrange across the cosets for each degree
    (peer of ``tpoly.py`` :199-224)."""
    height, width = evals.shape[-3], evals.shape[-2]
    cols = idft_ef(evals.transpose(-3, -2))  # (..., width, height, 4)
    scales = F.cached_const(
        ("unshift", height, width, shift, init),
        lambda: _unshift_scales(height, width, shift, init),
        evals.device,
    )
    cols = F.mul(cols, scales[..., None])
    pts = tuple(pow(init * pow(shift, c, P) % P, height, P) for c in range(width))
    # out[c * height + t] = lagrange(pts, cols[:, t])[c]
    out = lagrange_coeffs(pts, cols.reshape(cols.shape[:-3] + (width, height * 4)))
    return out.reshape(cols.shape[:-3] + (width * height, 4))


def barycentric_weights(l_skip: int, r):
    """EF weights c_i with p(r) = sum_i c_i p(w^i) for deg p < N = 2^l_skip:
    c_i = (r^N - 1) / N * w^i / (r - w^i); r (..., 4) -> (..., N, 4). Peer
    of ``barycentric_weights_dev``."""
    omega = roots_of_unity(l_skip)
    pref = F.mul(F.sub(squares(r, l_skip + 1)[-1], _one(r)), pow(1 << l_skip, P - 2, P))
    w = from_base_const(omega, r.device)
    inv = F.einv(F.sub(r[..., None, :], w))
    return F.mul(emul(pref[..., None, :], inv), w[:, :1])
