"""Sumcheck building blocks on torch tensors.

Peer of ``swirl/prover/sumcheck.py``. Every table here is in NATURAL index
order (bit i of the index belongs to variable i); the JAX package's
bit-reversed device layouts are a TPU choice the port does not copy, and the
values that reach the transcript are the same.

Matrices: base (w, h) or EF (w, h, 4) canonical int64; the hypercube or
prism index is the data axis. Protocol-small values (points, challenges)
are device tensors (the tables also take host EF values).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..fields.babybear import U64

from .. import tpoly
from ..fields import field as F
from .ntt import coset_ntt, intt


def lift_mat(mat, l_skip: int):
    """Cyclically tile a (w, h[, 4]) matrix to height >= 2^l_skip."""
    h = mat.shape[1]
    if h >= 1 << l_skip:
        return mat
    reps = (1 << l_skip) // h
    return mat.repeat((1, reps) + (1,) * (mat.dim() - 2))


def rot1(mat):
    """out[:, i] = mat[:, (i + 1) % h]."""
    return torch.roll(mat, -1, dims=1)


def fold_ple(mat, l_skip: int, is_rot: bool, weights):
    """Evaluate prismalinear columns at r (``weights`` from
    :func:`swirl_torch.tpoly.barycentric_weights`, a (2^l_skip, 4) tensor):
    (w, h[, 4]) -> (w, lifted_h >> l_skip, 4)."""
    if is_rot:
        mat = rot1(mat)
    mat = lift_mat(mat, l_skip)
    n = 1 << l_skip
    acc = None
    for i in range(n):  # one weight at a time keeps the temporaries (w, h/n, 4)
        col = mat[:, i::n]
        term = F.ext_mul(col, weights[i]) if mat.dim() == 3 else F.mul(col[..., None], weights[i])
        acc = term if acc is None else F.add(acc, term)
    return acc


def fold_mle(tab, r):
    """Fold the MLE pairs (t0, t1) = (2i, 2i+1) of the data axis at the EF
    point r: (..., h, 4) -> (..., h/2, 4), t0 + (t1 - t0) * r."""
    if tab.shape[-2] <= 1:
        return tab
    t0, t1 = tab[..., 0::2, :], tab[..., 1::2, :]
    return F.add(t0, F.ext_mul(F.sub(t1, t0), r))


def interp_mle_at_int(tab, x: int):
    """The MLE pairs (2i, 2i+1) of the data axis at integer X:
    (..., h, 4) -> (..., h/2, 4)."""
    t0, t1 = tab[..., 0::2, :], tab[..., 1::2, :]
    if x == 1:
        return t1
    return F.add(t0, F.mul(F.sub(t1, t0), x))


def ef_dev(v, device):
    """Host EF value(s) -> tensor."""
    return F.const_arr(np.asarray(v, U64), device)


def _ef_rows(v, device):
    """EF point(s), a device tensor or host values, as an (n, 4) tensor."""
    if isinstance(v, torch.Tensor):
        return v.reshape(-1, 4)
    return ef_dev(np.asarray(v, U64).reshape(-1, 4), device)


def _doubling_table(w0, w1):
    """Table over H_n from per-variable weights w0, w1 (each (n, 4) on the
    device): bit i of the index <-> variable i (each new variable is the
    high bit)."""
    out = F.ext_one(w0.device)[None]
    for i in range(w0.shape[0]):
        out = torch.cat([F.ext_mul(out, w0[i]), F.ext_mul(out, w1[i])])
    return out


def eq_hypercube(xi_vec, device):
    """eq(xi, y) over H_n as a (2^n, 4) tensor; xi_vec: (n, 4), a device
    tensor or host values (peer of ``eq_hypercube_dev`` :166)."""
    xi = _ef_rows(xi_vec, device)
    return _doubling_table(F.sub(F.ext_one(xi.device), xi), xi)


def mobius_eq_hypercube(u_vec, device):
    """Mobius-adjusted eq table over H_n: per-variable weights (1 - 2u, u)."""
    u = _ef_rows(u_vec, device)
    return _doubling_table(F.sub(F.ext_one(u.device), F.add(u, u)), u)


def _squares(z, n: int, device):
    """[z, z^2, z^4, ..., z^(2^(n-1))] of an EF point z as an (n, 4) tensor."""
    z = _ef_rows(z, device)[0]
    return torch.stack(tpoly.squares(z, n)) if n else z.new_zeros((0, 4))


def eq_pows_hypercube(z, n: int, device):
    """eq((z, z^2, z^4, ...), y) over H_n for an EF point z (peer of
    ``eq_pows_hypercube_dev`` :244)."""
    return eq_hypercube(_squares(z, n, device), device)


def pow_hypercube(z, n: int, device):
    """T[y] = z^y over H_n (y read as an integer) for an EF point z."""
    squares = _squares(z, n, device)
    out = F.ext_one(squares.device)[None]
    for s in squares:
        out = torch.cat([out, F.ext_mul(out, s)])
    return out


def eq_pows_base_batch(zvec, n: int):
    """Batched eq(pow(z_i), y) tables for base-field points zvec (Q,):
    (Q, 2^n) base field, one doubling ladder for all points (peer of
    ``eq_pows_base_batch_dev`` :269)."""
    out = torch.ones((zvec.shape[0], 1), dtype=F.DTYPE, device=zvec.device)
    z = zvec
    for _ in range(n):
        x = z[:, None]
        out = torch.cat([F.mul(out, F.sub(torch.ones_like(x), x)), F.mul(out, x)], dim=1)
        z = F.mul(z, z)
    return out


def coset_eval_chunks(mat, l_skip: int, coset_shifts: Sequence[int], is_rot: bool):
    """Univariate-skip round-0 grid: (w, h) base columns -> (w, n_chunks,
    n_shifts << l_skip), the polynomial through each 2^l_skip chunk
    evaluated on each coset shift * D (grouped by coset)."""
    if is_rot:
        mat = rot1(mat)
    mat = lift_mat(mat, l_skip)
    w, h = mat.shape
    coeffs = intt(mat.reshape(w, h >> l_skip, 1 << l_skip))
    return torch.cat([coset_ntt(coeffs, s) for s in coset_shifts], dim=2)


def selectors_matrix(height: int, l_skip: int, device):
    """(3, lifted_height) base selectors [is_first, is_transition, is_last]."""
    lifted = max(height, 1 << l_skip)
    idx = torch.arange(lifted, device=device) % height
    is_first = (idx == 0).to(F.DTYPE)
    is_last = (idx == height - 1).to(F.DTYPE)
    return torch.stack([is_first, 1 - is_last, is_last])
