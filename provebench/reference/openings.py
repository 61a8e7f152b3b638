"""Each trace column's value at the batch sumcheck's point, from the trace
itself: what a proof's column openings must claim.

A column of 2^(l_skip + n) rows is read as 2^n chunks of 2^l_skip
consecutive rows. Each chunk is a polynomial's values on the subgroup D of
order 2^l_skip (row j of a chunk at omega^j); the opening is each chunk's
polynomial at r_0, then the multilinear extension over the chunk index at
(r_1, ..., r_n), bit i of the index against r_{i+1}. So the opening is
sum_i T[i] * L_{i mod 2^l_skip}(r_0) * eq(i >> l_skip, r_{1..n}), with L_j
the Lagrange basis of D. The rotated opening reads the next row, T[i + 1],
cyclically.

Plain PyTorch on the trace's device, int64 canonical values. Nothing here
comes from the program: the weights are worked out from the verifier's
point alone.
"""

from __future__ import annotations

import numpy as np
import torch

from . import poly as hpoly
from .fields import ext
from .fields.babybear import P, U64, finv, two_adic_generator

# columns summed at once: a (block, rows) product of int64 stays under a GB
# at 2^20 rows
_ROWS_X_COLUMNS = 1 << 26


def lagrange_at(l_skip: int, x: np.ndarray) -> np.ndarray:
    """(2^l_skip, 4): L_j(x) for j < 2^l_skip, L_j(x) = (1/N) sum_k
    (x omega^-j)^k on the subgroup of order N = 2^l_skip."""
    n = 1 << l_skip
    omega_inv = finv(two_adic_generator(l_skip))
    x_pows = ext.epowers(np.asarray(x, U64), n)  # (n, 4)
    n_inv = finv(n)
    out = np.zeros((n, 4), dtype=U64)
    for j in range(n):
        w = pow(omega_inv, j, P)
        coeffs = np.array([pow(w, k, P) * n_inv % P for k in range(n)], dtype=U64)
        out[j] = (x_pows * coeffs[:, None] % U64(P)).sum(axis=0, dtype=U64) % U64(P)
    return out


def row_weights(l_skip: int, r) -> np.ndarray:
    """(2^(l_skip + n), 4) EF weights of the rows, for r = (r_0, ..., r_n)."""
    r = np.asarray(r, U64).reshape(-1, 4)
    lag = lagrange_at(l_skip, r[0])
    eq = hpoly.evals_eq_hypercube(r[1:]) if r.shape[0] > 1 else ext.eone()[None]
    return ext.emul(eq[:, None, :], lag[None, :, :]).reshape(-1, 4)


def _weighted_sums(trace: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """(width, 4): sum_i trace[c, i] * weights[i] mod P, for a (width, rows)
    int64 trace and (rows, 4) int64 weights."""
    width, rows = trace.shape
    out = torch.zeros((width, 4), dtype=torch.int64, device=trace.device)
    block = max(1, _ROWS_X_COLUMNS // rows)
    for c0 in range(0, width, block):
        t = trace[c0 : c0 + block]
        for k in range(4):
            out[c0 : c0 + block, k] = (t * weights[:, k]).remainder_(P).sum(dim=1).remainder_(P)
    return out


def column_openings(trace: torch.Tensor, l_skip: int, r, rotated: bool) -> np.ndarray:
    """The openings of a (width, rows) canonical int64 trace at r, as the
    proof lists a trace's common main: (claim, rotated claim) a column when
    ``rotated``, else the claims; (k, 4) uint64."""
    w = torch.from_numpy(row_weights(l_skip, r).astype(np.int64)).to(trace.device)
    if w.shape[0] != trace.shape[1]:
        raise ValueError(f"openings: {trace.shape[1]} rows against a point of {w.shape[0]} rows")
    claims = _weighted_sums(trace, w)
    if not rotated:
        return claims.cpu().numpy().astype(U64)
    # sum_i T[i + 1] w[i] = sum_j T[j] w[j - 1]
    rot = _weighted_sums(trace, torch.roll(w, 1, dims=0))
    return torch.stack([claims, rot], dim=1).reshape(-1, 4).cpu().numpy().astype(U64)
