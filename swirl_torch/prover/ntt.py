"""Batched NTT over BabyBear on torch tensors: the wrapper of kernels A and
A′, their plain PyTorch version, the plain model of the four-step split, and
the transforms built on them.

Peer of ``swirl/prover/ntt.py`` (:76-192). ``ntt(x)[i] = poly(w^i)`` with
``w = two_adic_generator(log N)``, natural order in and out, along the last
axis (or the second to last for EF4 arrays ``(..., N, 4)``, which run as
four base planes). ``ntt(inverse=True)`` is unscaled; :func:`intt` applies
1/N.
"""

from __future__ import annotations

from functools import lru_cache

import torch

from .. import kernels as K
from ..fields import field as F
from ..fields.babybear import P, TWO_ADICITY, two_adic_generator

# BabyBear's two-adicity: the longest transform that exists. The TPU code's
# ceiling of 2^28 (ntt_pallas.py:60) has no 2^28-th root of unity to use.
MAX_LOG_N = TWO_ADICITY
SMALL_LOG_MAX = 13  # ntt.cu: one shared-memory pass up to 2^13 points, four-step above
RECURSIVE_LOG_N = 26  # above this the TPU recursed (A′); ntt.cu runs 2^14-point rows


def _root(log_n: int, inverse: bool) -> int:
    w = two_adic_generator(log_n)
    return pow(w, P - 2, P) if inverse else w


def _split(log_n: int):
    """ntt.cu's split N = n1 * n2: (log n1, log n2)."""
    if log_n <= SMALL_LOG_MAX:
        return 0, log_n
    return log_n // 2, log_n - log_n // 2


def _twiddle_tables(log_n: int, log_n1: int, inverse: bool, device: str):
    """The two-level twiddle table of an N = n1 * n2 split, canonical:
    hi[e] = w^(n1*e) for e < n2 and lo[e] = w^e for e < n1, so that
    w^e = hi[e >> log n1] * lo[e & (n1 - 1)] for every e < N."""
    w = _root(log_n, inverse)
    hi = F.powers(pow(w, 1 << log_n1, P), 1 << (log_n - log_n1), device)
    lo = F.powers(w, 1 << log_n1, device)
    return hi, lo


@lru_cache(maxsize=None)
def _kernel_table(log_n: int, inverse: bool, device: str):
    """hi then lo of ntt.cu's split, in Montgomery form (uint32 values in
    int32 storage): n2 + n1 entries, at most 2^14 + 2^13."""
    hi, lo = _twiddle_tables(log_n, _split(log_n)[0], inverse, device)
    return ((torch.cat([hi, lo]) * ((1 << 32) % P)) % P).to(torch.int32)


@lru_cache(maxsize=None)
def _plain_twiddles(log_n: int, inverse: bool, device: str):
    """Per-stage DIF twiddles: stage s (half-block h = N >> (s+1)) uses w_2h^j."""
    w = _root(log_n, inverse)
    return [F.powers(pow(w, 1 << s, P), 1 << (log_n - 1 - s), device) for s in range(log_n)]


@lru_cache(maxsize=None)
def _bitrev(log_n: int, device: str):
    idx = torch.arange(1 << log_n, device=device)
    rev = torch.zeros_like(idx)
    for b in range(log_n):
        rev |= ((idx >> b) & 1) << (log_n - 1 - b)
    return rev


def ntt_plain(x, inverse: bool = False):
    """(batch, N) -> (batch, N): decimation in frequency with contiguous-block
    butterflies, then one bit-reversal gather."""
    batch, n = x.shape
    log_n = n.bit_length() - 1
    dev = str(x.device)
    for s, tw in enumerate(_plain_twiddles(log_n, inverse, dev)):
        h = n >> (s + 1)
        v = x.reshape(batch, n // (2 * h), 2, h)
        a, b = v[:, :, 0], v[:, :, 1]
        x = torch.stack([F.add(a, b), F.mul(F.sub(a, b), tw)], dim=2).reshape(batch, n)
    return x[:, _bitrev(log_n, dev)]


def ntt_four_step_plain(x, log_n1: int, inverse: bool = False):
    """(batch, N) -> (batch, N) by the four-step split that ntt.cu runs:
    n1-point sub-NTTs over j1 of the (n1, n2) view, the w^(j2*k1) twiddle
    from the two-level table, n2-point sub-NTTs over j2, and a transpose
    to natural order X[k1 + n1*k2]. The model of the kernel's index
    algebra; equal to :func:`ntt_plain` for every split."""
    batch, n = x.shape
    log_n = n.bit_length() - 1
    n1, n2 = 1 << log_n1, n >> log_n1
    a = x.reshape(batch, n1, n2).transpose(1, 2).reshape(batch * n2, n1)
    a = ntt_plain(a, inverse).reshape(batch, n2, n1)  # [j2, k1]
    hi, lo = _twiddle_tables(log_n, log_n1, inverse, str(x.device))
    e = torch.arange(n2, device=x.device)[:, None] * torch.arange(n1, device=x.device)
    a = F.mul(a, F.mul(hi[e >> log_n1], lo[e & (n1 - 1)]))
    a = a.transpose(1, 2).reshape(batch * n1, n2)  # [k1, j2]
    a = ntt_plain(a, inverse).reshape(batch, n1, n2)  # [k1, k2]
    return a.transpose(1, 2).reshape(batch, n)


def kernel_for(log_n: int):
    """The launch counter a CUDA transform of 2^log_n points adds to."""
    return K.NTT_RECURSIVE if log_n > RECURSIVE_LOG_N else K.NTT


def _ntt_kernel(x, inverse: bool):
    K.require(x, 2, "ntt")
    batch, n = x.shape
    log_n = n.bit_length() - 1
    table = _kernel_table(log_n, inverse, str(x.device))
    out = torch.empty_like(x)
    if log_n > SMALL_LOG_MAX:  # four-step: two uint32 scratch buffers
        s0 = torch.empty(batch * n, dtype=torch.int32, device=x.device)
        s1 = torch.empty_like(s0)
        p0, p1 = s0.data_ptr(), s1.data_ptr()
    else:
        p0 = p1 = None
    K.LIB.launch(
        kernel_for(log_n), "swirl_ntt", x, x.data_ptr(), out.data_ptr(), p0, p1, batch, log_n, table.data_ptr()
    )
    return out


def ntt_rows(x, inverse: bool = False):
    """Kernels A and A′: (batch, N) base-field rows -> their DFTs."""
    n = x.shape[1]
    log_n = n.bit_length() - 1
    if n != 1 << log_n or log_n > MAX_LOG_N:
        raise ValueError(f"ntt: length {n} is not a power of two <= 2^{MAX_LOG_N}")
    if n == 1 or x.shape[0] == 0:
        return x.clone()
    if x.is_cuda:
        return _ntt_kernel(x, inverse)
    return ntt_plain(x, inverse)


def ntt(x, inverse: bool = False, ext: bool = False):
    """DFT along the data axis (-1, or -2 for EF4 arrays), natural order."""
    if ext:
        planes = x.movedim(-1, -2)  # (..., 4, N)
        out = ntt(planes.contiguous(), inverse)
        return out.movedim(-2, -1).contiguous()
    shape = x.shape
    return ntt_rows(x.reshape(-1, shape[-1]).contiguous(), inverse).reshape(shape)


def intt(x, ext: bool = False):
    """Inverse DFT with the 1/N scale."""
    n = x.shape[-2 if ext else -1]
    if n == 1:
        return x
    return F.mul(ntt(x, inverse=True, ext=ext), pow(n, P - 2, P))


def coset_ntt(coeffs, shift: int, ext: bool = False):
    """Evaluate on the coset shift * <w>: scale by shift^i, then NTT."""
    n = coeffs.shape[-2 if ext else -1]
    pows = F.powers(shift, n, coeffs.device)
    return ntt(F.mul(coeffs, pows[:, None] if ext else pows), ext=ext)


def _subset_transform(x, log_k: int, ext: bool, op):
    if ext:
        return _subset_transform(x.movedim(-1, -2), log_k, False, op).movedim(-2, -1).contiguous()
    shape = x.shape
    n = shape[-1]
    for b in range(log_k):
        v = x.reshape(shape[:-1] + (n >> (b + 1), 2, 1 << b))
        lo, hi = v[..., 0, :], v[..., 1, :]
        x = torch.stack([lo, op(hi, lo)], dim=-2).reshape(shape)
    return x


def zeta_transform(x, log_k: int, ext: bool = False):
    """Subset zeta over the low log_k index bits: x[i | 2^b] += x[i]."""
    return _subset_transform(x, log_k, ext, F.add)


def mobius_transform(x, log_k: int, ext: bool = False):
    """Inverse of :func:`zeta_transform`: x[i | 2^b] -= x[i]."""
    return _subset_transform(x, log_k, ext, F.sub)
