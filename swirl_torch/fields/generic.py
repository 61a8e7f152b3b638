"""Generic device field arithmetic on torch tensors: 31-bit prime fields,
their sparse-modulus extensions, and 64-bit Goldilocks with its cubic
extension. Peer of ``swirl/fields/generic.py`` (itself the peer of the
reference's ``benchmarks/fields`` CUDA crate, ``benchmarks/fields/src/lib.rs``,
``cuda/include/{baby_bear,koala_bear,goldilocks}/*.h``).

Representation: every value is CANONICAL in an int64 tensor, as
:mod:`swirl_torch.fields.field` keeps BabyBear (the JAX module holds
Montgomery uint32; ``to_host`` of both gives the same canonical values).
Layouts are the JAX module's: extension elements ``(d, ...)``
coefficient-major, Goldilocks values ``(2, ...)`` (lo, hi) 32-bit limbs,
since a canonical Goldilocks value does not fit a signed int64. A product of
two 31-bit values is below 2^62, so a 31-bit field multiplies with one
``%``; a 32 x 32-bit limb product can reach 2^64, so Goldilocks forms it
from 16-bit limb products (``_mul_full``) and carries by shifts.

Field inventory (moduli from the reference headers):

- BabyBear  p = 2^31 - 2^27 + 1: fp5 = F_p[x]/(x^5 - 2),
  fp6 = F_p[x]/(x^6 - 31)  (fp4 is :mod:`swirl_torch.fields.field`'s)
- KoalaBear p = 2^31 - 2^24 + 1: base, kb5 = F_p[x]/(x^5 + x^2 - 1),
  kb6 = F_p[x]/(x^6 + x^3 + 1)
- Goldilocks p = 2^64 - 2^32 + 1: base, gl3 = F_p[X]/(X^3 - X - 1)

Inversion is Fermat powering (p^d - 2) over the batched product, one code
path for every field. Host constructors (``to_monty``, ``to_dev``) take the
device, the card by default.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np
import torch

DTYPE = torch.int64
M16 = 0xFFFF
M32 = 0xFFFFFFFF


def _mul_full(a, b):
    """Full 32 x 32 -> 64-bit product of values in [0, 2^32) as (hi, lo),
    each in [0, 2^32), from 16-bit limb products (each below 2^32)."""
    a0, a1 = a & M16, a >> 16
    b0, b1 = b & M16, b >> 16
    mid = a0 * b1 + a1 * b0  # below 2^33
    low = a0 * b0 + ((mid & M16) << 16)  # below 2^33
    return a1 * b1 + (mid >> 16) + (low >> 32), low & M32


@dataclass(frozen=True)
class Mont31:
    """Arithmetic over a 31-bit prime on canonical int64 tensors (the name
    is the JAX module's, whose values are Montgomery uint32)."""

    p: int

    @property
    def P(self) -> int:
        return self.p

    # -- host <-> device -------------------------------------------------

    def to_monty(self, vals, device="cuda") -> torch.Tensor:
        """Host values -> canonical tensor on ``device``."""
        a = np.asarray(vals, dtype=np.uint64) % np.uint64(self.p)
        return torch.from_numpy(a.astype(np.int64)).to(device)

    def to_host(self, x) -> np.ndarray:
        return x.detach().cpu().numpy().astype(np.uint64)

    # -- core ------------------------------------------------------------

    def add(self, a, b):
        s = a + b
        return torch.where(s >= self.p, s - self.p, s)

    def sub(self, a, b):
        d = a - b
        return torch.where(d < 0, d + self.p, d)

    def neg(self, a):
        return torch.where(a == 0, a, self.p - a)

    def mul(self, a, b):
        return (a * b) % self.p

    def const(self, v: int) -> int:
        """A host constant as the tensors take it (canonical)."""
        return int(v) % self.p

    def inv(self, a):
        """Fermat: a^(p-2)."""
        return self.pow_int(a, self.p - 2)

    def pow_int(self, a, e: int):
        result = torch.ones_like(a)
        base = a
        while e > 0:
            if e & 1:
                result = self.mul(result, base)
            base = self.mul(base, base)
            e >>= 1
        return result


_TABLES: dict = {}


@dataclass(frozen=True)
class ExtField:
    """F_p[x] / (monic modulus), coefficient-major ``(d, ...)`` tensors.

    ``reduction``: the substitution x^d = sum_i c_i x^i as a length-d tuple
    of host ints (so kb5's x^5 + x^2 - 1 is ``(1, 0, -1, 0, 0)`` meaning
    x^5 = 1 - x^2).
    """

    base: Mont31
    d: int
    reduction: Tuple[int, ...]

    def add(self, a, b):
        return self.base.add(a, b)

    def sub(self, a, b):
        return self.base.sub(a, b)

    def mul(self, a, b):
        """Schoolbook convolution (the d^2 coefficient products at once,
        summed onto their degree), then the top degrees folded down,
        highest first (a rule may cascade)."""
        d, p = self.d, self.base.p
        a, b = torch.broadcast_tensors(a, b)
        rest = a.shape[1:]
        prods = (a[:, None] * b[None, :]) % p  # (d, d, ...): below 2^31 each
        degree, red = self._tables(a.device)
        conv = torch.zeros((2 * d - 1,) + rest, dtype=DTYPE, device=a.device)
        conv.index_add_(0, degree, prods.reshape((d * d,) + rest))
        conv %= p
        red = red.reshape((d,) + (1,) * len(rest))
        for k in range(2 * d - 2, d - 1, -1):
            conv[k - d : k] = (conv[k - d : k] + conv[k] * red) % p
        return conv[:d]

    def _tables(self, device):
        """(the degree i + j of each coefficient product, the reduction's
        constants), made on ``device`` once: a host-to-device copy on the
        card waits for its stream."""
        key = (self, torch.device(device))
        t = _TABLES.get(key)
        if t is None:
            d = self.d
            ij = torch.arange(d * d, device=device)
            red = torch.zeros(d, dtype=DTYPE, device=device)
            for i, c in enumerate(self.reduction):
                if c % self.base.p:
                    red[i] = c % self.base.p
            t = _TABLES[key] = (ij // d + ij % d, red)
        return t

    def one_like(self, a):
        out = torch.zeros_like(a)
        out[0] = 1
        return out

    def inv(self, a):
        """Fermat in the extension: a^(p^d - 2)."""
        e = self.base.p**self.d - 2
        result = self.one_like(a)
        base = a
        while e > 0:
            if e & 1:
                result = self.mul(result, base)
            base = self.mul(base, base)
            e >>= 1
        return result

    def to_monty(self, coeffs, device="cuda") -> torch.Tensor:
        return self.base.to_monty(coeffs, device)

    def to_host(self, x) -> np.ndarray:
        return self.base.to_host(x)


# ---------------------------------------------------------------------------
# Goldilocks: p = 2^64 - 2^32 + 1, values as (lo, hi) 32-bit limbs.

GL_P = (1 << 64) - (1 << 32) + 1
_GL_EPS = M32  # 2^32 - 1 == 2^64 mod p


def _gl_canonical(lo, hi):
    """A value below 2^64 into [0, p): p itself is (2^32 - 1) << 32 | 1, so
    the value is at least p exactly when hi = 2^32 - 1 and lo >= 1, and
    then the value minus p is (0, lo - 1)."""
    ge = (hi == _GL_EPS) & (lo >= 1)
    return torch.stack([torch.where(ge, lo - 1, lo), torch.where(ge, 0, hi)])


def _add_eps(lo, hi, k):
    """(hi:lo) + k * (2^32 - 1) for k in {0, 1}, known to stay below 2^64."""
    lo = lo + k * _GL_EPS
    return lo & M32, hi + (lo >> 32)


def _sub_eps(lo, hi, k):
    """(hi:lo) - k * (2^32 - 1) for k in {0, 1}, known to stay at or above 0."""
    lo = lo - k * _GL_EPS
    borrow = (lo < 0).to(DTYPE)
    return lo + (borrow << 32), hi - borrow


class Goldilocks:
    """Batched Goldilocks arithmetic on (2, ...) int64 (lo, hi) limbs in
    canonical form (the special prime's reduction is cheap)."""

    p = GL_P

    @staticmethod
    def to_dev(vals, device="cuda") -> torch.Tensor:
        a = np.asarray(vals, dtype=np.uint64) % np.uint64(GL_P)
        limbs = np.stack([a & np.uint64(M32), a >> np.uint64(32)]).astype(np.int64)
        return torch.from_numpy(limbs).to(device)

    @staticmethod
    def to_host(x) -> np.ndarray:
        limbs = x.detach().cpu().numpy().astype(np.uint64)
        return limbs[0] | (limbs[1] << np.uint64(32))

    @staticmethod
    def add(a, b):
        lo = a[0] + b[0]
        hi = a[1] + b[1] + (lo >> 32)
        wrap = hi >> 32  # past 2^64: 2^64 = 2^32 - 1 mod p
        # a + b - 2^64 < 2p - 2^64, so adding 2^32 - 1 wraps no more
        lo, hi = _add_eps(lo & M32, hi & M32, wrap)
        return _gl_canonical(lo, hi)

    @staticmethod
    def sub(a, b):
        lo = a[0] - b[0]
        borrow = (lo < 0).to(DTYPE)
        hi = a[1] - b[1] - borrow
        under = (hi < 0).to(DTYPE)  # below 0: 2^64 added, 2^32 - 1 taken off
        lo, hi = _sub_eps(lo + (borrow << 32), hi + (under << 32), under)
        return _gl_canonical(lo, hi)

    @staticmethod
    def neg(a):
        return Goldilocks.sub(torch.zeros_like(a), a)

    @staticmethod
    def mul(a, b):
        """(a*b) mod p: the 128-bit product's limbs x0..x3, then (2^64 =
        2^32 - 1, 2^96 = -1 mod p) r = (x1:x0) - x3 + x2 * (2^32 - 1), each
        wrap fixed by one conditional +-(2^32 - 1) (the JAX module's
        reduction, its carries taken by shifts)."""
        h00, l00 = _mul_full(a[0], b[0])
        h01, l01 = _mul_full(a[0], b[1])
        h10, l10 = _mul_full(a[1], b[0])
        h11, l11 = _mul_full(a[1], b[1])
        s1 = h00 + l01 + l10
        s2 = h01 + h10 + l11 + (s1 >> 32)
        x0, x1, x2, x3 = l00, s1 & M32, s2 & M32, h11 + (s2 >> 32)
        # t0 = (x1:x0) - x3; below 0: 2^64 added, 2^32 - 1 taken off
        lo = x0 - x3
        borrow = (lo < 0).to(DTYPE)
        hi = x1 - borrow
        under = (hi < 0).to(DTYPE)
        lo, hi = _sub_eps(lo + (borrow << 32), hi + (under << 32), under)
        # t1 = x2 * (2^32 - 1) = (x2 << 32) - x2, below 2^64
        nz = (x2 != 0).to(DTYPE)
        t1_lo, t1_hi = ((1 << 32) - x2) * nz, x2 - nz
        # t0 + t1; past 2^64: add 2^32 - 1 (no second wrap)
        lo = lo + t1_lo
        hi = hi + t1_hi + (lo >> 32)
        wrap = hi >> 32
        lo, hi = _add_eps(lo & M32, hi & M32, wrap)
        return _gl_canonical(lo, hi)

    @staticmethod
    def one_like(a):
        out = torch.zeros_like(a)
        out[0] = 1
        return out

    @staticmethod
    def inv(a):
        e = GL_P - 2
        result = Goldilocks.one_like(a)
        base = a
        while e > 0:
            if e & 1:
                result = Goldilocks.mul(result, base)
            base = Goldilocks.mul(base, base)
            e >>= 1
        return result


class Goldilocks3:
    """GL cubic extension F_p[X]/(X^3 - X - 1): elements (3, 2, ...)
    (coeff-major over (lo, hi) limbs). X^3 = X + 1."""

    d = 3

    @staticmethod
    def add(a, b):
        return Goldilocks.add(a.movedim(1, 0), b.movedim(1, 0)).movedim(0, 1)

    @staticmethod
    def sub(a, b):
        return Goldilocks.sub(a.movedim(1, 0), b.movedim(1, 0)).movedim(0, 1)

    @staticmethod
    def mul(a, b):
        """The nine coefficient products in one batched product, then the
        convolution and X^4 = X^2 + X, X^3 = X + 1."""
        G = Goldilocks
        a, b = torch.broadcast_tensors(a, b)
        la = a.movedim(1, 0)[:, :, None]  # (2, 3, 1, ...)
        lb = b.movedim(1, 0)[:, None, :]  # (2, 1, 3, ...)
        prods = G.mul(*torch.broadcast_tensors(la, lb))  # (2, 3, 3, ...)
        t = lambda i, j: prods[:, i, j]  # noqa: E731
        conv = [
            t(0, 0),
            G.add(t(0, 1), t(1, 0)),
            G.add(G.add(t(0, 2), t(1, 1)), t(2, 0)),
            G.add(t(1, 2), t(2, 1)),
            t(2, 2),
        ]
        c0 = G.add(conv[0], conv[3])
        c1 = G.add(G.add(conv[1], conv[3]), conv[4])
        c2 = G.add(conv[2], conv[4])
        return torch.stack([c0, c1, c2])

    @staticmethod
    def inv(a):
        e = GL_P**3 - 2
        result = torch.zeros_like(a)
        result[0, 0] = 1
        base = a
        while e > 0:
            if e & 1:
                result = Goldilocks3.mul(result, base)
            base = Goldilocks3.mul(base, base)
            e >>= 1
        return result

    @staticmethod
    def to_dev(coeffs, device="cuda") -> torch.Tensor:
        return torch.stack([Goldilocks.to_dev(c, device) for c in np.asarray(coeffs, np.uint64)])

    @staticmethod
    def to_host(x) -> np.ndarray:
        return np.stack([Goldilocks.to_host(x[i]) for i in range(3)])


# ---------------------------------------------------------------------------
# The field zoo (moduli per the reference headers)

BABYBEAR_P = (1 << 31) - (1 << 27) + 1  # 0x78000001
KOALABEAR_P = (1 << 31) - (1 << 24) + 1  # 0x7f000001

babybear = Mont31(BABYBEAR_P)
koalabear = Mont31(KOALABEAR_P)

# BabyBear: x^5 = 2 (fp5.h:9), x^6 = 31 (fp6.h:4)
bb5 = ExtField(babybear, 5, (2, 0, 0, 0, 0))
bb6 = ExtField(babybear, 6, (31, 0, 0, 0, 0, 0))
# KoalaBear: x^5 = 1 - x^2 (kb5.h:4), x^6 = -(1 + x^3) (kb6.h:4)
kb5 = ExtField(koalabear, 5, (1, 0, -1, 0, 0))
kb6 = ExtField(koalabear, 6, (-1, 0, 0, -1, 0, 0))

FIELDS: Dict[str, object] = {
    "babybear": babybear,
    "koalabear": koalabear,
    "bb5": bb5,
    "bb6": bb6,
    "kb5": kb5,
    "kb6": kb6,
    "goldilocks": Goldilocks,
    "gl3": Goldilocks3,
}
