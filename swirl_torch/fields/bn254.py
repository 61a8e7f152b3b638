"""The BN254 scalar field on the port's devices, for the outer hash scheme.

Peer of ``swirl/fields/jbn254.py``. A field element is a trailing ``(8,)``
axis of ``torch.int32``: eight little-endian 32-bit words (bit patterns;
a word above 2^31 reads negative), 32 B an element. Field values are in
Montgomery form with ``R = 2^256``, the JAX package's radix, so a Monty
value means the same thing in the JAX package, the plain version here and
the kernel; digests leave the hash in canonical form. Every function
broadcasts over the leading axes, and the layout is the same on the CPU and
on the card.

On a CUDA tensor each function launches kernel G (``csrc/bn254.cu``: 8 x
32-bit words, CIOS Montgomery products, fully reduced after each
operation); on a CPU tensor it runs the plain version. The plain version
follows the JAX algorithm: word-serial Montgomery (CIOS) over 16-bit
limbs held in int64, since torch on the CPU lacks uint32 ``add``, ``>>``
and ``<``. int64 leaves room for every lazily carried limb of a product
(below 2^39), so the limbs carry once per step (the one carry the next
step's quotient needs) and exactly at the end, over 32-bit words.

Inside the plain version a value is in "word form": an int64 ``(..., 8)``
tensor of 32-bit words (:func:`words`, :func:`from_words`); the hash's
plain permutation stays in that form between operations.
"""

from __future__ import annotations

from fractions import Fraction

import numpy as np
import torch

from .. import kernels as K

# BN254 (alt_bn128) scalar field modulus
P = 21888242871839275222246405745257275088548364400416034343698204186575808495617

L = 8  # 32-bit words an element
WORD_BITS = 32
DTYPE = torch.int32
_WORD = (1 << WORD_BITS) - 1
_LIMB = 0xFFFF

_R_INT = (1 << (L * WORD_BITS)) % P
_R2_INT = _R_INT * _R_INT % P
_NP16_INT = (-pow(P, -1, 1 << 16)) % (1 << 16)


def limbs_from_int(v: int) -> np.ndarray:
    """Host int (< 2^256, not reduced: P itself round-trips) -> (8,) uint32
    little-endian words."""
    v = int(v)
    assert 0 <= v < (1 << (L * WORD_BITS))
    return np.array([(v >> (WORD_BITS * i)) & _WORD for i in range(L)], dtype=np.uint32)


def int_from_limbs(arr) -> int:
    a = np.asarray(arr).astype(np.uint32).reshape(-1)
    assert a.shape[0] == L
    return sum(int(a[i]) << (WORD_BITS * i) for i in range(L))


def const(v: int) -> np.ndarray:
    """Host int -> Monty-form (8,) word constant (reduced)."""
    return limbs_from_int((int(v) % P) * _R_INT % P)


P_LIMBS = limbs_from_int(P)
R2 = limbs_from_int(_R2_INT)
ONE_CANON = limbs_from_int(1)


def tensor(arr, device) -> torch.Tensor:
    """uint32 words (numpy, any shape ending in 8) -> an int32 tensor."""
    a = np.ascontiguousarray(np.asarray(arr, dtype=np.uint32))
    return torch.from_numpy(a.view(np.int32)).to(device)


def from_ints(values, device) -> torch.Tensor:
    """Host ints (< 2^256) -> an (n, 8) int32 tensor of their words."""
    return tensor(np.stack([limbs_from_int(v) for v in values]).reshape(-1, L), device)


def to_ints(t: torch.Tensor) -> list:
    """An (..., 8) int32 tensor -> host ints, in row-major order; one copy."""
    a = t.detach().reshape(-1, L).cpu().numpy().view(np.uint32).astype(object)
    shifts = np.array([1 << (WORD_BITS * i) for i in range(L)], dtype=object)
    return [int(v) for v in (a * shifts).sum(axis=1)]


# -- the plain version: word form (int64 32-bit words), 16-bit limb products --


def words(t: torch.Tensor) -> torch.Tensor:
    """int32 elements -> word form (int64 words in [0, 2^32))."""
    return t.to(torch.int64) & _WORD


def from_words(w: torch.Tensor) -> torch.Tensor:
    """Word form -> int32 elements (the words' bit patterns)."""
    return (w - ((w >> 31) << 32)).to(DTYPE)


_consts = {}


_SOURCES = {
    "p": [int(w) for w in P_LIMBS],
    "r2": [int(w) for w in R2],
    "one": [int(w) for w in ONE_CANON],
    "p16": [(P >> (16 * i)) & _LIMB for i in range(2 * L)],  # P in 16-bit limbs
}


def _wconst(name: str, device) -> torch.Tensor:
    """A constant in word form (or P's 16-bit limbs), made once per device."""
    key = (name, str(device))
    if key not in _consts:
        _consts[key] = torch.tensor(_SOURCES[name], dtype=torch.int64, device=device)
    return _consts[key]


def _carry(w: torch.Tensor) -> torch.Tensor:
    """Exact carry over the 8 words of a lazily summed word-form value (each
    word a signed int64 well inside int64; the value in [0, 2^256))."""
    out = []
    c = torch.zeros_like(w[..., 0])
    for i in range(L):
        s = w[..., i] + c
        out.append(s & _WORD)
        c = s >> WORD_BITS  # arithmetic: a negative word borrows
    return torch.stack(out, dim=-1)


def _cond_sub_p(w: torch.Tensor) -> torch.Tensor:
    """w - P where w >= P (w in [0, 2P), normalized words)."""
    p = _wconst("p", w.device)
    # the highest differing word decides: sum sign(w_i - p_i) * 2^i
    sign = torch.sign(w - p)
    ge = (sign * (1 << torch.arange(L, device=w.device))).sum(-1) >= 0
    return torch.where(ge[..., None], _carry(w - p), w)


def add_w(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _cond_sub_p(_carry(a + b))


def sub_w(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    # a - b + P lies in (0, 2P): one carry pass, one conditional subtract
    return _cond_sub_p(_carry(a - b + _wconst("p", a.device)))


def _limbs16(w: torch.Tensor) -> torch.Tensor:
    return torch.stack([w & _LIMB, w >> 16], dim=-1).reshape(w.shape[:-1] + (2 * L,))


def mont_mul_w(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Montgomery product a * b / 2^256 mod P in word form: word-serial CIOS
    over 16-bit limbs (word 2^16), as ``jbn254.mont_mul``.

    Step i adds a_i * b and m * P (m the quotient that clears limb i) into
    the limbs i .. i + 15 of a window, then carries limb i (now 0 mod
    2^16) into limb i + 1, so limb i + 1 is exact mod 2^16 for the next
    quotient. A limb takes at most 16 of each product (< 2^32) and the
    carries: below 2^39. The result, limbs 16 .. 31, is below 2P."""
    a, b = torch.broadcast_tensors(a, b)
    a16, b16 = _limbs16(a), _limbs16(b)
    p16 = _wconst("p16", a.device)
    t = torch.zeros(a.shape[:-1] + (4 * L,), dtype=torch.int64, device=a.device)
    for i in range(2 * L):
        win = t[..., i : i + 2 * L]
        win += a16[..., i : i + 1] * b16
        m = (t[..., i] * _NP16_INT) & _LIMB
        win += m[..., None] * p16
        t[..., i + 1] += t[..., i] >> 16
    hi = t[..., 2 * L :].reshape(a.shape[:-1] + (L, 2))
    return _cond_sub_p(_carry(hi[..., 0] + (hi[..., 1] << 16)))


def from_canonical_w(w: torch.Tensor) -> torch.Tensor:
    return mont_mul_w(w, _wconst("r2", w.device))


def to_canonical_w(w: torch.Tensor) -> torch.Tensor:
    return mont_mul_w(w, _wconst("one", w.device))


# -- the entry points: kernel G on the card, the plain version on the CPU --

_OPS = {"add": 0, "sub": 1, "mont_mul": 2, "from_canonical": 3, "to_canonical": 4, "dbl": 5}
_PLAIN = {
    "add": add_w,
    "sub": sub_w,
    "mont_mul": mont_mul_w,
    "from_canonical": lambda a, _: from_canonical_w(a),
    "to_canonical": lambda a, _: to_canonical_w(a),
    "dbl": lambda a, _: add_w(a, a),
}


def op_plain(op: str, a: torch.Tensor, b: torch.Tensor = None) -> torch.Tensor:
    return from_words(_PLAIN[op](words(a), None if b is None else words(b)))


def require_words(t: torch.Tensor, ndim, what: str) -> None:
    """Validate a kernel operand of BN254 elements: a contiguous int32 CUDA
    tensor of ``ndim`` dims whose rows are 8 words, 16-byte aligned (the
    kernels move a row as two 16-byte vectors)."""
    K.require(t, ndim, what, dtype=DTYPE)
    if t.shape[-1] != L or t.data_ptr() % 16:
        raise K.KernelError(f"{what}: expected 16-byte aligned rows of {L} words, got {tuple(t.shape)}")


def _op(op: str, a: torch.Tensor, b: torch.Tensor = None) -> torch.Tensor:
    if not a.is_cuda:
        return op_plain(op, a, b)
    a, b = torch.broadcast_tensors(a, a if b is None else b)
    if a.shape[-1] != L:
        raise K.KernelError(f"bn254.{op}: the last axis of {tuple(a.shape)} is not {L} words")
    a2, b2 = a.contiguous().reshape(-1, L), b.contiguous().reshape(-1, L)
    require_words(a2, 2, f"bn254.{op} (a)")
    require_words(b2, 2, f"bn254.{op} (b)")
    out = torch.empty_like(a2)
    K.LIB.launch(K.BN254_FIELD, "swirl_bn254_op", a2, _OPS[op], a2.data_ptr(), b2.data_ptr(), out.data_ptr(),
                 a2.shape[0])
    return out.reshape(a.shape)


def add(a, b):
    return _op("add", a, b)


def sub(a, b):
    return _op("sub", a, b)


def mont_mul(a, b):
    """Montgomery product over the trailing word axis."""
    return _op("mont_mul", a, b)


def from_canonical(t):
    """Canonical words -> Monty form."""
    return _op("from_canonical", t)


def to_canonical(a):
    """Monty form -> canonical words (a product by canonical 1)."""
    return _op("to_canonical", a)


def dbl(a):
    return _op("dbl", a)


# -- the card's arithmetic, modelled step by step ------------------------------
#
# Kernels G-J (csrc/bn254.cuh) multiply on the FP64 pipe: an element is 5
# limbs of radix 2^52 (R' = 2^260 inside the kernels), each limb of a
# product's operand an exact double below 2^52. A partial product a * b (a,
# b < 2^52) takes three double operations (Emmart, Zheng and Weems, ARITH
# 2018):
#
#     hi = fma_rz(a, b, 2^104)             2^104 + H 2^52, H = a b >> 52
#     lo = fma_rz(a, b, (2^104 + 2^52) - hi)   2^52 + L, L = a b mod 2^52
#
# and the bit patterns of lo and hi, read as integers, are L and H plus a
# constant (the exponent's bits), which the 64-bit integer column sums
# take off at once by starting from minus their total (f64_offset). The
# functions below repeat every operation of the kernels on Python ints,
# the double operations rounded as the card rounds them, and assert every
# bound the kernels rely on.

F64_LIMBS, F64_RADIX = 5, 52
F64_MASK = (1 << F64_RADIX) - 1
F64_R = 1 << (F64_LIMBS * F64_RADIX)
F64_NP = (-pow(P, -1, 1 << F64_RADIX)) % (1 << F64_RADIX)  # -P^-1 mod 2^52
F64_LO_BITS, F64_HI_BITS = (1023 + 52) << 52, (1023 + 104) << 52  # 2^52, 2^104 as doubles
_U64 = (1 << 64) - 1
_C1, _C2 = 1 << 104, (1 << 104) + (1 << 52)
# the quotient estimate of f64_reduce: q = floor((top >> 5) * INV), INV = 32 /
# (P >> 208 + 1) rounded toward zero to a double
F64_P4 = P >> 208


def f64_limbs(v: int) -> list:
    """An int below 2^260 -> its 5 limbs of radix 2^52."""
    assert 0 <= v < F64_R
    return [(v >> (F64_RADIX * k)) & F64_MASK for k in range(F64_LIMBS)]


def f64_value(x) -> int:
    """The value of 5 limbs (normalized or not)."""
    return sum(int(v) << (F64_RADIX * k) for k, v in enumerate(x))


def _rz53(x):
    """x (an int or a Fraction) rounded toward zero to 53 significant bits:
    what the card's rz operations return for that exact result."""
    if x == 0:
        return 0
    sign, x = (1, x) if x > 0 else (-1, -x)
    x = Fraction(x)
    e = x.numerator.bit_length() - x.denominator.bit_length()
    if Fraction(2) ** e > x:
        e -= 1
    ulp = Fraction(2) ** (e - 52)
    r = (x // ulp) * ulp
    return sign * (int(r) if r.denominator == 1 else r)


F64_INV = _rz53(Fraction(32, F64_P4 + 1))


def _exact(x):
    assert _rz53(x) == x, f"{x} is not a double"
    return x


def f64_bits(x: int) -> int:
    """The bit pattern of a positive double of integer value x."""
    x = _exact(x)
    assert x > 0
    e = x.bit_length() - 1
    mant = (x >> (e - 52)) if e >= 52 else (x << (52 - e))
    return ((e + 1023) << 52) | (mant & F64_MASK)


def f64_fma_rz(a, b, c):
    return _rz53(a * b + c)


def f64_double(x: int) -> int:
    """A limb (below 2^52) as the double the kernels make of it: its bits
    with 2^52's exponent, minus 2^52 (exact)."""
    assert 0 <= x <= F64_MASK, f"limb {x} is not below 2^52"
    return _exact((x | F64_LO_BITS) - F64_LO_BITS)


def _split(a: int, b: int):
    """(bits of lo, L, bits of hi, H) of the three double operations on a * b."""
    assert 0 <= a <= F64_MASK and 0 <= b <= F64_MASK
    hi = f64_fma_rz(a, b, _C1)
    s = _exact(_C2 - hi)  # the subtract is exact
    lo = f64_fma_rz(a, b, s)
    assert lo == a * b + s, "the low half is not exact"
    h, l = divmod(a * b, 1 << F64_RADIX)
    lo_bits, hi_bits = f64_bits(lo), f64_bits(hi)
    assert lo_bits == F64_LO_BITS + l and hi_bits == F64_HI_BITS + h
    return lo_bits, l, hi_bits, h


def _pairs(k: int) -> int:
    """Products a_i b_j (i, j < 5) whose low half lands in column k = i + j."""
    return k + 1 if 0 <= k < 5 else (9 - k if 5 <= k <= 8 else 0)


def _red_lo(k: int) -> int:
    """Low halves of the quotient products m_s P_t (t >= 1) in column s + t."""
    return sum(1 for s in range(F64_LIMBS) for t in range(1, F64_LIMBS) if s + t == k)


def f64_offset(k: int, ab: bool) -> int:
    """Column k's starting value, mod 2^64: minus the exponent bits of every
    low (2^52's) and high (2^104's) half it will take: a * b's (``ab``) and
    the quotients' m_s P_t (low halves for t >= 1 at s + t, high halves at
    s + t + 1). A square adds the same counts (its cross products twice)."""
    lo = (_pairs(k) if ab else 0) + _red_lo(k)
    hi = (_pairs(k - 1) if ab else 0) + _pairs(k - 1)
    return (-(lo * F64_LO_BITS + hi * F64_HI_BITS)) & _U64


class _Columns:
    """The kernels' 10 uint64 column sums: the bits they add (mod 2^64) beside
    the values those stand for; a read asserts the two agree."""

    def __init__(self, ab: bool):
        self.raw = [f64_offset(k, ab) for k in range(2 * F64_LIMBS)]
        self.val = [0] * (2 * F64_LIMBS)

    def add(self, k: int, bits: int, value: int, times: int = 1) -> None:
        self.raw[k] = (self.raw[k] + times * bits) & _U64
        self.val[k] += times * value

    def read(self, k: int) -> int:
        assert self.raw[k] == self.val[k] < (1 << 64), f"column {k}: {self.raw[k]} against {self.val[k]}"
        return self.raw[k]


def _redc_columns(c: _Columns) -> list:
    """The 5 quotient steps and the final carries of every product: step s
    clears column s with m = (c_s mod 2^52) (-P^-1) mod 2^52 (an integer
    product) and carries ceil(c_s / 2^52) into column s + 1 (c_s + m P_0's
    low half is that multiple of 2^52, so that half is never made); returns
    columns 5-9, normalized (value < 2^260)."""
    p = f64_limbs(P)
    for s in range(F64_LIMBS):
        cs = c.read(s)
        m = ((cs & F64_MASK) * F64_NP) & _U64 & F64_MASK
        md = f64_double(m)
        h0 = f64_fma_rz(md, p[0], _C1)
        h = (m * p[0]) >> F64_RADIX
        assert f64_bits(h0) == F64_HI_BITS + h
        c.add(s + 1, f64_bits(h0), h)
        assert (cs + (m * p[0])) & F64_MASK == 0
        carry = ((cs + F64_MASK) & _U64) >> F64_RADIX
        assert carry == (cs + ((m * p[0]) & F64_MASK)) >> F64_RADIX
        c.add(s + 1, carry, carry)
        for t in range(1, F64_LIMBS):
            lo_bits, l, hi_bits, hh = _split(md, p[t])
            c.add(s + t, lo_bits, l)
            c.add(s + t + 1, hi_bits, hh)
    out = [c.read(k) for k in range(F64_LIMBS, 2 * F64_LIMBS)]
    return f64_norm(out)


def f64_mont(a: list, b: list, square: bool = False) -> list:
    """The kernels' product a b / 2^260 (mod P, below a b / 2^260 + P) of
    normalized limbs (``square``: b is a, 15 partial products, the cross
    ones added twice); normalized limbs out."""
    a = [f64_double(v) for v in a]
    b = a if square else [f64_double(v) for v in b]
    c = _Columns(ab=True)
    for i in range(F64_LIMBS):
        for j in range(i if square else 0, F64_LIMBS):
            lo_bits, l, hi_bits, h = _split(a[i], b[j])
            times = 2 if square and i != j else 1
            c.add(i + j, lo_bits, l, times)
            c.add(i + j + 1, hi_bits, h, times)
    return _redc_columns(c)


def f64_redc(x: list) -> list:
    """x / 2^260 (mod P, below x / 2^260 + P): the quotient steps alone, on
    x's limbs (below 2^57 each) in columns 0-4."""
    c = _Columns(ab=False)
    for k, v in enumerate(x):
        c.raw[k] = (c.raw[k] + v) & _U64
        c.val[k] += v
    return _redc_columns(c)


def f64_add(*xs) -> list:
    """Limb by limb, no carry (each limb stays far below 2^64)."""
    out = [sum(v) for v in zip(*xs)]
    assert max(out) < 1 << 57
    return out


def f64_norm(x: list) -> list:
    """The carries of limbs below 2^64: limbs below 2^52, value below 2^260."""
    x = list(x)
    for k in range(F64_LIMBS - 1):
        x[k + 1] += x[k] >> F64_RADIX
        x[k] &= F64_MASK
        assert x[k + 1] < 1 << 64
    assert x[-1] <= F64_MASK, f"value {f64_value(x)} is not below 2^260"
    return x


def f64_reduce(x: list) -> list:
    """A value below 3P with the value of x mod P, x's limbs below 2^56: q =
    floor(top / (P_4 + 1)) from top = x_4 + (x_3 >> 52) (below x / 2^208, so
    q P <= x) by one fma on the FP64 pipe, then x - q P limb by limb and
    signed carries."""
    assert max(x) < 1 << 56
    top = x[4] + (x[3] >> F64_RADIX)
    td = f64_double(top >> 5)
    qd = f64_fma_rz(td, F64_INV, Fraction(1 << 52))
    assert (1 << 52) <= qd < (1 << 53)
    q = f64_bits(int(qd)) - F64_LO_BITS
    assert q == int(Fraction(td) * F64_INV) and q * P <= f64_value(x)
    p = f64_limbs(P)
    y = [v - q * pk for v, pk in zip(x, p)]
    assert all(q * pk < 1 << 63 for pk in p)
    for k in range(F64_LIMBS - 1):
        y[k + 1] += y[k] >> F64_RADIX  # arithmetic: a negative limb borrows
        y[k] &= F64_MASK
    assert 0 <= y[4] <= F64_MASK and f64_value(y) < 3 * P
    return y


def f64_canon(x: list) -> int:
    """The canonical value of normalized limbs below 2P: x - P where that is
    not negative (signed carries), else x."""
    assert f64_value(x) < 2 * P and max(x) <= F64_MASK
    d = [v - pk for v, pk in zip(x, f64_limbs(P))]
    for k in range(F64_LIMBS - 1):
        d[k + 1] += d[k] >> F64_RADIX
        d[k] &= F64_MASK
    return f64_value(x if d[4] < 0 else d)


# R'-form constants (R' = 2^260): a product by K_e takes x to x 2^(e - 260)
F64_K = {e: pow(2, e, P) for e in (256, 264, 516, 520)}


def f64_mont_mul_model(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Kernel G's ``mont_mul`` (R = 2^256) on (..., 8) int32 operands, by the
    model: a b / 2^256 = mont'(a, 16 b) (16 b below 2^260), then one
    conditional subtract. Operands below P, or P itself."""
    a, b = torch.broadcast_tensors(a, b)
    out = [f64_canon(f64_mont(f64_limbs(x), f64_limbs(16 * y)))
           for x, y in zip(to_ints(a), to_ints(b))]
    return from_ints(out, a.device).reshape(a.shape)
