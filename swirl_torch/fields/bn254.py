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
