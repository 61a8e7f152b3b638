"""Poseidon2-BabyBear-16 on the host: the numpy half of
``swirl_torch/hash/poseidon2.py`` (Plonky3's ``Poseidon2BabyBear<16>``:
initial M_E, 4 full rounds, 13 partial rounds, 4 full rounds; round
constants from :mod:`.constants`), frozen with the rest of this package.

The program's copy hands its permutations to a C++ library when one is
built; this copy runs numpy only (the program's fallback), and the
verifier here hashes a round's opened leaves and Merkle paths as batches
(``verifier/whir.py``).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

from ..fields.babybear import P, U64
from . import constants as _rc

WIDTH = 16
RATE = 8
DIGEST = 8
FULL_ROUNDS = 8
PARTIAL_ROUNDS = 13
N_BITS = 31


# Internal-layer diagonal d_i (canonical values). This is the
# shift-friendly diagonal family used by Plonky3 for BabyBear width 16:
# [-2, 1, 2, 1/2, 3, 4, -1/2, -3, -4, 1/2^8, 1/4, 1/8, 1/2^27, -1/2^8, -1/16, -1/2^27]
_inv = lambda x: pow(x, P - 2, P)
INTERNAL_DIAG = [
    P - 2,
    1,
    2,
    _inv(2),
    3,
    4,
    P - _inv(2),
    P - 3,
    P - 4,
    _inv(1 << 8),
    _inv(4),
    _inv(8),
    _inv(1 << 27),
    P - _inv(1 << 8),
    P - _inv(16),
    P - _inv(1 << 27),
]


@lru_cache(maxsize=None)
def constants():
    """Round-constant tables (canonical uint64): the vendored reference-parity
    HorizenLabs/Plonky3 RC16 instance (see :mod:`.constants`)."""
    return (
        np.array(_rc.EXTERNAL_INITIAL, dtype=np.uint64),
        np.array(_rc.INTERNAL, dtype=np.uint64),
        np.array(_rc.EXTERNAL_FINAL, dtype=np.uint64),
        np.array(INTERNAL_DIAG, dtype=np.uint64),
    )


# ---------------------------------------------------------------------------
# Host (numpy) implementation. State: uint64 array (..., 16), canonical.
# ---------------------------------------------------------------------------

_P = U64(P)


def _sbox_np(x):
    x2 = (x * x) % _P
    x4 = (x2 * x2) % _P
    x6 = (x4 * x2) % _P
    return (x6 * x) % _P


def _m4_np(s):
    """Apply M4 = circ-style [[2,3,1,1],[1,2,3,1],[1,1,2,3],[3,1,1,2]] to
    (..., 4) lanes using the cheap add-chain."""
    x0, x1, x2, x3 = (s[..., i] for i in range(4))
    t01 = (x0 + x1) % _P
    t23 = (x2 + x3) % _P
    t0123 = (t01 + t23) % _P
    t01123 = (t0123 + x1) % _P
    t01233 = (t0123 + x3) % _P
    out0 = (t01123 + t01) % _P
    out1 = (t01123 + 2 * x2) % _P
    out2 = (t01233 + t23) % _P
    out3 = (t01233 + 2 * x0) % _P
    return np.stack([out0, out1, out2, out3], axis=-1)


def _external_np(s):
    s4 = s.reshape(s.shape[:-1] + (4, 4))
    s4 = _m4_np(s4)
    sums = s4.sum(axis=-2, dtype=np.uint64) % _P  # (..., 4)
    s4 = (s4 + sums[..., None, :]) % _P
    return s4.reshape(s.shape)


def _internal_np(s, diag):
    total = s.sum(axis=-1, dtype=np.uint64) % _P
    return (s * diag + total[..., None]) % _P


def permute_np(state: np.ndarray) -> np.ndarray:
    """Poseidon2 permutation on (..., 16) canonical uint64 arrays.

    """
    return _permute_np_py(state)


def _permute_np_py(state: np.ndarray) -> np.ndarray:
    ext_init, internal, ext_final, diag = constants()
    s = np.asarray(state, dtype=np.uint64) % _P
    s = _external_np(s)
    for rc in ext_init:
        s = _sbox_np((s + rc) % _P)
        s = _external_np(s)
    for rc in internal:
        s0 = _sbox_np((s[..., 0] + rc) % _P)
        s = s.copy()
        s[..., 0] = s0
        s = _internal_np(s, diag)
    for rc in ext_final:
        s = _sbox_np((s + rc) % _P)
        s = _external_np(s)
    return s


# ---------------------------------------------------------------------------
# Host hashing helpers (numpy, canonical). Used by verifier/keygen/transcript.
# ---------------------------------------------------------------------------


def hash_slice_np(vals) -> np.ndarray:
    """Padding-free sponge, rate 8, digest = first 8 lanes of final state.

    Mirrors Plonky3 PaddingFreeSponge semantics: overwrite state[:len(chunk)]
    per RATE-sized chunk (last chunk may be partial), permute after each.
    """
    vals = np.asarray(vals, dtype=np.uint64).ravel() % _P
    state = np.zeros(WIDTH, dtype=np.uint64)
    for i in range(0, len(vals), RATE):
        chunk = vals[i : i + RATE]
        state[: len(chunk)] = chunk
        state = permute_np(state)
    return state[:DIGEST]


def hash_rows_np(mat: np.ndarray) -> np.ndarray:
    """Batched hash_slice over rows of a 2D (n, w) canonical array -> (n, 8)."""
    mat = np.asarray(mat, dtype=np.uint64) % _P
    n, w = mat.shape
    state = np.zeros((n, WIDTH), dtype=np.uint64)
    if w == 0:
        # p3 PaddingFreeSponge on empty input: no permutation, zero digest.
        return state[:, :DIGEST]
    for i in range(0, w, RATE):
        chunk = mat[:, i : i + RATE]
        state[:, : chunk.shape[1]] = chunk
        state = permute_np(state)
    return state[:, :DIGEST]


def compress_np(left: np.ndarray, right: np.ndarray) -> np.ndarray:
    """2-to-1 truncated-permutation compression on (..., 8) digests."""
    state = np.concatenate([np.asarray(left, dtype=np.uint64), np.asarray(right, dtype=np.uint64)], axis=-1)
    return permute_np(state)[..., :DIGEST]

