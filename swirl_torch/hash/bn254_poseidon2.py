"""Poseidon2 permutations over the BN254 scalar field (widths 2 and 3).

The reference workspace ships a second hash scheme for *outer* recursion
proofs: Merkle/transcript hashing over the BN254 scalar field so the final
STARK can be wrapped in a BN254 SNARK cheaply (reference:
``crates/stark-sdk/src/config/bn254_poseidon2/*`` widths 2/3,
``crates/stark-sdk/src/config/baby_bear_bn254_poseidon2.rs``,
``cuda-backend/cuda/src/bn254_*.cu``). This module is the port's copy of
``swirl/hash/bn254_poseidon2.py``.

Instances (reference parity):

- **width 2** (Merkle 2-to-1 compression): t=2, rF=6, rP=50, S-box x^5,
  internal diag d=(1,2); round constants are the vendored gnark-crypto
  Keccak-chain table (:mod:`swirl_torch.hash.bn254_constants`, from
  ``bn254_poseidon2/width2_constants.rs`` RC2).
- **width 3** (leaf hash / transcript sponge): t=3, rF=8, rP=56, S-box x^5,
  internal diag d=(1,1,2); round constants are the frozen zkhash ``RC3``
  instance (:mod:`swirl_torch.hash.bn254_rc3` — leading entries cross-checked
  against the published HorizenLabs table, and
  ``tests/test_multi_field.py`` asserts the Grain-LFSR generator
  reproduces the frozen table bit-exactly; see
  ``bn254_poseidon2/width3.rs:1-8`` for the reference's sourcing).

BN254 scalars are 254-bit; this hashing tier is host-side by design (outer proofs are tiny — the reference likewise
keeps BN254 hashing out of the throughput path and only accelerates it for
grinding). Values are Python ints.

Structure (Poseidon2 paper, t <= 3): external linear layer M_E = J + I
(t=2 -> [[2,1],[1,2]]; t=3 -> [[2,1,1],[1,2,1],[1,1,2]]); internal layer
M_I = J + diag(d).
"""

from __future__ import annotations

from functools import lru_cache
from typing import List, Sequence, Tuple

from .bn254_constants import RC2
from .grain import poseidon2_round_constants

# BN254 (alt_bn128) scalar field modulus
P_BN254 = (
    21888242871839275222246405745257275088548364400416034343698204186575808495617
)
N_BITS = 254

# (full_rounds, partial_rounds, internal diag) per width — reference
# `bn254_poseidon2/width2.rs:29-32` and `width3.rs:22-24`.
_PARAMS = {2: (6, 50, (1, 2)), 3: (8, 56, (1, 1, 2))}


@lru_cache(maxsize=None)
def constants(t: int) -> Tuple[tuple, tuple, tuple]:
    """(external_initial, internal, external_final) for width t in {2, 3}."""
    assert t in (2, 3)
    r_f, r_p, _ = _PARAMS[t]
    if t == 2:
        # Vendored flat table: split as in `split_flat_round_constants`
        # (`bn254_poseidon2/common.rs:54-79`).
        half = r_f // 2
        ext_i = [RC2[r * t : (r + 1) * t] for r in range(half)]
        internal = RC2[half * t : half * t + r_p]
        flat_f = RC2[half * t + r_p :]
        ext_f = [flat_f[r * t : (r + 1) * t] for r in range(half)]
    else:
        # Frozen vendored table (see bn254_rc3.py header for provenance);
        # the Grain generator's agreement with it is a test invariant.
        from .bn254_rc3 import (
            RC3_EXTERNAL_FINAL,
            RC3_EXTERNAL_INITIAL,
            RC3_INTERNAL,
        )

        ext_i = [list(r) for r in RC3_EXTERNAL_INITIAL]
        internal = list(RC3_INTERNAL)
        ext_f = [list(r) for r in RC3_EXTERNAL_FINAL]
    return (
        tuple(tuple(r) for r in ext_i),
        tuple(internal),
        tuple(tuple(r) for r in ext_f),
    )


def _sbox(x: int) -> int:
    x2 = x * x % P_BN254
    x4 = x2 * x2 % P_BN254
    return x4 * x % P_BN254


def _external(s: List[int]) -> List[int]:
    total = sum(s) % P_BN254
    return [(total + x) % P_BN254 for x in s]


def _internal(s: List[int], t: int) -> List[int]:
    d = _PARAMS[t][2]
    total = sum(s) % P_BN254
    return [(total + d[i] * s[i]) % P_BN254 for i in range(t)]


def permute(state: Sequence[int], t: int) -> List[int]:
    """Poseidon2 permutation on a length-t list of BN254 scalars."""
    assert len(state) == t
    ext_i, internal, ext_f = constants(t)
    s = _external(list(state))
    for rc in ext_i:
        s = _external([_sbox((x + c) % P_BN254) for x, c in zip(s, rc)])
    for c in internal:
        s[0] = _sbox((s[0] + c) % P_BN254)
        s = _internal(s, t)
    for rc in ext_f:
        s = _external([_sbox((x + c) % P_BN254) for x, c in zip(s, rc)])
    return s


def compress2(a: int, b: int) -> int:
    """2-to-1 Merkle compression via the width-2 permutation.

    Reference `baby_bear_bn254_poseidon2.rs:59`: `TruncatedPermutation<
    Poseidon2Bn254Width2, 2, 1, 2>` — permute [a, b], keep lane 0.
    """
    return permute([a, b], 2)[0]


def hash_scalars(vals: Sequence[int]) -> int:
    """Sponge hash of BN254 scalars: width 3, rate 2, capacity 1."""
    s = [0, 0, 0]
    buf = list(vals)
    for i in range(0, len(buf), 2):
        chunk = buf[i : i + 2]
        for j, v in enumerate(chunk):
            s[j] = v % P_BN254  # overwrite mode
        s = permute(s, 3)
    if not buf:
        s = permute(s, 3)
    return s[0]
