"""Engine-level hash-scheme selection: inner (BabyBear Poseidon2-16) vs
outer (BN254 Poseidon2, multi-field). The port's copy of
``swirl/hash/scheme.py``.

Peer of the reference's ``cuda-backend/src/hash_scheme.rs`` +
``stark-sdk/src/config/baby_bear_bn254_poseidon2.rs:44-63``: the STARK
protocol is generic over the Fiat-Shamir/commitment hash; the outer
recursion layer swaps BabyBear Poseidon2 digests ``[F; 8]`` for a single
BN254 scalar so the final proof is cheap to verify inside a BN254 SNARK
circuit. Trace/constraint arithmetic stays BabyBear/EF4 in BOTH schemes —
only hashing, the transcript, and digest types change.

A scheme bundles:

- ``new_transcript()`` — the duplex-sponge Fiat-Shamir transcript;
- ``hash_slice`` / ``compress`` / ``digest_eq`` — verifier-side Merkle ops;
- ``check_digest`` — proof-shape validation of a digest value;
- ``pre_hash`` — the vk pre-hash over versioned postcard bytes;
- ``tree_builder()`` — ``None`` for the inner scheme (the prover keeps its
  Poseidon2 kernels' Merkle trees), or a host builder ``(matrix,
  rows_per_query, ext) -> (root, tree)`` whose tree answers the query-proof
  API of :class:`swirl_torch.prover.merkle.MerkleTree`.

Outer Merkle hashing and the outer transcript (its grinds included) run on
the HOST by design: outer proofs commit one tiny recursion trace, and BN254
host arithmetic keeps the scheme dependency-free. The trace, constraint and
WHIR arithmetic stays on the prover's device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from ..fields.babybear import P
from ..verifier.errors import ElementShapeMismatch, NonCanonicalElement


@dataclass
class HostMerkleTree:
    """Host-side Merkle digest layers, layout-identical to the device
    :class:`swirl_torch.prover.merkle.MerkleTree` (strided first-k pairing
    so one query opens ``rows_per_query`` coset-aligned rows with one
    path)."""

    layers: List[list]  # layers[0] has num_leaves/rows_per_query digests
    rows_per_query: int

    @property
    def root(self):
        return self.layers[-1][0]

    @property
    def query_stride(self) -> int:
        return len(self.layers[0])

    def batch_query_proofs(self, indices) -> List[list]:
        """proofs[qi][level] = sibling digest, identical ordering to the
        device tree's ``batch_query_proofs``."""
        out = []
        for index in indices:
            cur = int(index)
            if not (0 <= cur < self.query_stride):
                raise ValueError("HostMerkleTree: query index out of bounds")
            path = []
            for layer in self.layers[:-1]:
                path.append(layer[cur ^ 1])
                cur >>= 1
            out.append(path)
        return out

    def batch_query_proofs_arr(self, indices) -> List[list]:
        """The device tree's entry point: ``indices`` an (nq,) tensor (read
        to the host once) or a sequence; the same paths as
        :meth:`batch_query_proofs`, query-major, then level."""
        if isinstance(indices, torch.Tensor):
            indices = indices.cpu().tolist()
        return self.batch_query_proofs(indices)

    def query_proof(self, index: int) -> list:
        return self.batch_query_proofs([index])[0]


def build_host_tree(
    matrix: np.ndarray,
    rows_per_query: int,
    ext: bool,
    hash_slice: Callable,
    compress: Callable,
) -> HostMerkleTree:
    """Build the digest-layer stack for a canonical-u64 host matrix
    ``(width, height[, 4])`` with pluggable hash/compress (same leaf layout
    and strided pairing as the device ``build_merkle_tree``)."""
    if ext:
        w, h, d = matrix.shape
        cols = np.transpose(matrix, (0, 2, 1)).reshape(w * d, h)
    else:
        cols = matrix
        h = int(matrix.shape[1])
    if h <= 0 or h & (h - 1) != 0:
        raise ValueError("HostMerkleTree: height must be a positive power of two")
    if rows_per_query & (rows_per_query - 1) != 0 or rows_per_query > h:
        raise ValueError("HostMerkleTree: bad rows_per_query")

    digests = [hash_slice(cols[:, i]) for i in range(h)]
    query_stride = h // rows_per_query
    n = h
    cur = digests
    while n > query_stride:
        half = n // 2
        nxt = []
        # strided pairing: position (x, s) pairs groups 2x and 2x+1
        for x in range(half // query_stride):
            for s in range(query_stride):
                nxt.append(
                    compress(
                        cur[(2 * x) * query_stride + s],
                        cur[(2 * x + 1) * query_stride + s],
                    )
                )
        cur = nxt
        n = half
    layers = [cur]
    while len(cur) > 1:
        cur = [compress(cur[2 * i], cur[2 * i + 1]) for i in range(len(cur) // 2)]
        layers.append(cur)
    return HostMerkleTree(layers=layers, rows_per_query=rows_per_query)


class InnerPoseidon2Scheme:
    """BabyBear Poseidon2-16: the production scheme. Digests are ``(8,)``
    canonical-u64 arrays; the prover commits on its device (the Poseidon2
    kernels), so ``tree_builder()`` is None."""

    name = "babybear-poseidon2"
    digest_is_scalar = False

    def new_transcript(self, record: bool = False):
        from ..transcript import Transcript

        return Transcript(record=record)

    @staticmethod
    def hash_slice(vals):
        from .poseidon2 import hash_slice_np

        return hash_slice_np(np.asarray(vals, dtype=np.uint64).ravel())

    @staticmethod
    def compress(a, b):
        from .poseidon2 import compress_np

        return compress_np(a, b)

    @staticmethod
    def digest_eq(a, b) -> bool:
        from ..fields.babybear import U64

        return np.array_equal(
            np.asarray(a) % U64(P), np.asarray(b) % U64(P)
        )

    @staticmethod
    def check_digest(v, context: str):
        if getattr(v, "shape", None) != (8,):
            raise ElementShapeMismatch(
                context=context, expected=(8,), actual=getattr(v, "shape", None)
            )
        if getattr(v, "dtype", None) != np.uint64 or not bool(
            (np.asarray(v) < P).all()
        ):
            raise NonCanonicalElement(context=context)

    def pre_hash(self, byte_elems: np.ndarray):
        return self.hash_slice(byte_elems)

    def tree_builder(self) -> Optional[Callable]:
        return None


class Bn254OuterScheme:
    """BabyBear data, BN254 Poseidon2 hashing: the outer-recursion scheme
    (reference ``BabyBearBn254Poseidon2Config``). Digests are single BN254
    scalars (Python ints)."""

    name = "bn254-outer"
    digest_is_scalar = True

    def new_transcript(self, record: bool = False):
        from .multi_field import MultiFieldTranscript

        return MultiFieldTranscript(record=record)

    @staticmethod
    def hash_slice(vals) -> int:
        from .multi_field import MultiFieldHasher

        return MultiFieldHasher.hash_slice(vals)

    @staticmethod
    def compress(a: int, b: int) -> int:
        from .multi_field import MultiFieldHasher

        return MultiFieldHasher.compress(int(a), int(b))

    @staticmethod
    def digest_eq(a, b) -> bool:
        from .bn254_poseidon2 import P_BN254

        return int(a) % P_BN254 == int(b) % P_BN254

    @staticmethod
    def check_digest(v, context: str):
        from .bn254_poseidon2 import P_BN254

        if not isinstance(v, (int, np.integer)):
            raise ElementShapeMismatch(
                context=context, expected="BN254 scalar", actual=type(v).__name__
            )
        if not (0 <= int(v) < P_BN254):
            raise NonCanonicalElement(context=context)

    def pre_hash(self, byte_elems: np.ndarray) -> int:
        return self.hash_slice(byte_elems)

    def tree_builder(self) -> Callable:
        from ..fields import field as F

        def build(matrix, rows_per_query: int, ext: bool):
            """A (width, height[, 4]) tensor on any device, read to the host
            once; the tree is built there."""
            host = F.to_host(matrix)
            tree = build_host_tree(
                host, rows_per_query, ext, self.hash_slice, self.compress
            )
            return tree.root, tree

        return build


_SCHEMES = {
    InnerPoseidon2Scheme.name: InnerPoseidon2Scheme(),
    "babybear": InnerPoseidon2Scheme(),
    Bn254OuterScheme.name: Bn254OuterScheme(),
    "bn254": Bn254OuterScheme(),
}


def get_scheme(name_or_scheme=None):
    """Resolve a scheme by name (default inner); passes scheme objects
    through."""
    if name_or_scheme is None:
        return _SCHEMES[InnerPoseidon2Scheme.name]
    if isinstance(name_or_scheme, str):
        try:
            return _SCHEMES[name_or_scheme]
        except KeyError:
            raise ValueError(
                f"unknown hash scheme {name_or_scheme!r}; "
                f"one of {sorted(set(_SCHEMES))}"
            )
    return name_or_scheme
