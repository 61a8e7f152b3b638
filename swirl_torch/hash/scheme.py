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

- ``new_transcript(record, device)`` — the duplex-sponge Fiat-Shamir
  transcript (``device``: where the outer transcript grinds);
- ``hash_slice`` / ``compress`` / ``digest_eq`` — verifier-side Merkle ops;
- ``check_digest`` — proof-shape validation of a digest value;
- ``pre_hash`` — the vk pre-hash over versioned postcard bytes;
- ``tree_builder()`` — ``None`` for the inner scheme (the prover keeps its
  Poseidon2 kernels' Merkle trees), or a builder ``(matrix, rows_per_query,
  ext) -> (root, tree)`` whose tree answers the query-proof API of
  :class:`swirl_torch.prover.merkle.MerkleTree`.

The outer scheme builds its trees where the matrix lives
(:class:`DeviceBn254Tree`): on the card its leaf hashes and Merkle layers
are kernels I and H (``csrc/bn254.cu``) and the digest layers stay there;
on the CPU the same code runs their plain versions. The prover's
transcript grinds on kernel J on the card (``new_transcript(device=...)``);
its sponge, and the verifier's hashing and transcript, stay on host ints
(:func:`build_host_tree` and :class:`HostMerkleTree` are the reference the
tests hold the device tree to). The reference's outer tier hashes on the
card too (``bn254_poseidon2.cu``, ``bn254_merkle.cu``, ``bn254_grind.cu``):
at the root tier a commit hashes 2^25 leaves.
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


class DeviceBn254Tree:
    """The outer scheme's Merkle tree on the matrix's device: the digest
    layers from the query stride up, each an (n, 8) int32 tensor of
    canonical BN254 digests, laid out as :func:`build_host_tree`'s (strided
    pairing while more digests than the query stride remain, then
    contiguous). The root is read once, as a Python int."""

    def __init__(self, matrix, rows_per_query: int, ext: bool):
        from .bn254_poseidon2 import compress_layer, hash_rows
        from ..fields import bn254 as fb

        h = int(matrix.shape[1])
        if (matrix.dim() == 3) != ext:
            raise ValueError(f"DeviceBn254Tree: a {tuple(matrix.shape)} matrix with ext={ext}")
        if h <= 0 or h & (h - 1) != 0:
            raise ValueError("DeviceBn254Tree: height must be a positive power of two")
        if rows_per_query & (rows_per_query - 1) != 0 or rows_per_query > h:
            raise ValueError("DeviceBn254Tree: bad rows_per_query")
        stride = h // rows_per_query
        cur = hash_rows(matrix)
        while cur.shape[0] > stride:
            cur = compress_layer(cur, stride)
        self.layers = [cur]
        while cur.shape[0] > 1:
            cur = compress_layer(cur, 1)
            self.layers.append(cur)
        self.root = fb.to_ints(cur)[0]

    @property
    def query_stride(self) -> int:
        return int(self.layers[0].shape[0])

    def batch_query_proofs_arr(self, indices) -> List[list]:
        """proofs[qi][level] = sibling digest (Python ints), the host tree's
        order: the siblings gathered on the device, copied back once."""
        from ..fields import bn254 as fb

        idx = torch.as_tensor(indices, dtype=torch.int64).to(self.layers[0].device).reshape(-1)
        nq, depth = int(idx.shape[0]), len(self.layers) - 1
        if depth == 0:
            return [[] for _ in range(nq)]
        sib = torch.stack([layer[(idx >> level) ^ 1] for level, layer in enumerate(self.layers[:-1])], dim=1)
        flat = fb.to_ints(sib)
        return [flat[q * depth : (q + 1) * depth] for q in range(nq)]


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

    def new_transcript(self, record: bool = False, device=None):
        """The host transcript (its grinds run in the native host library);
        ``device`` is the outer scheme's, unused here."""
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

    def new_transcript(self, record: bool = False, device=None):
        """The multi-field transcript; with a ``device`` it grinds there
        (kernel J on the card, its plain version on the CPU), with none on
        the host loop (the verifier's)."""
        from .multi_field import MultiFieldTranscript

        return MultiFieldTranscript(record=record, device=device)

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
        def build(matrix, rows_per_query: int, ext: bool):
            """A canonical (width, height[, 4]) int64 tensor; the tree is
            built on its device, the root read once."""
            tree = DeviceBn254Tree(matrix, rows_per_query, ext)
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
