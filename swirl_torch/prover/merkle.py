"""Merkle tree over Poseidon2 digests on torch tensors.

Peer of ``swirl/prover/merkle.py``. Rows of a (width, height[, 4]) codeword
matrix are leaf-hashed (one column of the matrix per leaf, EF coefficients
flattened so that hash input row = column * 4 + coefficient, read in place
by kernel B); the first
log2(rows_per_query) levels pair leaves at stride ``height /
rows_per_query`` so one query index opens that many coset-aligned rows with
one path, and ``layers[0]`` is the layer after those strided levels. Query
proofs and opened rows leave as canonical numpy.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np
import torch

from .errors import StackedPcsError

from ..fields import field as F
from ..hash import poseidon2 as p2


@dataclass
class MerkleTree:
    layers: List[torch.Tensor]  # each (8, n_i) canonical; layers[-1] is the root
    rows_per_query: int

    @property
    def root(self) -> np.ndarray:
        return F.to_host(self.layers[-1][:, 0])

    @property
    def query_stride(self) -> int:
        return int(self.layers[0].shape[1])

    def batch_query_proofs(self, indices) -> List[List[np.ndarray]]:
        """proofs[qi][level] = sibling digest (8,) canonical uint64."""
        cur = np.asarray(indices, dtype=np.int64)
        if not np.all((0 <= cur) & (cur < self.query_stride)):
            raise StackedPcsError("MerkleTree.query_proof: query index out of bounds")
        per_level = []
        for layer in self.layers[:-1]:
            sib = layer[:, torch.as_tensor(cur ^ 1, device=layer.device)]
            per_level.append(F.to_host(sib).T)  # (nq, 8)
            cur = cur >> 1
        return [[lvl[qi] for lvl in per_level] for qi in range(len(cur))]


def build_merkle_tree(matrix, rows_per_query: int, ext: bool = False) -> MerkleTree:
    height = int(matrix.shape[1])
    if height <= 0 or height & (height - 1) != 0:
        raise StackedPcsError("MerkleTree: height must be a positive power of two")
    if rows_per_query & (rows_per_query - 1) != 0:
        raise StackedPcsError(
            f"MerkleTree: rows_per_query ({rows_per_query}) is not a power of two"
        )
    if rows_per_query > height:
        raise StackedPcsError(
            f"MerkleTree: rows_per_query ({rows_per_query}) exceeds leaves ({height})"
        )
    if ext != (matrix.dim() == 3):
        raise StackedPcsError(f"MerkleTree: ext={ext} does not fit a {matrix.dim()}-d matrix")
    # an EF (w, h, 4) matrix is hashed in place, hash input row c * 4 + d
    cur = p2.hash_cols(matrix.contiguous())
    query_stride = height // rows_per_query
    # the strided levels pair columns query_stride apart, read in place
    while cur.shape[1] > query_stride:
        cur = p2.compress_layer(cur, query_stride)
    return MerkleTree(layers=[cur] + p2.merkle_tower(cur), rows_per_query=rows_per_query)


def get_opened_rows(matrix, index: int, rows_per_query: int, ext: bool) -> np.ndarray:
    """Rows {index + t * query_stride} of the matrix as canonical numpy
    (rows_per_query, width[, 4])."""
    query_stride = int(matrix.shape[1]) // rows_per_query
    row_ids = index + query_stride * torch.arange(rows_per_query, device=matrix.device)
    host = F.to_host(matrix[:, row_ids])
    return host.transpose(1, 0, 2) if ext else host.transpose(1, 0)
