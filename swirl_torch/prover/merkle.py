"""Merkle tree over Poseidon2 digests on torch tensors.

Peer of ``swirl/prover/merkle.py``. Rows of a (width, height[, 4]) codeword
matrix are leaf-hashed (one column of the matrix per leaf, EF coefficients
flattened so that hash input row = column * 4 + coefficient, read in place
by kernel B); the first
log2(rows_per_query) levels pair leaves at stride ``height /
rows_per_query`` so one query index opens that many coset-aligned rows with
one path, and ``layers[0]`` is the layer after those strided levels. Query
paths and opened rows are gathered on the device for all queries at once.
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

    def batch_query_proofs_arr(self, indices) -> torch.Tensor:
        """The sibling paths of a (nq,) index tensor as one (nq, depth, 8)
        tensor on the tree's device, a gather a level and no read (peer of
        ``swirl/prover/merkle.py:88-100``); the indices are below
        :attr:`query_stride` by construction (sampled bits)."""
        cur = indices
        per_level = []
        for layer in self.layers[:-1]:
            per_level.append(layer[:, cur ^ 1].T)  # (nq, 8)
            cur = cur >> 1
        if not per_level:
            return torch.zeros((cur.shape[0], 0, 8), dtype=F.DTYPE, device=cur.device)
        return torch.stack(per_level, dim=1)


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


def get_opened_rows_batch(matrix, indices, rows_per_query: int) -> torch.Tensor:
    """Rows {index + t * query_stride} of the matrix for a (nq,) index
    tensor, in one gather and no read: (nq, rows_per_query, width[, 4]) on
    the matrix's device (peer of ``swirl/prover/merkle.py:157-170``)."""
    query_stride = int(matrix.shape[1]) // rows_per_query
    row_ids = indices[:, None] + query_stride * torch.arange(rows_per_query, device=matrix.device)
    rows = torch.index_select(matrix, 1, row_ids.reshape(-1))
    rows = rows.reshape((matrix.shape[0],) + tuple(row_ids.shape) + tuple(matrix.shape[2:]))
    return rows.movedim(0, 2)
