"""Stacked polynomial commitment: column stacking, RS encode, Merkle tree.

Peer of ``swirl/prover/stacked_pcs.py``. The port keeps its own
:class:`StackedLayout` (the reference's module imports jax); a test holds
the two equal. Matrices are (width, height) canonical int64 tensors.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .errors import StackedPcsError

from .. import metrics
from ..fields import field as F
from ..parallel import annotate
from .merkle import build_merkle_tree
from .ntt import intt, ntt, zeta_transform

# the card's time in a prove's RS encodes (kernels A, A′, with the chunk
# iDFTs and the padding) and in its Merkle builds (B, C, D), each summed
# over its occurrences (``metrics.device_interval``)
ENCODE_TIMING = "pcs.encode.device"
MERKLE_TIMING = "pcs.merkle.device"


@dataclass(frozen=True)
class StackedSlice:
    """Location of one (lifted) trace column inside the stacked matrix."""

    col_idx: int
    row_idx: int
    log_height: int  # true log height; striding if < l_skip

    def length(self, l_skip: int) -> int:
        return 1 << max(self.log_height, l_skip)


@dataclass
class StackedLayout:
    l_skip: int
    height: int
    width: int
    # (matrix index, column index, slice) in stacking order
    sorted_cols: List[Tuple[int, int, StackedSlice]]
    mat_starts: List[int]

    @staticmethod
    def new(
        l_skip: int,
        log_stacked_height: int,
        sorted_dims: Sequence[Tuple[int, int]],  # (width, log_height) desc by height
    ) -> "StackedLayout":
        assert l_skip <= log_stacked_height
        if any(
            sorted_dims[i][1] < sorted_dims[i + 1][1] for i in range(len(sorted_dims) - 1)
        ):
            raise StackedPcsError("StackedLayout.new: dims must be sorted by descending height")
        height = 1 << log_stacked_height
        sorted_cols: List[Tuple[int, int, StackedSlice]] = []
        mat_starts: List[int] = []
        col_idx = 0
        row_idx = 0
        for mat_idx, (width, log_ht) in enumerate(sorted_dims):
            mat_starts.append(len(sorted_cols))
            if width == 0:
                continue
            if log_ht > log_stacked_height:
                raise StackedPcsError(
                    f"StackedLayout.new: column height {log_ht} exceeds "
                    f"stacked height {log_stacked_height}"
                )
            slice_len = 1 << max(log_ht, l_skip)
            for j in range(width):
                if row_idx + slice_len > height:
                    if row_idx != height:
                        raise StackedPcsError(
                            f"StackedLayout.new: row overflow at col_idx={col_idx}"
                        )
                    col_idx += 1
                    row_idx = 0
                sorted_cols.append((mat_idx, j, StackedSlice(col_idx, row_idx, log_ht)))
                row_idx += slice_len
        width = col_idx + (1 if row_idx != 0 else 0)
        return StackedLayout(l_skip, height, width, sorted_cols, mat_starts)

    def get(self, mat_idx: int, col_idx: int) -> Optional[StackedSlice]:
        idx = self.mat_starts[mat_idx] + col_idx
        if idx >= len(self.sorted_cols):
            return None
        m, c, s = self.sorted_cols[idx]
        assert m == mat_idx and c == col_idx
        return s


@dataclass
class StackedPcsData:
    """Prover-side data of one stacked commitment.

    Memory policy (``ProverConfig``, peer of ``swirl/prover/stacked_pcs.py``
    :115-148): ``matrix`` and ``rs_matrix`` may be dropped after the commit
    (None) and are recomputed on demand from the retained traces; readers
    go through :meth:`get_matrix` and :meth:`get_rs_matrix`. ``tree`` is a
    :class:`~.merkle.MerkleTree`, or the hash scheme's host tree."""

    layout: StackedLayout
    matrix: Optional[torch.Tensor]  # (width, height) stacked evaluations
    rs_matrix: Optional[torch.Tensor]  # (width, height << log_blowup) codewords
    tree: object
    traces: Sequence[torch.Tensor] = ()
    l_skip: int = 0
    n_stack: int = 0
    log_blowup: int = 0

    @property
    def device(self) -> torch.device:
        return self.traces[0].device

    def get_matrix(self) -> torch.Tensor:
        if self.matrix is not None:
            return self.matrix
        return stack_traces(self.l_skip, self.n_stack, self.traces)[0]

    def get_rs_matrix(self) -> torch.Tensor:
        if self.rs_matrix is not None:
            return self.rs_matrix
        return rs_code_matrix(self.l_skip, self.log_blowup, self.get_matrix())


def stack_traces(
    l_skip: int, n_stack: int, traces: Sequence[torch.Tensor]
) -> Tuple[torch.Tensor, StackedLayout]:
    """Stack trace columns (each trace (w_t, h_t), heights descending).

    The greedy layout places slices back to back in column-major order, so
    the stacked matrix is the concatenation of the traces' flat columns
    (short traces zero-interleaved to their stride), zero-padded to
    width * height."""
    dims = [(int(t.shape[0]), int(t.shape[1]).bit_length() - 1) for t in traces]
    layout = StackedLayout.new(l_skip, l_skip + n_stack, dims)
    device = traces[0].device
    blocks = []
    for t in traces:
        h_t = int(t.shape[1])
        stride = (1 << l_skip) // h_t if h_t < (1 << l_skip) else 1
        if stride == 1:
            blocks.append(t.reshape(-1))
        else:
            ex = torch.zeros((t.shape[0], h_t, stride), dtype=F.DTYPE, device=device)
            ex[:, :, 0] = t
            blocks.append(ex.reshape(-1))
    flat = torch.cat(blocks)
    pad = layout.width * layout.height - int(flat.shape[0])
    if pad:
        flat = torch.cat([flat, torch.zeros(pad, dtype=F.DTYPE, device=device)])
    return flat.reshape(layout.width, layout.height), layout


def rs_message(l_skip: int, evals):
    """Eval-to-coeff RS message of prismalinear columns (batched over the
    leading axes): iDFT per 2^l_skip chunk, then the zeta transform over the
    chunk-local bits."""
    shape = evals.shape
    chunks = evals.reshape(shape[:-1] + (shape[-1] >> l_skip, 1 << l_skip))
    return zeta_transform(intt(chunks).reshape(shape), l_skip)


def rs_encode(padded, ext: bool = False):
    """The codewords of zero-padded coefficients, ``ntt(padded, ext=ext)``:
    the RS encode of the commit and of WHIR's codeword commits. Under
    ``annotate.spmd_mesh`` it runs across the mesh's ranks
    (``parallel/sharded.py`` ``rs_ntt``)."""
    mesh = annotate.active_mesh()
    if mesh is None:
        return ntt(padded, ext=ext)
    from ..parallel import sharded

    return sharded.rs_ntt(padded, mesh, ext=ext)


def rs_code_matrix(l_skip: int, log_blowup: int, stacked):
    """Reed-Solomon codewords of all stacked columns (one batched NTT)."""
    width, height = stacked.shape
    with metrics.device_interval(ENCODE_TIMING):
        padded = torch.zeros((width, height << log_blowup), dtype=F.DTYPE, device=stacked.device)
        padded[:, :height] = rs_message(l_skip, stacked)
        return rs_encode(padded)


def stacked_commit(
    l_skip: int,
    n_stack: int,
    log_blowup: int,
    k_whir: int,
    traces: Sequence[torch.Tensor],
    cache_stacked_matrix: bool = True,
    cache_rs_code_matrix: bool = True,
    tree_builder=None,
) -> Tuple[object, StackedPcsData]:
    """Commit to height-sorted traces; returns (root digest, data).
    ``tree_builder`` (the hash-scheme hook): when set, ``(rs_matrix,
    rows_per_query, ext) -> (root, tree)`` replaces the Poseidon2 Merkle
    build (the BN254 outer scheme commits on the codeword's device: kernels
    I and H on the card)."""
    stacked, layout = stack_traces(l_skip, n_stack, traces)
    rs = rs_code_matrix(l_skip, log_blowup, stacked)
    if tree_builder is None:
        tree = build_merkle_tree(rs, 1 << k_whir)
        root = tree.root
    else:
        root, tree = tree_builder(rs, 1 << k_whir, False)
    return root, StackedPcsData(
        layout=layout,
        matrix=stacked if cache_stacked_matrix else None,
        rs_matrix=rs if cache_rs_code_matrix else None,
        tree=tree,
        traces=list(traces),
        l_skip=l_skip,
        n_stack=n_stack,
        log_blowup=log_blowup,
    )
