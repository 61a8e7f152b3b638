"""The stacked layout of the verifier: the host half of
``swirl_torch/prover/stacked_pcs.py`` (:class:`StackedSlice`,
:class:`StackedLayout`), frozen with the rest of this package."""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple


class StackedPcsError(ValueError):
    """A layout the stacking cannot hold."""


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
