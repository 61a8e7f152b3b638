"""The card's busy time in a window: the disjoint union of its kernel, copy
and fill intervals, the arithmetic of ``swirl_torch/tools/prove_profile.py``
(``_Union``, commit 484cae3), frozen so that a later change to the program
cannot move it."""

from __future__ import annotations

import bisect


class Union:
    """Disjoint union of intervals, with the covered length in a window."""

    def __init__(self, intervals):
        merged = []
        for s, e in sorted(intervals):
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        self.starts = [s for s, _ in merged]
        self.ends = [e for _, e in merged]
        self.prefix = [0]
        for s, e in merged:
            self.prefix.append(self.prefix[-1] + e - s)

    def covered(self, lo, hi) -> int:
        i = bisect.bisect_right(self.ends, lo)  # first interval ending after lo
        j = bisect.bisect_left(self.starts, hi)  # intervals starting before hi
        if i >= j:
            return 0
        total = self.prefix[j] - self.prefix[i]
        total -= max(0, lo - self.starts[i])
        total -= max(0, self.ends[j - 1] - hi)
        return total
