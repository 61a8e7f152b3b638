"""Test fixtures: small AIRs + trace generators mirroring the reference's
test zoo (``crates/stark-backend/src/test_utils/``): Fibonacci, Fibonacci
with selectors, dummy interaction sender/receiver pairs, self-interaction,
cached-trace and preprocessed variants.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from ..air import Air
from ..fields.babybear import P


class FibonacciAir(Air):
    """Columns (a, b); row i+1: (b_i, a_i + b_i); pvs [a0, b0, b_last]."""

    def common_main_width(self) -> int:
        return 2

    def num_public_values(self) -> int:
        return 3

    def eval(self, b):
        main = b.common_main
        (a, bb) = main.local
        (a_next, b_next) = main.next
        pv_a0, pv_b0, pv_final = b.public_values
        when_first = b.when_first_row()
        when_first.assert_eq(a, pv_a0)
        when_first.assert_eq(bb, pv_b0)
        t = b.when_transition()
        t.assert_eq(a_next, bb)
        t.assert_eq(b_next, a + bb)
        b.when_last_row().assert_eq(bb, pv_final)

    @staticmethod
    def generate_trace(a0: int, b0: int, n: int) -> np.ndarray:
        rows = np.zeros((n, 2), dtype=np.uint64)
        a, bv = a0 % P, b0 % P
        for i in range(n):
            rows[i] = (a, bv)
            a, bv = bv, (a + bv) % P
        return rows

    @staticmethod
    def pvs(a0: int, b0: int, n: int) -> List[int]:
        a, bv = a0 % P, b0 % P
        for _ in range(n - 1):
            a, bv = bv, (a + bv) % P
        return [a0 % P, b0 % P, bv]


class FibonacciSelectorAir(Air):
    """Fib with a preprocessed selector column gating the transition.

    With ``interaction=True`` the AIR additionally sends (a, b) on lookup
    bus 0 gated by the selector with count_weight 0 — mirroring the
    reference fixture's ``enable_interactions`` flag (LookupBus key adds,
    ``fib_selector_air/air.rs:105``), used by the vk-introspection tests.
    """

    def __init__(self, sels: List[bool], interaction: bool = False):
        self.sels = list(sels)
        self.interaction = interaction

    def common_main_width(self) -> int:
        return 2

    def num_public_values(self) -> int:
        return 3

    def preprocessed_trace(self) -> Optional[np.ndarray]:
        return np.array([[1 if s else 0] for s in self.sels], dtype=np.uint64)

    def eval(self, b):
        (sel,) = b.preprocessed.local
        (a, bb) = b.common_main.local
        (a_next, b_next) = b.common_main.next
        pv_a0, pv_b0, pv_final = b.public_values
        first = b.when_first_row()
        first.assert_eq(a, pv_a0)
        first.assert_eq(bb, pv_b0)
        when_sel_t = b.when_transition().when(sel)
        when_sel_t.assert_eq(a_next, bb)
        when_sel_t.assert_eq(b_next, a + bb)
        # when not sel (and transition): copy row
        not_sel = b.when_transition().when(1 - sel)
        not_sel.assert_eq(a_next, a)
        not_sel.assert_eq(b_next, bb)
        b.when_last_row().assert_eq(bb, pv_final)
        if self.interaction:
            b.push_interaction(0, [a, bb], sel, 0)

    def generate_trace(self, a0: int, b0: int) -> np.ndarray:
        n = len(self.sels)
        rows = np.zeros((n, 2), dtype=np.uint64)
        a, bv = a0 % P, b0 % P
        for i in range(n):
            rows[i] = (a, bv)
            if i < n - 1 and self.sels[i]:
                a, bv = bv, (a + bv) % P
        return rows

    def pvs(self, a0: int, b0: int) -> List[int]:
        tr = self.generate_trace(a0, b0)
        return [a0 % P, b0 % P, int(tr[-1, 1])]


class DummyInteractionAir(Air):
    """(count, fields...) rows; sends or receives on a bus.

    is_send controls the sign of the count. Mirrors the reference's
    dummy_interaction_air used across the conformance suite.
    """

    def __init__(self, field_width: int, is_send: bool, bus_index: int,
                 count_weight: int = 0, partitioned: bool = False):
        self.field_width = field_width
        self.is_send = is_send
        self.bus_index = bus_index
        self.count_weight = count_weight
        self.partitioned = partitioned

    def common_main_width(self) -> int:
        return 1 if self.partitioned else 1 + self.field_width

    def cached_main_widths(self) -> List[int]:
        return [self.field_width] if self.partitioned else []

    def eval(self, b):
        if self.partitioned:
            (count,) = b.partitioned_main[1].local
            fields = b.partitioned_main[0].local
        else:
            row = b.common_main.local
            count, fields = row[0], row[1:]
        mult = count if self.is_send else -count
        b.push_interaction(self.bus_index, fields, mult, self.count_weight)

    @staticmethod
    def make_trace(rows: List[List[int]]) -> np.ndarray:
        """rows of [count, f0, f1, ...]."""
        return np.array(rows, dtype=np.uint64) % np.uint64(P)


class MultiCachedAir(Air):
    """AIR with TWO cached-main partitions (the reference conformance
    suite sweeps cached-part counts 1-3, ``backend-tests/src/lib.rs:254``):
    common column a must equal b0 + b1 + c0 of the cached parts."""

    def name(self) -> str:
        return "multi_cached"

    def common_main_width(self) -> int:
        return 1

    def cached_main_widths(self) -> List[int]:
        return [2, 1]

    def eval(self, b):
        b0, b1 = b.partitioned_main[0].local
        (c0,) = b.partitioned_main[1].local
        (a,) = b.partitioned_main[2].local
        b.assert_zero(a - (b0 + b1 + c0))

    @staticmethod
    def generate_traces(n: int, seed: int = 0):
        """(common, [cached_part_1, cached_part_2]) host traces (h, w)."""
        rng = np.random.default_rng(seed)
        p1 = rng.integers(0, P, (n, 2), dtype=np.uint64)
        p2 = rng.integers(0, P, (n, 1), dtype=np.uint64)
        common = ((p1[:, 0] + p1[:, 1] + p2[:, 0]) % np.uint64(P)).reshape(n, 1)
        return common, [p1, p2]


class SelfInteractionAir(Air):
    """Width-w AIR sending each row's key on a bus twice and receiving it
    twice (balanced on a single trace); plus a dummy constraint."""

    def __init__(self, width: int, bus_index: int = 0):
        assert width >= 3
        self.width = width
        self.bus_index = bus_index

    def common_main_width(self) -> int:
        return self.width

    def eval(self, b):
        row = b.common_main.local
        # send with count = row[0], receive with count = row[1]; traces set
        # row[0] == row[1] so each message balances within the trace.
        msg = row[2:]
        b.push_interaction(self.bus_index, msg, row[0], 1)
        b.push_interaction(self.bus_index, msg, -row[1], 1)
        b.assert_eq(row[0], row[1])

    def generate_trace(self, height: int, seed: int = 0) -> np.ndarray:
        rng = np.random.default_rng(seed)
        w = self.width
        tr = rng.integers(0, P, (height, w), dtype=np.uint64)
        counts = rng.integers(0, 100, height, dtype=np.uint64)
        tr[:, 0] = counts
        tr[:, 1] = counts
        return tr


class MixtureAir(Air):
    """Simple constraint-only AIR of arbitrary width/degree for mixing."""

    def __init__(self, width: int = 3):
        assert width >= 2
        self.width = width

    def common_main_width(self) -> int:
        return self.width

    def eval(self, b):
        row = b.common_main.local
        # col0 * col1 == col1 * col0 style non-trivial but always satisfiable:
        # enforce col_{w-1} = col_0 * col_1
        b.assert_eq(row[self.width - 1], row[0] * row[1])

    def generate_trace(self, height: int, seed: int = 1) -> np.ndarray:
        rng = np.random.default_rng(seed)
        tr = rng.integers(0, P, (height, self.width), dtype=np.uint64)
        tr[:, self.width - 1] = (tr[:, 0] * tr[:, 1]) % np.uint64(P)
        return tr
