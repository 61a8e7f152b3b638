"""Synthetic workload AIRs: kernel-cost-faithful replay of captured AIR
shapes (the swirl analog of the reference's ``benchmarks/synthetic``).

A :class:`SyntheticAir` reproduces the prover-observable shape of a real
AIR — trace height, width, constraint count/degree, interaction count and
message lengths — without needing valid witness data. The trick: column 0
is a "kill column" of zeros; every constraint is a structurally distinct
degree-D monomial multiplied by it (trivially satisfied) and every
interaction uses it as the count (trivially balanced), so the prover does
identical per-cell and per-term work as on the real AIR.

Shape atlases are plain JSON: {"source": ..., "shapes": [{...}]}.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from ..air import Air


@dataclass
class SyntheticShape:
    air_name: str
    log_height: int
    common_main_width: int
    num_constraints: int
    num_interactions: int
    num_distinct_buses: int
    max_constraint_degree: int
    interaction_message_lens: List[int] = field(default_factory=list)
    interaction_count_weights: List[int] = field(default_factory=list)
    occurrences: int = 1


def load_shape_atlas(path: str) -> List[SyntheticShape]:
    with open(path) as f:
        data = json.load(f)
    return [SyntheticShape(**{k: v for k, v in s.items() if k in SyntheticShape.__dataclass_fields__}) for s in data["shapes"]]


def shape_from_record(rec: dict, max_log_height: int = 22) -> SyntheticShape:
    """Per-AIR shape from a reth-atlas record (peer of the reference's
    ``shape_from_record``, ``benchmarks/synthetic/src/bin/synthetic_runner.rs:111``:
    heights clamp to ``max_log_height``; ``num_distinct_buses`` is the
    distinct count of the captured bus list; preprocessed/cached widths are
    ignored by :class:`SyntheticAir` exactly as in the reference v1 AIR)."""
    return SyntheticShape(
        air_name=rec["air_name"],
        log_height=min(rec["log_height"], max_log_height),
        common_main_width=rec["common_main_width"],
        num_constraints=rec["num_constraints"],
        num_interactions=rec["num_interactions"],
        num_distinct_buses=len(set(rec["buses"])) or 1,
        max_constraint_degree=rec["max_constraint_degree"],
        interaction_message_lens=list(rec["interaction_message_lens"]),
        interaction_count_weights=list(rec["interaction_count_weights"]),
    )


def load_segment_atlas(path: str, max_log_height: int = 22) -> List[dict]:
    """Load a segment atlas (``benchmarks/reth_atlas.py`` output): returns
    [{"segment_idx": n, "clamped": bool, "shapes": [SyntheticShape...]}]."""
    with open(path) as f:
        data = json.load(f)
    out = []
    for seg in data["segments"]:
        shapes = [shape_from_record(r, max_log_height) for r in seg["airs"]]
        clamped = any(r["log_height"] > max_log_height for r in seg["airs"])
        out.append(
            {
                "segment_idx": seg["segment_idx"],
                "clamped": clamped,
                "shapes": shapes,
                "max_constraint_degree": int(
                    seg.get("global_max_constraint_degree", 3)
                ),
            }
        )
    return out


class SyntheticAir(Air):
    def __init__(self, shape: SyntheticShape):
        max_msg = max(shape.interaction_message_lens, default=0)
        self.width = max(shape.common_main_width, max_msg + 1, 2)
        self.shape = shape
        num_buses = max(shape.num_distinct_buses, 1)
        max_fields = self.width - 1
        fallback = min(max_fields, 4)
        self.interactions = []
        for i in range(shape.num_interactions):
            msg_len = (
                shape.interaction_message_lens[i]
                if i < len(shape.interaction_message_lens)
                else fallback
            )
            cw = (
                shape.interaction_count_weights[i]
                if i < len(shape.interaction_count_weights)
                else 0
            )
            self.interactions.append(
                (i % num_buses, i % 2 == 0, min(msg_len, max_fields), cw)
            )

    def name(self) -> str:
        return f"Synthetic({self.shape.air_name})"

    def common_main_width(self) -> int:
        return self.width

    def eval(self, b):
        local = b.common_main.local
        nxt = b.common_main.next
        kill = local[0]
        w = self.width
        deg = max(self.shape.max_constraint_degree, 1)
        # num_constraints structurally distinct degree-(deg) monomials:
        # constraint c = kill * prod of (deg - 1) variables chosen by the
        # mixed-radix digits of c over the 2*(w-1) non-kill window columns.
        n_vars = 2 * (w - 1)
        for c in range(self.shape.num_constraints):
            expr = kill
            idx = c
            for _ in range(deg - 1):
                pick = idx % max(n_vars, 1)
                idx //= max(n_vars, 1)
                col = 1 + (pick % (w - 1))
                row = nxt if pick >= (w - 1) else local
                expr = expr * row[col]
            # make distinct even when digits collide by adding c
            b.assert_zero(expr * 1 + kill * c)
        for bus, is_send, msg_len, cw in self.interactions:
            msg = [local[1 + (j % (w - 1))] for j in range(max(msg_len, 1))]
            count = kill if is_send else -kill
            b.push_interaction(bus, msg, count, cw)

    def generate_trace(self, log_height: Optional[int] = None) -> np.ndarray:
        lh = self.shape.log_height if log_height is None else log_height
        return np.zeros((1 << lh, self.width), dtype=np.uint64)


def uniform_shape(
    log_height: int,
    width: int,
    num_constraints: int = 8,
    num_interactions: int = 4,
    degree: int = 3,
) -> SyntheticShape:
    return SyntheticShape(
        air_name=f"uniform_{log_height}x{width}",
        log_height=log_height,
        common_main_width=width,
        num_constraints=num_constraints,
        num_interactions=num_interactions,
        num_distinct_buses=2,
        max_constraint_degree=degree,
        interaction_message_lens=[3] * num_interactions,
        interaction_count_weights=[0] * num_interactions,
    )
