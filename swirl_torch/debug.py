"""Debug-first constraint checker: evaluates every constraint on every row
before proving, and checks LogUp bus balance across all traces (cf.
reference ``crates/stark-backend/src/air_builders/debug/``).

Peer of ``swirl/debug.py`` with the same inputs, order and messages, run on
the traces' own device: the DAG is evaluated over all rows of a trace as
int64 tensor ops (node by node, or through the level-scheduled interpreter
for a DAG of 128 nodes or more, as the prover does), the first failing row
of every constraint comes from one reduction, and the buses balance by
grouping the messages with
``torch.unique`` and summing their counts with ``scatter_add``. Only the
verdict, and the unbalanced messages for the report, reach the host.
"""

from __future__ import annotations

import torch

from .fields import field as F
from .fields.babybear import P
from .keygen import MultiStarkProvingKey
from .prover.dag_eval import _eval_nodes_device
from .prover.dag_vectorized import NodeValues
from .symbolic import ConstraintsDag

_DEBUG_ENABLED = [True]

# messages listed per bus in the imbalance report
REPORT_MESSAGES = 20


def disable_debug():
    _DEBUG_ENABLED[0] = False


def enable_debug():
    _DEBUG_ENABLED[0] = True


class _RowEvaluator:
    """Base-field evaluation over all rows at once: (w, h) int64 tensors in,
    (h,) node values out (constants and public values stay 0-d). A rotation
    is a roll along the height."""

    def __init__(self, prep, parts, pvs, height, device):
        self.prep = prep  # (w, h) or None
        self.parts = parts  # list of (w, h)
        self.pvs = pvs
        self.device = device
        idx = torch.arange(height, device=device)
        self.sels = [
            (idx == 0).to(F.DTYPE),
            (idx != height - 1).to(F.DTYPE),
            (idx == height - 1).to(F.DTYPE),
        ]

    def eval_const(self, c):
        return torch.full((), int(c) % P, dtype=F.DTYPE, device=self.device)

    def eval_var(self, entry, part, offset, index):
        if entry == "public":
            return self.eval_const(self.pvs[index])
        mat = self.prep if entry == "preprocessed" else self.parts[part]
        col = mat[index]
        return col if offset == 0 else torch.roll(col, -offset)

    def eval_vars(self, entry, part, offset, indices):
        mat = self.prep if entry == "preprocessed" else self.parts[part]
        cols = mat.index_select(0, indices)
        return cols if offset == 0 else torch.roll(cols, -offset, dims=1)

    def eval_sel(self, kind):
        i = {"is_first_row": 0, "is_transition": 1, "is_last_row": 2}[kind]
        return self.sels[i]

    add = staticmethod(F.add)
    sub = staticmethod(F.sub)
    neg = staticmethod(F.neg)
    mul = staticmethod(F.mul)


def _first_failing_rows(nodes, constraint_idx, height, device):
    """(num_constraints,) first row where each constraint is non-zero, or
    ``height`` where it holds on every row; one host read in all."""
    if not constraint_idx:
        return []
    if isinstance(nodes, NodeValues):
        vals = nodes.gather(constraint_idx)
    else:
        vals = torch.stack([nodes[idx].expand(height) for idx in constraint_idx])
    rows = torch.arange(height, device=device)
    return torch.where(vals != 0, rows, height).amin(dim=1).tolist()


class _BusRows:
    """Every row of non-zero count sent on one bus, in the reference's
    order of occurrence (``seq``: contexts, then interactions, then rows)."""

    def __init__(self):
        self.keys, self.counts, self.seq, self.air = [], [], [], []


def check_constraints_and_interactions(airs, pk: MultiStarkProvingKey, ctx):
    """ctx: ProvingContext with (w, h) int64 tensors, checked where they lie."""
    if not _DEBUG_ENABLED[0]:
        return
    buses = {}
    seq0 = 0
    for air_id, tc in ctx.per_trace:
        spk = pk.per_air[air_id]
        dag: ConstraintsDag = spk.vk.symbolic_constraints
        common = tc.common_main
        device, h = common.device, int(common.shape[1])
        prep = spk.preprocessed_data.trace if spk.preprocessed_data is not None else None
        parts = [cd.trace for cd in tc.cached_mains] + [common]
        nodes = _eval_nodes_device(dag, _RowEvaluator(prep, parts, tc.public_values, h, device))
        for ci, row in enumerate(_first_failing_rows(nodes, dag.constraint_idx, h, device)):
            if row < h:
                raise AssertionError(
                    f"constraint {ci} of AIR {spk.air_name} (id {air_id}) "
                    f"failed at row {row}"
                )
        for it in dag.interactions:
            counts = nodes[it.count].expand(h)
            rows = torch.nonzero(counts != 0).squeeze(1)
            bus = buses.setdefault(it.bus_index, _BusRows())
            msg = [nodes[m].expand(h)[rows] for m in it.message]
            bus.keys.append(torch.stack(msg, 1) if msg else rows.new_zeros(len(rows), 0))
            bus.counts.append(counts[rows])
            bus.seq.append(rows + seq0)
            bus.air.append(torch.full_like(rows, air_id))
            seq0 += h
        del nodes
    unbalanced, contributions = {}, {}
    for bus_index, bus in buses.items():
        found = _unbalanced_on_bus(bus)
        if found:
            unbalanced[bus_index], contributions[bus_index] = found
    if unbalanced:
        raise AssertionError(format_unbalanced_report(unbalanced, contributions, pk))


def _unbalanced_on_bus(bus: _BusRows):
    """({message: total}, {message: [(air_id, count)]}) of the messages whose
    counts do not sum to 0 mod P, in order of first occurrence; the
    contributions only of the messages the report lists. None if balanced."""
    counts, seq, air = torch.cat(bus.counts), torch.cat(bus.seq), torch.cat(bus.air)
    if counts.numel() == 0:
        return None
    # messages of another length are other keys: pad with -1, no field value
    width = max(1, max(k.shape[1] for k in bus.keys))
    keys = torch.cat([torch.nn.functional.pad(k, (0, width - k.shape[1]), value=-1) for k in bus.keys])
    uniq, inverse = torch.unique(keys, dim=0, return_inverse=True)
    # counts < P < 2^31: 2^32 rows sum below 2^63
    totals = torch.zeros(uniq.shape[0], dtype=F.DTYPE, device=keys.device)
    totals = totals.scatter_add_(0, inverse, counts) % P
    first = torch.full_like(totals, torch.iinfo(F.DTYPE).max)
    first = first.scatter_reduce_(0, inverse, seq, "amin")
    bad = torch.nonzero(totals).squeeze(1)
    if bad.numel() == 0:
        return None
    bad = bad[torch.argsort(first[bad])]
    listed = torch.full_like(totals, -1)
    listed[bad[:REPORT_MESSAGES]] = torch.arange(min(len(bad), REPORT_MESSAGES), device=keys.device)
    rows = torch.nonzero(listed[inverse] >= 0).squeeze(1)
    rows = rows[torch.argsort(seq[rows])]
    messages = [tuple(v for v in k if v >= 0) for k in uniq[bad].tolist()]
    table = dict(zip(messages, totals[bad].tolist()))
    contrib = {m: [] for m in messages[:REPORT_MESSAGES]}
    for j, a, c in zip(listed[inverse[rows]].tolist(), air[rows].tolist(), counts[rows].tolist()):
        contrib[messages[j]].append((a, c))
    return table, contrib


def format_unbalanced_report(unbalanced, contributions, pk) -> str:
    """Per-bus unbalanced-message diff: for every message whose signed count
    sum is nonzero, list each contributing (AIR, count) pair so the author
    can see which side dropped/duplicated a send. Peer of the reference
    interaction debugger (``interaction/debug.rs`` LogicalInteractions +
    the `debug_constraints_and_interactions` report)."""
    lines = ["LogUp bus imbalance detected:"]
    for bus in sorted(unbalanced):
        lines.append(f"  bus {bus}:")
        for key, total in list(unbalanced[bus].items())[:REPORT_MESSAGES]:
            signed = total if total <= P // 2 else total - P
            lines.append(f"    message {key}: net count {signed} (mod p {total})")
            for air_id, c in contributions[bus][key]:
                name = pk.per_air[air_id].air_name
                sc = c if c <= P // 2 else c - P
                lines.append(f"      {name} (air {air_id}): {sc:+d}")
        extra = len(unbalanced[bus]) - REPORT_MESSAGES
        if extra > 0:
            lines.append(f"    ... and {extra} more unbalanced messages")
    return "\n".join(lines)

