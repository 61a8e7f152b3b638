"""Level-scheduled constraint-DAG interpreter for large AIRs.

Peer of ``swirl/prover/dag_vectorized.py``. The DAG is compiled once on the
host into a *level schedule*: each topological level's nodes are grouped by
op type, and the whole level runs as one gather per operand and one field
op per op type, so the launch count grows with the DAG's depth (29 levels
for keccak-f), not with its node count (40,535).

Memory is bounded two ways. A liveness analysis keeps, after each level,
only the values a later level or an output still reads (keccak-f: at most
17,904 rows). And no level materialises ``concat(buffer, outputs)``: the
new values land in one buffer, and the kept rows of both are gathered
straight into the next buffer; an op group whose rows would exceed
:data:`ROW_CHUNK_ELEMS` values runs in row chunks.

The schedule's index tensors are made once per schedule and device
(:meth:`DagSchedule.on`): a host-to-device copy from pageable memory waits
for the stream, so a copy per level per call would sync the device at
every level of every point.
"""

from __future__ import annotations

import weakref
from dataclasses import dataclass, field
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..fields.babybear import P
from ..symbolic import ConstraintsDag

OPS = ("add", "sub", "mul", "neg")

# values (int64 elements) an op group evaluates at once
ROW_CHUNK_ELEMS = 1 << 27


@dataclass
class _Level:
    """One level on a device: (op, left, right) gathers into the input
    buffer, the kept rows of the input buffer and of the level's outputs."""

    ops: List[Tuple[str, torch.Tensor, torch.Tensor]]
    num_new: int
    keep_old: torch.Tensor
    keep_new: torch.Tensor


@dataclass
class DagSchedule:
    """Host-side compiled form of a ConstraintsDag.

    Buffers are per-level: ``levels[L]`` maps op -> (left_pos, right_pos)
    positions *into the level-L input buffer*; ``keeps[L]`` indexes into
    concat(input_buffer, level_outputs) to form the level-L+1 input buffer.
    ``out_pos`` maps original output-node indices into the final buffer.
    """

    leaf_kinds: List[Tuple]  # ("const", v) | ("var", e, p, o, i) | ("sel", k)
    levels: List[Dict[str, Tuple[np.ndarray, np.ndarray]]]
    keeps: List[np.ndarray]
    out_pos: Dict[int, int]
    max_live: int
    _device: Dict = field(default_factory=dict, repr=False, compare=False)

    def on(self, device) -> List[_Level]:
        """The levels' index tensors on ``device``, made at the first call."""
        device = torch.device(device)
        if device not in self._device:
            levels = []
            width = len(self.leaf_kinds)
            for level_sched, keep in zip(self.levels, self.keeps):
                ops = [
                    (op, torch.as_tensor(ls, device=device), torch.as_tensor(rs, device=device))
                    for op, (ls, rs) in level_sched.items()
                ]
                num_new = sum(len(ls) for ls, _ in level_sched.values())
                split = int(np.searchsorted(keep, width))
                levels.append(_Level(
                    ops, num_new,
                    torch.as_tensor(keep[:split], device=device),
                    torch.as_tensor(keep[split:] - width, device=device),
                ))
                width = len(keep)
            self._device[device] = (levels, {})
        return self._device[device][0]

    def leaf_groups(self, device) -> List[Tuple[Tuple, torch.Tensor, object]]:
        """The leaves grouped as :func:`_leaf_buffer` writes them: (key,
        their buffer rows, the column indices of a "var" group or None),
        key ("const",), ("var", entry, part, offset), ("sel", kind) or
        ("public", entry, part, offset, index) (a public value, one a
        group), made once per device."""
        cache = self._cache(device)
        if "leaf groups" not in cache:
            rows: Dict[Tuple, List[int]] = {}
            cols: Dict[Tuple, List[int]] = {}
            for k, node in enumerate(self.leaf_kinds):
                if node[0] == "const":
                    key = ("const",)
                elif node[0] == "sel":
                    key = ("sel", node[1])
                elif node[1] == "public":
                    key = ("public",) + tuple(node[1:])
                else:
                    key = ("var",) + tuple(node[1:4])
                    cols.setdefault(key, []).append(node[4])
                rows.setdefault(key, []).append(k)

            def on(xs):
                return torch.as_tensor(np.array(xs, dtype=np.int64), device=device)

            cache["leaf groups"] = [
                (key, on(ks), on(cols[key]) if key in cols else None) for key, ks in rows.items()
            ]
        return cache["leaf groups"]

    def leaf_consts(self, device, ext_dims: int) -> torch.Tensor:
        """The constant leaves, canonical: (k,) base values, or (k, 4) EF
        values with ``ext_dims`` 1."""
        cache = self._cache(device)
        if ("leaf consts", ext_dims) not in cache:
            vals = np.array([node[1] % P for node in self.leaf_kinds if node[0] == "const"], dtype=np.int64)
            if ext_dims:
                vals = np.concatenate([vals[:, None], np.zeros((len(vals), 3), dtype=np.int64)], axis=1)
            cache[("leaf consts", ext_dims)] = torch.as_tensor(vals, device=device)
        return cache[("leaf consts", ext_dims)]

    def _cache(self, device) -> Dict:
        self.on(device)
        return self._device[torch.device(device)][1]

    def positions(self, orig_indices: Sequence[int], device) -> torch.Tensor:
        """Final-buffer rows of output nodes, as a tensor cached on ``device``."""
        cache = self._cache(device)
        key = tuple(int(i) for i in orig_indices)
        if key not in cache:
            pos = np.array([self.out_pos[i] for i in key], dtype=np.int64)
            cache[key] = torch.as_tensor(pos, device=device)
        return cache[key]


def _output_nodes(dag: ConstraintsDag) -> List[int]:
    outs = set(dag.constraint_idx)
    for it in dag.interactions:
        outs.add(it.count)
        outs.update(it.message)
    return sorted(outs)


def compile_schedule(dag: ConstraintsDag) -> DagSchedule:
    n = len(dag.nodes)
    level = np.zeros(n, dtype=np.int64)
    for i, node in enumerate(dag.nodes):
        tag = node[0]
        if tag in ("const", "var", "sel"):
            level[i] = 0
        elif tag == "neg":
            level[i] = level[node[1]] + 1
        else:
            level[i] = max(level[node[1]], level[node[2]]) + 1
    max_level = int(level.max()) if n else 0

    outputs = _output_nodes(dag)
    # last level whose ops consume each node; outputs live to the end
    last_use = np.array(level)  # a node is born at its own level
    for i, node in enumerate(dag.nodes):
        tag = node[0]
        if tag in ("const", "var", "sel"):
            continue
        children = (node[1],) if tag == "neg" else (node[1], node[2])
        for c in children:
            last_use[c] = max(last_use[c], level[i])
    for i in outputs:
        last_use[i] = max_level + 1

    # level-0 buffer: live leaves in original order
    buf_ids: List[int] = [
        i
        for i, node in enumerate(dag.nodes)
        if level[i] == 0 and last_use[i] > 0
    ]
    leaf_kinds = [dag.nodes[i] for i in buf_ids]
    pos = {nid: k for k, nid in enumerate(buf_ids)}

    levels: List[Dict[str, Tuple[np.ndarray, np.ndarray]]] = []
    keeps: List[np.ndarray] = []
    max_live = len(buf_ids)
    for lv in range(1, max_level + 1):
        by_op: Dict[str, Tuple[List[int], List[int], List[int]]] = {}
        for i in np.nonzero(level == lv)[0]:
            node = dag.nodes[i]
            tag = node[0]
            li = node[1]
            ri = node[2] if tag != "neg" else node[1]
            ids, ls, rs = by_op.setdefault(tag, ([], [], []))
            ids.append(int(i))
            ls.append(pos[li])
            rs.append(pos[ri])
        level_sched: Dict[str, Tuple[np.ndarray, np.ndarray]] = {}
        out_ids: List[int] = []
        for op in OPS:
            if op not in by_op:
                continue
            ids, ls, rs = by_op[op]
            level_sched[op] = (np.array(ls), np.array(rs))
            out_ids.extend(ids)
        levels.append(level_sched)
        # build next buffer: survivors of the current buffer + new outputs
        ext_ids = buf_ids + out_ids  # positions in concat(buf, outs)
        next_ids = [nid for nid in ext_ids if last_use[nid] > lv]
        keep = np.array(
            [k for k, nid in enumerate(ext_ids) if last_use[nid] > lv],
            dtype=np.int64,
        )
        keeps.append(keep)
        buf_ids = next_ids
        pos = {nid: k for k, nid in enumerate(buf_ids)}
        max_live = max(max_live, len(ext_ids))

    out_pos = {nid: pos[nid] for nid in outputs}
    return DagSchedule(
        leaf_kinds=leaf_kinds,
        levels=levels,
        keeps=keeps,
        out_pos=out_pos,
        max_live=max_live,
    )


# id(dag) -> (weak reference to the dag, its schedule). The weak reference
# drops the entry when the DAG is freed, and a later DAG that Python places
# at the same id fails the identity check, so it never gets a stale schedule.
_schedule_cache: Dict[int, Tuple[weakref.ref, DagSchedule]] = {}


def get_schedule(dag: ConstraintsDag) -> DagSchedule:
    key = id(dag)
    entry = _schedule_cache.get(key)
    if entry is None or entry[0]() is not dag:
        ref = weakref.ref(dag, lambda _, key=key: _schedule_cache.pop(key, None))
        entry = (ref, compile_schedule(dag))
        _schedule_cache[key] = entry
    return entry[1]


def _leaf_buffer(sched: DagSchedule, evaluator) -> torch.Tensor:
    """(num_live_leaves, *batch) stack of the leaves, broadcast to the batch:
    written group by group (the constants from one table, the variables of
    one trace part and row offset by one gather), so its launches do not
    grow with the leaf count."""
    proto = evaluator.eval_const(0)
    device = proto.device
    parts = []
    shape = None
    for key, pos, cols in sched.leaf_groups(device):
        if key[0] == "var":
            v = evaluator.eval_vars(key[1], key[2], key[3], cols)
            shape = v.shape[1:]
        elif key[0] == "sel":
            v = evaluator.eval_sel(key[1])
            shape = v.shape
            v = v[None]
        elif key[0] == "public":
            v = evaluator.eval_var(*key[1:])[None]
        else:
            v = sched.leaf_consts(device, proto.dim())
        parts.append((pos, v))
    if shape is None:
        raise ValueError("vectorized eval needs at least one var/sel leaf")
    buf = torch.empty((len(sched.leaf_kinds),) + tuple(shape), dtype=proto.dtype, device=device)
    for pos, v in parts:
        if v.dim() < buf.dim():  # constants and public values: (k,) or (k, 4)
            v = v.reshape((v.shape[0],) + (1,) * (buf.dim() - v.dim()) + v.shape[1:])
        buf.index_put_((pos,), v)
    return buf


def eval_dag_vectorized(dag: ConstraintsDag, evaluator) -> "NodeValues":
    """Evaluate all output nodes with the level schedule.

    `evaluator` provides the same leaf/op interface as DeviceEvaluator.
    Returns a NodeValues wrapper supporting [original_node_idx] for the
    DAG's output nodes (constraints + interaction count/message nodes).
    """
    sched = get_schedule(dag)
    buf = _leaf_buffer(sched, evaluator)
    row = buf[0].numel()
    chunk = max(1, ROW_CHUNK_ELEMS // max(row, 1))
    for lv in sched.on(buf.device):
        new = buf.new_empty((lv.num_new,) + buf.shape[1:])
        at = 0
        for op, ls, rs in lv.ops:
            for c in range(0, len(ls), chunk):
                a = buf.index_select(0, ls[c : c + chunk])
                if op == "neg":
                    out = evaluator.neg(a)
                else:
                    out = getattr(evaluator, op)(a, buf.index_select(0, rs[c : c + chunk]))
                new[at : at + len(a)] = out
                at += len(a)
                del a, out
        nxt = buf.new_empty((len(lv.keep_old) + len(lv.keep_new),) + buf.shape[1:])
        torch.index_select(buf, 0, lv.keep_old, out=nxt[: len(lv.keep_old)])
        torch.index_select(new, 0, lv.keep_new, out=nxt[len(lv.keep_old) :])
        buf = nxt
        del new
    return NodeValues(buf, sched)


class NodeValues:
    """Indexable by ORIGINAL dag node index (output nodes only)."""

    def __init__(self, buf: torch.Tensor, sched: DagSchedule):
        self.buf = buf
        self.sched = sched

    def __getitem__(self, orig_idx: int):
        return self.buf[self.sched.out_pos[int(orig_idx)]]

    def positions(self, orig_indices: Sequence[int]) -> torch.Tensor:
        return self.sched.positions(orig_indices, self.buf.device)

    def gather(self, orig_indices) -> torch.Tensor:
        """(k, *batch) stack of node values for original indices."""
        return self.buf.index_select(0, self.positions(orig_indices))
