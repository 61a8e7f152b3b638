"""Constraint-DAG evaluation over torch tensors (and single host points).

Peer of ``swirl/prover/dag_eval.py``. Base mode evaluates node values as
base-field tensors over the row batch (round 0, where trace values are base
field); ext mode as EF tensors (..., 4) (the multilinear rounds after
folding). A DAG of at least :data:`VECTORIZE_THRESHOLD` nodes runs through
the level-scheduled interpreter (:mod:`.dag_vectorized`), a smaller one node
by node, as in the reference. The host evaluator runs single EF points for
the verifier; the prover evaluates an exhausted trace's single folded point
on the device.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from ..fields import ext as hext
from ..fields.babybear import P
from ..symbolic import ConstraintsDag, eval_dag_nodes

from ..fields import field as F
from .dag_vectorized import NodeValues, eval_dag_vectorized

_SELECTORS = {"is_first_row": 0, "is_transition": 1, "is_last_row": 2}


class DeviceEvaluator:
    """parts: trace parts [cached..., common] as (local, next|None) pairs of
    (width, *batch) base or (width, *batch, 4) EF tensors."""

    def __init__(
        self,
        sels,  # (3, *batch[, 4])
        preprocessed: Optional[Tuple],
        parts: Sequence[Tuple],
        public_values: Sequence[int],
        ext_mode: bool,
    ):
        self.sels = sels
        self.preprocessed = preprocessed
        self.parts = parts
        self.public_values = public_values
        self.ext_mode = ext_mode
        self.mul = F.ext_mul if ext_mode else F.mul

    add = staticmethod(F.add)
    sub = staticmethod(F.sub)
    neg = staticmethod(F.neg)

    def eval_const(self, c: int):
        # a fill, not torch.tensor: a host-to-device copy would sync the stream
        v = torch.full((), int(c) % P, dtype=F.DTYPE, device=self.sels.device)
        return F.ext_from_base(v) if self.ext_mode else v

    def eval_var(self, entry: str, part: int, offset: int, index: int):
        if entry == "public":
            return self.eval_const(int(self.public_values[index]))
        pair = self.preprocessed if entry == "preprocessed" else self.parts[part]
        return (pair[0] if offset == 0 else pair[1])[index]

    def eval_sel(self, kind: str):
        return self.sels[_SELECTORS[kind]]

    def batch_shape(self):
        return self.sels.shape[1:-1] if self.ext_mode else self.sels.shape[1:]


class HostEvaluator:
    """Single-point EF evaluation on canonical numpy values."""

    def __init__(self, sels, preprocessed, parts, public_values):
        self.sels = sels  # (is_first, is_transition, is_last) EF values
        self.preprocessed = preprocessed
        self.parts = parts
        self.public_values = public_values

    add = staticmethod(hext.eadd)
    sub = staticmethod(hext.esub)
    neg = staticmethod(hext.eneg)
    mul = staticmethod(hext.emul)
    eval_const = staticmethod(hext.from_base)

    def eval_var(self, entry: str, part: int, offset: int, index: int):
        if entry == "public":
            return hext.from_base(int(self.public_values[index]))
        cols = self.preprocessed if entry == "preprocessed" else self.parts[part]
        return cols[index][offset]

    def eval_sel(self, kind: str):
        return self.sels[_SELECTORS[kind]]


def eval_nodes(dag: ConstraintsDag, evaluator) -> list:
    return eval_dag_nodes(dag, evaluator)


VECTORIZE_THRESHOLD = 128

# EF4 terms (int64 elements) the weighted constraint sum forms at once
TERM_CHUNK_ELEMS = 1 << 27


def _eval_nodes_device(dag: ConstraintsDag, ev):
    """Dispatch: node by node for small DAGs, the level-scheduled
    interpreter for large ones (its launches grow with depth, not size)."""
    if len(dag.nodes) >= VECTORIZE_THRESHOLD:
        return eval_dag_vectorized(dag, ev)
    return eval_dag_nodes(dag, ev)


def _times_ef(ev: DeviceEvaluator, value, weight):
    """node value (base or EF) times an EF weight (4,) -> EF."""
    return F.ext_mul(value, weight) if ev.ext_mode else F.mul(value[..., None], weight)


def _weighted_sum_gather(nodes: NodeValues, indices, weights, ev: DeviceEvaluator):
    """sum_i weights[i] * nodes[indices[i]] by gathers from the
    interpreter's buffer and sums, in groups of at most TERM_CHUNK_ELEMS
    term elements (field sums are associative, so the grouping changes no
    value). weights: (k, 4) EF. -> (*batch, 4)."""
    batch = tuple(ev.batch_shape())
    group = max(1, TERM_CHUNK_ELEMS // (4 * torch.Size(batch).numel() or 1))
    pos = nodes.positions(indices)
    acc = None
    for g in range(0, len(indices), group):
        vals = nodes.buf.index_select(0, pos[g : g + group])
        w = weights[g : g + len(vals)].reshape((len(vals),) + (1,) * len(batch) + (4,))
        part = _times_ef(ev, vals, w).sum(0)
        acc = part if acc is None else acc + part
    return acc % P


def acc_constraints(dag: ConstraintsDag, ev: DeviceEvaluator, lambda_pows):
    """sum_i lambda^i * constraint_i as an EF tensor over the batch: one
    gather and sum from the interpreter's buffer, or one product and add a
    constraint for a node list (a small DAG's sum then holds one EF tensor
    of the batch at a time, not a stack of all its constraints)."""
    acc = torch.zeros(tuple(ev.batch_shape()) + (4,), dtype=F.DTYPE, device=ev.sels.device)
    if not dag.constraint_idx:
        return acc
    nodes = _eval_nodes_device(dag, ev)
    if isinstance(nodes, NodeValues):
        return _weighted_sum_gather(nodes, dag.constraint_idx, lambda_pows, ev)
    for i, idx in enumerate(dag.constraint_idx):
        acc = F.add(acc, _times_ef(ev, nodes[idx], lambda_pows[i]))
    return acc


def _h_beta(ev, nodes, it, bus_term, beta_pows):
    h = bus_term
    for j, m_idx in enumerate(it.message):
        h = F.add(h, _times_ef(ev, nodes[m_idx], beta_pows[j]))
    return h


def acc_interactions(dag, ev: DeviceEvaluator, beta_pows, bus_terms, eq_3bs):
    """(numer, denom) EF tensors: numer = sum_s eq3b_s * count_s,
    denom = sum_s eq3b_s * h_beta_s (denominators exclude the alpha shift)."""
    nodes = _eval_nodes_device(dag, ev)
    numer = denom = None
    for s, it in enumerate(dag.interactions):
        n_term = _times_ef(ev, nodes[it.count], eq_3bs[s])
        d_term = F.ext_mul(_h_beta(ev, nodes, it, bus_terms[s], beta_pows), eq_3bs[s])
        numer = n_term if numer is None else F.add(numer, n_term)
        denom = d_term if denom is None else F.add(denom, d_term)
    return numer, denom


def interactions_pq(dag, ev: DeviceEvaluator, beta_pows, bus_terms):
    """Per-interaction (count, h_beta) tensors for the GKR input."""
    nodes = _eval_nodes_device(dag, ev)
    return [
        (nodes[it.count], _h_beta(ev, nodes, it, bus_terms[s], beta_pows))
        for s, it in enumerate(dag.interactions)
    ]
