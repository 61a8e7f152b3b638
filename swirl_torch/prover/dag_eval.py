"""Constraint-DAG evaluation over torch tensors (and single host points).

Peer of ``swirl/prover/dag_eval.py``. Base mode evaluates node values as
base-field tensors over the row batch (round 0, where trace values are base
field); ext mode as EF tensors (..., 4) (the multilinear rounds after
folding). A DAG of at least :data:`VECTORIZE_THRESHOLD` nodes runs through
the level-scheduled interpreter (:mod:`.dag_vectorized`), a smaller one node
by node, as in the reference. The host evaluator runs single EF points for
the verifier; the prover evaluates an exhausted trace's single folded point
on the device.

Ext mode's products and every weighted sum go through kernel L
(:mod:`~swirl_torch.fields.ef4`) on the card: a product is one launch, and a
weighted sum of the interpreter's values one launch that reads their buffer
rows in place; on the CPU their plain versions.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..fields import ext as hext
from ..fields.babybear import P
from ..symbolic import ConstraintsDag, eval_dag_nodes

from ..fields import ef4
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
        self.mul = ef4.mul if ext_mode else F.mul

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

    def eval_vars(self, entry: str, part: int, offset: int, indices):
        """The columns ``indices`` (a tensor) of one part at one row offset."""
        pair = self.preprocessed if entry == "preprocessed" else self.parts[part]
        return (pair[0] if offset == 0 else pair[1]).index_select(0, indices)

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


def _eval_nodes_device(dag: ConstraintsDag, ev):
    """Dispatch: node by node for small DAGs, the level-scheduled
    interpreter for large ones (its launches grow with depth, not size)."""
    if len(dag.nodes) >= VECTORIZE_THRESHOLD:
        return eval_dag_vectorized(dag, ev)
    return eval_dag_nodes(dag, ev)


def _times_ef(ev: DeviceEvaluator, value, weight):
    """node value (base or EF) times an EF weight (4,) -> EF."""
    return ef4.mul(value, weight) if ev.ext_mode else F.mul(value[..., None], weight)


def _weighted_sum_gather(nodes, indices, weights, ev: DeviceEvaluator):
    """sum_i weights[i] * nodes[indices[i]] by one
    :func:`~swirl_torch.fields.ef4.mul_sum`: over the interpreter's buffer
    rows in place, or over the stack of a node list's values. weights:
    (k, 4) EF, or more rows, of which the first k are read. -> (*batch, 4)."""
    weights = weights[: len(indices)]
    if isinstance(nodes, NodeValues):
        return ef4.mul_sum(nodes.buf, weights, index=nodes.positions(indices), ext=ev.ext_mode)
    shape = tuple(ev.batch_shape()) + ((4,) if ev.ext_mode else ())
    vals = [torch.broadcast_to(nodes[i], shape) for i in indices]
    vals = torch.stack(vals) if vals else torch.zeros((0,) + shape, dtype=F.DTYPE, device=ev.sels.device)
    return ef4.mul_sum(vals, weights, ext=ev.ext_mode)


def acc_constraints(dag: ConstraintsDag, ev: DeviceEvaluator, lambda_pows):
    """sum_i lambda^i * constraint_i as an EF tensor over the batch: one
    weighted sum of the constraints' node values."""
    if not dag.constraint_idx:
        return torch.zeros(tuple(ev.batch_shape()) + (4,), dtype=F.DTYPE, device=ev.sels.device)
    return _weighted_sum_gather(_eval_nodes_device(dag, ev), dag.constraint_idx, lambda_pows, ev)


def _h_beta(ev, nodes, it, bus_term, beta_pows):
    h = bus_term
    for j, m_idx in enumerate(it.message):
        h = F.add(h, _times_ef(ev, nodes[m_idx], beta_pows[j]))
    return h


def acc_interactions(dag, ev: DeviceEvaluator, beta_pows, bus_terms, eq_3bs):
    """(numer, denom) EF tensors: numer = sum_s eq3b_s * count_s,
    denom = sum_s eq3b_s * h_beta_s (denominators exclude the alpha shift).
    Each is one weighted sum over the interactions' nodes: h_beta_s =
    bus_s + sum_j beta^j * message_s[j], so denom = sum_s eq3b_s * bus_s
    + sum_(s, j) (eq3b_s * beta^j) * message_s[j], the same field values
    in launches that do not grow with the interaction count."""
    nodes = _eval_nodes_device(dag, ev)
    its = dag.interactions
    numer = _weighted_sum_gather(nodes, [it.count for it in its], eq_3bs, ev)
    msg = [m for it in its for m in it.message]
    terms = F.cached_const(
        ("interaction message terms", tuple(len(it.message) for it in its)),
        lambda: np.array([(s, j) for s, it in enumerate(its) for j in range(len(it.message))],
                         dtype=np.uint64).reshape(-1, 2),
        ev.sels.device,
    )
    weights = ef4.mul(eq_3bs.index_select(0, terms[:, 0]), beta_pows.index_select(0, terms[:, 1]))
    bus = ef4.mul_sum(bus_terms, eq_3bs)
    denom = F.add(_weighted_sum_gather(nodes, msg, weights, ev), bus)
    return numer, denom


def interactions_pq(dag, ev: DeviceEvaluator, beta_pows, bus_terms):
    """Per-interaction (count, h_beta) tensors for the GKR input."""
    nodes = _eval_nodes_device(dag, ev)
    return [
        (nodes[it.count], _h_beta(ev, nodes, it, bus_terms[s], beta_pows))
        for s, it in enumerate(dag.interactions)
    ]
