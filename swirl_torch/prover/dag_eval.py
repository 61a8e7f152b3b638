"""Constraint-DAG evaluation over torch tensors (and single host points).

Peer of ``swirl/prover/dag_eval.py``: one per-node evaluator. Base mode
evaluates node values as base-field tensors over the row batch (round 0,
where trace values are base field); ext mode as EF tensors (..., 4) (the
multilinear rounds after folding). The host evaluator runs single EF points
for the prover's exhausted-trace tail.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from ..fields import ext as hext
from ..fields.babybear import P
from ..symbolic import ConstraintsDag, eval_dag_nodes

from ..fields import field as F

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
        v = torch.tensor(int(c) % P, dtype=F.DTYPE, device=self.sels.device)
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


def _times_ef(ev: DeviceEvaluator, value, weight):
    """node value (base or EF) times an EF weight (4,) -> EF."""
    return F.ext_mul(value, weight) if ev.ext_mode else F.mul(value[..., None], weight)


def acc_constraints(dag: ConstraintsDag, ev: DeviceEvaluator, lambda_pows):
    """sum_i lambda^i * constraint_i as an EF tensor over the batch."""
    acc = torch.zeros(tuple(ev.batch_shape()) + (4,), dtype=F.DTYPE, device=ev.sels.device)
    if not dag.constraint_idx:
        return acc
    nodes = eval_dag_nodes(dag, ev)
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
    nodes = eval_dag_nodes(dag, ev)
    numer = denom = None
    for s, it in enumerate(dag.interactions):
        n_term = _times_ef(ev, nodes[it.count], eq_3bs[s])
        d_term = F.ext_mul(_h_beta(ev, nodes, it, bus_terms[s], beta_pows), eq_3bs[s])
        numer = n_term if numer is None else F.add(numer, n_term)
        denom = d_term if denom is None else F.add(denom, d_term)
    return numer, denom


def interactions_pq(dag, ev: DeviceEvaluator, beta_pows, bus_terms):
    """Per-interaction (count, h_beta) tensors for the GKR input."""
    nodes = eval_dag_nodes(dag, ev)
    return [
        (nodes[it.count], _h_beta(ev, nodes, it, bus_terms[s], beta_pows))
        for s, it in enumerate(dag.interactions)
    ]


def acc_constraints_host(dag: ConstraintsDag, ev: HostEvaluator, lambda_pows):
    nodes = eval_dag_nodes(dag, ev)
    acc = hext.ezero()
    for i, idx in enumerate(dag.constraint_idx):
        acc = hext.eadd(acc, hext.emul(nodes[idx], lambda_pows[i]))
    return acc


def acc_interactions_host(dag: ConstraintsDag, ev: HostEvaluator, beta_pows, eq_3bs):
    nodes = eval_dag_nodes(dag, ev)
    numer = hext.ezero()
    denom = hext.ezero()
    for s, it in enumerate(dag.interactions):
        h_beta = hext.escale(beta_pows[len(it.message)], (it.bus_index + 1) % P)
        for j, m_idx in enumerate(it.message):
            h_beta = hext.eadd(h_beta, hext.emul(beta_pows[j], nodes[m_idx]))
        numer = hext.eadd(numer, hext.emul(eq_3bs[s], nodes[it.count]))
        denom = hext.eadd(denom, hext.emul(eq_3bs[s], h_beta))
    return numer, denom
