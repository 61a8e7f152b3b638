"""Monomial expansion of constraint DAGs and a monomial-basis evaluator.

Peer of ``swirl/prover/monomial.py``. The reference prover ships two
constraint-evaluation engines and picks one per AIR: the DAG bytecode
interpreter and an expanded-monomial kernel (``cuda-backend/src/pkey.rs:26-60``,
``src/monomial.rs:19``, ``cuda/src/batch_mle_monomial.cu``). Each constraint
is expanded on the host into a sparse sum of monomials ``coeff * prod(vars)``
over the leaf variables (trace cells, selectors); expansion aborts past
``MAX_MONOMIALS`` terms in any intermediate, and the caller keeps the DAG
interpreter.

The evaluator runs as whole-stack tensor ops, so its launches do not grow
with the monomial count: the leaves are gathered once (one gather a trace
part and row offset, as the interpreter's leaf buffer is written); for each
degree d an (M_d, d) table of leaf ids is gathered column by column and
multiplied (d - 1 products over the stack), scaled by the coefficients and
added into its constraint by one ``index_add``; the lambda-weighted sum of
the constraints is one weighted sum. Stacks are taken in groups of at most
``TERM_CHUNK_ELEMS`` elements, which changes no value: field sums do not
depend on their order. Neither package picks an engine per AIR, so the
prover keeps the interpreter and this module stands beside it.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..fields import field as F
from ..fields.babybear import P
from ..symbolic import ConstraintsDag
from .dag_eval import TERM_CHUNK_ELEMS, DeviceEvaluator
from .dag_vectorized import DagSchedule

MAX_MONOMIALS = 4096

# a monomial: coefficient (int mod P) and a sorted tuple of leaf ids
Monomial = Tuple[int, Tuple[int, ...]]
# a polynomial: map from var-tuple to coefficient
Poly = Dict[Tuple[int, ...], int]


class MonomialBlowup(Exception):
    """Expansion exceeded MAX_MONOMIALS — use the DAG interpreter instead."""


def _padd(a: Poly, b: Poly) -> Poly:
    out = dict(a)
    for k, v in b.items():
        nv = (out.get(k, 0) + v) % P
        if nv:
            out[k] = nv
        elif k in out:
            del out[k]
    if len(out) > MAX_MONOMIALS:
        raise MonomialBlowup()
    return out


def _pneg(a: Poly) -> Poly:
    return {k: (P - v) % P for k, v in a.items() if v}


def _pmul(a: Poly, b: Poly) -> Poly:
    out: Poly = {}
    for ka, va in a.items():
        for kb, vb in b.items():
            k = tuple(sorted(ka + kb))
            nv = (out.get(k, 0) + va * vb) % P
            if nv:
                out[k] = nv
            elif k in out:
                del out[k]
            if len(out) > MAX_MONOMIALS:
                raise MonomialBlowup()
    return out


@dataclass
class ExpandedConstraints:
    """Per-constraint monomial lists over leaf ids; ``leaves[i]`` is the
    original DAG node tuple ("var", ...) or ("sel", ...)."""

    leaves: List[tuple]
    # per constraint: list of (coeff, leaf-id tuple)
    constraints: List[List[Monomial]]
    _device: Dict = field(default_factory=dict, repr=False, compare=False)

    def num_monomials(self) -> int:
        return sum(len(c) for c in self.constraints)

    def tables(self, device) -> "_Tables":
        """The evaluator's index tensors on ``device``, made at the first call."""
        device = torch.device(device)
        if device not in self._device:
            self._device[device] = _Tables.build(self, device)
        return self._device[device]


def expand_monomials(dag: ConstraintsDag) -> ExpandedConstraints:
    """Expand every constraint polynomial into monomial form.

    Raises :class:`MonomialBlowup` when any intermediate exceeds
    ``MAX_MONOMIALS`` terms.
    """
    leaves: List[tuple] = []
    leaf_ids: Dict[tuple, int] = {}

    def leaf(node: tuple) -> int:
        if node not in leaf_ids:
            leaf_ids[node] = len(leaves)
            leaves.append(node)
        return leaf_ids[node]

    polys: List[Poly] = []
    for n in dag.nodes:
        tag = n[0]
        if tag == "const":
            c = int(n[1]) % P
            polys.append({(): c} if c else {})
        elif tag in ("var", "sel"):
            polys.append({(leaf(n),): 1})
        elif tag == "add":
            polys.append(_padd(polys[n[1]], polys[n[2]]))
        elif tag == "sub":
            polys.append(_padd(polys[n[1]], _pneg(polys[n[2]])))
        elif tag == "neg":
            polys.append(_pneg(polys[n[1]]))
        elif tag == "mul":
            polys.append(_pmul(polys[n[1]], polys[n[2]]))
        else:  # pragma: no cover
            raise ValueError(f"unknown node tag {tag}")
    constraints = [
        sorted(((v, k) for k, v in polys[i].items()), key=lambda m: m[1])
        for i in dag.constraint_idx
    ]
    return ExpandedConstraints(leaves=leaves, constraints=constraints)


@dataclass
class _Tables:
    """Device form of an expansion: the leaves' groups (a DagSchedule over
    the leaves, whose ``leaf_groups`` the interpreter's leaf buffer uses),
    each degree's (leaf ids (M_d, d), coefficients (M_d,), constraint of
    each monomial (M_d,)), and the constant terms by constraint (None if
    every one is zero)."""

    leaves: DagSchedule
    by_degree: List[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]
    constants: Optional[torch.Tensor]

    @staticmethod
    def build(expanded: ExpandedConstraints, device) -> "_Tables":
        rows: Dict[int, List[Tuple[int, Tuple[int, ...], int]]] = {}
        constants = np.zeros(len(expanded.constraints), dtype=np.int64)
        for ci, monos in enumerate(expanded.constraints):
            for coeff, var_ids in monos:
                if var_ids:
                    rows.setdefault(len(var_ids), []).append((coeff, var_ids, ci))
                else:
                    constants[ci] = (int(constants[ci]) + coeff) % P
        by_degree = []
        for d in sorted(rows):
            ms = rows[d]
            by_degree.append(tuple(
                torch.as_tensor(np.array(a, dtype=np.int64), device=device)
                for a in ([m[1] for m in ms], [m[0] for m in ms], [m[2] for m in ms])
            ))
        sched = DagSchedule(leaf_kinds=list(expanded.leaves), levels=[], keeps=[], out_pos={}, max_live=0)
        const = torch.as_tensor(constants, device=device) if constants.any() else None
        return _Tables(sched, by_degree, const)


def _leaf_values(tables: _Tables, ev: DeviceEvaluator, shape) -> torch.Tensor:
    """(num_leaves, *shape) values of the leaves, a gather a trace part and
    row offset, a copy a selector or public value."""
    device = ev.sels.device
    buf = torch.empty((len(tables.leaves.leaf_kinds),) + tuple(shape), dtype=F.DTYPE, device=device)
    for key, pos, cols in tables.leaves.leaf_groups(device):
        if key[0] == "var":
            v = ev.eval_vars(key[1], key[2], key[3], cols)
        elif key[0] == "sel":
            v = ev.eval_sel(key[1])[None]
        else:  # a public value: a constant, broadcast over the batch
            v = ev.eval_var(*key[1:]).expand(shape)[None]
        buf.index_put_((pos,), v)
    return buf


def _group(batch_elems: int) -> int:
    return max(1, TERM_CHUNK_ELEMS // max(batch_elems, 1))


def acc_constraints_monomial(expanded: ExpandedConstraints, ev: DeviceEvaluator, lambda_pows):
    """sum_i lambda^i * constraint_i through the monomial form: an EF tensor
    (*batch, 4) on the evaluator's device, equal bit for bit to
    :func:`swirl_torch.prover.dag_eval.acc_constraints` (the interpreter).
    ``lambda_pows``: (num_constraints, 4) EF tensor on that device."""
    batch = tuple(ev.batch_shape())
    shape = batch + ((4,) if ev.ext_mode else ())
    device = ev.sels.device
    k = len(expanded.constraints)
    if k == 0:
        return torch.zeros(batch + (4,), dtype=F.DTYPE, device=device)
    tables = expanded.tables(device)
    elems = torch.Size(shape).numel()
    cons = torch.zeros((k,) + shape, dtype=F.DTYPE, device=device)
    if tables.by_degree:
        leaves = _leaf_values(tables, ev, shape)
        group = _group(elems)
        for ids, coeffs, owner in tables.by_degree:
            for g in range(0, len(ids), group):
                cols = ids[g : g + group]
                term = leaves.index_select(0, cols[:, 0])
                for j in range(1, cols.shape[1]):
                    term = ev.mul(term, leaves.index_select(0, cols[:, j]))
                c = coeffs[g : g + group].reshape((-1,) + (1,) * len(shape))
                # each term is below P: index_add sums up to 2^32 of them in int64
                cons.index_add_(0, owner[g : g + group], F.mul(term, c))
                del term
        del leaves
    if tables.constants is not None:
        const = tables.constants.reshape((k,) + (1,) * len(batch))
        if ev.ext_mode:
            cons[..., 0] += const
        else:
            cons += const
    cons %= P
    acc = torch.zeros(batch + (4,), dtype=F.DTYPE, device=device)
    group = _group(4 * torch.Size(batch).numel())
    for g in range(0, k, group):
        vals = cons[g : g + group]
        w = lambda_pows[g : g + len(vals)].reshape((len(vals),) + (1,) * len(batch) + (4,))
        acc = acc + (F.ext_mul(vals, w) if ev.ext_mode else F.mul(vals[..., None], w)).sum(0)
    return acc % P
