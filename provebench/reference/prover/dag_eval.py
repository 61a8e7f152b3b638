"""The verifier's constraint evaluation at one point: the host half of
``swirl_torch/prover/dag_eval.py`` (:class:`HostEvaluator`,
:func:`eval_nodes`), frozen with the rest of this package."""

from __future__ import annotations

from ..fields import ext as hext
from ..symbolic import ConstraintsDag, eval_dag_nodes

_SELECTORS = {"is_first_row": 0, "is_transition": 1, "is_last_row": 2}


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
