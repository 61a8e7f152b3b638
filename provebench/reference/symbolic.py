"""Symbolic AIR constraint capture.

An AIR's ``eval`` runs once at keygen on symbolic variables; the recorded
expressions become a deduplicated, topologically ordered DAG that is (a)
hashed into the verifying key, (b) interpreted by the verifier at the
opening point, and (c) lowered by the prover into fused JAX computations
over row batches (the TPU-native analog of the reference's GPU-bytecode
rules compiler, ``cuda-backend/src/pkey.rs:26``).

Mirrors the semantics of the reference's symbolic builder
(``crates/stark-backend/src/air_builders/symbolic/``): entries address the
preprocessed trace, partitioned main parts (cached parts first, common main
last) and public values; row offset 0/1 selects the local/rotated row.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple, Union

from .fields.babybear import P

# ---------------------------------------------------------------------------
# Expressions
# ---------------------------------------------------------------------------

ExprLike = Union["Expr", int]


def _wrap(x: ExprLike) -> "Expr":
    if isinstance(x, Expr):
        return x
    return Constant(int(x) % P)


class Expr:
    """Base symbolic expression with operator overloading."""

    degree: int

    def __add__(self, other: ExprLike) -> "Expr":
        return Add(self, _wrap(other))

    def __radd__(self, other: ExprLike) -> "Expr":
        return Add(_wrap(other), self)

    def __sub__(self, other: ExprLike) -> "Expr":
        return Sub(self, _wrap(other))

    def __rsub__(self, other: ExprLike) -> "Expr":
        return Sub(_wrap(other), self)

    def __mul__(self, other: ExprLike) -> "Expr":
        return Mul(self, _wrap(other))

    def __rmul__(self, other: ExprLike) -> "Expr":
        return Mul(_wrap(other), self)

    def __neg__(self) -> "Expr":
        return Neg(self)


class Constant(Expr):
    __slots__ = ("value", "degree")

    def __init__(self, value: int):
        self.value = int(value) % P
        self.degree = 0


class Var(Expr):
    """Trace/public variable. entry in {"preprocessed", "main", "public"};
    for main, ``part`` indexes [cached_0, ..., cached_{m-1}, common]."""

    __slots__ = ("entry", "part", "offset", "index", "degree")

    def __init__(self, entry: str, index: int, part: int = 0, offset: int = 0):
        assert entry in ("preprocessed", "main", "public")
        self.entry = entry
        self.part = part
        self.offset = offset
        self.index = index
        self.degree = 1 if entry in ("preprocessed", "main") else 0


class Selector(Expr):
    __slots__ = ("kind", "degree")

    def __init__(self, kind: str):
        assert kind in ("is_first_row", "is_last_row", "is_transition")
        self.kind = kind
        self.degree = 1


class Add(Expr):
    __slots__ = ("x", "y", "degree")

    def __init__(self, x: Expr, y: Expr):
        self.x, self.y = x, y
        self.degree = max(x.degree, y.degree)


class Sub(Expr):
    __slots__ = ("x", "y", "degree")

    def __init__(self, x: Expr, y: Expr):
        self.x, self.y = x, y
        self.degree = max(x.degree, y.degree)


class Neg(Expr):
    __slots__ = ("x", "degree")

    def __init__(self, x: Expr):
        self.x = x
        self.degree = x.degree


class Mul(Expr):
    __slots__ = ("x", "y", "degree")

    def __init__(self, x: Expr, y: Expr):
        self.x, self.y = x, y
        self.degree = x.degree + y.degree


# ---------------------------------------------------------------------------
# Interactions
# ---------------------------------------------------------------------------


@dataclass
class Interaction:
    """LogUp bus interaction; ``message``/``count`` reference either Expr
    (pre-DAG) or node indices (post-DAG)."""

    message: list
    count: object
    bus_index: int
    count_weight: int


# ---------------------------------------------------------------------------
# DAG (deduplicated, topo-sorted node list)
# ---------------------------------------------------------------------------

# Node encodings (tuples are hashable for interning):
#   ("const", value)
#   ("var", entry, part, offset, index)
#   ("sel", kind)
#   ("add"|"sub"|"mul", left_idx, right_idx, degree)
#   ("neg", idx, degree)

Node = Tuple


@dataclass
class ConstraintsDag:
    nodes: List[Node]
    constraint_idx: List[int]
    interactions: List[Interaction]  # message/count as node indices

    def max_rotation(self) -> int:
        rot = 0
        for n in self.nodes:
            if n[0] == "var":
                rot = max(rot, n[3])
        return rot

    def num_constraints(self) -> int:
        return len(self.constraint_idx)

    def node_degrees(self) -> List[int]:
        degs = []
        for n in self.nodes:
            if n[0] == "const":
                degs.append(0)
            elif n[0] == "var":
                degs.append(1 if n[1] in ("preprocessed", "main") else 0)
            elif n[0] == "sel":
                degs.append(1)
            else:
                degs.append(n[-1])
        return degs

    def max_constraint_degree(self) -> int:
        degs = self.node_degrees()
        max_deg = 0
        for idx in self.constraint_idx:
            max_deg = max(max_deg, degs[idx])
        for it in self.interactions:
            max_deg = max(max_deg, degs[it.count])
            for m in it.message:
                max_deg = max(max_deg, degs[m])
        return max_deg

    def canonical_tuple(self):
        """Hashable canonical form, used for vk pre-hash serialization."""
        return (
            tuple(self.nodes),
            tuple(self.constraint_idx),
            tuple(
                (tuple(i.message), i.count, i.bus_index, i.count_weight)
                for i in self.interactions
            ),
        )


class DagBuilder:
    """Interning DAG builder with constant folding and identity
    simplifications (x+0, x*1, x*0, x-0, double negation)."""

    def __init__(self):
        self.nodes: List[Node] = []
        self._intern: Dict[Node, int] = {}
        self._memo: Dict[int, int] = {}  # id(expr) -> node idx

    def _push(self, node: Node) -> int:
        idx = self._intern.get(node)
        if idx is None:
            idx = len(self.nodes)
            self.nodes.append(node)
            self._intern[node] = idx
        return idx

    def _const_of(self, idx: int) -> Optional[int]:
        n = self.nodes[idx]
        return n[1] if n[0] == "const" else None

    def _degree(self, idx: int) -> int:
        n = self.nodes[idx]
        if n[0] == "const":
            return 0
        if n[0] == "var":
            return 1 if n[1] in ("preprocessed", "main") else 0
        if n[0] == "sel":
            return 1
        return n[-1]

    def add_expr(self, e: Expr) -> int:
        key = id(e)
        if key in self._memo:
            return self._memo[key]
        if isinstance(e, Constant):
            idx = self._push(("const", e.value))
        elif isinstance(e, Var):
            idx = self._push(("var", e.entry, e.part, e.offset, e.index))
        elif isinstance(e, Selector):
            idx = self._push(("sel", e.kind))
        elif isinstance(e, Neg):
            c_idx = self.add_expr(e.x)
            c = self._const_of(c_idx)
            if c is not None:
                idx = self._push(("const", (P - c) % P))
            else:
                idx = self._push(("neg", c_idx, self._degree(c_idx)))
        elif isinstance(e, (Add, Sub, Mul)):
            li = self.add_expr(e.x)
            ri = self.add_expr(e.y)
            lc, rc = self._const_of(li), self._const_of(ri)
            if isinstance(e, Add):
                if lc is not None and rc is not None:
                    idx = self._push(("const", (lc + rc) % P))
                elif lc == 0:
                    idx = ri
                elif rc == 0:
                    idx = li
                elif self.nodes[ri][0] == "neg":
                    idx = self._push(
                        ("sub", li, self.nodes[ri][1],
                         max(self._degree(li), self._degree(self.nodes[ri][1])))
                    )
                else:
                    idx = self._push(
                        ("add", li, ri, max(self._degree(li), self._degree(ri)))
                    )
            elif isinstance(e, Sub):
                if lc is not None and rc is not None:
                    idx = self._push(("const", (lc - rc) % P))
                elif rc == 0:
                    idx = li
                elif self.nodes[ri][0] == "neg":
                    idx = self._push(
                        ("add", li, self.nodes[ri][1],
                         max(self._degree(li), self._degree(self.nodes[ri][1])))
                    )
                else:
                    idx = self._push(
                        ("sub", li, ri, max(self._degree(li), self._degree(ri)))
                    )
            else:  # Mul
                if lc is not None and rc is not None:
                    idx = self._push(("const", (lc * rc) % P))
                elif lc == 0 or rc == 1:
                    idx = li
                elif rc == 0 or lc == 1:
                    idx = ri
                else:
                    idx = self._push(
                        ("mul", li, ri, self._degree(li) + self._degree(ri))
                    )
        else:
            raise TypeError(f"unknown expr {type(e)}")
        self._memo[key] = idx
        return idx


def build_dag(
    constraints: Sequence[Expr], interactions: Sequence[Interaction]
) -> ConstraintsDag:
    b = DagBuilder()
    cidx = sorted(set(b.add_expr(c) for c in constraints))
    dag_interactions = [
        Interaction(
            message=[b.add_expr(m) for m in it.message],
            count=b.add_expr(it.count),
            bus_index=it.bus_index,
            count_weight=it.count_weight,
        )
        for it in interactions
    ]
    return ConstraintsDag(nodes=b.nodes, constraint_idx=cidx, interactions=dag_interactions)


def eval_dag_nodes(dag: ConstraintsDag, evaluator) -> list:
    """Evaluate all nodes in topo order with a pluggable evaluator providing
    eval_const/eval_var/eval_sel and field ops add/sub/mul/neg."""
    out = []
    for n in dag.nodes:
        tag = n[0]
        if tag == "const":
            out.append(evaluator.eval_const(n[1]))
        elif tag == "var":
            out.append(evaluator.eval_var(n[1], n[2], n[3], n[4]))
        elif tag == "sel":
            out.append(evaluator.eval_sel(n[1]))
        elif tag == "add":
            out.append(evaluator.add(out[n[1]], out[n[2]]))
        elif tag == "sub":
            out.append(evaluator.sub(out[n[1]], out[n[2]]))
        elif tag == "neg":
            out.append(evaluator.neg(out[n[1]]))
        elif tag == "mul":
            out.append(evaluator.mul(out[n[1]], out[n[2]]))
        else:
            raise ValueError(tag)
    return out


# ---------------------------------------------------------------------------
# Symbolic builder (the AirBuilder the AIR's eval() runs against at keygen)
# ---------------------------------------------------------------------------


class RowView:
    """Two-row window of one trace part: .local / .next lists of Vars."""

    def __init__(self, entry: str, width: int, part: int = 0):
        self.local = [Var(entry, i, part=part, offset=0) for i in range(width)]
        self.next = [Var(entry, i, part=part, offset=1) for i in range(width)]

    def row(self, offset: int):
        return self.local if offset == 0 else self.next


class SymbolicAirBuilder:
    """Records constraints and interactions while an AIR evaluates.

    Main parts are ordered [cached_0, ..., cached_{m-1}, common]; this is the
    same part indexing the prover and verifier use.
    """

    def __init__(
        self,
        preprocessed_width: Optional[int],
        cached_widths: Sequence[int],
        common_width: int,
        num_public_values: int,
    ):
        self.preprocessed = (
            RowView("preprocessed", preprocessed_width)
            if preprocessed_width
            else None
        )
        parts = list(cached_widths) + [common_width]
        self.partitioned_main = [
            RowView("main", w, part=i) for i, w in enumerate(parts)
        ]
        self.common_main = self.partitioned_main[-1]
        self.cached_mains = self.partitioned_main[:-1]
        self.public_values = [Var("public", i) for i in range(num_public_values)]
        self.is_first_row = Selector("is_first_row")
        self.is_last_row = Selector("is_last_row")
        self.is_transition = Selector("is_transition")
        self.constraints: List[Expr] = []
        self.interactions: List[Interaction] = []

    # -- assertion API ------------------------------------------------------

    def assert_zero(self, x: ExprLike) -> None:
        self.constraints.append(_wrap(x))

    def assert_eq(self, x: ExprLike, y: ExprLike) -> None:
        self.assert_zero(_wrap(x) - _wrap(y))

    def assert_one(self, x: ExprLike) -> None:
        self.assert_eq(x, 1)

    def assert_bool(self, x: ExprLike) -> None:
        x = _wrap(x)
        self.assert_zero(x * (x - 1))

    def assert_tern(self, x: ExprLike) -> None:
        x = _wrap(x)
        self.assert_zero(x * (x - 1) * (x - 2))

    def when(self, condition: ExprLike) -> "FilteredBuilder":
        return FilteredBuilder(self, _wrap(condition))

    def when_first_row(self) -> "FilteredBuilder":
        return self.when(self.is_first_row)

    def when_last_row(self) -> "FilteredBuilder":
        return self.when(self.is_last_row)

    def when_transition(self) -> "FilteredBuilder":
        return self.when(self.is_transition)

    # -- interactions (LogUp bus API) ---------------------------------------

    def push_interaction(
        self, bus_index: int, fields, count: ExprLike, count_weight: int
    ) -> None:
        msg = [_wrap(f) for f in fields]
        self.interactions.append(
            Interaction(msg, _wrap(count), int(bus_index), int(count_weight))
        )

    def num_interactions(self) -> int:
        return len(self.interactions)

    # -- output --------------------------------------------------------------

    def build_dag(self) -> ConstraintsDag:
        return build_dag(self.constraints, self.interactions)


class FilteredBuilder:
    """`when(cond)` wrapper multiplying asserted expressions by cond."""

    def __init__(self, inner, condition: Expr):
        self._inner = inner
        self._cond = condition

    def assert_zero(self, x: ExprLike) -> None:
        self._inner.assert_zero(self._cond * _wrap(x))

    def assert_eq(self, x: ExprLike, y: ExprLike) -> None:
        self.assert_zero(_wrap(x) - _wrap(y))

    def assert_one(self, x: ExprLike) -> None:
        self.assert_eq(x, 1)

    def assert_bool(self, x: ExprLike) -> None:
        x = _wrap(x)
        self.assert_zero(x * (x - 1))

    def when(self, condition: ExprLike) -> "FilteredBuilder":
        return FilteredBuilder(self._inner, self._cond * _wrap(condition))


# ---------------------------------------------------------------------------
# LogUp bus wrappers (cf. reference ``interaction/mod.rs:74``)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class LookupBus:
    index: int

    def lookup_key(self, builder, query, enabled) -> None:
        builder.push_interaction(self.index, query, enabled, 1)

    def add_key_with_lookups(self, builder, key, num_lookups) -> None:
        builder.push_interaction(self.index, key, -_wrap(num_lookups), 0)
