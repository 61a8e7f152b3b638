"""Lean 4 extraction of AIR constraints (with interactions) from symbolic
DAGs — the swirl peer of the reference's ``crates/stark-backend/src/lean/``
(``mod.rs`` module driver, ``render.rs`` expression renderer, ``columns.rs``
column-definition generator). A copy of ``swirl/lean_extraction.py`` on the
port's ``keygen`` and ``symbolic``: host Python, no tensors.

Produces standalone Lean 4 source against the ``LeanZKCircuit.OpenVM.Circuit``
abstraction:

- each AIR constraint becomes an ``@[simp] def constraint_i ... := <expr> = 0``
  over an abstract ``Circuit F ExtF C`` instance (render.rs:194-209);
- shared subexpressions are handled on two levels, driven by *direct use
  counts* over the deduplicated DAG (render.rs:218-266): multi-use compound
  nodes (>=2 uses, >=2 ops) are lifted into standalone ``def inter_k`` helper
  definitions emitted once per module (render.rs:495-529); everything else
  becomes per-definition ``let t_j`` bindings, deduplicated within each
  definition (render.rs:445-492);
- interactions are grouped by bus into one ``constrain_interactions``
  definition whose body branches on the bus index and flat-maps each row's
  ``(count, message)`` pairs over the trace rows (mod.rs:113-157,
  render.rs:268-326);
- small field constants near the characteristic render as negative literals
  for readability (render.rs:558-575);
- a commented "used columns" preamble lists every referenced trace column
  sorted by (entry kind, part, column, rotation) (render.rs:82-153).

The swirl renderer walks the interned :class:`~swirl_torch.symbolic.ConstraintsDag`
(node indices) where the reference walks ``Arc``-shared expression trees by
pointer; the interning already guarantees the sharing structure the reference
recovers via pointer identity.
"""

from __future__ import annotations

import io
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set, Tuple

from .fields.babybear import P
from .keygen import MultiStarkVerifyingKey, StarkVerifyingKey
from .symbolic import ConstraintsDag

# ---------------------------------------------------------------------------
# Air-name normalization (mod.rs:33-59)
# ---------------------------------------------------------------------------


def format_lean_air_name(air_name: str) -> str:
    """Normalize a (possibly generic) AIR name into a Lean identifier:
    ``<``/``,``/space -> ``_``, ``>`` dropped, runs of ``_`` collapsed,
    trailing ``_`` trimmed."""
    out: List[str] = []
    prev_underscore = False
    for ch in air_name:
        if ch == ">":
            continue
        if ch in "<, ":
            ch = "_"
        if ch == "_":
            if prev_underscore:
                continue
            prev_underscore = True
        else:
            prev_underscore = False
        out.append(ch)
    return "".join(out).rstrip("_")


# ---------------------------------------------------------------------------
# Column definitions (columns.rs) — the #[derive(LeanColumns)] analog
# ---------------------------------------------------------------------------


@dataclass
class LeanEntry:
    """One entry of an AIR's column struct: a named column, or a nested
    sub-AIR of a given width (columns.rs:1-12)."""

    name: str
    sub_air_type: Optional[str] = None
    width: int = 1

    @property
    def is_sub_air(self) -> bool:
        return self.sub_air_type is not None


def generate_lean_air_definition(air_name: str, entries: Sequence[LeanEntry]) -> str:
    """Render a ``#define_air`` block (columns.rs:20-42). AIR column structs
    declare their layout as a list of :class:`LeanEntry` (the duck-typed
    analog of ``#[derive(LeanColumns)]``: give the class a ``lean_columns()``
    returning the entry list and pass it here)."""
    lines = [f'#define_air "{air_name}" using "openvm_encapsulation" where']
    for e in entries:
        if e.is_sub_air:
            lines.append(
                f'  MainSubAir["{e.name}": "{e.sub_air_type}" width := {e.width}]'
            )
        else:
            lines.append(f'  Column["{e.name}"]')
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# Expression rendering (render.rs)
# ---------------------------------------------------------------------------

_SEL_LEAN = {
    "is_first_row": "(Circuit.isFirstRow c row)",
    "is_last_row": "(Circuit.isLastRow c row)",
    "is_transition": "(Circuit.isTransitionRow c row)",
}

_ENTRY_ORDER = {"preprocessed": 0, "main": 1, "public": 2, "challenge": 3}

_COMPOUND = {"add": "+", "sub": "-", "mul": "*", "neg": None}


def indent_block(text: str, indent: str) -> str:
    return "\n".join(indent + line for line in text.split("\n"))


def _leaf_to_lean(node: tuple, scoping: str, characteristic: Optional[int]) -> str:
    tag = node[0]
    if tag == "sel":
        return scoping + _SEL_LEAN[node[1]]
    if tag == "var":
        _, entry, part, offset, index = node
        if entry == "preprocessed":
            body = (
                f"(Circuit.preprocessed c (column := {index}) (row := row) "
                f"(rotation := {offset}))"
            )
        elif entry == "main":
            body = (
                f"(Circuit.main c (id := {part}) (column := {index}) "
                f"(row := row) (rotation := {offset}))"
            )
        elif entry == "public":
            body = f"(Circuit.public c (index := {index}))"
        elif entry == "challenge":
            body = f"(Circuit.challenge c (index := {index}))"
        else:
            raise ValueError(f"unknown var entry {entry!r}")
        return scoping + body
    if tag == "const":
        num = int(node[1])
        if characteristic is not None and 0 < characteristic - num < num:
            return f"-{characteristic - num}"
        return str(num)
    raise ValueError(f"not a leaf node: {node!r}")


@dataclass
class _Rendered:
    """A rendered subexpression: ``let`` bindings plus the result atom
    (render.rs:161-178)."""

    bindings: List[Tuple[str, str]]
    result: str
    op_count: int

    def into_block(self, tail: str = "") -> str:
        lines = [f"let {name} := {expr}" for name, expr in self.bindings]
        lines.append(self.result + tail)
        return "\n".join(lines)


def _merge_bindings(
    into: List[Tuple[str, str]], extra: List[Tuple[str, str]]
) -> None:
    seen = {name for name, _ in into}
    for name, expr in extra:
        if name not in seen:
            seen.add(name)
            into.append((name, expr))


@dataclass
class LeanRenderContext:
    """Shared per-module renderer state: temp/intermediate counters, emitted
    helper defs, and the DAG use counts (render.rs:180-192)."""

    use_counts: Dict[int, int] = field(default_factory=dict)
    next_temp_idx: int = 0
    next_intermediate_idx: int = 0
    helper_names: Dict[int, str] = field(default_factory=dict)
    emitted_helpers: Set[int] = field(default_factory=set)


def dag_use_counts(dag: ConstraintsDag) -> Dict[int, int]:
    """Direct parent-edge counts for every node reachable from the
    constraints and interactions (render.rs:233-266). Root references
    (constraint/count/message slots) do not count as uses."""
    counts: Dict[int, int] = {}
    visited: Set[int] = set()
    roots = list(dag.constraint_idx)
    for it in dag.interactions:
        roots.append(it.count)
        roots.extend(it.message)
    stack = list(roots)
    while stack:
        idx = stack.pop()
        if idx in visited:
            continue
        visited.add(idx)
        node = dag.nodes[idx]
        tag = node[0]
        if tag in ("add", "sub", "mul"):
            for child in (node[1], node[2]):
                counts[child] = counts.get(child, 0) + 1
                stack.append(child)
        elif tag == "neg":
            counts[node[1]] = counts.get(node[1], 0) + 1
            stack.append(node[1])
    return counts


_DEF_SIG = (
    "{C : Type → Type → Type} {F ExtF : Type} [Field F] [Field ExtF] "
    "[Circuit F ExtF C] (c : C F ExtF) (row: ℕ)"
)


def _render_node(
    dag: ConstraintsDag,
    root: int,
    scoping: str,
    characteristic: Optional[int],
    ctx: LeanRenderContext,
) -> Tuple[List[str], _Rendered]:
    """Render one expression root to bindings + result, lifting multi-use
    compound subexpressions into module-level helper defs
    (render.rs:328-443, 495-529). The memo is per call: the same shared node
    referenced from two *definitions* re-renders (or resolves to its helper),
    exactly like the reference's per-call ``rendered`` map."""
    helper_defs: List[str] = []
    memo: Dict[int, _Rendered] = {}

    def visit(idx: int, is_root: bool) -> _Rendered:
        if idx in memo:
            return memo[idx]
        node = dag.nodes[idx]
        tag = node[0]
        if tag not in _COMPOUND:
            r = _Rendered([], _leaf_to_lean(node, scoping, characteristic), 0)
            memo[idx] = r
            return r
        if tag == "neg":
            inner = visit(node[1], False)
            bindings = list(inner.bindings)
            name = f"t{ctx.next_temp_idx}"
            ctx.next_temp_idx += 1
            bindings.append((name, f"-({inner.result})"))
            cur = _Rendered(bindings, name, inner.op_count + 1)
        else:
            lhs = visit(node[1], False)
            rhs = visit(node[2], False)
            bindings = list(lhs.bindings)
            _merge_bindings(bindings, rhs.bindings)
            name = f"t{ctx.next_temp_idx}"
            ctx.next_temp_idx += 1
            bindings.append(
                (name, f"({lhs.result} {_COMPOUND[tag]} {rhs.result})")
            )
            cur = _Rendered(bindings, name, lhs.op_count + rhs.op_count + 1)
        cur = _maybe_lift(idx, is_root, cur)
        memo[idx] = cur
        return cur

    def _maybe_lift(idx: int, is_root: bool, cur: _Rendered) -> _Rendered:
        if is_root or cur.op_count <= 1 or ctx.use_counts.get(idx, 0) <= 1:
            return cur
        name = ctx.helper_names.get(idx)
        if name is None:
            name = f"inter_{ctx.next_intermediate_idx}"
            ctx.next_intermediate_idx += 1
            ctx.helper_names[idx] = name
        if idx not in ctx.emitted_helpers:
            ctx.emitted_helpers.add(idx)
            helper_defs.append(
                f"  def {name} {_DEF_SIG} :=\n"
                + indent_block(cur.into_block(), "    ")
                + "\n"
            )
        return _Rendered([], f"{scoping}{name} c row", cur.op_count)

    result = visit(root, True)
    return helper_defs, result


def constraint_to_lean_definition(
    dag: ConstraintsDag,
    root: int,
    constraint_idx: int,
    scoping: str,
    characteristic: Optional[int],
    ctx: LeanRenderContext,
) -> Tuple[List[str], str]:
    """One ``@[simp] def constraint_i ... := <expr> = 0`` definition
    (render.rs:194-209)."""
    helper_defs, rendered = _render_node(dag, root, scoping, characteristic, ctx)
    body = indent_block(rendered.into_block(" = 0"), "    ")
    text = f"  @[simp]\n  def constraint_{constraint_idx} {_DEF_SIG} :=\n{body}\n"
    return helper_defs, text


def interaction_bus_to_lean(
    dag: ConstraintsDag,
    interactions: Sequence,
    scoping: str,
    characteristic: Optional[int],
    ctx: LeanRenderContext,
) -> Tuple[List[str], str]:
    """All of one bus's interactions as a flat-mapped per-row list of
    ``(count, [message...])`` pairs (render.rs:268-326)."""
    helper_defs: List[str] = []
    row_bindings: List[Tuple[str, str]] = []
    row_items: List[str] = []
    for it in interactions:
        hd, count_r = _render_node(dag, it.count, scoping, characteristic, ctx)
        helper_defs.extend(hd)
        _merge_bindings(row_bindings, count_r.bindings)
        msg_items = []
        for m in it.message:
            hd, mr = _render_node(dag, m, scoping, characteristic, ctx)
            helper_defs.extend(hd)
            _merge_bindings(row_bindings, mr.bindings)
            msg_items.append(mr.result)
        row_items.append(f"({count_r.result}, [{', '.join(msg_items)}])")
    body = _Rendered(row_bindings, f"[{', '.join(row_items)}]", 0).into_block()
    text = (
        "(List.range (Circuit.last_row c + 1)).flatMap (λ row =>\n"
        + indent_block(body, "  ")
        + ")"
    )
    return helper_defs, text


# ---------------------------------------------------------------------------
# Used-column preamble (render.rs:82-153)
# ---------------------------------------------------------------------------


def placeholder_column_names(dag: ConstraintsDag) -> str:
    """Commented list of every referenced column/public/challenge slot,
    sorted by (entry kind, part, column index, rotation)."""
    leaves: Set[tuple] = set()
    visited: Set[int] = set()
    roots = list(dag.constraint_idx)
    for it in dag.interactions:
        roots.append(it.count)
        roots.extend(it.message)
    stack = list(roots)
    while stack:
        idx = stack.pop()
        if idx in visited:
            continue
        visited.add(idx)
        node = dag.nodes[idx]
        tag = node[0]
        if tag == "var":
            leaves.add(node[1:])
        elif tag in ("add", "sub", "mul"):
            stack.extend((node[1], node[2]))
        elif tag == "neg":
            stack.append(node[1])

    def sort_key(leaf):
        entry, part, offset, index = leaf
        return (_ENTRY_ORDER[entry], part, index, offset)

    lines = []
    for entry, part, offset, index in sorted(leaves, key=sort_key):
        if entry == "preprocessed":
            lines.append(
                f"--def Circuit._ (c: Circuit F ExtF) (row: N) := "
                f"c.preprocessed (column := {index}) (row := row) "
                f"(rotation := {offset})"
            )
        elif entry == "main":
            lines.append(
                f"--def Circuit._ (c: Circuit F ExtF) (row: N) := "
                f"c.main (id := {part}) (column := {index}) (row := row) "
                f"(rotation := {offset})"
            )
        elif entry == "public":
            lines.append(
                f"--def Circuit._ (c: Circuit F ExtF) := c.public (index := {index})"
            )
        else:
            lines.append(
                f"--def Circuit._ (c: Circuit F ExtF) := "
                f"c.challenge (index := {index})"
            )
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# Module driver (mod.rs:62-163)
# ---------------------------------------------------------------------------


def extract_constraints_to_lean(
    dag: ConstraintsDag,
    air_name: str,
    characteristic: Optional[int] = P,
) -> str:
    """Full standalone Lean 4 module for one AIR's constraint DAG."""
    out = io.StringIO()
    lean_name = format_lean_air_name(air_name)
    w = out.write
    w("import Mathlib.Algebra.Field.Basic\n\n")
    w("import LeanZKCircuit.OpenVM.Circuit\n\n")
    w("set_option linter.all false\n\n")
    w(f"register_simp_attr {lean_name}_air_simplification\n")
    w(
        f"register_simp_attr "
        f"{lean_name}_constraint_and_interaction_simplification\n\n"
    )
    w(f"namespace {lean_name}.extraction\n\n")
    w(f"-----Constraints for {air_name}-----\n\n")
    w("-----Used Columns-------------------\n")
    w(placeholder_column_names(dag) + "\n\n")
    w("-----Extracted constraints----------\n")

    ctx = LeanRenderContext(use_counts=dag_use_counts(dag))
    helper_defs: List[str] = []
    constraint_defs: List[str] = []
    for i, root in enumerate(dag.constraint_idx):
        hd, text = constraint_to_lean_definition(
            dag, root, i, "", characteristic, ctx
        )
        helper_defs.extend(hd)
        constraint_defs.append(text)

    by_bus: Dict[int, list] = {}
    for it in dag.interactions:
        by_bus.setdefault(it.bus_index, []).append(it)
    branches = []
    for i, bus in enumerate(sorted(by_bus)):
        hd, expr = interaction_bus_to_lean(
            dag, by_bus[bus], "", characteristic, ctx
        )
        helper_defs.extend(hd)
        prefix = "" if i == 0 else "else "
        branches.append(
            f"      {prefix}if index = {bus} then\n"
            + indent_block(expr, "        ")
        )

    for hd in helper_defs:
        w(hd + "\n")
    for cd in constraint_defs:
        w(cd + "\n")

    w(
        "  def constrain_interactions {C : Type → Type → Type} "
        "{F ExtF : Type} [Field F] [Field ExtF] [Circuit F ExtF C] "
        "(c : C F ExtF) :=\n"
    )
    w("    Circuit.buses c = λ index =>\n")
    for b in branches:
        w(b + "\n")
    w("    []\n" if not by_bus else "    else []\n")
    w(f"\nend {lean_name}.extraction\n")
    w("------\n")
    return out.getvalue()


def render_air(name: str, vk: StarkVerifyingKey) -> str:
    """One AIR of a vk -> Lean module (vk-driven entry point)."""
    return extract_constraints_to_lean(vk.symbolic_constraints, name)


def render_vk(mvk: MultiStarkVerifyingKey, air_names: List[str]) -> str:
    """Every AIR of a multi-STARK vk, concatenated — standalone Lean codegen
    from a serialized verifying key (mod.rs:1-3)."""
    return "\n".join(
        render_air(name, vk) for name, vk in zip(air_names, mvk.per_air)
    )
