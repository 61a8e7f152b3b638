"""Postcard serialization of the pre-verifying-key (vk pre-hash parity).

The reference protects against weak Fiat-Shamir by hashing the
"pre"-verifying key (``MultiStarkVerifyingKey0``) into every transcript
(``keygen/mod.rs:193-216``). That hash is computed over a **postcard**
(serde) serialization — not the byte codec — framed as::

    CODEC_VERSION (4 bytes LE) ++ len(vk_bytes) as u64 LE ++ vk_bytes

with every byte mapped to a BabyBear element (``F::from_u8``) and absorbed
through the native ``hash_slice``.

This module emulates postcard's wire format for the exact struct tree:

- postcard primitives: bool/u8 = 1 byte; u16/u32/u64/usize = unsigned
  LEB128 varint; isize = zigzag varint; Option = 0x00/0x01 + payload;
  Vec = varint length + items; struct = fields in order; [T; N] = N items;
  enum = varint discriminant + payload; PhantomData = nothing.
- Plonky3 ``MontyField31`` (BabyBear) serde writes the **Montgomery form**
  as u32 ("it's faster to serialize in monty form" — p3 monty-31); so a
  field element is varint(x * 2^32 mod p).

Struct tree (field orders from the reference sources):

- ``MultiStarkVerifyingKey0`` = { params: SystemParams, per_air:
  Vec<StarkVerifyingKey>, trace_height_constraints: Vec<LinearConstraint> }
  (``keygen/types.rs:150-158``)
- ``SystemParams`` = { l_skip, n_stack, w_stack, log_blowup, whir:
  WhirConfig, logup: LogUpSecurityParameters, max_constraint_degree }
  (``config.rs:51-64``)
- ``WhirConfig`` = { k, rounds: Vec<{num_queries}>, mu_pow_bits,
  query_phase_pow_bits, folding_pow_bits, proximity } (``config.rs:171-192``)
- ``WhirProximityStrategy`` enum: UniqueDecoding=0, SplitUniqueList{m,
  list_start_round}=1, ListDecoding{m}=2 (``config.rs:199-214``)
- ``LogUpSecurityParameters`` = { max_interaction_count: u32,
  log_max_message_length: u32, pow_bits: usize } (``interaction/mod.rs:219``)
- ``StarkVerifyingKey`` = { preprocessed_data:
  Option<{commit: [F;8], hypercube_dim: isize, stacking_width: usize}>,
  params: {width: {preprocessed: Option<usize>, cached_mains: Vec<usize>,
  common_main: usize}, num_public_values: usize, need_rot: bool},
  symbolic_constraints: SymbolicConstraintsDag, max_constraint_degree: u8,
  is_required: bool, unused_variables: Vec<SymbolicVariable> }
  (``keygen/types.rs:113-130``)
- ``SymbolicConstraintsDag`` = { constraints: {nodes:
  Vec<SymbolicExpressionNode>, constraint_idx: Vec<usize>}, interactions:
  Vec<{message: Vec<usize>, count: usize, bus_index: u16, count_weight:
  u32}> } (``symbolic/dag.rs:48-88``, ``interaction/mod.rs:16-31``)
- ``SymbolicExpressionNode`` enum: Variable=0, IsFirstRow=1, IsLastRow=2,
  IsTransition=3, Constant=4, Add{l,r,d}=5, Sub{l,r,d}=6, Neg{i,d}=7,
  Mul{l,r,d}=8 (``symbolic/dag.rs:22-46``)
- ``SymbolicVariable`` = { entry: Entry, index: usize } with Entry enum
  Preprocessed{offset}=0, Main{part_index, offset}=1, Public=2,
  Challenge=3 (``symbolic/symbolic_variable.rs:15-67``)
- ``LinearConstraint`` = { coefficients: Vec<u32>, threshold: u32 }

MontyField31 serde: the pinned Plonky3 v0.4.3 impl is, verbatim::

    impl<MP: MontyParameters> Serialize for MontyField31<MP> {
        fn serialize<S: Serializer>(&self, serializer: S) -> ... {
            // It's faster to serialize in monty form
            serializer.serialize_u32(self.value)
        }
    }

i.e. the raw Montgomery-form u32 (postcard then varint-encodes it). The
Plonky3 sources are not on this disk and the environment has no egress,
so this is pinned from the documented impl rather than a vendored file;
``tests/test_vk_introspection.py`` freezes a golden byte string of a full
pre-vk serialization so any drift in this layout fails loudly. Everything
else follows reference sources cited above.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from .fields.babybear import P

_R = (1 << 32) % P  # Montgomery factor

CODEC_VERSION = 3  # keygen/mod.rs:205 uses the codec version for domain sep


def _monty(x: int) -> int:
    return (int(x) * _R) % P


class _W:
    def __init__(self):
        self.buf = bytearray()

    def varint(self, v: int):
        v = int(v)
        assert v >= 0
        while True:
            b = v & 0x7F
            v >>= 7
            if v:
                self.buf.append(b | 0x80)
            else:
                self.buf.append(b)
                return

    def zigzag(self, v: int):
        v = int(v)
        self.varint((v << 1) ^ (v >> 63) if v < 0 else (v << 1))

    def byte(self, v: int):
        self.buf.append(v & 0xFF)

    def boolean(self, v: bool):
        self.byte(1 if v else 0)

    def felt(self, x: int):
        self.varint(_monty(x))


def _entry(w: _W, entry: str, part: int, offset: int):
    if entry == "preprocessed":
        w.varint(0)
        w.varint(offset)
    elif entry == "main":
        w.varint(1)
        w.varint(part)
        w.varint(offset)
    elif entry == "public":
        w.varint(2)
    elif entry == "challenge":
        w.varint(3)
    else:
        raise ValueError(entry)


_SEL_DISCR = {"is_first_row": 1, "is_last_row": 2, "is_transition": 3}


def _node(w: _W, n):
    tag = n[0]
    if tag == "var":
        w.varint(0)
        _entry(w, n[1], n[2], n[3])
        w.varint(n[4])  # index
    elif tag == "sel":
        w.varint(_SEL_DISCR[n[1]])
    elif tag == "const":
        w.varint(4)
        w.felt(n[1])
    elif tag == "add":
        w.varint(5)
        w.varint(n[1])
        w.varint(n[2])
        w.varint(n[3])
    elif tag == "sub":
        w.varint(6)
        w.varint(n[1])
        w.varint(n[2])
        w.varint(n[3])
    elif tag == "neg":
        w.varint(7)
        w.varint(n[1])
        w.varint(n[2])
    elif tag == "mul":
        w.varint(8)
        w.varint(n[1])
        w.varint(n[2])
        w.varint(n[3])
    else:
        raise ValueError(tag)


def _params(w: _W, p):
    w.varint(p.l_skip)
    w.varint(p.n_stack)
    w.varint(p.w_stack)
    w.varint(p.log_blowup)
    # WhirConfig
    w.varint(p.whir.k)
    w.varint(len(p.whir.rounds))
    for r in p.whir.rounds:
        w.varint(r.num_queries)
    w.varint(p.whir.mu_pow_bits)
    w.varint(p.whir.query_phase_pow_bits)
    w.varint(p.whir.folding_pow_bits)
    prox = p.whir.proximity
    if prox.kind == "unique":
        w.varint(0)
    elif prox.kind == "split":
        w.varint(1)
        w.varint(prox.m)
        w.varint(prox.list_start_round)
    elif prox.kind == "list":
        w.varint(2)
        w.varint(prox.m)
    else:
        raise ValueError(prox.kind)
    # LogUpSecurityParameters
    w.varint(p.logup.max_interaction_count)
    w.varint(p.logup.log_max_message_length)
    w.varint(p.logup.pow_bits)
    w.varint(p.max_constraint_degree)


def _vk(w: _W, vk):
    prep = vk.preprocessed_data
    if prep is None:
        w.byte(0)
    else:
        w.byte(1)
        if isinstance(prep.commit, (int, np.integer)):
            # outer BN254 digest: one scalar, 32 LE bytes (halo2curves Fr
            # postcard serde; hash_scheme.rs outer digest type)
            for b in int(prep.commit).to_bytes(32, "little"):
                w.byte(b)
        else:
            for d in np.asarray(prep.commit).reshape(8):
                w.felt(int(d))
        w.zigzag(prep.hypercube_dim)
        w.varint(prep.stacking_width)
    tw = vk.params.width
    if tw.preprocessed is None:
        w.byte(0)
    else:
        w.byte(1)
        w.varint(tw.preprocessed)
    w.varint(len(tw.cached_mains))
    for c in tw.cached_mains:
        w.varint(c)
    w.varint(tw.common_main)
    w.varint(vk.params.num_public_values)
    w.boolean(vk.params.need_rot)
    dag = vk.symbolic_constraints
    w.varint(len(dag.nodes))
    for n in dag.nodes:
        _node(w, n)
    w.varint(len(dag.constraint_idx))
    for i in dag.constraint_idx:
        w.varint(i)
    w.varint(len(dag.interactions))
    for it in dag.interactions:
        w.varint(len(it.message))
        for m in it.message:
            w.varint(m)
        w.varint(it.count)
        w.varint(it.bus_index)
        w.varint(it.count_weight)
    w.byte(vk.max_constraint_degree)  # u8
    w.boolean(vk.is_required)
    unused = getattr(vk, "unused_variables", [])
    w.varint(len(unused))
    for entry, part, offset, index in unused:
        _entry(w, entry, part, offset)
        w.varint(index)


def serialize_pre_vk(params, vks: Sequence, constraints: Sequence) -> bytes:
    """Postcard bytes of MultiStarkVerifyingKey0 (params, per_air,
    trace_height_constraints)."""
    w = _W()
    _params(w, params)
    w.varint(len(vks))
    for vk in vks:
        _vk(w, vk)
    w.varint(len(constraints))
    for c in constraints:
        w.varint(len(c.coefficients))
        for co in c.coefficients:
            w.varint(co)
        w.varint(c.threshold)
    return bytes(w.buf)


def versioned_pre_vk_bytes(params, vks, constraints) -> bytes:
    vk_bytes = serialize_pre_vk(params, vks, constraints)
    return (
        CODEC_VERSION.to_bytes(4, "little")
        + len(vk_bytes).to_bytes(8, "little")
        + vk_bytes
    )
