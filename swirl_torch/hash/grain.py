"""Grain-LFSR round-constant generation for Poseidon/Poseidon2 (the port's
copy of ``swirl/hash/grain.py``).

Implements the parameter-generation procedure from the Poseidon reference
implementation (``generate_parameters_grain.sage``): an 80-bit Grain LFSR
seeded with the instance description, with 160 discarded warm-up bits and a
shrinking-generator output filter, then rejection sampling of n-bit field
elements.

The reference stack obtains its BabyBear Poseidon2 constants from
HorizenLabs' ``zkhash`` crate, which uses this generator (the reference
checks equality with Plonky3's constants in
``crates/stark-sdk/src/config/baby_bear_poseidon2.rs:293-351``). We generate
constants with the same documented procedure; the resulting table lives in
:mod:`swirl_torch.hash.poseidon2` and can be swapped wholesale if byte-exact
parity with a particular external instance is required.
"""

from __future__ import annotations

from typing import List


class GrainLFSR:
    def __init__(self, field: int, sbox: int, n: int, t: int, r_f: int, r_p: int):
        bits: List[int] = []

        def push(value: int, width: int):
            for i in reversed(range(width)):
                bits.append((value >> i) & 1)

        push(field, 2)
        push(sbox, 4)
        push(n, 12)
        push(t, 12)
        push(r_f, 10)
        push(r_p, 10)
        bits.extend([1] * 30)
        assert len(bits) == 80
        self.state = bits
        # discard 160 warm-up bits
        for _ in range(160):
            self._next_raw()

    def _next_raw(self) -> int:
        s = self.state
        new = s[62] ^ s[51] ^ s[38] ^ s[23] ^ s[13] ^ s[0]
        self.state = s[1:] + [new]
        return new

    def next_bit(self) -> int:
        # shrinking generator: emit b2 only when b1 == 1
        while True:
            b1 = self._next_raw()
            b2 = self._next_raw()
            if b1 == 1:
                return b2

    def next_field_element(self, n_bits: int, p: int) -> int:
        while True:
            v = 0
            for _ in range(n_bits):
                v = (v << 1) | self.next_bit()
            if v < p:
                return v


def poseidon2_round_constants(
    p: int, n_bits: int, t: int, r_f: int, r_p: int
) -> tuple:
    """Returns (external_initial, internal, external_final) constant lists.

    external_initial / external_final: lists of length r_f/2, each of t ints.
    internal: list of r_p ints (partial rounds add a constant to lane 0 only).
    """
    g = GrainLFSR(field=1, sbox=0, n=n_bits, t=t, r_f=r_f, r_p=r_p)
    # Draw order (validated against the reference's vendored RC16 table,
    # crates/cuda-common/include/poseidon2.cuh:14-47): constants are drawn
    # in ROUND order, with partial rounds drawing a SINGLE element each
    # (zkhash stores partial rows as [c, 0, ..., 0]):
    #   r_f/2 full t-wide rows, then r_p single elements, then r_f/2 rows.
    # tests/test_hash_transcript.py pins this generator to the vendored
    # reference table for the BabyBear-16 instance.
    half = r_f // 2
    initial = [
        [g.next_field_element(n_bits, p) for _ in range(t)] for _ in range(half)
    ]
    internal = [g.next_field_element(n_bits, p) for _ in range(r_p)]
    final = [
        [g.next_field_element(n_bits, p) for _ in range(t)] for _ in range(half)
    ]
    return initial, internal, final
