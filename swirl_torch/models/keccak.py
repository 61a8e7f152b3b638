"""Keccak-f[1600] AIR: 24 rows per permutation, 2633 columns, degree 3.

The torch port's own copy of ``swirl/models/keccak.py`` (host numpy; the
AIR and its trace generation touch no device).

The flagship wide-trace workload, the peer of the reference's keccakf
example (``crates/stark-sdk/examples/keccakf.rs``, which proves
p3-keccak-air at 2^10 permutations under the app preset). The column
layout and constraint strategy follow the same shape as p3-keccak-air —
16-bit limb state columns plus per-round bit decompositions for theta and
chi — but the AIR is written from the Keccak-f specification directly.

Conventions: a lane is A[x][y] (keccak coordinates); arrays here index
``[y][x]``. Bit z is the 2^z bit of a lane; limb k holds bits
``16k..16k+16``. Round constants/rotations are the standard Keccak-f
values, validated in tests by running SHA3-256 on top of :func:`keccak_f`
against hashlib.
"""

from __future__ import annotations

from typing import List

import numpy as np

from ..air import Air

NUM_ROUNDS = 24
U64_LIMBS = 4
BITS_PER_LIMB = 16

# rho rotation offsets, RHO[x][y]
RHO = [
    [0, 36, 3, 41, 18],
    [1, 44, 10, 45, 2],
    [62, 6, 43, 15, 61],
    [28, 55, 25, 21, 56],
    [27, 20, 39, 8, 14],
]

RC = [
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A,
    0x8000000080008000, 0x000000000000808B, 0x0000000080000001,
    0x8000000080008081, 0x8000000000008009, 0x000000000000008A,
    0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089,
    0x8000000000008003, 0x8000000000008002, 0x8000000000000080,
    0x000000000000800A, 0x800000008000000A, 0x8000000080008081,
    0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
]


# ---------------------------------------------------------------------------
# Column layout
# ---------------------------------------------------------------------------


class Cols:
    """Flat column indices. Order: step_flags, export, preimage, a, c,
    c_prime, a_prime, a_prime_prime, a''[0][0] bits, a'''[0][0] limbs."""

    STEP_FLAGS = 0
    EXPORT = STEP_FLAGS + NUM_ROUNDS
    PREIMAGE = EXPORT + 1
    A = PREIMAGE + 25 * U64_LIMBS
    C = A + 25 * U64_LIMBS
    C_PRIME = C + 5 * 64
    A_PRIME = C_PRIME + 5 * 64
    A_PP = A_PRIME + 25 * 64
    A_PP_00_BITS = A_PP + 25 * U64_LIMBS
    A_PPP_00 = A_PP_00_BITS + 64
    NUM = A_PPP_00 + U64_LIMBS

    @staticmethod
    def step_flag(r: int) -> int:
        return Cols.STEP_FLAGS + r

    @staticmethod
    def preimage(y: int, x: int, limb: int) -> int:
        return Cols.PREIMAGE + (y * 5 + x) * U64_LIMBS + limb

    @staticmethod
    def a(y: int, x: int, limb: int) -> int:
        return Cols.A + (y * 5 + x) * U64_LIMBS + limb

    @staticmethod
    def c(x: int, z: int) -> int:
        return Cols.C + x * 64 + z

    @staticmethod
    def c_prime(x: int, z: int) -> int:
        return Cols.C_PRIME + x * 64 + z

    @staticmethod
    def a_prime(y: int, x: int, z: int) -> int:
        return Cols.A_PRIME + (y * 5 + x) * 64 + z

    @staticmethod
    def a_pp(y: int, x: int, limb: int) -> int:
        return Cols.A_PP + (y * 5 + x) * U64_LIMBS + limb

    @staticmethod
    def a_pp_00_bit(z: int) -> int:
        return Cols.A_PP_00_BITS + z

    @staticmethod
    def a_ppp_00(limb: int) -> int:
        return Cols.A_PPP_00 + limb


NUM_KECCAK_COLS = Cols.NUM  # 2633


# ---------------------------------------------------------------------------
# Reference permutation (numpy, batched over leading axis)
# ---------------------------------------------------------------------------


def _rotl(v: np.ndarray, s: int) -> np.ndarray:
    s %= 64
    if s == 0:
        return v
    return (v << np.uint64(s)) | (v >> np.uint64(64 - s))


def keccak_round(lanes: np.ndarray, rc: int) -> np.ndarray:
    """One Keccak-f round. lanes: (..., 5, 5) uint64 indexed [y][x]."""
    a = lanes
    c = a[..., 0, :].copy()
    for y in range(1, 5):
        c ^= a[..., y, :]
    d = np.empty_like(c)
    for x in range(5):
        d[..., x] = c[..., (x + 4) % 5] ^ _rotl(c[..., (x + 1) % 5], 1)
    ap = a ^ d[..., None, :]
    b = np.empty_like(a)
    for yb in range(5):
        for xb in range(5):
            x, y = (xb + 3 * yb) % 5, xb
            b[..., yb, xb] = _rotl(ap[..., y, x], RHO[x][y])
    out = np.empty_like(a)
    for yb in range(5):
        for xb in range(5):
            out[..., yb, xb] = b[..., yb, xb] ^ (
                ~b[..., yb, (xb + 1) % 5] & b[..., yb, (xb + 2) % 5]
            )
    out[..., 0, 0] ^= np.uint64(rc)
    return out


def keccak_f(lanes: np.ndarray) -> np.ndarray:
    """Full Keccak-f[1600]: (..., 5, 5) uint64 [y][x] -> same shape."""
    out = lanes.astype(np.uint64)
    for r in range(NUM_ROUNDS):
        out = keccak_round(out, RC[r])
    return out


# ---------------------------------------------------------------------------
# AIR
# ---------------------------------------------------------------------------


def _xor(a, b):
    return a + b - 2 * a * b


def _xor3(a, b, c):
    return _xor(_xor(a, b), c)


def _andn(a, b):
    return (1 - a) * b


class KeccakAir(Air):
    """Proves batches of Keccak-f[1600] permutations, 24 rows each."""

    def common_main_width(self) -> int:
        return NUM_KECCAK_COLS

    def eval(self, bld) -> None:
        local = bld.common_main.local
        nxt = bld.common_main.next
        flags = [local[Cols.step_flag(r)] for r in range(NUM_ROUNDS)]
        first_step = flags[0]
        final_step = flags[NUM_ROUNDS - 1]
        not_final = 1 - final_step

        # step flag rotation schedule
        first = bld.when_first_row()
        first.assert_one(flags[0])
        for i in range(1, NUM_ROUNDS):
            first.assert_zero(flags[i])
        trans = bld.when_transition()
        for i in range(NUM_ROUNDS):
            trans.assert_eq(nxt[Cols.step_flag((i + 1) % NUM_ROUNDS)], flags[i])

        # export flag
        export = local[Cols.EXPORT]
        bld.assert_bool(export)
        bld.when(not_final).assert_zero(export)

        # preimage: pinned to a on the first step, carried across rows
        when_first_step = bld.when(first_step)
        trans_nf = bld.when_transition().when(not_final)
        for y in range(5):
            for x in range(5):
                for l in range(U64_LIMBS):
                    when_first_step.assert_eq(
                        local[Cols.preimage(y, x, l)], local[Cols.a(y, x, l)]
                    )
                    trans_nf.assert_eq(
                        nxt[Cols.preimage(y, x, l)], local[Cols.preimage(y, x, l)]
                    )

        c = [[local[Cols.c(x, z)] for z in range(64)] for x in range(5)]
        cp = [[local[Cols.c_prime(x, z)] for z in range(64)] for x in range(5)]
        for x in range(5):
            for z in range(64):
                bld.assert_bool(c[x][z])
                # theta: C'[x] = C[x] ^ D[x], D[x] = C[x-1] ^ rot(C[x+1], 1)
                bld.assert_eq(
                    cp[x][z],
                    _xor3(c[x][z], c[(x + 4) % 5][z], c[(x + 1) % 5][(z + 63) % 64]),
                )

        ap = [
            [[local[Cols.a_prime(y, x, z)] for z in range(64)] for x in range(5)]
            for y in range(5)
        ]
        for y in range(5):
            for x in range(5):
                for z in range(64):
                    bld.assert_bool(ap[y][x][z])
        # parity link: xor_y A'[x][y][z] == C'[x][z], so the bit-sum differs
        # from C'[x][z] by an even number in {0, 2, 4}
        for x in range(5):
            for z in range(64):
                bit_sum = ap[0][x][z]
                for y in range(1, 5):
                    bit_sum = bit_sum + ap[y][x][z]
                diff = bit_sum - cp[x][z]
                bld.assert_zero(diff * (diff - 2) * (diff - 4))

        # a recomposition: A = A' ^ D = A' ^ C ^ C'  (theta inverse)
        for y in range(5):
            for x in range(5):
                bits = [_xor3(ap[y][x][z], c[x][z], cp[x][z]) for z in range(64)]
                for l in range(U64_LIMBS):
                    comb = bits[l * BITS_PER_LIMB]
                    for k in range(1, BITS_PER_LIMB):
                        comb = comb + (1 << k) * bits[l * BITS_PER_LIMB + k]
                    bld.assert_eq(local[Cols.a(y, x, l)], comb)

        # rho+pi: B[xb][yb] bit z reads A'[x][y] bit (z - RHO[x][y])
        def b_bit(xb: int, yb: int, z: int):
            x, y = (xb + 3 * yb) % 5, xb
            return ap[y][x][(z - RHO[x][y]) % 64]

        # chi: A''[x][y] = B[x][y] ^ (~B[x+1][y] & B[x+2][y])
        for yb in range(5):
            for xb in range(5):
                bits = [
                    _xor(
                        b_bit(xb, yb, z),
                        _andn(b_bit((xb + 1) % 5, yb, z), b_bit((xb + 2) % 5, yb, z)),
                    )
                    for z in range(64)
                ]
                for l in range(U64_LIMBS):
                    comb = bits[l * BITS_PER_LIMB]
                    for k in range(1, BITS_PER_LIMB):
                        comb = comb + (1 << k) * bits[l * BITS_PER_LIMB + k]
                    bld.assert_eq(local[Cols.a_pp(yb, xb, l)], comb)

        # a''[0][0] bit decomposition
        pp00 = [local[Cols.a_pp_00_bit(z)] for z in range(64)]
        for z in range(64):
            bld.assert_bool(pp00[z])
        for l in range(U64_LIMBS):
            comb = pp00[l * BITS_PER_LIMB]
            for k in range(1, BITS_PER_LIMB):
                comb = comb + (1 << k) * pp00[l * BITS_PER_LIMB + k]
            bld.assert_eq(local[Cols.a_pp(0, 0, l)], comb)

        # iota: A'''[0][0] = A''[0][0] ^ RC[round]
        for l in range(U64_LIMBS):
            comb = None
            for k in range(BITS_PER_LIMB):
                z = l * BITS_PER_LIMB + k
                rc_bit = None
                for r in range(NUM_ROUNDS):
                    if (RC[r] >> z) & 1:
                        rc_bit = flags[r] if rc_bit is None else rc_bit + flags[r]
                bit = pp00[z] if rc_bit is None else _xor(pp00[z], rc_bit)
                term = bit if k == 0 else (1 << k) * bit
                comb = term if comb is None else comb + term
            bld.assert_eq(local[Cols.a_ppp_00(l)], comb)

        # round transition: next A = A''' (A'' with iota applied at (0,0))
        for y in range(5):
            for x in range(5):
                for l in range(U64_LIMBS):
                    src = (
                        local[Cols.a_ppp_00(l)]
                        if (y, x) == (0, 0)
                        else local[Cols.a_pp(y, x, l)]
                    )
                    trans_nf.assert_eq(nxt[Cols.a(y, x, l)], src)

    # -- trace generation -----------------------------------------------------

    @staticmethod
    def generate_trace(inputs: np.ndarray, min_log_height: int = 0) -> np.ndarray:
        """inputs: (num_perms, 5, 5) uint64 lanes indexed [y][x].

        Returns (H, NUM_KECCAK_COLS) uint32 with H = next power of two >=
        max(24 * num_perms, 2^min_log_height); padding rows continue with
        zero-input permutations (truncated mid-block is fine: every
        constraint is local to a row or a forward transition).
        """
        inputs = np.asarray(inputs, dtype=np.uint64)
        num_perms = inputs.shape[0]
        height = max(NUM_ROUNDS * num_perms, 1 << min_log_height, 2)
        height = 1 << (height - 1).bit_length()
        num_blocks = -(-height // NUM_ROUNDS)
        lanes = np.zeros((num_blocks, 5, 5), dtype=np.uint64)
        lanes[:num_perms] = inputs

        rows = np.zeros((num_blocks, NUM_ROUNDS, NUM_KECCAK_COLS), dtype=np.uint32)
        zs = np.arange(64, dtype=np.uint64)
        ls = np.arange(U64_LIMBS, dtype=np.uint64) * np.uint64(BITS_PER_LIMB)

        def put_limbs(dst_base, yxl_stride_ok, lane, r, y, x):
            limbs = (lane[:, None] >> ls[None, :]) & np.uint64(0xFFFF)
            rows[:, r, dst_base : dst_base + U64_LIMBS] = limbs

        preimage = lanes.copy()
        a = lanes.copy()
        for r in range(NUM_ROUNDS):
            rows[:, r, Cols.step_flag(r)] = 1
            # theta intermediates
            c_lane = a[:, 0, :].copy()
            for y in range(1, 5):
                c_lane ^= a[:, y, :]
            cp_lane = np.empty_like(c_lane)
            for x in range(5):
                cp_lane[:, x] = (
                    c_lane[:, x]
                    ^ c_lane[:, (x + 4) % 5]
                    ^ _rotl(c_lane[:, (x + 1) % 5], 1)
                )
            d_lane = c_lane ^ cp_lane
            ap_lane = a ^ d_lane[:, None, :]
            b_lane = np.empty_like(a)
            for yb in range(5):
                for xb in range(5):
                    x, y = (xb + 3 * yb) % 5, xb
                    b_lane[:, yb, xb] = _rotl(ap_lane[:, y, x], RHO[x][y])
            app_lane = np.empty_like(a)
            for yb in range(5):
                for xb in range(5):
                    app_lane[:, yb, xb] = b_lane[:, yb, xb] ^ (
                        ~b_lane[:, yb, (xb + 1) % 5] & b_lane[:, yb, (xb + 2) % 5]
                    )
            appp00 = app_lane[:, 0, 0] ^ np.uint64(RC[r])

            for y in range(5):
                for x in range(5):
                    put_limbs(Cols.preimage(y, x, 0), True, preimage[:, y, x], r, y, x)
                    put_limbs(Cols.a(y, x, 0), True, a[:, y, x], r, y, x)
                    rows[:, r, Cols.a_prime(y, x, 0) : Cols.a_prime(y, x, 0) + 64] = (
                        (ap_lane[:, y, x, None] >> zs[None, :]) & np.uint64(1)
                    )
                    put_limbs(Cols.a_pp(y, x, 0), True, app_lane[:, y, x], r, y, x)
            for x in range(5):
                rows[:, r, Cols.c(x, 0) : Cols.c(x, 0) + 64] = (
                    (c_lane[:, x, None] >> zs[None, :]) & np.uint64(1)
                )
                rows[:, r, Cols.c_prime(x, 0) : Cols.c_prime(x, 0) + 64] = (
                    (cp_lane[:, x, None] >> zs[None, :]) & np.uint64(1)
                )
            rows[:, r, Cols.A_PP_00_BITS : Cols.A_PP_00_BITS + 64] = (
                (app_lane[:, 0, 0, None] >> zs[None, :]) & np.uint64(1)
            )
            rows[:, r, Cols.A_PPP_00 : Cols.A_PPP_00 + U64_LIMBS] = (
                (appp00[:, None] >> ls[None, :]) & np.uint64(0xFFFF)
            )

            next_a = app_lane.copy()
            next_a[:, 0, 0] = appp00
            a = next_a
        rows[:num_perms, NUM_ROUNDS - 1, Cols.EXPORT] = 1
        return rows.reshape(num_blocks * NUM_ROUNDS, NUM_KECCAK_COLS)[:height]


# ---------------------------------------------------------------------------
# SHA3-256 on top of keccak_f (test oracle against hashlib)
# ---------------------------------------------------------------------------


def sha3_256(data: bytes) -> bytes:
    rate = 136  # bytes
    padded = bytearray(data)
    pad_len = rate - (len(padded) % rate)
    padded += b"\x06" + b"\x00" * (pad_len - 2) + b"\x80" if pad_len >= 2 else b"\x86"
    if pad_len == 1:
        padded = bytearray(data) + b"\x86"
    state = np.zeros((5, 5), dtype=np.uint64)
    for off in range(0, len(padded), rate):
        block = padded[off : off + rate]
        for i in range(rate // 8):
            lane = int.from_bytes(block[8 * i : 8 * i + 8], "little")
            x, y = i % 5, i // 5
            state[y, x] ^= np.uint64(lane)
        state = keccak_f(state)
    out = b""
    for i in range(4):
        x, y = i % 5, i // 5
        out += int(state[y, x]).to_bytes(8, "little")
    return out
