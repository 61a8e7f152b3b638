"""Poseidon2 permutations over the BN254 scalar field (widths 2 and 3).

The reference workspace ships a second hash scheme for *outer* recursion
proofs: Merkle/transcript hashing over the BN254 scalar field so the final
STARK can be wrapped in a BN254 SNARK cheaply (reference:
``crates/stark-sdk/src/config/bn254_poseidon2/*`` widths 2/3,
``crates/stark-sdk/src/config/baby_bear_bn254_poseidon2.rs``,
``cuda-backend/cuda/src/bn254_*.cu``). This module is the port's copy of
``swirl/hash/bn254_poseidon2.py``.

Instances (reference parity):

- **width 2** (Merkle 2-to-1 compression): t=2, rF=6, rP=50, S-box x^5,
  internal diag d=(1,2); round constants are the vendored gnark-crypto
  Keccak-chain table (:mod:`swirl_torch.hash.bn254_constants`, from
  ``bn254_poseidon2/width2_constants.rs`` RC2).
- **width 3** (leaf hash / transcript sponge): t=3, rF=8, rP=56, S-box x^5,
  internal diag d=(1,1,2); round constants are the frozen zkhash ``RC3``
  instance (:mod:`swirl_torch.hash.bn254_rc3` — leading entries cross-checked
  against the published HorizenLabs table, and
  ``tests/test_multi_field.py`` asserts the Grain-LFSR generator
  reproduces the frozen table bit-exactly; see
  ``bn254_poseidon2/width3.rs:1-8`` for the reference's sourcing).

The host permutation below works on Python ints (the verifier's Merkle
checks and the outer transcript's sponge). The device entry points at the
end (peer of ``swirl/hash/jbn254_poseidon2.py``) run the same permutations
over :mod:`swirl_torch.fields.bn254` elements, batched: the prover's leaf
hashes (kernel I), Merkle layers (kernel H) and proof-of-work grinds
(kernel J) on the card, their plain versions on the CPU.

Structure (Poseidon2 paper, t <= 3): external linear layer M_E = J + I
(t=2 -> [[2,1],[1,2]]; t=3 -> [[2,1,1],[1,2,1],[1,1,2]]); internal layer
M_I = J + diag(d).
"""

from __future__ import annotations

from functools import lru_cache
from typing import List, Sequence, Tuple

import numpy as np
import torch

from .. import kernels as K
from ..fields import bn254 as fb
from .bn254_constants import RC2
from .grain import poseidon2_round_constants

P_BN254 = fb.P  # the BN254 (alt_bn128) scalar field modulus
N_BITS = 254

# (full_rounds, partial_rounds, internal diag) per width — reference
# `bn254_poseidon2/width2.rs:29-32` and `width3.rs:22-24`.
_PARAMS = {2: (6, 50, (1, 2)), 3: (8, 56, (1, 1, 2))}


@lru_cache(maxsize=None)
def constants(t: int) -> Tuple[tuple, tuple, tuple]:
    """(external_initial, internal, external_final) for width t in {2, 3}."""
    assert t in (2, 3)
    r_f, r_p, _ = _PARAMS[t]
    if t == 2:
        # Vendored flat table: split as in `split_flat_round_constants`
        # (`bn254_poseidon2/common.rs:54-79`).
        half = r_f // 2
        ext_i = [RC2[r * t : (r + 1) * t] for r in range(half)]
        internal = RC2[half * t : half * t + r_p]
        flat_f = RC2[half * t + r_p :]
        ext_f = [flat_f[r * t : (r + 1) * t] for r in range(half)]
    else:
        # Frozen vendored table (see bn254_rc3.py header for provenance);
        # the Grain generator's agreement with it is a test invariant.
        from .bn254_rc3 import (
            RC3_EXTERNAL_FINAL,
            RC3_EXTERNAL_INITIAL,
            RC3_INTERNAL,
        )

        ext_i = [list(r) for r in RC3_EXTERNAL_INITIAL]
        internal = list(RC3_INTERNAL)
        ext_f = [list(r) for r in RC3_EXTERNAL_FINAL]
    return (
        tuple(tuple(r) for r in ext_i),
        tuple(internal),
        tuple(tuple(r) for r in ext_f),
    )


def _sbox(x: int) -> int:
    x2 = x * x % P_BN254
    x4 = x2 * x2 % P_BN254
    return x4 * x % P_BN254


def _external(s: List[int]) -> List[int]:
    total = sum(s) % P_BN254
    return [(total + x) % P_BN254 for x in s]


def _internal(s: List[int], t: int) -> List[int]:
    d = _PARAMS[t][2]
    total = sum(s) % P_BN254
    return [(total + d[i] * s[i]) % P_BN254 for i in range(t)]


def permute(state: Sequence[int], t: int) -> List[int]:
    """Poseidon2 permutation on a length-t list of BN254 scalars."""
    assert len(state) == t
    ext_i, internal, ext_f = constants(t)
    s = _external(list(state))
    for rc in ext_i:
        s = _external([_sbox((x + c) % P_BN254) for x, c in zip(s, rc)])
    for c in internal:
        s[0] = _sbox((s[0] + c) % P_BN254)
        s = _internal(s, t)
    for rc in ext_f:
        s = _external([_sbox((x + c) % P_BN254) for x, c in zip(s, rc)])
    return s


def compress2(a: int, b: int) -> int:
    """2-to-1 Merkle compression via the width-2 permutation.

    Reference `baby_bear_bn254_poseidon2.rs:59`: `TruncatedPermutation<
    Poseidon2Bn254Width2, 2, 1, 2>` — permute [a, b], keep lane 0.
    """
    return permute([a, b], 2)[0]


def hash_scalars(vals: Sequence[int]) -> int:
    """Sponge hash of BN254 scalars: width 3, rate 2, capacity 1."""
    s = [0, 0, 0]
    buf = list(vals)
    for i in range(0, len(buf), 2):
        chunk = buf[i : i + 2]
        for j, v in enumerate(chunk):
            s[j] = v % P_BN254  # overwrite mode
        s = permute(s, 3)
    if not buf:
        s = permute(s, 3)
    return s[0]


# -- on the port's devices: peer of swirl/hash/jbn254_poseidon2.py -----------
#
# A state is (..., t, 8) int32 (t lanes of fields.bn254 elements, Monty
# form); digests are (n, 8) int32 canonical words, 32 B each. Each wrapper
# launches its kernel (csrc/bn254.cu) on a CUDA tensor and runs its plain
# version on a CPU tensor.


@lru_cache(maxsize=None)
def _dev_constants(t: int):
    """(ext_i, internal, ext_f) as Monty uint32 words, derived from
    :func:`constants`: (half, t, 8), (r_p, 8), (half, t, 8)."""
    ext_i, internal, ext_f = constants(t)
    m = lambda rows: np.stack([np.stack([fb.const(c) for c in r]) for r in rows])
    return m(ext_i), np.stack([fb.const(c) for c in internal]), m(ext_f)


_w_consts = {}


def _consts_w(t: int, device):
    """:func:`_dev_constants` in word form on ``device``, made once."""
    key = (t, str(device))
    if key not in _w_consts:
        _w_consts[key] = tuple(fb.words(fb.tensor(c, device)) for c in _dev_constants(t))
    return _w_consts[key]


def _sbox_w(x):
    x2 = fb.mont_mul_w(x, x)
    x4 = fb.mont_mul_w(x2, x2)
    return fb.mont_mul_w(x4, x)


def _lane_sum_w(s):
    total = s[..., 0, :]
    for i in range(1, s.shape[-2]):
        total = fb.add_w(total, s[..., i, :])
    return total


def _external_w(s):
    """M_E = J + I over the lane axis (-2)."""
    return fb.add_w(_lane_sum_w(s)[..., None, :], s)


def _internal_w(s, t: int):
    """M_I = J + diag(d); d = (1, 2) or (1, 1, 2): only the last lane doubles."""
    assert _PARAMS[t][2][:-1] == (1,) * (t - 1) and _PARAMS[t][2][-1] == 2
    last = s[..., -1:, :]
    x = torch.cat([s[..., :-1, :], fb.add_w(last, last)], dim=-2)
    return fb.add_w(_lane_sum_w(s)[..., None, :], x)


def _permute_w(s, t: int):
    """The permutation on a (..., t, 8) word-form Monty state."""
    ext_i, internal, ext_f = _consts_w(t, s.device)
    s = _external_w(s)
    for rc in ext_i:
        s = _external_w(_sbox_w(fb.add_w(s, rc)))
    for c in internal:
        s0 = _sbox_w(fb.add_w(s[..., 0, :], c))
        s = _internal_w(torch.cat([s0[..., None, :], s[..., 1:, :]], dim=-2), t)
    for rc in ext_f:
        s = _external_w(_sbox_w(fb.add_w(s, rc)))
    return s


def permute_plain(state, t: int):
    return fb.from_words(_permute_w(fb.words(state), t))


def permute_dev(state, t: int):
    """Kernel H: the Poseidon2 permutation of each (t, 8) Monty state of an
    (n, t, 8) tensor."""
    if state.dim() != 3 or state.shape[1] != t or t not in (2, 3):
        raise ValueError(f"permute_dev: a (n, {t}, 8) state, got {tuple(state.shape)}")
    if not state.is_cuda:
        return permute_plain(state, t)
    fb.require_words(state, 3, "permute_dev")
    out = torch.empty_like(state)
    K.LIB.launch(K.BN254_MERKLE, "swirl_bn254_permute", state, state.data_ptr(), out.data_ptr(),
                 state.shape[0], t)
    return out


def compress2_dev(a, b):
    """Batched 2-to-1 compression of Monty digests: permute width-2 [a, b],
    keep lane 0 (``baby_bear_bn254_poseidon2.rs:59``)."""
    return permute_dev(torch.stack([a, b], dim=-2).contiguous(), 2)[..., 0, :]


def compress_layer_plain(layer, stride: int):
    """(n, 8) canonical digests -> (n/2, 8): output o compresses digest
    2 * stride * (o // stride) + o % stride with the digest stride after it."""
    n = layer.shape[0]
    g = fb.words(layer).reshape(n // (2 * stride), 2, stride, fb.L).transpose(1, 2)
    s = _permute_w(fb.from_canonical_w(g.reshape(n // 2, 2, fb.L)), 2)
    return fb.from_words(fb.to_canonical_w(s[:, 0]))


def compress_layer(layer, stride: int):
    """Kernel H: one Merkle layer of canonical digests at a pairing stride
    (the query stride for the strided levels, 1 above them), read in place."""
    n = layer.shape[0]
    if layer.dim() != 2 or n < 2 or n % (2 * stride) or stride & (stride - 1):
        raise ValueError(f"compress_layer: {tuple(layer.shape)} at stride {stride}")
    if not layer.is_cuda:
        return compress_layer_plain(layer, stride)
    fb.require_words(layer, 2, "compress_layer")
    out = torch.empty((n // 2, fb.L), dtype=fb.DTYPE, device=layer.device)
    K.LIB.launch(K.BN254_MERKLE, "swirl_bn254_compress", layer, layer.data_ptr(), out.data_ptr(),
                 n // 2, stride.bit_length() - 1)
    return out


def _pack_w(felts):
    """Canonical BabyBear (..., k <= 8) int64 -> one canonical word-form
    scalar: felt j occupies bits [31j, 31j + 31), so a word takes pieces of
    at most two felts, which never overlap."""
    from .multi_field import FELT_BITS, FELTS_PER_SCALAR

    k = felts.shape[-1]
    assert k <= FELTS_PER_SCALAR
    out = []
    for w in range(fb.L):
        acc = torch.zeros(felts.shape[:-1], dtype=torch.int64, device=felts.device)
        for j in range(k):
            off = FELT_BITS * j - fb.WORD_BITS * w
            if off >= fb.WORD_BITS or off + FELT_BITS <= 0:
                continue
            f = felts[..., j]
            acc = acc + (((f << off) & 0xFFFFFFFF) if off >= 0 else (f >> -off))
        out.append(acc)
    return torch.stack(out, dim=-1)


def pack_felts_dev(felts):
    """Canonical BabyBear (..., k <= 8) int64 -> one canonical BN254 scalar
    (..., 8) int32: little-endian base-2^31 packing
    (``multi_field_packing.rs:31-39``)."""
    return fb.from_words(_pack_w(felts))


def _leaf_rows(mat):
    """The leaves' values, (h, W): a (w, h) codeword's columns, or a (w, h,
    d) extension-field codeword's, value c * d + e of leaf i being [c, i, e]."""
    if mat.dim() == 3:
        w, h, d = mat.shape
        return mat.permute(1, 0, 2).reshape(h, w * d)
    return mat.T


def hash_rows_plain(mat):
    """``MultiFieldHasher::hash_iter`` (``hasher.rs:119-136``) of every leaf
    of a canonical (w, h) or (w, h, d) int64 codeword -> (h, 8) canonical
    digests. Per 16-felt block: pack two scalars, overwrite state lanes 0
    and 1 (lane 0 only for a last block of at most 8 felts), permute width
    3; the digest is lane 0."""
    from .multi_field import BABY_BEAR_RATE, FELTS_PER_SCALAR, WIDTH

    rows = _leaf_rows(mat)
    h, w = rows.shape
    state = torch.zeros((h, WIDTH, fb.L), dtype=torch.int64, device=mat.device)
    for i in range(0, w, BABY_BEAR_RATE):
        block = rows[:, i : i + BABY_BEAR_RATE]
        n = -(-block.shape[1] // FELTS_PER_SCALAR)
        packed = torch.stack(
            [_pack_w(block[:, c * FELTS_PER_SCALAR : (c + 1) * FELTS_PER_SCALAR]) for c in range(n)], dim=1)
        state = _permute_w(torch.cat([fb.from_canonical_w(packed), state[:, n:]], dim=1), WIDTH)
    return fb.from_words(fb.to_canonical_w(state[:, 0]))


def hash_rows(mat):
    """Kernel I: (h, 8) canonical digests of the leaves of a (w, h) or
    (w, h, d) canonical int64 codeword (d a power of two), read in place."""
    if not mat.is_cuda:
        return hash_rows_plain(mat)
    K.require(mat, (2, 3), "hash_rows")
    d = mat.shape[2] if mat.dim() == 3 else 1
    if d & (d - 1) or d == 0:
        raise K.KernelError(f"hash_rows: the last of {tuple(mat.shape)} is not a power of two")
    w, h = mat.shape[0] * d, mat.shape[1]
    out = torch.empty((h, fb.L), dtype=fb.DTYPE, device=mat.device)
    K.LIB.launch(K.BN254_LEAVES, "swirl_bn254_hash_rows", mat, mat.data_ptr(), out.data_ptr(), w, h,
                 d.bit_length() - 1)
    return out


def merkle_layers_dev(leaf_digests) -> list:
    """Every layer from (n, 8) canonical digests (n a power of two) to the
    root, contiguous pairing (``bn254_merkle.cu`` peer)."""
    layers = [leaf_digests]
    while layers[-1].shape[0] > 1:
        layers.append(compress_layer(layers[-1], 1))
    return layers


def _grind_args(a: int, shift: int, bits: int, end: int) -> int:
    """Validate J's scalar operands; returns the search's end (None: BabyBear's order)."""
    from ..fields.babybear import P as P_BB

    end = P_BB if end is None else end
    if a not in (0, 1) or shift not in range(0, 31 * 8, 31) or not 1 <= bits <= 30 or not 0 <= end <= P_BB:
        raise ValueError(f"grind: absorb cursor {a}, shift {shift}, {bits} bits, end {end}")
    return end


def _grind_operand(state, a: int, shift: int, bits: int, end: int) -> int:
    """Validate J's operands; returns the search's end (None: BabyBear's order)."""
    if state.shape != (4, fb.L) or state.dtype != fb.DTYPE:
        raise ValueError(f"grind: a (4, 8) int32 operand, got {state.dtype} {tuple(state.shape)}")
    return _grind_args(a, shift, bits, end)


def grind_plain(state, a: int, shift: int, bits: int, end: int = None) -> int:
    """The smallest witness w below ``end`` (None: BabyBear's order, the
    host loop's range): the outer sponge's ``state`` (rows 0-2, canonical)
    with lane ``a`` overwritten by the packed pending felts (row 3,
    canonical, below 2^shift) plus w << shift, permuted once (whatever the cursors, observe + sample is one
    permutation: a full rate permutes at the absorb, else the squeeze does);
    the sample is lane 1 mod p, tested under ``bits``. Batched over
    candidates; -1 if none below ``end``."""
    from ..fields.babybear import P as P_BB

    end = _grind_operand(state, a, shift, bits, end)
    st = fb.words(state)
    monty = fb.from_canonical_w(st[:3])
    batch = min(1 << 20 if state.is_cuda else 1 << 12, max(64, 4 << bits))
    q, r = divmod(shift, fb.WORD_BITS)
    for lo in range(0, end, batch):
        w = torch.arange(lo, min(lo + batch, end), dtype=torch.int64, device=state.device)
        # w << shift as words: bits of w land in word q (from bit r) and q + 1
        v = torch.zeros((w.shape[0], fb.L), dtype=torch.int64, device=state.device)
        v[:, q] = (w << r) & 0xFFFFFFFF
        if r and q + 1 < fb.L:
            v[:, q + 1] = w >> (fb.WORD_BITS - r)
        lanes = monty.expand(w.shape[0], 3, fb.L).clone()
        lanes[:, a] = fb.from_canonical_w(v + st[3])
        x = fb.to_canonical_w(_permute_w(lanes, 3)[:, 1])
        digit = torch.zeros_like(w)
        for i in reversed(range(fb.L)):
            digit = ((digit << fb.WORD_BITS) + x[:, i]) % P_BB
        hit = torch.nonzero((digit & ((1 << bits) - 1)) == 0)
        if hit.numel():
            return lo + int(hit[0, 0])
    return -1


# Kernel J's launch: blocks of GRIND_THREADS threads, each taking every n-th
# candidate (n the launch's threads): a sweep is n candidates, and the search
# stops in the sweep after its witness's. csrc/bn254.cu swirl_bn254_grind
# sizes a sweep to four expected counts (one block at least), at most the
# blocks the card holds.
GRIND_THREADS = 128
_F64_R = fb.F64_R % P_BN254


def grind_sweeps(threads: int, end: int):
    """Kernel J's candidate order: sweep k holds (thread, w = k n + thread)
    for the threads with w < end."""
    for base in range(0, end, threads):
        yield [(t, base + t) for t in range(min(threads, end - base))]


def _grind_struct(lanes, pending: int, a: int, shift: int, mask: int, end: int) -> np.ndarray:
    """csrc/bn254.cu GrindArgs as 27 uint64: the lanes, the pending scalar
    and step in R' form (canonical limbs), end, then mask and a."""
    r, p = _F64_R, P_BN254
    rows = [v * r % p for v in lanes] + [pending * r % p, (r << shift) * r % p]
    words = [(v >> s) & fb.F64_MASK for v in rows for s in range(0, fb.F64_LIMBS * fb.F64_RADIX, fb.F64_RADIX)]
    return np.array(words + [end, mask | (a << 32)], dtype=np.uint64)


def grind_ints(lanes, pending: int, a: int, shift: int, bits: int, end: int = None, device="cuda") -> int:
    """Kernel J from the host's sponge: ``lanes`` (3 canonical ints) and the
    ``pending`` felts' packed scalar (below 2^shift) go by value (no copy to
    the card); :func:`grind_plain`'s witness, read to the host (-1 if none
    below ``end``). On a CPU ``device`` the plain version."""
    device = torch.device(device)
    if device.type != "cuda":
        return grind_plain(fb.from_ints([*lanes, pending], device), a, shift, bits, end)
    end = _grind_args(a, shift, bits, end)
    if len(lanes) != 3 or pending < 0 or pending >> shift or not all(0 <= v < P_BN254 for v in lanes):
        raise ValueError(f"grind: lanes {lanes}, pending {pending} (below 2^{shift})")
    found = torch.empty(1, dtype=torch.int64, device=device)
    args = _grind_struct(lanes, pending, a, shift, (1 << bits) - 1, end)
    K.LIB.launch(K.BN254_GRIND, "swirl_bn254_grind", found, args.ctypes.data, found.data_ptr())
    w = int(found.item())
    return w if w < end else -1


def grind(state, a: int, shift: int, bits: int, end: int = None) -> int:
    """Kernel J on a (4, 8) state tensor (rows 0-2 the lanes, row 3 the
    pending scalar, canonical): :func:`grind_ints` after one read of the
    state to the host; the plain version on a CPU tensor."""
    if not state.is_cuda:
        return grind_plain(state, a, shift, bits, end)
    _grind_operand(state, a, shift, bits, end)
    fb.require_words(state, 2, "grind")
    v = fb.to_ints(state)
    return grind_ints(v[:3], v[3], a, shift, bits, end, state.device)


def grind_model(lanes, pending: int, a: int, shift: int, bits: int, end: int = None,
                threads: int = GRIND_THREADS) -> int:
    """Kernel J by the model, its ``threads`` in :func:`grind_sweeps`' order: a
    thread's lane starts at base + mont(w, step) and moves by the stride
    mont(threads, step) a sweep (limb adds and one conditional subtract,
    :mod:`fields.bn254`'s f64 model, each asserted equal to (pending + w
    2^shift) 2^260 mod P); the permutation on the lanes' values (the host's;
    kernels H and I hold the card's to it); the sample from the canonical
    lane's 26-bit limb halves, each times 2^(26 j) mod p, the sum asserted
    below 2^64. A thread leaves once the least hit lies below its
    candidate; after a sweep with a hit every thread has. -1 if none."""
    from ..fields.babybear import P as P_BB

    end = _grind_args(a, shift, bits, end)
    g = _grind_struct(lanes, pending, a, shift, (1 << bits) - 1, end).tolist()
    limbs = lambda i: g[5 * i : 5 * i + 5]  # noqa: E731
    base, step = limbs(3), limbs(4)
    times_step = lambda k: fb.f64_limbs(fb.f64_canon(fb.f64_mont(fb.f64_limbs(k), step)))  # noqa: E731
    stride = times_step(threads)
    add_mod = lambda x, y: fb.f64_canon(fb.f64_norm(fb.f64_add(x, y)))  # noqa: E731
    weights = [pow(2, 26 * j, P_BB) for j in range(2 * fb.F64_LIMBS)]
    r = fb.F64_R % P_BN254
    v, found, gone = {}, None, set()
    for sweep in grind_sweeps(threads, end):
        for t, w in sweep:
            if t in gone or (found is not None and found < w):
                gone.add(t)
                continue
            if t not in v:
                v[t] = add_mod(base, times_step(t))
            else:
                v[t] = add_mod(fb.f64_limbs(v[t]), stride)
            assert v[t] == (pending + (w << shift)) * r % P_BN254
            state = list(lanes)
            state[a] = pending + (w << shift)
            c = fb.f64_limbs(permute(state, 3)[1])
            halves = [x for limb in c for x in (limb & ((1 << 26) - 1), limb >> 26)]
            assert max(halves) < 1 << 26 and max(weights) < 1 << 31
            acc = sum(h * wt for h, wt in zip(halves, weights))
            assert acc < 1 << 64
            if (acc % P_BB) & ((1 << bits) - 1) == 0:
                found = w if found is None else min(found, w)
        if found is not None:  # every later candidate lies above it
            break
    return -1 if found is None else found


# -- the kernels' arithmetic, modelled step by step ----------------------------
#
# csrc/bn254.cuh keeps a lane as 5 limbs of radix 2^52 in R' = 2^260 form
# (fields/bn254.py f64_*): products on the FP64 pipe, adds limb by limb
# with no carry, the carries only before a product's operand is made
# (f64_norm). The partial rounds' lanes 1 .. t - 1, which no S-box takes,
# are brought below 3P after each internal layer (f64_reduce); nothing else
# is reduced until a digest leaves (f64_redc, f64_canon). The functions
# below repeat the kernels on Python ints and assert every bound;
# f64_permute_bounds proves the value bounds for every input below the
# bounds it is given.


@lru_cache(maxsize=None)
def f64_constants(t: int):
    """(ext_i, internal, ext_f) in R' form (c 2^260 mod P), 5 limbs each: the
    kernels' round constants."""
    lim = lambda c: tuple(fb.f64_limbs(c * fb.F64_R % P_BN254))
    ext_i, internal, ext_f = constants(t)
    return (tuple(tuple(lim(c) for c in r) for r in ext_i), tuple(lim(c) for c in internal),
            tuple(tuple(lim(c) for c in r) for r in ext_f))


def f64_constant_words(t: int) -> np.ndarray:
    """:func:`f64_constants` flat as uint64 limbs, in the order external
    initial, internal, external final: what the kernels' __constant__
    tables hold."""
    ext_i, internal, ext_f = f64_constants(t)
    flat = [c for r in ext_i for c in r] + list(internal) + [c for r in ext_f for c in r]
    return np.ascontiguousarray(np.array(flat, dtype=np.uint64).reshape(-1))


def _f64_sbox(x):
    x2 = fb.f64_mont(x, None, square=True)
    x4 = fb.f64_mont(x2, None, square=True)
    return fb.f64_mont(x4, x)


def _f64_external(s):
    total = fb.f64_add(*s)
    return [fb.f64_add(total, x) for x in s]


def _f64_full_round(s, rc):
    return _f64_external([_f64_sbox(fb.f64_norm(fb.f64_add(x, c))) for x, c in zip(s, rc)])


def f64_permute(s: list, t: int) -> list:
    """The kernels' ``permute<t>`` on t lanes of limbs (R' form)."""
    ext_i, internal, ext_f = f64_constants(t)
    s = _f64_external(s)
    for rc in ext_i:
        s = _f64_full_round(s, rc)
    for c in internal:
        s[0] = _f64_sbox(fb.f64_norm(fb.f64_add(s[0], c)))
        total = fb.f64_add(*s)
        s[-1] = fb.f64_add(s[-1], s[-1])
        s = [fb.f64_add(total, x) for x in s]
        s = [s[0]] + [fb.f64_reduce(x) for x in s[1:]]
    for rc in ext_f:
        s = _f64_full_round(s, rc)
    return s


def _f64_to_mont(v: int, e: int = 520) -> list:
    """v 2^(e - 260) by one product: e = 520 takes a canonical value to R' form."""
    return fb.f64_mont(fb.f64_limbs(v), fb.f64_limbs(fb.F64_K[e]))


def _f64_digest(x: list) -> int:
    """A lane (R' form) -> its canonical value: the quotient steps alone,
    then one conditional subtract."""
    return fb.f64_canon(fb.f64_redc(x))


def permute_model(state, t: int):
    """``permute_kernel<t>`` by the model: each (t, 8) Monty (R = 2^256) state
    of an (n, t, 8) tensor into R' form by a product with 2^264 mod P,
    permuted, back by a product with 2^256 mod P, made canonical."""
    out = []
    for lanes in np.asarray(fb.to_ints(state), dtype=object).reshape(-1, t):
        s = f64_permute([_f64_to_mont(int(v), 264) for v in lanes], t)
        out += [fb.f64_canon(fb.f64_mont(fb.f64_norm(x), fb.f64_limbs(fb.F64_K[256]))) for x in s]
    return fb.from_ints(out, state.device).reshape(state.shape)


def compress_layer_model(layer, stride: int):
    """``compress_kernel`` by the model (the pairing of :func:`compress_layer_plain`)."""
    v = fb.to_ints(layer)
    n = len(v)
    left = [2 * stride * (o // stride) + o % stride for o in range(n // 2)]
    out = [_f64_digest(f64_permute([_f64_to_mont(v[i]), _f64_to_mont(v[i + stride])], 2)[0]) for i in left]
    return fb.from_ints(out, layer.device)


def hash_rows_model(mat):
    """``hash_rows_kernel`` by the model: per 16-felt block the packed scalars
    into R' form over lanes 0 and 1 (lane 0 alone for a last block of at
    most 8), one width-3 permutation; lane 0's digest."""
    from .multi_field import BABY_BEAR_RATE, FELTS_PER_SCALAR, pack_felts

    rows = _leaf_rows(mat).tolist()
    out = []
    for row in rows:
        s = [[0] * fb.F64_LIMBS for _ in range(3)]
        for i in range(0, len(row), BABY_BEAR_RATE):
            for k, v in enumerate(pack_felts(row[i : i + BABY_BEAR_RATE])):
                s[k] = _f64_to_mont(v)
            s = f64_permute(s, 3)
        out.append(_f64_digest(s[0]))
    return fb.from_ints(out, mat.device)


def f64_permute_bounds(t: int, lane_max: int) -> int:
    """Worst-case values through the kernels' ``permute<t>`` for lanes below
    ``lane_max`` (normalized limbs): asserts every operand of a product is
    below 2^260 and every limb that f64_reduce takes below 2^56; returns
    the bound of the output lanes. A product of values below a and b is
    below a b / 2^260 + P; a sum of k normalized values has limbs below
    k 2^52."""
    R, P, M = fb.F64_R, P_BN254, fb.F64_MASK

    def mont(a, b):
        assert a < R and b < R
        return a * b // R + P

    def sbox(x):
        x2 = mont(x, x)
        return mont(mont(x2, x2), x)

    rc = P  # round constants below P
    r_f, r_p, _ = _PARAMS[t]
    s = [lane_max] * t
    s = [sum(s) + x for x in s]
    for _ in range(r_f // 2):
        s = [sbox(x + rc) for x in s]
        s = [sum(s) + x for x in s]
    for _ in range(r_p):
        s[0] = sbox(s[0] + rc)
        total = sum(s)
        s = [total + s[0]] + [total + x for x in s[1:-1]] + [total + 2 * s[-1]]
        terms = 1 + (t - 1) + 2  # s0 and the reduced lanes, the last twice more
        assert terms * M < 1 << 56
        s = [s[0]] + [3 * P] * (t - 1)
    for _ in range(r_f // 2):
        s = [sbox(x + rc) for x in s]
        s = [sum(s) + x for x in s]
    assert max(s) < R
    return max(s)
