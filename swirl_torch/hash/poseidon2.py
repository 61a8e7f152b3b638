"""Poseidon2-BabyBear-16: the host numpy permutation and sponge, and on
torch tensors the plain permutation and the wrappers of kernels B (leaf
hash), C (2-to-1 compress) and D (tower).

The host half is the copy of ``swirl/hash/poseidon2.py`` (Plonky3's
``Poseidon2BabyBear<16>``: initial M_E, 4 full rounds, 13 partial rounds,
4 full rounds; round constants from :mod:`.constants`); the transcript,
keygen and the native library read :func:`constants` from here. The torch
half is the peer of ``swirl/hash/jposeidon2.py`` (``hash_cols`` :195,
``compress_cols`` :208, ``merkle_tower`` :249). Digest layers are
lane-major ``(8, n)`` canonical int64 tensors.

Each wrapper launches its CUDA kernel for a CUDA tensor and runs the plain
PyTorch version beside it for a CPU tensor.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch

from .. import kernels as K
from ..fields import field as F
from ..fields.babybear import P, U64
from . import constants as _rc

WIDTH = 16
RATE = 8
DIGEST = 8
FULL_ROUNDS = 8
PARTIAL_ROUNDS = 13
N_BITS = 31

# Internal-layer diagonal d_i (canonical values). This is the
# shift-friendly diagonal family used by Plonky3 for BabyBear width 16:
# [-2, 1, 2, 1/2, 3, 4, -1/2, -3, -4, 1/2^8, 1/4, 1/8, 1/2^27, -1/2^8, -1/16, -1/2^27]
_inv = lambda x: pow(x, P - 2, P)
INTERNAL_DIAG = [
    P - 2,
    1,
    2,
    _inv(2),
    3,
    4,
    P - _inv(2),
    P - 3,
    P - 4,
    _inv(1 << 8),
    _inv(4),
    _inv(8),
    _inv(1 << 27),
    P - _inv(1 << 8),
    P - _inv(16),
    P - _inv(1 << 27),
]


@lru_cache(maxsize=None)
def constants():
    """Round-constant tables (canonical uint64): the vendored reference-parity
    HorizenLabs/Plonky3 RC16 instance (see :mod:`.constants`)."""
    return (
        np.array(_rc.EXTERNAL_INITIAL, dtype=np.uint64),
        np.array(_rc.INTERNAL, dtype=np.uint64),
        np.array(_rc.EXTERNAL_FINAL, dtype=np.uint64),
        np.array(INTERNAL_DIAG, dtype=np.uint64),
    )


# ---------------------------------------------------------------------------
# Host (numpy) implementation. State: uint64 array (..., 16), canonical.
# ---------------------------------------------------------------------------

_P = U64(P)


def _sbox_np(x):
    x2 = (x * x) % _P
    x4 = (x2 * x2) % _P
    x6 = (x4 * x2) % _P
    return (x6 * x) % _P


def _m4_np(s):
    """Apply M4 = circ-style [[2,3,1,1],[1,2,3,1],[1,1,2,3],[3,1,1,2]] to
    (..., 4) lanes using the cheap add-chain."""
    x0, x1, x2, x3 = (s[..., i] for i in range(4))
    t01 = (x0 + x1) % _P
    t23 = (x2 + x3) % _P
    t0123 = (t01 + t23) % _P
    t01123 = (t0123 + x1) % _P
    t01233 = (t0123 + x3) % _P
    out0 = (t01123 + t01) % _P
    out1 = (t01123 + 2 * x2) % _P
    out2 = (t01233 + t23) % _P
    out3 = (t01233 + 2 * x0) % _P
    return np.stack([out0, out1, out2, out3], axis=-1)


def _external_np(s):
    s4 = s.reshape(s.shape[:-1] + (4, 4))
    s4 = _m4_np(s4)
    sums = s4.sum(axis=-2, dtype=np.uint64) % _P  # (..., 4)
    s4 = (s4 + sums[..., None, :]) % _P
    return s4.reshape(s.shape)


def _internal_np(s, diag):
    total = s.sum(axis=-1, dtype=np.uint64) % _P
    return (s * diag + total[..., None]) % _P


def permute_np(state: np.ndarray) -> np.ndarray:
    """Poseidon2 permutation on (..., 16) canonical uint64 arrays.

    Dispatches to the native C++ kernel (swirl/native) when available; the
    numpy path below is the bit-exact fallback and spec.
    """
    from .. import native

    if native.available():
        return native.permute_batch(np.asarray(state, dtype=np.uint64) % _P)
    return _permute_np_py(state)


def _permute_np_py(state: np.ndarray) -> np.ndarray:
    ext_init, internal, ext_final, diag = constants()
    s = np.asarray(state, dtype=np.uint64) % _P
    s = _external_np(s)
    for rc in ext_init:
        s = _sbox_np((s + rc) % _P)
        s = _external_np(s)
    for rc in internal:
        s0 = _sbox_np((s[..., 0] + rc) % _P)
        s = s.copy()
        s[..., 0] = s0
        s = _internal_np(s, diag)
    for rc in ext_final:
        s = _sbox_np((s + rc) % _P)
        s = _external_np(s)
    return s


# ---------------------------------------------------------------------------
# Host hashing helpers (numpy, canonical). Used by verifier/keygen/transcript.
# ---------------------------------------------------------------------------


def hash_slice_np(vals) -> np.ndarray:
    """Padding-free sponge, rate 8, digest = first 8 lanes of final state.

    Mirrors Plonky3 PaddingFreeSponge semantics: overwrite state[:len(chunk)]
    per RATE-sized chunk (last chunk may be partial), permute after each.
    """
    vals = np.asarray(vals, dtype=np.uint64).ravel() % _P
    from .. import native

    if native.available():
        return native.hash_rows(vals.reshape(1, -1))[0]
    state = np.zeros(WIDTH, dtype=np.uint64)
    for i in range(0, len(vals), RATE):
        chunk = vals[i : i + RATE]
        state[: len(chunk)] = chunk
        state = permute_np(state)
    return state[:DIGEST]


def hash_rows_np(mat: np.ndarray) -> np.ndarray:
    """Batched hash_slice over rows of a 2D (n, w) canonical array -> (n, 8)."""
    mat = np.asarray(mat, dtype=np.uint64) % _P
    from .. import native

    if native.available():
        return native.hash_rows(mat)
    n, w = mat.shape
    state = np.zeros((n, WIDTH), dtype=np.uint64)
    if w == 0:
        # p3 PaddingFreeSponge on empty input: no permutation, zero digest.
        return state[:, :DIGEST]
    for i in range(0, w, RATE):
        chunk = mat[:, i : i + RATE]
        state[:, : chunk.shape[1]] = chunk
        state = permute_np(state)
    return state[:, :DIGEST]


def compress_np(left: np.ndarray, right: np.ndarray) -> np.ndarray:
    """2-to-1 truncated-permutation compression on (..., 8) digests."""
    state = np.concatenate([left, right], axis=-1)
    return permute_np(state)[..., :DIGEST]


# ---------------------------------------------------------------------------
# Torch tensors: plain versions and kernel wrappers.
# ---------------------------------------------------------------------------

# largest layer the tower kernel (D) takes in one launch
TOWER_MAX = 8192


@lru_cache(maxsize=None)
def _constants(device: str):
    return tuple(F.const_arr(c, device) for c in constants())


def _sbox(x):
    x2 = F.mul(x, x)
    x4 = F.mul(x2, x2)
    return F.mul(F.mul(x4, x2), x)


def _m4(s):
    """The 4x4 MDS block on canonical values, reduced once at the end: every
    output sums at most 7 inputs, far below 2^63."""
    x0, x1, x2, x3 = s.unbind(-1)
    t01 = x0 + x1
    t23 = x2 + x3
    t0123 = t01 + t23
    t01123 = t0123 + x1
    t01233 = t0123 + x3
    return torch.stack([t01123 + t01, t01123 + 2 * x2, t01233 + t23, t01233 + 2 * x0], dim=-1) % P


def _external(s):
    s4 = _m4(s.reshape(s.shape[:-1] + (4, 4)))
    s4 = (s4 + s4.sum(dim=-2, keepdim=True)) % P
    return s4.reshape(s.shape)


def permute_plain(state):
    """Poseidon2 permutation of (..., 16) canonical int64 tensors."""
    ext_init, internal, ext_final, diag = _constants(str(state.device))
    s = _external(state)
    for rc in ext_init:
        s = _external(_sbox(F.add(s, rc)))
    for rc in internal:
        s0 = _sbox(F.add(s[..., :1], rc))
        s = torch.cat([s0, s[..., 1:]], dim=-1)
        # a product below 2^62 plus 16 canonical values stays below 2^63
        s = (s * diag + s.sum(dim=-1, keepdim=True)) % P
    for rc in ext_final:
        s = _external(_sbox(F.add(s, rc)))
    return s


# ---------------------------------------------------------------------------
# CPU model of the kernels' arithmetic (csrc/poseidon2.cu), step for step on
# int64 tensors that hold the kernels' uint32 words, with every bound the
# kernels rely on asserted. The CUDA cannot run without the card; this model
# is held to permute_plain and the host permutation by the CPU tests.
# ---------------------------------------------------------------------------

_M32 = (1 << 32) - 1
_MU = 0x88000001  # P^-1 mod 2^32 = 1 + 2^27 + 2^31
_R2 = (1 << 64) % P


def _below(x, bound, what):
    x = torch.as_tensor(x)
    if x.numel() == 0:
        return x
    lo, hi = torch.aminmax(x)
    if lo < 0 or hi >= bound:
        raise AssertionError(f"poseidon2 model: {what} leaves [0, {bound})")
    return x


def _add_m(a, b):
    s = _below(a, P, "add") + _below(b, P, "add")
    return torch.minimum(s, (s - P) & _M32)


def _sub_m(a, b):
    d = (_below(a, P, "sub") - _below(b, P, "sub")) & _M32
    return torch.minimum(d, (d + P) & _M32)


def _lo_mu(lo):
    """lo * P^-1 mod 2^32, by the shifts of MU (lo * MU overflows int64)."""
    return (lo + (lo << 27) + (lo << 31)) & _M32


def _mont_lazy_m(a, b):
    t = _below(_below(a, 1 << 32, "product") * _below(b, P, "product"), P << 32, "product")
    h = (_lo_mu(t & _M32) * P) >> 32
    return _below((t >> 32) - h + P, 2 * P, "lazy product")


def _mont_m(a, b):
    r = _mont_lazy_m(a, b)
    return torch.minimum(r, (r - P) & _M32)


def _from_mont_m(x):
    h = (_lo_mu(_below(x, P, "from_mont")) * P) >> 32
    return torch.minimum((-h) & _M32, P - h)


def _halve_m(x):
    return (_below(x, P, "halve") + (x & 1) * P) >> 1


def div2k_model(x, k: int):
    """x * 2^-k mod P for canonical x, 1 <= k <= 27, by the kernels' shift
    form: hi + P - 15 * 2^(27-k) * lo lies in [1, 2P)."""
    lo = _below(x, P, "div2k") & ((1 << k) - 1)
    v = _below((x >> k) + P - lo * (15 << (27 - k)), 2 * P, "div2k")
    w = (v - P) & _M32
    return torch.minimum((w + P) & _M32, w)


def _sbox_m(x):
    x2 = _mont_m(x, x)
    x3 = _mont_lazy_m(x2, x)  # < 2P: its product with x4 < P stays below P * 2^32
    x4 = _mont_m(x2, x2)
    return _mont_m(x3, x4)


def _m4_m(x0, x1, x2, x3):
    t01, t23 = _add_m(x0, x1), _add_m(x2, x3)
    t0123 = _add_m(t01, t23)
    t01123, t01233 = _add_m(t0123, x1), _add_m(t0123, x3)
    return [
        _add_m(t01123, t01),
        _add_m(t01123, _add_m(x2, x2)),
        _add_m(t01233, t23),
        _add_m(t01233, _add_m(x0, x0)),
    ]


def _external_m(s):
    s = sum((_m4_m(*s[4 * c : 4 * c + 4]) for c in range(4)), [])
    for j in range(4):
        tot = _add_m(_add_m(s[j], s[4 + j]), _add_m(s[8 + j], s[12 + j]))
        for c in range(4):
            s[4 * c + j] = _add_m(s[4 * c + j], tot)
    return s


def _partial_m(s, rc):
    a = [_add_m(s[1 + 2 * i], s[2 + 2 * i]) for i in range(7)] + [s[15]]
    a = [_add_m(a[2 * i], a[2 * i + 1]) for i in range(4)]
    part = _add_m(_add_m(a[0], a[1]), _add_m(a[2], a[3]))
    x = _sbox_m(_add_m(s[0], rc))
    full = _add_m(part, x)
    dbl = lambda v: _add_m(v, v)  # noqa: E731
    return [
        _sub_m(part, x),  # -2
        _add_m(s[1], full),  # 1
        _add_m(dbl(s[2]), full),  # 2
        _add_m(_halve_m(s[3]), full),  # 1/2
        _add_m(_add_m(dbl(s[4]), s[4]), full),  # 3
        _add_m(dbl(dbl(s[5])), full),  # 4
        _sub_m(full, _halve_m(s[6])),  # -1/2
        _sub_m(full, _add_m(dbl(s[7]), s[7])),  # -3
        _sub_m(full, dbl(dbl(s[8]))),  # -4
        _add_m(div2k_model(s[9], 8), full),
        _add_m(div2k_model(s[10], 2), full),
        _add_m(div2k_model(s[11], 3), full),
        _add_m(div2k_model(s[12], 27), full),
        _sub_m(full, div2k_model(s[13], 8)),
        _sub_m(full, div2k_model(s[14], 4)),
        _sub_m(full, div2k_model(s[15], 27)),
    ]


def permute_model(state):
    """Poseidon2 of (..., 16) canonical int64 tensors by the kernels' own
    steps: Montgomery lanes, lazy products, the diagonal without products
    (Plonky3's diag, :data:`INTERNAL_DIAG`), the tree sum of lanes 1..15."""
    ext_init, internal, ext_final, _ = (
        [int(v) * (1 << 32) % P for v in np.asarray(c).ravel()] for c in constants()
    )
    s = [_mont_m(x, torch.full_like(x, _R2)) for x in state.unbind(-1)]
    s = _external_m(s)
    for r in range(4):
        s = _external_m([_sbox_m(_add_m(s[i], ext_init[16 * r + i])) for i in range(WIDTH)])
    for rc in internal:
        s = _partial_m(s, rc)
    for r in range(4):
        s = _external_m([_sbox_m(_add_m(s[i], ext_final[16 * r + i])) for i in range(WIDTH)])
    return torch.stack([_from_mont_m(x) for x in s], dim=-1)


def _leaf_rows(mat):
    """A (w, n) matrix, or a (w, n, d) one as its (w*d, n) rows c*d + e."""
    if mat.dim() == 3:
        w, n, d = mat.shape
        return mat.permute(0, 2, 1).reshape(w * d, n)
    return mat


def hash_cols_plain(mat):
    """Padding-free rate-8 sponge over each column of a (w, n) matrix ->
    (8, n): the absorb overwrites the leading lanes of the state, and a short
    last chunk keeps the other lanes. A (w, n, d) matrix hashes as its
    (w*d, n) rows c*d + e."""
    mat = _leaf_rows(mat)
    w, n = mat.shape
    state = torch.zeros((n, WIDTH), dtype=F.DTYPE, device=mat.device)
    for i in range(0, w, RATE):
        chunk = mat[i : i + RATE].T
        state = torch.cat([chunk, state[:, chunk.shape[1] :]], dim=1)
        state = permute_plain(state)
    return state[:, :DIGEST].T.contiguous()


def compress_cols_plain(pairs):
    """(16, n) digest pairs [left; right] -> (8, n): one truncated permutation."""
    return permute_plain(pairs.T)[:, :DIGEST].T.contiguous()


def compress_layer_plain(layer, stride: int):
    """(8, n) digest layer -> (8, n/2): output column o compresses digest
    2*stride*(o // stride) + o % stride with the digest stride columns after it."""
    n = layer.shape[1]
    g = layer.reshape(DIGEST, n // (2 * stride), 2, stride)
    half = n // 2
    return compress_cols_plain(torch.cat([g[:, :, 0].reshape(DIGEST, half), g[:, :, 1].reshape(DIGEST, half)]))


def merkle_tower_plain(digests) -> list:
    layers = []
    cur = digests
    while cur.shape[1] > 1:
        cur = compress_layer_plain(cur, 1)
        layers.append(cur)
    return layers


def hash_cols(mat):
    """Kernel B: (w, n) canonical matrix -> (8, n) column digests. A
    contiguous (w, n, d) extension-field matrix (d a power of two) is read
    in place as its (w*d, n) rows c*d + e."""
    if not mat.is_cuda:
        return hash_cols_plain(mat)
    K.require(mat, (2, 3), "hash_cols")
    d = mat.shape[2] if mat.dim() == 3 else 1
    if d & (d - 1) or d == 0:
        raise K.KernelError(f"hash_cols: the last of {tuple(mat.shape)} is not a power of two")
    w, n = mat.shape[0] * d, mat.shape[1]
    out = torch.empty((DIGEST, n), dtype=F.DTYPE, device=mat.device)
    K.LIB.launch(
        K.HASH_COLS, "swirl_p2_hash_cols", mat, mat.data_ptr(), out.data_ptr(), w, n, d.bit_length() - 1
    )
    return out


def _compress_launch(t, out, m, ld, log_s, off):
    K.LIB.launch(K.COMPRESS, "swirl_p2_compress", t, t.data_ptr(), out.data_ptr(), m, ld, log_s, off)
    return out


def compress_cols(pairs):
    """Kernel C: (16, n) lane-major digest pairs -> (8, n)."""
    if not pairs.is_cuda:
        return compress_cols_plain(pairs)
    K.require(pairs, 2, "compress_cols")
    if pairs.shape[0] != WIDTH:
        raise K.KernelError(f"compress_cols: expected 16 rows, got {pairs.shape[0]}")
    n = pairs.shape[1]
    out = torch.empty((DIGEST, n), dtype=F.DTYPE, device=pairs.device)
    # left digest o at column o (log_s 62 keeps o whole), right at row 8
    return _compress_launch(pairs, out, n, n, 62, DIGEST * n)


def compress_layer(layer, stride: int):
    """Kernel C on a (8, n) layer read in place: output column o compresses
    digest 2*stride*(o // stride) + o % stride with the one stride columns
    after it (stride a power of two, 2*stride dividing n)."""
    if not layer.is_cuda:
        return compress_layer_plain(layer, stride)
    K.require(layer, 2, "compress_layer")
    n = layer.shape[1]
    if layer.shape[0] != DIGEST or stride < 1 or stride & (stride - 1) or n % (2 * stride):
        raise K.KernelError(f"compress_layer: stride {stride} does not pair {tuple(layer.shape)}")
    out = torch.empty((DIGEST, n // 2), dtype=F.DTYPE, device=layer.device)
    return _compress_launch(layer, out, n // 2, n, stride.bit_length() - 1, stride)


# the counters of each (device index, stream): the tower's ticket, the
# grind's (found word, ticket) pair and the GKR pass's ticket as
# :class:`Tickets`, zero (the found word all ones) between launches, views
# of one allocation (:func:`_counters`). torch hands out pooled streams
# round robin, so a stream's handle recurs; a capture takes its own
# (private_tickets) instead.
_TICKETS = {}
_PRIVATE = threading.local()


class Tickets(NamedTuple):
    """One stream's or capture's counters: kernel D's ticket (int32),
    kernel F's (found word, ticket) pair (int64) and kernel K's ticket
    (int32, ``prover/gkr.py``)."""

    tower: torch.Tensor
    grind: torch.Tensor
    gkr: torch.Tensor


def _counters(device) -> Tickets:
    """One int64 quadruple (F's found word, all ones; F's ticket; D's
    ticket and K's, each the int32 low half of its word), as its three
    views."""
    t = torch.tensor([-1, 0, 0, 0], dtype=torch.int64, device=device)
    return Tickets(t[2:3].view(torch.int32)[:1], t[:2], t[3:].view(torch.int32)[:1])


@contextmanager
def private_tickets(device):
    """Kernel D's, F's and K's launches on ``device`` from this thread inside it
    use counters made here (armed) and yielded, as :class:`Tickets`, for the
    caller to keep: the graphs captured inside it read them at every replay,
    and no other launch shares them."""
    own = _counters(device)
    prev = getattr(_PRIVATE, "own", None)
    _PRIVATE.own = own
    try:
        yield own
    finally:
        _PRIVATE.own = prev


def tickets(device) -> Tickets:
    """The counters of the capture inside :func:`private_tickets`, else of
    ``device``'s current stream (made at its first call, outside a capture)."""
    own = getattr(_PRIVATE, "own", None)
    if own is not None and own.tower.device == device:
        return own
    key = (device.index, torch.cuda.current_stream(device).cuda_stream)
    if key not in _TICKETS:
        if torch.cuda.is_current_stream_capturing():  # a captured fill runs only at replay
            raise K.KernelError("compress_tower, grind, gkr_round: call one on this stream before capturing it")
        _TICKETS[key] = _counters(device)
    return _TICKETS[key]


def _tower_layers(flat, n: int) -> list:
    """The (8, m) views of every level, m = n/2 down to 1, of the flat
    tower output: level m at offset 8 * (n - 2m)."""
    layers = []
    m = n // 2
    while m >= 1:
        off = DIGEST * (n - 2 * m)
        layers.append(flat[off : off + DIGEST * m].view(DIGEST, m))
        m //= 2
    return layers


def compress_tower(digests) -> list:
    """Kernel D: every layer above a (8, n) layer, 2 <= n <= TOWER_MAX a power
    of two, down to the (8, 1) root, in one launch."""
    if not digests.is_cuda:
        return merkle_tower_plain(digests)
    K.require(digests, 2, "compress_tower")
    n = digests.shape[1]
    if digests.shape[0] != DIGEST or not 2 <= n <= TOWER_MAX or n & (n - 1):
        raise K.KernelError(f"compress_tower: unsupported shape {tuple(digests.shape)}")
    flat = torch.empty(DIGEST * (n - 1), dtype=F.DTYPE, device=digests.device)
    counter = tickets(digests.device).tower
    K.LIB.launch(K.TOWER, "swirl_p2_tower", digests, digests.data_ptr(), flat.data_ptr(), n, counter.data_ptr())
    return _tower_layers(flat, n)


# ---------------------------------------------------------------------------
# Kernels E (duplex) and F (grind): the Fiat-Shamir sponge of the device
# transcript (prover/device_transcript.py) on the card. The state is a (16,)
# canonical int64 tensor, updated in place; the cursors are host ints.
# ---------------------------------------------------------------------------

HOST_MAX = 32  # host felts one duplex launch takes by value (csrc HOST_MAX)


def _check_duplex(state, a: int, s: int, n_host: int, n_squeeze: int, bits: int) -> None:
    if tuple(state.shape) != (WIDTH,):
        raise ValueError(f"duplex: the state is {tuple(state.shape)}, not ({WIDTH},)")
    if not (0 <= a < RATE and 0 <= s <= RATE):
        raise ValueError(f"duplex: cursors (absorb {a}, sample {s}) out of range")
    if not 0 <= n_host <= HOST_MAX or n_squeeze < 0 or not -1 <= bits <= 30:
        raise ValueError(f"duplex: {n_host} host felts, {n_squeeze} squeezes, bits {bits}")


def duplex_plain(state, absorb, host, a: int, s: int, n_squeeze: int, bits: int = -1):
    """Kernel E's function: absorb the felts of ``absorb`` (a flat tensor or
    None) and then the host ints ``host`` from the cursors (a, s), overwrite
    mode, then squeeze ``n_squeeze`` values masked to ``bits`` low bits (-1:
    unmasked). Returns (new state, (n_squeeze,) values)."""
    vals = [] if absorb is None else [absorb.reshape(-1)]
    if len(host):
        vals.append(torch.tensor([int(v) for v in host], dtype=F.DTYPE, device=state.device))
    vals = torch.cat(vals) if vals else state[:0]
    off = 0
    while off < vals.shape[0]:
        n = min(RATE - a, vals.shape[0] - off)
        state = torch.cat([state[:a], vals[off : off + n], state[a + n :]])
        a, off = a + n, off + n
        if a == RATE:
            state, a, s = permute_plain(state), 0, RATE
    out = []
    for _ in range(n_squeeze):
        if a != 0 or s == 0:
            state, a, s = permute_plain(state), 0, RATE
        s -= 1
        out.append(state[s])
    out = torch.stack(out) if out else state[:0]
    return state, out if bits < 0 else out & ((1 << bits) - 1)


def duplex(state, absorb, host, a: int, s: int, n_squeeze: int, bits: int = -1):
    """Kernel E: :func:`duplex_plain` in one launch, the (16,) state updated
    in place; returns the squeezed values. ``host`` holds at most
    :data:`HOST_MAX` canonical ints, taken after ``absorb``."""
    _check_duplex(state, a, s, len(host), n_squeeze, bits)
    if not state.is_cuda:
        new, out = duplex_plain(state, absorb, host, a, s, n_squeeze, bits)
        state.copy_(new)
        return out
    K.require(state, 1, "duplex")
    k = 0
    if absorb is not None:
        K.require(absorb, 1, "duplex")
        k = absorb.shape[0]
    out = torch.empty(n_squeeze, dtype=F.DTYPE, device=state.device)
    h = np.ascontiguousarray(host, dtype=np.uint32)
    K.LIB.launch(
        K.DUPLEX, "swirl_p2_duplex", state, state.data_ptr(), absorb.data_ptr() if k else None, k,
        h.ctypes.data if len(h) else None, len(h), a, s, n_squeeze, bits, out.data_ptr(),
    )
    return out


def _check_grind(state, a: int, bits: int) -> None:
    if tuple(state.shape) != (WIDTH,) or not 0 <= a < RATE:
        raise ValueError(f"grind: state {tuple(state.shape)}, absorb cursor {a}")
    if not 1 <= bits <= 30:  # 2^bits < P
        raise ValueError(f"grind: {bits} bits; a witness needs 1 to 30")


def grind_plain(state, a: int, bits: int):
    """Kernel F's function: the smallest w in [0, P) such that observe(w) at
    absorb cursor ``a`` and then ``sample_bits(bits)`` give 0, and the
    state after both (one permutation with word a set to w; the sample is
    word RATE - 1). Returns (new state, w), or (state, -1) with no witness."""
    mask = (1 << bits) - 1
    # on the CPU the batch grows from 2^12 to 2^16 candidates, where the
    # per-op cost stops paying for the overshoot past a short search
    batch, most = (1 << 16, 1 << 16) if state.is_cuda else (1 << 12, 1 << 16)
    start = 0
    while start < P:
        cand = torch.arange(start, min(start + batch, P), dtype=F.DTYPE, device=state.device)
        states = state.expand(cand.shape[0], WIDTH).clone()
        states[:, a] = cand
        out = permute_plain(states)
        hits = (out[:, RATE - 1] & mask) == 0
        if bool(hits.any()):
            i = int(torch.argmax(hits.to(torch.int8)))
            return out[i], cand[i]
        start += batch
        batch = min(2 * batch, most)
    return state, torch.tensor(-1, dtype=F.DTYPE, device=state.device)


def grind(state, a: int, bits: int):
    """Kernel F: :func:`grind_plain` on the card in one launch, the (16,)
    state advanced in place (the squeeze cursor is then RATE - 1, the absorb
    cursor 0); returns the witness as a 0-d tensor, -1 if there is none."""
    _check_grind(state, a, bits)
    if not state.is_cuda:
        new, w = grind_plain(state, a, bits)
        state.copy_(new)
        return w
    K.require(state, 1, "grind")
    scratch = tickets(state.device).grind
    w = torch.empty((), dtype=F.DTYPE, device=state.device)
    K.LIB.launch(K.GRIND, "swirl_p2_grind", state, state.data_ptr(), a, bits, scratch.data_ptr(), w.data_ptr())
    return w


# ---------------------------------------------------------------------------
# Kernel D (csrc/poseidon2.cu tower_kernel): its permutation split over a
# quad of lanes, and its plan, checked on index arrays; a CPU model runs
# both step for step.
# ---------------------------------------------------------------------------

TOWER_BLOCK = 128  # digests a block folds
TOWER_ROW = TOWER_BLOCK // 2 + 4  # shared words of a lane row of a level
QUAD = 4  # lanes of one permutation: lane q holds state words 4q .. 4q + 3
_WARP = 32
_Q = torch.arange(QUAD)


def _quad_xor(x, mask: int):
    """__shfl_xor_sync(x, mask) within each quad: x (..., QUAD), one value a lane."""
    return x[..., _Q ^ mask]


def _quad_external_m(x):
    """M_E on words x[0..3], each (..., QUAD): M4 in each lane, then the sum
    over the quad of each word position by two shuffles."""
    x = _m4_m(*x)
    out = []
    for xj in x:
        t = _add_m(xj, _quad_xor(xj, 1))
        out.append(_add_m(xj, _add_m(t, _quad_xor(t, 2))))
    return out


def permute_quad_model(state):
    """Poseidon2 of (..., 16) canonical int64 tensors by kernel D's quad
    (``permute_quad``): lane q holds Montgomery words 4q .. 4q + 3, the
    partial rounds take every lane's word-0 S-box and use lane 0's through
    a broadcast, and the diagonal is a Montgomery product by each lane's
    d_i. The lane axis is the last; shuffles are index maps over it."""
    ext_init, internal, ext_final, diag = (
        torch.tensor([int(v) * (1 << 32) % P for v in np.asarray(c).ravel()]) for c in constants()
    )
    lanes = lambda c: c.reshape(-1, QUAD, 4).transpose(1, 2)  # noqa: E731  (rounds, word i, lane q)
    init, fin, d = lanes(ext_init), lanes(ext_final), lanes(diag)[0]
    s = _mont_m(state, torch.full_like(state, _R2)).reshape(state.shape[:-1] + (QUAD, 4))
    x = _quad_external_m(list(s.unbind(-1)))
    for r in range(4):
        x = _quad_external_m([_sbox_m(_add_m(x[i], init[r, i])) for i in range(4)])
    lane0 = _Q == 0
    for rc in internal:
        y = _sbox_m(_add_m(x[0], rc))
        own = _add_m(_add_m(torch.where(lane0, 0, x[0]), x[1]), _add_m(x[2], x[3]))
        t = _add_m(own, _quad_xor(own, 1))
        full = _add_m(_add_m(t, _quad_xor(t, 2)), y[..., :1].expand_as(y))
        x[0] = torch.where(lane0, y, x[0])
        x = [_add_m(_mont_m(x[i], d[i].expand_as(x[i])), full) for i in range(4)]
    for r in range(4):
        x = _quad_external_m([_sbox_m(_add_m(x[i], fin[r, i])) for i in range(4)])
    return _from_mont_m(torch.stack(x, dim=-1).reshape(state.shape))


def _tower_fold(n: int, src: str, base: int, width: int, parts, count: int, by: str) -> dict:
    """One fold of the kernel (``tower_fold``): block b of ``parts`` folds
    ``count`` digests of an (8, width) layer at flat ``base`` of ``src``,
    from column b * count, to one. At level l (m = count >> l pairs) thread
    t = 4p + q (p < m) loads lane rows 4 (q & 1) .. + 3 of digest 2p + q // 2:
    at level 1 from ``src[load]`` (its 4 words), above it from the shared
    words ``read[t]`` (lane row r of digest k at r * TOWER_ROW + k); lanes
    q < 2 then store lane rows 4q .. 4q + 3 of output digest p at shared
    ``write`` and flat ``out[b, p, lane]``."""
    from ..prover.ntt import bank_conflicts

    levels = []
    m, l, prev_out = count // 2, 1, None
    j4 = torch.arange(4)
    while m >= 1:
        w = width >> l
        t = torch.arange(max(QUAD * m, _WARP))  # a warp with a pair runs whole
        p, q = torch.clamp(t // QUAD, max=m - 1), t % QUAD
        k = 2 * p + q // 2
        rows = (4 * (q % 2))[:, None] + j4[None, :]  # (threads, 4)
        lvl = {"m": m, "load": None, "read": None}
        if l == 1:
            cols = parts[:, None, None] * count + k[None, :, None]
            lvl["load"] = base + rows[None] * width + cols  # (P, threads, 4)
        else:
            read = rows * TOWER_ROW + k[:, None]
            # the words the previous level wrote for those lanes of those digests
            if not torch.equal(read, prev_out[k[:, None], rows]):
                raise AssertionError(f"tower level {m}: its loads miss the words level {2 * m} wrote")
            for j in range(4):
                if bank_conflicts(read[:, j]) != 1:
                    raise AssertionError(f"tower level {m}: load {j} conflicts")
            lvl["read"] = read
        if m > TOWER_ROW:
            raise AssertionError(f"tower level {m}: its digests leave the rows")
        p_out = torch.arange(m)
        lane = torch.arange(DIGEST)
        write = lane[None, :] * TOWER_ROW + p_out[:, None]  # (m, 8): lane row r of digest p
        for j in range(4):  # lanes 0 and 1 of each quad store lane rows j and 4 + j
            stores = write[:, [j, 4 + j]].reshape(-1)  # thread order 4p, 4p + 1
            group = (QUAD * p_out[:, None] + torch.arange(2)[None, :]).reshape(-1) // _WARP
            if bank_conflicts(stores, group) != 1:
                raise AssertionError(f"tower level {m}: store {j} conflicts")
        lvl["write"] = write
        lvl["out"] = (DIGEST * (n - 2 * w) + lane[None, None, :] * w
                      + parts[:, None, None] * m + p_out[None, :, None])  # (P, m, 8)
        levels.append(lvl)
        prev_out, m, l = write, m // 2, l + 1
    return {"by": by, "src": src, "parts": parts, "count": count, "levels": levels}


def tower_plan(n: int) -> dict:
    """Kernel D's decomposition of an (8, n) digest layer: G = n / count
    blocks of 2 * count threads, at least a warp (count = min(n,
    TOWER_BLOCK)), one quad of 4 lanes a permutation (lane q holds state
    words 4q .. 4q + 3; its
    shuffle partners are q ^ 1 and q ^ 2, and lane 0 broadcasts the
    partial S-box); block b folds input columns [b * count, (b + 1) * count)
    and writes each level's slice out; the block that draws the last ticket
    (any of them) folds the G roots, read back from the output, to the root.
    Asserts that every level's loads are the shared words the level below
    stored, that every warp access to shared memory is conflict-free, that
    the top fold's loads are the roots the blocks wrote, and that every
    flat output index of [0, 8 (n - 1)) is written exactly once. Returns
    {"blocks", "threads", "ranges", "folds", "quad"}."""
    if not 2 <= n <= TOWER_MAX or n & (n - 1):
        raise ValueError(f"tower_plan: n = {n} is not a power of two in [2, {TOWER_MAX}]")
    count = min(n, TOWER_BLOCK)
    g = n // count
    if g > count:
        raise AssertionError(f"tower_plan: {g} roots do not fit one block's {count // 2} quads")
    folds = [_tower_fold(n, "in", 0, n, torch.arange(g), count, "every block")]
    if g > 1:
        top = _tower_fold(n, "out", DIGEST * (n - 2 * g), g, torch.tensor([0]), g, "the last ticket")
        roots = folds[0]["levels"][-1]["out"].reshape(-1)
        if not torch.equal(torch.unique(top["levels"][0]["load"]), torch.sort(roots).values):
            raise AssertionError("tower_plan: the top fold does not load the blocks' roots")
        folds.append(top)
    written = torch.cat([lvl["out"].reshape(-1) for f in folds for lvl in f["levels"]])
    if not torch.equal(torch.sort(written).values, torch.arange(DIGEST * (n - 1))):
        raise AssertionError("tower_plan: not every output index written exactly once")
    quad = {"words": [list(range(4 * q, 4 * q + 4)) for q in range(QUAD)],
            "xor_partners": [[q ^ 1, q ^ 2] for q in range(QUAD)], "broadcast_from": 0}
    ranges = [(b * count, (b + 1) * count) for b in range(g)]
    return {"blocks": g, "threads": max(2 * count, _WARP), "ranges": ranges, "folds": folds, "quad": quad}


def compress_tower_model(digests) -> list:
    """:func:`compress_tower` on a CPU (8, n) layer by kernel D's plan, step
    for step with :func:`permute_quad_model`: the subtree folds of every
    block, each level's shared words in a buffer of its own (canonical
    values, where the kernel keeps Montgomery form), then the top fold from
    the roots in the output. Asserts that no load finds a word unwritten
    and that every output digest is written exactly once."""
    n = digests.shape[1]
    plan = tower_plan(n)
    flat = torch.full((DIGEST * (n - 1),), -1, dtype=F.DTYPE)
    writes = torch.zeros_like(flat)
    for fold in plan["folds"]:
        src = digests.reshape(-1) if fold["src"] == "in" else flat
        nb = len(fold["parts"])
        buf = torch.full((nb, 2, DIGEST * TOWER_ROW), -1, dtype=F.DTYPE)
        for l, lvl in enumerate(fold["levels"], start=1):
            m = lvl["m"]
            words = src[lvl["load"]] if lvl["read"] is None else buf[:, (l - 1) & 1][:, lvl["read"]]
            if bool((words < 0).any()):
                raise AssertionError(f"tower model, level {m}: a load of a word never written")
            state = words[:, : QUAD * m].reshape(nb, m, WIDTH)  # thread 4p + q holds words 4q ..
            res = permute_quad_model(state)[..., :DIGEST]
            buf[:, l & 1, lvl["write"]] = res
            flat[lvl["out"]] = res
            writes[lvl["out"]] += 1
    if not bool((writes == 1).all()):
        raise AssertionError("tower model: an output digest written other than once")
    return _tower_layers(flat, n)


def merkle_tower(digests) -> list:
    """All binary-compression layers above a (8, n) digest layer, down to the
    (8, 1) root: one in-place compress launch per level above TOWER_MAX,
    then the rest in one tower launch."""
    layers = []
    cur = digests
    while cur.shape[1] > TOWER_MAX:
        cur = compress_layer(cur, 1)
        layers.append(cur)
    if cur.shape[1] > 1:
        layers.extend(compress_tower(cur))
    return layers


# ---------------------------------------------------------------------------
# Kernel E (csrc/poseidon2.cu duplex_kernel): its permutation with one state
# word a lane (``permute_row``) and its absorb loop, step for step on the CPU.
# ---------------------------------------------------------------------------

ROW = 16  # lanes of one of kernel E's permutations: lane l holds word l
_L = torch.arange(ROW)
_MONT15 = 15 * (1 << 32) % P  # 15 in Montgomery form


def _row(x, src):
    """__shfl_sync(x, src) within the 16 lanes: x (..., ROW), src a lane map."""
    return x[..., src]


def _row_external_m(x, rc):
    """M_E then + rc on words x (..., ROW): the column sums from lanes l ^ 4,
    l ^ 8, l ^ 12 (z = x_g + S), then M4's rotated row (2, 3, 1, 1) from the
    group's lanes 4g + (i + k) % 4, with the constant in the same add tree."""
    a, b, d = (_row(x, _L ^ m) for m in (4, 8, 12))
    z = _add_m(_add_m(_add_m(x, x), d), _add_m(a, b))
    z1, z2, z3 = (_row(z, (_L & ~3) | ((_L + k) & 3)) for k in (1, 2, 3))
    return _add_m(_add_m(_add_m(z, z1), _add_m(z2, z3)), _add_m(_add_m(z, rc), _add_m(z1, z1)))


def _row_sum_m(v):
    """The butterfly of four xor shuffles: every lane gets the lanes' sum."""
    for m in (1, 2, 4, 8):
        v = _add_m(v, _row(v, _L ^ m))
    return v


def permute_row_model(state):
    """Poseidon2 of (..., 16) canonical int64 tensors by kernel E's
    ``permute_row``: Montgomery words one a lane (the last axis), shuffles as
    lane maps; the partial rounds keep word 0 and the sum of words 1..15 in
    every lane and take the next sum as sum_{i>=1} d_i x_i + 15 full."""
    ext_init, internal, ext_final, diag = (
        torch.tensor([int(v) * (1 << 32) % P for v in np.asarray(c).ravel()]) for c in constants()
    )
    init, fin = ext_init.reshape(-1, ROW), ext_final.reshape(-1, ROW)
    zero = torch.zeros(ROW, dtype=torch.int64)
    lane0 = _L == 0
    x = _row_external_m(_mont_m(state, torch.full_like(state, _R2)), init[0])
    for r in range(4):
        x = _row_external_m(_sbox_m(x), init[r + 1] if r < 3 else zero)
    x0 = _row(x, torch.zeros_like(_L))
    part = _row_sum_m(torch.where(lane0, 0, x))
    y = _sbox_m(_add_m(x0, internal[0]))
    for r in range(PARTIAL_ROUNDS):
        q = _mont_m(x, diag.expand_as(x))
        full = _add_m(part, y)
        x = _add_m(q, full)
        if r + 1 == PARTIAL_ROUNDS:
            x0 = _sub_m(part, y)
            break
        x0c = _sub_m(_add_m(part, internal[r + 1]), y)
        part = _add_m(_row_sum_m(torch.where(lane0, 0, q)), _mont_m(full, torch.full_like(full, _MONT15)))
        y = _sbox_m(x0c)
    x = _add_m(torch.where(lane0, x0, x), fin[0])
    for r in range(4):
        x = _row_external_m(_sbox_m(x), fin[r + 1] if r < 3 else zero)
    return _from_mont_m(x)


def duplex_model(state, absorb, host, a: int, s: int, n_squeeze: int, bits: int = -1):
    """Kernel E's launch by the model: lane l's loads (word l of each rate
    block, the next block's felt fetched before the current block's
    permutation), :func:`permute_row_model`, the squeezes; returns (new
    state, squeezed values) as :func:`duplex_plain` does."""
    _check_duplex(state, a, s, len(host), n_squeeze, bits)
    flat = [] if absorb is None else [int(v) for v in absorb.reshape(-1)]
    felts = flat + [int(v) for v in host]
    total = len(felts)
    felt = lambda j: felts[j] if 0 <= j < total else 0  # noqa: E731  (duplex_felt)
    x = state.clone()
    v = [felt(l - a) for l in range(ROW)]
    off = 0
    while off < total:
        n = min(RATE - a, total - off)
        for l in range(a, a + n):
            x[l] = v[l]
        off, a = off + n, a + n
        if a == RATE:
            v = [felt(off + l) for l in range(ROW)]
            x, a, s = permute_row_model(x), 0, RATE
    out = []
    for _ in range(n_squeeze):
        if a != 0 or s == 0:
            x, a, s = permute_row_model(x), 0, RATE
        s -= 1
        out.append(int(x[s]) & (~0 if bits < 0 else (1 << bits) - 1))
    return x, torch.tensor(out, dtype=F.DTYPE)


# ---------------------------------------------------------------------------
# Kernel F (csrc/poseidon2.cu grind_sweep_kernel, grind_rows_kernel): the
# plan of swirl_p2_grind and the launch, step for step on the CPU.
# ---------------------------------------------------------------------------

GRIND_THREADS = 128  # threads a block, both routes
GRIND_MIN_BLOCKS = 2  # the sweep route's blocks an SM (its __launch_bounds__): the measured knee
GRIND_EXPECTED = 4  # a sweep: expected counts (2^bits each) of candidates
GRIND_ROW_CANDIDATES = GRIND_THREADS // ROW  # a block of the rows route: 2 a warp
GRIND_ROWS_MAX_CANDIDATES = 4096  # the rows route's largest sweep (10 bits), measured
H100_SMS = 132


def me_entry(i: int, j: int) -> int:
    """M_E's entry (i, j): M4[i % 4][j % 4] (2 on the diagonal, 3 one to its
    right, cyclically, else 1), doubled within a group."""
    m4 = 2 if j % 4 == i % 4 else 3 if j % 4 == (i + 1) % 4 else 1
    return m4 * (2 if i // 4 == j // 4 else 1)


def grind_plan(bits: int, sms: int = H100_SMS) -> dict:
    """swirl_p2_grind's launch: a sweep of GRIND_EXPECTED expected counts; up
    to GRIND_ROWS_MAX_CANDIDATES on the rows route (blocks of 8 candidates,
    2 a warp), above on the sweep route (a candidate a thread), at most
    ``sms`` x GRIND_MIN_BLOCKS blocks. Returns {"route", "blocks",
    "per_sweep"} (candidates a sweep)."""
    if not 1 <= bits <= 30:
        raise ValueError(f"grind: {bits} bits")
    want = GRIND_EXPECTED << bits
    if want <= GRIND_ROWS_MAX_CANDIDATES:
        blocks = -(-want // GRIND_ROW_CANDIDATES)
        return {"route": "rows", "blocks": blocks, "per_sweep": blocks * GRIND_ROW_CANDIDATES}
    blocks = min(-(-want // GRIND_THREADS), max(sms, 1) * GRIND_MIN_BLOCKS)
    return {"route": "sweep", "blocks": blocks, "per_sweep": blocks * GRIND_THREADS}


def grind_offsets(plan: dict) -> torch.Tensor:
    """The candidate of each thread in the first sweep (thread t of block b
    at index b * GRIND_THREADS + t; a later sweep adds its multiple of
    ``per_sweep``): the sweep route's w = b * 128 + t; the rows route's
    half-warp h of warp v of block b, b * 8 + 2 v + h (lanes of a half-warp
    share it)."""
    t = torch.arange(plan["blocks"] * GRIND_THREADS)
    if plan["route"] == "sweep":
        return t
    b, tid = t // GRIND_THREADS, t % GRIND_THREADS
    return b * GRIND_ROW_CANDIDATES + (tid // _WARP) * 2 + (tid // ROW) % 2


def _grind_first_inputs_m(c, wbar, a: int):
    """c_i + k_i w-bar, k = column a of M_E, from w-bar, 2w-bar, 3w-bar, 4w-bar,
    6w-bar (adds, each asserted in range)."""
    w2 = _add_m(wbar, wbar)
    w3 = _add_m(w2, wbar)
    w4 = _add_m(w2, w2)
    mult = {1: wbar, 2: w2, 3: w3, 4: w4, 6: _add_m(w3, w3)}
    return [_add_m(c[i], mult[me_entry(i, a)]) for i in range(WIDTH)]


def _grind_sweep_word_m(first, ext_init, internal, ext_final):
    """Word RATE - 1 after the permutation from its first S-box layer's
    inputs, by the kernels' steps (permute_from_sbox_inputs)."""
    s = _external_m([_sbox_m(x) for x in first])
    for r in range(1, 4):
        s = _external_m([_sbox_m(_add_m(s[i], ext_init[16 * r + i])) for i in range(WIDTH)])
    for rc in internal:
        s = _partial_m(s, rc)
    for r in range(4):
        s = _external_m([_sbox_m(_add_m(s[i], ext_final[16 * r + i])) for i in range(WIDTH)])
    return _from_mont_m(s[RATE - 1])


def grind_search(plan: dict, probe) -> int:
    """The trips of a launch of ``plan`` over its threads' candidates
    (:func:`grind_offsets`): a thread leaves once the least hit it read
    lies below its candidate (the rows route: its warp's first), and the
    read is a trip ahead, so at trip k it knows the hits of trips up to k -
    2. ``probe(trip, w, alive)`` gets the candidates that run in the trip
    (in [0, P], P only as a rows warp's last) and which of the launch's
    candidates they are (a mask over them, in offset order), and returns
    their hits as a bool tensor. Returns the least hit, P if none."""
    n = plan["per_sweep"]
    cand = torch.unique(grind_offsets(plan))  # a rows half-warp's lanes share one
    lead = cand - cand % 2 if plan["route"] == "rows" else cand
    alive = torch.ones_like(cand, dtype=torch.bool)
    least, found = P, []  # the least hit after each trip
    for trip in range(-(-P // n)):
        seen = found[trip - 2] if trip >= 2 else P
        alive &= (trip * n + lead < P) & (trip * n + lead <= seen)
        if not bool(alive.any()):
            break
        w = trip * n + cand[alive]
        hits = w[probe(trip, w, alive) & (w < P)]
        if hits.numel():
            least = min(least, int(hits.min()))
        found.append(least)
    return least


def grind_model(state, a: int, bits: int, sms: int = H100_SMS):
    """Kernel F's launch by the model: :func:`grind_plan` at ``sms`` SMs,
    every thread of a sweep at once (:func:`grind_offsets`). The sweep
    route: c = M_E(state with word a set to 0) + the first round's
    constants, k = column a of M_E, w-bar = mont(w) moving by the add of
    mont(per_sweep) a trip (asserted equal to mont(w)), then the scalar
    permutation's steps to word RATE - 1 (:func:`permute_model`'s). The rows
    route: :func:`permute_row_model` of the state with word a set to w. A
    thread leaves once the least hit it read lies below its candidate; the
    read is a trip ahead, so at trip k it knows the hits of trips up to k -
    2 (the rows route: a warp, by its first candidate). Every add's operands
    are asserted below P. Then the last block's advance
    (:func:`permute_row_model` with word a = the least hit). Returns (new
    state, witness) as :func:`grind_plain` does."""
    _check_grind(state, a, bits)
    plan = grind_plan(bits, sms)
    n, mask = plan["per_sweep"], (1 << bits) - 1
    ext_init, internal, ext_final, _ = (
        [int(v) * (1 << 32) % P for v in np.asarray(c).ravel()] for c in constants()
    )
    s0 = state.to(torch.int64).cpu()
    r2 = torch.tensor(_R2)
    if plan["route"] == "sweep":
        m = [_mont_m(x, r2) for x in s0.unbind(-1)]
        m[a] = torch.tensor(0)
        c = [_add_m(x, ext_init[i]) for i, x in enumerate(_external_m(m))]
        step = _mont_m(torch.tensor(n), r2)
        cand = torch.unique(grind_offsets(plan))
        wbar = {"trip": 0, "v": _mont_m(cand, r2.expand_as(cand))}

    def probe(trip, w, alive):
        if plan["route"] == "rows":
            states = s0.expand(w.shape[0], WIDTH).clone()
            states[:, a] = torch.where(w < P, w, 0)
            return (permute_row_model(states)[:, RATE - 1] & mask) == 0
        while wbar["trip"] < trip:  # one add a trip
            wbar["v"], wbar["trip"] = _add_m(wbar["v"], step), wbar["trip"] + 1
        v = wbar["v"][alive]
        if not torch.equal(v, _mont_m(w, r2.expand_as(w))):
            raise AssertionError("grind model: w-bar left mont(w)")
        word = _grind_sweep_word_m(_grind_first_inputs_m(c, v, a), ext_init, internal, ext_final)
        return (word & mask) == 0

    least = grind_search(plan, probe)
    if least >= P:
        return state.clone(), torch.tensor(-1, dtype=F.DTYPE)
    x = s0.clone()
    x[a] = least
    return permute_row_model(x), torch.tensor(least, dtype=F.DTYPE)
