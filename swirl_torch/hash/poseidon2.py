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

from functools import lru_cache

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
    x0, x1, x2, x3 = s.unbind(-1)
    t01 = F.add(x0, x1)
    t23 = F.add(x2, x3)
    t0123 = F.add(t01, t23)
    t01123 = F.add(t0123, x1)
    t01233 = F.add(t0123, x3)
    return torch.stack(
        [
            F.add(t01123, t01),
            F.add(t01123, F.add(x2, x2)),
            F.add(t01233, t23),
            F.add(t01233, F.add(x0, x0)),
        ],
        dim=-1,
    )


def _external(s):
    s4 = _m4(s.reshape(s.shape[:-1] + (4, 4)))
    s4 = F.add(s4, F.base_sum(s4, axis=-2)[..., None, :])
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
        s = F.add(F.mul(s, diag), F.base_sum(s, axis=-1)[..., None])
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
    if not bool(((x >= 0) & (x < bound)).all()):
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
    K.LIB.launch(K.TOWER, "swirl_p2_tower", digests, digests.data_ptr(), flat.data_ptr(), n)
    layers = []
    m = n // 2
    while m >= 1:
        off = DIGEST * (n - 2 * m)
        layers.append(flat[off : off + DIGEST * m].view(DIGEST, m))
        m //= 2
    return layers


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
