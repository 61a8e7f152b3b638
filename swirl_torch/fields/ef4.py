"""Kernel L: the batch sumcheck's EF4 products, one launch each.

:func:`mul` is the EF4 product ``c = a b`` (x^4 = 11) of two EF4 tensors
(..., 4), equal shapes or broadcast as torch broadcasts (a (4,) challenge,
(k, 1, 4) weights against (k, rows, 4)), each read in place through its
strides (the stride-2 views of ``interp_mle_at_int`` too); the result is
contiguous. :func:`mul_sum` is the product-and-sum ``sum_i w_i v_i`` over
v's leading axis for (k, 4) EF4 weights w, v EF4 or base field, its rows
optionally gathered by ``index`` (the DAG interpreter's buffer rows), with
no (k, *batch, 4) term in device memory.

On CUDA tensors both are kernel L (``csrc/ef4.cu``); on CPU tensors the
plain versions, :func:`~.field.ext_mul` and ``ext_sum(ext_mul(...))`` (or
the base x EF4 form). Every value is exact and canonical, so the two are
bit-equal. Each launch counts in :data:`~swirl_torch.kernels.EF4`.
"""

from __future__ import annotations

import ctypes

import torch

from .. import kernels as K
from . import field as F
from .babybear import P

# kernel L's block, the batch dims of a product (csrc/ef4.cu THREADS,
# MUL_DIMS), and the terms a lane of a sum's block takes at least before the
# terms split over blocks
THREADS = 256
MUL_DIMS = 3
TERMS_A_LANE = 4
MAX_ELEMS = 1 << 31

# EF4 terms (int64 elements) the plain sum forms at once: a group's values,
# product and its reduction hold 9/4 x 8 bytes a term element (0.6 GB),
# near what the interaction sums held a term at a time on a round-0 grid
TERM_CHUNK_ELEMS = 1 << 25


def mul_sum_plain(v, w, index=None, ext: bool = True):
    """:func:`mul_sum`'s plain version (its path on CPU tensors): gathers
    and products in groups of at most TERM_CHUNK_ELEMS term elements (field
    sums are associative, so the grouping changes no value)."""
    w = w.reshape(-1, 4)
    batch = v.shape[1 : v.dim() - int(ext)]
    group = max(1, TERM_CHUNK_ELEMS // (4 * batch.numel() or 1))
    acc = torch.zeros(batch + (4,), dtype=F.DTYPE, device=v.device)
    for g in range(0, w.shape[0], group):
        vals = v[g : g + group] if index is None else v.index_select(0, index[g : g + group])
        wg = w[g : g + len(vals)].reshape((len(vals),) + (1,) * len(batch) + (4,))
        acc = acc + (F.ext_mul(vals, wg) if ext else F.mul(vals[..., None], wg)).sum(0)
    return acc % P


def _sms(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _aligned(t) -> bool:
    """t's EF4 elements start on 16-byte boundaries, their coefficients adjacent."""
    return t.stride(-1) == 1 and t.data_ptr() % 16 == 0 and all(s % 2 == 0 for s in t.stride()[:-1])


def _copy(t):
    """A contiguous copy of t in an allocation of its own (which starts on a
    16-byte boundary: ``contiguous()`` keeps a contiguous view where it is)."""
    return t.clone(memory_format=torch.contiguous_format)


def mul_plan(shape, strides):
    """The batch dims of an output ``shape`` (its last dim, 4, left out)
    coalesced for the operands' ``strides`` (each in int64 words, 0 where
    broadcast): size-1 dims dropped, a dim merged into the one before it
    where every operand's strides allow. -> [(size, [stride of each])],
    outermost first."""
    dims = []
    for d, size in enumerate(shape[:-1]):
        if size == 1:
            continue
        st = [s[d] for s in strides]
        if dims and all(ps == s * size for ps, s in zip(dims[-1][1], st)):
            dims[-1] = (dims[-1][0] * size, st)
        else:
            dims.append((size, st))
    return dims


def mul_layout(a, b):
    """The operands of a product as kernel L reads them: (output shape,
    each operand expanded to it, its coalesced batch dims by
    :func:`mul_plan`). An operand whose elements do not start on 16-byte
    boundaries is copied first, and both operands of a product of more than
    MUL_DIMS dims."""
    for t, what in ((a, "a"), (b, "b")):
        if t.dtype != F.DTYPE or t.device != a.device:
            raise K.KernelError(f"ef4_mul: {what} must be an int64 tensor on {a.device}, "
                                f"got {t.dtype} on {t.device}")
    if a.shape[-1:] != (4,) or b.shape[-1:] != (4,):
        raise K.KernelError(f"ef4_mul: no EF4 product of shapes {tuple(a.shape)} and {tuple(b.shape)}")
    ops = torch.broadcast_tensors(*(t if _aligned(t) else _copy(t) for t in (a, b)))
    shape = ops[0].shape
    dims = mul_plan(shape, [t.stride() for t in ops])
    if len(dims) > MUL_DIMS:
        ops = [_copy(t) for t in ops]
        dims = mul_plan(shape, [t.stride() for t in ops])
    return shape, ops, dims or [(1, [0, 0])]


def mul(a, b):
    """EF4 product ``a b`` of (..., 4) tensors that broadcast: kernel L on
    CUDA tensors, :func:`~.field.ext_mul` on CPU ones."""
    if not a.is_cuda:
        return F.ext_mul(a, b)
    shape, ops, dims = mul_layout(a, b)
    out = torch.empty(shape, dtype=F.DTYPE, device=a.device)
    n = out.numel() // 4
    if n == 0:
        return out
    if n >= MAX_ELEMS:
        raise K.KernelError(f"ef4_mul: {n} elements, at most {MAX_ELEMS - 1}")
    pad = [1] * (MUL_DIMS - len(dims))
    plan = (ctypes.c_longlong * (1 + 3 * MUL_DIMS))(
        len(dims), *[s for s, _ in dims], *pad, *[st[0] for _, st in dims], *pad, *[st[1] for _, st in dims], *pad)
    blocks = min(-(-n // THREADS), _sms(a.device) * 16)
    K.LIB.launch(K.EF4, "swirl_ef4_mul", out, ops[0].data_ptr(), ops[1].data_ptr(), out.data_ptr(), n, plan,
                 blocks)
    return out


def sum_plan(m: int, k: int, sms: int):
    """(tj, gy) of a sum over k terms into m columns: tj columns a block
    (the least power of two >= m, at most THREADS), the other THREADS / tj
    threads splitting the terms; gy blocks split the terms only where one
    block holds every column, enough that each lane takes TERMS_A_LANE
    terms or more, at most 2 an SM."""
    tj = min(THREADS, 1 << max(m - 1, 0).bit_length())
    if m > tj:
        return tj, 1
    lanes = THREADS // tj
    return tj, max(1, min(-(-k // (lanes * TERMS_A_LANE)), 2 * sms))


def sum_layout(v, w, index=None, ext: bool = True):
    """The operands of a sum as kernel L reads them: (v with each row's m
    values contiguous, an EF4 row on a 16-byte boundary; w as (k, 4) on
    16-byte boundaries; index contiguous or None; the output's batch
    shape)."""
    w = w.reshape(-1, 4)
    for t, what in ((v, "v"), (w, "w")) + (((index, "index"),) if index is not None else ()):
        if t.dtype != F.DTYPE or t.device != v.device:
            raise K.KernelError(f"ef4_mul_sum: {what} must be an int64 tensor on {v.device}, "
                                f"got {t.dtype} on {t.device}")
    rows = tuple(index.shape) if index is not None else tuple(v.shape[:1])
    if v.dim() < 1 + int(ext) or rows != (w.shape[0],) or (ext and v.shape[-1] != 4):
        raise K.KernelError(f"ef4_mul_sum: no sum of v {tuple(v.shape)} (ext={ext}) by weights {tuple(w.shape)} "
                            f"at rows {None if index is None else tuple(index.shape)}")
    if not v[:1].is_contiguous() or (ext and not _aligned(v)):
        v = _copy(v)
    if not _aligned(w):
        w = _copy(w)
    if index is not None:
        index = index.contiguous()
    return v, w, index, tuple(v.shape[1 : v.dim() - int(ext)])


def mul_sum(v, w, index=None, ext: bool = True):
    """``sum_i w_i v_(index_i)`` over v's leading axis: v (K, *batch, 4) EF4
    (``ext``) or (K, *batch) base field, w (k, 4) EF4 weights (or (k, 1,
    ..., 1, 4)), index None (k = K) or (k,) rows of v; -> (*batch, 4).
    Kernel L on CUDA tensors (one launch; rows gathered in place, no term
    formed in device memory), :func:`mul_sum_plain` on CPU ones."""
    if not v.is_cuda:
        return mul_sum_plain(v, w, index, ext)
    v, w, index, batch = sum_layout(v, w, index, ext)
    device, k = v.device, w.shape[0]
    out = torch.empty(batch + (4,), dtype=F.DTYPE, device=device)
    m = out.numel() // 4
    if m == 0:
        return out
    if k == 0:
        return out.zero_()
    if m >= MAX_ELEMS:
        raise K.KernelError(f"ef4_mul_sum: {m} columns, at most {MAX_ELEMS - 1}")
    tj, gy = sum_plan(m, k, _sms(device))
    partials = ticket = None
    if gy > 1:
        partials = torch.empty(2 * gy * m, dtype=F.DTYPE, device=device)  # (gy, m, 4) 32-bit words
        ticket = K.tickets(device).ef4
    K.LIB.launch(K.EF4, "swirl_ef4_mul_sum", out, v.data_ptr(), v.stride(0),
                 None if index is None else index.data_ptr(), w.data_ptr(), k, m, int(ext), tj, gy,
                 out.data_ptr(), None if partials is None else partials.data_ptr(),
                 None if ticket is None else ticket.data_ptr())
    return out
