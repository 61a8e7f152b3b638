"""BabyBear and its quartic extension EF4 = F_p[x]/(x^4 - 11) on torch tensors.

Representation (decided once for the whole port): a field value is its
CANONICAL integer in [0, P), held in a ``torch.int64`` tensor. An EF4 value
carries a trailing dimension of 4 (coefficients of 1, x, x^2, x^3). Torch on
the CPU lacks ``add``, ``>>`` and ``<`` on uint32, so the port keeps int64
storage everywhere; the CUDA kernels read and write that storage as it is
and may use Montgomery form internally.

Two overflow rules follow from the storage:

- a product of two canonical values is below 2^62, but an EF4 product sums
  up to four of them and the ``x^4 = 11`` fold multiplies by 11, so every
  product is reduced mod P before it is added;
- ``sub`` adds P to a negative difference instead of relying on
  ``torch.remainder`` of a negative value.

Peer of ``swirl/fields/jfield.py`` (which holds Montgomery uint32 arrays).
"""

from __future__ import annotations

import numpy as np
import torch

from .babybear import EXT_W, P

DTYPE = torch.int64
# R^-1 mod P for R = 2^32: converts the JAX package's Montgomery values
R_INV = pow((1 << 32) % P, P - 2, P)


def add(a, b):
    s = a + b
    return torch.where(s >= P, s - P, s)


def sub(a, b):
    d = a - b
    return torch.where(d < 0, d + P, d)


def neg(a):
    return torch.where(a == 0, a, P - a)


def mul(a, b):
    return (a * b) % P


ext_add = add
ext_sub = sub
ext_neg = neg


def ext_mul(a, b):
    """EF4 product with x^4 = 11; broadcasts the leading dims."""
    a, b = torch.broadcast_tensors(a, b)
    a0, a1, a2, a3 = a.unbind(-1)
    b0, b1, b2, b3 = b.unbind(-1)
    c0 = (mul(a0, b0) + EXT_W * ((mul(a1, b3) + mul(a2, b2) + mul(a3, b1)) % P)) % P
    c1 = (mul(a0, b1) + mul(a1, b0) + EXT_W * ((mul(a2, b3) + mul(a3, b2)) % P)) % P
    c2 = (mul(a0, b2) + mul(a1, b1) + mul(a2, b0) + EXT_W * mul(a3, b3)) % P
    c3 = (mul(a0, b3) + mul(a1, b2) + mul(a2, b1) + mul(a3, b0)) % P
    return torch.stack([c0, c1, c2, c3], dim=-1)


def ext_scale(a, s):
    """EF4 value(s) times base-field value(s) ``s`` (tensor or int)."""
    if isinstance(s, torch.Tensor):
        s = s[..., None]
    return mul(a, s)


def ext_sum(a, axis: int = 0):
    """Sum along ``axis`` mod P (int64 holds 2^32 canonical summands); peer
    of ``text.py`` esum."""
    return a.sum(dim=axis) % P


base_sum = ext_sum


def ext_from_base(a):
    """Base field tensor -> EF4 with zero high coefficients (peer of
    ``text.py`` from_base on a device value)."""
    return torch.stack([a] + [torch.zeros_like(a)] * 3, dim=-1)


def const(v) -> int:
    """Host value -> canonical python int (tensors broadcast it as a scalar)."""
    return int(v) % P


def const_arr(vals, device=None):
    """Host canonical array (numpy / list) -> int64 tensor on ``device``."""
    a = np.asarray(vals, dtype=np.uint64) % np.uint64(P)
    return torch.from_numpy(a.astype(np.int64)).to(device)


ext_const = const_arr


def to_host(x) -> np.ndarray:
    """Tensor -> canonical numpy uint64 array (the proof's host values)."""
    return x.detach().cpu().numpy().astype(np.uint64)


ext_to_host = to_host


def pack(values):
    """(flat, layout) of a list of tensors and host values: the tensors'
    elements in one flat tensor on their device (None without a tensor),
    and each value's place in it, a shape, or the host value itself."""
    tensors = [v for v in values if isinstance(v, torch.Tensor)]
    flat = torch.cat([t.reshape(-1) for t in tensors]) if tensors else None
    layout = [(True, tuple(v.shape)) if isinstance(v, torch.Tensor) else (False, v) for v in values]
    return flat, layout


def unpack(layout, flat) -> list:
    """The values of :func:`pack`'s ``layout``, the tensors' read from the
    host copy ``flat`` of its flat tensor (canonical numpy arrays)."""
    out, off = [], 0
    for is_tensor, v in layout:
        if is_tensor:
            n = int(np.prod(v, dtype=np.int64))
            out.append(flat[off : off + n].reshape(v))
            off += n
        else:
            out.append(v)
    return out


def to_host_all(values) -> list:
    """Canonical numpy arrays of a list of tensors in ONE device-to-host
    copy (host values pass through as they are): the proof's values that a
    stage kept on the device until its end."""
    flat, layout = pack(values)
    return unpack(layout, None if flat is None else to_host(flat))


def ext_one(device):
    """The EF4 value 1 as a (4,) tensor, made on ``device`` (no host copy,
    which on the card would wait for the stream)."""
    return (torch.arange(4, device=device) == 0).to(DTYPE)


def epowers(a, n: int):
    """[1, a, ..., a^(n-1)] of (..., 4) EF tensors as (..., n, 4), by
    log-depth doubling on their device; peer of ``swirl/fields/text.py``
    epowers :113."""
    out = ext_one(a.device).expand(a.shape[:-1] + (1, 4))
    cur = a[..., None, :]
    while out.shape[-2] < n:
        out = torch.cat([out, ext_mul_small(out, cur)], dim=-2)
        cur = ext_mul_small(cur, cur)
    return out[..., :n, :]


# -- protocol-small EF values: points, challenges, round polynomials --------

_CONSTS: dict = {}


def cached_const(key, make, device):
    """The tensor of the host array ``make()`` on ``device``, made once per
    ``key`` and device: a host-to-device copy waits for the card's stream,
    so the provers' constant tables cross once, at their first use."""
    device = torch.device(device)
    t = _CONSTS.get((key, device))
    if t is None:
        t = _CONSTS[(key, device)] = const_arr(make(), device)
    return t


def _mul_table(device):
    """(W, K): each of the 16 products a_i * b_j (index 4i + j) weighted by
    1 or x^4 = 11, and their order by the coefficient (i + j) % 4 they
    land on, four a coefficient; made on ``device``."""
    key = ("ext_mul_small", torch.device(device))
    t = _CONSTS.get(key)
    if t is None:
        ij = torch.arange(16, device=device)
        i, j = ij // 4, ij % 4
        weight = torch.where(i + j >= 4, EXT_W, 1).to(DTYPE)
        t = _CONSTS[key] = (weight, torch.argsort((i + j) % 4 * 16 + ij))
    return t


def ext_mul_small(a, b):
    """EF4 product of small tensors in six launches (:func:`ext_mul` takes
    about fifty): the 16 products of coefficients at once, weighted by
    x^4 = 11 and summed onto their coefficient. Its temporary is four times
    its output, so the tables of the data axis keep :func:`ext_mul`."""
    a, b = torch.broadcast_tensors(a, b)
    w, order = _mul_table(a.device)
    prod = ((a[..., :, None] * b[..., None, :]) % P).reshape(a.shape[:-1] + (16,)) * w
    return prod.index_select(-1, order).reshape(a.shape + (4,)).sum(-1) % P


def _frobenius_table(device):
    """(3, 4): Frobenius^k, k = 1..3, maps coefficient i to itself times
    W^(i (p^k - 1) / 4) (peer of ``text.py`` _frob_consts :99)."""

    def make():
        out = np.zeros((3, 4), dtype=np.uint64)
        for k in range(1, 4):
            e = (pow(P, k, P**4) - 1) // 4 % (P - 1)
            out[k - 1] = [pow(EXT_W, i * e % (P - 1), P) for i in range(4)]
        return out

    return cached_const("frobenius", make, device)


def inv(a):
    """Base-field inverse a^(P-2) by square and multiply (0 maps to 0)."""
    out, cur, e = None, a, P - 2
    while e:
        if e & 1:
            out = cur if out is None else mul(out, cur)
        e >>= 1
        if e:
            cur = mul(cur, cur)
    return out


def einv(a):
    """EF4 inverse of each (..., 4) value through the norm map:
    a^-1 = a^(p + p^2 + p^3) / N(a), N(a) = a^(1 + p + p^2 + p^3) in the
    base field; 0 maps to 0. Peer of ``text.py`` einv :80 and, being
    elementwise over the batch, of ``batch_einv`` :137 (Montgomery's trick
    saves nothing here)."""
    frob = _frobenius_table(a.device)
    conj = ext_mul_small(mul(a, frob[0]), ext_mul_small(mul(a, frob[1]), mul(a, frob[2])))
    norm = ext_mul_small(a, conj)[..., 0]
    return ext_scale(conj, inv(norm))


def pow_exps(base: int, e, bits: int):
    """base^e for a tensor of exponents e < 2^bits, square and multiply on
    e's device (the WHIR query points omega^index)."""
    out = torch.ones_like(e)
    cur = int(base) % P
    for b in range(bits):
        out = torch.where(((e >> b) & 1) == 1, mul(out, cur), out)
        cur = cur * cur % P
    return out


def powers(base: int, n: int, device=None):
    """[base^0, ..., base^(n-1)] as an (n,) tensor, by log-depth doubling."""
    out = torch.ones(1, dtype=DTYPE, device=device)
    cur = int(base) % P
    while out.shape[0] < n:
        out = torch.cat([out, mul(out, cur)])
        cur = cur * cur % P
    return out[:n]


def from_jax(monty_u32) -> torch.Tensor:
    """The JAX package's Montgomery uint32 values (numpy) -> canonical tensor,
    so tests can feed both packages the same intermediates."""
    m = np.asarray(monty_u32, dtype=np.uint64)
    return torch.from_numpy(((m * np.uint64(R_INV)) % np.uint64(P)).astype(np.int64))
