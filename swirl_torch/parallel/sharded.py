"""One proof's hot pipeline sharded over a mesh of ranks, with every
collective explicit.

Peer of ``swirl/parallel/sharded.py``. There ``shard_map`` bodies run on a
device mesh and XLA lowers ``all_to_all`` / ``all_gather`` / ``ppermute``
/ ``psum``; here each function takes the rank's local shard and a 1-D
``DeviceMesh`` (``parallel/multihost.py``) and calls ``torch.distributed``
on the mesh's group: ``all_to_all_single``, ``all_gather_into_tensor``
and, for ``ppermute``, ``batch_isend_irecv``. A ``psum`` of field values is
an all-gather of the partials and a sum mod P on the port's canonical int64
tensors, never a float reduction. Every local transform is the port's own:
kernel A (``prover/ntt.py``) for the local NTT stage, kernels B, C and D
(``hash/poseidon2.py``) for leaves, levels and towers.

The long axis is the stacked-matrix height (the codeword's length):

- :func:`distributed_ntt`: Cooley-Tukey A x B with A = ranks. Three
  ``all_to_all_single`` exchanges with (A, w, B/A) buffers; the size-A DFT
  across ranks is local after the first, the B-point DFT (kernel A) after
  the second, the natural order restored by the third. A gather when B % A
  != 0 (tiny shapes).
- :func:`sharded_commit_step`, :func:`sharded_gkr_layer_step`,
  :func:`sharded_whir_fold_step`: the JAX package's three explicit steps,
  each returning what the JAX step returns (its replicated values on
  every rank, its sharded values as this rank's shard).
- :func:`rs_ntt` and :func:`merkle_layers`: the prover's sharded commit,
  which ``prover/stacked_pcs.py`` (``rs_encode``) and ``prover/merkle.py``
  (``build_merkle_tree``) call under ``annotate.spmd_mesh``. The prover's
  tree is not the JAX step's contiguous pairwise tree: its first
  ``log2(rows_per_query)`` levels pair columns ``query_stride`` apart, so
  a rank that held a contiguous slice of the codeword would hold no whole
  leaf. Each rank takes the columns of its query indices, ``{y + t *
  query_stride}`` for y in its 1/A of ``[0, query_stride)``, hashes them
  (B), runs the strided levels and its subtree locally (C, then D), and the
  A subtree roots are gathered and folded to the root (D). The codeword
  and the digest layers are then gathered whole on every rank, and the
  stages after the commit run replicated and unchanged.

Gloo on CUDA tensors: :data:`GLOO_CUDA` lists the collectives that gloo
took on the card; any other is refused before the call (no host copy is
made in its place).
"""

from __future__ import annotations

from typing import Callable, List, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..fields import field as F
from ..fields.babybear import P, two_adic_generator
from ..hash import poseidon2 as p2
from ..prover.errors import ProverError
from ..prover.merkle import build_merkle_tree
from ..prover.ntt import ntt
from ..prover.stacked_pcs import rs_message
from . import annotate, multihost

# the collectives of this module that gloo runs on CUDA tensors, as
# ``python -m swirl_torch.tools.gloo_cuda`` found them on the card (torch
# 2.11): all_to_all_single and all_gather_into_tensor ran; batch_isend_irecv
# handed the device pointer to the socket ("writev: Bad address") or
# aborted the process
GLOO_CUDA = frozenset({"all_gather", "all_to_all"})

# collectives issued, by name (a captured prove counts its capture's); the
# counts a prove are read by chip_smoke.py
_COUNTS = {"all_to_all": 0, "all_gather": 0, "ppermute": 0}


def collective_counts() -> dict:
    return dict(_COUNTS)


def reset_collective_counts() -> None:
    for name in _COUNTS:
        _COUNTS[name] = 0


def make_mesh(ranks=None, device_type: str = "cuda"):
    """1-D ``rows`` mesh over ``ranks`` (default: the world)."""
    return multihost.proof_mesh(ranks, device_type)


def _group(mesh):
    if mesh.ndim != 1:
        raise ValueError(f"sharded: a 1-D mesh is needed, got the dims {mesh.mesh_dim_names}")
    return mesh.get_group()


def mesh_size(mesh) -> int:
    return dist.get_world_size(_group(mesh))


def mesh_rank(mesh) -> int:
    """This rank's shard index: its rank in the mesh's group."""
    return dist.get_rank(_group(mesh))


def _collective(name: str, mesh, x: torch.Tensor, run: Callable) -> None:
    group = _group(mesh)
    backend = dist.get_backend(group)
    if backend == "gloo" and x.is_cuda and name not in GLOO_CUDA:
        raise ProverError(f"sharded: gloo does not take CUDA tensors for {name}; use an NCCL group "
                          "(no host copy is made in its place)")
    _COUNTS[name] += 1
    try:
        run(group)
    except RuntimeError as err:
        raise ProverError(f"sharded: {name} failed on the {backend} group for a {x.device.type} tensor: "
                          f"{err}") from err


def all_to_all(x: torch.Tensor, mesh) -> torch.Tensor:
    """Chunk s of ``x`` (its s-th index on axis 0, of A) goes to rank s;
    chunk s of the result came from rank s."""
    x = x.contiguous()
    out = torch.empty_like(x)
    _collective("all_to_all", mesh, x, lambda g: dist.all_to_all_single(out, x, group=g))
    return out


def all_gather(x: torch.Tensor, mesh) -> torch.Tensor:
    """(A, *x.shape): every rank's ``x`` in rank order."""
    flat = x.reshape(-1).contiguous()
    out = flat.new_empty(mesh_size(mesh) * flat.numel())
    _collective("all_gather", mesh, x, lambda g: dist.all_gather_into_tensor(out, flat, group=g))
    return out.view((mesh_size(mesh),) + tuple(x.shape))


def ppermute(x: torch.Tensor, mesh, pairs) -> torch.Tensor:
    """``jax.lax.ppermute``: rank d receives ``x`` of the rank s of its
    (s, d) pair, zeros if none; a pair with s == d is a local copy."""
    me = mesh_rank(mesh)
    out = torch.zeros_like(x)
    x = x.contiguous()

    def run(g):
        ops = []
        for s, d in pairs:
            if s == d == me:
                out.copy_(x)
            elif s == me:
                ops.append(dist.P2POp(dist.isend, x, dist.get_global_rank(g, d), g))
            elif d == me:
                ops.append(dist.P2POp(dist.irecv, out, dist.get_global_rank(g, s), g))
        for work in dist.batch_isend_irecv(ops) if ops else []:
            work.wait()

    _collective("ppermute", mesh, x, run)
    return out


def psum(x: torch.Tensor, mesh) -> torch.Tensor:
    """The field sum of every rank's ``x``: the partials gathered and added
    mod P (canonical int64, exact)."""
    return F.ext_sum(all_gather(x, mesh), axis=0)


def _dft_matrix_rows(n_dev: int, log_h: int) -> np.ndarray:
    """W[k1, j1] = w_A^(j1 k1) with A = n_dev and w_A = w_H^(H/A)."""
    w_a = pow(two_adic_generator(log_h), (1 << log_h) // n_dev, P)
    pw = [pow(w_a, i, P) for i in range(n_dev)]
    return np.array([[pw[(j * k) % n_dev] for j in range(n_dev)] for k in range(n_dev)], dtype=np.int64)


def distributed_ntt(x_local: torch.Tensor, mesh, log_h: int) -> torch.Tensor:
    """This rank's shard of the natural-order DFT of a (w, H) matrix whose
    rank d holds the columns [d B, (d+1) B), B = H / A; the result is
    sharded the same way.

    With j = j1 B + j2 and k = k1 + A k2: X[k1 + A k2] = sum_j2 w_B^(j2
    k2) w_H^(j2 k1) sum_j1 x[j1 B + j2] w_A^(j1 k1). Exchange 1 gives rank
    d every j1 for its slice of j2; the size-A DFT and the twiddle
    w_H^(j2 k1) are local; exchange 2 gives rank k1 the row Y[k1, :]; its
    B-point DFT (kernel A) is X[k1 + A k2]; exchange 3 restores the natural
    order. Each buffer is (A, w, B/A)."""
    a, d = mesh_size(mesh), mesh_rank(mesh)
    h = 1 << log_h
    rows, b = x_local.shape
    if h % a or b != h // a:
        raise ValueError(f"distributed_ntt: a (w, {b}) shard of 2^{log_h} columns over {a} ranks")
    if a == 1:
        return ntt(x_local)
    if b % a:
        return _distributed_ntt_gather(x_local, mesh, log_h)
    c = b // a
    # exchange 1: chunk s of j2 to rank s; xr[j1, :, t] = x[j1 B + d c + t]
    xr = all_to_all(x_local.reshape(rows, a, c).transpose(0, 1), mesh)
    w_h = two_adic_generator(log_h)
    dft = _dft_matrix_rows(a, log_h)
    wh_j2 = F.mul(F.powers(w_h, c, x_local.device), pow(w_h, d * c, P))  # w_H^(d c + t)
    ys, tw = [], None  # tw = w_H^(j2 k1); None for k1 = 0
    for k1 in range(a):
        y = sum(F.mul(xr[j1], int(dft[k1, j1])) for j1 in range(a)) % P
        if tw is not None:
            y = F.mul(y, tw)
        tw = wh_j2 if tw is None else F.mul(tw, wh_j2)
        ys.append(y)
    # exchange 2: rank k1 gets Y[k1, s c + t] from rank s
    yr = all_to_all(torch.stack(ys), mesh)
    z = ntt(yr.transpose(0, 1).reshape(rows, b))  # z[k2] = X[d + A k2]
    # exchange 3: rank t gets the k2 block t; recv[s, :, j] = X[t B + s + A j]
    recv = all_to_all(z.reshape(rows, a, c).transpose(0, 1), mesh)
    return recv.permute(1, 2, 0).reshape(rows, b)


def _distributed_ntt_gather(x_local: torch.Tensor, mesh, log_h: int) -> torch.Tensor:
    """Tiny shapes (B % A != 0): the whole input gathered, transformed on
    every rank, this rank's columns kept."""
    a, d = mesh_size(mesh), mesh_rank(mesh)
    rows, b = x_local.shape
    whole = ntt(all_gather(x_local, mesh).transpose(0, 1).reshape(rows, a * b))
    return whole[:, d * b : (d + 1) * b].contiguous()


# ---------------------------------------------------------------------------
# The prover's sharded commit (under annotate.spmd_mesh)
# ---------------------------------------------------------------------------


def rs_ntt(x: torch.Tensor, mesh, ext: bool = False) -> torch.Tensor:
    """``ntt(x, ext=ext)`` of a matrix every rank holds whole, computed
    across the mesh: rank d transforms its column block through
    :func:`distributed_ntt` and the blocks are gathered whole on every
    rank. A length below the rank count is transformed whole on each."""
    if ext:
        return rs_ntt(x.movedim(-1, -2).contiguous(), mesh).movedim(-2, -1).contiguous()
    a, d = mesh_size(mesh), mesh_rank(mesh)
    shape = x.shape
    n = int(shape[-1])
    if n % a:
        return ntt(x)
    rows = x.reshape(-1, n)
    b = n // a
    z = distributed_ntt(rows[:, d * b : (d + 1) * b].contiguous(), mesh, n.bit_length() - 1)
    return all_gather(z, mesh).transpose(0, 1).reshape(shape).contiguous()


def merkle_layers(matrix: torch.Tensor, rows_per_query: int, mesh) -> List[torch.Tensor]:
    """``build_merkle_tree(matrix, rows_per_query).layers`` of a codeword
    every rank holds whole, built across the mesh by query index: rank r
    hashes the columns {y + t S : t < rows_per_query} for y in [r s, (r+1)
    s), S = query_stride, s = S / A (kernel B, in place for an EF matrix),
    runs the strided levels at the local stride s (C) and its subtree to one
    root (C above the tower's width, then D); one all-gather brings every
    rank's layers, and the A roots are folded to the root (D). A tree whose
    query stride the ranks do not divide is built whole on each."""
    a, r = mesh_size(mesh), mesh_rank(mesh)
    w, n = int(matrix.shape[0]), int(matrix.shape[1])
    tail = tuple(matrix.shape[2:])
    stride = n // rows_per_query
    if stride % a:
        with annotate.spmd_mesh(None):
            return build_merkle_tree(matrix, rows_per_query, matrix.dim() == 3).layers
    s = stride // a
    shard = matrix.reshape((w, rows_per_query, a, s) + tail)[:, :, r].reshape((w, rows_per_query * s) + tail)
    cur = p2.hash_cols(shard.contiguous())
    while cur.shape[1] > s:
        cur = p2.compress_layer(cur, s)
    local = [cur] + p2.merkle_tower(cur)  # (8, s) ... (8, 1)
    flat, _ = F.pack(local)
    whole = all_gather(flat, mesh)  # (A, 8 (2s - 1))
    layers, off = [], 0
    for layer in local:
        m = int(layer.shape[1])
        block = whole[:, off : off + p2.DIGEST * m].reshape(a, p2.DIGEST, m)
        layers.append(block.transpose(0, 1).reshape(p2.DIGEST, a * m).contiguous())
        off += p2.DIGEST * m
    return layers + p2.merkle_tower(layers[-1])  # the A roots (8, A) folded by D


# ---------------------------------------------------------------------------
# The JAX package's explicit steps
# ---------------------------------------------------------------------------


def _tree_root(digests: torch.Tensor) -> torch.Tensor:
    """(8,) root of a plain pairwise tree over (8, n) digests."""
    layers = p2.merkle_tower(digests)
    return (layers[-1] if layers else digests)[:, 0]


def sharded_commit_step(mesh, l_skip: int, log_blowup: int, k_whir: int):
    """The step of ``swirl/parallel/sharded.py:209-312`` on a (w, H / A)
    local shard of a stacked matrix sharded contiguously on its height:
    returns (root (8,), round_evals (2,)), the same on every rank.

    The RS message (chunk iDFTs through A, the zeta transform) is local;
    the padded coefficients are redistributed by ``ppermute`` pairs (a
    gather when A < 2^log_blowup); the distributed NTT; the leaves (B) and
    a plain pairwise tree to one root a shard (C, D), the roots gathered
    and folded; one degree-2 round of sum_y f(y) gamma^y (gamma = 3) with
    the partials summed across ranks. ``k_whir`` is taken and, as in the
    reference, not used: this tree pairs contiguous leaves."""
    del k_whir

    def step(local: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        a, d = mesh_size(mesh), mesh_rank(mesh)
        w, b0 = local.shape
        h = b0 * a
        log_rs = h.bit_length() - 1 + log_blowup
        msg = rs_message(l_skip, local)
        blow = 1 << log_blowup
        if a % blow == 0:
            # target t holds the message blocks [t 2^lb, (t+1) 2^lb); targets
            # at or past A / 2^lb hold zero padding
            chunks = [ppermute(msg, mesh, [(t * blow + j, t) for t in range(a // blow)]) for j in range(blow)]
            mine = torch.cat(chunks, dim=1)
        else:
            full = torch.zeros((w, h << log_blowup), dtype=F.DTYPE, device=local.device)
            full[:, :h] = all_gather(msg, mesh).transpose(0, 1).reshape(w, h)
            b = (h << log_blowup) // a
            mine = full[:, d * b : (d + 1) * b].contiguous()
        code_local = distributed_ntt(mine, mesh, log_rs)
        root = _tree_root(all_gather(_tree_root(p2.hash_cols(code_local)), mesh).T.contiguous())

        # weights gamma^(global row) from shard-local powers
        g_pows = F.powers(3, b0, local.device)
        wvec = F.mul(g_pows, pow(3, d * b0, P))
        fp, wp = local.reshape(w, -1, 2), wvec.reshape(-1, 2)
        f0, f1, w0, w1 = fp[..., 0], fp[..., 1], wp[..., 0], wp[..., 1]
        ev1 = F.base_sum(F.base_sum(F.mul(f1, w1[None, :]), axis=1), axis=0)
        f2, w2 = F.add(f1, F.sub(f1, f0)), F.add(w1, F.sub(w1, w0))
        ev2 = F.base_sum(F.base_sum(F.mul(f2, w2[None, :]), axis=1), axis=0)
        return root, psum(torch.stack([ev1, ev2]), mesh)

    return step


def _at(v: torch.Tensor, x: int) -> torch.Tensor:
    """A degree-1 pair (v[:, 0], v[:, 1]) at X = x (EF values)."""
    t0, t1 = v[:, 0], v[:, 1]
    return t1 if x == 1 else F.ext_add(t0, F.ext_scale(F.ext_sub(t1, t0), x))


def _combine(p: torch.Tensor, q: torch.Tensor):
    """Fraction-tree combine of (n, 4) numerators and denominators to the root."""
    while p.shape[0] > 1:
        p0, p1, q0, q1 = p[0::2], p[1::2], q[0::2], q[1::2]
        p, q = F.ext_add(F.ext_mul(p0, q1), F.ext_mul(p1, q0)), F.ext_mul(q0, q1)
    return p[0], q[0]


def sharded_gkr_layer_step(mesh):
    """The step of ``swirl/parallel/sharded.py:315-369`` on this rank's (n /
    A, 4) shards of EF fraction leaves: returns (p root (4,), q root (4,),
    round poly (3, 4) at X = 1, 2, 3), the same on every rank."""

    def step(p_local: torch.Tensor, q_local: torch.Tensor):
        pp, qq = p_local.reshape(-1, 2, 4), q_local.reshape(-1, 2, 4)
        partial = torch.stack([F.ext_sum(F.ext_mul(_at(pp, x), _at(qq, x)), axis=0) for x in (1, 2, 3)])
        round_poly = psum(partial, mesh)
        p_c, q_c = _combine(p_local, q_local)
        p_root, q_root = _combine(all_gather(p_c, mesh), all_gather(q_c, mesh))
        return p_root, q_root, round_poly

    return step


def sharded_whir_fold_step(mesh):
    """The step of ``swirl/parallel/sharded.py:372-413`` on this rank's (n /
    A, 4) shards of f and w and a replicated challenge alpha (4,): returns
    (this rank's shard of fold(f), of fold(w), round evals (2, 4) at X = 1,
    2 summed across ranks). The pairs (2y, 2y + 1) are shard-local."""

    def step(f_local: torch.Tensor, w_local: torch.Tensor, alpha: torch.Tensor):
        fp, wp = f_local.reshape(-1, 2, 4), w_local.reshape(-1, 2, 4)
        partial = torch.stack([F.ext_sum(F.ext_mul(_at(fp, x), _at(wp, x)), axis=0) for x in (1, 2)])

        def fold(v):
            return F.ext_add(v[:, 0], F.ext_mul(F.ext_sub(v[:, 1], v[:, 0]), alpha))

        return fold(fp), fold(wp), psum(partial, mesh)

    return step
