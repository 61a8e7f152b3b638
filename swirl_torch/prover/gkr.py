"""LogUp fractional sumcheck via a GKR layered circuit, on torch tensors.

Peer of ``swirl/prover/gkr.py`` (``fractional_sumcheck`` :480): the
fraction segment tree (projective fraction addition of pairs,
``_combine_layer_impl`` :418), then per layer a degree-3 sumcheck over
eq(xi, Y) * (p0*q1 + p1*q0 + lambda*q0*q1) with round evaluations at X in
{1, 2, 3} (``_gkr_round_evals`` :58) and folds (``_gkr_fold`` :82). All
MLEs stay in natural index order: the logical pair (2i, 2i+1) is a
stride-2 split.

On the card a layer's sumcheck is kernel K (``csrc/gkr.cu``): one launch
for the layer's eq table (:func:`gkr_eq`), then one pass a sub-round
(:func:`gkr_round`) that folds the five MLEs at the last challenge and
evaluates the next sub-round in the same read, reading the challenges from
device memory; on the CPU the plain versions, the same arithmetic op by
op. The build counts the sub-rounds that K evaluated
(``gkr_kernel_subrounds``).

Every value stays on the device: the round evaluations, the challenges and
the layer claims. On a :class:`~.device_transcript.DeviceTranscript` (the
device path, ``gkr.py:531-680``) a sub-round is one sponge launch between
its evaluation and its fold, and the stage reads the host twice: the
root's zero check, and one copy of every round polynomial, claim and the
challenge point at the end. :func:`fractional_sumcheck_deferred` leaves
both to its caller: the fused prover reads them with the whole proof. On a
host transcript each observe reads its value first.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from .. import kernels as K
from .. import metrics
from ..fields import ext as hext
from ..proof import GkrLayerClaims
from ..fields import field as F
from .deferred import Deferred
from .device_transcript import device_view
from .sumcheck import eq_hypercube, fold_mle, interp_mle_at_int

# kernel K's block, its blocks an SM and the most variables of its eq table
# (csrc/gkr.cu GKR_THREADS, GKR_MIN_BLOCKS, GKR_EQ_MAX)
THREADS = 256
MIN_BLOCKS = 2
EQ_MAX = 30
EVAL_WORDS = 12  # the (3, 4) evaluations; one block's partial sums, as 32-bit words


def _pairs(col):
    return col[0::2], col[1::2]


def _round_evals(cols, lam):
    """Degree-3 round polynomial at X in {1, 2, 3}: cols are the five (m, 4)
    MLEs [eq, p0, q0, p1, q1]; returns a (3, 4) tensor."""
    out = []
    for x in (1, 2, 3):
        e, a0, b0, a1, b1 = (interp_mle_at_int(c, x) for c in cols)
        p_prev = F.add(F.ext_mul(a0, b1), F.ext_mul(a1, b0))
        q_prev = F.ext_mul(b0, b1)
        val = F.ext_mul(e, F.add(p_prev, F.ext_mul(lam, q_prev)))
        out.append(F.ext_sum(val, axis=0))
    return torch.stack(out)


def gkr_round_plain(cols, r=None, lam=None):
    """:func:`gkr_round`'s plain PyTorch version (its path on CPU tensors):
    ``fold_mle`` of each column, then :func:`_round_evals`."""
    if r is None and lam is None:
        raise ValueError("gkr_round: a pass folds, evaluates or both")
    if r is not None:
        cols = [fold_mle(c, r) for c in (cols if lam is not None else cols[1:])]
    if lam is None:
        return torch.stack([c[0] for c in cols]), None
    return list(cols), _round_evals(cols, lam)


def round_blocks(work: int, sms: int) -> int:
    """Kernel K's grid for ``work`` items of a thread each (pairs, or groups
    of the eq table): one block up to THREADS, above it enough blocks to
    fill the ``sms`` SMs at MIN_BLOCKS each, each thread taking several."""
    return max(1, min(-(-work // THREADS), sms * MIN_BLOCKS))


def _sms(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _operand(t, shape, stride, device, what: str) -> None:
    if t.device != device or t.dtype != F.DTYPE or tuple(t.shape) != shape or t.stride() != stride:
        raise K.KernelError(f"gkr_round: {what} must be an int64 {shape} tensor on {device} with strides {stride}, "
                            f"got {t.dtype} {tuple(t.shape)} on {t.device} with strides {t.stride()}")


def gkr_round(cols, r=None, lam=None):
    """One pass of a GKR layer's sumcheck over its five (n, 4) MLEs ``cols``
    = [eq, p0, q0, p1, q1]: fold each at ``r``, the last sub-round's
    challenge (none on the layer's first pass), then evaluate the next
    sub-round at X = 1, 2, 3 with ``lam``, giving (the five columns, the
    (3, 4) evaluations); without ``lam`` (the layer's last pass, n = 2),
    (the folded p0, q0, p1, q1 as the layer's (4, 4) claims, None). Kernel
    K on CUDA tensors, where p0, q0, p1, q1 may be the stride-2 views of the
    layer's p and q and r, lam are (4,) device tensors; the plain version on
    CPU ones."""
    eq = cols[0]
    if not eq.is_cuda:
        return gkr_round_plain(cols, r, lam)
    n, device = eq.shape[0], eq.device
    stride = cols[1].stride(0) // 4
    for c, s, what in zip(cols, (1, stride, stride, stride, stride), ("eq", "p0", "q0", "p1", "q1")):
        _operand(c, (n, 4), (4 * s, 1), device, what)
    for x, what in ((r, "r"), (lam, "lam")):
        if x is not None:
            _operand(x, (4,), (1,), device, what)
    fits = n == 2 if lam is None else n >= (2 if r is None else 4)  # the last pass folds 2 entries
    if n & (n - 1) or stride < 1 or (r is None and lam is None) or not fits:
        raise K.KernelError(f"gkr_round: no pass over {n} entries with r {'given' if r is not None else 'None'} "
                            f"and lam {'given' if lam is not None else 'None'}")
    ptrs = [c.data_ptr() for c in cols]
    if lam is None:
        claims = torch.empty((4, 4), dtype=F.DTYPE, device=device)
        K.LIB.launch(K.GKR_ROUND, "swirl_gkr_round", eq, *ptrs, stride, n, r.data_ptr(), None,
                     claims.data_ptr(), None, None, None, 1)
        return claims, None
    blocks = round_blocks(n // 2 if r is None else n // 4, _sms(device))
    # the evaluations, then each block's partial sums as 32-bit words
    words = torch.empty(EVAL_WORDS + EVAL_WORDS // 2 * blocks, dtype=F.DTYPE, device=device)
    evals = words[:EVAL_WORDS].view(3, 4)
    out = None if r is None else torch.empty((5, n // 2, 4), dtype=F.DTYPE, device=device)
    K.LIB.launch(K.GKR_ROUND, "swirl_gkr_round", eq, *ptrs, stride, n, None if r is None else r.data_ptr(),
                 lam.data_ptr(), None if out is None else out.data_ptr(), evals.data_ptr(),
                 words.data_ptr() + 8 * EVAL_WORDS, K.tickets(device).gkr.data_ptr(), blocks)
    return (list(cols) if out is None else list(out.unbind(0))), evals


def gkr_eq(xi):
    """eq(xi, y) over H_n as a (2^n, 4) tensor for an (n, 4) point xi, n >= 1
    (bit i of y belongs to xi[i]): kernel K's table on a CUDA tensor, the
    doubling table (:func:`~.sumcheck.eq_hypercube`) on a CPU one."""
    if not xi.is_cuda:
        return eq_hypercube(xi, xi.device)
    xi = xi.contiguous()
    K.require(xi, 2, "gkr_eq")
    n = xi.shape[0]
    if xi.shape[1] != 4 or not 1 <= n <= EQ_MAX:
        raise K.KernelError(f"gkr_eq: no table for a point of shape {tuple(xi.shape)}")
    out = torch.empty((1 << n, 4), dtype=F.DTYPE, device=xi.device)
    blocks = round_blocks(1 << max(n - 2, 0), _sms(xi.device))
    K.LIB.launch(K.GKR_ROUND, "swirl_gkr_eq", xi, xi.data_ptr(), n, out.data_ptr(), blocks)
    return out


def _combine_layer(p, q):
    """(2^t, 4) -> (2^(t-1), 4): p0*q1 + p1*q0 over q0*q1 for each pair."""
    p0, p1 = _pairs(p)
    q0, q1 = _pairs(q)
    return F.add(F.ext_mul(p0, q1), F.ext_mul(p1, q0)), F.ext_mul(q0, q1)


@dataclass
class FracSumcheckResult:
    fractional_sum: Tuple[np.ndarray, np.ndarray]  # (p, q) host EF
    claims_per_layer: List[GkrLayerClaims]
    sumcheck_polys: List[List[List[np.ndarray]]]
    xi: Optional[torch.Tensor]  # (t, 4) on the input's device; None without input


def _claims(c) -> GkrLayerClaims:
    """A layer's claims from their (4, 4) observe order p0, q0, p1, q1."""
    return GkrLayerClaims(p_xi_0=c[0], q_xi_0=c[1], p_xi_1=c[2], q_xi_1=c[3])


def fractional_sumcheck(
    transcript, p_evals, q_evals, assert_zero: bool = True
) -> FracSumcheckResult:
    """p_evals, q_evals: (2^t, 4) EF tensors, or None when there are no
    interactions. ``transcript``: a host :class:`Transcript` or a
    :class:`~.device_transcript.DeviceTranscript` on their device. Reads the
    root's numerator for the zero check first, then the proof values once."""
    pending, xi = fractional_sumcheck_deferred(transcript, p_evals, q_evals, assert_zero, check_now=True)
    result = pending.fetch()
    result.xi = xi
    return result


def fractional_sumcheck_deferred(
    transcript, p_evals, q_evals, assert_zero: bool = True, check_now: bool = False
) -> Tuple[Deferred, Optional[torch.Tensor]]:
    """The sumcheck with its proof values left on the device: (a
    :class:`~.deferred.Deferred` of the result without ``xi``, xi). With
    ``assert_zero`` the root's numerator is not observed but checked: read
    at once with ``check_now``, else in the build, after the fetch (the
    fused prover's one copy)."""
    if p_evals is None:
        def empty(host):
            metrics.counter("gkr_kernel_subrounds", 0)
            return FracSumcheckResult((hext.ezero(), hext.eone()), [], [], None)

        return Deferred([], empty), None
    total_rounds = int(p_evals.shape[0]).bit_length() - 1
    assert p_evals.shape[0] == 1 << total_rounds
    device = p_evals.device
    # the sub-rounds that K evaluates: all of them on the card
    kernel_subrounds = total_rounds * (total_rounds - 1) // 2 if p_evals.is_cuda else 0
    tr = device_view(transcript, device)

    layers = [(p_evals.contiguous(), q_evals.contiguous())]  # layers[total] = input ... layers[0] = root
    while layers[-1][0].shape[0] > 1:
        layers.append(_combine_layer(*layers[-1]))
    layers.reverse()

    # what is observed is kept for the proof: on the device, or the host
    # copy that a host transcript read to observe it
    root_p, root_q = (x[0] for x in layers[0])
    if assert_zero:
        if check_now:
            root_p = F.to_host(root_p)
            if root_p.any():
                raise ValueError("LogUp fractional sum is non-zero")
    else:
        root_p = tr.observe_ext(root_p)
    root_q = tr.observe_ext(root_q)

    p1, q1 = layers[1]
    claims = [tr.observe_slice(torch.stack([p1[0], q1[0], p1[1], q1[1]]))]
    xi = tr.sample_ext()[None]

    polys = []  # (3, 4) per sub-round, layer after layer
    for rnd in range(1, total_rounds):
        lam = tr.sample_ext()
        p0, p1v = _pairs(layers[rnd + 1][0])
        q0, q1v = _pairs(layers[rnd + 1][1])
        cols = [gkr_eq(xi), p0, q0, p1v, q1v]
        del xi  # in the eq table now; not live at the layer's peak
        r, rho = None, []
        for _ in range(rnd):
            cols, evals = gkr_round(cols, r, lam)  # fold at the last r, evaluate this sub-round
            polys.append(tr.observe_slice(evals))
            r = tr.sample_ext()
            rho.append(r)
        claims.append(tr.observe_slice(gkr_round(cols, r)[0]))
        xi = torch.cat([tr.sample_ext()[None], torch.stack(rho)])

    n_claims = len(claims)

    def build(host):
        metrics.counter("gkr_kernel_subrounds", kernel_subrounds)
        root_p, root_q, *rest = host
        if assert_zero and np.asarray(root_p).any():
            raise ValueError("LogUp fractional sum is non-zero")
        claims_h, polys_h = rest[:n_claims], rest[n_claims:]
        sumcheck_polys, off = [], 0
        for rnd in range(1, total_rounds):
            sumcheck_polys.append([list(e) for e in polys_h[off : off + rnd]])
            off += rnd
        return FracSumcheckResult(
            fractional_sum=(np.asarray(root_p), root_q),
            claims_per_layer=[_claims(c) for c in claims_h],
            sumcheck_polys=sumcheck_polys,
            xi=None,
        )

    return Deferred([root_p, root_q, *claims, *polys], build), xi
