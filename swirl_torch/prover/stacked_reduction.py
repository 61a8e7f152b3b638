"""Stacked opening reduction on torch tensors.

Peer of ``prove_stacked_opening_reduction`` (``swirl/prover/stacked_reduction.py``:
its host branch :47-594 and its device flow ``_reduction_device``
:595-1300): a batch sumcheck reducing the per-trace column (and
rotated-column) opening claims at the prism point r to openings of the
stacked matrix columns at a fresh prism point u.

Every value stays on the data's device: the points r and u as stacked
(n, 4) tensors, the round-0 z kernels, each round's evaluations and the
tilde regime's per-view factors (one batched op per group of views of one
height). One code path serves both transcripts
(:func:`~.device_transcript.device_view`): on a
:class:`~.device_transcript.DeviceTranscript` the stage reads the host once,
the proof's copy at its end (:func:`stacked_opening_reduction_deferred`
leaves it to the fused prover's one copy); on a host transcript each
observe reads its value first.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import torch

from .. import tpoly
from ..fields.babybear import GENERATOR, P, roots_of_unity, two_adic_generator
from ..params import SystemParams
from ..proof import StackingProof
from .errors import StackedReductionError

from ..fields import field as F
from .deferred import Deferred
from .device_transcript import device_view
from .stacked_pcs import StackedPcsData, StackedSlice
from .sumcheck import coset_eval_chunks, eq_hypercube, fold_mle, fold_ple, interp_mle_at_int

emul = F.ext_mul_small


@dataclass
class TraceView:
    com_idx: int
    slice: StackedSlice
    lambda_eq_idx: int
    lambda_rot_idx: Optional[int]


def _reduce_zx(q_grid, lam, x_tab):
    """sum over (group g, x) of lam[g] * x_tab[x] * q[g, x, z] -> (B_z, 4).

    q_grid (G, 2^n, B_z) base, lam (G, 4), x_tab (2^n, 4). The group sum runs
    first, one view at a time, so the largest temporary is (2^n, B_z, 4)."""
    acc = None
    for gi in range(q_grid.shape[0]):
        term = F.mul(q_grid[gi][..., None], lam[gi])
        acc = term if acc is None else F.add(acc, term)
    return F.ext_sum(F.ext_mul(acc, x_tab[:, None, :]), axis=0)


def _eff(l_skip: int, n: int, r0):
    """(l_eff, omega_eff, r_eff) of a view of log height l_skip + n: a view
    below the skip domain lives on its 2^(l_skip + n) subgroup."""
    omega_skip = two_adic_generator(l_skip)
    if n < 0:
        return l_skip + n, pow(omega_skip, 1 << (-n), P), tpoly.squares(r0, 1 - n)[-1]
    return l_skip, omega_skip, r0


def prove_stacked_opening_reduction(
    transcript,
    params: SystemParams,
    stacked_per_commit: List[StackedPcsData],
    need_rot_per_commit: List[List[bool]],
    r: torch.Tensor,
) -> Tuple[StackingProof, torch.Tensor]:
    """``transcript``: a host :class:`~swirl_torch.transcript.Transcript` or a
    :class:`~.device_transcript.DeviceTranscript` on the data's device; r:
    the RAP stage's (n, 4) point there. Returns the proof (its values read
    in one copy) and u as an (n_stack + 1, 4) tensor on the data's device."""
    pending, u = stacked_opening_reduction_deferred(
        transcript, params, stacked_per_commit, need_rot_per_commit, r
    )
    return pending.fetch(), u


def stacked_opening_reduction_deferred(
    transcript,
    params: SystemParams,
    stacked_per_commit: List[StackedPcsData],
    need_rot_per_commit: List[List[bool]],
    r: torch.Tensor,
) -> Tuple[Deferred, torch.Tensor]:
    """The reduction with its proof values left on the device: (a
    :class:`~.deferred.Deferred` of the proof, u)."""
    l_skip = params.l_skip
    n_stack = params.n_stack
    omega_skip = two_adic_generator(l_skip)
    device = stacked_per_commit[0].device
    tr = device_view(transcript, device)
    lam = tr.sample_ext()

    # trace views with lambda slots (eq at 2i, rot at 2i+1)
    trace_views: List[TraceView] = []
    lam_idx = 0
    for com_idx, d in enumerate(stacked_per_commit):
        need_rot = need_rot_per_commit[com_idx]
        for mat_idx, _col, sl in d.layout.sorted_cols:
            rot_idx = lam_idx + 1 if need_rot[mat_idx] else None
            trace_views.append(TraceView(com_idx, sl, lam_idx, rot_idx))
            lam_idx += 2
    lambda_pows = F.epowers(lam, lam_idx if lam_idx else 1)

    # consecutive views of equal log height form a group
    groups: List[Tuple[int, int]] = []
    start = 0
    for i in range(1, len(trace_views) + 1):
        if (
            i == len(trace_views)
            or trace_views[i].slice.log_height != trace_views[start].slice.log_height
        ):
            groups.append((start, i))
            start = i

    def view_const(name: str, s: int, e: int, fn):
        """A group's static per-view values fn(view) as a cached tensor."""
        vals = tuple(fn(trace_views[i]) for i in range(s, e))
        return F.cached_const((name, vals), lambda: vals, device)

    # each group's (G, 4) lambda powers of its views, the rotated ones zero
    # where a view has no rotation
    group_lambdas: Dict[int, Tuple[torch.Tensor, torch.Tensor]] = {}
    for s, e in groups:
        has_rot = view_const("has rot", s, e, lambda tv: int(tv.lambda_rot_idx is not None))
        lam_rot = F.mul(lambda_pows[2 * s + 1 : 2 * e : 2], has_rot[:, None])
        group_lambdas[s] = (lambda_pows[2 * s : 2 * e : 2], lam_rot)

    r0 = r[0]
    eq_const = tpoly.eval_eq_uni_at_one(l_skip, F.mul(r0, omega_skip))

    eq_r_per_lht: Dict[int, torch.Tensor] = {}
    for tv in trace_views:
        lht = tv.slice.log_height
        if lht not in eq_r_per_lht:
            n_lift = max(lht - l_skip, 0)
            if r.shape[0] < 1 + n_lift:
                raise StackedReductionError(
                    f"eq_r missing entry for log_height={lht}: need "
                    f"{1 + n_lift} opening-point coords, got {r.shape[0]}"
                )
            eq_r_per_lht[lht] = eq_hypercube(r[1 : 1 + n_lift], device)

    # ---- univariate round 0 ---------------------------------------------
    g = GENERATOR
    shifts = [pow(g, c + 1, P) for c in range(2)]
    w_pows = roots_of_unity(l_skip)
    z_vec = tpoly.from_base_const(
        [sh * int(w_pows[i]) % P for sh in shifts for i in range(1 << l_skip)], device
    )  # (B_z, 4)
    eq_uni_1_b = tpoly.eval_eq_uni_at_one(l_skip, z_vec)

    stacked_mats = [d.get_matrix() for d in stacked_per_commit]
    total_evals = None
    for s, e in groups:
        lht = trace_views[s].slice.log_height
        n = lht - l_skip
        lam_eq, lam_rot = group_lambdas[s]
        eq_tab = eq_r_per_lht[lht]
        krot_tab = torch.roll(eq_tab, 1, dims=0)
        cols = []
        for i in range(s, e):
            tv = trace_views[i]
            sl = tv.slice
            cols.append(stacked_mats[tv.com_idx][sl.col_idx, sl.row_idx : sl.row_idx + sl.length(l_skip)])
        q_grid = coset_eval_chunks(torch.stack(cols), l_skip, shifts, False)
        a_h = _reduce_zx(q_grid, lam_eq, eq_tab)
        b_h = _reduce_zx(q_grid, lam_rot, eq_tab)
        c_h = _reduce_zx(q_grid, lam_rot, F.sub(krot_tab, eq_tab))
        del q_grid
        l_eff, omega_eff, r_eff = _eff(l_skip, n, r0)
        term = F.add(
            emul(tpoly.eval_eq_uni(l_eff, z_vec, r_eff), a_h),
            emul(tpoly.eval_eq_uni(l_eff, z_vec, F.mul(r_eff, omega_eff)), b_h),
        )
        term = F.add(term, emul(emul(eq_const, eq_uni_1_b), c_h))
        term = emul(term, tpoly.eval_in_uni(l_skip, n, z_vec))
        total_evals = term if total_evals is None else F.add(total_evals, term)

    grid = total_evals.reshape(2, 1 << l_skip, 4).transpose(0, 1)
    s0_deg = 2 * ((1 << l_skip) - 1)
    s0_coeffs = tr.observe_slice(tpoly.from_geometric_cosets_evals(grid, g, g)[: s0_deg + 1])

    u0 = tr.sample_ext()
    u: List[torch.Tensor] = [u0]

    # ---- fold at u_0 ------------------------------------------------------
    weights = tpoly.barycentric_weights(l_skip, u0)
    q_evals = [fold_ple(m, l_skip, False, weights) for m in stacked_mats]
    del stacked_mats  # a recomputed matrix is not kept

    eq_uni_u01 = tpoly.eval_eq_uni_at_one(l_skip, u0)
    k_rot_per_lht: Dict[int, torch.Tensor] = {}
    for lht, tab in list(eq_r_per_lht.items()):
        n = lht - l_skip
        ind = tpoly.eval_in_uni(l_skip, n, u0)
        l_eff, omega_eff, r_eff = _eff(l_skip, n, r0)
        eq_uni = tpoly.eval_eq_uni(l_eff, u0, r_eff)
        eq_uni_rot = tpoly.eval_eq_uni(l_eff, u0, F.mul(r_eff, omega_eff))
        c1 = emul(ind, eq_uni_rot)
        c2 = emul(ind, emul(eq_const, eq_uni_u01))
        k_rot_per_lht[lht] = F.add(
            F.ext_mul(c1, tab), F.ext_mul(c2, F.sub(torch.roll(tab, 1, dims=0), tab))
        )
        eq_r_per_lht[lht] = F.ext_mul(emul(ind, eq_uni), tab)

    # per-group eq(u, b) products of the tilde regime, by group start
    eq_ub_g: Dict[int, torch.Tensor] = {}
    one = F.ext_one(device)

    def view_bits(s: int, e: int, rnd: int):
        """The bit b of each view's row index that round ``rnd`` binds."""
        return view_const(f"row bit {rnd}", s, e, lambda tv: (tv.slice.row_idx >> (l_skip + rnd - 1)) & 1)

    # ---- rounds 1..n_stack ------------------------------------------------
    sumcheck_round_polys = []
    for rnd in range(1, n_stack + 1):
        s_evals = torch.zeros((2, 4), dtype=F.DTYPE, device=device)
        for s, e in groups:
            lht = trace_views[s].slice.log_height
            n_lift = max(lht - l_skip, 0)
            eq_tab = eq_r_per_lht[lht]
            krot_tab = k_rot_per_lht[lht]
            lam_eq, lam_rot = group_lambdas[s]
            if rnd <= n_lift:
                hd = n_lift - rnd
                cols = []
                for i in range(s, e):
                    tv = trace_views[i]
                    row_start = (tv.slice.row_idx >> lht) << (hd + 1)
                    cols.append(q_evals[tv.com_idx][tv.slice.col_idx, row_start : row_start + (2 << hd)])
                q_grid = torch.stack(cols)  # (G, 2 << hd, 4)
                evals = []
                for x in (1, 2):
                    q_x = interp_mle_at_int(q_grid, x)
                    eq_x = interp_mle_at_int(eq_tab, x)
                    krot_x = interp_mle_at_int(krot_tab, x)
                    w = F.add(
                        F.ext_mul(lam_eq[:, None, :], eq_x[None]),
                        F.ext_mul(lam_rot[:, None, :], krot_x[None]),
                    )
                    evals.append(F.ext_sum(F.ext_sum(F.ext_mul(q_x, w), axis=1), axis=0))
                s_evals = F.add(s_evals, torch.stack(evals))
                continue
            # tilde regime: one gathered pair per view, its weight
            # eq(x, b) * prod eq(u, b) of the rounds before, at x = 1, 2
            pairs = []
            for i in range(s, e):
                tv = trace_views[i]
                st = (tv.slice.row_idx >> (l_skip + rnd)) << 1
                pairs.append(q_evals[tv.com_idx][tv.slice.col_idx, st : st + 2])
            q_pairs = torch.stack(pairs)  # (G, 2, 4)
            q_x = torch.stack([q_pairs[:, 1], F.add(q_pairs[:, 1], F.sub(q_pairs[:, 1], q_pairs[:, 0]))])
            b = view_bits(s, e, rnd)
            # eq(x, b) = 1 + 2xb - x - b: b at x = 1, 3b - 1 at x = 2
            eq_xb = torch.stack([b, F.sub(F.mul(b, 3), torch.ones_like(b))])  # (2, G)
            ub = F.mul(eq_ub_g.get(s, one), eq_xb[..., None])  # (2, G, 4)
            w = F.add(emul(lam_eq, eq_tab[0]), emul(lam_rot, krot_tab[0]))  # (G, 4)
            s_evals = F.add(s_evals, F.ext_sum(emul(emul(q_x, ub), w), axis=1))

        sumcheck_round_polys.append(tr.observe_slice(s_evals))
        u_rnd = tr.sample_ext()
        u.append(u_rnd)
        q_evals = [fold_mle(q, u_rnd) for q in q_evals]
        eq_r_per_lht = {lht: fold_mle(tab, u_rnd) for lht, tab in eq_r_per_lht.items()}
        k_rot_per_lht = {lht: fold_mle(tab, u_rnd) for lht, tab in k_rot_per_lht.items()}
        for s, e in groups:
            n_lift = max(trace_views[s].slice.log_height - l_skip, 0)
            if rnd > n_lift:
                # eq(u, b) = b*u + (1-b)*(1-u) for the static bit b of each view
                b = view_bits(s, e, rnd)[:, None] == 1
                eq_ub_g[s] = emul(eq_ub_g.get(s, one), torch.where(b, u_rnd, F.sub(one, u_rnd)))

    opened = tr.observe_slice(torch.cat([q[:, 0] for q in q_evals]))  # (sum of widths, 4)
    widths = [int(q.shape[0]) for q in q_evals]

    def build(host):
        s0_h, opened_h, *polys_h = host
        stacking_openings, off = [], 0
        for w in widths:
            stacking_openings.append(list(opened_h[off : off + w]))
            off += w
        return StackingProof(
            univariate_round_coeffs=list(s0_h),
            sumcheck_round_polys=[[p[0], p[1]] for p in polys_h],
            stacking_openings=stacking_openings,
        )

    return Deferred([s0_coeffs, opened, *sumcheck_round_polys], build), torch.stack(u)
