"""Stacked opening reduction on torch tensors.

Peer of the host-transcript branch of ``prove_stacked_opening_reduction``
(``swirl/prover/stacked_reduction.py:47-594``): a batch sumcheck reducing
the per-trace column (and rotated-column) opening claims at the prism point
r to openings of the stacked matrix columns at a fresh prism point u.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import poly as hpoly
from ..fields import ext as hext
from ..fields.babybear import GENERATOR, P, roots_of_unity, two_adic_generator
from ..params import SystemParams
from ..proof import StackingProof
from .errors import StackedReductionError
from ..transcript import Transcript

from ..fields import field as F
from .stacked_pcs import StackedPcsData, StackedSlice
from .sumcheck import (
    barycentric_weights_host,
    coset_eval_chunks,
    ef_dev,
    ef_stack,
    eq_hypercube,
    fold_mle,
    fold_ple,
    interp_mle_at_int,
)


@dataclass
class TraceView:
    com_idx: int
    slice: StackedSlice
    lambda_eq_idx: int
    lambda_rot_idx: Optional[int]


def _reduce_zx(q_grid, lam, x_tab):
    """sum over (group g, x) of lam[g] * x_tab[x] * q[g, x, z] -> (B_z,) EF.

    q_grid (G, 2^n, B_z) base, lam (G, 4), x_tab (2^n, 4). The group sum runs
    first, one view at a time, so the largest temporary is (2^n, B_z, 4)."""
    acc = None
    for gi in range(q_grid.shape[0]):
        term = F.mul(q_grid[gi][..., None], lam[gi])
        acc = term if acc is None else F.add(acc, term)
    return F.to_host(F.ext_sum(F.ext_mul(acc, x_tab[:, None, :]), axis=0))


def prove_stacked_opening_reduction(
    transcript: Transcript,
    params: SystemParams,
    stacked_per_commit: List[StackedPcsData],
    need_rot_per_commit: List[List[bool]],
    r: List[np.ndarray],
) -> Tuple[StackingProof, List[np.ndarray]]:
    l_skip = params.l_skip
    n_stack = params.n_stack
    omega_skip = two_adic_generator(l_skip)
    device = stacked_per_commit[0].matrix.device
    lam = transcript.sample_ext()

    # trace views with lambda slots (eq at 2i, rot at 2i+1)
    trace_views: List[TraceView] = []
    lam_idx = 0
    for com_idx, d in enumerate(stacked_per_commit):
        need_rot = need_rot_per_commit[com_idx]
        for mat_idx, _col, sl in d.layout.sorted_cols:
            rot_idx = lam_idx + 1 if need_rot[mat_idx] else None
            trace_views.append(TraceView(com_idx, sl, lam_idx, rot_idx))
            lam_idx += 2
    lambda_pows = hext.epowers(lam, lam_idx if lam_idx else 1)

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

    r0 = r[0]
    eq_const = hpoly.eval_eq_uni_at_one(l_skip, hext.escale(r0, omega_skip))

    eq_r_per_lht: Dict[int, torch.Tensor] = {}
    for tv in trace_views:
        lht = tv.slice.log_height
        if lht not in eq_r_per_lht:
            n_lift = max(lht - l_skip, 0)
            if len(r) < 1 + n_lift:
                raise StackedReductionError(
                    f"eq_r missing entry for log_height={lht}: need "
                    f"{1 + n_lift} opening-point coords, got {len(r)}"
                )
            eq_r_per_lht[lht] = eq_hypercube(ef_stack(r[1 : 1 + n_lift]), device)

    def group_lambdas(s: int, e: int):
        lam_eq = np.stack([lambda_pows[trace_views[i].lambda_eq_idx] for i in range(s, e)])
        lam_rot = np.stack(
            [
                lambda_pows[trace_views[i].lambda_rot_idx]
                if trace_views[i].lambda_rot_idx is not None
                else hext.ezero()
                for i in range(s, e)
            ]
        )
        return lam_eq, lam_rot

    # ---- univariate round 0 ---------------------------------------------
    g = GENERATOR
    shifts = [pow(g, c + 1, P) for c in range(2)]
    B_z = 2 << l_skip
    w_pows = roots_of_unity(l_skip)
    z_points = [sh * int(w_pows[i]) % P for sh in shifts for i in range(1 << l_skip)]
    z_vec = np.stack([hext.from_base(z) for z in z_points])  # (B_z, 4)

    stacked_mats = [d.matrix for d in stacked_per_commit]
    total_evals = hext.ezero((B_z,))
    for s, e in groups:
        lht = trace_views[s].slice.log_height
        n = lht - l_skip
        lam_eq, lam_rot = (ef_dev(x, device) for x in group_lambdas(s, e))
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
        if n < 0:
            l_eff = l_skip + n
            omega_eff = pow(omega_skip, 1 << (-n), P)
            r_eff = hext.epow(r0, 1 << (-n))
        else:
            l_eff, omega_eff, r_eff = l_skip, omega_skip, r0
        ind_b = hpoly.eval_in_uni(l_skip, n, z_vec)
        eq_uni_r0_b = hpoly.eval_eq_uni(l_eff, z_vec, r_eff)
        eq_uni_r0_rot_b = hpoly.eval_eq_uni(l_eff, z_vec, hext.escale(r_eff, omega_eff))
        eq_uni_1_b = hpoly.eval_eq_uni_at_one(l_skip, z_vec)
        term = hext.emul(eq_uni_r0_b, a_h)
        term = hext.eadd(term, hext.emul(eq_uni_r0_rot_b, b_h))
        term = hext.eadd(term, hext.emul(hext.emul(eq_const, eq_uni_1_b), c_h))
        total_evals = hext.eadd(total_evals, hext.emul(term, ind_b))

    grid = total_evals.reshape(2, 1 << l_skip, 4).transpose(1, 0, 2)
    s0_deg = 2 * ((1 << l_skip) - 1)
    s0_coeffs = hpoly.from_geometric_cosets_evals(grid, g, g)[: s0_deg + 1]
    for c in s0_coeffs:
        transcript.observe_ext(c)

    u: List[np.ndarray] = [transcript.sample_ext()]
    u0 = u[0]

    # ---- fold at u_0 ------------------------------------------------------
    weights = ef_dev(barycentric_weights_host(l_skip, u0), device)
    q_evals = [fold_ple(m, l_skip, False, weights) for m in stacked_mats]

    eq_uni_u0r0 = hpoly.eval_eq_uni(l_skip, u0, r0)
    eq_uni_u0r0_rot = hpoly.eval_eq_uni(l_skip, u0, hext.escale(r0, omega_skip))
    eq_uni_u01 = hpoly.eval_eq_uni_at_one(l_skip, u0)
    k_rot_per_lht: Dict[int, torch.Tensor] = {}
    for lht, tab in list(eq_r_per_lht.items()):
        n = lht - l_skip
        ind = hpoly.eval_in_uni(l_skip, n, u0)
        if n < 0:
            omega_eff = pow(omega_skip, 1 << (-n), P)
            r_eff = hext.epow(r0, 1 << (-n))
            l_eff = l_skip + n
            eq_uni = hpoly.eval_eq_uni(l_eff, u0, r_eff)
            eq_uni_rot = hpoly.eval_eq_uni(l_eff, u0, hext.escale(r_eff, omega_eff))
        else:
            eq_uni, eq_uni_rot = eq_uni_u0r0, eq_uni_u0r0_rot
        c1 = ef_dev(hext.emul(ind, eq_uni_rot), device)
        c2 = ef_dev(hext.emul(ind, hext.emul(eq_const, eq_uni_u01)), device)
        k_rot_per_lht[lht] = F.add(
            F.ext_mul(c1, tab), F.ext_mul(c2, F.sub(torch.roll(tab, 1, dims=0), tab))
        )
        eq_r_per_lht[lht] = F.ext_mul(ef_dev(hext.emul(ind, eq_uni), device), tab)

    # per-group eq(u, b) accumulators of the tilde regime, by group start
    eq_ub_g: Dict[int, np.ndarray] = {}

    def tilde_eq_ub(s: int, e: int):
        if s not in eq_ub_g:
            eq_ub_g[s] = np.stack([hext.eone()] * (e - s))
        return eq_ub_g[s]

    # ---- rounds 1..n_stack ------------------------------------------------
    sumcheck_round_polys: List[List[np.ndarray]] = []
    for rnd in range(1, n_stack + 1):
        s_evals = [hext.ezero(), hext.ezero()]
        for s, e in groups:
            lht = trace_views[s].slice.log_height
            n_lift = max(lht - l_skip, 0)
            eq_tab = eq_r_per_lht[lht]
            krot_tab = k_rot_per_lht[lht]
            if rnd <= n_lift:
                hd = n_lift - rnd
                lam_eq, lam_rot = (ef_dev(x, device) for x in group_lambdas(s, e))
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
                vals = F.to_host(torch.stack(evals))
                s_evals = [hext.eadd(s_evals[i], vals[i]) for i in range(2)]
                continue
            # tilde regime: one gathered pair per view, (G, 4) host algebra
            eq0, krot0 = F.to_host(eq_tab[0]), F.to_host(krot_tab[0])
            pairs = []
            b_bits = []
            for i in range(s, e):
                tv = trace_views[i]
                st = (tv.slice.row_idx >> (l_skip + rnd)) << 1
                pairs.append(q_evals[tv.com_idx][tv.slice.col_idx, st : st + 2])
                b_bits.append((tv.slice.row_idx >> (l_skip + rnd - 1)) & 1)
            q_pairs = F.to_host(torch.stack(pairs))  # (G, 2, 4)
            lam_eq_vals, lam_rot_vals = group_lambdas(s, e)
            ub_base = tilde_eq_ub(s, e)
            for xi, x in enumerate((1, 2)):
                q_x = hext.eadd(
                    q_pairs[:, 0], hext.escale(hext.esub(q_pairs[:, 1], q_pairs[:, 0]), x)
                )
                # eq(x, b) = 1 + 2xb - x - b
                eqb_vec = np.stack([hext.from_base((1 + 2 * x * b - x - b) % P) for b in b_bits])
                ub = hext.emul(ub_base, eqb_vec)
                acc = hext.emul(lam_eq_vals, hext.emul(q_x, hext.emul(eq0, ub)))
                acc = hext.eadd(
                    acc, hext.emul(lam_rot_vals, hext.emul(q_x, hext.emul(krot0, ub)))
                )
                s_evals[xi] = hext.eadd(s_evals[xi], hext.esum(acc, axis=0))

        for ev in s_evals:
            transcript.observe_ext(ev)
        sumcheck_round_polys.append(list(s_evals))
        u_rnd = transcript.sample_ext()
        u.append(u_rnd)
        u_dev = ef_dev(u_rnd, device)
        q_evals = [fold_mle(q, u_dev) for q in q_evals]
        eq_r_per_lht = {lht: fold_mle(tab, u_dev) for lht, tab in eq_r_per_lht.items()}
        k_rot_per_lht = {lht: fold_mle(tab, u_dev) for lht, tab in k_rot_per_lht.items()}
        for s, e in groups:
            n_lift = max(trace_views[s].slice.log_height - l_skip, 0)
            if rnd > n_lift:
                # eq(u, b) = b*u + (1-b)*(1-u) for the static bit b of each view
                b_vec = np.stack(
                    [
                        hext.from_base((trace_views[i].slice.row_idx >> (l_skip + rnd - 1)) & 1)
                        for i in range(s, e)
                    ]
                )
                one = hext.eone()
                factor = hext.eadd(
                    hext.emul(b_vec, u_rnd),
                    hext.emul(hext.esub(one, b_vec), hext.esub(one, u_rnd)),
                )
                eq_ub_g[s] = hext.emul(tilde_eq_ub(s, e), factor)

    stacking_openings = []
    for q in q_evals:
        host = F.to_host(q[:, 0])  # (W, 4)
        opens = [host[c] for c in range(host.shape[0])]
        for c in opens:
            transcript.observe_ext(c)
        stacking_openings.append(opens)

    proof = StackingProof(
        univariate_round_coeffs=[c for c in s0_coeffs],
        sumcheck_round_polys=sumcheck_round_polys,
        stacking_openings=stacking_openings,
    )
    return proof, u
