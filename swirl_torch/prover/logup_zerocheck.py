"""Batched zerocheck + LogUp constraint prover on torch tensors.

Peer of the host-transcript branches of ``swirl/prover/logup_zerocheck.py``:
``prove_gkr_phase`` (:461), ``_gkr_input_pq`` (:612), ``prove_batch_phase``
(:704) and ``prove_zerocheck_and_logup`` (:2536). O(height) work (coset
grids, DAG evaluation, folds, hypercube sums) runs on tensors; O(degree)
polynomial assembly and the transcript run on the host in canonical numpy,
but for the GKR fractional sumcheck, which takes the device transcript
when the prover has one (``prove_gkr_phase``).
The JAX package's ``zerocheck_save_memory`` chunking is not ported: it
produces the same bytes, and the full round-0 grid fits the card.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import metrics
from .. import poly as hpoly
from ..fields import ext as hext
from ..fields.babybear import GENERATOR, P, batch_inverse
from ..params import SystemParams, calculate_n_logup
from ..proof import BatchConstraintProof, GkrProof, column_openings_by_rot
from .errors import LogupZerocheckError
from ..symbolic import ConstraintsDag
from ..transcript import Transcript

from ..fields import field as F
from .dag_eval import (
    DeviceEvaluator,
    HostEvaluator,
    acc_constraints,
    acc_constraints_host,
    acc_interactions,
    acc_interactions_host,
    interactions_pq,
)
from .device_transcript import handed_over
from .gkr import fractional_sumcheck
from .stacked_pcs import StackedLayout
from .sumcheck import (
    barycentric_weights_host,
    coset_eval_chunks,
    ef_dev,
    ef_stack,
    eq_hypercube,
    fold_mle,
    fold_ple,
    interp_mle_at_int,
    rot1,
    selectors_matrix,
)


def sumcheck_round0_deg(l_skip: int, d: int) -> int:
    return d * ((1 << l_skip) - 1)


@dataclass
class TraceProver:
    """Per-trace prover state."""

    air_id: int
    dag: ConstraintsDag
    needs_next: bool
    d_air: int
    public_values: List[int]
    height: int
    n: int  # log_height - l_skip (may be negative)
    preprocessed: Optional[torch.Tensor]  # (width, height) base
    cached: List[torch.Tensor]
    common: torch.Tensor
    # set during proving: EF (local, next|None) pairs per part
    prep_pair: Optional[Tuple] = None
    main_pairs: Optional[List[Tuple]] = None
    sels: Optional[torch.Tensor] = None  # (3, cur_h, 4) EF
    zerocheck_tilde: Optional[np.ndarray] = None
    logup_tilde: Optional[List[np.ndarray]] = None

    @property
    def n_lift(self) -> int:
        return max(self.n, 0)

    def base_parts(self) -> List[torch.Tensor]:
        prep = [self.preprocessed] if self.preprocessed is not None else []
        return prep + list(self.cached) + [self.common]

    def has_preprocessed(self) -> bool:
        return self.preprocessed is not None

    def split_pairs(self, pairs):
        """[prep?, cached..., common] pairs -> (prep_pair, main_pairs)."""
        if self.has_preprocessed():
            return pairs[0], pairs[1:]
        return None, pairs


class _EqTables:
    """Device eq tables over slices of xi, cached by (start, end)."""

    def __init__(self, xi, device):
        self.xi = xi
        self.device = device
        self._tables: Dict[Tuple[int, int], torch.Tensor] = {}

    def __call__(self, start: int, end: int):
        key = (start, end)
        if key not in self._tables:
            self._tables[key] = eq_hypercube(ef_stack(self.xi[start:end]), self.device)
        return self._tables[key]


def _validate_trace_dag(t: TraceProver) -> None:
    """Every DAG variable must index the trace's real widths."""
    num_parts = len(t.cached) + 1
    part_widths = [int(m.shape[0]) for m in t.cached] + [int(t.common.shape[0])]
    prep_width = int(t.preprocessed.shape[0]) if t.preprocessed is not None else 0
    for node in t.dag.nodes:
        if node[0] != "var":
            continue
        _, entry, part, _offset, index = node
        if entry == "preprocessed" and index >= prep_width:
            raise LogupZerocheckError(
                f"air {t.air_id}: preprocessed trace index {index} out of "
                f"bounds for width {prep_width}"
            )
        if entry == "main" and (part >= num_parts or index >= part_widths[part]):
            raise LogupZerocheckError(
                f"air {t.air_id}: main partition {part} col_index {index} "
                f">= width {part_widths[part] if part < num_parts else 0}"
            )
        if entry == "public" and index >= len(t.public_values):
            raise LogupZerocheckError(
                f"air {t.air_id}: public value index {index} out of bounds "
                f"for len {len(t.public_values)}"
            )
        if entry == "challenge":
            raise LogupZerocheckError(f"air {t.air_id}: challenge not supported")


def _phase_common(params, traces):
    """Validation, n_max, and the interactions stacked layout (striding
    threshold 0; widths are interaction counts, heights lifted heights)."""
    l_skip = params.l_skip
    if len(traces) == 0:
        raise LogupZerocheckError("prove_zerocheck_and_logup: no traces")
    for t in traces:
        _validate_trace_dag(t)
    total_interactions = 0
    inter_dims = []
    for t in traces:
        num_int = len(t.dag.interactions)
        log_lifted = max(t.height.bit_length() - 1, l_skip)
        total_interactions += num_int << log_lifted
        inter_dims.append((num_int, log_lifted))
    n_logup = calculate_n_logup(l_skip, total_interactions)
    inter_layout = StackedLayout.new(0, l_skip + n_logup, inter_dims)
    max_msg_len = max(
        (len(it.message) for t in traces for it in t.dag.interactions), default=0
    )
    n_max = max(max(t.n for t in traces), 0)
    return n_max, n_logup, inter_layout, max_msg_len


def _bus_terms(beta_pows, t: TraceProver, device):
    """Per-interaction beta^len * (bus + 1) as a (k, 4) tensor."""
    rows = [
        hext.escale(beta_pows[len(it.message)], (it.bus_index + 1) % P)
        for it in t.dag.interactions
    ]
    return ef_dev(ef_stack(rows), device)


def prove_gkr_phase(
    transcript: Transcript, params: SystemParams, traces: List[TraceProver], device_transcript=None
):
    """LogUp grind, GKR input evaluation, fractional sumcheck and the xi
    extension sampling. Returns (gkr_proof, xi, beta). With a
    ``device_transcript`` the fractional sumcheck runs on it, the sponge
    handed over from ``transcript`` and back."""
    l_skip = params.l_skip
    n_max, n_logup, inter_layout, max_msg_len = _phase_common(params, traces)
    device = traces[0].common.device

    logup_pow_witness = transcript.grind(params.logup.pow_bits)
    alpha = transcript.sample_ext()
    beta = transcript.sample_ext()
    beta_pows = hext.epowers(beta, max_msg_len + 1)

    if inter_layout.sorted_cols:
        metrics.counter("gkr_interaction_cells", 1 << (l_skip + n_logup))
        p_dev, q_dev = _gkr_input_pq(
            traces, inter_layout, l_skip, n_logup, beta_pows, alpha, device
        )
        with metrics.span("fractional_sumcheck"), handed_over(transcript, device_transcript) as t:
            frac = fractional_sumcheck(t, p_dev, q_dev, assert_zero=True)
    else:
        frac = fractional_sumcheck(transcript, None, None)

    xi = list(frac.xi)
    while len(xi) != l_skip + max(n_max, n_logup):
        xi.append(transcript.sample_ext())

    gkr_proof = GkrProof(
        logup_pow_witness=logup_pow_witness,
        q0_claim=frac.fractional_sum[1],
        claims_per_layer=frac.claims_per_layer,
        sumcheck_polys=frac.sumcheck_polys,
    )
    return gkr_proof, xi, beta


def _gkr_input_pq(traces, inter_layout, l_skip, n_logup, beta_pows, alpha, device):
    """GKR input (p, q): each interaction's counts and denominators, tiled to
    its lifted length (counts scaled by 1/reps) in the interactions layout
    order, zero-padded to 2^(l_skip + n_logup); q is shifted by alpha."""
    beta_pows_dev = ef_dev(beta_pows, device)
    per_key = {}
    for t_idx, t in enumerate(traces):
        if not t.dag.interactions:
            continue
        h = t.height
        pairs = [(m, rot1(m) if t.needs_next else None) for m in t.base_parts()]
        prep_pair, main_pairs = t.split_pairs(pairs)
        ev = DeviceEvaluator(
            selectors_matrix(h, 0, device), prep_pair, main_pairs, t.public_values, False
        )
        pq = interactions_pq(t.dag, ev, beta_pows_dev, _bus_terms(beta_pows, t, device))
        for s_idx, (count, h_beta) in enumerate(pq):
            per_key[(t_idx, s_idx)] = (count, h_beta, h)
    total = 1 << (l_skip + n_logup)
    p_dev = torch.zeros((total, 4), dtype=F.DTYPE, device=device)
    q_dev = torch.zeros((total, 4), dtype=F.DTYPE, device=device)
    pos = 0
    for t_idx, s_idx, sl in inter_layout.sorted_cols:
        assert sl.col_idx == 0 and sl.row_idx == pos, "non-contiguous"
        count, h_beta, h = per_key[(t_idx, s_idx)]
        length = 1 << sl.log_height
        reps = length // h
        if reps > 1:
            count = F.mul(count, pow(reps, P - 2, P))
        p_dev[pos : pos + length, 0] = count.repeat(reps)
        q_dev[pos : pos + length] = h_beta.repeat(reps, 1)
        pos += length
    return p_dev, F.add(q_dev, ef_dev(alpha, device))


def prove_batch_phase(
    transcript: Transcript,
    params: SystemParams,
    global_degree: int,
    traces: List[TraceProver],
    xi: List[np.ndarray],
    beta,
) -> Tuple[BatchConstraintProof, List[np.ndarray]]:
    """The batched zerocheck + LogUp sumcheck (univariate-skip round 0 and
    the multilinear rounds) and the column openings."""
    l_skip = params.l_skip
    num_traces = len(traces)
    n_max, n_logup, inter_layout, max_msg_len = _phase_common(params, traces)
    device = traces[0].common.device
    d_global = global_degree
    ZERO = hext.ezero()
    eq_table = _EqTables(xi, device)
    beta_pows = hext.epowers(beta, max_msg_len + 1)
    beta_pows_dev = ef_dev(beta_pows, device)

    lam = transcript.sample_ext()
    max_num_constraints = max(len(t.dag.constraint_idx) for t in traces)
    lambda_pows = hext.epowers(lam, max(max_num_constraints, 1))
    lambda_pows_dev = ef_dev(lambda_pows, device)

    eq_3b_per_trace: List[np.ndarray] = []
    for t_idx, t in enumerate(traces):
        xi_seg = ef_stack(xi[l_skip + t.n_lift : l_skip + n_logup])
        rows = []
        for i in range(len(t.dag.interactions)):
            b_int = inter_layout.get(t_idx, i).row_idx >> (l_skip + t.n_lift)
            bits = ef_stack(
                [hext.from_base((b_int >> j) & 1) for j in range(n_logup - t.n_lift)]
            )
            rows.append(hpoly.eval_eq_mle(xi_seg, bits))
        eq_3b_per_trace.append(ef_stack(rows))

    # ---- univariate round 0 ---------------------------------------------
    sp0_logup: List[Tuple[np.ndarray, np.ndarray]] = []
    sp0_zc: List[np.ndarray] = []
    g = GENERATOR
    for t_idx, t in enumerate(traces):
        eq_tab = eq_table(l_skip, l_skip + t.n_lift)  # (2^n_lift, 4)
        d_air = t.d_air
        sels_base = selectors_matrix(t.height, l_skip, device)

        def grid_sums(num_cosets: int, eval_fn):
            """eq-weighted chunk sums of eval_fn's EF outputs on the coset
            grids: each output (chunks, cosets << l_skip, 4) -> host sums."""
            shifts = [pow(g, c + 1, P) for c in range(num_cosets)]
            sels_g = coset_eval_chunks(sels_base, l_skip, shifts, False)
            pairs = [
                (
                    coset_eval_chunks(m, l_skip, shifts, False),
                    coset_eval_chunks(m, l_skip, shifts, True) if t.needs_next else None,
                )
                for m in t.base_parts()
            ]
            prep_g, main_g = t.split_pairs(pairs)
            ev = DeviceEvaluator(sels_g, prep_g, main_g, t.public_values, False)
            return tuple(
                F.to_host(F.ext_sum(F.ext_mul(p, eq_tab[:, None, :]), axis=0))
                for p in eval_fn(ev)
            )

        # zerocheck: (d_air - 1) cosets, divide by the zerofier, interpolate
        num_zc_cosets = d_air - 1
        sp0_deg_air = sumcheck_round0_deg(l_skip, d_air)
        if num_zc_cosets == 0:
            sp0_zc.append(np.stack([ZERO] * (sp0_deg_air + 1)))
        else:
            (sums,) = grid_sums(
                num_zc_cosets, lambda ev: (acc_constraints(t.dag, ev, lambda_pows_dev),)
            )
            zf = []
            for c in range(num_zc_cosets):
                sh = pow(g, c + 1, P)
                zf.extend([(pow(sh, 1 << l_skip, P) - 1) % P] * (1 << l_skip))
            q_evals = hext.escale(sums, batch_inverse(np.array(zf, dtype=np.uint64)))
            grid = q_evals.reshape(num_zc_cosets, 1 << l_skip, 4).transpose(1, 0, 2)
            q_coeffs = hpoly.from_geometric_cosets_evals(grid, g, g)
            coeffs = []
            nq = q_coeffs.shape[0]
            for i in range(sp0_deg_air + 1):
                c = hext.eneg(q_coeffs[i]) if i < nq else ZERO
                if i >= (1 << l_skip) and i - (1 << l_skip) < nq:
                    c = hext.eadd(c, q_coeffs[i - (1 << l_skip)])
                coeffs.append(c)
            sp0_zc.append(np.stack(coeffs))

        # logup: d_air cosets, interpolate numerator and denominator
        if not t.dag.interactions:
            sp0_logup.append((ef_stack([]), ef_stack([])))
        else:
            bus_terms = _bus_terms(beta_pows, t, device)
            eq_3b_dev = ef_dev(eq_3b_per_trace[t_idx], device)
            n_sum, d_sum = grid_sums(
                d_air,
                lambda ev: acc_interactions(t.dag, ev, beta_pows_dev, bus_terms, eq_3b_dev),
            )
            numer_coeffs, denom_coeffs = (
                hpoly.from_geometric_cosets_evals(
                    s.reshape(d_air, 1 << l_skip, 4).transpose(1, 0, 2), g, g
                )
                for s in (n_sum, d_sum)
            )
            norm = pow(1 << max(0, -t.n), P - 2, P)
            sp0_logup.append((hext.escale(numer_coeffs, norm), denom_coeffs))

    # ---- assemble s_0, observe the sum claims ---------------------------
    s_deg = d_global + 1
    sp0_deg = sumcheck_round0_deg(l_skip, d_global)
    s0_deg = sumcheck_round0_deg(l_skip, s_deg)
    big = 1 << s0_deg.bit_length() if s0_deg > 0 else 1

    def pad(coeffs, size: int):
        k = min(coeffs.shape[0], sp0_deg + 1, size)
        return np.stack([coeffs[i] for i in range(k)] + [ZERO] * (size - k))

    eq_sharp_evals = hpoly.dft_ef(pad(hpoly.eq_sharp_uni_poly(np.stack(xi[:l_skip])), big))
    s0_logup_polys = []  # 2 * num_traces coefficient arrays (big, 4)
    for t_idx in range(num_traces):
        for which in range(2):
            evals = hpoly.dft_ef(pad(sp0_logup[t_idx][which], big))
            s0_logup_polys.append(hpoly.idft_ef(hext.emul(evals, eq_sharp_evals)))

    numerator_term_per_air = []
    denominator_term_per_air = []
    for t_idx in range(num_traces):
        for which in range(2):
            coeffs = s0_logup_polys[2 * t_idx + which]
            acc = ZERO
            for j in range(0, s0_deg + 1, 1 << l_skip):
                acc = hext.eadd(acc, coeffs[j])
            claim = hext.escale(acc, 1 << l_skip)
            (numerator_term_per_air if which == 0 else denominator_term_per_air).append(claim)
            transcript.observe_ext(claim)

    mu = transcript.sample_ext()
    mu_pows = hext.epowers(mu, 3 * num_traces)

    eq_uni_evals = hpoly.dft_ef(pad(hpoly.eq_uni_poly(l_skip, xi[0]), big))
    zc_batch = None
    for t_idx in range(num_traces):
        term = hext.emul(pad(sp0_zc[t_idx], big), mu_pows[2 * num_traces + t_idx])
        zc_batch = term if zc_batch is None else hext.eadd(zc_batch, term)
    s0_zc_poly = hpoly.idft_ef(hext.emul(hpoly.dft_ef(zc_batch), eq_uni_evals))

    s0_coeffs = []
    for j in range(s0_deg + 1):
        c = s0_zc_poly[j]
        for t_idx in range(num_traces):
            c = hext.eadd(c, hext.emul(mu_pows[2 * t_idx], s0_logup_polys[2 * t_idx][j]))
            c = hext.eadd(
                c, hext.emul(mu_pows[2 * t_idx + 1], s0_logup_polys[2 * t_idx + 1][j])
            )
        s0_coeffs.append(c)
        transcript.observe_ext(c)
    s0_coeffs = np.stack(s0_coeffs)

    r: List[np.ndarray] = [transcript.sample_ext()]
    r0 = r[0]
    prev_s_eval = hpoly.horner_eval(s0_coeffs, r0)

    # ---- fold the prismalinear columns at r_0 ---------------------------
    weights = ef_dev(barycentric_weights_host(l_skip, r0), device)
    for t in traces:
        pairs = [
            (
                fold_ple(m, l_skip, False, weights),
                fold_ple(m, l_skip, True, weights) if t.needs_next else None,
            )
            for m in t.base_parts()
        ]
        t.prep_pair, t.main_pairs = t.split_pairs(pairs)
        t.sels = fold_ple(selectors_matrix(t.height, l_skip, device), l_skip, False, weights)

    eq_ns = [hpoly.eval_eq_uni(l_skip, xi[0], r0)]
    eq_sharp_ns = [hpoly.eval_eq_sharp_uni(l_skip, np.stack(xi[:l_skip]), r0)]

    # ---- multilinear rounds ---------------------------------------------
    sumcheck_round_polys: List[List[np.ndarray]] = []
    n_per_trace = [t.n for t in traces]
    for rnd in range(1, n_max + 1):
        r_prev = r[rnd - 1]
        sp_zc_evals: List[List[np.ndarray]] = []
        sp_logup_evals: List[List[np.ndarray]] = []
        for t_idx, t in enumerate(traces):
            has_int = bool(t.dag.interactions)
            norm = pow(1 << max(0, -t.n), P - 2, P)
            if rnd > t.n_lift:
                if rnd == t.n_lift + 1:
                    # pull the folded single-point values to the host
                    hev = _host_evaluator(t)
                    t.zerocheck_tilde = hext.emul(
                        eq_ns[rnd - 1], acc_constraints_host(t.dag, hev, lambda_pows)
                    )
                    if has_int:
                        numer, denom = acc_interactions_host(
                            t.dag, hev, beta_pows, eq_3b_per_trace[t_idx]
                        )
                        t.logup_tilde = [
                            hext.escale(hext.emul(eq_sharp_ns[rnd - 1], numer), norm),
                            hext.emul(eq_sharp_ns[rnd - 1], denom),
                        ]
                else:
                    t.zerocheck_tilde = hext.emul(t.zerocheck_tilde, r_prev)
                    if has_int:
                        t.logup_tilde = [hext.emul(x, r_prev) for x in t.logup_tilde]
                sp_zc_evals.append([t.zerocheck_tilde])
                if has_int:
                    sp_logup_evals.append([t.logup_tilde[0]])
                    sp_logup_evals.append([t.logup_tilde[1]])
                else:
                    sp_logup_evals.extend([[ZERO] * d_global, [ZERO] * d_global])
                continue

            eq_tab = eq_table(l_skip + rnd, l_skip + t.n_lift)
            zc_at, nm_at, dn_at = [], [], []
            bus_terms = _bus_terms(beta_pows, t, device) if has_int else None
            eq_3b_dev = ef_dev(eq_3b_per_trace[t_idx], device) if has_int else None
            for x in range(1, d_global + 1):
                pairs_x = [
                    (
                        interp_mle_at_int(local, x),
                        interp_mle_at_int(nxt, x) if nxt is not None else None,
                    )
                    for local, nxt in _all_pairs(t)
                ]
                prep_x, main_x = t.split_pairs(pairs_x)
                ev = DeviceEvaluator(
                    interp_mle_at_int(t.sels, x), prep_x, main_x, t.public_values, True
                )
                outs = [acc_constraints(t.dag, ev, lambda_pows_dev)]
                if has_int:
                    outs.extend(acc_interactions(t.dag, ev, beta_pows_dev, bus_terms, eq_3b_dev))
                sums = F.to_host(
                    torch.stack([F.ext_sum(F.ext_mul(o, eq_tab), axis=0) for o in outs])
                )
                zc_at.append(sums[0])
                if has_int:
                    nm_at.append(hext.escale(sums[1], norm))
                    dn_at.append(sums[2])
            sp_zc_evals.append(zc_at)
            if has_int:
                sp_logup_evals.extend([nm_at, dn_at])
            else:
                sp_logup_evals.extend([[ZERO] * d_global, [ZERO] * d_global])

        # front-loaded batching: head traces still active, tail exhausted
        tail_start = next((i for i, n_t in enumerate(n_per_trace) if rnd > n_t), num_traces)
        sp_head_zc = [ZERO] * d_global
        sp_head_logup = [ZERO] * d_global
        sp_tail = ZERO
        for t_idx in range(num_traces):
            zc_i, nm_i, dn_i = 2 * num_traces + t_idx, 2 * t_idx, 2 * t_idx + 1
            if t_idx < tail_start:
                for i in range(d_global):
                    sp_head_zc[i] = hext.eadd(
                        sp_head_zc[i], hext.emul(mu_pows[zc_i], sp_zc_evals[t_idx][i])
                    )
                    sp_head_logup[i] = hext.eadd(
                        sp_head_logup[i],
                        hext.eadd(
                            hext.emul(mu_pows[nm_i], sp_logup_evals[nm_i][i]),
                            hext.emul(mu_pows[dn_i], sp_logup_evals[dn_i][i]),
                        ),
                    )
            else:
                sp_tail = hext.eadd(
                    sp_tail,
                    hext.eadd(
                        hext.emul(mu_pows[zc_i], sp_zc_evals[t_idx][0]),
                        hext.eadd(
                            hext.emul(mu_pows[nm_i], sp_logup_evals[nm_i][0]),
                            hext.emul(mu_pows[dn_i], sp_logup_evals[dn_i][0]),
                        ),
                    ),
                )

        sp_head_evals = [ZERO] * s_deg
        for i in range(d_global):
            sp_head_evals[i + 1] = hext.eadd(
                hext.emul(eq_ns[rnd - 1], sp_head_zc[i]),
                hext.emul(eq_sharp_ns[rnd - 1], sp_head_logup[i]),
            )
        xi_cur = xi[l_skip + rnd - 1]
        b_c = hext.esub(hext.eone(), xi_cur)
        sp_head_evals[0] = hext.emul(
            hext.esub(hext.esub(prev_s_eval, hext.emul(xi_cur, sp_head_evals[1])), sp_tail),
            hext.einv(b_c),
        )
        sp_head_coeffs = hpoly.lagrange_coeffs(list(range(s_deg)), np.stack(sp_head_evals))
        # batch_s(X) = eq(xi, X) * sp_head(X) + sp_tail * X
        coeffs = [sp_head_coeffs[i] for i in range(s_deg)] + [ZERO]
        a_c = hext.esub(xi_cur, b_c)
        for i in range(s_deg - 1, -1, -1):
            coeffs[i + 1] = hext.eadd(hext.emul(a_c, coeffs[i]), hext.emul(b_c, coeffs[i + 1]))
        coeffs[0] = hext.emul(coeffs[0], b_c)
        coeffs[1] = hext.eadd(coeffs[1], sp_tail)
        coeffs = np.stack(coeffs)
        batch_evals = [hpoly.horner_eval(coeffs, hext.from_base(i)) for i in range(1, s_deg + 1)]
        for e in batch_evals:
            transcript.observe_ext(e)
        sumcheck_round_polys.append(batch_evals)

        r_rnd = transcript.sample_ext()
        r.append(r_rnd)
        prev_s_eval = hpoly.horner_eval(coeffs, r_rnd)

        r_dev = ef_dev(r_rnd, device)
        for t in traces:
            if t.sels.shape[1] > 1:
                t.sels = fold_mle(t.sels, r_dev)
                fold_pair = lambda p: (  # noqa: E731
                    fold_mle(p[0], r_dev),
                    fold_mle(p[1], r_dev) if p[1] is not None else None,
                )
                if t.prep_pair is not None:
                    t.prep_pair = fold_pair(t.prep_pair)
                t.main_pairs = [fold_pair(p) for p in t.main_pairs]
        eq_mle = hpoly.eval_eq_mle(xi_cur.reshape(1, 4), r_rnd.reshape(1, 4))
        eq_ns.append(hext.emul(eq_ns[rnd - 1], eq_mle))
        eq_sharp_ns.append(hext.emul(eq_sharp_ns[rnd - 1], eq_mle))

    # ---- column openings ------------------------------------------------
    column_openings: List[List[List[np.ndarray]]] = []
    for t in traces:
        part_openings = []
        for local, nxt in _all_pairs(t):
            lh = F.to_host(local[:, 0])  # (w, 4)
            if t.needs_next:
                nh = F.to_host(nxt[:, 0])
                flat = [v for c in range(lh.shape[0]) for v in (lh[c], nh[c])]
            else:
                flat = [lh[c] for c in range(lh.shape[0])]
            part_openings.append(flat)
        # common main first, then preprocessed, then cached
        column_openings.append([part_openings[-1]] + part_openings[:-1])
    for t_idx, t in enumerate(traces):
        for claim, claim_rot in column_openings_by_rot(column_openings[t_idx][0], t.needs_next):
            transcript.observe_ext(claim)
            transcript.observe_ext(claim_rot)
    for t_idx, t in enumerate(traces):
        for part in column_openings[t_idx][1:]:
            for claim, claim_rot in column_openings_by_rot(part, t.needs_next):
                transcript.observe_ext(claim)
                transcript.observe_ext(claim_rot)

    batch_proof = BatchConstraintProof(
        numerator_term_per_air=numerator_term_per_air,
        denominator_term_per_air=denominator_term_per_air,
        univariate_round_coeffs=[s0_coeffs[j] for j in range(s0_deg + 1)],
        sumcheck_round_polys=sumcheck_round_polys,
        column_openings=column_openings,
    )
    return batch_proof, r


def _all_pairs(t: TraceProver):
    return ([t.prep_pair] if t.prep_pair else []) + t.main_pairs


def _host_evaluator(t: TraceProver) -> HostEvaluator:
    """Evaluator at the single folded point of an exhausted trace."""
    sels_h = F.to_host(t.sels[:, 0])
    parts_cols = []
    for local, nxt in _all_pairs(t):
        lh = F.to_host(local[:, 0])
        nh = F.to_host(nxt[:, 0]) if nxt is not None else None
        parts_cols.append(
            [(lh[c], nh[c] if nh is not None else None) for c in range(lh.shape[0])]
        )
    prep_cols, main_cols = t.split_pairs(parts_cols)
    return HostEvaluator((sels_h[0], sels_h[1], sels_h[2]), prep_cols, main_cols, t.public_values)


def prove_zerocheck_and_logup(
    transcript: Transcript,
    params: SystemParams,
    global_degree: int,
    traces: List[TraceProver],
    device_transcript=None,
) -> Tuple[GkrProof, BatchConstraintProof, List[np.ndarray]]:
    """The RAP stage: GKR phase, then the batch-constraint phase (its
    fractional sumcheck on ``device_transcript`` when one is given)."""
    gkr_proof, xi, beta = prove_gkr_phase(transcript, params, traces, device_transcript)
    batch_proof, r = prove_batch_phase(transcript, params, global_degree, traces, xi, beta)
    return gkr_proof, batch_proof, r
