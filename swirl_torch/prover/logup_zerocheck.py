"""Batched zerocheck + LogUp constraint prover on torch tensors.

Peer of ``swirl/prover/logup_zerocheck.py``: ``prove_gkr_phase`` (:461),
``_gkr_input_pq`` (:612), ``prove_batch_phase`` (:704, and its device flow
``_batch_phase_device`` :1409-2535) and ``prove_zerocheck_and_logup``
(:2536). Every value stays on the traces' device: the O(height) work (coset
grids, DAG evaluation, folds, hypercube sums) and the O(degree) polynomial
assembly (:mod:`swirl_torch.tpoly`), batched over traces. One code path
serves both transcripts (:func:`~.device_transcript.device_view`): on a
:class:`~.device_transcript.DeviceTranscript` a round reads nothing back,
and the stage reads the host three times (GKR's root check and copy, the
batch phase's one copy at its end); on a host transcript each observe reads
its value first.
With ``save_memory`` (``ProverConfig.zerocheck_save_memory``) round 0's
coset grids of a tall trace are built and summed in 8 segments of rows
(``chunked_sums``, :787-880), which bounds the live grid to 1/8; the sums,
and so the proof bytes, are the same.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import metrics
from .. import tpoly
from ..fields.babybear import GENERATOR, P, batch_inverse
from ..params import SystemParams, calculate_n_logup
from ..proof import BatchConstraintProof, GkrProof
from .errors import LogupZerocheckError
from ..symbolic import ConstraintsDag

from ..fields import field as F
from .dag_eval import DeviceEvaluator, acc_constraints, acc_interactions, interactions_pq
from .device_transcript import device_view
from .gkr import fractional_sumcheck
from .stacked_pcs import StackedLayout
from .sumcheck import (
    coset_eval_chunks,
    eq_hypercube,
    fold_mle,
    fold_ple,
    interp_mle_at_int,
    rot1,
    selectors_matrix,
)

emul = F.ext_mul_small

# zerocheck_save_memory segments round 0's grids only for traces of at
# least 2^13 hypercube chunks (8 segments need n_chunks % 8 == 0, and small
# grids are not worth the sequence): ``swirl/prover/logup_zerocheck.py:60-63``
_SAVE_MEMORY_MIN_CHUNKS_LOG = 13
SAVE_MEMORY_SEGMENTS = 8


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
            self._tables[key] = eq_hypercube(self.xi[start:end], self.device)
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


def _bus_terms(beta_pows, t: TraceProver):
    """Per-interaction beta^len * (bus + 1) as a (k, 4) tensor."""
    its = t.dag.interactions
    lens = tuple(len(it.message) for it in its)
    buses = tuple((it.bus_index + 1) % P for it in its)
    device = beta_pows.device
    idx = F.cached_const(("message lengths", lens), lambda: lens, device)
    bus = F.cached_const(("buses", buses), lambda: buses, device)
    return F.mul(beta_pows.index_select(0, idx), bus[:, None])


def prove_gkr_phase(tr, params: SystemParams, traces: List[TraceProver]):
    """LogUp grind, GKR input evaluation, fractional sumcheck and the xi
    extension sampling on the transcript view ``tr``
    (:func:`~.device_transcript.device_view`). Returns (gkr_proof, xi, beta):
    xi an (n, 4) and beta a (4,) tensor on the traces' device; the proof's
    ``logup_pow_witness`` is what the grind returned (a 0-d tensor on the
    device transcript, read with the batch phase's copy)."""
    l_skip = params.l_skip
    n_max, n_logup, inter_layout, max_msg_len = _phase_common(params, traces)
    device = traces[0].common.device

    logup_pow_witness = tr.grind(params.logup.pow_bits)
    alpha = tr.sample_ext()
    beta = tr.sample_ext()
    beta_pows = F.epowers(beta, max_msg_len + 1)

    xi_parts = []
    if inter_layout.sorted_cols:
        metrics.counter("gkr_interaction_cells", 1 << (l_skip + n_logup))
        p_dev, q_dev = _gkr_input_pq(traces, inter_layout, l_skip, n_logup, beta_pows, alpha, device)
        with metrics.span("fractional_sumcheck"):
            frac = fractional_sumcheck(tr, p_dev, q_dev, assert_zero=True)
        xi_parts.append(frac.xi)
    else:
        frac = fractional_sumcheck(tr, None, None)
    have = sum(int(x.shape[0]) for x in xi_parts)
    xi_parts += [tr.sample_ext()[None] for _ in range(l_skip + max(n_max, n_logup) - have)]
    xi = torch.cat(xi_parts) if xi_parts else torch.zeros((0, 4), dtype=F.DTYPE, device=device)

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
        pq = interactions_pq(t.dag, ev, beta_pows, _bus_terms(beta_pows, t))
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
    return p_dev, F.add(q_dev, alpha)


def _placed(x, start: int, size: int, limit: Optional[int] = None):
    """The rows of x (..., k, 4), cut at ``limit`` rows, placed from row
    ``start`` of a (..., size, 4) zero tensor and cut at its end."""
    out = x.new_zeros(x.shape[:-2] + (size, 4))
    k = min(x.shape[-2], size - start, x.shape[-2] if limit is None else limit)
    if k > 0:
        out[..., start : start + k, :] = x[..., :k, :]
    return out


def _row_segment(m, lo: int, rows: int, is_rot: bool):
    """Rows [lo, lo + rows) of the (w, h) matrix m, or of m rotated by one
    row (row i holds row i + 1, the last row the first) with ``is_rot``."""
    if not is_rot:
        return m[:, lo : lo + rows]
    hi = lo + 1 + rows
    if hi <= m.shape[1]:
        return m[:, lo + 1 : hi]
    return torch.cat([m[:, lo + 1 :], m[:, : hi - m.shape[1]]], dim=1)


def _eq_3b(xi, inter_layout, t_idx: int, t: TraceProver, l_skip: int, n_logup: int):
    """eq(xi[l_skip + n_lift : l_skip + n_logup], b) for the stacked row
    block b of each of the trace's interactions: a (k, 4) tensor."""
    lo, hi = l_skip + t.n_lift, l_skip + n_logup
    m = max(hi - lo, 0)
    blocks = tuple(
        inter_layout.get(t_idx, i).row_idx >> lo for i in range(len(t.dag.interactions))
    )
    bits = F.cached_const(
        ("interaction row bits", blocks, m),
        lambda: np.array([[(b >> j) & 1 for j in range(m)] for b in blocks], dtype=np.uint64).reshape(-1, m),
        xi.device,
    )
    return tpoly.eval_eq_mle(xi[lo : lo + m], F.ext_from_base(bits))


def prove_batch_phase(
    tr,
    params: SystemParams,
    global_degree: int,
    traces: List[TraceProver],
    xi: torch.Tensor,
    beta: torch.Tensor,
    carry: Sequence = (),
    save_memory: bool = False,
):
    """The batched zerocheck + LogUp sumcheck (univariate-skip round 0 and
    the multilinear rounds) and the column openings, on the transcript view
    ``tr``; xi (n, 4) and beta (4,) on the traces' device. Every value stays
    on the device until one copy at the end, which also reads the ``carry``
    values of the stage before. ``save_memory``: round 0's grids of a
    trace of at least 2^(l_skip + 13) rows in 8 segments. Returns (proof, r
    as an (n_max + 1, 4) tensor, the carry values on the host)."""
    l_skip = params.l_skip
    num_traces = len(traces)
    n_max, n_logup, inter_layout, max_msg_len = _phase_common(params, traces)
    device = traces[0].common.device
    d_global = global_degree
    eq_table = _EqTables(xi, device)
    beta_pows = F.epowers(beta, max_msg_len + 1)

    lam = tr.sample_ext()
    max_num_constraints = max(len(t.dag.constraint_idx) for t in traces)
    lambda_pows = F.epowers(lam, max(max_num_constraints, 1))

    bus_terms = [_bus_terms(beta_pows, t) if t.dag.interactions else None for t in traces]
    eq_3b = [
        _eq_3b(xi, inter_layout, t_idx, t, l_skip, n_logup) if t.dag.interactions else None
        for t_idx, t in enumerate(traces)
    ]

    # ---- univariate round 0 ---------------------------------------------
    sp0_zc: List[Optional[torch.Tensor]] = []  # (sp0_deg_air + 1, 4) coefficients
    sp0_logup: List[Optional[torch.Tensor]] = []  # (2, d_air << l_skip, 4): numerator, denominator
    g = GENERATOR
    for t_idx, t in enumerate(traces):
        eq_tab = eq_table(l_skip, l_skip + t.n_lift)  # (2^n_lift, 4)
        d_air = t.d_air
        sels_base = selectors_matrix(t.height, l_skip, device)

        # a segment's rows: selectors are row-global, so slicing them needs
        # an unlifted trace, which the height bound guarantees
        chunked = save_memory and t.height >= 1 << (l_skip + _SAVE_MEMORY_MIN_CHUNKS_LOG)
        segments = SAVE_MEMORY_SEGMENTS if chunked else 1
        seg_chunks = (1 << t.n_lift) // segments

        def grid_sums(num_cosets: int, eval_fn):
            """eq-weighted chunk sums of eval_fn's EF outputs on the coset
            grids: (cosets << l_skip, 4) tensors (grouped by coset), summed
            over the row segments (one segment: the whole grid)."""
            shifts = [pow(g, c + 1, P) for c in range(num_cosets)]
            rows = seg_chunks << l_skip
            total = None
            for ci in range(segments):

                def grid(m, is_rot):
                    if segments > 1:
                        m, is_rot = _row_segment(m, ci * rows, rows, is_rot), False
                    return coset_eval_chunks(m, l_skip, shifts, is_rot)

                sels_g = grid(sels_base, False)
                pairs = [
                    (grid(m, False), grid(m, True) if t.needs_next else None)
                    for m in t.base_parts()
                ]
                prep_g, main_g = t.split_pairs(pairs)
                ev = DeviceEvaluator(sels_g, prep_g, main_g, t.public_values, False)
                eq_seg = eq_tab[ci * seg_chunks : (ci + 1) * seg_chunks, None, :]
                sums = [F.ext_sum(F.ext_mul(p, eq_seg), axis=0) for p in eval_fn(ev)]
                # free this segment's grids before the next one is built
                del sels_g, pairs, prep_g, main_g, ev
                total = sums if total is None else [F.add(a, b) for a, b in zip(total, sums)]
            return total

        # zerocheck: (d_air - 1) cosets, divide by the zerofier, interpolate
        num_zc_cosets = d_air - 1
        sp0_deg_air = sumcheck_round0_deg(l_skip, d_air)
        if num_zc_cosets == 0:
            sp0_zc.append(None)
        else:
            (sums,) = grid_sums(
                num_zc_cosets, lambda ev: (acc_constraints(t.dag, ev, lambda_pows),)
            )
            zf_inv = F.cached_const(
                ("zerofier inverses", l_skip, num_zc_cosets),
                lambda: np.repeat(
                    batch_inverse(
                        np.array(
                            [(pow(g, (c + 1) << l_skip, P) - 1) % P for c in range(num_zc_cosets)],
                            dtype=np.uint64,
                        )
                    ),
                    1 << l_skip,
                ),
                device,
            )
            grid = F.mul(sums, zf_inv[:, None]).reshape(num_zc_cosets, 1 << l_skip, 4)
            q_coeffs = tpoly.from_geometric_cosets_evals(grid.transpose(0, 1), g, g)
            # -q(X) + X^(2^l_skip) q(X), cut at the round's degree
            n = sp0_deg_air + 1
            sp0_zc.append(F.sub(_placed(q_coeffs, 1 << l_skip, n), _placed(q_coeffs, 0, n)))

        # logup: d_air cosets, interpolate numerator and denominator
        if not t.dag.interactions:
            sp0_logup.append(None)
        else:
            sums = grid_sums(
                d_air,
                lambda ev: acc_interactions(t.dag, ev, beta_pows, bus_terms[t_idx], eq_3b[t_idx]),
            )
            grids = torch.stack(sums).reshape(2, d_air, 1 << l_skip, 4).transpose(1, 2)
            coeffs = tpoly.from_geometric_cosets_evals(grids, g, g)
            norm = pow(1 << max(0, -t.n), P - 2, P)
            sp0_logup.append(torch.stack([F.mul(coeffs[0], norm), coeffs[1]]))

    # ---- assemble s_0, observe the sum claims ---------------------------
    s_deg = d_global + 1
    sp0_deg = sumcheck_round0_deg(l_skip, d_global)
    s0_deg = sumcheck_round0_deg(l_skip, s_deg)
    big = 1 << s0_deg.bit_length() if s0_deg > 0 else 1
    zeros = torch.zeros((big, 4), dtype=F.DTYPE, device=device)

    def pad(coeffs):
        return zeros if coeffs is None else _placed(coeffs, 0, big, sp0_deg + 1)

    eq_sharp_evals = tpoly.dft_ef(pad(tpoly.eq_sharp_uni_poly(xi[:l_skip])))
    logup_evals = tpoly.dft_ef(
        torch.stack([pad(c) if c is not None else zeros.expand(2, big, 4) for c in sp0_logup])
    )
    s0_logup = tpoly.idft_ef(emul(logup_evals, eq_sharp_evals))  # (T, 2, big, 4)
    claims = F.mul(F.ext_sum(s0_logup[..., : s0_deg + 1 : 1 << l_skip, :], axis=-2), 1 << l_skip)
    claims = tr.observe_slice(claims)  # (T, 2, 4): numerator, denominator per trace

    mu = tr.sample_ext()
    mu_pows = F.epowers(mu, 3 * num_traces)
    # (T, 3, 4): each trace's weights of its zerocheck, numerator, denominator
    mu_t = torch.stack(
        [mu_pows[2 * num_traces :], mu_pows[0 : 2 * num_traces : 2], mu_pows[1 : 2 * num_traces : 2]],
        dim=1,
    )

    eq_uni_evals = tpoly.dft_ef(pad(tpoly.eq_uni_poly(l_skip, xi[0])))
    zc_batch = F.ext_sum(emul(torch.stack([pad(c) for c in sp0_zc]), mu_t[:, 0, None, :]), axis=0)
    s0_zc_poly = tpoly.idft_ef(emul(tpoly.dft_ef(zc_batch), eq_uni_evals))
    logup_term = F.ext_sum(emul(s0_logup, mu_t[:, 1:, None, :]), axis=(0, 1))
    s0_coeffs = F.add(s0_zc_poly, logup_term)[: s0_deg + 1]
    univariate = tr.observe_slice(s0_coeffs)

    r0 = tr.sample_ext()
    r: List[torch.Tensor] = [r0]
    prev_s_eval = tpoly.horner_eval(s0_coeffs, r0)

    # ---- fold the prismalinear columns at r_0 ---------------------------
    weights = tpoly.barycentric_weights(l_skip, r0)
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

    eq_n = tpoly.eval_eq_uni(l_skip, xi[0], r0)
    eq_sharp_n = tpoly.eval_eq_sharp_uni(l_skip, xi[:l_skip], r0)

    # ---- multilinear rounds ---------------------------------------------
    xi_rounds = xi[l_skip : l_skip + n_max]
    one = F.ext_one(device)
    inv_b = F.einv(F.sub(one, xi_rounds))  # 1 / eq(xi, 0) of every round
    points = tpoly.from_base_const(range(1, s_deg + 1), device)
    round_polys = []
    tilde: List[Optional[torch.Tensor]] = [None] * num_traces  # (3, 4) of an exhausted trace
    for rnd in range(1, n_max + 1):
        r_prev = r[rnd - 1]
        heads = []  # (3, d_global, 4) per active trace: zerocheck, numerator, denominator
        for t_idx, t in enumerate(traces):
            has_int = bool(t.dag.interactions)
            norm = pow(1 << max(0, -t.n), P - 2, P)
            if rnd > t.n_lift:
                if rnd == t.n_lift + 1:
                    # the DAG at the trace's single folded point, on the device
                    ev = DeviceEvaluator(t.sels, *t.split_pairs(_all_pairs(t)), t.public_values, True)
                    vals = [emul(eq_n, acc_constraints(t.dag, ev, lambda_pows)[0])]
                    if has_int:
                        numer, denom = acc_interactions(
                            t.dag, ev, beta_pows, bus_terms[t_idx], eq_3b[t_idx]
                        )
                        vals += [F.mul(emul(eq_sharp_n, numer[0]), norm), emul(eq_sharp_n, denom[0])]
                    else:
                        vals += [torch.zeros_like(vals[0])] * 2
                    tilde[t_idx] = torch.stack(vals)
                else:
                    tilde[t_idx] = emul(tilde[t_idx], r_prev)
                continue

            eq_tab = eq_table(l_skip + rnd, l_skip + t.n_lift)
            at_x = []
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
                outs = [acc_constraints(t.dag, ev, lambda_pows)]
                if has_int:
                    outs.extend(acc_interactions(t.dag, ev, beta_pows, bus_terms[t_idx], eq_3b[t_idx]))
                at_x.append(torch.stack([F.ext_sum(F.ext_mul(o, eq_tab), axis=0) for o in outs]))
            sums = torch.stack(at_x, dim=1)  # (1 or 3, d_global, 4)
            if has_int:
                sums = torch.stack([sums[0], F.mul(sums[1], norm), sums[2]])
            else:
                sums = torch.cat([sums, sums.new_zeros((2,) + sums.shape[1:])])
            heads.append(sums)

        # front-loaded batching: head traces still active, tail exhausted
        n_head = len(heads)
        head = F.ext_sum(emul(torch.stack(heads), mu_t[:n_head, :, None, :]), axis=0)
        sp_tail = (
            F.ext_sum(emul(torch.stack(tilde[n_head:]), mu_t[n_head:]), axis=(0, 1))
            if n_head < num_traces
            else torch.zeros_like(one)
        )
        # the head's evaluations at 1..d_global, then at 0 from the claim
        sp_head = F.add(emul(eq_n, head[0]), emul(eq_sharp_n, F.add(head[1], head[2])))
        xi_cur = xi_rounds[rnd - 1]
        at_0 = emul(F.sub(F.sub(prev_s_eval, emul(xi_cur, sp_head[0])), sp_tail), inv_b[rnd - 1])
        sp_head_coeffs = tpoly.lagrange_coeffs(range(s_deg), torch.cat([at_0[None], sp_head]))
        # batch_s(X) = eq(xi, X) * sp_head(X) + sp_tail * X
        b_c = F.sub(one, xi_cur)
        a_c = F.sub(xi_cur, b_c)
        coeffs = F.add(
            emul(_placed(sp_head_coeffs, 0, s_deg + 1), b_c),
            emul(_placed(sp_head_coeffs, 1, s_deg + 1), a_c),
        )
        coeffs[1] = F.add(coeffs[1], sp_tail)
        round_polys.append(tr.observe_slice(tpoly.horner_eval(coeffs, points)))

        r_rnd = tr.sample_ext()
        r.append(r_rnd)
        prev_s_eval = tpoly.horner_eval(coeffs, r_rnd)

        for t in traces:
            if t.sels.shape[1] > 1:
                t.sels = fold_mle(t.sels, r_rnd)
                fold_pair = lambda p: (  # noqa: E731
                    fold_mle(p[0], r_rnd),
                    fold_mle(p[1], r_rnd) if p[1] is not None else None,
                )
                if t.prep_pair is not None:
                    t.prep_pair = fold_pair(t.prep_pair)
                t.main_pairs = [fold_pair(p) for p in t.main_pairs]
        eq_mle = tpoly.eval_eq_mle(xi_cur[None], r_rnd[None])
        eq_n = emul(eq_n, eq_mle)
        eq_sharp_n = emul(eq_sharp_n, eq_mle)

    # ---- column openings ------------------------------------------------
    # each trace's parts as the proof lists them (common main, then
    # preprocessed, then cached), each part its (claim, rotated claim)
    # pairs, the rotated claim zero without a next row
    parts_per_trace = []
    for t in traces:
        pairs = _all_pairs(t)
        parts = []
        for local, nxt in pairs[-1:] + pairs[:-1]:
            rot = nxt[:, 0] if t.needs_next else torch.zeros_like(local[:, 0])
            parts.append(torch.stack([local[:, 0], rot], dim=1).reshape(-1, 4))
        parts_per_trace.append(parts)
    # one observe: every trace's common main, then the other parts trace by trace
    slots = [(t_idx, 0) for t_idx in range(num_traces)] + [
        (t_idx, i) for t_idx, parts in enumerate(parts_per_trace) for i in range(1, len(parts))
    ]
    opened = tr.observe_slice(torch.cat([parts_per_trace[t_idx][i] for t_idx, i in slots]))

    host = F.to_host_all([*carry, claims, univariate, *round_polys, opened])
    carry_h, (claims_h, univ_h, *rest) = host[: len(carry)], host[len(carry) :]
    polys_h, opened_h = rest[:-1], rest[-1]
    column_openings = [[None] * len(parts) for parts in parts_per_trace]
    off = 0
    for t_idx, i in slots:
        n = parts_per_trace[t_idx][i].shape[0]
        rows = opened_h[off : off + n]
        off += n
        column_openings[t_idx][i] = list(rows if traces[t_idx].needs_next else rows[0::2])

    batch_proof = BatchConstraintProof(
        numerator_term_per_air=[claims_h[t][0] for t in range(num_traces)],
        denominator_term_per_air=[claims_h[t][1] for t in range(num_traces)],
        univariate_round_coeffs=[univ_h[j] for j in range(s0_deg + 1)],
        sumcheck_round_polys=[[e[i] for i in range(s_deg)] for e in polys_h],
        column_openings=column_openings,
    )
    return batch_proof, torch.stack(r), carry_h


def _all_pairs(t: TraceProver):
    return ([t.prep_pair] if t.prep_pair else []) + t.main_pairs


def prove_zerocheck_and_logup(
    transcript,
    params: SystemParams,
    global_degree: int,
    traces: List[TraceProver],
    save_memory: bool = False,
) -> Tuple[GkrProof, BatchConstraintProof, torch.Tensor]:
    """The RAP stage on a host :class:`Transcript` or a
    :class:`~.device_transcript.DeviceTranscript` on the traces' device: the
    GKR phase, then the batch-constraint phase (``save_memory``: round 0's
    grids in segments). Returns the proofs and r, an (n_max + 1, 4) tensor
    on the traces' device."""
    tr = device_view(transcript, traces[0].common.device)
    gkr_proof, xi, beta = prove_gkr_phase(tr, params, traces)
    batch_proof, r, (witness,) = prove_batch_phase(
        tr, params, global_degree, traces, xi, beta, carry=[gkr_proof.logup_pow_witness],
        save_memory=save_memory,
    )
    if int(witness) >= P:  # kernel F's -1: no witness below P
        raise LogupZerocheckError("failed to find the LogUp PoW witness")
    gkr_proof.logup_pow_witness = int(witness)
    return gkr_proof, batch_proof, r
