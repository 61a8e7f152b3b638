"""Round-by-round (RBR) soundness accounting for the SWIRL protocol: the
copy of ``swirl/soundness.py``.

Python re-derivation of the reference's soundness calculator
(``crates/stark-backend/src/soundness/calculator.rs``): per-component
security-bit estimates for LogUp challenge sampling, GKR sumchecks and
batching, the fused batch-constraint boundary, the zerocheck sumcheck
rounds, the stacked reduction, and WHIR (mu batching, per-sub-round fold
errors via BCHKS25 proximity-gap bounds, OOD, biased query sampling and
gamma batching). All quantities are -log2(error) "bits"; the protocol's
security level is the minimum across components.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

from .params import ProximityRegime, SystemParams, WhirProximityStrategy

BABYBEAR_ORDER = float(2013265921)
# |EF| = p^4 for the quartic extension
CHALLENGE_FIELD_BITS = 4 * math.log2(BABYBEAR_ORDER)


def log2_add(a: float, b: float) -> float:
    """Numerically stable log2(2^a + 2^b)."""
    if math.isinf(a) and a > 0:
        return a
    if math.isinf(b) and b > 0:
        return b
    hi, lo = (a, b) if a >= b else (b, a)
    return hi + math.log2(1.0 + 2.0 ** (lo - hi))


def combine_security_bits(a: float, b: float) -> float:
    """-log2(2^-a + 2^-b)."""
    if math.isinf(a) and a > 0:
        return b
    if math.isinf(b) and b > 0:
        return a
    return -log2_add(-a, -b)


def sample_bits_residue_probs(n_bits: float, p: float):
    two_n = 2.0**n_bits
    c = math.floor(p / two_n)
    r = p - c * two_n
    return (c + 1.0) / p, c / p, r


def effective_pow_bits(pow_bits: int, p: float = BABYBEAR_ORDER) -> float:
    if pow_bits == 0:
        return 0.0
    p_hi, _, _ = sample_bits_residue_probs(float(pow_bits), p)
    return -math.log2(p_hi)


@dataclass
class ProximityGapSecurity:
    log2_err: float
    log2_list_size: float


def bchks25_reference_log2_degrees(log_degree: int, log_inv_rate: int, m: int):
    m_bar = max(m, 1) + 0.5
    l2_m = math.log2(m_bar)
    l2_n = float(log_degree + log_inv_rate)
    l2_rho = -float(log_inv_rate)
    l2_dx = l2_m + l2_n + 0.5 * l2_rho
    l2_dy = l2_m - 0.5 * l2_rho
    l2_dz = max(l2_dy, 2.0 * l2_m - math.log2(3.0) - l2_rho)
    return l2_dx, l2_dy, l2_dz


def log2_a_bound_bchks25(log_degree: int, log_inv_rate: int, m: int):
    """(log2(a_bound), log2(list_size)) per BCHKS25 Thm 1.5 contrapositive."""
    INVALID = (math.inf, math.inf)
    m_eff = max(m, 1)
    rho = 2.0 ** (-log_inv_rate)
    if rho <= 0 or not math.isfinite(rho):
        return INVALID
    if m_eff == 1 and rho >= 4.0 / 9.0:
        return INVALID
    sqrt_rho = math.sqrt(rho)
    eta = sqrt_rho / (2.0 * m_eff)
    gamma = 1.0 - sqrt_rho - eta
    if eta <= 0 or gamma <= 0 or gamma >= 1.0 - sqrt_rho:
        return INVALID
    l2_n = float(log_degree + log_inv_rate)
    l2_dx, l2_dy, l2_dz = bchks25_reference_log2_degrees(log_degree, log_inv_rate, m_eff)
    l2_gn1 = log2_add(math.log2(gamma) + l2_n, 0.0)
    # Equation (13): a > 2 D_X D_Y^2 D_Z + (gamma n + 1) D_Y
    l2_a = log2_add(1.0 + l2_dx + 2.0 * l2_dy + l2_dz, l2_dy + l2_gn1)
    if not math.isfinite(l2_a):
        return INVALID
    l2_a = max(l2_a, 0.0)
    a_bound = max(math.ceil(2.0**l2_a), 1.0)
    return math.log2(a_bound), l2_dy


def logup_soundness(
    max_interaction_count: int,
    log_max_message_length: int,
    challenge_field_bits: float,
    log2_list_size: float,
) -> float:
    """LogUp alpha/beta collision error (reference
    ``soundness/calculator.rs:195``); the PCS list size is a direct
    security penalty."""
    return (
        challenge_field_bits
        - math.log2(2.0 * max_interaction_count)
        - float(log_max_message_length)
        - log2_list_size
    )


def constraint_batching_soundness(
    challenge_field_bits: float,
    max_num_constraints_per_air: int,
    num_airs: int,
    l_skip: int,
    max_log_trace_height: int,
    n_logup: int,
    log2_list_size: float,
) -> float:
    """Fused batch-constraint boundary + mu-batching error (reference
    ``calculator.rs:282``): worst of the fused boundary degree
    ``max(n_extra,3) + (2^l_skip - 1) + (N_C - 1)`` and the 3-claims-per-AIR
    batching degree ``3*|T| - 1``."""
    assert max_num_constraints_per_air > 0 and num_airs > 0
    n_trace = max(max_log_trace_height - l_skip, 0)
    n_extra = max(n_trace - n_logup, 0)
    skip_deg = (1 << l_skip) - 1
    fused_deg = max(n_extra, 3) + skip_deg + (max_num_constraints_per_air - 1)
    batching_deg = 3 * num_airs - 1
    return (
        min(
            challenge_field_bits - math.log2(fused_deg),
            challenge_field_bits - math.log2(batching_deg),
        )
        - log2_list_size
    )


def whir_gamma_batching_security(
    challenge_field_bits: float, batch_size: int, log2_list_size: float
) -> float:
    """gamma-batching error of one WHIR round (reference
    ``calculator.rs:834``): batch = in-domain queries + OOD samples."""
    assert batch_size > 0
    return challenge_field_bits - math.log2(batch_size) - log2_list_size


def whir_proximity_gap_security(
    regime: ProximityRegime,
    challenge_field_bits: float,
    log_degree: int,
    log_inv_rate: int,
    batch_size: int,
) -> ProximityGapSecurity:
    assert batch_size > 1
    if regime.kind == "unique":
        log2_err = (
            challenge_field_bits
            - math.log2(batch_size - 1)
            - log_degree
            - log_inv_rate
        )
        return ProximityGapSecurity(log2_err, 0.0)
    l2_a, l2_list = log2_a_bound_bchks25(log_degree, log_inv_rate, regime.m)
    log2_err = challenge_field_bits - math.log2(batch_size - 1) - l2_a
    return ProximityGapSecurity(log2_err, l2_list)


def whir_query_security_biased(
    regime: ProximityRegime,
    num_queries: int,
    log_inv_rate: int,
    log_query_domain: int,
    p: float = BABYBEAR_ORDER,
) -> float:
    alpha = regime.max_agreement(log_inv_rate)
    _, _, r = sample_bits_residue_probs(float(log_query_domain), p)
    big_n = 2.0**log_query_domain
    heavy = min(alpha * big_n, r)
    mass = min(max(alpha * (1.0 - r / p) + heavy / p, 5e-324), 1.0)
    return -num_queries * math.log2(mass)


@dataclass
class WhirSoundness:
    mu_batching_bits: float
    fold_rbr_bits: float
    ood_rbr_bits: float
    shift_rbr_bits: float
    query_bits: float
    proximity_gaps_bits: float
    sumcheck_bits: float
    gamma_batching_bits: float


@dataclass
class SoundnessReport:
    logup_bits: float
    gkr_sumcheck_bits: float
    gkr_batching_bits: float
    zerocheck_sumcheck_bits: float
    constraint_batching_bits: float
    stacked_reduction_bits: float
    whir_bits: float
    whir: WhirSoundness
    total_bits: float


def calculate_soundness(
    params: SystemParams,
    max_num_constraints_per_air: int,
    num_airs: int,
    max_log_trace_height: int,
    num_trace_columns: int,
    num_stacked_columns: int,
    n_logup: int,
    base_field_order: float = BABYBEAR_ORDER,
    challenge_field_bits: float = CHALLENGE_FIELD_BITS,
) -> SoundnessReport:
    fb = challenge_field_bits
    init_gap = whir_proximity_gap_security(
        params.whir.proximity.in_round(0),
        fb,
        params.log_stacked_height,
        params.log_blowup,
        max(num_stacked_columns, 2),
    )
    l2_list = init_gap.log2_list_size

    logup_bits = logup_soundness(
        params.logup.max_interaction_count,
        params.logup.log_max_message_length,
        fb,
        l2_list,
    ) + effective_pow_bits(params.logup.pow_bits, base_field_order)

    gkr_sumcheck_bits = fb - math.log2(3)
    gkr_batching_bits = fb  # degree-1 mu/lambda tests

    d = params.max_constraint_degree
    uni_deg = (d + 1) * ((1 << params.l_skip) - 1)
    zerocheck_bits = fb - math.log2(max(uni_deg, d + 1)) - l2_list

    constraint_batching_bits = constraint_batching_soundness(
        fb,
        max_num_constraints_per_air,
        num_airs,
        params.l_skip,
        max_log_trace_height,
        n_logup,
        l2_list,
    )

    stacked_reduction_bits = (
        min(
            fb - math.log2(2.0 * max(num_trace_columns, 1)),
            fb - math.log2(2 * ((1 << params.l_skip) - 1)),
            fb - 1.0,
        )
        - l2_list
    )

    # ---- WHIR ----
    whir = params.whir
    k = whir.k
    mu_sec = whir_proximity_gap_security(
        whir.proximity.in_round(0),
        fb,
        params.log_stacked_height,
        params.log_blowup,
        max(num_stacked_columns, 2),
    )
    mu_bits = mu_sec.log2_err + effective_pow_bits(whir.mu_pow_bits, base_field_order)
    min_rbr = mu_bits
    min_query = math.inf
    min_prox = math.inf
    min_sc = math.inf
    min_ood = math.inf
    min_gamma = math.inf
    min_fold = math.inf
    min_shift = math.inf

    log_inv_rate = params.log_blowup
    cur_log_deg = params.log_stacked_height
    num_rounds = whir.num_whir_rounds()
    for rnd, rc in enumerate(whir.rounds):
        regime = whir.proximity.in_round(rnd)
        next_rate = log_inv_rate + (k - 1)
        l2_ls = None
        for _ in range(k):
            cur_log_deg -= 1
            gap = whir_proximity_gap_security(regime, fb, cur_log_deg, log_inv_rate, 2)
            l2_ls = gap.log2_list_size
            prox_bits = gap.log2_err + effective_pow_bits(
                whir.folding_pow_bits, base_field_order
            )
            min_prox = min(min_prox, prox_bits)
            sc_bits = (
                fb
                - math.log2(3)
                - l2_ls
                + effective_pow_bits(whir.folding_pow_bits, base_field_order)
            )
            min_sc = min(min_sc, sc_bits)
            fold_bits = combine_security_bits(sc_bits, prox_bits)
            min_fold = min(min_fold, fold_bits)
            min_rbr = min(min_rbr, fold_bits)

        log_query_domain = cur_log_deg + log_inv_rate
        q_bits = whir_query_security_biased(
            regime, rc.num_queries, log_inv_rate, log_query_domain, base_field_order
        ) + effective_pow_bits(whir.query_phase_pow_bits, base_field_order)
        min_query = min(min_query, q_bits)

        next_l2_ls = whir_proximity_gap_security(
            whir.proximity.in_round(rnd + 1), fb, cur_log_deg, next_rate, 2
        ).log2_list_size
        batch_size = rc.num_queries + 1  # one OOD sample
        gamma_bits = whir_gamma_batching_security(fb, batch_size, next_l2_ls)
        min_gamma = min(min_gamma, gamma_bits)
        shift_bits = combine_security_bits(q_bits, gamma_bits)
        min_shift = min(min_shift, shift_bits)
        min_rbr = min(min_rbr, shift_bits)

        if rnd != num_rounds - 1:
            ood_bits = (fb - cur_log_deg + 1.0) - 2.0 * next_l2_ls
            min_ood = min(min_ood, ood_bits)
            min_rbr = min(min_rbr, ood_bits)

        log_inv_rate = next_rate

    whir_details = WhirSoundness(
        mu_batching_bits=mu_bits,
        fold_rbr_bits=min_fold,
        ood_rbr_bits=min_ood,
        shift_rbr_bits=min_shift,
        query_bits=min_query,
        proximity_gaps_bits=min_prox,
        sumcheck_bits=min_sc,
        gamma_batching_bits=min_gamma,
    )
    whir_bits = min_rbr

    total = min(
        logup_bits,
        gkr_sumcheck_bits,
        gkr_batching_bits,
        zerocheck_bits,
        constraint_batching_bits,
        stacked_reduction_bits,
        whir_bits,
    )
    return SoundnessReport(
        logup_bits=logup_bits,
        gkr_sumcheck_bits=gkr_sumcheck_bits,
        gkr_batching_bits=gkr_batching_bits,
        zerocheck_sumcheck_bits=zerocheck_bits,
        constraint_batching_bits=constraint_batching_bits,
        stacked_reduction_bits=stacked_reduction_bits,
        whir_bits=whir_bits,
        whir=whir_details,
        total_bits=total,
    )


def format_soundness_report(
    params: SystemParams,
    report: SoundnessReport,
    *,
    max_num_constraints_per_air: int = 0,
    num_airs: int = 0,
    max_log_trace_height: int = 0,
    num_trace_columns: int = 0,
    num_stacked_columns: int = 0,
    n_logup: int = 0,
) -> str:
    """Human-readable soundness report (peer of the reference's
    ``print_soundness_report``, ``soundness/calculator.rs:846``): system
    parameters, proving context, per-component security bits, the WHIR
    error-source breakdown, and a per-round WHIR query/rate table."""
    w = params.whir
    lines = [
        "=== SWIRL Proof System Soundness Report ===",
        "",
        "System Parameters:",
        f"  l_skip: {params.l_skip}",
        f"  n_stack: {params.n_stack}",
        f"  log_blowup: {params.log_blowup}",
        f"  WHIR k: {w.k}",
        f"  WHIR rounds: {len(w.rounds)}",
        f"  WHIR mu_pow_bits: {w.mu_pow_bits}",
        f"  WHIR query_phase_pow_bits: {w.query_phase_pow_bits}",
        f"  WHIR folding_pow_bits: {w.folding_pow_bits}",
        f"  LogUp pow_bits: {params.logup.pow_bits}",
        f"  LogUp max_interaction_count: {params.logup.max_interaction_count}",
        f"  LogUp log_max_message_length: {params.logup.log_max_message_length}",
        f"  max_constraint_degree: {params.max_constraint_degree}",
        "",
        "Proving Context:",
        f"  max_num_constraints_per_air: {max_num_constraints_per_air}",
        f"  num_airs: {num_airs}",
        f"  max_log_trace_height: {max_log_trace_height}",
        f"  num_trace_columns: {num_trace_columns}",
        f"  num_stacked_columns: {num_stacked_columns}",
        f"  n_logup (GKR depth): {n_logup}",
        "",
        "Security Analysis (bits):",
        f"  LogUp (alpha/beta + PoW):    {report.logup_bits:.1f}",
        f"  GKR sumcheck:                {report.gkr_sumcheck_bits:.1f}",
        f"  GKR batching (mu/lambda):    {report.gkr_batching_bits:.1f}",
        f"  ZeroCheck sumcheck:          {report.zerocheck_sumcheck_bits:.1f}",
        f"  Fused boundary/batching:     {report.constraint_batching_bits:.1f}",
        f"  Stacked reduction:           {report.stacked_reduction_bits:.1f}",
        f"  WHIR (round-by-round min):   {report.whir_bits:.1f}",
        "",
        f"  TOTAL SECURITY:              {report.total_bits:.1f} bits",
        "",
        "WHIR Error Source Breakdown:",
        f"  Query error:          {report.whir.query_bits:.1f} bits",
        f"  Proximity gaps:       {report.whir.proximity_gaps_bits:.1f} bits",
        f"  Sumcheck error:       {report.whir.sumcheck_bits:.1f} bits",
        f"  Min eps_fold:         {report.whir.fold_rbr_bits:.1f} bits",
        f"  OOD error:            {report.whir.ood_rbr_bits:.1f} bits",
        f"  gamma batching error: {report.whir.gamma_batching_bits:.1f} bits",
        f"  mu batching error:    {report.whir.mu_batching_bits:.1f} bits",
        "",
        "WHIR Round Breakdown:",
    ]
    log_inv_rate = params.log_blowup
    for rnd, rc in enumerate(w.rounds):
        regime = w.proximity.in_round(rnd)
        query_sec = rc.num_queries * regime.per_query_security_bits(log_inv_rate)
        lines.append(
            f"  Round {rnd} | rate=2^-{log_inv_rate:<2} | "
            f"queries={rc.num_queries:<3} | query_sec={query_sec:5.1f} | "
            f"pow={w.query_phase_pow_bits} | fold_pow={w.folding_pow_bits}"
        )
        log_inv_rate += w.k - 1
    return "\n".join(lines)


def min_whir_queries(
    params: SystemParams, target_bits: int
) -> int:
    """Minimum queries per round so biased query sampling alone meets the
    target (cf. reference ``soundness/calculator.rs:979``)."""
    regime = params.whir.proximity.in_round(0)
    per_query = regime.per_query_security_bits(params.log_blowup)
    return math.ceil(target_bits / per_query)


# ---------------------------------------------------------------------------
# vk-level audit (peer of reference ``src/soundness/vk.rs``)
# ---------------------------------------------------------------------------


@dataclass
class VkAuditFinding:
    severity: str  # "info" | "warn" | "fail"
    message: str


@dataclass
class VkAuditReport:
    soundness: SoundnessReport
    findings: list
    achieved_bits: float
    target_bits: float

    @property
    def ok(self) -> bool:
        return not any(f.severity == "fail" for f in self.findings)


def audit_vk(params, mvk, target_bits: float = 100.0) -> VkAuditReport:
    """Audit a ``MultiStarkVerifyingKey`` against a security target.

    Recomputes the RBR soundness from the vk's actual shape (constraint
    counts, trace heights, stacked widths) rather than from preset
    assumptions, and flags structural hazards the calculator alone cannot
    see: interaction-count overflow headroom (trace-height linear
    constraints must exist whenever a bus could wrap the field), missing
    PoW gates, and degree overruns.
    """
    findings = []
    num_airs = len(mvk.per_air)
    max_constraints = max(
        (len(vk.symbolic_constraints.constraint_idx) for vk in mvk.per_air),
        default=1,
    )
    max_log_h = params.log_stacked_height
    num_cols = sum(
        vk.params.width.total_width() for vk in mvk.per_air
    )
    total_interactions = sum(
        len(vk.symbolic_constraints.interactions) for vk in mvk.per_air
    )
    n_logup = max(
        params.log_stacked_height - params.l_skip, 0
    )
    report = calculate_soundness(
        params,
        max_num_constraints_per_air=max(max_constraints, 1),
        num_airs=max(num_airs, 1),
        max_log_trace_height=max_log_h,
        num_trace_columns=max(num_cols, 1),
        num_stacked_columns=params.w_stack,
        n_logup=n_logup,
    )
    if report.total_bits < target_bits:
        findings.append(
            VkAuditFinding(
                "fail",
                f"total soundness {report.total_bits:.1f} bits < target "
                f"{target_bits:.1f}",
            )
        )
    for name in (
        "logup_bits",
        "zerocheck_sumcheck_bits",
        "stacked_reduction_bits",
        "whir_bits",
    ):
        bits = getattr(report, name)
        if bits < target_bits:
            findings.append(
                VkAuditFinding(
                    "warn", f"{name} = {bits:.1f} below target (RBR component)"
                )
            )
    if total_interactions and params.logup.pow_bits == 0:
        findings.append(
            VkAuditFinding(
                "warn",
                "interactions present but LogUp PoW gate disabled "
                "(pow_bits = 0)",
            )
        )
    for vk in mvk.per_air:
        d = vk.max_constraint_degree
        if d > params.max_constraint_degree:
            findings.append(
                VkAuditFinding(
                    "fail",
                    f"AIR constraint degree {d} exceeds params max "
                    f"{params.max_constraint_degree}",
                )
            )
    if total_interactions and not mvk.trace_height_constraints:
        findings.append(
            VkAuditFinding(
                "fail",
                "interactions present but no trace-height linear "
                "constraints in vk (bus count overflow unchecked)",
            )
        )
    return VkAuditReport(
        soundness=report,
        findings=findings,
        achieved_bits=report.total_bits,
        target_bits=target_bits,
    )
