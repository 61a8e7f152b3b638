"""System parameters for the SWIRL protocol.

Mirrors the parameter model of the reference (``crates/stark-backend/src/
config.rs``): ``SystemParams`` bundles the stacking shape (l_skip, n_stack,
w_stack), the RS blowup, the WHIR folding/query schedule, LogUp security
parameters and the global max constraint degree. ``WhirConfig.new`` derives
the per-round query counts from a target security level using proven
proximity-regime bounds (unique decoding / list decoding with multiplicity).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Literal, Optional, Tuple


@dataclass(frozen=True)
class LogUpSecurityParameters:
    """Bounds ensuring soundness of the LogUp bus argument
    (cf. reference ``interaction/mod.rs:219``)."""

    max_interaction_count: int
    log_max_message_length: int
    pow_bits: int

    def max_message_length(self) -> int:
        return 1 << self.log_max_message_length


@dataclass(frozen=True)
class ProximityRegime:
    """Per-round proximity regime; determines per-query security bits."""

    kind: Literal["unique", "list"]
    m: int = 1

    def max_agreement(self, log_inv_rate: int) -> float:
        rho = 2.0 ** (-log_inv_rate)
        if self.kind == "unique":
            agreement = (1.0 + rho) / 2.0
        else:
            m = max(self.m, 1)
            agreement = math.sqrt(rho) * (1.0 + 1.0 / (2.0 * m))
        return min(max(agreement, 5e-324), 1.0)

    def per_query_security_bits(self, log_inv_rate: int) -> float:
        return -math.log2(self.max_agreement(log_inv_rate))

    def query_security_bits(self, num_queries: int, log_inv_rate: int) -> float:
        return num_queries * self.per_query_security_bits(log_inv_rate)


@dataclass(frozen=True)
class WhirProximityStrategy:
    """unique | split (unique then list from `list_start_round`) | list."""

    kind: Literal["unique", "split", "list"]
    m: int = 1
    list_start_round: int = 0

    def in_round(self, whir_round: int) -> ProximityRegime:
        if self.kind == "unique":
            return ProximityRegime("unique")
        if self.kind == "list":
            return ProximityRegime("list", self.m)
        if whir_round < self.list_start_round:
            return ProximityRegime("unique")
        return ProximityRegime("list", self.m)


@dataclass(frozen=True)
class WhirRoundConfig:
    num_queries: int


@dataclass(frozen=True)
class WhirParams:
    k: int
    log_final_poly_len: int
    query_phase_pow_bits: int
    proximity: WhirProximityStrategy
    folding_pow_bits: int
    mu_pow_bits: int


@dataclass(frozen=True)
class WhirConfig:
    k: int
    rounds: Tuple[WhirRoundConfig, ...]
    mu_pow_bits: int
    query_phase_pow_bits: int
    folding_pow_bits: int
    proximity: WhirProximityStrategy

    @staticmethod
    def new(
        log_blowup: int,
        log_stacked_height: int,
        whir_params: WhirParams,
        security_bits: int,
    ) -> "WhirConfig":
        protocol_security_level = max(
            0, security_bits - whir_params.query_phase_pow_bits
        )
        k = whir_params.k
        num_rounds = -(
            -(max(0, log_stacked_height - whir_params.log_final_poly_len)) // k
        )
        log_inv_rate = log_blowup
        rounds = []
        for rnd in range(num_rounds):
            regime = whir_params.proximity.in_round(rnd)
            per_query = regime.per_query_security_bits(log_inv_rate)
            num_queries = math.ceil(protocol_security_level / per_query)
            rounds.append(WhirRoundConfig(num_queries))
            log_inv_rate = log_inv_rate + (k - 1)
        return WhirConfig(
            k=k,
            rounds=tuple(rounds),
            mu_pow_bits=whir_params.mu_pow_bits,
            query_phase_pow_bits=whir_params.query_phase_pow_bits,
            folding_pow_bits=whir_params.folding_pow_bits,
            proximity=whir_params.proximity,
        )

    def num_whir_rounds(self) -> int:
        return len(self.rounds)

    def num_sumcheck_rounds(self) -> int:
        return self.num_whir_rounds() * self.k

    def log_final_poly_len(self, log_stacked_height: int) -> int:
        return log_stacked_height - self.num_whir_rounds() * self.k


@dataclass(frozen=True)
class SystemParams:
    l_skip: int
    n_stack: int
    w_stack: int
    log_blowup: int
    whir: WhirConfig
    logup: LogUpSecurityParameters
    max_constraint_degree: int

    @property
    def log_stacked_height(self) -> int:
        return self.l_skip + self.n_stack

    @property
    def k_whir(self) -> int:
        return self.whir.k

    def log_final_poly_len(self) -> int:
        return self.whir.log_final_poly_len(self.log_stacked_height)

    def num_whir_rounds(self) -> int:
        return self.whir.num_whir_rounds()

    def num_whir_sumcheck_rounds(self) -> int:
        return self.whir.num_sumcheck_rounds()

    def logup_pow_bits(self) -> int:
        return self.logup.pow_bits


def calculate_n_logup(l_skip: int, total_interactions: int) -> int:
    """n_logup such that 2^(l_skip + n_logup) >= total_interactions + 1
    (bit-length formula; cf. reference ``lib.rs:82``)."""
    if total_interactions == 0:
        return 0
    return total_interactions.bit_length() - l_skip


# ---------------------------------------------------------------------------
# Presets (SDK tier). Small test params mirror the reference test suite's
# shrunken systems; production presets target 100-bit provable RBR security
# (cf. ``crates/stark-sdk/src/config/mod.rs``).
# ---------------------------------------------------------------------------


def test_whir_config_small(
    log_blowup: int, log_stacked_height: int, k_whir: int, log_final_poly_len: int
) -> WhirConfig:
    params = WhirParams(
        k=k_whir,
        log_final_poly_len=log_final_poly_len,
        query_phase_pow_bits=1,
        proximity=WhirProximityStrategy("split", m=3, list_start_round=1),
        folding_pow_bits=2,
        mu_pow_bits=3,
    )
    return WhirConfig.new(log_blowup, log_stacked_height, params, security_bits=5)


def test_system_params_small(
    l_skip: int, n_stack: int, k_whir: int, log_final_poly_len: Optional[int] = None,
    max_constraint_degree: int = 3,
) -> SystemParams:
    if log_final_poly_len is None:
        log_final_poly_len = (n_stack + l_skip) % k_whir
    assert log_final_poly_len < l_skip + n_stack
    log_blowup = 1
    return SystemParams(
        l_skip=l_skip,
        n_stack=n_stack,
        w_stack=1 << 12,
        log_blowup=log_blowup,
        whir=test_whir_config_small(
            log_blowup, l_skip + n_stack, k_whir, log_final_poly_len
        ),
        logup=LogUpSecurityParameters(
            max_interaction_count=1 << 30, log_max_message_length=7, pow_bits=2
        ),
        max_constraint_degree=max_constraint_degree,
    )


# Production preset constants (mirroring the reference SDK's tiers,
# ``crates/stark-sdk/src/config/mod.rs:29-138``)
DEFAULT_K_WHIR = 4
DEFAULT_WHIR_QUERY_PHASE_POW_BITS = 20
WHIR_MAX_LOG_FINAL_POLY_LEN = 10
SECURITY_BITS_TARGET = 100
MAX_APP_LOG_STACKED_HEIGHT = 24


def _logup_params_100_bits(log2_pcs_list_size: float = 0.0) -> LogUpSecurityParameters:
    """LogUp parameters with grinding calibrated for 100-bit security,
    accounting for the PCS list-size union bound.

    Reference-exact (``stark-sdk/src/config/log_up_params.rs:16-48``):
    max_interaction_count = |BabyBear|, log_max_message_length = 7 (the
    captured reth workload carries 32-felt messages), and pow_bits floored
    at 18 to keep the historical baseline margin for unique decoding."""
    import math

    max_interaction_count = 2013265921  # BabyBear::ORDER_U32
    log_max_message_length = 7
    min_pow_bits = 18  # MIN_BABY_BEAR_LOGUP_POW_BITS
    challenge_bits = 4 * math.log2(2013265921)
    base = (
        challenge_bits
        - math.log2(2.0 * max_interaction_count)
        - log_max_message_length
        - log2_pcs_list_size
    )
    pow_bits = max(
        min_pow_bits, math.ceil(SECURITY_BITS_TARGET - base)
    )
    return LogUpSecurityParameters(
        max_interaction_count=max_interaction_count,
        log_max_message_length=log_max_message_length,
        pow_bits=pow_bits,
    )


def params_with_100_bits_security(
    log_blowup: int,
    l_skip: int,
    n_stack: int,
    w_stack: int,
    folding_pow_bits: int,
    mu_pow_bits: int,
    proximity: WhirProximityStrategy,
    max_constraint_degree: int,
    whir_query_phase_pow_bits: int = DEFAULT_WHIR_QUERY_PHASE_POW_BITS,
    k_whir: int = DEFAULT_K_WHIR,
) -> SystemParams:
    whir_params = WhirParams(
        k=k_whir,
        log_final_poly_len=WHIR_MAX_LOG_FINAL_POLY_LEN,
        query_phase_pow_bits=whir_query_phase_pow_bits,
        proximity=proximity,
        folding_pow_bits=folding_pow_bits,
        mu_pow_bits=mu_pow_bits,
    )
    return SystemParams(
        l_skip=l_skip,
        n_stack=n_stack,
        w_stack=w_stack,
        log_blowup=log_blowup,
        whir=WhirConfig.new(
            log_blowup, l_skip + n_stack, whir_params, SECURITY_BITS_TARGET
        ),
        logup=_logup_params_100_bits(),
        max_constraint_degree=max_constraint_degree,
    )


def app_params_with_100_bits_security(log_stacked_height: int = 24) -> SystemParams:
    """App-tier preset: l_skip=4, log_blowup=1, w_stack=2048, k_whir=4,
    unique decoding, 100-bit RBR target."""
    assert log_stacked_height <= MAX_APP_LOG_STACKED_HEIGHT
    return params_with_100_bits_security(
        log_blowup=1,
        l_skip=4,
        n_stack=max(log_stacked_height - 4, 0),
        w_stack=2048,
        folding_pow_bits=5,
        mu_pow_bits=15,
        proximity=WhirProximityStrategy("unique"),
        max_constraint_degree=3,
    )


def leaf_params_with_100_bits_security(log_stacked_height: int = 23) -> SystemParams:
    return params_with_100_bits_security(
        log_blowup=2,
        l_skip=4,
        n_stack=max(log_stacked_height - 4, 0),
        w_stack=2048,
        folding_pow_bits=5,
        mu_pow_bits=15,
        proximity=WhirProximityStrategy("unique"),
        max_constraint_degree=4,
    )


def internal_params_with_100_bits_security(log_stacked_height: int = 22) -> SystemParams:
    return params_with_100_bits_security(
        log_blowup=3,
        l_skip=4,
        n_stack=max(log_stacked_height - 4, 0),
        w_stack=2048,
        folding_pow_bits=5,
        mu_pow_bits=15,
        proximity=WhirProximityStrategy("unique"),
        max_constraint_degree=4,
    )


def root_params_with_100_bits_security(log_stacked_height: int = 21) -> SystemParams:
    return params_with_100_bits_security(
        log_blowup=4,
        l_skip=4,
        n_stack=max(log_stacked_height - 4, 0),
        w_stack=2048,
        folding_pow_bits=5,
        mu_pow_bits=15,
        proximity=WhirProximityStrategy("unique"),
        max_constraint_degree=4,
    )
