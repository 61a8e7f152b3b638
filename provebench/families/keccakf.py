"""The Keccak-f family: ``KeccakAir`` (p3-keccak-air's columns, the
upstream ``examples/keccakf``) over random permutation inputs. Its trace is
made on the host by the reference's copy of the AIR, from 5 x 5 random
64-bit lanes a permutation."""

from __future__ import annotations

import numpy as np


def program_air(cfg):
    from swirl_torch.models.keccak import KeccakAir

    return KeccakAir()


def reference_air(cfg):
    from reference.models.keccak import KeccakAir

    return KeccakAir()


def host_trace(cfg, seed: int) -> np.ndarray:
    """The (rows, width) canonical trace of 2^log_permutations permutations
    of inputs drawn from ``seed``."""
    from reference.models.keccak import KeccakAir

    inputs = np.random.default_rng(seed).integers(0, 1 << 63, (1 << cfg["air"]["log_permutations"], 5, 5),
                                                  dtype=np.uint64)
    return KeccakAir().generate_trace(inputs)
