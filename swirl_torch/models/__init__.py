"""Flagship AIR workloads ("models") proved by the torch port.

The copy of ``swirl/models``: keccak-f (cf. the reference's
``crates/stark-sdk/examples/keccakf.rs``, which proves p3-keccak-air); the
synthetic replay AIRs live in ``swirl_torch.testing.synthetic``.
"""

from .keccak import KeccakAir, keccak_f  # noqa: F401
