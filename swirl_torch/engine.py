"""StarkEngine for the torch port: keygen, context construction, debug
check, prove and verify.

Peer of ``swirl/engine.py``: ``prover_config`` is the memory policy
(:class:`~swirl_torch.prover.backend.ProverConfig`), ``hash_scheme`` the
Fiat-Shamir and commitment hash (:func:`~swirl_torch.hash.scheme.get_scheme`:
the default BabyBear Poseidon2-16, or ``"bn254-outer"``, the outer-recursion
scheme, whose digests are single BN254 scalars). A fresh transcript of the
scheme serves each proof and each verification, unless the caller hands
the prover a transcript (a device one among them, on the default scheme
only). The engine runs on the CUDA card unless the caller passes another
device (``device="cpu"`` for the tests); the debug check runs on the
traces' device, the verifier on the host (:mod:`swirl_torch.verifier`).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from .air import Air
from .debug import check_constraints_and_interactions
from .keygen import MultiStarkKeygenBuilder, MultiStarkProvingKey, MultiStarkVerifyingKey
from .params import SystemParams
from .proof import Proof
from .transcript import Transcript
from .verifier import verify as verify_proof

from .hash.scheme import get_scheme
from .prover.backend import (
    AirContext,
    Coordinator,
    DeviceMultiStarkProvingKey,
    ProverConfig,
    ProvingContext,
    TorchBackend,
    to_device_matrix,
)
from .prover.device_transcript import DeviceTranscript
from .prover.errors import ProverError


class StarkEngine:
    def __init__(
        self,
        params: SystemParams,
        prover_config: Optional[ProverConfig] = None,
        hash_scheme=None,
        device="cuda",
    ):
        self.params = params
        self.scheme = get_scheme(hash_scheme)
        self.backend = TorchBackend(params, prover_config, device=device)
        self.backend.tree_builder = self.scheme.tree_builder()

    @property
    def device(self):
        return self.backend.device

    def proving_memory_config(self):
        """The device-memory model of a prove under this engine's policy
        (peer of ``swirl/engine.py:46-57``)."""
        from .memory_metering import DIGEST_SIZE, OUTER_DIGEST_SIZE, ProvingMemoryConfig

        cfg = self.backend.config
        return ProvingMemoryConfig.from_params(
            self.params,
            cache_stacked_matrix=cfg.cache_stacked_matrix,
            cache_rs_code_matrix=cfg.cache_rs_code_matrix,
            zerocheck_save_memory=bool(cfg.zerocheck_save_memory),
            digest_size=OUTER_DIGEST_SIZE if self.scheme.digest_is_scalar else DIGEST_SIZE,
        )

    def keygen(
        self, airs: List[Air], required: Optional[List[bool]] = None
    ) -> Tuple[MultiStarkProvingKey, MultiStarkVerifyingKey]:
        builder = MultiStarkKeygenBuilder(self.params, self.backend.keygen_committer())
        if self.scheme.name != "babybear-poseidon2":
            builder.pre_hasher = self.scheme.pre_hash
        for i, air in enumerate(airs):
            if required and required[i]:
                builder.add_required_air(air)
            else:
                builder.add_air(air)
        pk = builder.generate_pk()
        return pk, pk.get_vk()

    def context_for(
        self,
        air_id: int,
        common_main,
        public_values: Optional[List[int]] = None,
        cached_mains: Optional[List[np.ndarray]] = None,
    ) -> Tuple[int, AirContext]:
        """``common_main``: (height, width) canonical host array, or a
        (width, height) int64 tensor already on the engine's device (taken
        as it is; ``SWIRL_SANITIZE=1`` range-checks it in the prover)."""
        if not isinstance(common_main, torch.Tensor):
            common_main = to_device_matrix(common_main, self.device)
        cached = [
            self.backend.commit_single(np.asarray(t, dtype=np.uint64))
            for t in (cached_mains or [])
        ]
        return (
            air_id,
            AirContext(
                cached_mains=cached,
                common_main=common_main,
                public_values=list(public_values or []),
            ),
        )

    def transport_pk(self, pk: MultiStarkProvingKey) -> DeviceMultiStarkProvingKey:
        return self.backend.transport_pk_to_device(pk)

    def prove(
        self,
        dpk: DeviceMultiStarkProvingKey,
        ctx: ProvingContext,
        transcript=None,
    ) -> Proof:
        """A fresh host transcript of the scheme by default; a
        :class:`~swirl_torch.prover.device_transcript.DeviceTranscript` on the
        engine's device keeps the sponge on it from the RAP stage through
        WHIR (the same proof bytes). The device sponge is BabyBear
        Poseidon2-16, so another scheme refuses it."""
        if isinstance(transcript, DeviceTranscript) and self.scheme.name != "babybear-poseidon2":
            raise ProverError(
                f"the device transcript is BabyBear Poseidon2-16; the {self.scheme.name} "
                "scheme proves on its host transcript"
            )
        transcript = transcript or self.scheme.new_transcript(device=self.device)
        return Coordinator(self.backend, transcript).prove(dpk, ctx)

    def verify(
        self,
        vk: MultiStarkVerifyingKey,
        proof: Proof,
        transcript: Optional[Transcript] = None,
    ) -> None:
        verify_proof(self.params, vk, proof, transcript, scheme=self.scheme)

    def debug(self, airs: List[Air], pk: MultiStarkProvingKey, ctx: ProvingContext):
        """Every constraint on every row and the bus balance, on the device."""
        check_constraints_and_interactions(airs, pk, ctx)

    def run_test(
        self,
        airs: List[Air],
        ctxs: List[Tuple[np.ndarray, List[int], List[np.ndarray]]],
        transcript: Optional[Transcript] = None,
        debug: bool = True,
    ) -> Tuple[MultiStarkVerifyingKey, Proof]:
        """keygen -> contexts -> debug check -> prove -> verify; ctxs: per
        AIR (common_main, public_values, cached_mains). ``transcript`` is
        the prover's (a recording one keeps the prover's events); the
        verifier always takes a fresh one."""
        pk, vk = self.keygen(airs)
        ctx = ProvingContext(
            [self.context_for(i, cm, pvs, cached) for i, (cm, pvs, cached) in enumerate(ctxs)]
        )
        if debug:
            self.debug(airs, pk, ctx)
        proof = self.prove(self.transport_pk(pk), ctx, transcript)
        self.verify(vk, proof)
        return vk, proof
