"""StarkEngine for the torch port: keygen, context construction, debug
check, prove and verify.

Peer of ``swirl/engine.py`` on the default BabyBear-Poseidon2 scheme with a
fresh :class:`~swirl_torch.transcript.Transcript` per proof and per
verification, unless the caller hands the prover a transcript (a device
one among them). The engine runs on the CUDA card unless the caller passes
another device (``device="cpu"`` for the tests); the debug check runs on
the traces' device, the verifier on the host (:mod:`swirl_torch.verifier`).
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

from .prover.backend import (
    AirContext,
    Coordinator,
    DeviceMultiStarkProvingKey,
    ProvingContext,
    TorchBackend,
    to_device_matrix,
)


class StarkEngine:
    def __init__(self, params: SystemParams, device="cuda"):
        self.params = params
        self.backend = TorchBackend(params, device)

    @property
    def device(self):
        return self.backend.device

    def keygen(
        self, airs: List[Air], required: Optional[List[bool]] = None
    ) -> Tuple[MultiStarkProvingKey, MultiStarkVerifyingKey]:
        builder = MultiStarkKeygenBuilder(self.params, self.backend.keygen_committer())
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
        """A fresh host :class:`Transcript` by default; a
        :class:`~swirl_torch.prover.device_transcript.DeviceTranscript` on the
        engine's device keeps the sponge on it through GKR and WHIR (the
        same proof bytes)."""
        return Coordinator(self.backend, transcript or Transcript()).prove(dpk, ctx)

    def verify(
        self,
        vk: MultiStarkVerifyingKey,
        proof: Proof,
        transcript: Optional[Transcript] = None,
    ) -> None:
        verify_proof(self.params, vk, proof, transcript)

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
