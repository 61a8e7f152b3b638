"""StarkEngine for the torch port: keygen, context construction, prove.

Peer of ``swirl/engine.py`` on the default BabyBear-Poseidon2 scheme with a
fresh :class:`~swirl_torch.transcript.Transcript` per proof. The engine
runs on the CUDA card unless the caller passes another device
(``device="cpu"`` for the tests). The port has no verifier yet: a proof is
checked by encoding it with :mod:`swirl_torch.codec` and verifying the
bytes with the JAX package's verifier.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from .air import Air
from .keygen import MultiStarkKeygenBuilder, MultiStarkProvingKey, MultiStarkVerifyingKey
from .params import SystemParams
from .proof import Proof
from .transcript import Transcript

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
        (width, height) int64 tensor already on the engine's device."""
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
        transcript: Optional[Transcript] = None,
    ) -> Proof:
        return Coordinator(self.backend, transcript or Transcript()).prove(dpk, ctx)

    def run_test(
        self,
        airs: List[Air],
        ctxs: List[Tuple[np.ndarray, List[int], List[np.ndarray]]],
        transcript: Optional[Transcript] = None,
    ) -> Tuple[MultiStarkVerifyingKey, Proof]:
        """keygen -> contexts -> prove; ctxs: per AIR (common_main,
        public_values, cached_mains). Returns (vk, proof) unverified."""
        pk, vk = self.keygen(airs)
        ctx = ProvingContext(
            [self.context_for(i, cm, pvs, cached) for i, (cm, pvs, cached) in enumerate(ctxs)]
        )
        return vk, self.prove(self.transport_pk(pk), ctx, transcript)
