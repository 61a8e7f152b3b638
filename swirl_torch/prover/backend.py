"""Torch prover backend: device data, transport, commitment, and the proof
coordinator.

Peer of ``swirl/prover/backend.py``: ``TorchBackend`` plays ``JaxBackend``
and :class:`Coordinator` is its ``Coordinator._prove`` (:294-396). Stages:
main-trace stacked commit, RAP constraints (LogUp GKR + batch sumcheck),
stacked opening reduction, WHIR. On a
:class:`~.device_transcript.DeviceTranscript` (as ``swirl/prover/fused.py:387``
runs the Coordinator on one) the preamble is observed on a host transcript
and the sponge handed to the card once, before the RAP stage; every stage
from there to the end of WHIR runs on it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from .. import metrics
from .. import sanitize
from .. import tpoly
from ..keygen import MultiStarkProvingKey
from ..params import SystemParams
from ..proof import Proof, TraceVData
from .errors import ProverError
from ..transcript import Transcript

from ..fields import field as F
from .device_transcript import DeviceTranscript, device_view
from .logup_zerocheck import TraceProver, prove_zerocheck_and_logup
from .stacked_pcs import StackedPcsData, stacked_commit
from .stacked_reduction import prove_stacked_opening_reduction
from .whir import prove_whir_opening

# round-0 coset grids are 2^l_skip points per chunk; same bound as the
# JAX backend's
MAX_BACKEND_L_SKIP = 9


def to_device_matrix(trace: np.ndarray, device) -> torch.Tensor:
    """(height, width) canonical host trace -> (width, height) tensor."""
    return F.const_arr(np.asarray(trace, dtype=np.uint64).T, device).contiguous()


def from_device_matrix(mat: torch.Tensor) -> np.ndarray:
    """(width, height) tensor -> (height, width) canonical host trace."""
    return F.to_host(mat).T


@dataclass
class CommittedTraceData:
    commitment: np.ndarray  # digest (8,)
    trace: torch.Tensor  # (w, h)
    data: StackedPcsData


@dataclass
class AirContext:
    cached_mains: List[CommittedTraceData]
    common_main: torch.Tensor  # (w, h)
    public_values: List[int]

    @property
    def height(self) -> int:
        return int(self.common_main.shape[1])


@dataclass
class ProvingContext:
    per_trace: List[Tuple[int, AirContext]]

    def sorted_for_stacking(self) -> "ProvingContext":
        order = sorted(
            range(len(self.per_trace)),
            key=lambda i: (-self.per_trace[i][1].height, self.per_trace[i][0]),
        )
        return ProvingContext([self.per_trace[i] for i in order])


@dataclass
class DeviceStarkProvingKey:
    air_name: str
    vk: object  # StarkVerifyingKey
    preprocessed_data: Optional[CommittedTraceData]


@dataclass
class DeviceMultiStarkProvingKey:
    params: SystemParams
    per_air: List[DeviceStarkProvingKey]
    max_constraint_degree: int
    vk_pre_hash: np.ndarray


@dataclass
class ProverConfig:
    """Memory policy, peer of ``swirl/prover/backend.py:90-102`` (the
    reference's ``GpuProverConfig``, ``cuda-backend/src/device.rs:26-47``):
    dropping the stacked matrix or the RS codewords after the commit trades
    one recompute (the stacking copy, the RS encode through kernel A) for
    the two largest buffers that live through the whole prove."""

    cache_stacked_matrix: bool = True
    cache_rs_code_matrix: bool = True
    # the round-0 coset grids in 8 segments of rows, so that 1/8 of the
    # grid is live at a time; None resolves to log_blowup == 1, as the
    # reference's default (device.rs:65)
    zerocheck_save_memory: Optional[bool] = None


def _sync(device) -> None:
    """Let a stage's span cover its device work, not only its launches."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class TorchBackend:
    """Commitment and transport on one torch device."""

    def __init__(self, params: SystemParams, config: Optional[ProverConfig] = None, device="cuda"):
        if params.l_skip > MAX_BACKEND_L_SKIP:
            raise ProverError(
                f"TorchBackend requires l_skip <= {MAX_BACKEND_L_SKIP}, got {params.l_skip}"
            )
        self.params = params
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise ProverError(
                "TorchBackend: no CUDA device is available; pass device='cpu' "
                "to prove on the CPU"
            )
        self.config = config or ProverConfig()
        if self.config.zerocheck_save_memory is None:
            self.config.zerocheck_save_memory = params.log_blowup == 1
        # hash-scheme hook (``swirl_torch/hash/scheme.py``): None = the
        # Poseidon2 kernels' Merkle trees; the BN254 outer scheme installs
        # its device tree builder
        self.tree_builder = None

    def commit_traces(self, traces: List[torch.Tensor]):
        p, c = self.params, self.config
        return stacked_commit(
            p.l_skip, p.n_stack, p.log_blowup, p.k_whir, traces,
            cache_stacked_matrix=c.cache_stacked_matrix,
            cache_rs_code_matrix=c.cache_rs_code_matrix,
            tree_builder=self.tree_builder,
        )

    def commit_single(self, trace_host: np.ndarray) -> CommittedTraceData:
        dev = to_device_matrix(trace_host, self.device)
        commit, data = self.commit_traces([dev])
        return CommittedTraceData(commitment=commit, trace=dev, data=data)

    def transport_pk_to_device(self, mpk: MultiStarkProvingKey) -> DeviceMultiStarkProvingKey:
        return DeviceMultiStarkProvingKey(
            params=mpk.params,
            per_air=[
                DeviceStarkProvingKey(
                    air_name=pk.air_name, vk=pk.vk, preprocessed_data=pk.preprocessed_data
                )
                for pk in mpk.per_air
            ],
            max_constraint_degree=mpk.max_constraint_degree,
            vk_pre_hash=mpk.vk_pre_hash,
        )

    def keygen_committer(self):
        """Committer callable for :class:`~swirl_torch.keygen.MultiStarkKeygenBuilder`."""

        def commit(trace_host: np.ndarray):
            ctd = self.commit_single(trace_host)
            return ctd.commitment, ctd, ctd.data.layout.width

        return commit


class Coordinator:
    """Drives the full prove flow on a host :class:`Transcript` or a
    :class:`DeviceTranscript` on the backend's device."""

    def __init__(self, backend: TorchBackend, transcript):
        self.backend = backend
        self.transcript = transcript

    def commit_and_observe(self, mpk: DeviceMultiStarkProvingKey, ctx: ProvingContext, transcript=None):
        """The main-trace stacked commit and the transcript's preamble, on
        the sorted context, observed into ``transcript`` (a host one; by
        default the coordinator's). Returns (common_commit, common_data,
        trace_vdata, public_values)."""
        transcript = self.transcript if transcript is None else transcript
        device = self.backend.device
        transcript.observe_commit(mpk.vk_pre_hash)

        common_traces = [tc.common_main for _, tc in ctx.per_trace]
        sanitize.check_traces(common_traces, "common_main")
        with metrics.span("prover.main_trace_commit"):
            common_commit, common_data = self.backend.commit_traces(common_traces)
            _sync(device)
        if common_data.matrix is not None:
            sanitize.check_canonical(common_data.matrix, "stacked_matrix")

        trace_vdata, public_values = proof_metadata(mpk, ctx)
        observe_preamble(transcript, mpk, common_commit, trace_vdata, public_values)
        return common_commit, common_data, trace_vdata, public_values

    def prove(self, mpk: DeviceMultiStarkProvingKey, unsorted_ctx: ProvingContext) -> Proof:
        with metrics.span("stark_prove_excluding_trace"):
            proof = self._prove(mpk, unsorted_ctx)
            _sync(self.backend.device)
        return proof

    def _prove(self, mpk: DeviceMultiStarkProvingKey, unsorted_ctx: ProvingContext) -> Proof:
        params = mpk.params
        device = self.backend.device
        # a device transcript takes the sponge once, after the preamble,
        # which is observed on a host transcript at its state; every stage
        # from the RAP stage to the end of WHIR then runs on it
        on_card, transcript = None, self.transcript
        if isinstance(transcript, DeviceTranscript):
            on_card = device_view(transcript, device)  # refuses another device
            transcript = on_card.to_host()
        ctx = unsorted_ctx.sorted_for_stacking()
        common_commit, common_data, trace_vdata, public_values = self.commit_and_observe(
            mpk, ctx, transcript
        )
        if on_card is not None:
            on_card.load(transcript)
        tr = device_view(transcript if on_card is None else on_card, device)

        # stage: RAP constraints (GKR + batch sumcheck)
        traces = trace_provers(mpk, ctx)
        with metrics.span("prove_rap_constraints"):
            gkr_proof, batch_proof, r = prove_zerocheck_and_logup(
                tr, params, mpk.max_constraint_degree, traces,
                save_memory=bool(self.backend.config.zerocheck_save_memory),
            )

        # stage: openings (stacked reduction + WHIR)
        datas, need_rot_per_commit = stacked_per_commit(mpk, ctx, common_data)

        with metrics.span("prove_stacked_reduction"):
            stacking_proof, u = prove_stacked_opening_reduction(
                tr, params, datas, need_rot_per_commit, r
            )

        # u_cube: the prism coordinate u0 replaced by its l_skip squarings
        u_cube = torch.stack(tpoly.squares(u[0], params.l_skip) + list(u[1:]))

        with metrics.span("prove_whir"):
            whir_proof = prove_whir_opening(
                tr, params, datas, u_cube, tree_builder=self.backend.tree_builder
            )

        return Proof(
            common_main_commit=common_commit,
            trace_vdata=trace_vdata,
            public_values=public_values,
            gkr_proof=gkr_proof,
            batch_constraint_proof=batch_proof,
            stacking_proof=stacking_proof,
            whir_proof=whir_proof,
        )


def proof_metadata(mpk: DeviceMultiStarkProvingKey, ctx: ProvingContext):
    """(trace_vdata, public_values) of the proof, one entry an AIR (None and
    [] for an AIR without a trace in ``ctx``)."""
    num_airs = len(mpk.per_air)
    trace_vdata: List[Optional[TraceVData]] = [None] * num_airs
    public_values: List[List[int]] = [[] for _ in range(num_airs)]
    for air_id, tc in ctx.per_trace:
        trace_vdata[air_id] = TraceVData(
            log_height=tc.height.bit_length() - 1,
            cached_commitments=[cd.commitment for cd in tc.cached_mains],
        )
        public_values[air_id] = list(tc.public_values)
    return trace_vdata, public_values


def observe_preamble(transcript, mpk: DeviceMultiStarkProvingKey, common_commit, trace_vdata, public_values) -> None:
    """The transcript's events after ``vk_pre_hash`` and the commit: the
    common root (a host or a device digest), then per AIR its presence
    (when not required), its preprocessed root or log height, its cached
    roots and its public values."""
    transcript.observe_commit(common_commit)
    for air_id, pk in enumerate(mpk.per_air):
        vdata = trace_vdata[air_id]
        if not pk.vk.is_required:
            transcript.observe(1 if vdata is not None else 0)
        if vdata is not None:
            if pk.preprocessed_data is not None:
                transcript.observe_commit(pk.preprocessed_data.commitment)
            else:
                transcript.observe(vdata.log_height)
            for c in vdata.cached_commitments:
                transcript.observe_commit(c)
        for pv in public_values[air_id]:
            transcript.observe(pv)


def stacked_per_commit(mpk: DeviceMultiStarkProvingKey, ctx: ProvingContext, common_data: StackedPcsData):
    """The openings' commitments in proof order, the common one first, then
    each trace's preprocessed and cached ones, and their need_rot flags."""
    datas: List[StackedPcsData] = [common_data]
    need_rot: List[List[bool]] = [[mpk.per_air[air_id].vk.params.need_rot for air_id, _ in ctx.per_trace]]
    for air_id, tc in ctx.per_trace:
        pk = mpk.per_air[air_id]
        rot = pk.vk.params.need_rot
        if pk.preprocessed_data is not None:
            datas.append(pk.preprocessed_data.data)
            need_rot.append([rot])
        for cd in tc.cached_mains:
            datas.append(cd.data)
            need_rot.append([rot])
    return datas, need_rot


def trace_provers(mpk: DeviceMultiStarkProvingKey, ctx: ProvingContext) -> List[TraceProver]:
    """The RAP stage's per-trace inputs, in the sorted context's order."""
    traces = []
    for air_id, tc in ctx.per_trace:
        pk = mpk.per_air[air_id]
        vk = pk.vk
        traces.append(
            TraceProver(
                air_id=air_id,
                dag=vk.symbolic_constraints,
                needs_next=vk.params.need_rot,
                d_air=vk.max_constraint_degree,
                public_values=list(tc.public_values),
                height=tc.height,
                n=tc.height.bit_length() - 1 - mpk.params.l_skip,
                preprocessed=(
                    pk.preprocessed_data.trace if pk.preprocessed_data is not None else None
                ),
                cached=[cd.trace for cd in tc.cached_mains],
                common=tc.common_main,
            )
        )
    return traces
