"""The Fiat-Shamir transcript on the card: the duplex sponge's state stays a
device tensor, so a stage can absorb its device values and use its device
challenges without reading anything back to the host.

Peer of ``swirl/prover/device_transcript.py``. It mirrors
:class:`swirl_torch.transcript.Transcript` event for event (overwrite
duplex, Poseidon2-16, the same grind scan order), so a proof made on it is
byte-identical to one made on the host transcript. The state is a (16,)
canonical int64 tensor; ``absorb_idx`` and ``sample_idx`` are Python ints,
since the event schedule is static given the proof's shape. Every sponge
event runs through kernel E (``p2.duplex``), the proof-of-work search
through kernel F (``p2.grind``); on a CPU tensor both take their plain
PyTorch versions.

Observes are buffered and absorbed by the next launch: device values as
they are, host values (ints, numpy) by value in the launch's arguments;
each returns the value it observed, which is what a stage keeps for its
proof. Samples return device tensors. The prover observes its preamble on
a host transcript and hands the sponge over once (:meth:`load`), before
the RAP stage; from there to the end of WHIR every stage runs on this
transcript, as the reference's CUDA backend keeps its sponge on the device
(``cuda-backend/src/sponge.rs``). :func:`device_view` gives a stage the
same interface over a host transcript.
"""

from __future__ import annotations

import numpy as np
import torch

from ..fields import field as F
from ..fields.babybear import P
from ..hash import poseidon2 as p2
from ..hash.poseidon2 import DIGEST, RATE, WIDTH
from ..transcript import Transcript
from .errors import ProverError

EF_D = 4


def _device(device) -> torch.device:
    """``device`` with its index: "cuda" names the current card."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None and torch.cuda.is_available():
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def cursors_after(a: int, s: int, k: int, n_squeeze: int):
    """The (absorb_idx, sample_idx) after absorbing k felts from (a, s) and
    then squeezing n_squeeze values: the host's share of a duplex launch."""
    if k:
        if (a + k) // RATE:
            s = RATE
        a = (a + k) % RATE
    for _ in range(n_squeeze):
        if a != 0 or s == 0:
            a, s = 0, RATE
        s -= 1
    return a, s


def duplex_absorb_sample_ext(state, flat):
    """From ``absorb_idx == 0``: absorb the (k,) device felts ``flat``, k > 0,
    then squeeze one EF challenge, in one launch. Returns ``(state, r)``
    (the state updated in place). The exit cursors are (0, RATE - EF_D) for
    any k, which makes a sumcheck round's events the same in every round."""
    if flat.numel() == 0:
        raise ValueError("duplex_absorb_sample_ext: nothing to absorb")
    return state, p2.duplex(state, flat.reshape(-1), [], 0, RATE, EF_D)


class DeviceTranscript:
    """Duplex sponge transcript over BabyBear with Poseidon2-16, on ``device``."""

    __slots__ = ("state", "absorb_idx", "sample_idx", "device", "_pieces", "_host")

    def __init__(self, device="cuda"):
        self.device = _device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise ProverError(
                "DeviceTranscript: no CUDA device is available; pass device='cpu' "
                "to run it on the CPU"
            )
        self.state = torch.zeros(WIDTH, dtype=F.DTYPE, device=self.device)
        # the cursors of ``state``; buffered felts are not yet in either
        self.absorb_idx = 0
        self.sample_idx = 0
        self._pieces = []  # device felts, in order
        self._host = []  # host felts, after the pieces

    # -- handoff to and from the host transcript -----------------------------

    @classmethod
    def from_host(cls, t: Transcript, device="cuda") -> "DeviceTranscript":
        dt = cls(device)
        dt.load(t)
        return dt

    def load(self, t: Transcript) -> None:
        """Take the host transcript's state and cursors (16 words, 2 ints)."""
        self.state = F.const_arr(t.state, self.device)
        self.absorb_idx, self.sample_idx = t.absorb_idx, t.sample_idx
        self._pieces, self._host = [], []

    def save(self):
        """(state, absorb_idx, sample_idx) with every buffered felt
        absorbed: what one segment of the fused prover hands the next
        (``swirl/prover/fused.py:523-530``, ``save_cursor``)."""
        self._flush()
        return self.state, self.absorb_idx, self.sample_idx

    @classmethod
    def restore(cls, state, absorb_idx: int, sample_idx: int) -> "DeviceTranscript":
        """A transcript that goes on from :meth:`save`'s result, on the same
        state tensor (``restore_transcript``)."""
        t = cls.__new__(cls)
        t.device, t.state = state.device, state
        t.absorb_idx, t.sample_idx = absorb_idx, sample_idx
        t._pieces, t._host = [], []
        return t

    def to_host(self) -> Transcript:
        """A host transcript at this one's state (one read of 16 words)."""
        self._flush()
        t = Transcript()
        t.state = F.to_host(self.state)
        t.absorb_idx, t.sample_idx = self.absorb_idx, self.sample_idx
        return t

    # -- the launches ---------------------------------------------------------

    def _launch(self, n_squeeze: int, bits: int = -1):
        pieces = self._pieces
        absorb = None if not pieces else pieces[0] if len(pieces) == 1 else torch.cat(pieces)
        k = (0 if absorb is None else absorb.shape[0]) + len(self._host)
        out = p2.duplex(
            self.state, absorb, self._host, self.absorb_idx, self.sample_idx, n_squeeze, bits
        )
        self.absorb_idx, self.sample_idx = cursors_after(
            self.absorb_idx, self.sample_idx, k, n_squeeze
        )
        self._pieces, self._host = [], []
        return out

    def _flush(self) -> None:
        if self._pieces or self._host:
            self._launch(0)

    def _observe_device(self, t) -> None:
        if t.device != self.device:
            raise ValueError(f"DeviceTranscript on {self.device} observes a tensor on {t.device}")
        if self._host:  # keep the order: the host felts go after the pieces
            self._flush()
        if t.numel():
            self._pieces.append(t.contiguous().reshape(-1))

    def _observe_host(self, v) -> None:
        self._host.append(int(v) % P)
        if len(self._host) == p2.HOST_MAX:
            self._flush()

    # -- the transcript's events ----------------------------------------------

    def observe(self, value) -> None:
        if isinstance(value, torch.Tensor):
            if value.numel() != 1:
                raise ValueError(f"observe takes one felt, got {tuple(value.shape)}")
            self._observe_device(value)
        else:
            self._observe_host(value)

    def observe_slice(self, values):
        """Observes the felts of a tensor or of host values and returns them
        as given: what a stage keeps for its proof."""
        if isinstance(values, torch.Tensor):
            self._observe_device(values)
        else:
            for v in np.asarray(values, dtype=np.uint64).ravel():
                self._observe_host(v)
        return values

    def _observe_sized(self, value, n: int, what: str):
        size = value.numel() if isinstance(value, torch.Tensor) else np.asarray(value).size
        if size != n:
            raise ValueError(f"{what} takes {n} felts, got {size}")
        return self.observe_slice(value)

    def observe_commit(self, digest):
        return self._observe_sized(digest, DIGEST, "observe_commit")

    def observe_ext(self, value):
        return self._observe_sized(value, EF_D, "observe_ext")

    def sample(self):
        return self._launch(1)[0]

    def sample_ext(self):
        return self._launch(EF_D)

    def sample_bits(self, bits: int):
        return self.sample_bits_batch(bits, 1)[0]

    def sample_bits_batch(self, bits: int, n: int):
        """``n`` consecutive :meth:`sample_bits` in one launch: an (n,) tensor."""
        if not (0 <= bits < 32 and (1 << bits) < P):
            raise ValueError(f"sample_bits: {bits} bits")
        return self._launch(n, bits)

    # -- proof of work ----------------------------------------------------------

    def check_witness(self, bits: int, witness) -> None:
        """The witness's state advance; its validity is the verifier's check."""
        if bits == 0:
            return
        self.observe(witness)
        self.sample_bits(bits)

    def grind(self, bits: int):
        """The smallest witness (kernel F), observed and checked on the card:
        a 0-d tensor, -1 if none exists (the prover refuses it at its fetch)."""
        if not (0 <= bits < 32 and (1 << bits) < P):
            raise ValueError(f"grind: {bits} bits")
        if bits == 0:
            return torch.zeros((), dtype=F.DTYPE, device=self.device)
        self._flush()
        w = p2.grind(self.state, self.absorb_idx, bits)
        self.absorb_idx, self.sample_idx = 0, RATE - 1
        return w


class _HostView:
    """A host transcript behind the device transcript's interface: device
    values are read to the host before they are observed (and the host
    copies returned, for the proof), challenges come back as tensors on
    ``device``, witnesses as ints."""

    __slots__ = ("t", "device")

    def __init__(self, t: Transcript, device):
        self.t = t
        self.device = device

    @staticmethod
    def _host(v):
        return F.to_host(v) if isinstance(v, torch.Tensor) else v

    def observe_slice(self, values):
        values = self._host(values)
        self.t.observe_slice(values)
        return values

    def observe_ext(self, value):
        value = self._host(value)
        self.t.observe_ext(value)
        return value

    def observe_commit(self, digest):
        digest = self._host(digest)
        self.t.observe_commit(digest)
        return digest

    def sample_ext(self):
        return F.const_arr(self.t.sample_ext(), self.device)

    def sample_bits_batch(self, bits: int, n: int):
        return F.const_arr([self.t.sample_bits(bits) for _ in range(n)], self.device).reshape(n)

    def grind(self, bits: int) -> int:
        return self.t.grind(bits)


def device_view(transcript, device):
    """The transcript as a stage that keeps its values on ``device`` uses it:
    a :class:`DeviceTranscript` (or a view already) as it is, a host one
    behind :class:`_HostView`."""
    if isinstance(transcript, _HostView):
        return transcript
    if isinstance(transcript, DeviceTranscript):
        if transcript.device != _device(device):
            raise ProverError(
                f"the transcript is on {transcript.device}, the prover's data on {device}"
            )
        return transcript
    return _HostView(transcript, device)
