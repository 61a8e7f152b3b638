"""Fiat-Shamir transcript: duplex sponge in overwrite mode (host-side).

Semantics mirror the reference transcript exactly so the prover and verifier
stay in lock-step (``crates/stark-backend/src/transcript/duplex_sponge.rs:16``
and ``transcript/traits.rs:11``):

- ``observe`` overwrites ``state[absorb_idx]``; on filling RATE lanes the
  state is permuted and ``sample_idx`` resets to RATE.
- ``sample`` permutes iff there are pending absorbs or no squeezable lanes
  remain, then returns ``state[--sample_idx]``.
- ``sample_bits(b)`` masks the canonical sample to ``b`` low bits.
- ``check_witness``/``grind`` implement the proof-of-work gate.

The transcript is deterministic host state (numpy); devices return claims to
the host at round boundaries (same shape as the CUDA backend's device/host
sponge sync). Grinding is vectorized over candidate batches.
"""

from __future__ import annotations

import numpy as np

from .fields.babybear import P
from .hash.poseidon2 import DIGEST, RATE, WIDTH, permute_np

EF_D = 4


class TranscriptDivergence(AssertionError):
    """A replayed transcript event differed from the recorded log."""


class Transcript:
    """Duplex sponge transcript over BabyBear with Poseidon2-16."""

    __slots__ = ("state", "absorb_idx", "sample_idx", "log", "_record")

    def __init__(self, record: bool = False):
        self.state = np.zeros(WIDTH, dtype=np.uint64)
        self.absorb_idx = 0
        self.sample_idx = 0
        self._record = record
        self.log = [] if record else None

    def clone(self) -> "Transcript":
        t = Transcript()
        t.state = self.state.copy()
        t.absorb_idx = self.absorb_idx
        t.sample_idx = self.sample_idx
        return t

    # -- core duplex ops ---------------------------------------------------

    def observe(self, value) -> None:
        v = int(value) % P
        if self._record:
            self.log.append(("observe", v))
        self.state[self.absorb_idx] = v
        self.absorb_idx += 1
        if self.absorb_idx == RATE:
            self.state = permute_np(self.state)
            self.absorb_idx = 0
            self.sample_idx = RATE

    def sample(self) -> int:
        if self.absorb_idx != 0 or self.sample_idx == 0:
            self.state = permute_np(self.state)
            self.absorb_idx = 0
            self.sample_idx = RATE
        self.sample_idx -= 1
        v = int(self.state[self.sample_idx])
        if self._record:
            self.log.append(("sample", v))
        return v

    # -- derived ops -------------------------------------------------------

    def observe_slice(self, values) -> None:
        for v in np.asarray(values, dtype=np.uint64).ravel():
            self.observe(int(v))

    def observe_commit(self, digest) -> None:
        digest = np.asarray(digest, dtype=np.uint64).ravel()
        assert digest.shape[0] == DIGEST
        self.observe_slice(digest)

    def observe_ext(self, value) -> None:
        v = np.asarray(value, dtype=np.uint64).ravel()
        assert v.shape[0] == EF_D
        self.observe_slice(v)

    def sample_ext(self) -> np.ndarray:
        return np.array([self.sample() for _ in range(EF_D)], dtype=np.uint64)

    def sample_bits(self, bits: int) -> int:
        assert 0 <= bits < 32 and (1 << bits) < P
        return self.sample() & ((1 << bits) - 1)

    # -- proof of work -----------------------------------------------------

    def check_witness(self, bits: int, witness) -> bool:
        if bits == 0:
            return True
        self.observe(witness)
        return self.sample_bits(bits) == 0

    def grind(self, bits: int, batch: int = 4096) -> int:
        """Find w with check_witness(bits, w); observes it into self.

        Vectorized brute force: simulates observe(w)+sample_bits(bits) for a
        batch of candidate witnesses at once against a snapshot of the state.
        """
        assert 0 <= bits < 32 and (1 << bits) < P
        if bits == 0:
            self_check = self.check_witness(bits, 0)
            assert self_check
            return 0
        mask = (1 << bits) - 1
        start = 0
        while start < P:
            n = min(batch, P - start)
            cand = np.arange(start, start + n, dtype=np.uint64)
            states = np.broadcast_to(self.state, (n, WIDTH)).copy()
            # observe(w): state[absorb_idx] = w
            states[:, self.absorb_idx] = cand
            a_idx = self.absorb_idx + 1
            s_idx = self.sample_idx
            if a_idx == RATE:
                states = permute_np(states)
                a_idx, s_idx = 0, RATE
            # sample(): permute if pending absorbs or drained
            if a_idx != 0 or s_idx == 0:
                states = permute_np(states)
                s_idx = RATE
            s_idx -= 1
            hits = np.nonzero((states[:, s_idx] & mask) == 0)[0]
            if hits.size:
                w = int(cand[hits[0]])
                ok = self.check_witness(bits, w)
                assert ok
                return w
            start += n
        raise RuntimeError("failed to find PoW witness")


def observe_ext_np(transcript: Transcript, arr: np.ndarray) -> None:
    """Observe a (..., 4) array of EF values in row-major order."""
    flat = np.asarray(arr, dtype=np.uint64).reshape(-1, EF_D)
    for row in flat:
        transcript.observe_ext(row)


class TranscriptValidator(Transcript):
    """Replays a recorded transcript log, failing on the first divergence.

    Peer of the reference's ``DuplexSpongeValidator``
    (``transcript/duplex_sponge.rs:196``): record the prover's transcript
    with ``Transcript(record=True)``, then run the verifier against a
    validator built from that log — any mismatch in the observe/sample
    event stream (the classic source of prover/verifier drift) surfaces as
    a :class:`TranscriptDivergence` at the exact offending event instead of
    a final proof rejection.
    """

    __slots__ = ("_expected", "_pos")

    def __init__(self, log):
        super().__init__()
        self._expected = list(log)
        self._pos = 0

    def _next(self, kind: str, value: int):
        if self._pos >= len(self._expected):
            raise TranscriptDivergence(
                f"transcript log exhausted at event {self._pos}: "
                f"replay produced ({kind}, {value})"
            )
        exp_kind, exp_value = self._expected[self._pos]
        if (exp_kind, exp_value) != (kind, value):
            raise TranscriptDivergence(
                f"transcript divergence at event {self._pos}: recorded "
                f"({exp_kind}, {exp_value}), replay ({kind}, {value})"
            )
        self._pos += 1

    def observe(self, value) -> None:
        v = int(value) % P
        self._next("observe", v)
        super().observe(v)

    def sample(self) -> int:
        v = super().sample()
        self._next("sample", v)
        return v

    def finish(self) -> None:
        """Assert the full log was consumed."""
        if self._pos != len(self._expected):
            raise TranscriptDivergence(
                f"replay consumed {self._pos} of {len(self._expected)} "
                "recorded transcript events"
            )
