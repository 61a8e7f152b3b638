"""Multi-field hasher + transcript: BabyBear data, BN254 Poseidon2 sponge (the
port's copy of ``swirl/hash/multi_field.py``).

Bit-exact peer of the reference's outer-recursion hashing tier:

- ``MultiFieldHasher`` (``crates/stark-backend/src/hasher.rs:87-137``):
  packs BabyBear felts into BN254 scalars at base ``2^31`` (little-endian
  Horner, 8 felts per scalar — ``multi_field_packing.rs:31-39``) and hashes
  with the width-3 permutation; per 16-felt block the two packed scalars
  OVERWRITE state lanes 0/1, then one permutation. Digest = state[0].
- ``MultiFieldTranscript`` (``transcript/multi_field.rs:25-180``): a BN254
  duplex sponge (width 3, rate 2, overwrite mode — the same state machine as
  ``duplex_sponge.rs:16``) that buffers BabyBear observes 8-at-a-time into
  packed scalars and expands each squeezed scalar into 5 base-p digits
  (LSB-first, ``extract_samples`` / ``compute_num_samples_per_elem`` with
  BIAS_BITS=100).

Digests are a single BN254 scalar (vs ``[BabyBear; 8]`` in the inner
scheme), which is what makes the outer proof cheap to verify in a BN254
SNARK circuit. The sponge is host-side Python ints (a few permutations a
round); the proof-of-work search of a transcript made with a ``device``
runs there (kernel J on the card, ``bn254_poseidon2.grind_ints``, its operands by value), and the host
applies the witness it returns.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from ..fields.babybear import P
from .bn254_poseidon2 import P_BN254, compress2, permute

FELTS_PER_SCALAR = 8  # floor(254 / 31); 2^248 < P_BN254 keeps packing injective
FELT_BITS = 31
SAMPLES_PER_SCALAR = 5  # largest k with p^k * 2^98 <= P_BN254 (BIAS_BITS=100)
EF_D = 4

RATE = 2
WIDTH = 3
BABY_BEAR_RATE = 16  # sponge rate in felts: RATE * FELTS_PER_SCALAR


def pack_felts(vals: Sequence[int]) -> List[int]:
    """BabyBear felts -> BN254 scalars, 8 felts little-endian per scalar."""
    out = []
    for i in range(0, len(vals), FELTS_PER_SCALAR):
        acc = 0
        for j, v in enumerate(vals[i : i + FELTS_PER_SCALAR]):
            acc |= (int(v) % P) << (FELT_BITS * j)
        out.append(acc)
    return out


class MultiFieldHasher:
    """Merkle hashing of BabyBear data with BN254 digests."""

    @staticmethod
    def hash_slice(vals) -> int:
        """`MultiFieldHasher::hash_iter` (hasher.rs:119-136): per 16-felt
        block, overwrite state[i] with packed scalar i, then permute."""
        flat = [int(v) for v in np.asarray(vals, dtype=np.uint64).ravel()]
        state = [0] * WIDTH
        for i in range(0, len(flat), BABY_BEAR_RATE):
            block = flat[i : i + BABY_BEAR_RATE]
            for chunk_id, packed in enumerate(pack_felts(block)):
                state[chunk_id] = packed
            state = permute(state, WIDTH)
        return state[0]

    @staticmethod
    def compress(left: int, right: int) -> int:
        return compress2(left, right)

    @classmethod
    def merkle_root(cls, rows: Sequence[Sequence[int]]) -> int:
        """Root over leaf rows (power-of-two count)."""
        layer = [cls.hash_slice(r) for r in rows]
        assert layer and (len(layer) & (len(layer) - 1)) == 0
        while len(layer) > 1:
            layer = [
                cls.compress(layer[2 * i], layer[2 * i + 1])
                for i in range(len(layer) // 2)
            ]
        return layer[0]


class _Bn254DuplexSponge:
    """Overwrite-mode duplex sponge over BN254, width 3 / rate 2 — the exact
    state machine of ``transcript/duplex_sponge.rs:16-84``."""

    __slots__ = ("state", "absorb_idx", "sample_idx")

    def __init__(self):
        self.state = [0] * WIDTH
        self.absorb_idx = 0
        self.sample_idx = 0

    def absorb(self, value: int) -> None:
        self.state[self.absorb_idx] = value % P_BN254
        self.absorb_idx += 1
        if self.absorb_idx == RATE:
            self.state = permute(self.state, WIDTH)
            self.absorb_idx = 0
            self.sample_idx = RATE

    def squeeze(self) -> int:
        if self.absorb_idx != 0 or self.sample_idx == 0:
            self.state = permute(self.state, WIDTH)
            self.absorb_idx = 0
            self.sample_idx = RATE
        self.sample_idx -= 1
        return self.state[self.sample_idx]


class MultiFieldTranscript:
    """Duplex-sponge Fiat-Shamir over BN254 absorbing/squeezing BabyBear.

    Same observable API as :class:`swirl_torch.transcript.Transcript` so the
    prover/verifier pipeline can run under the outer hash scheme unchanged:
    observe/observe_slice/observe_ext/observe_commit, sample/sample_ext/
    sample_bits, check_witness/grind.
    """

    __slots__ = ("_sponge", "_obs_buf", "_samples", "log", "_record", "_device")

    def __init__(self, record: bool = False, device=None):
        self._sponge = _Bn254DuplexSponge()
        self._obs_buf: List[int] = []  # pending BabyBear felts (< 8)
        self._samples: List[int] = []  # buffered digits, pop() returns next
        self._record = record
        self.log = [] if record else None
        # where grind searches (None: the host loop)
        self._device = None if device is None else torch.device(device)

    def clone(self) -> "MultiFieldTranscript":
        t = MultiFieldTranscript()
        t._sponge.state = list(self._sponge.state)
        t._sponge.absorb_idx = self._sponge.absorb_idx
        t._sponge.sample_idx = self._sponge.sample_idx
        t._obs_buf = list(self._obs_buf)
        t._samples = list(self._samples)
        return t

    # -- absorb ------------------------------------------------------------

    def observe(self, value) -> None:
        v = int(value) % P
        if self._record:
            self.log.append(("observe", v))
        self._samples.clear()
        self._obs_buf.append(v)
        if len(self._obs_buf) == FELTS_PER_SCALAR:
            self._sponge.absorb(pack_felts(self._obs_buf)[0])
            self._obs_buf.clear()

    def observe_slice(self, values) -> None:
        for v in np.asarray(values, dtype=np.uint64).ravel():
            self.observe(int(v))

    def observe_ext(self, value) -> None:
        v = np.asarray(value, dtype=np.uint64).ravel()
        assert v.shape[0] == EF_D
        self.observe_slice(v)

    def observe_commit(self, digest) -> None:
        """Observe a BN254 digest (int): `absorb_slice` semantics —
        invalidate samples, flush pending observes, absorb directly."""
        assert isinstance(digest, (int, np.integer)), "outer digests are scalars"
        if self._record:
            self.log.append(("observe", int(digest)))
        self._samples.clear()
        self._flush()
        self._sponge.absorb(int(digest))

    def _flush(self) -> None:
        if self._obs_buf:
            self._sponge.absorb(pack_felts(self._obs_buf)[0])
            self._obs_buf.clear()

    # -- squeeze -----------------------------------------------------------

    def sample(self) -> int:
        if not self._samples:
            self._flush()
            x = self._sponge.squeeze()
            # extract_samples: k base-p digits, LSB-first; reversed so that
            # pop() yields b_0 first (transcript/multi_field.rs:122-131).
            digits = []
            for _ in range(SAMPLES_PER_SCALAR):
                digits.append(x % P)
                x //= P
            self._samples = list(reversed(digits))
        v = self._samples.pop()
        if self._record:
            self.log.append(("sample", v))
        return v

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

    def grind(self, bits: int) -> int:
        assert 0 <= bits < 32 and (1 << bits) < P
        if bits == 0:
            assert self.check_witness(bits, 0)
            return 0
        if self._device is not None:
            return self._grind_on_device(bits)
        w = 0
        while True:
            probe = self.clone()  # probes never record/validate events
            if probe.check_witness(bits, w):
                ok = self.check_witness(bits, w)
                assert ok
                return w
            w += 1

    def _grind_on_device(self, bits: int) -> int:
        """The host loop's witness, searched on the transcript's device from
        its sponge state and pending felts, then observed and checked here
        (so the record and a validator see the host loop's events)."""
        from .bn254_poseidon2 import grind_ints

        pending = pack_felts(self._obs_buf)[0] if self._obs_buf else 0
        w = grind_ints(self._sponge.state, pending, self._sponge.absorb_idx, FELT_BITS * len(self._obs_buf), bits,
                       device=self._device)
        if w < 0 or not self.check_witness(bits, w):
            raise RuntimeError(f"failed to find PoW witness ({bits} bits): the search returned {w}")
        return w


class MultiFieldTranscriptValidator(MultiFieldTranscript):
    """Replays a recorded outer-transcript log, failing on the first
    divergence — the BN254 peer of
    the BabyBear transcript's validator (reference
    ``DuplexSpongeValidator`` precedent). Commit digests are validated as
    full BN254 scalars; felts and sampled digits as BabyBear values."""

    __slots__ = ("_expected", "_pos")

    def __init__(self, log):
        super().__init__()
        self._expected = list(log)
        self._pos = 0

    def _next(self, kind: str, value: int) -> None:
        from ..transcript import TranscriptDivergence

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

    def observe_commit(self, digest) -> None:
        self._next("observe", int(digest))
        super().observe_commit(digest)

    def sample(self) -> int:
        v = super().sample()
        self._next("sample", v)
        return v

    def finish(self) -> None:
        from ..transcript import TranscriptDivergence

        if self._pos != len(self._expected):
            raise TranscriptDivergence(
                f"transcript log not fully consumed: {self._pos} of "
                f"{len(self._expected)} events replayed"
            )
