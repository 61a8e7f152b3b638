"""A stage's share of the proof, left on the device until one copy.

Each stage of the prover computes its proof values on the device and says
how to build its proof part from their host copies: a :class:`Deferred`.
``Coordinator.prove`` fetches each stage's values at the stage's end (one
copy a stage); ``prover/fused.py`` joins every stage's values, packs them
into one flat tensor and fetches the whole proof once, as the JAX
package's ``_pack`` / ``_unpack`` / ``_rebuild_proof`` do
(``swirl/prover/fused.py:442-460``, :69-146). Checks that need a value on
the host (a zero LogUp sum, a witness that was found) run in the build, so
on the fused path they run after the fetch.
"""

from __future__ import annotations

from typing import Callable, List, Sequence

from ..fields import field as F


class Deferred:
    """``values``: tensors on the device and host values; ``build(host)``
    makes the proof part from their host copies, in the same order."""

    __slots__ = ("values", "build")

    def __init__(self, values: Sequence, build: Callable[[List], object]):
        self.values = list(values)
        self.build = build

    def fetched(self) -> "Deferred":
        """The same part with its values copied to the host now (one read)."""
        return Deferred(F.to_host_all(self.values), self.build)

    def fetch(self):
        """The proof part: one copy of the values, then the build."""
        return self.build(F.to_host_all(self.values))

    @staticmethod
    def join(parts: Sequence["Deferred"]) -> "Deferred":
        """One part of several: its values theirs in order, its build a list
        of their builds' results."""
        parts = list(parts)
        builds = [(p.build, len(p.values)) for p in parts]

        def build(host):
            out, off = [], 0
            for b, n in builds:
                out.append(b(host[off : off + n]))
                off += n
            return out

        return Deferred([v for p in parts for v in p.values], build)
