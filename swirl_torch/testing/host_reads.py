"""Counts the host reads and host writes of the prover's code, stage span by
stage span: the measure of "no host read inside a round loop" on the CPU
and on the card alike.

A read is a device-to-host copy: :func:`swirl_torch.fields.field.to_host`
and a tensor's ``item``, ``tolist``, ``numpy``, ``cpu``, ``bool`` and
``int``. A write is a tensor made from host data (``torch.from_numpy``,
``torch.tensor``, ``torch.as_tensor``): on the card, a host-to-device copy.
On the card each of either kind waits for the stream. The plain versions
of kernels E and F stand for launches on the card, so the reads inside them
are not counted.

Usage::

    with HostReads() as reads:
        proof = engine.prove(dpk, ctx, DeviceTranscript())
    reads.reads["prove_stacked_reduction"], reads.writes["prove_whir"]

Each count holds the events inside every span that was open (a span nested
in another counts in both), and ``"total"`` all of them.
"""

from __future__ import annotations

import contextlib
from collections import Counter

import torch

from .. import metrics
from ..fields import field as F
from ..hash import poseidon2 as p2

_READS = ("item", "tolist", "numpy", "cpu", "__bool__", "__int__")
_WRITES = ("from_numpy", "tensor", "as_tensor")

# the host reads of a prove on the device transcript, per stage span, that
# no number of rounds changes: the commit reads its root; the RAP stage
# GKR's two (the root's zero check, the copy) and the batch phase's one
# copy; the stacked reduction and WHIR one copy each
STAGE_READS = {
    "prover.main_trace_commit": 1,
    "prove_rap_constraints": 3,
    "fractional_sumcheck": 2,
    "prove_stacked_reduction": 1,
    "prove_whir": 1,
}


class HostReads:
    def __init__(self):
        self.reads: Counter = Counter()
        self.writes: Counter = Counter()
        self._open = []  # span names, outermost first
        self._quiet = 0
        self._undo = []

    def _count(self, which: Counter) -> None:
        if not self._quiet:
            which["total"] += 1
            for name in self._open:
                which[name] += 1

    def _counted(self, which: Counter, f):
        def counted(*a, **k):
            self._count(which)
            self._quiet += 1
            try:
                return f(*a, **k)
            finally:
                self._quiet -= 1

        return counted

    def _quieted(self, f):
        def quiet(*a, **k):
            self._quiet += 1
            try:
                return f(*a, **k)
            finally:
                self._quiet -= 1

        return quiet

    def _patch(self, owner, name: str, new) -> None:
        self._undo.append((owner, name, getattr(owner, name)))
        setattr(owner, name, new)

    def __enter__(self) -> "HostReads":
        span = metrics.span

        @contextlib.contextmanager
        def named_span(name):
            self._open.append(name)
            try:
                with span(name):
                    yield
            finally:
                self._open.remove(name)

        self._patch(metrics, "span", named_span)
        self._patch(F, "to_host", self._counted(self.reads, F.to_host))
        for name in _READS:
            self._patch(torch.Tensor, name, self._counted(self.reads, getattr(torch.Tensor, name)))
        for name in _WRITES:
            self._patch(torch, name, self._counted(self.writes, getattr(torch, name)))
        for name in ("duplex_plain", "grind_plain"):
            self._patch(p2, name, self._quieted(getattr(p2, name)))
        return self

    def __exit__(self, *exc) -> None:
        while self._undo:
            owner, name, old = self._undo.pop()
            setattr(owner, name, old)
