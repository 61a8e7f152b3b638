"""The one traffic generator: the traces a run hands the prover, from a
traffic file's parameters, the configuration's family and ``--seed``.

Index -1 is set-up's trace (the first call, which captures), 0, 1, ... the
proofs'. Every trace is drawn from (seed, index) alone, so the same seed
gives the same traces and the set-up trace is never a proof's.

- A family that makes its traces on the card (``device_trace``) makes each
  one when it is asked for, so the making of a proof's trace is inside the
  proof's time.
- A family whose traces are made on the host (``host_trace``) has a pool of
  ``trace_pool`` distinct traces, made in set-up and moved to the card
  there, which the proofs take in turn.
"""

from __future__ import annotations

import numpy as np
import torch


def derive(seed: int, index: int) -> int:
    """A 63-bit seed of (run seed, trace index): the seed may be any whole
    number, the index -1 or more."""
    ss = np.random.SeedSequence([seed % (1 << 64), index + 1])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def host_to_device(trace: np.ndarray, device) -> torch.Tensor:
    """(rows, width) canonical host trace -> the (width, rows) int64 tensor
    the prover takes."""
    return torch.from_numpy(np.ascontiguousarray(np.asarray(trace).T).astype(np.int64)).to(device)


class Traces:
    """The traces of one run (see the module's docstring)."""

    def __init__(self, family, cfg: dict, traffic: dict, seed: int, width: int, device):
        self.family, self.cfg, self.seed, self.width, self.device = family, cfg, seed, width, device
        self.on_device = hasattr(family, "device_trace")
        self.pool = None
        self.setup = None
        if not self.on_device:
            size = int(traffic["trace_pool"])
            if size < 2:
                raise ValueError(f"traffic: a trace pool of {size}; a replay needs at least two traces")
            self.setup = self._host(-1)
            self.pool = [self._host(j) for j in range(size)]

    def _host(self, index: int) -> torch.Tensor:
        return host_to_device(self.family.host_trace(self.cfg, derive(self.seed, index)), self.device)

    def trace(self, index: int) -> torch.Tensor:
        """The trace of proof ``index`` (-1: set-up's)."""
        if self.on_device:
            return self.family.device_trace(self.cfg, self.width, derive(self.seed, index), self.device)
        if index < 0:
            return self.setup
        return self.pool[index % len(self.pool)]
