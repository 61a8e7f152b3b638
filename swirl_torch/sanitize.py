"""Field-domain sanitizer — the analog of the reference's ``touchemall``
poison-fill feature (``cuda-common/src/d_buffer.rs:84-89``,
``cuda-common/Cargo.toml:28``).

On CUDA, fresh device buffers are memset to ``0xff`` so uninitialized reads
surface as wildly-wrong field values. The port's field arrays are int64
tensors of canonical values in ``[0, P)``, so the failure class is
*out-of-domain data flowing into field arithmetic*. The sanitizer makes it
loud:

- :func:`poison_fill` builds an int64 buffer of ``0xFFFFFFFF`` sentinels
  (no field value: ``P < 2^31``) for tests that emulate a forgotten
  initialization, like touchemall's memset;
- :func:`check_canonical` asserts every element of a field tensor or numpy
  array lies in ``[0, P)``, raising :class:`SanitizerError` with the first
  offending index;
- enabled via ``SWIRL_SANITIZE=1``, the prover runs the checks at its stage
  boundaries (input traces, committed stacked matrix).

Peer of ``swirl/sanitize.py``.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .fields import field as F
from .fields.babybear import P

#: No field value (P < 2^31 < 0xFFFFFFFF) — the touchemall 0xff fill.
POISON = 0xFFFFFFFF


class SanitizerError(AssertionError):
    """An out-of-domain (non-canonical / poisoned) field value was observed."""


def enabled() -> bool:
    return os.environ.get("SWIRL_SANITIZE", "0") not in ("", "0")


def poison_fill(shape, device=None) -> torch.Tensor:
    """An 'uninitialized' int64 buffer: every value 0xFFFFFFFF."""
    return torch.full(tuple(shape), POISON, dtype=F.DTYPE, device=device)


def check_canonical(arr, what: str) -> None:
    """Assert every element of a field array (tensor or numpy) is in [0, P)."""
    if not enabled():
        return
    if not isinstance(arr, torch.Tensor):
        arr = np.asarray(arr)
    bad = (arr < 0) | (arr >= P)
    if not bool(bad.any()):
        return
    first = torch.nonzero(bad)[0] if isinstance(arr, torch.Tensor) else np.argwhere(bad)[0]
    idx = tuple(int(i) for i in first)
    raise SanitizerError(
        f"sanitizer: non-canonical field value {int(arr[idx])} at "
        f"{what}{list(idx)} (>= P={P}); was this buffer initialized?"
    )


def check_traces(traces, what: str) -> None:
    """Range-check a list of (w, h[, 4]) field matrices."""
    if not enabled():
        return
    for i, t in enumerate(traces):
        check_canonical(t, f"{what}[{i}]")
