"""AIR interface: user-defined constraint systems.

The equivalent of the reference's ``AnyAir``/``BaseAir``/``Air`` trait stack
(``crates/stark-backend/src/any_air.rs``): an AIR declares its trace widths
and (optionally) preprocessed trace, and records constraints/interactions by
evaluating against a builder. Traces are numpy arrays of shape
(height, width) with canonical uint64 entries; heights power-of-two.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np


class Air:
    """Base class for AIRs."""

    def common_main_width(self) -> int:
        raise NotImplementedError

    def cached_main_widths(self) -> List[int]:
        return []

    def num_public_values(self) -> int:
        return 0

    def preprocessed_trace(self) -> Optional[np.ndarray]:
        """(height, width) canonical uint64, or None."""
        return None

    def eval(self, builder) -> None:
        """Record constraints/interactions on a SymbolicAirBuilder."""
        raise NotImplementedError

    def name(self) -> str:
        return type(self).__name__
