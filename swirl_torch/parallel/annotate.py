"""The seam through which the commit sites learn of the mesh.

Peer of ``swirl/parallel/annotate.py``. There the stage code calls the
hints ``rows`` / ``leaves`` / ``replicated`` unconditionally and, inside an
SPMD trace, they hand the active mesh's sharding to XLA's partitioner,
which inserts the collectives. Eager torch has no partitioner, so those
hints have no peer here: the two sites that the JAX package annotates, the
RS encode (``prover/stacked_pcs.py`` ``rs_encode``) and the Merkle build
(``prover/merkle.py`` ``build_merkle_tree``), ask :func:`active_mesh`
instead and, when a mesh is set, run ``parallel/sharded.py``'s explicit
collectives. Outside :func:`spmd_mesh` they run as on one device.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager

_state = threading.local()


def active_mesh():
    """The mesh of the innermost :func:`spmd_mesh` of this thread, or None."""
    return getattr(_state, "mesh", None)


@contextmanager
def spmd_mesh(mesh):
    """Shard the commits of the code run inside it over ``mesh`` (a 1-D
    ``DeviceMesh`` named ``rows``; None shards nothing)."""
    prev = active_mesh()
    _state.mesh = mesh
    try:
        yield
    finally:
        _state.mesh = prev
