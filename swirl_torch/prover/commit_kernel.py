"""The stacked commit as one captured program: RS encode and Merkle tree of
a stacked matrix, one CUDA graph replay per commit on the card.

Peer of ``swirl/prover/commit_kernel.py``, where one jitted XLA program per
shape replaces the hundreds of eager ops of a commit. Here the peer is one
``torch.cuda.CUDAGraph`` per (l_skip, log_blowup, k_whir, width, height,
device), captured at the first call on the card: ``rs_message`` (the chunk
iDFTs through kernel A, and the zeta transform), the padded NTT (A), the
leaf hashes (B), the k_whir strided compress levels (C) and the tower (D),
with the levels above the tower's width through C. A later call copies the
stacked matrix into the graph's static input and replays it.

Capture needs what the eager path makes at its first call on a stream to
exist before it: the NTT twiddle tables and the kernels' constants. So the
capture runs one eager commit on its own stream first, then captures on
that stream. Kernel D's launches in both use a ticket counter of the
graph's own (``p2.private_tickets``), made before them: a zero fill
captured in the graph would run only at replay, and a counter keyed by the
stream's handle would be shared with any later pooled stream of that
handle. A failed capture raises; there
is no eager fallback on the card. The results are copies of the graph's
static outputs, so a later commit leaves them as they were.

On a CPU tensor the same functions run eagerly through their plain versions
and nothing is captured. ``stacked_pcs.stacked_commit`` stays the general
entry point (stacking, the memory policy, another hash scheme's trees).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

import torch

from .. import metrics
from ..hash import poseidon2 as p2
from .merkle import build_merkle_tree
from .stacked_pcs import MERKLE_TIMING, rs_code_matrix


def commit_eager(l_skip: int, log_blowup: int, k_whir: int, stacked) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """(codeword (w, h * 2^log_blowup), digest layers (8, n) from the
    strided levels' output to the root), eagerly."""
    code = rs_code_matrix(l_skip, log_blowup, stacked)
    with metrics.device_interval(MERKLE_TIMING):
        return code, build_merkle_tree(code, 1 << k_whir).layers


@dataclass
class CommitGraph:
    """One captured commit: its static input and outputs, and kernel D's
    ticket counter of the graph (``p2.private_tickets``)."""

    graph: torch.cuda.CUDAGraph
    stacked: torch.Tensor
    code: torch.Tensor
    layers: List[torch.Tensor]
    tickets: torch.Tensor = None

    def replay(self, stacked) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        """Copy ``stacked`` into the static input and replay; returns the
        static outputs themselves, which the next replay overwrites."""
        self.stacked.copy_(stacked)
        self.graph.replay()
        return self.code, self.layers


_GRAPHS: Dict[tuple, CommitGraph] = {}


def _capture(l_skip: int, log_blowup: int, k_whir: int, stacked) -> CommitGraph:
    """Capture the commit of ``stacked``'s shape on its device: one eager
    commit on a new stream (the tables and D's ticket counter for that
    stream), then the capture on the same stream."""
    device = stacked.device
    current = torch.cuda.current_stream(device)
    stream = torch.cuda.Stream(device)
    static = torch.empty_like(stacked)
    static.copy_(stacked)
    stream.wait_stream(current)
    with p2.private_tickets(device) as own:
        with torch.cuda.stream(stream):
            commit_eager(l_skip, log_blowup, k_whir, static)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=stream):
            code, layers = commit_eager(l_skip, log_blowup, k_whir, static)
    current.wait_stream(stream)
    return CommitGraph(graph, static, code, layers, own.tower)


def commit_graph(l_skip: int, log_blowup: int, k_whir: int, stacked) -> CommitGraph:
    """The captured commit of this shape and device, captured at its first call."""
    key = (l_skip, log_blowup, k_whir, int(stacked.shape[0]), int(stacked.shape[1]), stacked.device)
    g = _GRAPHS.get(key)
    if g is None:
        g = _GRAPHS[key] = _capture(l_skip, log_blowup, k_whir, stacked)
    return g


def release_graphs() -> None:
    """Drop every captured commit (and the device memory its pool holds)."""
    _GRAPHS.clear()


def commit_kernel(l_skip: int, log_blowup: int, k_whir: int, stacked):
    """Returns (codeword matrix, digest layers list) for one (w, h) stacked
    matrix: on the card by replaying the shape's captured graph (results
    copied out of its static outputs), on the CPU eagerly."""
    if not stacked.is_cuda:
        return commit_eager(l_skip, log_blowup, k_whir, stacked)
    code, layers = commit_graph(l_skip, log_blowup, k_whir, stacked).replay(stacked)
    return code.clone(), [layer.clone() for layer in layers]
