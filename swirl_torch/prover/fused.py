"""The fused prover: one device transcript from the first event, every
proof value on the device until one fetch, and on the card the prove
captured as CUDA graphs and replayed.

Peer of ``swirl/prover/fused.py`` (``prove_fused`` :850-898). There the
whole prove is one XLA program (``mode="jit"``), five stage programs with
the sponge carried between them (``"segmented"``, :491-727) or the same
trace-mode pipeline run op by op (``"eager"``). Here the five segments are
methods of :class:`_Prove`, the bodies the JAX package jits:

1. ``commit``: the stacked commit of the common traces and the preamble,
   observed on a :class:`~.device_transcript.DeviceTranscript` (the vk
   pre-hash, log heights and public values as host felts in kernel E's
   launch arguments, the commit root as a device digest);
2. ``gkr``: ``prove_gkr_phase``;
3. ``batch``: ``prove_batch_phase``;
4. ``stacking``: the stacked opening reduction;
5. ``whir``: the WHIR opening, then every segment's proof values packed
   into one flat int64 tensor.

No segment reads the host and none syncs: the checks that need a host
value (a zero LogUp sum, a witness found by each grind) run in the
builds, after the one fetch of the flat tensor, which also raise their
errors there. Each segment hands the next the sponge's state and cursors
(:meth:`~.device_transcript.DeviceTranscript.save` / ``restore``).

Modes, on the card:

- ``"eager"``: the five bodies run op by op, each in the Coordinator's span;
- ``"segmented"``: each body is captured as one ``torch.cuda.CUDAGraph`` at
  the first call for a cache key; the five share one memory pool and
  replay in the order they were captured, each in its span, which ends in
  a sync (as ``run_stages`` does, :776-800);
- ``"jit"``: the five bodies captured as one graph.

Segment timings: on the card each segment body runs between a pair of
timing events (``external``, so that under capture each record is an
event-record node of the graph and every replay records it again). When a
metrics collector is active, ``prove_fused`` reads them after the fetch
and adds ``<segment>.device`` for each segment's device time,
``segments.gap.device`` for the card's time between segments (the host's
sync and the next graph's launch), and ``pcs.encode.device`` and
``pcs.merkle.device``, the card's time in every RS encode and every Merkle
build of the prove (each occurrence between events of its own,
``metrics.device_interval``, opened inside the segments), beside the host
spans ``fused.refresh``
(the static inputs' copy), ``fused.launch`` (the graphs' launch calls),
``proof_fetch`` and ``proof_build``.

Graphs are cached on the proving key per (mode, device, memory policy,
context key); the key holds every host value a graph bakes in (air ids,
heights, widths, public values, cached commitments), as ``_ctx_cache_key``
(:306-330). A proving key keeps ``CACHE_ENTRIES`` captured proves: the
capture of a new key first drops the oldest, whose pool is about the eager
prove's peak. The graphs read their own copies of the common traces and
of the cached mains' tensors (trace, matrices, Merkle layers), into which
the caller's are copied before each replay: a graph never reads a tensor
that the caller may free. The first call runs one eager prove on the
capture stream before it captures: the NTT tables, the kernels' constants
and the DAG schedules' index tensors are made there, since none can be
made while the stream captures (what ``commit_kernel.py`` learned); kernel
D's launches in both use a ticket counter that the entry owns, kernel
F's a (found word, ticket) pair and kernel K's (GKR's layer sumcheck) a
ticket of its own (``K.private_tickets``). A capture that fails raises: the card has no
eager fallback. On the CPU every mode runs the five bodies eagerly through
the plain kernels and captures nothing.

``mesh`` (a 1-D ``DeviceMesh`` named ``rows``, ``parallel/multihost.py``
``proof_mesh``): every rank runs the same prove on the same whole context,
the same sponge and so the same challenges, and gets the one-device bytes;
inside ``parallel.annotate.spmd_mesh`` the commits (the main trace's and
WHIR's codeword commits) run across the ranks (``parallel/sharded.py``),
their codewords and layers gathered whole, and the other stages run
replicated. As in the reference (:869-870) a mesh needs a graph mode. On
the card the graphs capture the commits' NCCL collectives (the warm-up
on the capture stream has made the communicator); a mesh whose group is
not NCCL cannot be captured and is refused. The mesh is part of the cache
key (``_mesh_key``, :333-341). On the CPU every mode runs eagerly.

Not ported: the persistent compile cache and the AOT executable bundles
(the kernels are built once by nvcc; a graph is captured in-process),
trace mode.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .. import kernels as K
from .. import metrics
from .. import sanitize
from .. import tpoly
from ..fields import field as F
from ..parallel import annotate
from ..proof import Proof
from .backend import (
    AirContext,
    CommittedTraceData,
    ProvingContext,
    observe_preamble,
    proof_metadata,
    stacked_per_commit,
    trace_provers,
)
from .commit_kernel import commit_eager
from .deferred import Deferred
from .device_transcript import DeviceTranscript
from .errors import ProverError
from .logup_zerocheck import prove_batch_phase, prove_gkr_phase
from .merkle import MerkleTree
from .stacked_pcs import StackedPcsData, stack_traces
from .stacked_reduction import stacked_opening_reduction_deferred
from .whir import whir_opening_deferred

MODES = ("eager", "segmented", "jit")

# captured proves kept a proving key: each holds a pool of about the eager
# prove's peak, so a new key's capture first drops the oldest
CACHE_ENTRIES = 1

# the five segments (swirl/prover/fused.py:543-706), each with the span of
# Coordinator.prove it runs in
SEGMENTS = (
    ("commit", "prover.main_trace_commit"),
    ("gkr", "prove_rap_constraints"),
    ("batch", "prove_rap_constraints"),
    ("stacking", "prove_stacked_reduction"),
    ("whir", "prove_whir"),
)


# the card's time between segments, from the first segment's start to the
# last one's end
GAP = "segments.gap.device"


def segment_events(device) -> Optional[Dict[str, Tuple[torch.cuda.Event, torch.cuda.Event]]]:
    """A (start, end) pair of timing events a segment on a CUDA ``device``
    (``metrics.event_pair``), None elsewhere."""
    if device.type != "cuda":
        return None
    return {name: metrics.event_pair() for name, _ in SEGMENTS}


def segment_timings(times: Dict[str, Tuple[float, float]]) -> Dict[str, float]:
    """{``<segment>.device``: end - start} of each segment and
    :data:`GAP`: the first start to the last end, less the segments, from
    each segment's (start, end) in ms on one clock, in segment order."""
    out = {f"{name}.device": end - start for name, (start, end) in times.items()}
    spans = list(times.values())
    out[GAP] = spans[-1][1] - spans[0][0] - sum(out.values())
    return out


def read_events(events) -> Dict[str, Tuple[float, float]]:
    """Each segment's (start, end) in ms from the first segment's start, read
    from its recorded, completed events."""
    first = events[SEGMENTS[0][0]][0]
    return {name: (first.elapsed_time(start), first.elapsed_time(end)) for name, (start, end) in events.items()}


def ctx_cache_key(ctx: ProvingContext) -> tuple:
    """Per trace of the sorted context: (air id, height, width, public
    values, cached commitments), every host value a captured prove bakes
    in (``_ctx_cache_key``, ``swirl/prover/fused.py:306-330``)."""
    parts = []
    for air_id, tc in ctx.per_trace:
        cached = tuple(tuple(int(v) for v in np.asarray(cd.commitment).ravel()) for cd in tc.cached_mains)
        parts.append((air_id, tc.height, int(tc.common_main.shape[0]),
                      tuple(int(p) for p in tc.public_values), cached))
    return tuple(parts)


class _Prove:
    """The five segment bodies of one prove on ``commons`` (the sorted
    context's common traces, in its order). Each segment reads what the
    ones before it left on ``self`` and adds its proof values (a
    :class:`~.deferred.Deferred`) to ``parts``; ``whir`` ends with the
    packed values in ``flat`` and ``layout`` and the proof's build in
    ``build``. ``cached``, per trace, takes the place of its cached mains
    when given. On the card :meth:`segment` runs a body between its pair
    of ``events``, the device intervals opened inside it kept in
    ``intervals``."""

    def __init__(self, backend, mpk, ctx: ProvingContext, commons: List[torch.Tensor], cached=None):
        self.backend, self.mpk, self.params = backend, mpk, mpk.params
        if cached is None:
            cached = [tc.cached_mains for _, tc in ctx.per_trace]
        self.ctx = ProvingContext([
            (air_id, AirContext(cached_mains=cds, common_main=cm, public_values=tc.public_values))
            for (air_id, tc), cm, cds in zip(ctx.per_trace, commons, cached)
        ])
        self.parts: List[Deferred] = []
        self.sponge = None  # (state, absorb_idx, sample_idx) between segments
        self.events = segment_events(backend.device)
        self.intervals = None if self.events is None else []

    def segment(self, name: str) -> None:
        """The segment body ``name``, between its events on the card."""
        if self.events is None:
            getattr(self, name)()
            return
        start, end = self.events[name]
        start.record()
        with metrics.device_intervals(self.intervals):
            getattr(self, name)()
        end.record()

    def _transcript(self) -> DeviceTranscript:
        return DeviceTranscript.restore(*self.sponge)

    def commit(self) -> None:
        p, c = self.params, self.backend.config
        t = DeviceTranscript(self.backend.device)
        t.observe_commit(self.mpk.vk_pre_hash)
        commons = [tc.common_main for _, tc in self.ctx.per_trace]
        stacked, layout = stack_traces(p.l_skip, p.n_stack, commons)
        code, layers = commit_eager(p.l_skip, p.log_blowup, p.k_whir, stacked)
        self.common_data = StackedPcsData(
            layout=layout,
            matrix=stacked if c.cache_stacked_matrix else None,
            rs_matrix=code if c.cache_rs_code_matrix else None,
            tree=MerkleTree(layers=layers, rows_per_query=1 << p.k_whir),
            traces=commons,
            l_skip=p.l_skip,
            n_stack=p.n_stack,
            log_blowup=p.log_blowup,
        )
        del stacked, code
        root = layers[-1][:, 0]
        observe_preamble(t, self.mpk, root, *proof_metadata(self.mpk, self.ctx))
        self.parts.append(Deferred([root], lambda host: host[0]))
        self.sponge = t.save()

    def gkr(self) -> None:
        t = self._transcript()
        pending, self.xi, self.beta = prove_gkr_phase(t, self.params, trace_provers(self.mpk, self.ctx), defer=True)
        self.parts.append(pending)
        self.sponge = t.save()

    def batch(self) -> None:
        t = self._transcript()
        pending, self.r = prove_batch_phase(
            t, self.params, self.mpk.max_constraint_degree, trace_provers(self.mpk, self.ctx), self.xi,
            self.beta, save_memory=bool(self.backend.config.zerocheck_save_memory),
        )
        self.parts.append(pending)
        self.xi = self.beta = None
        self.sponge = t.save()

    def stacking(self) -> None:
        t = self._transcript()
        datas, need_rot = stacked_per_commit(self.mpk, self.ctx, self.common_data)
        pending, self.u = stacked_opening_reduction_deferred(t, self.params, datas, need_rot, self.r)
        self.parts.append(pending)
        self.r = None
        self.sponge = t.save()

    def whir(self) -> None:
        t = self._transcript()
        datas, _ = stacked_per_commit(self.mpk, self.ctx, self.common_data)
        u = self.u
        u_cube = torch.stack(tpoly.squares(u[0], self.params.l_skip) + list(u[1:]))
        self.parts.append(whir_opening_deferred(t, self.params, datas, u_cube))
        whole = Deferred.join(self.parts)
        self.flat, self.layout = F.pack(whole.values)
        self.build = whole.build
        # the run keeps the packed values only: the prove's other tensors
        # go back to the allocator (under capture, to the graphs' pool)
        self.parts, self.common_data, self.u, self.sponge = [], None, None, None


def cached_tensors(cached) -> List[torch.Tensor]:
    """The device tensors of cached mains (per trace, a list of
    :class:`CommittedTraceData`) in a fixed order: each one's trace, then
    its commitment's traces, matrices and Merkle layers."""
    out = []
    for cds in cached:
        for cd in cds:
            d = cd.data
            out += [cd.trace, *d.traces, *(m for m in (d.matrix, d.rs_matrix) if m is not None), *d.tree.layers]
    return out


def static_cached(cached):
    """Copies of cached mains (per trace, a list of
    :class:`CommittedTraceData`) for the graphs to read: every device
    tensor cloned, a tensor held in two places cloned once."""
    clones = {}

    def clone(t):
        if t is None:
            return None
        if id(t) not in clones:
            clones[id(t)] = t.clone()
        return clones[id(t)]

    def copy(cd):
        d = cd.data
        data = dataclasses.replace(
            d, matrix=clone(d.matrix), rs_matrix=clone(d.rs_matrix), traces=[clone(t) for t in d.traces],
            tree=dataclasses.replace(d.tree, layers=[clone(layer) for layer in d.tree.layers]),
        )
        return CommittedTraceData(commitment=cd.commitment, trace=clone(cd.trace), data=data)

    return [[copy(cd) for cd in cds] for cds in cached]


@dataclass
class FusedGraphs:
    """One cache entry: the graphs of one (mode, context key), each group
    with its span, the static inputs (common traces, cached mains) and
    output, the segments' timing events and the device intervals inside
    them, which every replay records, the
    first call's seconds and counts (``stats["nodes"]``: each graph's
    nodes), kernel D's ticket counter
    and kernel F's (found word, ticket) pair of the graphs, which share
    their allocation with kernel K's ticket
    (``K.private_tickets``): torch's pooled streams recur, so a counter
    keyed by the capture stream's handle could be shared with an eager
    launch while a replay runs."""

    groups: List[Tuple[str, List[torch.cuda.CUDAGraph]]]
    static: List[torch.Tensor]
    cached: list
    flat: torch.Tensor
    layout: list
    build: object
    sync_each: bool
    events: Optional[Dict[str, Tuple[torch.cuda.Event, torch.cuda.Event]]] = None
    intervals: Optional[list] = None
    stats: Dict[str, object] = field(default_factory=dict)
    tickets: torch.Tensor = None
    grind_scratch: torch.Tensor = None

    def refresh(self, ctx: ProvingContext) -> None:
        """Copy the sorted ``ctx``'s common traces and cached mains into the
        static inputs, after checking that they pair one to one in shape
        (cached mains committed under another memory policy hold other
        tensors under the same commitment)."""
        commons = [tc.common_main for _, tc in ctx.per_trace]
        cached = cached_tensors([tc.cached_mains for _, tc in ctx.per_trace])
        mine = cached_tensors(self.cached)
        if len(commons) != len(self.static) or len(cached) != len(mine) or any(
            s.shape != c.shape for s, c in zip(self.static + mine, commons + cached)
        ):
            raise ProverError("prove_fused: the context's traces or cached mains do not match the captured "
                              f"prove's in count or shape ({len(commons)} and {len(cached)} tensors against "
                              f"{len(self.static)} and {len(mine)})")
        for s, c in zip(self.static, commons):
            s.copy_(c)
        done = set()
        for s, c in zip(mine, cached):
            if id(s) not in done:
                done.add(id(s))
                s.copy_(c)

    def replay(self, ctx: ProvingContext, device) -> None:
        with metrics.span("fused.refresh"):
            self.refresh(ctx)
        for span, graphs in self.groups:
            with metrics.span(span):
                for g in graphs:
                    with metrics.span("fused.launch"):
                        g.replay()
                if self.sync_each:
                    torch.cuda.synchronize(device)


def run_segments(backend, mpk, ctx: ProvingContext, commons=None, cached=None, spans: bool = True) -> _Prove:
    """The five bodies run eagerly on the sorted ``ctx`` (on ``commons`` and
    ``cached`` in place of its common traces and cached mains when given),
    each in its span; the result holds the packed values (``flat``,
    ``layout``) and the proof's ``build``."""
    if commons is None:
        commons = [tc.common_main for _, tc in ctx.per_trace]
    run = _Prove(backend, mpk, ctx, commons, cached)
    for name, span in SEGMENTS:
        with metrics.span(span) if spans else contextlib.nullcontext():
            run.segment(name)
    return run


def _warm_up(backend, mpk, ctx, static, cached, stream) -> None:
    """One eager prove on the capture stream, not waited for: everything the
    stages make at their first call on a stream exists before the capture."""
    with torch.cuda.stream(stream):
        run_segments(backend, mpk, ctx, static, cached, spans=False)


def _record(backend, mpk, ctx, static, cached, stream, mode: str):
    """Capture the five bodies on ``stream`` into one pool: one graph each
    (``segmented``) or one in all (``jit``). Returns (the groups of graphs
    by span, the finished run, the capture's and the instantiation's
    seconds, {graph: nodes})."""
    if mode == "segmented":
        plan = [(span, [name]) for name, span in SEGMENTS]
    else:
        plan = [("fused_replay", [name for name, _ in SEGMENTS])]
    pool = torch.cuda.graph_pool_handle()
    run = _Prove(backend, mpk, ctx, static, cached)
    captured, capture_s, instantiate_s, nodes = [], 0.0, 0.0, {}
    for span, names in plan:
        # instantiated apart from the capture, so that its seconds show
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        t0 = time.perf_counter()
        with torch.cuda.graph(graph, pool=pool, stream=stream):
            for name in names:
                run.segment(name)
        t1 = time.perf_counter()
        graph.instantiate()
        capture_s += t1 - t0
        instantiate_s += time.perf_counter() - t1
        captured.append((span, graph))
        nodes["+".join(names)] = K.graph_nodes(graph)
    groups: List[Tuple[str, List[torch.cuda.CUDAGraph]]] = []
    for span, graph in captured:
        if groups and groups[-1][0] == span:
            groups[-1][1].append(graph)
        else:
            groups.append((span, [graph]))
    return groups, run, capture_s, instantiate_s, nodes


def _capture(backend, mpk, ctx, mode: str) -> FusedGraphs:
    """The first call of a cache key on the card: static inputs, the eager
    warm-up and the capture, on a stream of their own."""
    device = backend.device
    current = torch.cuda.current_stream(device)
    static = [tc.common_main.clone() for _, tc in ctx.per_trace]
    cached = static_cached([tc.cached_mains for _, tc in ctx.per_trace])
    stream = torch.cuda.Stream(device)
    stream.wait_stream(current)
    with K.private_tickets(device) as own:
        t0 = time.perf_counter()
        _warm_up(backend, mpk, ctx, static, cached, stream)
        stream.synchronize()
        warm_s = time.perf_counter() - t0
        try:
            groups, run, capture_s, instantiate_s, nodes = _record(backend, mpk, ctx, static, cached, stream, mode)
        except Exception as err:
            raise ProverError(f"prove_fused(mode={mode!r}): the capture failed ({type(err).__name__}: {err}); "
                              "the card has no eager fallback") from err
    current.wait_stream(stream)
    return FusedGraphs(
        groups=groups, static=static, cached=cached, flat=run.flat, layout=run.layout, build=run.build,
        sync_each=mode == "segmented", events=run.events, intervals=run.intervals,
        stats={"warm_up_s": warm_s, "capture_s": capture_s, "instantiate_s": instantiate_s,
               "graphs": sum(len(g) for _, g in groups), "nodes": nodes},
        tickets=own.tower,
        grind_scratch=own.grind,
    )


def fused_graphs(mpk, key) -> FusedGraphs:
    """The cache entry of ``key`` (see :func:`graph_key`), or None."""
    return getattr(mpk, "_fused_cache", {}).get(key)


def _mesh_key(mesh):
    """None, or a mesh's dims, world size, this rank and its group's
    backend (``swirl/prover/fused.py:333-341``): a prove captured without a
    mesh never replays with one."""
    if mesh is None:
        return None
    group = mesh.get_group()
    return (tuple(mesh.mesh_dim_names), tuple(mesh.mesh.shape), tuple(dist.get_process_group_ranks(group)),
            dist.get_world_size(), dist.get_rank(), dist.get_backend(group))


def graph_key(backend, ctx: ProvingContext, mode: str, mesh=None) -> tuple:
    """The cache key of a captured prove of the sorted ``ctx``."""
    c = backend.config
    policy = (c.cache_stacked_matrix, c.cache_rs_code_matrix, bool(c.zerocheck_save_memory))
    return (mode, backend.device, policy, _mesh_key(mesh), ctx_cache_key(ctx))


def cached_entry(mpk, key, capture) -> FusedGraphs:
    """The proving key's entry of ``key``; on a miss, ``capture()`` makes it
    after the oldest entries are dropped down to ``CACHE_ENTRIES - 1``."""
    cache = mpk.__dict__.setdefault("_fused_cache", {})
    entry = cache.get(key)
    if entry is None:
        while len(cache) >= CACHE_ENTRIES:
            del cache[next(iter(cache))]
        entry = cache[key] = capture()
    return entry


def release_fused(mpk) -> None:
    """Drop the proving key's captured proves (and the device memory their
    pools hold), as ``commit_kernel.release_graphs`` does."""
    if hasattr(mpk, "_fused_cache"):
        del mpk._fused_cache


def prove_fused(backend, mpk, unsorted_ctx: ProvingContext, mode: str = "jit", mesh=None) -> Proof:
    """A prove on the device transcript from its first event, byte-identical
    to ``Coordinator.prove``; the proof's values are read in one copy.

    ``mode``: ``"eager"`` runs the five segments op by op; ``"segmented"``
    replays one CUDA graph a segment and ``"jit"`` one graph for all five,
    each captured at the first call of its cache key on the card (the key
    holds the public values and cached commitments; the proving key keeps
    the last ``CACHE_ENTRIES`` captures, each with a pool of about the
    eager prove's peak, until :func:`release_fused`). On the CPU every mode
    runs eagerly. The BN254 outer scheme (a backend with a
    ``tree_builder``) proves on its host transcript and is refused.

    ``mesh``: a 1-D ``DeviceMesh`` named ``rows`` over the ranks, each of
    which calls this with the same context; the commits run across them and
    each gets the one-device proof. It needs ``mode="jit"`` or
    ``"segmented"``, and on the card an NCCL group."""
    if mode not in MODES:
        raise ValueError(f"prove_fused: unknown mode {mode!r}; one of {MODES}")
    if mesh is not None and mode not in ("jit", "segmented"):
        raise ValueError("mesh sharding requires mode='jit' or 'segmented'")
    if backend.tree_builder is not None:
        raise ProverError("prove_fused: the device transcript is BabyBear Poseidon2-16; a backend with "
                          "another hash scheme's tree builder proves on its host transcript")
    device = backend.device
    if mesh is not None and device.type == "cuda" and dist.get_backend(mesh.get_group()) != "nccl":
        raise ProverError(f"prove_fused(mode={mode!r}): a {dist.get_backend(mesh.get_group())} mesh cannot be "
                          "captured in a CUDA graph; the card's mesh needs an NCCL group, and there is no eager "
                          "fallback")
    ctx = unsorted_ctx.sorted_for_stacking()
    commons = [tc.common_main for _, tc in ctx.per_trace]
    sanitize.check_traces(commons, "common_main")
    trace_vdata, public_values = proof_metadata(mpk, ctx)

    with metrics.span("stark_prove_excluding_trace"), annotate.spmd_mesh(mesh):
        if device.type != "cuda" or mode == "eager":
            run = run_segments(backend, mpk, ctx, commons)
            flat, layout, build, events, intervals = run.flat, run.layout, run.build, run.events, run.intervals
        else:
            key = graph_key(backend, ctx, mode, mesh)
            entry = cached_entry(mpk, key, lambda: _capture(backend, mpk, ctx, mode))
            entry.replay(ctx, device)
            flat, layout, build = entry.flat, entry.layout, entry.build
            events, intervals = entry.events, entry.intervals
        with metrics.span("proof_fetch"):
            host = F.unpack(layout, F.to_host(flat))
        # the fetch waited for the stream, so every segment's events are done
        if events is not None and metrics.collecting():
            for name, ms in {**segment_timings(read_events(events)), **metrics.interval_ms(intervals)}.items():
                metrics.time_ms(name, ms)
        with metrics.span("proof_build"):
            commit, gkr, batch, stacking, whir = build(host)
    return Proof(
        common_main_commit=commit,
        trace_vdata=trace_vdata,
        public_values=public_values,
        gkr_proof=gkr,
        batch_constraint_proof=batch,
        stacking_proof=stacking,
        whir_proof=whir,
    )
