"""Timing spans and metrics collection: the copy of ``swirl/metrics.py``
(the swirl analog of the reference's
tracing/metrics harness, ``crates/stark-sdk/src/bench/mod.rs`` and
``docs/metrics.md``).

Span names follow the reference metric-name contract so dashboards carry
over: ``stark_prove_excluding_trace_time_ms``,
``prover.main_trace_commit_time_ms``, ``fractional_sumcheck_time_ms``,
``prove_whir_time_ms``, ...

While the autograd profiler is enabled, each span is also a host range
named ``span:<name>``, so that the program's spans sit among the
profiler's host events on the device trace's clock. The range is an
operator's (``_RecordFunctionFast``), not a user annotation's
(``record_function``): the profiler mirrors a user annotation onto the
device's timeline from its first kernel to its last, which a reader of the
device's busy time would count as busy.
:func:`time_ms` adds a timing the program measured itself (a device time
between CUDA events) where a span puts its own. :func:`device_interval`
marks a block of the card's work that recurs inside a prove (an RS encode,
a Merkle build) with a pair of such events of its own, kept in the list
that the innermost :func:`device_intervals` holds open.
"""

from __future__ import annotations

import contextlib
import json
import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import torch

# the prefix of a span's range in a profiler trace
SPAN_RANGE = "span:"

_ACTIVE: List["MetricsCollector"] = []


class MetricsCollector:
    def __init__(self):
        self.gauges: Dict[str, float] = {}
        self.counters: Dict[str, int] = defaultdict(int)
        self._timings: Dict[str, float] = defaultdict(float)

    def add_time_ms(self, name: str, ms: float):
        self._timings[f"{name}_time_ms"] += ms

    def gauge(self, name: str, value: float):
        self.gauges[name] = value

    def counter(self, name: str, value: int = 1):
        self.counters[name] += value

    def snapshot(self) -> Dict[str, float]:
        out = dict(self.gauges)
        out.update(self._timings)
        out.update({k: float(v) for k, v in self.counters.items()})
        return out

    def to_json(self) -> str:
        return json.dumps(self.snapshot(), sort_keys=True)


@contextlib.contextmanager
def span(name: str):
    """Timing span: accumulates into every active collector; while the
    autograd profiler is enabled, also a ``span:<name>`` range."""
    if torch.autograd._profiler_enabled():
        marked = torch._C._profiler._RecordFunctionFast(SPAN_RANGE + name)
    else:
        marked = contextlib.nullcontext()
    t0 = time.perf_counter()
    try:
        with marked:
            yield
    finally:
        time_ms(name, (time.perf_counter() - t0) * 1e3)


def time_ms(name: str, ms: float):
    """Add ``ms`` to ``<name>_time_ms`` in every active collector."""
    for c in _ACTIVE:
        c.add_time_ms(name, ms)


def collecting() -> bool:
    """Whether a collector is active."""
    return bool(_ACTIVE)


def event_pair() -> Tuple[torch.cuda.Event, torch.cuda.Event]:
    """A (start, end) pair of timing events. They are ``external``: recorded
    under capture, each record is an event-record node of the graph, which
    every replay records again."""
    return (torch.cuda.Event(enable_timing=True, external=True),
            torch.cuda.Event(enable_timing=True, external=True))


# the lists open for device intervals, innermost last
_INTERVALS: List[list] = []


@contextlib.contextmanager
def device_intervals(into: Optional[list]):
    """While open, each :func:`device_interval` appends its (name, start
    event, end event) to ``into``; with None nothing is recorded."""
    if into is None:
        yield
        return
    _INTERVALS.append(into)
    try:
        yield
    finally:
        _INTERVALS.pop()


@contextlib.contextmanager
def device_interval(name: str):
    """The card's work enqueued inside the block, between two timing events
    of its own, kept by the innermost open :func:`device_intervals`; nothing
    when none is open. A graph replays every record node and an event keeps
    only its last record, so each occurrence has a pair of its own."""
    if not _INTERVALS:
        yield
        return
    start, end = event_pair()
    start.record()
    yield
    end.record()
    _INTERVALS[-1].append((name, start, end))


def interval_ms(intervals) -> Dict[str, float]:
    """{name: the sum of its intervals' end - start, ms} from recorded,
    completed events."""
    out: Dict[str, float] = defaultdict(float)
    for name, start, end in intervals:
        out[name] += start.elapsed_time(end)
    return dict(out)


@contextlib.contextmanager
def run_with_metric_collection(output_path: Optional[str] = None):
    """Collects spans/metrics inside the context; writes JSON on exit."""
    collector = MetricsCollector()
    _ACTIVE.append(collector)
    try:
        yield collector
    finally:
        _ACTIVE.remove(collector)
        if output_path:
            with open(output_path, "w") as f:
                f.write(collector.to_json())


def gauge(name: str, value: float):
    for c in _ACTIVE:
        c.gauge(name, value)


def counter(name: str, value: int = 1):
    for c in _ACTIVE:
        c.counter(name, value)


def trace_metrics(air_names, widths, log_heights):
    """Per-AIR cell-count metrics (cf. reference ``prover/metrics.rs``)."""
    total = 0
    for name, w, lh in zip(air_names, widths, log_heights):
        cells = w * (1 << lh)
        total += cells
        gauge(f"trace_cells.{name}", cells)
    gauge("main_trace_cells", total)


# ---------------------------------------------------------------------------
# Prometheus export (peer of the reference's `run_with_metric_exporter`,
# stark-sdk/src/bench/mod.rs:66: push metrics to a pushgateway).
# ---------------------------------------------------------------------------


def prometheus_exposition(snapshot: Dict[str, float], prefix: str = "swirl") -> str:
    """Render a metric snapshot in the Prometheus text exposition format.

    Metric names are sanitized (dots and dashes to underscores); all values
    export as gauges, matching the reference's snapshot semantics.
    """
    lines = []
    for name in sorted(snapshot):
        metric = f"{prefix}_{name}".replace(".", "_").replace("-", "_")
        lines.append(f"# TYPE {metric} gauge")
        lines.append(f"{metric} {float(snapshot[name])}")
    return "\n".join(lines) + "\n"


@contextlib.contextmanager
def run_with_metric_exporter(
    pushgateway: Optional[str] = None, job: str = "swirl"
):
    """Collect metrics and push them to a Prometheus pushgateway on exit.

    ``pushgateway`` defaults to ``$SWIRL_PROMETHEUS_PUSHGATEWAY`` (e.g.
    ``http://127.0.0.1:9091``); when unset, the context degrades to plain
    collection. Push failures are reported, never raised — observability
    must not fail the prove.
    """
    import os

    collector = MetricsCollector()
    _ACTIVE.append(collector)
    try:
        yield collector
    finally:
        _ACTIVE.remove(collector)
        target = pushgateway or os.environ.get("SWIRL_PROMETHEUS_PUSHGATEWAY")
        if target:
            body = prometheus_exposition(collector.snapshot()).encode()
            url = f"{target.rstrip('/')}/metrics/job/{job}"
            try:
                import urllib.request

                req = urllib.request.Request(url, data=body, method="PUT")
                urllib.request.urlopen(req, timeout=5).read()
            except Exception as e:  # pragma: no cover - network dependent
                import sys

                print(f"swirl_torch.metrics: prometheus push failed: {e}", file=sys.stderr)


# ---------------------------------------------------------------------------
# Live device-memory tracking (peer of the reference MemTracker,
# cuda-common/src/memory_manager/mod.rs:175: per-phase peak/current device
# memory gauges) from the CUDA caching allocator's statistics; a CPU device
# has none and records nothing.
# ---------------------------------------------------------------------------


class MemTracker:
    """Per-phase device-memory gauges from ``torch.cuda.memory_stats``."""

    def __init__(self, device="cuda"):
        import torch

        self.device = torch.device(device)

    def stats(self) -> Optional[Dict[str, int]]:
        """{"bytes_in_use", "peak_bytes_in_use"} of the allocator (bytes
        allocated now and at the peak since the last reset); None off the
        card."""
        import torch

        if self.device.type != "cuda":
            return None
        s = torch.cuda.memory_stats(self.device)
        if not s:
            return None
        return {
            "bytes_in_use": s.get("allocated_bytes.all.current", 0),
            "peak_bytes_in_use": s.get("allocated_bytes.all.peak"),
        }

    @contextlib.contextmanager
    def phase(self, name: str):
        """Record current/peak bytes-in-use deltas for a prover phase as
        ``mem.<name>.{start,end,peak}_bytes`` gauges."""
        before = self.stats()
        if before is not None:
            gauge(f"mem.{name}.start_bytes", before.get("bytes_in_use", 0))
        try:
            yield
        finally:
            after = self.stats()
            if after is not None:
                gauge(f"mem.{name}.end_bytes", after.get("bytes_in_use", 0))
                peak = after.get("peak_bytes_in_use")
                if peak is not None:
                    gauge(f"mem.{name}.peak_bytes", peak)
