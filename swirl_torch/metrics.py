"""Timing spans and metrics collection: the copy of ``swirl/metrics.py``
(the swirl analog of the reference's
tracing/metrics harness, ``crates/stark-sdk/src/bench/mod.rs`` and
``docs/metrics.md``).

Span names follow the reference metric-name contract so dashboards carry
over: ``stark_prove_excluding_trace_time_ms``,
``prover.main_trace_commit_time_ms``, ``fractional_sumcheck_time_ms``,
``prove_whir_time_ms``, ...
"""

from __future__ import annotations

import contextlib
import json
import time
from collections import defaultdict
from typing import Dict, List, Optional

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
    """Timing span: accumulates into every active collector."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        ms = (time.perf_counter() - t0) * 1e3
        for c in _ACTIVE:
            c.add_time_ms(name, ms)


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
