"""The port's tracing on the CPU: ``swirl_torch/metrics.py``'s ``time_ms``,
``collecting``, the ``span:<name>`` range a span opens under the
profiler and the device intervals (each RS encode and Merkle build of a
prove between events of its own, with the events stood in for), and the
fused prover's segment timings and host spans
(``swirl_torch/prover/fused.py``). The timings themselves come from CUDA
events, which exist on the card only: ``tests/test_torch_kernels_cuda.py``
holds them to the first start and the last end there.

Tolerance: the arithmetic on hand-computed values in float64, to 1e-12.
"""

import contextlib

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from swirl_torch import metrics
from swirl_torch.engine import StarkEngine
from swirl_torch.prover import fused
from swirl_torch.prover.backend import ProvingContext
from swirl_torch.testing.golden import golden_cases


def test_time_ms_and_collecting():
    metrics.time_ms("outside", 5.0)  # no collector: nothing to add to
    assert not metrics.collecting()
    with metrics.run_with_metric_collection() as outer:
        assert metrics.collecting()
        with metrics.run_with_metric_collection() as inner:
            metrics.time_ms("seg.device", 1.25)
        metrics.time_ms("seg.device", 2.5)
        with metrics.span("seg"):
            pass
    assert not metrics.collecting()
    assert outer.snapshot()["seg.device_time_ms"] == 3.75
    assert inner.snapshot()["seg.device_time_ms"] == 1.25
    assert "outside_time_ms" not in outer.snapshot() and "seg_time_ms" in outer.snapshot()


def _span_ranges(prof):
    return [e.name() for e in prof.profiler.kineto_results.events() if e.name().startswith(metrics.SPAN_RANGE)]


def test_span_opens_a_range_only_under_the_profiler(monkeypatch):
    """Under a CPU ``torch.profiler`` each span is a ``span:<name>`` host
    range, nested as the spans are, and still timed; without one no range
    is opened at all."""
    with profile(activities=[ProfilerActivity.CPU]) as prof, metrics.run_with_metric_collection() as c:
        with metrics.span("outer"):
            with metrics.span("inner"):
                torch.ones(4).sum()
    assert sorted(_span_ranges(prof)) == ["span:inner", "span:outer"]
    times = {e.name(): (e.start_ns(), e.end_ns()) for e in prof.profiler.kineto_results.events()}
    (outer_start, outer_end), (inner_start, inner_end) = times["span:outer"], times["span:inner"]
    assert outer_start <= inner_start <= inner_end <= outer_end
    assert {"outer_time_ms", "inner_time_ms"} <= set(c.snapshot())

    opened = []
    real = torch._C._profiler._RecordFunctionFast

    def counted(name):
        opened.append(name)
        return real(name)

    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", counted)
    with metrics.span("unprofiled"):
        pass
    assert opened == []
    with profile(activities=[ProfilerActivity.CPU]):
        with metrics.span("profiled"):
            pass
    assert opened == ["span:profiled"]


# hand-computed: segments 2, 7.5, 20, 4 and 3.5 ms; first start 0, last end
# 40, so 3 ms between them (0.5 + 1 + 1.5)
TIMES = {"commit": (0.0, 2.0), "gkr": (2.5, 10.0), "batch": (10.0, 30.0), "stacking": (31.0, 35.0),
         "whir": (36.5, 40.0)}
WANT = {"commit.device": 2.0, "gkr.device": 7.5, "batch.device": 20.0, "stacking.device": 4.0,
        "whir.device": 3.5, fused.GAP: 3.0}


def test_segment_timings_by_hand():
    got = fused.segment_timings(TIMES)
    assert list(got) == list(WANT)
    assert got == pytest.approx(WANT, abs=1e-12)
    # back to back: no gap
    assert fused.segment_timings({"a": (1.0, 2.0), "b": (2.0, 5.0)}) == {"a.device": 1.0, "b.device": 3.0,
                                                                         fused.GAP: 0.0}


class _Event:
    """Stands for a recorded CUDA event at ``t`` ms on the card's clock."""

    def __init__(self, t):
        self.t = t

    def elapsed_time(self, other):
        return other.t - self.t


def test_read_events_from_the_first_start():
    """Ten events, read against the first segment's start event, give the
    segments' (start, end) from it; a clock that starts elsewhere gives the
    same timings."""
    events = {name: (_Event(100.0 + s), _Event(100.0 + e)) for name, (s, e) in TIMES.items()}
    assert fused.read_events(events) == TIMES
    assert fused.segment_timings(fused.read_events(events)) == pytest.approx(WANT, abs=1e-12)


def test_no_events_off_the_card():
    assert fused.segment_events(torch.device("cpu")) is None


def test_interval_ms_sums_each_names_occurrences():
    pairs = [("enc", _Event(1.0), _Event(3.5)), ("mk", _Event(4.0), _Event(10.0)), ("enc", _Event(12.0), _Event(12.25))]
    assert metrics.interval_ms(pairs) == {"enc": 2.75, "mk": 6.0}
    assert metrics.interval_ms([]) == {}


class _Recorded:
    """Stands for a timing event: logs its making and its record."""

    log = []

    def __init__(self, **kwargs):
        assert kwargs == {"enable_timing": True, "external": True}
        self.log.append(("event",))

    def record(self):
        self.log.append(("record", self))


def test_device_interval_records_only_inside_an_open_list(monkeypatch):
    """Outside any open list, and inside ``device_intervals(None)``, a
    device interval makes no event; inside, each occurrence makes a pair of
    its own, recorded around its block, and the innermost list keeps it."""
    monkeypatch.setattr(torch.cuda, "Event", _Recorded)
    log = _Recorded.log
    log.clear()
    with metrics.device_interval("x"):
        pass
    with metrics.device_intervals(None), metrics.device_interval("x"):
        pass
    assert log == []
    outer, inner = [], []
    with metrics.device_intervals(outer):
        with metrics.device_interval("a"):
            log.append("body a")
        with metrics.device_intervals(inner), metrics.device_interval("b"):
            pass
        with metrics.device_interval("a"):
            pass
    assert [name for name, _, _ in outer] == ["a", "a"] and [name for name, _, _ in inner] == ["b"]
    (_, s0, e0), (_, s1, e1) = outer
    assert len({id(e) for e in (s0, e0, s1, e1)}) == 4
    assert log[:5] == [("event",), ("event",), ("record", s0), "body a", ("record", e0)]


@pytest.fixture(scope="module")
def fib():
    params, airs, ctxs = golden_cases()["fib"]()
    eng = StarkEngine(params, device="cpu")
    pk, _ = eng.keygen(airs)
    ctx = ProvingContext([eng.context_for(i, cm, pvs, cached) for i, (cm, pvs, cached) in enumerate(ctxs)])
    return eng, eng.transport_pk(pk), ctx


@pytest.mark.parametrize("mode", fused.MODES)
def test_prove_fused_on_the_cpu_records_host_spans_and_no_device_timing(fib, mode):
    """On the CPU every mode runs its segments eagerly: the stage spans, the
    fetch and the build are timed, nothing is replayed (no refresh, no
    launch) and no segment has a device timing."""
    eng, dpk, ctx = fib
    with metrics.run_with_metric_collection() as c:
        fused.prove_fused(eng.backend, dpk, ctx, mode=mode)
    names = set(c.snapshot())
    assert {f"{span}_time_ms" for _, span in fused.SEGMENTS} <= names
    assert {"stark_prove_excluding_trace_time_ms", "proof_fetch_time_ms", "proof_build_time_ms"} <= names
    assert not {"fused.refresh_time_ms", "fused.launch_time_ms"} & names
    assert not [n for n in names if n.endswith(".device_time_ms")]


class _Graph:
    def __init__(self, log, name):
        self.log, self.name = log, name

    def replay(self):
        self.log.append(("replay", self.name))


def test_replay_spans_the_refresh_and_each_launch(monkeypatch):
    """A replay's refresh is one ``fused.refresh`` span, and each graph's
    launch call its own ``fused.launch`` span inside its group's span."""
    log = []
    plain = metrics.span

    @contextlib.contextmanager
    def logged(name):
        log.append(("open", name))
        with plain(name):
            yield
        log.append(("close", name))

    monkeypatch.setattr(metrics, "span", logged)
    groups = [("rap", [_Graph(log, "gkr"), _Graph(log, "batch")]), ("whir", [_Graph(log, "w")])]
    entry = fused.FusedGraphs(groups=groups, static=[], cached=[], flat=None, layout=None, build=None,
                              sync_each=False)
    with metrics.run_with_metric_collection() as c:
        entry.replay(ProvingContext([]), torch.device("cpu"))

    def launch(g):
        return [("open", "fused.launch"), ("replay", g), ("close", "fused.launch")]

    want = [("open", "fused.refresh"), ("close", "fused.refresh"), ("open", "rap"), *launch("gkr"), *launch("batch"),
            ("close", "rap"), ("open", "whir"), *launch("w"), ("close", "whir")]
    assert log == want
    assert {"fused.refresh_time_ms", "fused.launch_time_ms", "rap_time_ms", "whir_time_ms"} <= set(c.snapshot())


@pytest.mark.parametrize("cache_rs", [True, False])
def test_every_encode_and_merkle_build_of_a_prove_is_an_interval(fib, monkeypatch, cache_rs):
    """With a list held open around a prove, each RS encode and each Merkle
    build is one interval: the main commit's and each WHIR codeword's (one
    encode more where WHIR recomputes the dropped codewords); the bytes
    are the prove's without them."""
    import dataclasses

    from swirl_torch.codec import encode_proof
    from swirl_torch.prover.stacked_pcs import ENCODE_TIMING, MERKLE_TIMING

    eng, dpk, ctx = fib
    config = eng.backend.config
    eng.backend.config = dataclasses.replace(config, cache_rs_code_matrix=cache_rs)
    try:
        plain = encode_proof(fused.prove_fused(eng.backend, dpk, ctx, mode="eager"))
        monkeypatch.setattr(torch.cuda, "Event", _Recorded)
        intervals = []
        with metrics.device_intervals(intervals):
            timed = encode_proof(fused.prove_fused(eng.backend, dpk, ctx, mode="eager"))
    finally:
        eng.backend.config = config
    codewords = dpk.params.whir.num_whir_rounds() - 1
    names = [name for name, _, _ in intervals]
    assert names.count(ENCODE_TIMING) == 1 + codewords + (0 if cache_rs else 1)
    assert names.count(MERKLE_TIMING) == 1 + codewords
    assert codewords >= 1 and timed == plain
