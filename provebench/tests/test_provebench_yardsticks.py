"""The arithmetic of the metrics against hand-computed values: the rate over
the window, the spans a proof, the busy union and the idle share, the frozen
work functions and bounds, the roofline share, and a proof's launches."""

import pytest

import harness
from yardstick import roofline as y
from yardstick.busy import Union


def reader(name):
    return harness.load_module("metrics", name)


def test_rate_over_the_window():
    run = harness.Run(proofs=4, window_s=6.2, memory_reserved=8_004_829_184, setup_s=30.5, first_call_s=20.25,
                      spans_ms={"prove_rap_constraints_time_ms": 5200.0, "prove_whir_time_ms": 400.0})
    assert reader("prove_s").read(run) == pytest.approx(1.55)
    assert reader("device_mem_gb").read(run) == pytest.approx(8.004829184)
    assert reader("setup_s").read(run) == 30.5 and reader("first_call_s").read(run) == 20.25
    assert reader("rap_ms").read(run) == 1300.0 and reader("whir_ms").read(run) == 100.0
    assert reader("commit_ms").read(run) is None  # a span the run did not see reads nothing
    assert reader("prove_s").read(harness.Run()) is None


def test_busy_union():
    u = Union([(10, 20), (15, 30), (40, 50), (50, 55), (70, 80)])
    assert (u.starts, u.ends) == ([10, 40, 70], [30, 55, 80])
    assert u.covered(0, 100) == 20 + 15 + 10
    assert u.covered(25, 45) == 5 + 5
    assert u.covered(31, 39) == 0


def _profile(device, host=(), lo=0, hi=100, proofs=1):
    return harness.Profile(lo, hi, list(device), list(host), proofs)


def test_idle_share_leaves_out_the_profilers_own_stalls():
    idle = reader("device_idle_pct").read
    p = _profile([("k", 0, 30), ("k", 20, 50), ("Memcpy DtoH (Device -> Pinned)", 60, 70)])
    assert harness.busy_ns(p) == 60 and harness.idle_gaps(p) == [(50, 60), (70, 100)]
    assert idle(harness.Run(profile=p)) == pytest.approx(40.0)
    # 20 ns of the idle 40 lie in a buffer flush: 20 idle of 80
    p.host.append(("Buffer Flush", 75, 95))
    assert harness.profiler_idle_ns(p) == 20
    assert idle(harness.Run(profile=p)) == pytest.approx(25.0)
    assert idle(harness.Run()) is None


def test_breakdown():
    p = _profile([("void (anonymous namespace)::hash_cols_kernel(long const*)", 0, 30),
                  ("void at::native::(anonymous namespace)::distribution_elementwise_grid_stride_kernel<x>(int)", 40, 50),
                  ("void (anonymous namespace)::hash_cols_kernel(long const*)", 50, 60)],
                 host=[("cudaGraphLaunch", 30, 45), ("aten::copy_", 60, 100), ("cudaMemcpyAsync", 61, 99)])
    b = harness.breakdown(p)
    assert b["device_ops"] == [["hash_cols_kernel", 40e-9],
                               ["at::native::distribution_elementwise_grid_stride_kernel", 10e-9]]
    assert b["idle_gaps"] == [["cudaMemcpyAsync", 40e-9], ["cudaGraphLaunch", 10e-9]]


def test_work_functions():
    assert y.PERM == (1809, 3930) and y.BUTTERFLY == (3, 6)
    # 2 rows of 8 points: 2 * 4 * 3 butterflies; a read and a write of 16 int64
    assert y.ntt_work((2, 8)) == (256, (72, 144))
    # 16 columns by 4 rows: (16 + 8) * 4 words; 2 permutations a row
    assert y.hash_work((16, 4)) == (768, (8 * 1809, 8 * 3930))
    assert y.hash_work((1, 4, 4)) == y.hash_work((4, 4))
    assert y.compress_work((16, 5)) == (960, (5 * 1809, 5 * 3930))
    assert y.layer_work((8, 10)) == y.compress_work((16, 5))
    assert y.tower_work((8, 4)) == ((32 + 24) * 8, (3 * 1809, 3 * 3930))
    assert y.launch_work("compress_cols", (16, 5)) == y.compress_work((16, 5))
    assert y.launch_work("compress_cols", (8, 10)) == y.layer_work((8, 10))
    assert y.launch_work("ntt_recursive", (2, 8)) == y.ntt_work((2, 8))
    assert y.launch_work("duplex", (16,)) is None
    # bytes bound: 3.35e12 B/s; operations: max(m, (m + a) / 2) lanes at 64 x 132 x 1.98e9 a second
    assert y.bound((3.35e9, (0, 0))) == (pytest.approx(1.0), "bytes")
    ms, by = y.bound((0, (y.INT32_LANE_OPS_PER_S, y.INT32_LANE_OPS_PER_S)))
    assert (ms, by) == (pytest.approx(1000.0), "operations")


def test_roofline_share():
    share = reader("ntt_hash_roofline").read
    launches = {("ntt", (4, 1 << 20)): 1, ("hash_cols", (16, 1 << 20)): 2, ("duplex", (16,)): 400}
    least = y.bound(y.ntt_work((4, 1 << 20)))[0] + 2 * y.bound(y.hash_work((16, 1 << 20)))[0]
    # two proofs traced, each 2 ms of A-D: the share is least / 2 ms
    dev = [("void (anonymous namespace)::ntt_pass1_kernel(long*)", 0, 1_000_000),
           ("void (anonymous namespace)::hash_cols_kernel(long const*)", 1_000_000, 4_000_000),
           ("void (anonymous namespace)::duplex_kernel(long*)", 4_000_000, 9_000_000),
           ("void at::native::vectorized_elementwise_kernel<4>(int)", 0, 9_000_000)]
    run = harness.Run(launches=launches, profile=_profile(dev, hi=10_000_000, proofs=2))
    assert share(run) == pytest.approx(100 * least / 2.0)
    assert share(harness.Run(launches=launches)) is None
    assert share(harness.Run(launches=launches, profile=_profile(dev[2:], hi=10_000_000))) is None


def test_a_proofs_launches_halve_the_first_calls():
    assert harness.per_proof({("ntt", (4, 8)): 2, ("hash_cols", (1, 8, 4)): 6}) == {
        ("ntt", (4, 8)): 1, ("hash_cols", (1, 8, 4)): 3}
    assert harness.per_proof({("ntt", (4, 8)): 3}) is None
    assert harness.per_proof({}) is None


def test_trace_seeds():
    import generator

    assert generator.derive(7, 0) == generator.derive(7, 0) != generator.derive(7, 1)
    assert generator.derive(2**40 + 3, -1) != generator.derive(2**40 + 3, 0)
    assert 0 <= generator.derive(2**40 + 3, 5) < 2**63
