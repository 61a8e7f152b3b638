"""The readers of the fused prover's segment timings and host spans against
hand-computed values on a hand-made run: the window's sums a proof, and
nothing where the run did not see a span (as a parent without them)."""

import pytest

import harness


def reader(name):
    return harness.load_module("metrics", name)


SPANS = {
    "gkr.device_time_ms": 2400.0, "batch.device_time_ms": 2720.0, "segments.gap.device_time_ms": 160.0,
    "fused.launch_time_ms": 180.0, "fused.refresh_time_ms": 8.0, "proof_fetch_time_ms": 12.0,
    "proof_build_time_ms": 20.0, "prove_rap_constraints_time_ms": 5200.0,
}


def test_segment_readers_a_proof():
    run = harness.Run(proofs=4, window_s=6.2, spans_ms=dict(SPANS))
    assert reader("gkr_ms").read(run) == 600.0
    assert reader("batch_ms").read(run) == 680.0
    assert reader("segment_gap_ms").read(run) == 40.0
    assert reader("graph_launch_ms").read(run) == 45.0
    assert reader("proof_host_ms").read(run) == pytest.approx((8.0 + 12.0 + 20.0) / 4)
    # the RAP stage's two segments inside its span
    assert reader("gkr_ms").read(run) + reader("batch_ms").read(run) <= reader("rap_ms").read(run)


@pytest.mark.parametrize("name", ["gkr_ms", "batch_ms", "segment_gap_ms", "graph_launch_ms", "proof_host_ms"])
def test_segment_readers_read_nothing_the_run_did_not_see(name):
    # a parent's run: the stage spans and the fetch, none of the new ones
    parent = harness.Run(proofs=4, window_s=6.2, spans_ms={"prove_rap_constraints_time_ms": 5200.0,
                                                           "proof_fetch_time_ms": 12.0})
    assert reader(name).read(parent) is None
    assert reader(name).read(harness.Run()) is None
    module = reader(name)
    assert (module.LAYER, module.UNIT, module.SOURCE, module.MOVES) == (
        "RAP stage" if name in ("gkr_ms", "batch_ms") else "fused prover", "ms/proof", "program_span", "prove_s")
