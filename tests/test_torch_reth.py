"""The port's reth-segment replay path against the JAX package, on the CPU:
the atlas loaders, the metrics helpers, the soundness calculator and vk
audit, the refusal of parameters with no WHIR round, and a multi-AIR
golden proof made by the JAX package.

The golden case ``reth_subset`` takes six AIRs of the repo's reth atlas at
a 2^6 clamp under the synthetic runner's degree-4 parameters at a stacked
height of 2^11 (one WHIR round): from segment 204 an AIR of one row and
one of four (both below 2^l_skip rows), a degree-2, a degree-3 and two
degree-4 AIRs with interactions on 1 to 19 buses; segment 204 has no AIR
without constraints, so segment 13's ``ProgramAir`` is the sixth. Its
traces are random from a seed but for the kill column, which stays zero.
Its vk, proof and transcript were made once with the JAX package's public API
(``JAX_PLATFORMS=cpu python tests/test_torch_reth.py`` writes them again);
the port's proof must equal those bytes and pass ``swirl.verifier``.
Tolerance everywhere: exact equality.
"""

import dataclasses
import json
import os

import numpy as np
import pytest

import jax

jax.config.update("jax_platforms", "cpu")

import swirl.metrics as jmetrics  # noqa: E402
import swirl.params as jparams  # noqa: E402
import swirl.soundness as jsoundness  # noqa: E402
import swirl.testing.synthetic as jsynth  # noqa: E402
import swirl_torch.metrics as tmetrics  # noqa: E402
import swirl_torch.params as tparams  # noqa: E402
import swirl_torch.soundness as tsoundness  # noqa: E402
import swirl_torch.testing.synthetic as tsynth  # noqa: E402
from swirl_torch.tools.segment_fit import seeded_traces  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATLAS = os.path.join(REPO, "benchmarks", "reth-block-23992138-atlas.json")
GOLDEN = "reth_subset"
# (segment, AIR name) of the golden case's AIRs, in proof order
GOLDEN_AIRS = (
    (204, "VerifierPvsAir"),  # 1 row, 213 constraints of degree 4, 69 interactions on 4 buses
    (204, "EqSharpUniAir"),  # 4 rows
    (204, "PowerCheckerAir<2, 32>"),  # degree 2
    (204, "MerkleVerifyAir"),  # degree 3, clamped from 2^13 rows
    (204, "ProofShapeAir<4, 8>"),  # degree 4, 77 interactions on 19 buses
    (13, "ProgramAir"),  # no constraints
)
GOLDEN_CLAMP = 6
GOLDEN_LOG_STACKED = 11

# as tests/test_torch_host.py's presets
PRESETS = (
    [("app_params_with_100_bits_security", h) for h in range(20, 25)]
    + [("leaf_params_with_100_bits_security", h) for h in range(23, 26)]
    + [("internal_params_with_100_bits_security", None)]
    + [("root_params_with_100_bits_security", None)]
    + [("test_system_params_small", (2, 6, 3)), ("test_system_params_small", (2, 7, 3))]
)


def _fields(obj):
    """Dataclasses as nested plain values, so objects of the two packages
    compare field by field."""
    if dataclasses.is_dataclass(obj):
        return (type(obj).__name__, {f.name: _fields(getattr(obj, f.name)) for f in dataclasses.fields(obj)})
    if isinstance(obj, (list, tuple)):
        return [_fields(x) for x in obj]
    if isinstance(obj, dict):
        return {k: _fields(v) for k, v in obj.items()}
    return obj


def runner_params(params_mod, max_log_height: int, degree: int):
    """``benchmarks/synthetic_runner.py``'s parameters (:66-85), from the
    params module of either package."""
    if degree <= 3:
        return params_mod.app_params_with_100_bits_security(max_log_height)
    return params_mod.params_with_100_bits_security(
        log_blowup=1,
        l_skip=4,
        n_stack=max(max_log_height - 4, 0),
        w_stack=2048,
        folding_pow_bits=5,
        mu_pow_bits=15,
        proximity=params_mod.WhirProximityStrategy("unique"),
        max_constraint_degree=degree,
    )


@pytest.mark.parametrize("clamp", [22, 12])
def test_segment_atlas_matches_jax(clamp):
    got = tsynth.load_segment_atlas(ATLAS, clamp)
    want = jsynth.load_segment_atlas(ATLAS, clamp)
    assert len(got) == len(want) == 209
    assert _fields(got) == _fields(want)
    assert any(seg["clamped"] for seg in got) == (clamp < 22)


@pytest.mark.parametrize("clamp", [22, 12])
def test_shape_atlas_matches_jax(clamp, tmp_path):
    """A shape atlas of segments 204's and 13's AIRs at the clamp, read by
    both loaders."""
    segs = {s["segment_idx"]: s for s in jsynth.load_segment_atlas(ATLAS, clamp)}
    shapes = [dataclasses.asdict(sh) for idx in (204, 13) for sh in segs[idx]["shapes"]]
    path = tmp_path / "shapes.json"
    path.write_text(json.dumps({"source": ATLAS, "shapes": shapes}))
    got, want = tsynth.load_shape_atlas(str(path)), jsynth.load_shape_atlas(str(path))
    assert len(got) == 64
    assert _fields(got) == _fields(want)


def test_segment_fit_params_are_the_runners():
    from swirl_torch.tools.segment_fit import runner_params as got_params

    for log_h, degree in ((22, 4), (22, 3), (11, 4), (8, 4)):
        got = got_params(log_h, degree)
        assert _fields(got) == _fields(runner_params(tparams, log_h, degree))
        assert _fields(got) == _fields(runner_params(jparams, log_h, degree))


def test_segment_fit_sample_and_estimate():
    """The fit tool samples the screening tier as the runner does (21
    segments at 0.1, seed 42) and estimates a segment under the engine's
    default memory policy."""
    import math
    import random

    from swirl_torch.engine import StarkEngine
    from swirl_torch.memory_metering import counts_for
    from swirl_torch.tools import segment_fit

    segs = tsynth.load_segment_atlas(ATLAS, 22)
    idxs = list(range(len(segs)))
    random.Random(42).shuffle(idxs)
    assert segment_fit.sample(segs, 0.1, 42) == sorted(idxs[: math.ceil(len(segs) * 0.1)])
    assert [segs[i]["segment_idx"] for i in segment_fit.sample(segs, 0.1, 42)][:3] == [3, 5, 13]
    (i,) = segment_fit.sample(segs, 0.1, 42, {204})
    params = segment_fit.runner_params(22, 4)
    counts, _, est = segment_fit.segment_estimate(params, segs[i])
    eng = StarkEngine(params, device="cpu")
    _, vk = eng.keygen([tsynth.SyntheticAir(sh) for sh in segs[i]["shapes"]])
    assert counts == counts_for(vk, [1 << sh.log_height for sh in segs[i]["shapes"]])
    assert est == eng.proving_memory_config().estimate(counts)
    assert len(counts.round0_airs) == 42 and counts.main_cells == 14985745


def test_no_whir_round_raises_whir_prover_error():
    """The runner's parameters at a 2^8 stacked height have no WHIR round;
    the port refuses before the mu grind, with WhirProverError (a
    StopIteration escaped before)."""
    from swirl_torch.engine import StarkEngine
    from swirl_torch.prover.backend import ProvingContext
    from swirl_torch.prover.errors import WhirProverError

    params = runner_params(tparams, 8, 4)
    assert params.whir.rounds == ()
    air = tsynth.SyntheticAir(tsynth.uniform_shape(8, 8, num_constraints=4, num_interactions=2, degree=4))
    eng = StarkEngine(params, device="cpu")
    pk, _ = eng.keygen([air])
    ctx = ProvingContext([eng.context_for(0, air.generate_trace(), [], [])])
    with pytest.raises(WhirProverError, match=r"params.whir.rounds == \(\)"):
        eng.prove(eng.transport_pk(pk), ctx)


class _Ops:
    """Counts the aten ops dispatched inside the block (on the card, each
    is a launch or a host-side view)."""

    def __enter__(self):
        from torch.utils._python_dispatch import TorchDispatchMode

        outer = self

        class Count(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                outer.n += 1
                return func(*args, **(kwargs or {}))

        self.n, self._mode = 0, Count()
        self._mode.__enter__()
        return self

    def __exit__(self, *exc):
        self._mode.__exit__(*exc)


def _synthetic_evaluator(num_constraints: int, num_interactions: int, ext: bool):
    """A 16-wide SyntheticAir's DAG (through the interpreter) and a device
    evaluator on random canonical values at a batch of 8 rows."""
    import torch

    from swirl_torch.fields import field as F
    from swirl_torch.keygen import keygen_air
    from swirl_torch.prover import dag_eval as de

    air = tsynth.SyntheticAir(tsynth.uniform_shape(
        5, 16, num_constraints=num_constraints, num_interactions=num_interactions, degree=3))
    dag = keygen_air(air, tparams.test_system_params_small(2, 5, 3), False)[0].symbolic_constraints
    assert len(dag.nodes) >= de.VECTORIZE_THRESHOLD
    rng = np.random.default_rng(num_constraints + num_interactions)
    tail = (8, 4) if ext else (8,)
    sels, local, nxt = (F.const_arr(rng.integers(0, 2013265921, (k,) + tail, dtype=np.uint64))
                        for k in (3, 16, 16))
    ev = de.DeviceEvaluator(sels, None, [(local, nxt)], [], ext)
    k = num_interactions
    ef = lambda n: F.const_arr(rng.integers(0, 2013265921, (n, 4), dtype=np.uint64))  # noqa: E731
    return dag, ev, (ef(5), ef(k), ef(k)) if k else None, torch


@pytest.mark.parametrize("ext", [False, True])
def test_interaction_sums_launches_do_not_grow_with_interactions(ext):
    """Segment 13's XorinVmAir has 561 interactions: the batch phase's sums
    are weighted sums over the interactions' nodes, whose ops a call do not
    grow with their count (an EF product and an add a message field
    before), equal to the per-interaction loop's values."""
    from swirl_torch.prover import dag_eval as de

    counts = []
    for k in (4, 40):
        dag, ev, (beta_pows, bus_terms, eq_3bs), _ = _synthetic_evaluator(130, k, ext)
        de.acc_interactions(dag, ev, beta_pows, bus_terms, eq_3bs)  # the cached index tensors
        with _Ops() as ops:
            numer, denom = de.acc_interactions(dag, ev, beta_pows, bus_terms, eq_3bs)
        counts.append(ops.n)
        # the sums as the per-interaction loop forms them
        nodes = de._eval_nodes_device(dag, ev)
        from swirl_torch.fields import field as F

        want_n = want_d = None
        for s, it in enumerate(dag.interactions):
            n_term = de._times_ef(ev, nodes[it.count], eq_3bs[s])
            d_term = F.ext_mul(de._h_beta(ev, nodes, it, bus_terms[s], beta_pows), eq_3bs[s])
            want_n = n_term if want_n is None else F.add(want_n, n_term)
            want_d = d_term if want_d is None else F.add(want_d, d_term)
        assert np.array_equal(F.to_host(numer), F.to_host(want_n))
        assert np.array_equal(F.to_host(denom), F.to_host(want_d))
    assert counts[0] == counts[1], counts


def test_leaf_buffer_launches_do_not_grow_with_leaves():
    """The interpreter's leaf buffer is written group by group: its ops a
    call are the same for 130 and 1,300 constraints (each SyntheticAir
    constraint adds a constant leaf), and its rows equal the leaves."""
    from swirl_torch.fields import field as F
    from swirl_torch.prover import dag_vectorized as dv

    counts = []
    for ext in (False, True):
        for c in (130, 1300):
            dag, ev, _, torch = _synthetic_evaluator(c, 2, ext)
            sched = dv.get_schedule(dag)
            dv._leaf_buffer(sched, ev)
            with _Ops() as ops:
                buf = dv._leaf_buffer(sched, ev)
            counts.append(ops.n)
            for row, node in enumerate(sched.leaf_kinds):
                if node[0] == "const":
                    want = ev.eval_const(node[1])
                elif node[0] == "var":
                    want = ev.eval_var(*node[1:])
                else:
                    want = ev.eval_sel(node[1])
                assert torch.equal(buf[row], torch.broadcast_to(want, buf.shape[1:])), (row, node)
    assert counts[0] == counts[1] and counts[2] == counts[3], counts


SNAPSHOT = {"prove_whir_time_ms": 12.5, "trace_cells.Synthetic(A<2, 8>)": 4096.0,
            "main-trace.cells": 3.0, "gkr_interaction_cells": 1048576.0}


def test_prometheus_exposition_matches_jax():
    for prefix in ("swirl", "port"):
        assert tmetrics.prometheus_exposition(SNAPSHOT, prefix) == jmetrics.prometheus_exposition(SNAPSHOT, prefix)


def test_trace_metrics_match_jax():
    segs = {s["segment_idx"]: s for s in tsynth.load_segment_atlas(ATLAS, 22)}
    shapes = segs[204]["shapes"]
    airs = [tsynth.SyntheticAir(sh) for sh in shapes]
    args = ([a.name() for a in airs], [a.width for a in airs], [sh.log_height for sh in shapes])
    with tmetrics.run_with_metric_collection() as got, jmetrics.run_with_metric_collection() as want:
        tmetrics.trace_metrics(*args)
        jmetrics.trace_metrics(*args)
    assert got.snapshot() == want.snapshot()
    assert got.snapshot()["main_trace_cells"] == 14985745


def test_metric_exporter_without_gateway_collects(monkeypatch):
    monkeypatch.delenv("SWIRL_PROMETHEUS_PUSHGATEWAY", raising=False)
    with tmetrics.run_with_metric_exporter() as got, jmetrics.run_with_metric_exporter() as want:
        for mod in (tmetrics, jmetrics):
            mod.gauge("g", 2.0)
            mod.counter("c", 3)
            with mod.span("s"):
                pass
    assert got.gauges == want.gauges == {"g": 2.0}
    assert dict(got.counters) == dict(want.counters) == {"c": 3}
    assert set(got.snapshot()) == set(want.snapshot()) == {"g", "c", "s_time_ms"}


def test_mem_tracker_records_nothing_off_the_card():
    got_tracker = tmetrics.MemTracker("cpu")
    want_tracker = jmetrics.MemTracker(jax.devices("cpu")[0])
    assert got_tracker.stats() is None
    with tmetrics.run_with_metric_collection() as got, jmetrics.run_with_metric_collection() as want:
        with got_tracker.phase("prove"):
            pass
        with want_tracker.phase("prove"):
            pass
    assert got.snapshot() == want.snapshot() == {}


@pytest.mark.parametrize("preset,arg", PRESETS)
def test_calculate_soundness_matches_jax(preset, arg):
    args = arg if isinstance(arg, tuple) else (() if arg is None else (arg,))
    for max_log_h, airs, cols in ((20, 1, 64), (22, 42, 1521), (21, 22, 4836)):
        kw = dict(max_num_constraints_per_air=3183, num_airs=airs, max_log_trace_height=max_log_h,
                  num_trace_columns=cols, num_stacked_columns=2048, n_logup=max_log_h - 4)
        got = tsoundness.calculate_soundness(getattr(tparams, preset)(*args), **kw)
        want = jsoundness.calculate_soundness(getattr(jparams, preset)(*args), **kw)
        assert _fields(got) == _fields(want)
        assert tsoundness.format_soundness_report(getattr(tparams, preset)(*args), got) == \
            jsoundness.format_soundness_report(getattr(jparams, preset)(*args), want)
    assert tsoundness.min_whir_queries(getattr(tparams, preset)(*args), 100) == \
        jsoundness.min_whir_queries(getattr(jparams, preset)(*args), 100)


@pytest.mark.parametrize("segment", [204, 13])
def test_audit_vk_matches_jax_on_segments(segment):
    """``audit_vk`` of both packages on a segment's vk (42 and 22 AIRs), each
    package's own keygen, under the runner's degree-4 parameters at the
    2^22 clamp."""
    from swirl.keygen import MultiStarkKeygenBuilder as JBuilder
    from swirl_torch.keygen import MultiStarkKeygenBuilder as TBuilder

    def audit(synth, soundness, builder_cls, params_mod):
        params = runner_params(params_mod, 22, 4)
        seg = next(s for s in synth.load_segment_atlas(ATLAS, 22) if s["segment_idx"] == segment)
        builder = builder_cls(params, None)
        for sh in seg["shapes"]:
            builder.add_air(synth.SyntheticAir(sh))
        return soundness.audit_vk(params, builder.generate_pk().get_vk())

    got = audit(tsynth, tsoundness, TBuilder, tparams)
    want = audit(jsynth, jsoundness, JBuilder, jparams)
    assert _fields(got) == _fields(want)
    assert got.ok and got.achieved_bits >= 100.0 and not got.findings


def golden_case(pkg: str):
    """(params, airs, traces) of the golden case from package ``pkg``
    ("swirl" or "swirl_torch")."""
    from importlib import import_module

    synth = import_module(f"{pkg}.testing.synthetic")
    params = runner_params(import_module(f"{pkg}.params"), GOLDEN_LOG_STACKED, 4)
    segs = {s["segment_idx"]: s for s in synth.load_segment_atlas(ATLAS, GOLDEN_CLAMP)}
    shapes = [next(sh for sh in segs[idx]["shapes"] if sh.air_name == name) for idx, name in GOLDEN_AIRS]
    airs = [synth.SyntheticAir(sh) for sh in shapes]
    return params, airs, seeded_traces(airs, 0)


def golden_paths():
    from swirl_torch.testing.golden import paths_for

    return paths_for(GOLDEN)


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def build_jax_golden():
    """(vk bytes, proof bytes, transcript log bytes) of the case, proved and
    verified by the JAX package's public API."""
    from swirl.codec import encode_proof, encode_vk
    from swirl.engine import StarkEngine
    from swirl.prover.backend import ProvingContext
    from swirl.testing.golden import encode_transcript_log
    from swirl.transcript import Transcript

    params, airs, traces = golden_case("swirl")
    eng = StarkEngine(params)
    pk, vk = eng.keygen(airs)
    ctx = ProvingContext([eng.context_for(i, t, [], []) for i, t in enumerate(traces)])
    transcript = Transcript(record=True)
    proof = eng.prove(eng.transport_pk(pk), ctx, transcript=transcript)
    eng.verify(vk, proof)
    return encode_vk(vk), encode_proof(proof), encode_transcript_log(transcript.log)


def test_golden_case_shape():
    """The case holds what it claims: AIRs below 2^l_skip rows, one without
    constraints, degrees 2 to 4, interactions on several buses, one WHIR
    round."""
    params, airs, traces = golden_case("swirl_torch")
    shapes = [a.shape for a in airs]
    assert len(params.whir.rounds) >= 1
    assert sum(len(t) < 1 << params.l_skip for t in traces) == 2
    assert [sh.num_constraints for sh in shapes].count(0) == 1
    assert {sh.max_constraint_degree for sh in shapes} >= {2, 3, 4}
    assert max(sh.num_distinct_buses for sh in shapes) == 19


def test_golden_reth_subset_port_bytes():
    """The port proves the case on the CPU: vk, proof and transcript equal
    the JAX package's stored bytes, and ``swirl.verifier`` accepts the
    port's proof decoded by ``swirl.codec``."""
    from swirl.codec import decode_proof as jdecode_proof, decode_vk as jdecode_vk
    from swirl.verifier import verify as jverify
    from swirl_torch.codec import encode_proof, encode_vk
    from swirl_torch.engine import StarkEngine
    from swirl_torch.testing.golden import encode_transcript_log
    from swirl_torch.transcript import Transcript

    params, airs, traces = golden_case("swirl_torch")
    transcript = Transcript(record=True)
    vk, proof = StarkEngine(params, device="cpu").run_test(airs, [(t, [], []) for t in traces], transcript)
    paths = golden_paths()
    assert encode_transcript_log(transcript.log) == _read(paths["transcript"])
    assert encode_vk(vk) == _read(paths["vk"])
    proof_bytes = encode_proof(proof)
    assert proof_bytes == _read(paths["proof"])
    jvk = jdecode_vk(encode_vk(vk))
    jverify(jvk.params, jvk, jdecode_proof(proof_bytes))


@pytest.mark.slow
def test_golden_reth_subset_jax_bytes():
    """The JAX package makes the stored bytes again."""
    vk_bytes, proof_bytes, log_bytes = build_jax_golden()
    paths = golden_paths()
    assert vk_bytes == _read(paths["vk"])
    assert proof_bytes == _read(paths["proof"])
    assert log_bytes == _read(paths["transcript"])


if __name__ == "__main__":
    vk_bytes, proof_bytes, log_bytes = build_jax_golden()
    paths = golden_paths()
    for what, data in (("vk", vk_bytes), ("proof", proof_bytes), ("transcript", log_bytes)):
        with open(paths[what], "wb") as f:
            f.write(data)
    print(f"golden {GOLDEN}: vk {len(vk_bytes)} B, proof {len(proof_bytes)} B, transcript "
          f"{log_bytes.count(b'\n')} events")
