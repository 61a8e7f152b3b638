"""The check that decides ``correct``, driven through a whole run at a small
size on the CPU (the look for a card skipped): sound runs come out correct;
the control (the program under weaker parameters) and each fault planted in
the timed path come out not correct. The control at the cells' own size is
the test marked ``card``."""

import json
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from conftest import ROOT, tiny_tree

import harness

SEED = 3_000_000_021


def drive(tmp_path, family="synthetic", control=False, trace=False, seconds=0.0):
    bench = tiny_tree(str(tmp_path), family)
    cell = harness.resolve(bench, "tiny.replay", root=str(tmp_path))
    device = torch.device("cpu")
    run, numbers, counts = harness.run_cell(cell, SEED, seconds, trace, device, time.perf_counter(), control)
    return run, harness.result(cell, run, numbers, counts, trace, device)


@pytest.mark.parametrize("family", ["synthetic", "keccakf"])
def test_sound_run_is_correct(tmp_path, family):
    run, line = drive(tmp_path, family)
    assert line["correct"] and line["failed"] == 0 and line["attempted"] >= 1
    assert line["checks"] == {"rejected": {"value": 0, "limit": 0}, "opening_mismatches": {"value": 0, "limit": 0}}
    assert list(line)[-1] == "checks"
    assert set(line["metrics"]) == {"prove_s", "setup_s"}  # no card: no memory reading
    assert run.spans_ms["prove_rap_constraints_time_ms"] > 0


def test_traced_run(tmp_path):
    run, line = drive(tmp_path, trace=True)
    assert line["correct"] and run.profile is not None and run.profile.proofs == 1
    assert {"first_call_s", "commit_ms", "rap_ms", "stacking_ms", "whir_ms"} <= set(line["metrics"])
    assert "breakdown" in line


def test_control_is_not_correct(tmp_path):
    _, line = drive(tmp_path, control=True)
    assert not line["correct"] and line["checks"]["rejected"]["value"] >= 1


def test_stale_state_is_not_correct(tmp_path, monkeypatch):
    """The timed path returns its state unchanged: every proof is of the
    set-up's trace, a valid proof of the wrong trace."""
    real, first = harness.prove_one, {}

    def stale(fused, backend, dpk, ctx):
        return real(fused, backend, dpk, first.setdefault("ctx", ctx))

    monkeypatch.setattr(harness, "prove_one", stale)
    _, line = drive(tmp_path)
    assert not line["correct"]
    assert line["checks"]["rejected"]["value"] == 0 and line["checks"]["opening_mismatches"]["value"] > 0


def test_altered_answer_is_not_correct(tmp_path, monkeypatch):
    """An answer altered where it is produced: one value of each proof's
    WHIR final polynomial."""
    real = harness.prove_one

    def altered(fused, backend, dpk, ctx):
        proof = real(fused, backend, dpk, ctx)
        c = np.array(proof.whir_proof.final_poly[0], dtype=np.uint64)
        c[0] = (c[0] + 1) % 2013265921
        proof.whir_proof.final_poly[0] = c
        return proof

    monkeypatch.setattr(harness, "prove_one", altered)
    _, line = drive(tmp_path)
    assert not line["correct"] and line["checks"]["rejected"]["value"] >= 1


def test_failed_proof_is_not_correct(tmp_path, monkeypatch):
    real, calls = harness.prove_one, []

    def failing(fused, backend, dpk, ctx):
        calls.append(1)
        if len(calls) > 1:
            raise RuntimeError("planted")
        return real(fused, backend, dpk, ctx)

    monkeypatch.setattr(harness, "prove_one", failing)
    _, line = drive(tmp_path)
    assert not line["correct"] and line["failed"] == 1


@pytest.mark.card
@pytest.mark.parametrize("workload", ["app-synthetic.replay", "keccakf-1024.replay"])
def test_control_on_card(card, workload):
    """The control at the cell's own size: the program under the
    configuration's control parameters is judged not correct."""
    out = subprocess.run([sys.executable, "provebench/run.py", "--workload", workload, "--seed", str(SEED),
                          "--seconds", "3", "--trace", "0", "--control"],
                         cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert not line["correct"] and line["checks"]["rejected"]["value"] >= 1
