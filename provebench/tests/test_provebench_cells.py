"""Every cell of BENCHMARK.json resolves from its own files, the file keeps
to the benchmark's contract, and a configuration, traffic mix and metric
added as new files and entries are picked up with no existing file edited."""

import hashlib
import json
import os
import re

import pytest

from conftest import BENCH_DIR, ROOT, load_bench, tiny_tree

import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("workload", [w["name"] for w in load_bench()["workloads"]])
def test_every_cell_resolves(workload):
    bench = load_bench()
    cell = harness.resolve(bench, workload)
    assert cell.chips == 1
    assert hasattr(cell.family, "program_air") and hasattr(cell.family, "reference_air")
    assert hasattr(cell.family, "device_trace") or hasattr(cell.family, "host_trace")
    for key in ("params", "control", "air", "source", "family"):
        assert key in cell.config
    assert {"trace_pool", "profile_proofs", "check_sample"} <= set(cell.traffic)
    names = {m["name"] for m in cell.end_to_end} | {m["name"] for m in cell.per_layer}
    assert {"prove_s", "setup_s", "device_mem_gb"} <= names
    assert set(cell.readers) == names
    # each metric's file declares what BENCHMARK.json says of it
    for m in cell.end_to_end + cell.per_layer:
        reader = cell.readers[m["name"]]
        assert reader.UNIT == m["unit"] and reader.SOURCE == m["source"]
    for m in cell.per_layer:
        reader = cell.readers[m["name"]]
        assert (reader.LAYER, reader.MOVES) == (m["layer"], m["moves"])


def test_benchmark_keeps_to_the_contract():
    bench = load_bench()
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert bench["command"] == ["python3", "provebench/run.py"] and bench["paths"] == ["provebench"]
    assert isinstance(bench["run_seconds"], int) and 1 <= bench["run_seconds"] <= 51
    e2e = {m["name"] for m in bench["end_to_end"]}
    cells = {w["name"] for w in bench["workloads"]}
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and NAME.match(c["name"])
        assert c["file"].startswith("provebench/") and os.path.isfile(os.path.join(ROOT, c["file"]))
        with open(os.path.join(ROOT, c["file"])) as f:
            assert json.load(f)["source"] == c["source"]
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and NAME.match(w["name"])
        assert len(w["why"]) <= 200 and w["chips"] in (1, 4)
    for m in bench["end_to_end"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["moves"] in e2e
        assert set(m["workloads"]) <= cells
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    names = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(names) == len(set(names)) and "setup_s" in e2e
    assert len(json.dumps(bench)) < 64 * 1024


def _digests(base):
    out = {}
    for d, _, files in os.walk(base):
        for name in files:
            if "__pycache__" not in d:
                path = os.path.join(d, name)
                with open(path, "rb") as f:
                    out[os.path.relpath(path, base)] = hashlib.sha256(f.read()).hexdigest()
    return out


def test_files_added_are_picked_up(tmp_path):
    """A configuration, a traffic mix and a per-layer metric, each a new
    file with its new entries, resolve without an edit to any file the
    benchmark had."""
    before = _digests(BENCH_DIR)
    bench = tiny_tree(str(tmp_path), "synthetic", name="added")
    base = tmp_path / "provebench"
    (base / "traffic" / "burst.json").write_text(json.dumps(
        {"name": "burst", "loop": "closed", "in_flight": 1, "trace_pool": 3, "profile_proofs": 2, "check_sample": 2}))
    (base / "metrics" / "fetch_ms.py").write_text(
        'from harness import span_ms\n\nLAYER = "fused prover"\nUNIT = "ms/proof"\nSOURCE = "program_span"\n'
        'MOVES = "prove_s"\n\n\ndef read(run):\n    return span_ms(run, "proof_fetch")\n')
    bench["workloads"].append({"name": "added.burst", "config": "added", "traffic": "burst", "chips": 1, "why": "t"})
    bench["per_layer"].append({"name": "fetch_ms", "unit": "ms/proof", "better": "lower", "source": "program_span",
                               "layer": "fused prover", "moves": "prove_s", "workloads": ["added.burst"]})
    cell = harness.resolve(bench, "added.burst", root=str(tmp_path))
    assert cell.config["name"] == "added" and cell.traffic["trace_pool"] == 3
    run = harness.Run(proofs=4, spans_ms={"proof_fetch_time_ms": 10.0})
    assert cell.readers["fetch_ms"].read(run) == 2.5
    assert "fetch_ms" not in harness.resolve(bench, "added.replay", root=str(tmp_path)).readers
    copied = _digests(str(base))
    assert all(copied[k] == v for k, v in before.items())
    assert _digests(BENCH_DIR) == before


def test_missing_file_is_refused(tmp_path):
    bench = tiny_tree(str(tmp_path), "synthetic")
    os.remove(tmp_path / "provebench" / "metrics" / "rap_ms.py")
    with pytest.raises(harness.HarnessError, match="rap_ms.py"):
        harness.resolve(bench, "tiny.replay", root=str(tmp_path))
