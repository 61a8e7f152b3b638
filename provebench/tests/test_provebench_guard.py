"""What a run may not do: hold JAX or the JAX package, or fall back to the
CPU; and the benchmark's own sources import neither, nor does its reference
import the program."""

import ast
import json
import os
import subprocess
import sys
import types

import pytest

from conftest import BENCH_DIR, ROOT

import harness


@pytest.mark.parametrize("name,caught", [
    ("jax", True), ("jax.numpy", True), ("jaxlib", True), ("flax", True), ("swirl", True),
    ("swirl.prover.fused", True), ("benchmarks", True), ("swirl_torch", False), ("swirl_torch.prover", False),
    ("jaxtyping", False), ("swirly", False),
])
def test_import_check(monkeypatch, name, caught):
    monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert (name.split(".")[0] in harness.forbidden_modules()) is caught


def test_no_card_no_result():
    """Without a CUDA card a run exits with a code other than 0 and prints no
    result line: a measurement never falls back to the CPU."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = subprocess.run([sys.executable, os.path.join(BENCH_DIR, "run.py"), "--workload", "app-synthetic.replay",
                          "--seed", "3000000019", "--seconds", "1", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert "no CUDA card" in out.stderr
    for line in out.stdout.splitlines():
        with pytest.raises(ValueError):
            json.loads(line)


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _sources(base):
    for d, _, files in os.walk(base):
        for name in files:
            if name.endswith(".py"):
                yield os.path.join(d, name)


def test_sources_import_no_jax():
    for path in _sources(BENCH_DIR):
        for mod in _imports(path):
            assert mod.split(".")[0] not in harness.FORBIDDEN, f"{path} imports {mod}"


def test_reference_takes_nothing_of_the_program():
    for path in _sources(os.path.join(BENCH_DIR, "reference")):
        for mod in _imports(path):
            assert mod.split(".")[0] in ("numpy", "torch", "__future__", "dataclasses", "typing", "functools", "io",
                                         "struct", "json", "hashlib", "os", "math", "itertools", "collections"), \
                f"{path} imports {mod}"
