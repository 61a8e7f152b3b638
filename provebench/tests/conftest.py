"""CPU tests of the benchmark (``python -m pytest provebench/tests``); the
tests marked ``card`` run only where a CUDA card is, and skip elsewhere."""

import json
import os
import shutil
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH_DIR = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH_DIR)
sys.path[:0] = [BENCH_DIR, ROOT]


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def load_bench() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


# small shapes of each family and the test parameters they prove under
# (test_system_params_small with a WHIR query grind of 8 bits, which the
# control drops to 0)
TINY = {
    "synthetic": ("app-synthetic", {"log_height": 8, "width": 12, "num_constraints": 4, "num_interactions": 2},
                  [2, 6, 3]),
    "keccakf": ("keccakf-1024", {"log_permutations": 1, "log_height": 6}, [2, 5, 3]),
}


def tiny_tree(root: str, family: str, name: str = "tiny") -> dict:
    """A copy of the benchmark under ``root`` with a configuration ``name``
    of ``family`` at a small size and its cell ``<name>.replay`` added as new
    files and entries; returns the copy's parsed ``BENCHMARK.json``."""
    shutil.copytree(BENCH_DIR, os.path.join(root, "provebench"), ignore=shutil.ignore_patterns("__pycache__"),
                    dirs_exist_ok=True)
    base, air, args = TINY[family]
    with open(os.path.join(BENCH_DIR, "configs", f"{base}.json")) as f:
        cfg = json.load(f)
    cfg["name"] = name
    cfg["air"].update(air)
    cfg["params"] = {"preset": "test_system_params_small", "args": args, "whir": {"query_phase_pow_bits": 8}}
    cfg["control"]["params"] = {"preset": "test_system_params_small", "args": args, "whir": {"query_phase_pow_bits": 0}}
    with open(os.path.join(root, "provebench", "configs", f"{name}.json"), "w") as f:
        json.dump(cfg, f)
    bench = load_bench()
    bench["configs"].append({"name": name, "source": "test", "file": f"provebench/configs/{name}.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": f"{name}.replay", "config": name, "traffic": "replay", "chips": 1,
                               "why": "test"})
    for m in bench["per_layer"]:
        m["workloads"].append(f"{name}.replay")
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return bench
