"""The torch port's stage roofline (``swirl_torch/roofline.py``) against the
JAX package's (``swirl/roofline.py``): the same stage keys and the same
bytes (the reference's work model), a bound by the H100 formula, and
``chip_smoke.py``'s kernel bounds, which now read their constants from the
port's module, unchanged for one shape of each of kernels A-D (the values
the script computed before the move). Tolerance: exact for the bytes and
counts, 1e-12 relative for the bounds in ms (float arithmetic)."""

import math

import pytest

import jax

jax.config.update("jax_platforms", "cpu")

from swirl import roofline as jroof  # noqa: E402
from swirl import params as jparams  # noqa: E402
from swirl_torch import params as tparams  # noqa: E402
from swirl_torch import roofline as troof  # noqa: E402

import chip_smoke  # noqa: E402

CELLS = [("app", "app_params_with_100_bits_security", 22, 3), ("leaf", "leaf_params_with_100_bits_security", 25, 4)]


@pytest.mark.parametrize("name,preset,log_stacked,degree", CELLS, ids=[c[0] for c in CELLS])
def test_stage_bytes_match_jax(name, preset, log_stacked, degree):
    got = troof.prove_bounds(getattr(tparams, preset)(log_stacked), 20, 64, 8)
    want = jroof.prove_bounds(getattr(jparams, preset)(log_stacked), 20, 64, 8)
    assert list(got) == list(want)
    for key in want:
        assert got[key].hbm_bytes == want[key].hbm_bytes, key


def test_bound_follows_the_h100_formula():
    params = tparams.app_params_with_100_bits_security(22)
    for key, b in troof.prove_bounds(params, 20, 64, 8).items():
        byte_s = b.hbm_bytes / 3.35e12
        op_s = max(b.muls, (b.muls + b.others) / 2) / (64 * 132 * 1.98e9)
        assert math.isclose(b.min_ms, max(byte_s, op_s) * 1e3, rel_tol=1e-12), key
        assert b.bound == ("bytes" if byte_s >= op_s else "operations")
    # the commit: a butterfly a cell a pass, two passes, and the permutations
    rs_cells = (1 << 20) * 64 * 2
    perms = rs_cells / 8 + 2 * ((1 << 23) >> params.k_whir)
    commit = troof.prove_bounds(params, 20, 64, 8)["prover.main_trace_commit"]
    assert (commit.muls, commit.others) == (3 * 2 * rs_cells + 1809 * perms, 6 * 2 * rs_cells + 3930 * perms)


def test_report_joins_spans():
    params = tparams.leaf_params_with_100_bits_security(25)
    spans = {"prover.main_trace_commit": 100.0, "prove_whir": 50.0}
    rep = troof.report(params, 20, 64, 8, spans)
    assert set(rep) == set(jroof.prove_bounds(jparams.leaf_params_with_100_bits_security(25), 20, 64, 8))
    for key, entry in rep.items():
        assert ("measured_ms" in entry) == (key in spans)
    frac = rep["prove_whir"]["roofline_frac"]
    assert frac == round(troof.prove_bounds(params, 20, 64, 8)["prove_whir"].min_ms / 50.0, 4)


# (work function, shape, bound_ms and bound_by as chip_smoke.py computed them
# with its own constants, before they moved to swirl_torch/roofline.py)
KERNEL_BOUNDS = [
    ("ntt_work", (16, 1 << 23), 0.641039894925373, "bytes"),
    ("ntt_work", (2, 1 << 27), 1.282079789850746, "bytes"),
    ("hash_work", (16, 1 << 23), 2.878107621671258, "operations"),
    ("layer_work", (8, 1 << 23), 0.7195269054178145, "operations"),
    ("compress_work", (16, 1 << 22), 0.7195269054178145, "operations"),
    ("tower_work", (8, 8192), 0.001405154438561754, "operations"),
]


@pytest.mark.parametrize("work,shape,ms,by", KERNEL_BOUNDS, ids=[f"{w}-{s}" for w, s, _, _ in KERNEL_BOUNDS])
def test_chip_smoke_kernel_bounds_unchanged(work, shape, ms, by):
    assert chip_smoke.bound(getattr(chip_smoke, work)(shape)) == (ms, by)
    assert chip_smoke.PERM == troof.PERM == (1809, 3930)
    assert chip_smoke.BUTTERFLY == troof.BUTTERFLY == (3, 6)
