"""The torch port's plain sumchecks (``swirl_torch/prover/plain_sumcheck.py``)
against the JAX package's (``swirl/prover/plain_sumcheck.py``).

The same numpy EF evaluations from a seed go through both provers: the
proofs (sum claim, univariate coefficients, round values, final claim) and
the challenges are equal. Then the round trips and tampers of
``tests/test_codec_sumcheck.py``'s ``TestPlainSumcheck`` on the port, and
the prism proof's final claim against ``chip_smoke.prism_eval``, the host
evaluation of the prism polynomial. Tolerance: exact equality (finite field).
"""

import numpy as np
import pytest

import jax

jax.config.update("jax_platforms", "cpu")

from swirl.fields import jfield as jf  # noqa: E402
from swirl.prover import plain_sumcheck as jps  # noqa: E402
from swirl.transcript import Transcript as JTranscript  # noqa: E402
from swirl_torch import poly as hpoly  # noqa: E402
from swirl_torch.fields import ext  # noqa: E402
from swirl_torch.fields import field as F  # noqa: E402
from swirl_torch.fields.babybear import P  # noqa: E402
from swirl_torch.prover import plain_sumcheck as tps  # noqa: E402
from swirl_torch.prover.errors import SumcheckError  # noqa: E402
from swirl_torch.transcript import Transcript  # noqa: E402

import chip_smoke  # noqa: E402


def _evals(log_n: int, seed: int):
    return np.random.default_rng(seed).integers(0, P, (1 << log_n, 4), dtype=np.uint64)


def _same_values(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert np.array_equal(np.asarray(x, dtype=np.uint64), np.asarray(y, dtype=np.uint64))


def _same_rounds(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        _same_values(x, y)


def test_multilinear_matches_jax():
    evals = _evals(5, 0)
    got, r = tps.sumcheck_multilinear(Transcript(), F.const_arr(evals))
    want, jr = jps.sumcheck_multilinear(JTranscript(), jf.const_arr(evals))
    _same_values([got.sum_claim, got.eval_claim], [want.sum_claim, want.eval_claim])
    _same_rounds(got.round_polys_eval, want.round_polys_eval)
    _same_values(r, jr)


@pytest.mark.parametrize("l_skip,n", [(2, 3), (3, 2)])
def test_prismalinear_matches_jax(l_skip, n):
    evals = _evals(l_skip + n, 10 + l_skip)
    got, r = tps.sumcheck_prismalinear(Transcript(), l_skip, F.const_arr(evals))
    want, jr = jps.sumcheck_prismalinear(JTranscript(), l_skip, jf.const_arr(evals))
    _same_values([got.sum_claim, got.eval_claim], [want.sum_claim, want.eval_claim])
    _same_values(got.s0_coeffs, want.s0_coeffs)
    _same_rounds(got.round_polys_eval, want.round_polys_eval)
    _same_values(r, jr)


@pytest.mark.parametrize("kind", ["multilinear", "prismalinear"])
def test_roundtrip(kind):
    """The proof verifies with a fresh transcript, the challenges agree, and
    the final claim is the polynomial at them."""
    if kind == "multilinear":
        evals = _evals(5, 0)
        proof, r = tps.sumcheck_multilinear(Transcript(), F.const_arr(evals))
        r2 = tps.verify_sumcheck_multilinear(Transcript(), proof, 5)
        want = hpoly.eval_mle_evals_at_point(evals, np.stack(r))
    else:
        evals = _evals(5, 2)
        proof, r = tps.sumcheck_prismalinear(Transcript(), 2, F.const_arr(evals))
        r2 = tps.verify_sumcheck_prismalinear(Transcript(), proof, 2, 3)
        want = chip_smoke.prism_eval(evals, 2, r)
    assert ext.eeq(proof.sum_claim, ext.esum(evals, axis=0))
    _same_values(r, r2)
    assert ext.eeq(proof.eval_claim, want)


TAMPERS = [(k, f) for k in ("multilinear", "prismalinear") for f in ("round", "final", "s0", "sum")
           if (k, f) != ("multilinear", "s0")]  # a multilinear proof has no univariate round


@pytest.mark.parametrize("kind,field", TAMPERS, ids=[f"{k}-{f}" for k, f in TAMPERS])
def test_tamper_rejected(kind, field):
    evals = _evals(3 if kind == "multilinear" else 4, 1)
    if kind == "multilinear":
        proof, _ = tps.sumcheck_multilinear(Transcript(), F.const_arr(evals))
    else:
        proof, _ = tps.sumcheck_prismalinear(Transcript(), 2, F.const_arr(evals))
    if field == "round":
        proof.round_polys_eval[1][0] = (proof.round_polys_eval[1][0] + 1) % P
    elif field == "final":
        proof.eval_claim = (proof.eval_claim + 1) % P
    elif field == "s0":
        proof.s0_coeffs[1] = (proof.s0_coeffs[1] + 1) % P
    else:
        proof.sum_claim = (proof.sum_claim + 1) % P
    with pytest.raises(SumcheckError):
        if kind == "multilinear":
            tps.verify_sumcheck_multilinear(Transcript(), proof, 3)
        else:
            tps.verify_sumcheck_prismalinear(Transcript(), proof, 2, 2)
