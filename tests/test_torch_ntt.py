"""The model of kernels A and A′'s two four-step passes (``ntt_two_pass_model``
in ``swirl_torch/prover/ntt.py``) against the plain transform and the JAX
package's ``ntt``, and the model's checks of the kernel's index algebra
(bank-conflict-free shared memory, every output written exactly once) at
the splits the prove path runs. The kernels themselves run only on the
card (``tests/test_torch_kernels_cuda.py``). Inputs are made with numpy
from a seed. Tolerance: exact equality (finite field).
"""

import numpy as np
import pytest
import torch

import jax

jax.config.update("jax_platforms", "cpu")

from swirl.fields import jfield as jf  # noqa: E402
from swirl.fields.babybear import P  # noqa: E402
from swirl.prover import ntt as jntt  # noqa: E402
from swirl_torch.fields import field as F  # noqa: E402
from swirl_torch.prover import ntt as tntt  # noqa: E402

SHARED_BYTES_MAX = 232448  # the most dynamic shared memory one Hopper block takes
SM_SHARED_BYTES = 233472  # an H100 SM's shared memory; each block also reserves 1 KB


def _rows(log_n: int, seed: int):
    x = np.random.default_rng(seed).integers(0, P, (2, 1 << log_n), dtype=np.uint64)
    x[0, :97] = P - 1  # the largest canonical values
    x[1, -64:] = P - 1
    return x


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("log_n", [14, 15, 16, 17, 18])
def test_two_pass_model_matches_jax_ntt(log_n, inverse):
    """The kernel's own strips; odd log_n has n2 = 2 * n1, as 2^27 does."""
    x = _rows(log_n, log_n)
    got = F.to_host(tntt.ntt_two_pass_model(F.const_arr(x), log_n // 2, *tntt.strip_widths(log_n), inverse))
    assert np.array_equal(got, F.to_host(tntt.ntt_plain(F.const_arr(x), inverse)))
    assert np.array_equal(got, jf.to_host(jntt.ntt(jf.const_arr(x), inverse=inverse)))


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("log_n,strip1", [(14, 4), (14, 8), (15, 16), (15, 32)])
def test_two_pass_model_matches_plain_at_other_strips(log_n, strip1, inverse):
    """Pass-1 strips other than the kernel's (pass 2 always holds 2
    columns), at 2^7-point columns, where every width is conflict-free."""
    x = _rows(log_n, 100 + log_n)
    got = tntt.ntt_two_pass_model(F.const_arr(x), log_n // 2, strip1, 2, inverse)
    assert torch.equal(got, tntt.ntt_plain(F.const_arr(x), inverse))


# the splits of the path's four-step shapes: (4, 2^21) and (4, 2^22) app
# WHIR, (16, 2^23) app RS, (4, 2^24), (4, 2^25) and (4, 2^26) leaf WHIR,
# (2, 2^27) A′
PATH_LOG_N = [21, 22, 23, 24, 25, 26, 27]


@pytest.mark.parametrize("log_n", PATH_LOG_N)
def test_two_pass_plan_at_path_splits(log_n):
    """Index arrays only: every warp access of both passes bank-conflict
    free, every scratch and output index written once, vectors aligned."""
    tntt.two_pass_plan(log_n, log_n // 2, *tntt.strip_widths(log_n))


@pytest.mark.parametrize("log_n", list(range(14, 28)))
def test_strip_widths_fit_the_shared_memory(log_n):
    """A strip and its stage twiddles fit a block; two pass-1 blocks (and
    two pass-2 blocks below 2^27) fit an SM; a strip is a whole number of
    16-byte vectors wide."""
    l1, l2 = log_n // 2, log_n - log_n // 2
    c, r = tntt.strip_widths(log_n)
    assert 2 <= c and 2 * c <= 1 << l2 and r == 2
    assert c == 2 or c << l1 == 1 << 14
    shared1, shared2 = 4 * (c + 1) << l1, 4 * (r + 1) << l2
    assert shared1 <= SHARED_BYTES_MAX and shared2 <= SHARED_BYTES_MAX
    assert 2 * (shared1 + 1024) <= SM_SHARED_BYTES
    assert log_n == 27 or 2 * (shared2 + 1024) <= SM_SHARED_BYTES


def test_two_pass_plan_batches_and_refuses_bad_strips():
    tntt.two_pass_plan(15, 7, 4, 2, batch=3)
    for log_n1, strips in ((7, (1, 2)), (7, (3, 2)), (7, (4, 4)), (7, (256, 2)), (6, (4, 2)), (8, (4, 2))):
        with pytest.raises(ValueError):
            tntt.two_pass_plan(15, log_n1, *strips)


@pytest.mark.parametrize("addr,degree", [
    (torch.arange(32), 1),
    (torch.zeros(32, dtype=torch.int64), 1),  # one word: a broadcast
    (torch.arange(32) * 32, 32),
    (torch.arange(32) * 2, 2),
    (torch.arange(64).reshape(2, 32).flip(1), 1),
])
def test_bank_conflicts_counts_distinct_words_per_bank(addr, degree):
    assert tntt.bank_conflicts(addr) == degree


def test_swizzle_is_a_bijection_on_strips():
    for log_n in (7, 10, 11, 13, 14):
        for log_cols in (1, 2, 3):
            f = torch.arange(1 << (log_n + log_cols))
            assert torch.equal(torch.sort(tntt.swizzle(f, log_n, log_cols)).values, f)
