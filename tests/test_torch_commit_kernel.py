"""The torch port's stacked-commit program (``swirl_torch/prover/commit_kernel.py``)
on the CPU against the JAX package's jitted one
(``swirl/prover/commit_kernel.py``): the codeword and every digest layer,
from the strided levels' output to the root, at small shapes, and the root
against the port's ``stacked_commit`` of the same matrix as one trace. On
the CPU nothing is captured (the graph replay is held to the eager commit
on the card, ``tests/test_torch_kernels_cuda.py``). Inputs come from a
numpy seed. Tolerance: exact equality (finite field).
"""

import numpy as np
import pytest
import torch

import jax

jax.config.update("jax_platforms", "cpu")

from swirl.fields import jfield as jf  # noqa: E402
from swirl.prover import commit_kernel as jck  # noqa: E402
from swirl_torch.fields import field as F  # noqa: E402
from swirl_torch.fields.babybear import P  # noqa: E402
from swirl_torch.prover import commit_kernel as tck  # noqa: E402
from swirl_torch.prover.stacked_pcs import stacked_commit  # noqa: E402

# (width, log height, l_skip, log_blowup, k_whir)
SHAPES = [(4, 8, 2, 1, 2), (3, 9, 3, 1, 4), (2, 7, 2, 2, 3)]


@pytest.mark.parametrize("w,log_h,l_skip,log_blowup,k_whir", SHAPES,
                         ids=[f"{w}x2^{h}-k{k}-b{b}" for w, h, _, b, k in SHAPES])
def test_commit_matches_jax(w, log_h, l_skip, log_blowup, k_whir):
    stacked = np.random.default_rng(log_h).integers(0, P, (w, 1 << log_h), dtype=np.uint64)
    code, layers = tck.commit_kernel(l_skip, log_blowup, k_whir, F.const_arr(stacked))
    jcode, jlayers = jck.commit_kernel(l_skip, log_blowup, k_whir, jf.const_arr(stacked))
    assert code.shape == (w, 1 << (log_h + log_blowup)) and code.device.type == "cpu"
    assert np.array_equal(F.to_host(code), jf.to_host(jcode))
    assert len(layers) == len(jlayers)
    assert layers[0].shape == (8, 1 << (log_h + log_blowup - k_whir))
    for got, want in zip(layers, jlayers):
        assert np.array_equal(F.to_host(got), jf.to_host(want))
    assert layers[-1].shape == (8, 1)

    root, data = stacked_commit(l_skip, log_h - l_skip, log_blowup, k_whir, [F.const_arr(stacked)])
    assert np.array_equal(F.to_host(layers[-1][:, 0]), root)
    assert torch.equal(data.rs_matrix, code)


def test_cpu_captures_nothing():
    stacked = F.const_arr(np.random.default_rng(5).integers(0, P, (2, 1 << 6), dtype=np.uint64))
    tck.commit_kernel(2, 1, 2, stacked)
    assert not tck._GRAPHS
