"""The Merkle build's in-place forms against the JAX package on the CPU:
kernel C's layer entry (pairs read at a stride from an (8, n) layer),
kernel B on a (w, h, 4) extension-field matrix read in place, and whole
trees (root and every layer) against ``swirl.prover.merkle``, and kernel
D's plan run step for step on the CPU against ``swirl.hash.jposeidon2``'s
tower. On these CPU
tensors the wrappers run their plain PyTorch versions; the card tests
(tests/test_torch_kernels_cuda.py) hold the kernels to those. Tolerance:
exact equality (finite field).
"""

import numpy as np
import pytest

import jax

jax.config.update("jax_platforms", "cpu")

from swirl.fields import jfield as jf  # noqa: E402
from swirl.fields.babybear import P  # noqa: E402
from swirl.hash import jposeidon2 as jp2  # noqa: E402
from swirl.hash.poseidon2 import compress_np, hash_rows_np  # noqa: E402
from swirl.prover import merkle as jmerkle  # noqa: E402
import torch  # noqa: E402

from swirl_torch.fields import field as F  # noqa: E402
from swirl_torch.hash import poseidon2 as tp2  # noqa: E402
from swirl_torch.prover import merkle as tmerkle  # noqa: E402

U64 = np.uint64


def _rand(seed, shape):
    return np.random.default_rng(seed).integers(0, P, shape, dtype=U64)


@pytest.mark.parametrize("stride", [1, 2, 4, 16])
def test_compress_layer_matches_numpy(stride):
    """n = 32: stride 16 is n/2. Pairs built here: output o takes digest
    2s(o // s) + o % s and the one s after it."""
    n = 32
    layer = _rand(stride, (8, n))
    left = [2 * stride * (o // stride) + o % stride for o in range(n // 2)]
    want = compress_np(layer[:, left].T, layer[:, [i + stride for i in left]].T)
    assert np.array_equal(F.to_host(tp2.compress_layer(F.const_arr(layer), stride)).T, want)


@pytest.mark.parametrize("stride", [1, 4])
def test_compress_layer_gives_the_pairs_route(stride):
    """The in-place route gives the layer the old (16, n/2) pairs tensor gave."""
    layer = F.const_arr(_rand(40 + stride, (8, 64)))
    g = layer.reshape(8, 64 // (2 * stride), 2, stride)
    pairs = F.const_arr(np.concatenate([F.to_host(g[:, :, 0].reshape(8, 32)), F.to_host(g[:, :, 1].reshape(8, 32))]))
    assert np.array_equal(F.to_host(tp2.compress_layer(layer, stride)), F.to_host(tp2.compress_cols(pairs)))


@pytest.mark.parametrize("w", [1, 2, 3])
def test_hash_cols_reads_ext_matrix_in_place(w):
    m = _rand(w, (w, 9, 4))
    flat = m.transpose(0, 2, 1).reshape(4 * w, 9)  # hash input row c * 4 + d
    assert np.array_equal(F.to_host(tp2.hash_cols(F.const_arr(m))), hash_rows_np(flat.T).T)


@pytest.mark.parametrize("rows_per_query", [1, 16])
@pytest.mark.parametrize("ext", [False, True])
def test_build_merkle_tree_matches_jax(ext, rows_per_query):
    shape = (3, 64, 4) if ext else (5, 64)
    m = _rand(rows_per_query + ext, shape)
    want = jmerkle.build_merkle_tree(jf.const_arr(m), rows_per_query, ext=ext)
    got = tmerkle.build_merkle_tree(F.const_arr(m), rows_per_query, ext=ext)
    assert got.rows_per_query == want.rows_per_query
    assert len(got.layers) == len(want.layers)
    for a, b in zip(got.layers, want.layers):
        assert np.array_equal(F.to_host(a), jf.to_host(b))
    assert np.array_equal(got.root, np.asarray(want.root, U64))


@pytest.mark.parametrize("log_n", range(1, 14))
def test_tower_model_matches_plain_and_jax(log_n):
    """Kernel D's plan (subtree folds, then the last block's top fold) run
    by the CPU model equals the plain tower and the JAX package's, and its
    blocks cover every input digest and write every output digest once."""
    n = 1 << log_n
    plan = tp2.tower_plan(n)
    assert plan["blocks"] * plan["threads"] == max(tp2.QUAD * n // 2, 32)  # a quad a pair, whole warps
    assert [c for r in plan["ranges"] for c in range(*r)] == list(range(n))
    written = torch.cat([lvl["out"].reshape(-1) for f in plan["folds"] for lvl in f["levels"]])
    assert torch.equal(torch.sort(written).values, torch.arange(8 * (n - 1)))
    assert sum(len(f["levels"]) for f in plan["folds"]) == log_n

    d = _rand(100 + log_n, (8, n))
    got = [F.to_host(x) for x in tp2.compress_tower_model(F.const_arr(d))]
    plain = [F.to_host(x) for x in tp2.merkle_tower_plain(F.const_arr(d))]
    want = [jf.to_host(x) for x in jp2.merkle_tower(jf.const_arr(d))]
    assert len(got) == len(plain) == len(want) == log_n
    for g, p, w in zip(got, plain, want):
        assert np.array_equal(g, w)
        assert np.array_equal(p, w)
