"""The port's CUDA kernels against their plain PyTorch versions on the card,
over edge shapes (every NTT size from 2 points to the four-step split,
every four-step strip shape from 2^19 to 2^26 at batch 1 and 3, A′ at
2^27, sponge widths that are not multiples of 8, extension-field
codewords hashed in place, digest layers compressed in place at every kind
of pairing stride, the extreme field values, every tower width, and the
tower's ticket counter across calls, streams and a CUDA graph). Skips
without a card. This file imports no jax, so on a machine without jax run it with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py

Tolerance: exact equality (finite field).
"""

import pytest
import torch

from swirl_torch import kernels as K
from swirl_torch.fields.babybear import P
from swirl_torch.hash import poseidon2 as p2
from swirl_torch.prover import ntt

pytestmark = pytest.mark.cuda


@pytest.fixture
def rand():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    return lambda *shape: torch.randint(0, P, shape, generator=gen, device="cuda", dtype=torch.int64)


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("batch,log_n", [(5, n) for n in range(1, 19)] + [(1, 21), (3 << 10, 3)])
def test_ntt_kernel_matches_plain(rand, batch, log_n, inverse):
    x = rand(batch, 1 << log_n)
    before = K.NTT.launches
    assert torch.equal(ntt.ntt_rows(x, inverse), ntt.ntt_plain(x, inverse))
    assert K.NTT.launches == before + 1


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("batch", [1, 3])
@pytest.mark.parametrize("log_n", range(19, 27))
def test_ntt_two_pass_kernel_matches_plain(rand, batch, log_n, inverse):
    """The four-step passes at every strip shape of the path's splits."""
    x = rand(batch, 1 << log_n)
    assert torch.equal(ntt.ntt_rows(x, inverse), ntt.ntt_plain(x, inverse))


def test_ntt_two_pass_kernel_on_the_largest_values(rand):
    x = torch.full((2, 1 << 26), P - 1, dtype=torch.int64, device=rand(1).device)
    for inverse in (False, True):
        assert torch.equal(ntt.ntt_rows(x, inverse), ntt.ntt_plain(x, inverse))


def test_ntt_kernel_takes_an_unaligned_view(rand):
    """Rows that start 8 bytes past a 16-byte boundary (the passes read
    16-byte vectors) and a strided view are transformed all the same."""
    base = rand(2 * (1 << 16) + 1)
    x = base[1:].view(2, 1 << 16)
    assert torch.equal(ntt.ntt_rows(x), ntt.ntt_plain(x))
    y = rand(3, 1 << 15)[::2]
    assert torch.equal(ntt.ntt(y), ntt.ntt_plain(y.contiguous()))


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("batch", [1, 3])
def test_ntt_recursive_kernel_matches_plain(rand, batch, inverse):
    """A′: 2^27 points, the longest BabyBear transform; batch 3 puts the
    element indices above 2^28."""
    x = rand(batch, 1 << 27)
    assert torch.equal(ntt.ntt_rows(x, inverse), ntt.ntt_plain(x, inverse))


def test_ntt_recursive_kernel_on_the_largest_values(rand):
    x = torch.full((2, 1 << 27), P - 1, dtype=torch.int64, device=rand(1).device)
    for inverse in (False, True):
        assert torch.equal(ntt.ntt_rows(x, inverse), ntt.ntt_plain(x, inverse))


@pytest.mark.parametrize("log_n", [26, 27])
def test_ntt_launch_counts_split_at_2_26(rand, log_n):
    x = rand(1, 1 << log_n)
    a, a2 = K.NTT.launches, K.NTT_RECURSIVE.launches
    ntt.ntt_rows(x)
    torch.cuda.synchronize()
    recursive = log_n > 26
    assert K.NTT.launches == a + (not recursive)
    assert K.NTT_RECURSIVE.launches == a2 + recursive


@pytest.mark.parametrize("w", [0, 1, 7, 8, 9, 16, 21, 64])
def test_hash_cols_kernel_matches_plain(rand, w):
    x = rand(w, 1000)
    assert torch.equal(p2.hash_cols(x), p2.hash_cols_plain(x))


def test_compress_kernel_matches_plain(rand):
    x = rand(16, 12345)
    assert torch.equal(p2.compress_cols(x), p2.compress_cols_plain(x))


@pytest.mark.parametrize("n,stride", [(2000, 1), (2000, 2), (2000, 8), (5 << 13, 1 << 12), (1 << 13, 1 << 12)])
def test_compress_layer_kernel_matches_plain(rand, n, stride):
    """In place, at strides 1, 2, 2^k and n/2; 1000 outputs is not a
    multiple of the block."""
    x = rand(8, n)
    before = K.COMPRESS.launches
    assert torch.equal(p2.compress_layer(x, stride), p2.compress_layer_plain(x, stride))
    assert K.COMPRESS.launches == before + 1


@pytest.mark.parametrize("w", [1, 2, 5])
def test_hash_cols_kernel_reads_ext_matrix_in_place(rand, w):
    x = rand(w, 1000, 4)
    want = p2.hash_cols_plain(x.permute(0, 2, 1).reshape(4 * w, 1000))
    assert torch.equal(p2.hash_cols(x), want)


@pytest.mark.parametrize("value", [0, P - 1])
def test_poseidon2_kernels_on_extreme_values(rand, value):
    dev = rand(1).device
    full = lambda *shape: torch.full(shape, value, dtype=torch.int64, device=dev)  # noqa: E731
    for x in (full(16, 300), full(3, 300), full(2, 300, 4)):
        assert torch.equal(p2.hash_cols(x), p2.hash_cols_plain(x))
    assert torch.equal(p2.compress_cols(full(16, 300)), p2.compress_cols_plain(full(16, 300)))
    assert torch.equal(p2.compress_layer(full(8, 512), 4), p2.compress_layer_plain(full(8, 512), 4))


@pytest.mark.parametrize("log_n", [1, 2, 9, 13, 15])
def test_merkle_tower_kernels_match_plain(rand, log_n):
    x = rand(8, 1 << log_n)
    got, want = p2.merkle_tower(x), p2.merkle_tower_plain(x)
    assert len(got) == len(want) == log_n
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("log_n", range(1, 14))
def test_tower_kernel_matches_plain(rand, log_n):
    x = rand(8, 1 << log_n)
    got, want = p2.compress_tower(x), p2.merkle_tower_plain(x)
    assert len(got) == len(want) == log_n
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_tower_kernel_leaves_its_tickets_clean(rand):
    """Calls in a row and on a side stream: a ticket counter left dirty
    would make a later launch's top fold run early, or never."""
    xs = [rand(8, 8192) for _ in range(3)]
    wants = [p2.merkle_tower_plain(x) for x in xs]
    for _ in range(2):
        for x, want in zip(xs, wants):
            assert all(torch.equal(a, b) for a, b in zip(p2.compress_tower(x), want))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        got = [p2.compress_tower(x) for x in xs]
    torch.cuda.current_stream().wait_stream(side)
    for g, want in zip(got, wants):
        assert all(torch.equal(a, b) for a, b in zip(g, want))


def test_tower_kernel_replays_in_a_cuda_graph(rand):
    """Captured after a call on its stream (which makes the stream's ticket
    counter), replayed twice; captured first on a stream, it raises."""
    x = rand(8, 8192)
    want = p2.merkle_tower_plain(x)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        p2.compress_tower(x)
    side.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        got = p2.compress_tower(x)
    for _ in range(2):
        for t in got:
            t.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    with pytest.raises(K.KernelError):
        with torch.cuda.graph(torch.cuda.CUDAGraph(), stream=torch.cuda.Stream()):
            p2.compress_tower(x)


@pytest.mark.parametrize("value", [0, P - 1])
@pytest.mark.parametrize("log_n", [1, 8, 13])
def test_tower_kernel_on_extreme_values(rand, value, log_n):
    x = torch.full((8, 1 << log_n), value, dtype=torch.int64, device=rand(1).device)
    assert all(torch.equal(a, b) for a, b in zip(p2.compress_tower(x), p2.merkle_tower_plain(x)))


@pytest.mark.parametrize("shape", [(8, 1), (8, 3), (8, 16384), (9, 64)])
def test_tower_kernel_refuses_bad_shapes(rand, shape):
    with pytest.raises(K.KernelError):
        p2.compress_tower(rand(*shape))


def test_kernels_refuse_bad_operands(rand):
    with pytest.raises(K.KernelError):
        p2.hash_cols(rand(4, 8).to(torch.int32))
    with pytest.raises(K.KernelError):
        p2.compress_cols(rand(8, 8))
    with pytest.raises(K.KernelError):
        p2.compress_layer(rand(8, 12), 4)
    with pytest.raises(K.KernelError):
        p2.hash_cols(rand(2, 8, 3))
    with pytest.raises(ValueError):
        ntt.ntt_rows(rand(2, 12))


def _debug_verdict(device, case):
    """The port's debug check on ``device``: its AssertionError text, or
    None if the traces pass."""
    import numpy as np

    from swirl_torch.engine import StarkEngine
    from swirl_torch.params import test_system_params_small
    from swirl_torch.prover.backend import ProvingContext
    from swirl_torch.testing.fixtures import DummyInteractionAir
    from swirl_torch.testing.synthetic import SyntheticAir, uniform_shape

    mk = DummyInteractionAir.make_trace
    air = SyntheticAir(uniform_shape(12, 16, num_constraints=6, num_interactions=4, degree=3))
    trace = np.random.default_rng(3).integers(0, P, (1 << 12, air.common_main_width()), dtype=np.uint64)
    trace[:, 0] = 0
    if case == "broken":
        trace[1234, 0] = 1  # the kill column: the constraints fail at row 1234
    sender = DummyInteractionAir(2, is_send=True, bus_index=40)
    receiver = DummyInteractionAir(2, is_send=False, bus_index=40)
    sends = [[1 + i % 3, i % 25, 100 + i % 25] for i in range(64)]
    recvs = sends if case != "unbalanced" else [[1, 0, 100]] + [[0, 0, 0]] * 63
    airs = [air, sender, receiver]
    ctxs = [(trace, [], []), (mk(sends), [], []), (mk(recvs), [], [])]
    eng = StarkEngine(test_system_params_small(2, 12, 3), device=device)
    pk, _ = eng.keygen(airs)
    ctx = ProvingContext([eng.context_for(i, t, pv, c) for i, (t, pv, c) in enumerate(ctxs)])
    assert ctx.per_trace[0][1].common_main.device.type == torch.device(device).type
    try:
        eng.debug(airs, pk, ctx)
    except AssertionError as e:
        return str(e)
    return None


@pytest.mark.parametrize("case", ["valid", "broken", "unbalanced"])
def test_debug_check_on_the_card_matches_the_cpu(rand, case):
    """The debug check on CUDA traces gives the CPU's verdict and text."""
    got = _debug_verdict("cuda", case)
    assert got == _debug_verdict("cpu", case)
    assert (got is None) == (case == "valid")
    if case == "broken":
        assert got.endswith("failed at row 1234")


def _synthetic_dag():
    """The 187-node SyntheticAir DAG with 8 interactions (above the
    interpreter's threshold)."""
    from swirl_torch.keygen import keygen_air
    from swirl_torch.params import test_system_params_small
    from swirl_torch.testing.synthetic import SyntheticAir, uniform_shape

    air = SyntheticAir(uniform_shape(5, 16, num_constraints=32, num_interactions=8, degree=3))
    return keygen_air(air, test_system_params_small(2, 5, 3), False)[0].symbolic_constraints


@pytest.mark.parametrize("ext", [False, True], ids=["base", "ext"])
def test_dag_interpreter_on_the_card_matches_the_cpu(rand, ext):
    """The level-scheduled interpreter and the constraint and interaction
    sums on CUDA tensors give the CPU's values, at a batch of 1000 rows."""
    from swirl_torch.prover import dag_eval as de
    from swirl_torch.prover.dag_vectorized import eval_dag_vectorized

    dag = _synthetic_dag()
    assert len(dag.nodes) >= de.VECTORIZE_THRESHOLD
    width = 1 + max(n[4] for n in dag.nodes if n[0] == "var" and n[1] == "main")
    tail = (1000, 4) if ext else (1000,)
    sels, local, nxt = rand(3, *tail), rand(width, *tail), rand(width, *tail)
    lam, bus, eq3 = rand(32, 4), rand(8, 4), rand(8, 4)
    beta = rand(1 + max(len(it.message) for it in dag.interactions), 4)

    def run(device):
        ev = de.DeviceEvaluator(sels.to(device), None, [(local.to(device), nxt.to(device))], [], ext)
        values = eval_dag_vectorized(dag, ev)
        outs = [values.gather(sorted(values.sched.out_pos)), de.acc_constraints(dag, ev, lam.to(device))]
        outs += de.acc_interactions(dag, ev, beta.to(device), bus.to(device), eq3.to(device))
        outs += [t for pq in de.interactions_pq(dag, ev, beta.to(device), bus.to(device)) for t in pq]
        return [t.cpu() for t in outs]

    got, want = run("cuda"), run("cpu")
    assert len(got) == len(want) == 4 + 2 * 8
    assert all(torch.equal(g, w) for g, w in zip(got, want))
