"""The port's CUDA kernels against their plain PyTorch versions on the card,
over edge shapes (every NTT size from 2 points to the four-step split,
every four-step strip shape from 2^19 to 2^26 at batch 1 and 3, A′ at
2^27, sponge widths that are not multiples of 8, extension-field
codewords hashed in place, digest layers compressed in place at every kind
of pairing stride, the extreme field values, every tower width, and the
tower's ticket counter across calls, streams and a CUDA graph), the
monomial engine against the CPU and the interpreter, the stacked commit's
captured graph against the eager commit, and the
device transcript's kernels E (duplex) and F (grind) at ``chip_smoke.py``'s
cases, E under CUDA graph capture, F at every absorb cursor on both of its
routes and at 18 bits, replayed in a CUDA graph, with its (found word,
ticket) pair owned by each capture and prove, and with no witness (-1),
both refusing bad cursors and bit counts,
the transcript on the card against the CPU and a golden proof on it, the
BN254 outer golden case and round 0 in segments on the card, the fused
prover's captured proves (golden bytes in segmented and jit mode, a replay
on another trace, a replay on a fresh context of a cached trace whose
first context was freed, a failed capture that raises, the segments'
device timings from events that the graphs record and each graph's node
count, a leaf-shaped prove's RS encode and Merkle build timings, kernel
D's ticket counter owned by each captured prove and commit, the golden
bytes on a world-of-one NCCL mesh), kernel K (GKR's layer
sumcheck: each kind of pass on both sides of the one-block boundary, the
eq table, a capture replayed on new inputs, captures owning their ticket
counters, 2^14 fractions against the CPU), kernel L (the batch sumcheck's
EF4 product and product-and-sum at the batch phase's shapes, stride-2
views, one row and none, a capture replayed on new inputs, captures owning
their ticket counters, and degree-3 and degree-4 fused proofs on the card
equal to the CPU's), and the BN254
kernels G-J against their plain versions (the field's operations on
random and edge operands, the permutations, compress layers at every kind
of stride, leaf hashes of every absorb shape and of extension-field
codewords, the device tree against the host tree, the grind from every
sponge cursor at 5, 15 and 18 bits; all-zero and all-(P - 1) digest layers and codewords, and
the product on every pair of edge values, for the FP64 core). Skips
without a card. This file imports no jax, so on a machine without jax run it with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py

Tolerance: exact equality (finite field).
"""

import numpy as np
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


@pytest.mark.parametrize("ext", [False, True], ids=["base", "ext"])
def test_monomial_engine_on_the_card_matches_the_cpu(rand, ext):
    """The monomial engine on CUDA tensors gives the CPU's values and the
    interpreter's, on the SyntheticAir DAG at 2^10 rows."""
    from swirl_torch.prover import dag_eval as de
    from swirl_torch.prover.monomial import acc_constraints_monomial, expand_monomials

    dag = _synthetic_dag()
    exp = expand_monomials(dag)
    width = 1 + max(n[4] for n in dag.nodes if n[0] == "var" and n[1] == "main")
    tail = (1 << 10, 4) if ext else (1 << 10,)
    sels, local, nxt, lam = rand(3, *tail), rand(width, *tail), rand(width, *tail), rand(32, 4)

    def run(device):
        ev = de.DeviceEvaluator(sels.to(device), None, [(local.to(device), nxt.to(device))], [], ext)
        got = acc_constraints_monomial(exp, ev, lam.to(device))
        assert got.device.type == torch.device(device).type
        assert torch.equal(got, de.acc_constraints(dag, ev, lam.to(device)))
        return got.cpu()

    assert torch.equal(run("cuda"), run("cpu"))


def test_commit_graph_replay_matches_eager(rand):
    """The commit replays its captured graph: the codeword and layers equal
    the eager commit's and the CPU's, a second commit on other data leaves
    the first one's tensors as they were, and kernels A-D launch only at
    the warm-up and the capture (a replay enqueues no wrapper)."""
    from swirl_torch.prover import commit_kernel as ck

    ck.release_graphs()
    x, y = rand(4, 1 << 12), rand(4, 1 << 12)
    eager = ck.commit_eager(2, 1, 3, x)
    K.reset_launch_counts()
    code, layers = ck.commit_kernel(2, 1, 3, x)
    per_commit = K.launch_counts()
    assert all(per_commit[k.name] == 2 * n for k, n in ((K.NTT, 2), (K.HASH_COLS, 1), (K.COMPRESS, 3), (K.TOWER, 1)))
    assert torch.equal(code, eager[0]) and all(torch.equal(a, b) for a, b in zip(layers, eager[1]))
    cpu = ck.commit_kernel(2, 1, 3, x.cpu())
    assert torch.equal(code.cpu(), cpu[0]) and all(torch.equal(a.cpu(), b) for a, b in zip(layers, cpu[1]))
    first = [code.clone()] + [t.clone() for t in layers]
    code2, layers2 = ck.commit_kernel(2, 1, 3, y)
    assert K.launch_counts() == per_commit
    other = ck.commit_eager(2, 1, 3, y)
    assert torch.equal(code2, other[0]) and all(torch.equal(a, b) for a, b in zip(layers2, other[1]))
    assert all(torch.equal(a, b) for a, b in zip([code] + layers, first))
    assert len(ck._GRAPHS) == 1
    ck.release_graphs()


# ------------------------------------------ the device transcript: E, F ---

import chip_smoke  # noqa: E402


@pytest.mark.parametrize("case", chip_smoke.DUPLEX_CASES, ids=[c[0] for c in chip_smoke.DUPLEX_CASES])
def test_duplex_kernel_matches_plain(rand, case):
    """Kernel E at chip_smoke.py's cases: the new state and the squeezed
    values, one launch a call."""
    _, a, s, k, n_host, n_squeeze, bits = case
    st0, absorb = rand(16), rand(k) if k else None
    host = [int(v) for v in rand(n_host).cpu()]
    st = st0.clone()
    before = K.DUPLEX.launches
    out = p2.duplex(st, absorb, host, a, s, n_squeeze, bits)
    assert K.DUPLEX.launches == before + 1
    new, want = p2.duplex_plain(st0, absorb, host, a, s, n_squeeze, bits)
    assert torch.equal(out, want) and torch.equal(st, new)


GRAPH_DUPLEX_CASES = ("gkr_subround_from_5", "final_poly_absorb", "query_indices", "host_felts",
                      "absorb_4088_and_5_host_from_3")


@pytest.mark.parametrize("label", GRAPH_DUPLEX_CASES)
def test_duplex_kernel_in_a_cuda_graph(rand, label):
    """Kernel E captured in a CUDA graph (as the fused prover captures it)
    and replayed twice: each replay advances the state once, bit-equal to
    the plain version applied as often; its launch configuration takes no
    host read."""
    _, a, s, k, n_host, n_squeeze, bits = next(c for c in chip_smoke.DUPLEX_CASES if c[0] == label)
    st0, absorb = rand(16), rand(k) if k else None
    host = [int(v) for v in rand(n_host).cpu()]
    st = st0.clone()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        out = p2.duplex(st, absorb, host, a, s, n_squeeze, bits)
    want_st = st0
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        want_st, want = p2.duplex_plain(want_st, absorb, host, a, s, n_squeeze, bits)
        assert torch.equal(out, want) and torch.equal(st, want_st)


@pytest.mark.parametrize("case", chip_smoke.GRIND_CASES, ids=[c[0] for c in chip_smoke.GRIND_CASES])
def test_grind_kernel_matches_plain(rand, case):
    """Kernel F at chip_smoke.py's widths, from cursor 4: the smallest
    witness and the advanced state, one launch a call."""
    _, bits = case
    st0 = rand(16)
    st = st0.clone()
    before = K.GRIND.launches
    w = p2.grind(st, 4, bits)
    assert K.GRIND.launches == before + 1
    new, want = p2.grind_plain(st0, 4, bits)
    assert torch.equal(w, want) and torch.equal(st, new)


@pytest.mark.parametrize("a", range(8))
@pytest.mark.parametrize("bits", [1, 8, 10, 11, 13, 18])
def test_grind_kernel_at_every_absorb_cursor(rand, a, bits):
    """Both routes (rows up to 10 bits, the sweep above: ``p2.grind_plan``)
    and the logup grind's 18 bits, from every cursor."""
    st0 = rand(16)
    st = st0.clone()
    w = p2.grind(st, a, bits)
    new, want = p2.grind_plain(st0, a, bits)
    assert torch.equal(w, want) and torch.equal(st, new)


@pytest.mark.parametrize("bits", [5, 12])
def test_grind_kernel_in_a_cuda_graph(rand, bits):
    """Kernel F captured in a CUDA graph (as the fused prover captures it)
    and replayed twice: each replay searches from the state the last one
    left, bit-equal to the plain version applied as often; the launch
    re-arms its (found word, ticket) pair."""
    st0 = rand(16)
    st = st0.clone()
    p2.grind(st0.clone(), 3, bits)  # the library and its constants, before any capture
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with K.private_tickets(st.device) as own:
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=stream):
            w = p2.grind(st, 3, bits)
    want_st = st0
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        want_st, want_w = p2.grind_plain(want_st, 3, bits)
        assert torch.equal(w, want_w) and torch.equal(st, want_st)
        assert own.grind.tolist() == [-1, 0]


def test_captures_own_their_grind_pairs(rand):
    """Two captured grinds and a captured prove each own their (found word,
    ticket) pair, none of them a stream's; each is armed after its replays."""
    from swirl_torch.prover import fused

    pairs = []
    for bits in (5, 12):
        st = rand(16)
        p2.grind(st.clone(), 0, bits)  # the library and its constants, before any capture
        stream = torch.cuda.Stream()
        stream.wait_stream(torch.cuda.current_stream())
        with K.private_tickets(st.device) as own:
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, stream=stream):
                p2.grind(st, 0, bits)
        graph.replay()
        pairs.append(own.grind)
    eng, dpk, ctx = _fused_case("fib")
    fused.prove_fused(eng.backend, dpk, ctx, mode="segmented")
    pairs.append(next(iter(dpk._fused_cache.values())).grind_scratch)
    fused.prove_fused(eng.backend, dpk, ctx, mode="segmented")
    torch.cuda.synchronize()
    shared = {t.grind.data_ptr() for t in K._TICKETS.values()}
    assert len({t.data_ptr() for t in pairs}) == 3 and not shared & {t.data_ptr() for t in pairs}
    assert all(t.dtype == torch.int64 and t.tolist() == [-1, 0] for t in pairs)
    fused.release_fused(dpk)


def test_grind_kernel_without_a_witness():
    """A 30-bit search finds no witness in [0, P) from about one state in
    seven: the first seeded state that gives -1 leaves the state as it
    was, gives -1 again, no candidate of [0, 2^22) passes the plain
    permutation's test, and the re-armed pair serves the next grind."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(30)
    for _ in range(64):
        st0 = torch.tensor(rng.integers(0, P, 16).astype(np.int64), device="cuda")
        st = st0.clone()
        if int(p2.grind(st, 2, 30)) == -1:
            break
    else:
        pytest.fail("64 seeded states, each with a 30-bit witness")
    assert torch.equal(st, st0) and int(p2.grind(st, 2, 30)) == -1 and torch.equal(st, st0)
    for lo in range(0, 1 << 22, 1 << 20):
        states = st0.expand(1 << 20, 16).clone()
        states[:, 2] = torch.arange(lo, lo + (1 << 20), device="cuda")
        assert not bool(((p2.permute_plain(states)[:, p2.RATE - 1] & ((1 << 30) - 1)) == 0).any())
    new, want = p2.grind_plain(st0, 2, 5)
    assert torch.equal(p2.grind(st, 2, 5), want) and torch.equal(st, new)


def test_transcript_kernels_refuse_bad_arguments(rand):
    st = rand(16)
    for a, s in ((8, 0), (-1, 0), (0, 9), (0, -1)):
        with pytest.raises(ValueError):
            p2.duplex(st, None, [], a, s, 1)
    with pytest.raises(ValueError):
        p2.duplex(st, None, list(range(p2.HOST_MAX + 1)), 0, 0, 1)
    with pytest.raises(ValueError):
        p2.duplex(st, None, [], 0, 0, 1, 31)
    with pytest.raises(K.KernelError):
        p2.duplex(st, rand(4).to(torch.int32), [], 0, 0, 1)
    for bits in (0, 31, 32):
        with pytest.raises(ValueError):
            p2.grind(st, 0, bits)
    with pytest.raises(ValueError):
        p2.grind(st, 8, 5)
    from swirl_torch.prover.device_transcript import DeviceTranscript

    with pytest.raises(ValueError):
        DeviceTranscript("cuda").grind(31)


def test_device_transcript_on_the_card_matches_the_cpu(rand):
    """One schedule of every event on both devices: equal samples and
    exit states (the CPU runs the plain versions)."""
    from swirl_torch.prover.device_transcript import DeviceTranscript

    vec = rand(37)
    outs = []
    for device in ("cuda", "cpu"):
        t = DeviceTranscript(device)
        got = []
        t.observe(5)
        t.observe_slice(vec.to(device))
        got.append(t.sample_ext())
        t.observe(7)
        got += [t.sample(), t.sample_ext(), t.sample_bits(9)]
        got.append(t.grind(6))
        got.append(t.sample_bits_batch(11, 21))
        t.observe_ext(vec[:4].to(device))
        t.check_witness(3, torch.tensor(12, device=device))
        got.append(t.sample_ext())
        h = t.to_host()
        outs.append(([g.cpu() for g in got], h.state, h.absorb_idx, h.sample_idx))
    (a, sa, ia, ja), (b, sb, ib, jb) = outs
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert (sa == sb).all() and (ia, ja) == (ib, jb)


def test_golden_proof_on_a_device_transcript_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from swirl_torch.codec import encode_proof
    from swirl_torch.engine import StarkEngine
    from swirl_torch.prover.device_transcript import DeviceTranscript
    from swirl_torch.testing.golden import golden_cases, paths_for

    params, airs, ctxs = golden_cases()["interactions"]()
    _, proof = StarkEngine(params, device="cuda").run_test(airs, ctxs, DeviceTranscript("cuda"))
    with open(paths_for("interactions")["proof"], "rb") as f:
        assert encode_proof(proof) == f.read()


def test_outer_golden_case_on_the_card():
    """The BN254 outer scheme's golden case with its traces, BabyBear
    stages, Merkle trees (kernels H and I) and grinds (kernel J) on the
    card, its sponge on the host: the transcript's events and the vk
    pre-hash equal ``tests/golden``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from swirl_torch.engine import StarkEngine
    from swirl_torch.testing.golden import (
        CASE_SCHEME, encode_transcript_log, golden_cases, paths_for, pre_hash_hex)

    params, airs, ctxs = golden_cases()["outer"]()
    eng = StarkEngine(params, hash_scheme=CASE_SCHEME["outer"], device="cuda")
    transcript = eng.scheme.new_transcript(record=True, device=eng.device)
    before = [k.launches for k in (K.BN254_MERKLE, K.BN254_LEAVES, K.BN254_GRIND)]
    vk, _ = eng.run_test(airs, ctxs, transcript)
    after = [k.launches for k in (K.BN254_MERKLE, K.BN254_LEAVES, K.BN254_GRIND)]
    assert all(a > b for a, b in zip(after, before))
    paths = paths_for("outer")
    with open(paths["transcript"], "rb") as f:
        assert encode_transcript_log(transcript.log) == f.read()
    with open(paths["prehash"]) as f:
        assert pre_hash_hex(vk.pre_hash) == f.read().strip()


@pytest.mark.parametrize("on_card", [False, True])
def test_segmented_round0_on_the_card_matches_the_cpu(monkeypatch, on_card):
    """Round 0's grids in 8 row segments (threshold lowered to 2^3 chunks)
    on the card, on the host and the device transcript, give the CPU's
    full-grid proof."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from swirl_torch.codec import encode_proof
    from swirl_torch.engine import StarkEngine
    from swirl_torch.prover import logup_zerocheck
    from swirl_torch.prover.backend import ProverConfig
    from swirl_torch.prover.device_transcript import DeviceTranscript
    from swirl_torch.testing.golden import golden_cases

    monkeypatch.setattr(logup_zerocheck, "_SAVE_MEMORY_MIN_CHUNKS_LOG", 3)
    params, airs, ctxs = golden_cases()["fib"]()
    _, want = StarkEngine(params, ProverConfig(zerocheck_save_memory=False), device="cpu").run_test(airs, ctxs)
    eng = StarkEngine(params, ProverConfig(zerocheck_save_memory=True), device="cuda")
    _, got = eng.run_test(airs, ctxs, DeviceTranscript("cuda") if on_card else None)
    assert encode_proof(got) == encode_proof(want)


# -- the BN254 outer scheme's kernels G-J -------------------------------------


def _bn_rand(gen, n):
    """(n, 8) int32 words of values below P (the top word below P's)."""
    from swirl_torch.fields import bn254 as fb

    w = torch.randint(-(1 << 31), 1 << 31, (n, 8), generator=gen, device="cuda", dtype=torch.int32)
    w[:, 7] = torch.randint(0, 0x30644E72, (n,), generator=gen, device="cuda", dtype=torch.int32)
    return w


@pytest.fixture
def bn_gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(7)
    return gen


@pytest.mark.parametrize("op", ["add", "sub", "mont_mul", "from_canonical", "to_canonical", "dbl"])
@pytest.mark.parametrize("n", [1, 129, 1 << 16])
def test_bn254_field_kernel_matches_plain(bn_gen, op, n):
    from swirl_torch.fields import bn254 as fb

    a, b = _bn_rand(bn_gen, n), _bn_rand(bn_gen, n)
    edges = fb.tensor(np.stack([fb.limbs_from_int(v) for v in (0, 1, fb.P - 1, fb.P)]), "cuda")
    a = torch.cat([a, edges.repeat_interleave(4, 0)])
    b = torch.cat([b, edges.repeat(4, 1)])
    before = K.BN254_FIELD.launches
    got = getattr(fb, op)(a, b) if op in ("add", "sub", "mont_mul") else getattr(fb, op)(a)
    assert K.BN254_FIELD.launches == before + 1
    want = fb.op_plain(op, a, b if op in ("add", "sub", "mont_mul") else None)
    assert torch.equal(got, want)


@pytest.mark.parametrize("t", [2, 3])
def test_bn254_permute_kernel_matches_plain(bn_gen, t):
    from swirl_torch.hash import bn254_poseidon2 as bp

    state = _bn_rand(bn_gen, 300 * t).reshape(300, t, 8)
    assert torch.equal(bp.permute_dev(state, t), bp.permute_plain(state, t))


@pytest.mark.parametrize("n,stride", [(2, 1), (64, 1), (64, 4), (64, 32), (1 << 12, 1 << 8), (1 << 16, 1 << 15)])
def test_bn254_compress_kernel_matches_plain(bn_gen, n, stride):
    from swirl_torch.fields import bn254 as fb
    from swirl_torch.hash import bn254_poseidon2 as bp

    layer = fb.to_canonical(_bn_rand(bn_gen, n))
    assert torch.equal(bp.compress_layer(layer, stride), bp.compress_layer_plain(layer, stride))


@pytest.mark.parametrize("shape", [(1, 300), (4, 257), (7, 128), (8, 128), (9, 128), (16, 64), (17, 64),
                                   (32, 200), (33, 65), (1, 256, 4), (3, 100, 4), (2, 64, 2)])
def test_bn254_hash_rows_kernel_matches_plain(rand, shape):
    from swirl_torch.hash import bn254_poseidon2 as bp

    mat = rand(*shape)
    mat.view(-1)[:7] = P - 1
    before = K.BN254_LEAVES.launches
    got = bp.hash_rows(mat)
    assert K.BN254_LEAVES.launches == before + 1
    assert torch.equal(got, bp.hash_rows_plain(mat))


@pytest.mark.parametrize("ext,rows_per_query", [(False, 16), (True, 16), (False, 1)])
def test_bn254_device_tree_matches_host_tree(rand, ext, rows_per_query):
    from swirl_torch.hash import scheme as sc

    mat = rand(*((1, 256, 4) if ext else (5, 256)))
    tree = sc.DeviceBn254Tree(mat, rows_per_query, ext)
    s = sc.Bn254OuterScheme
    host = sc.build_host_tree(mat.cpu().numpy().astype(np.uint64), rows_per_query, ext, s.hash_slice, s.compress)
    assert tree.root == host.root
    idx = [0, 3, host.query_stride - 1, 5, 3]
    assert tree.batch_query_proofs_arr(torch.tensor(idx, device="cuda")) == host.batch_query_proofs(idx)


@pytest.mark.parametrize("a,k,bits", [(a, k, b) for a in (0, 1) for k in range(8) for b in (1, 7)] + [(0, 3, 15)])
def test_bn254_grind_kernel_matches_plain(bn_gen, a, k, bits):
    from swirl_torch.fields import bn254 as fb
    from swirl_torch.hash import bn254_poseidon2 as bp
    from swirl_torch.hash.multi_field import pack_felts

    st = fb.to_canonical(_bn_rand(bn_gen, 3))
    felts = torch.randint(0, P, (k,), generator=bn_gen, device="cuda").tolist()
    pending = fb.from_ints([pack_felts(felts)[0] if k else 0], "cuda")
    state = torch.cat([st, pending])
    before = K.BN254_GRIND.launches
    w = bp.grind(state, a, 31 * k, bits)
    assert K.BN254_GRIND.launches == before + 1
    assert w == bp.grind_plain(state, a, 31 * k, bits) >= 0
    assert bp.grind(state, a, 31 * k, bits, end=w) == -1 == bp.grind_plain(state, a, 31 * k, bits, end=w)


@pytest.mark.parametrize("a,k", [(a, k) for a in (0, 1) for k in range(8)])
def test_bn254_grind_kernel_witness_is_the_least_at_20_bits(bn_gen, a, k):
    """At the query phase's 20 bits the search spans many sweeps: the
    witness passes the host transcript's check, and a search of [0, w)
    finds nothing."""
    from swirl_torch.fields import bn254 as fb
    from swirl_torch.hash import bn254_poseidon2 as bp
    from swirl_torch.hash.multi_field import MultiFieldTranscript, pack_felts

    lanes = fb.to_ints(fb.to_canonical(_bn_rand(bn_gen, 3)))
    felts = torch.randint(0, P, (k,), generator=bn_gen, device="cuda").tolist()
    state = fb.from_ints([*lanes, pack_felts(felts)[0] if k else 0], "cuda")
    w = bp.grind(state, a, 31 * k, 20)
    t = MultiFieldTranscript()
    t._sponge.state, t._sponge.absorb_idx, t._sponge.sample_idx = list(lanes), a, 2
    t._obs_buf = list(felts)
    assert w >= 0 and t.check_witness(20, w)
    assert bp.grind(state, a, 31 * k, 20, end=w) == -1
    # the by-value entry the outer transcript calls
    pending = pack_felts(felts)[0] if k else 0
    assert bp.grind_ints(lanes, pending, a, 31 * k, 20, device="cuda") == w
    assert bp.grind_ints(lanes, pending, a, 31 * k, 20, end=w, device="cuda") == -1


@pytest.mark.parametrize("a,k,bits", [(a, k, b) for a in (0, 1) for k in range(8) for b in (5, 15, 18)])
def test_bn254_grind_kernel_at_every_cursor(bn_gen, a, k, bits):
    """Kernel J by value from every cursor at the folding, mu and logup
    grinds' bits: the plain search's witness (at 18 bits the plain search on
    [0, w], whose least hit is the whole search's), one launch a call."""
    from swirl_torch.fields import bn254 as fb
    from swirl_torch.hash import bn254_poseidon2 as bp
    from swirl_torch.hash.multi_field import pack_felts

    lanes = fb.to_ints(fb.to_canonical(_bn_rand(bn_gen, 3)))
    felts = torch.randint(0, P, (k,), generator=bn_gen, device="cuda").tolist()
    pending = pack_felts(felts)[0] if k else 0
    before = K.BN254_GRIND.launches
    w = bp.grind_ints(lanes, pending, a, 31 * k, bits, device="cuda")
    assert K.BN254_GRIND.launches == before + 1
    state = fb.from_ints([*lanes, pending], "cuda")
    assert w >= 0 and bp.grind_plain(state, a, 31 * k, bits, end=w + 1 if bits == 18 else None) == w


# Edge operands of the redesigned core (csrc/bn254.cuh: 2^52 limbs, products
# on the FP64 pipe, lanes unreduced between products): the largest values
# and zeros, where a limb or a column sum is at its bound.


@pytest.mark.parametrize("fill", ["zero", "p_minus_1", "alternating"])
@pytest.mark.parametrize("stride", [1, 2, "half"])
def test_bn254_compress_kernel_on_edge_digests(bn_gen, fill, stride):
    from swirl_torch.fields import bn254 as fb
    from swirl_torch.hash import bn254_poseidon2 as bp

    n = 512
    stride = n // 2 if stride == "half" else stride
    vals = {"zero": [0] * n, "p_minus_1": [fb.P - 1] * n, "alternating": [0, fb.P - 1] * (n // 2)}[fill]
    layer = fb.from_ints(vals, "cuda")
    assert torch.equal(bp.compress_layer(layer, stride), bp.compress_layer_plain(layer, stride))


@pytest.mark.parametrize("shape", [(1, 130), (8, 130), (9, 130), (16, 130), (17, 130), (32, 130), (33, 130),
                                   (3, 100, 4), (8, 64, 4), (9, 64, 4)])
def test_bn254_hash_rows_kernel_on_edge_felts(shape):
    """Codewords of BabyBear P - 1 everywhere, and (w, h, 4) ones read in place."""
    from swirl_torch.hash import bn254_poseidon2 as bp

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    mat = torch.full(shape, P - 1, dtype=torch.int64, device="cuda")
    assert torch.equal(bp.hash_rows(mat), bp.hash_rows_plain(mat))


def test_bn254_device_tree_root_at_16_rows_a_query_on_edge_felts(rand):
    """A tree with strided levels at a query stride of 2^10 and levels above
    it: its root and openings equal the host tree's."""
    from swirl_torch.hash import scheme as sc

    mat = rand(3, 1 << 14)
    mat[:, ::3] = P - 1
    tree = sc.DeviceBn254Tree(mat, 16, False)
    s = sc.Bn254OuterScheme
    host = sc.build_host_tree(mat.cpu().numpy().astype(np.uint64), 16, False, s.hash_slice, s.compress)
    assert tree.root == host.root
    idx = [0, 1, host.query_stride - 1, 77]
    assert tree.batch_query_proofs_arr(torch.tensor(idx, device="cuda")) == host.batch_query_proofs(idx)


def test_bn254_mont_mul_edges_through_the_new_core(bn_gen):
    """Kernel G's product (x (16 y) / 2^260 on the FP64 core) and the
    conversions on every pair of edge values, against plain."""
    from swirl_torch.fields import bn254 as fb

    r = (1 << 256) % fb.P
    vals = [0, 1, 2, fb.P - 2, fb.P - 1, fb.P, r, fb.P - r, (1 << 255) % fb.P, fb.P >> 1]
    e = fb.from_ints(vals, "cuda")
    a = e.repeat_interleave(len(vals), 0).contiguous()
    b = e.repeat(len(vals), 1).contiguous()
    assert torch.equal(fb.mont_mul(a, b), fb.op_plain("mont_mul", a, b))
    for op in ("from_canonical", "to_canonical"):
        assert torch.equal(getattr(fb, op)(e), fb.op_plain(op, e))


def test_bn254_kernels_refuse_bad_operands(bn_gen):
    from swirl_torch.hash import bn254_poseidon2 as bp

    layer = _bn_rand(bn_gen, 64)
    with pytest.raises(K.KernelError):
        bp.compress_layer(layer.to(torch.int64), 1)
    with pytest.raises(K.KernelError):
        bp.compress_layer(layer.view(-1)[2:258].reshape(32, 8), 1)  # rows 8 bytes off alignment
    with pytest.raises(ValueError):
        bp.compress_layer(layer, 64)


# ---- the fused prover (prover/fused.py): captured proves on the card ----


def _fused_case(name, edit=None):
    """(engine, dpk, ctx) of a golden case on the card, its common traces
    changed by ``edit(index, trace)`` when given."""
    from swirl_torch.engine import StarkEngine
    from swirl_torch.prover.backend import ProvingContext
    from swirl_torch.testing.golden import golden_cases

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    params, airs, ctxs = golden_cases()[name]()
    eng = StarkEngine(params, device="cuda")
    pk, _ = eng.keygen(airs)
    rows = [np.array(cm, dtype=np.uint64) for cm, _, _ in ctxs]
    if edit is not None:
        rows = [edit(i, r) for i, r in enumerate(rows)]
    ctx = ProvingContext([eng.context_for(i, r, pvs, cached) for i, (r, (_, pvs, cached)) in enumerate(zip(rows, ctxs))])
    return eng, eng.transport_pk(pk), ctx


def _other_trace(name):
    """A second trace of the case's shape and public values: fib with one
    inner cell changed (the prover does not check constraints), the
    receiver's rows of ``interactions`` in another order (still balanced)."""
    def edit(i, rows):
        rows = rows.copy()
        if name == "fib":
            rows[5, 0] = (rows[5, 0] + 1) % P
        elif i == 1:
            rows[[0, 2]] = rows[[2, 0]]
        return rows

    return edit


@pytest.mark.parametrize("mode", ["segmented", "jit"])
@pytest.mark.parametrize("case", ["fib", "interactions"])
def test_fused_prove_on_the_card_replays_golden_bytes(case, mode):
    """Captured at the first call, the golden bytes; a replay on another
    trace of the shape gives that trace's device-transcript bytes through
    the same graphs, and leaves the first proof as it was."""
    from swirl_torch.codec import encode_proof
    from swirl_torch.prover import fused
    from swirl_torch.prover.device_transcript import DeviceTranscript
    from swirl_torch.testing.golden import paths_for

    eng, dpk, ctx = _fused_case(case)
    with open(paths_for(case)["proof"], "rb") as f:
        want = f.read()
    first = fused.prove_fused(eng.backend, dpk, ctx, mode=mode)
    assert encode_proof(first) == want
    _, _, other = _fused_case(case, _other_trace(case))
    other_want = encode_proof(eng.prove(dpk, other, DeviceTranscript("cuda")))
    assert other_want != want
    entry = next(iter(dpk._fused_cache.values()))
    assert encode_proof(fused.prove_fused(eng.backend, dpk, other, mode=mode)) == other_want
    assert len(dpk._fused_cache) == 1 and next(iter(dpk._fused_cache.values())) is entry
    assert encode_proof(first) == want
    fused.release_fused(dpk)
    assert not hasattr(dpk, "_fused_cache")


def test_fused_replay_on_a_fresh_context_of_a_cached_trace():
    """``cached_preprocessed`` captured, then its context dropped and the
    freed blocks filled with other values: a fresh ``context_for`` of the
    same cached trace hits the entry and replays to the golden bytes (the
    graphs read their own copies of the cached mains)."""
    from swirl_torch.codec import encode_proof
    from swirl_torch.prover import fused
    from swirl_torch.prover.backend import ProvingContext
    from swirl_torch.prover.device_transcript import DeviceTranscript
    from swirl_torch.testing.golden import golden_cases, paths_for

    eng, dpk, ctx = _fused_case("cached_preprocessed")
    with open(paths_for("cached_preprocessed")["proof"], "rb") as f:
        want = f.read()
    assert encode_proof(fused.prove_fused(eng.backend, dpk, ctx, mode="segmented")) == want
    entry = next(iter(dpk._fused_cache.values()))
    freed = fused.cached_tensors([tc.cached_mains for _, tc in ctx.per_trace])
    freed += [tc.common_main for _, tc in ctx.per_trace]
    shapes = [(t.shape, t.dtype) for t in freed]
    del ctx, freed
    junk = [torch.full(shape, 12345, dtype=dtype, device="cuda") for shape, dtype in shapes]
    ctxs = golden_cases()["cached_preprocessed"]()[2]
    fresh = ProvingContext([eng.context_for(i, *c) for i, c in enumerate(ctxs)])
    assert encode_proof(eng.prove(dpk, fresh, DeviceTranscript("cuda"))) == want
    assert encode_proof(fused.prove_fused(eng.backend, dpk, fresh, mode="segmented")) == want
    assert next(iter(dpk._fused_cache.values())) is entry and len(junk) == len(shapes)
    fused.release_fused(dpk)


def test_fused_capture_failure_raises_without_an_eager_fallback(monkeypatch):
    """A segment that fails while it is captured: ProverError, nothing
    cached, and no eager prove in its place (the warm-up was the only one)."""
    from swirl_torch.prover import fused
    from swirl_torch.prover.errors import ProverError

    eng, dpk, ctx = _fused_case("fib")
    plain_stacking, plain_run = fused._Prove.stacking, fused.run_segments
    eager_runs = []

    def stacking(self):
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("a segment failed while capturing")
        return plain_stacking(self)

    def run_segments(*args, **kwargs):
        eager_runs.append(1)
        return plain_run(*args, **kwargs)

    monkeypatch.setattr(fused._Prove, "stacking", stacking)
    monkeypatch.setattr(fused, "run_segments", run_segments)
    with pytest.raises(ProverError, match="capture failed"):
        fused.prove_fused(eng.backend, dpk, ctx, mode="segmented")
    assert not getattr(dpk, "_fused_cache", {}) and len(eager_runs) == 1


@pytest.mark.parametrize("mode", ["segmented", "jit", "eager"])
def test_fused_segment_timings_on_the_card(monkeypatch, mode):
    """The segments' events, recorded by graph nodes on a replay (eagerly in
    ``eager``), give five positive device times whose sum and the gap come
    to the first start to the last end; the RAP stage's two segments fit in
    its span, which ends in a sync; each graph's nodes are counted."""
    from swirl_torch import metrics
    from swirl_torch.prover import fused

    eng, dpk, ctx = _fused_case("interactions")
    seen = []
    timings = fused.segment_timings

    def recorded(times):
        seen.append(times)
        return timings(times)

    monkeypatch.setattr(fused, "segment_timings", recorded)
    fused.prove_fused(eng.backend, dpk, ctx, mode=mode)
    assert not seen  # no collector, no reading
    with metrics.run_with_metric_collection() as c:
        fused.prove_fused(eng.backend, dpk, ctx, mode=mode)
    snap = c.snapshot()
    (times,) = seen
    device = [snap[f"{name}.device_time_ms"] for name, _ in fused.SEGMENTS]
    assert all(ms > 0 for ms in device)
    first, last = times["commit"][0], times["whir"][1]
    assert sum(device) + snap["segments.gap.device_time_ms"] == pytest.approx(last - first, rel=1e-9)
    assert snap["segments.gap.device_time_ms"] >= -1e-3  # events resolve to about 0.5 us
    if mode == "eager":
        assert "fused.launch_time_ms" not in snap and not getattr(dpk, "_fused_cache", {})
        return
    entry = next(iter(dpk._fused_cache.values()))
    assert fused.read_events(entry.events) == times
    nodes = entry.stats["nodes"]
    names = [name for name, _ in fused.SEGMENTS]
    assert list(nodes) == (names if mode == "segmented" else ["+".join(names)])
    assert all(isinstance(n, int) and n > 2 for n in nodes.values())
    assert {"fused.launch_time_ms", "fused.refresh_time_ms", "proof_fetch_time_ms", "proof_build_time_ms"} <= set(snap)
    if mode == "segmented":
        assert snap["gkr.device_time_ms"] + snap["batch.device_time_ms"] <= snap["prove_rap_constraints_time_ms"]
    fused.release_fused(dpk)


def _leaf_case():
    """(engine, dpk, ctx) of a small leaf-shaped prove on the card: the leaf
    preset at a stacked height of 2^16 (rate 1/4, two WHIR rounds) over a
    2^12 x 16 degree-4 SyntheticAir with interactions, on a seeded trace
    whose kill column is zero."""
    from swirl_torch.engine import StarkEngine
    from swirl_torch.params import leaf_params_with_100_bits_security
    from swirl_torch.prover.backend import ProvingContext
    from swirl_torch.testing import synthetic

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    air = synthetic.SyntheticAir(synthetic.uniform_shape(12, 16, num_constraints=4, num_interactions=2, degree=4))
    eng = StarkEngine(leaf_params_with_100_bits_security(16), device="cuda")
    pk, _ = eng.keygen([air])
    gen = torch.Generator(device="cuda")
    gen.manual_seed(24)
    trace = torch.randint(0, P, (air.common_main_width(), 1 << 12), generator=gen, device="cuda", dtype=torch.int64)
    trace[0] = 0
    return eng, eng.transport_pk(pk), ProvingContext([eng.context_for(0, trace)])


@pytest.mark.parametrize("mode", ["segmented", "jit", "eager"])
def test_fused_encode_and_merkle_timings_on_the_card(mode):
    """A leaf-shaped prove replayed (or run eagerly): each RS encode and
    Merkle build of the prove is one interval of its own (the main commit's
    and the WHIR codeword's), both timings are positive and fit in the
    commit and WHIR segments, and the proof's bytes are those of a prove
    with no timing events (``Coordinator.prove``)."""
    from swirl_torch import metrics
    from swirl_torch.codec import encode_proof
    from swirl_torch.prover import fused
    from swirl_torch.prover.stacked_pcs import ENCODE_TIMING, MERKLE_TIMING

    eng, dpk, ctx = _leaf_case()
    plain = encode_proof(eng.prove(dpk, ctx))
    fused.prove_fused(eng.backend, dpk, ctx, mode=mode)
    with metrics.run_with_metric_collection() as c:
        proof = fused.prove_fused(eng.backend, dpk, ctx, mode=mode)
    snap = c.snapshot()
    encode, merkle = snap[f"{ENCODE_TIMING}_time_ms"], snap[f"{MERKLE_TIMING}_time_ms"]
    assert encode > 0 and merkle > 0
    assert encode + merkle <= snap["commit.device_time_ms"] + snap["whir.device_time_ms"]
    assert encode_proof(proof) == plain
    if mode != "eager":
        entry = next(iter(dpk._fused_cache.values()))
        names = [name for name, _, _ in entry.intervals]
        codewords = dpk.params.whir.num_whir_rounds() - 1
        assert codewords == 1 and names.count(ENCODE_TIMING) == names.count(MERKLE_TIMING) == 1 + codewords
    fused.release_fused(dpk)


def test_captures_own_their_tower_tickets(rand):
    """Kernel D's ticket counter of a captured prove (and of a captured
    commit) is the entry's own: torch hands out pooled streams round robin,
    so the handle of a stream held alive recurs among the next ones, and a
    counter keyed by the capture stream's handle would be shared with an
    eager D on that handle while a replay runs. The entries' counters are
    no stream's, and zero after a replay."""
    from swirl_torch.prover import commit_kernel as ck
    from swirl_torch.prover import fused

    held = torch.cuda.Stream()
    assert held.cuda_stream in {torch.cuda.Stream().cuda_stream for _ in range(64)}
    eng, dpk, ctx = _fused_case("fib")
    fused.prove_fused(eng.backend, dpk, ctx, mode="segmented")
    entry = next(iter(dpk._fused_cache.values()))
    ck.release_graphs()
    ck.commit_kernel(2, 1, 3, rand(4, 1 << 12))
    owned = [entry.tickets, next(iter(ck._GRAPHS.values())).tickets]
    shared = {t.tower.data_ptr() for t in K._TICKETS.values()}
    assert all(t.dtype == torch.int32 and t.numel() == 1 and t.data_ptr() not in shared for t in owned)
    fused.prove_fused(eng.backend, dpk, ctx, mode="segmented")
    ck.commit_kernel(2, 1, 3, rand(4, 1 << 12))
    torch.cuda.synchronize()
    assert [int(t.item()) for t in owned] == [0, 0]
    fused.release_fused(dpk)
    ck.release_graphs()


def test_fused_prove_on_a_world_of_one_mesh():
    """``prove_fused(mesh=proof_mesh())``, NCCL, a world of one: the graphs
    capture the commits' collectives and replay to the golden bytes (a
    replay issues no collective from Python); a gloo mesh of CUDA tensors
    is refused by the graph modes, and eager refuses any mesh."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from swirl_torch.codec import encode_proof
    from swirl_torch.parallel import multihost, sharded
    from swirl_torch.prover import fused
    from swirl_torch.prover.errors import ProverError
    from swirl_torch.testing.golden import paths_for

    eng, dpk, ctx = _fused_case("fib")
    with open(paths_for("fib")["proof"], "rb") as f:
        want = f.read()
    mesh = multihost.proof_mesh()
    assert dist.get_backend(mesh.get_group()) == "nccl" and mesh.size() == 1
    for mode in ("segmented", "jit"):
        sharded.reset_collective_counts()
        assert encode_proof(fused.prove_fused(eng.backend, dpk, ctx, mode=mode, mesh=mesh)) == want
        counts = sharded.collective_counts()
        assert counts["all_gather"] >= 2
        assert encode_proof(fused.prove_fused(eng.backend, dpk, ctx, mode=mode, mesh=mesh)) == want
        assert sharded.collective_counts() == counts
        assert next(iter(dpk._fused_cache))[3] is not None  # the mesh is in the key
        fused.release_fused(dpk)
    gloo = DeviceMesh.from_group(dist.new_group([0], backend="gloo"), "cuda", mesh_dim_names=("rows",))
    with pytest.raises(ProverError, match="cannot be captured"):
        fused.prove_fused(eng.backend, dpk, ctx, mode="segmented", mesh=gloo)
    with pytest.raises(ValueError, match="mesh sharding requires"):
        fused.prove_fused(eng.backend, dpk, ctx, mode="eager", mesh=mesh)


# -- kernel K: GKR's layer sumcheck, a pass a sub-round ---------------------------


def _gkr_pass_case(rand, m: int):
    """Source columns of 2m entries (the four p/q columns as the stride-2
    views of a layer's (4m, 4) p and q, as a layer's second pass reads
    them), and r, lam as device tensors."""
    p, q = rand(4 * m, 4), rand(4 * m, 4)
    cols = [rand(2 * m, 4), p[0::2], q[0::2], p[1::2], q[1::2]]
    return cols, rand(4), rand(4)


def _assert_pass_equal(got, want) -> None:
    (a, ea), (b, eb) = got, want
    if ea is None:
        assert eb is None and torch.equal(a, b)
        return
    assert torch.equal(ea, eb) and len(a) == len(b) == 5 and all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("log_m", [0, 1, 7, 12, 16, 17, 22])
def test_gkr_round_kernel_matches_plain(rand, log_m):
    """Each kind of pass at column length m, on both sides of the one-block
    boundary: the fold from 2m entries (the layer's stride-2 views) with the
    next evaluation, the first pass's evaluation of m entries, and at m = 1
    the last pass's claims; r and lam are device tensors."""
    from swirl_torch.prover import gkr

    m = 1 << log_m
    cols, r, lam = _gkr_pass_case(rand, m)
    before = K.GKR_ROUND.launches
    if m == 1:
        _assert_pass_equal(gkr.gkr_round(cols, r), gkr.gkr_round_plain(cols, r))
        assert K.GKR_ROUND.launches == before + 1
        return
    _assert_pass_equal(gkr.gkr_round(cols, r, lam), gkr.gkr_round_plain(cols, r, lam))
    layer, _, _ = _gkr_pass_case(rand, m // 2)  # m entries: a layer's first pass
    _assert_pass_equal(gkr.gkr_round(layer, None, lam), gkr.gkr_round_plain(layer, None, lam))
    compact = [c.contiguous() for c in layer]
    _assert_pass_equal(gkr.gkr_round(compact, None, lam), gkr.gkr_round_plain(compact, None, lam))
    assert K.GKR_ROUND.launches == before + 3
    torch.cuda.synchronize()
    assert K.tickets(r.device).gkr.tolist() == [0]


def test_gkr_round_kernel_on_the_largest_values():
    """Every entry and challenge P - 1, one block and many."""
    from swirl_torch.prover import gkr

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for m in (8, 1 << 14):
        cols = [torch.full((2 * m, 4), P - 1, dtype=torch.int64, device="cuda") for _ in range(5)]
        r = lam = torch.full((4,), P - 1, dtype=torch.int64, device="cuda")
        _assert_pass_equal(gkr.gkr_round(cols, r, lam), gkr.gkr_round_plain(cols, r, lam))


@pytest.mark.parametrize("n", [1, 2, 3, 10, 22])
def test_gkr_eq_kernel_matches_eq_hypercube(rand, n):
    from swirl_torch.prover import gkr
    from swirl_torch.prover.sumcheck import eq_hypercube

    xi = rand(n, 4)
    assert torch.equal(gkr.gkr_eq(xi), eq_hypercube(xi, xi.device))


def test_gkr_round_kernel_replays_in_a_cuda_graph(rand):
    """A pass captured at m = 2^16 (many blocks, the ticket) and the
    layer's last pass, replayed on new columns and new r and lam: each
    replay bit-equal to the plain version on its inputs, the capture's
    ticket zero after it."""
    from swirl_torch.prover import gkr

    m = 1 << 16
    cols, r, lam = _gkr_pass_case(rand, m)
    tail, tail_r = [rand(2, 4) for _ in range(5)], rand(4)
    gkr.gkr_round(cols, r, lam)  # the library, before any capture
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with K.private_tickets(r.device) as own:
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=stream):
            got = gkr.gkr_round(cols, r, lam)
            claims = gkr.gkr_round(tail, tail_r)
    for _ in range(2):
        for t in (*cols, r, lam, *tail, tail_r):
            t.copy_(rand(*t.shape))
        graph.replay()
        torch.cuda.synchronize()
        _assert_pass_equal(got, gkr.gkr_round_plain(cols, r, lam))
        _assert_pass_equal(claims, gkr.gkr_round_plain(tail, tail_r))
        assert own.gkr.tolist() == [0]


def test_gkr_round_captures_own_their_tickets(rand):
    """Two captured passes each take their capture's ticket counter, neither
    a stream's: replayed in turns, both stay bit-equal and both counters
    zero."""
    from swirl_torch.prover import gkr

    cases, owned = [], []
    for log_m in (15, 17):
        cols, r, lam = _gkr_pass_case(rand, 1 << log_m)
        gkr.gkr_round(cols, r, lam)
        stream = torch.cuda.Stream()
        stream.wait_stream(torch.cuda.current_stream())
        with K.private_tickets(r.device) as own:
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, stream=stream):
                got = gkr.gkr_round(cols, r, lam)
        cases.append((graph, got, cols, r, lam))
        owned.append(own.gkr)
    shared = {t.gkr.data_ptr() for t in K._TICKETS.values()}
    assert len({t.data_ptr() for t in owned}) == 2 and not shared & {t.data_ptr() for t in owned}
    for _ in range(2):
        for graph, *_ in cases:
            graph.replay()
    torch.cuda.synchronize()
    for _, got, cols, r, lam in cases:
        _assert_pass_equal(got, gkr.gkr_round_plain(cols, r, lam))
    assert [t.tolist() for t in owned] == [[0], [0]]


def test_fractional_sumcheck_on_the_card_matches_the_cpu():
    """2^14 fractions on a device transcript on the card and on the CPU:
    equal claims, round polynomials, point and sponge state; every layer
    through kernel K (an eq table, a pass a sub-round and the last fold),
    every sub-round counted."""
    from swirl_torch import metrics
    from swirl_torch.fields import field as F
    from swirl_torch.prover.device_transcript import DeviceTranscript
    from swirl_torch.prover.gkr import fractional_sumcheck

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(14)
    t = 14
    p = np.zeros((1 << t, 4), np.uint64)
    p[:, 0] = rng.integers(0, P, 1 << t, dtype=np.uint64)
    q = rng.integers(0, P, (1 << t, 4), dtype=np.uint64)
    outs = []
    for device in ("cuda", "cpu"):
        dt = DeviceTranscript(device)
        before = K.GKR_ROUND.launches
        with metrics.run_with_metric_collection() as c:
            res = fractional_sumcheck(dt, F.const_arr(p, device), F.const_arr(q, device), assert_zero=False)
        launches = K.GKR_ROUND.launches - before
        h = dt.to_host()
        outs.append((res, h.state, launches, c.snapshot()["gkr_kernel_subrounds"]))
    (a, sa, la, ka), (b, sb, lb, kb) = outs
    subrounds = t * (t - 1) // 2
    assert (la, ka, lb, kb) == (subrounds + 2 * (t - 1), subrounds, 0, 0)
    assert np.array_equal(sa, sb)
    assert np.array_equal(F.to_host(a.xi), F.to_host(b.xi))
    assert all(np.array_equal(x, y) for la_, lb_ in zip(a.sumcheck_polys, b.sumcheck_polys) for x, y in zip(la_, lb_))
    assert len(a.claims_per_layer) == t
    for x, y in zip(a.claims_per_layer, b.claims_per_layer):
        assert all(np.array_equal(getattr(x, f), getattr(y, f)) for f in ("p_xi_0", "p_xi_1", "q_xi_0", "q_xi_1"))
    assert np.array_equal(a.fractional_sum[0], b.fractional_sum[0])
    assert np.array_equal(a.fractional_sum[1], b.fractional_sum[1])


def test_gkr_round_kernel_refuses_bad_operands(rand):
    from swirl_torch.prover import gkr

    cols, r, lam = _gkr_pass_case(rand, 4)
    with pytest.raises(K.KernelError):
        gkr.gkr_round(cols[:1] + [c[::2] for c in cols[1:]], r, lam)  # eq of 8 entries, the others of 4
    with pytest.raises(K.KernelError):
        gkr.gkr_round(cols, r)  # the last pass takes 2 entries
    with pytest.raises(K.KernelError):
        gkr.gkr_round(cols, r.to(torch.int32), lam)
    with pytest.raises(K.KernelError):
        gkr.gkr_eq(rand(31, 4))


# -- kernel L: the batch sumcheck's EF4 product and product-and-sum ------------


def _full(shape, v=P - 1):
    return torch.full(shape, v, dtype=torch.int64, device="cuda")


def _ef4_mul_cases(rand):
    """(label, a, b) at the batch phase's shapes: the largest level group of
    the app's multilinear rounds against its equal operand, a table by a
    (4,) challenge, (k, 1, 4) weights against (k, rows, 4), interp_mle_at_int's
    stride-2 views at X = 1, one row, no row, and every value P - 1."""
    big = rand(3, 2 << 15, 4)
    return [
        ("level group (187, 2^15)", rand(187, 1 << 15, 4), rand(187, 1 << 15, 4)),
        ("challenge (2^16, 4) x (4,)", rand(1 << 16, 4), rand(4)),
        ("weights (40, 1, 4) x (40, 2^12, 4)", rand(40, 1, 4), rand(40, 1 << 12, 4)),
        ("stride-2 (3, 2^15, 4)", big[:, 1::2], rand(3, 1 << 15, 4)),
        ("stride-2 by a challenge", big[:, 1::2], rand(4)),
        ("one row", rand(1, 4), rand(1, 4)),
        ("a point", rand(4), rand(4)),
        ("no row", rand(0, 4), rand(4)),
        ("P - 1", _full((1000, 4)), _full((1000, 4))),
    ]


def test_ef4_mul_kernel_matches_ext_mul(rand):
    """Kernel L's product bit for bit against ``F.ext_mul`` at the batch
    phase's shapes, one launch each (none for an empty product)."""
    from swirl_torch.fields import ef4
    from swirl_torch.fields import field as F

    for label, a, b in _ef4_mul_cases(rand):
        before = K.EF4.launches
        got = ef4.mul(a, b)
        want = F.ext_mul(a, b)
        assert got.is_contiguous() and torch.equal(got, want), label
        assert K.EF4.launches == before + (got.numel() > 0), label


def _ef4_sum_cases(rand):
    """(label, v, w, index, ext) at the batch phase's shapes: round 0's
    (16, 2^21) base terms gathered from the interpreter's buffer, its coset
    grid sums (2^13 chunks x 48 columns) by the eq table's segment, a
    multilinear round's eq-weighted sum (2^15 rows into one value, blocks
    over the terms), a round's constraint sum of 16 gathered (2^15, 4)
    rows, the exhausted trace's one point, one row, no term, and every value
    P - 1."""
    buf = rand(40, 1 << 21)
    rows = torch.randperm(40, device="cuda")[:16]
    return [
        ("round 0 base terms (16, 2^21)", buf, rand(16, 4), rows, False),
        ("round 0 grid (2^13, 48)", rand(1 << 13, 48, 4), rand(1 << 13, 4), None, True),
        ("eq-weighted (2^15, 4)", rand(1 << 15, 4), rand(1 << 15, 4), None, True),
        ("constraints (16 of 40, 2^15)", rand(40, 1 << 15, 4), rand(16, 4), rows, True),
        ("one point", rand(40, 1, 4), rand(16, 4), rows, True),
        ("one row", rand(1, 4), rand(1, 4), None, True),
        ("no term", rand(4, 8, 4), rand(0, 4), rows[:0], True),
        ("P - 1 (2^14, 4)", _full((1 << 14, 4)), _full((1 << 14, 4)), None, True),
        ("P - 1 base (300, 64)", _full((300, 64)), _full((300, 4)), None, False),
    ]


def test_ef4_mul_sum_kernel_matches_plain(rand):
    """Kernel L's product-and-sum bit for bit against
    ``F.ext_sum(F.ext_mul(...))`` (the base x EF4 form for base terms) at
    the batch phase's shapes; the stream's ticket zero after the sums that
    split over blocks."""
    from swirl_torch.fields import ef4

    for label, v, w, index, ext in _ef4_sum_cases(rand):
        got = ef4.mul_sum(v, w, index=index, ext=ext)
        want = ef4.mul_sum_plain(v, w, index=index, ext=ext)
        assert torch.equal(got, want), label
    torch.cuda.synchronize()
    assert K.tickets(torch.device("cuda", torch.cuda.current_device())).ef4.tolist() == [0]


def test_ef4_kernel_replays_in_a_cuda_graph(rand):
    """A product, a sum over one block and a sum over many blocks (the
    ticket) captured once and replayed on new operands, each replay
    bit-equal to the plain versions; the capture's ticket zero after it."""
    from swirl_torch.fields import ef4
    from swirl_torch.fields import field as F

    a, b = rand(64, 1 << 12, 4)[:, 1::2], rand(4)
    v, w = rand(1 << 15, 4), rand(1 << 15, 4)
    buf, rows, lam = rand(40, 1 << 14, 4), torch.randperm(40, device="cuda")[:16], rand(16, 4)
    ef4.mul_sum(v, w)  # the stream's counters, before any capture
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with K.private_tickets(v.device) as own:
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=stream):
            prod = ef4.mul(a, b)
            total = ef4.mul_sum(v, w)
            cons = ef4.mul_sum(buf, lam, index=rows)
    for _ in range(2):
        for t in (a, b, v, w, buf, lam):
            t.copy_(rand(*t.shape))
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(prod, F.ext_mul(a, b))
        assert torch.equal(total, ef4.mul_sum_plain(v, w))
        assert torch.equal(cons, ef4.mul_sum_plain(buf, lam, index=rows))
        assert own.ef4.tolist() == [0]


def test_ef4_captures_own_their_tickets(rand):
    """Two captured sums over many blocks each take their capture's ticket,
    neither a stream's: replayed in turns, both bit-equal, both counters
    zero."""
    from swirl_torch.fields import ef4

    cases, owned = [], []
    for rows in (1 << 14, 1 << 16):
        v, w = rand(rows, 4), rand(rows, 4)
        ef4.mul_sum(v, w)
        stream = torch.cuda.Stream()
        stream.wait_stream(torch.cuda.current_stream())
        with K.private_tickets(v.device) as own:
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, stream=stream):
                got = ef4.mul_sum(v, w)
        cases.append((graph, got, v, w))
        owned.append(own.ef4)
    shared = {t.ef4.data_ptr() for t in K._TICKETS.values()}
    assert len({t.data_ptr() for t in owned}) == 2 and not shared & {t.data_ptr() for t in owned}
    for _ in range(2):
        for graph, *_ in cases:
            graph.replay()
    torch.cuda.synchronize()
    for _, got, v, w in cases:
        assert torch.equal(got, ef4.mul_sum_plain(v, w))
    assert [t.tolist() for t in owned] == [[0], [0]]


def test_ef4_kernel_refuses_bad_operands(rand):
    from swirl_torch.fields import ef4

    with pytest.raises(K.KernelError):
        ef4.mul(rand(8, 4), rand(8, 4).to(torch.int32))
    with pytest.raises(K.KernelError):
        ef4.mul(rand(8, 3), rand(8, 3))
    with pytest.raises(K.KernelError):
        ef4.mul_sum(rand(8, 16, 4), rand(7, 4))  # 8 rows, 7 weights
    with pytest.raises(K.KernelError):
        ef4.mul_sum(rand(8, 16, 4), rand(2, 4), index=torch.zeros(3, dtype=torch.int64, device="cuda"))


@pytest.mark.parametrize("degree", [3, 4])
def test_fused_synthetic_proof_on_the_card_equals_the_cpu(degree):
    """A SyntheticAir of the app's shape (64 columns, 16 constraints, 8
    interactions) at degree 3 and 4, proved through ``prove_fused``
    (segmented) on the card and eagerly on the CPU: the same bytes; on the
    card the batch segment launches kernel L, and the F.ext_mul calls left
    in it are the folds, two a round (the selectors and the main trace)."""
    from swirl_torch import metrics
    from swirl_torch.codec import encode_proof
    from swirl_torch.engine import StarkEngine
    from swirl_torch.params import test_system_params_small
    from swirl_torch.prover.backend import ProvingContext
    from swirl_torch.prover.fused import prove_fused, release_fused
    from swirl_torch.testing.synthetic import SyntheticAir, uniform_shape

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    log_h, l_skip = 8, 2
    air = SyntheticAir(uniform_shape(log_h, 64, 16, 8, degree=degree))
    trace = np.random.default_rng(degree).integers(0, P, (1 << log_h, air.common_main_width()), dtype=np.uint64)
    trace[:, 0] = 0
    out = {}
    for device in ("cuda", "cpu"):
        eng = StarkEngine(test_system_params_small(l_skip, log_h, 3, max_constraint_degree=degree), device=device)
        pk, _ = eng.keygen([air])
        dpk = eng.transport_pk(pk)
        ctx = ProvingContext([eng.context_for(0, trace, [], [])])
        if device == "cuda":
            prove_fused(eng.backend, dpk, ctx, mode="segmented")  # the capture
        with metrics.run_with_metric_collection() as c:
            proof = prove_fused(eng.backend, dpk, ctx, mode="segmented")
        out[device] = (encode_proof(proof), c.snapshot())
        release_fused(dpk)
    (card, on_card), (cpu, on_cpu) = out["cuda"], out["cpu"]
    assert card == cpu
    assert on_card["batch_ef4_launches"] > 0 and on_cpu["batch_ef4_launches"] == 0
    assert on_card["batch_ef4_aten"] == on_cpu["batch_ef4_aten"] == 2 * (log_h - l_skip)
