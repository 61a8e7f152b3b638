"""The port's BN254 device library on the CPU: ``swirl_torch/fields/bn254.py``
and the device entry points of ``swirl_torch/hash/bn254_poseidon2.py`` (the
plain versions of kernels G-J) against the JAX package's
``swirl/fields/jbn254.py`` / ``swirl/hash/jbn254_poseidon2.py`` and against
the port's host BN254 modules, on inputs made from seeds with numpy.

- the field's ``add``, ``sub``, ``mont_mul``, ``from_canonical``,
  ``to_canonical`` and ``dbl`` equal ``jbn254``'s bit for bit on random,
  batched and edge operands (0, 1, P - 1, and P itself through
  ``limbs_from_int``); the JAX package holds 16 x 16-bit limbs, the port 8 x
  32-bit words of the same Monty values (R = 2^256);
- the Monty round constants equal ``_dev_constants(2)`` / ``(3)``; the
  packing equals ``pack_felts_dev``;
- the plain permutation, compress, leaf hash, Merkle layers and device tree
  equal the port's host ``permute``, ``compress2``,
  ``MultiFieldHasher.hash_slice`` and ``build_host_tree`` (which
  ``tests/test_torch_outer.py`` holds to the JAX package's);
- the plain grind returns the host loop's witness from every sponge cursor
  the prover reaches, and a transcript made with a device logs the host
  loop's events; kernel J's model (its candidate lanes, sweeps and
  sample) equals the plain search and the JAX package's host loop, its
  sweeps cover every candidate below the witness, and its plan sizes them;
- the outer scheme's memory terms.

The JAX ``permute_dev``, ``compress2_dev`` and ``hash_rows_dev`` take about
50 s of XLA compile each on the CPU: those comparisons are ``slow``.
Tolerance: exact equality (finite fields).
"""

import os
import re

import numpy as np
import pytest
import torch

import jax

jax.config.update("jax_platforms", "cpu")

import swirl.fields.jbn254 as jb  # noqa: E402
import swirl.hash.jbn254_poseidon2 as jp  # noqa: E402
from swirl_torch import kernels as K  # noqa: E402
from swirl_torch.fields import bn254 as fb  # noqa: E402
from swirl_torch.fields.babybear import P as P_BB  # noqa: E402
from swirl_torch.hash import bn254_poseidon2 as bp  # noqa: E402
from swirl_torch.hash import multi_field as mf  # noqa: E402
from swirl_torch.hash import scheme as tscheme  # noqa: E402

P = fb.P
CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "swirl_torch", "csrc")



@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """The plain BN254 path is many small tensor ops: one intra-op thread,
    since the tier runs several test processes side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

def _ints(rng, n):
    return [int.from_bytes(rng.bytes(32), "little") % P for _ in range(n)]


def _to16(t: torch.Tensor) -> np.ndarray:
    """The port's (..., 8) int32 words -> the JAX package's (..., 16) limbs."""
    w = t.numpy().view(np.uint32)
    return np.stack([w & 0xFFFF, w >> 16], axis=-1).reshape(w.shape[:-1] + (16,)).astype(np.uint32)


def _from16(limbs) -> torch.Tensor:
    l = np.asarray(limbs, dtype=np.uint32)
    l = l.reshape(l.shape[:-1] + (8, 2))
    return torch.from_numpy((l[..., 0] | (l[..., 1] << 16)).astype(np.uint32).view(np.int32))


EDGES = [0, 1, P - 1, P]


def _operands(seed: int, shape):
    """Monty-form words of random values; the edges through limbs_from_int."""
    rng = np.random.default_rng(seed)
    n = int(np.prod(shape))
    vals = [fb.limbs_from_int(v) for v in EDGES] + [fb.const(v) for v in _ints(rng, n - len(EDGES))]
    return fb.tensor(np.stack(vals).reshape(tuple(shape) + (8,)), "cpu")


@pytest.mark.parametrize("op", ["add", "sub", "mont_mul", "from_canonical", "to_canonical", "dbl"])
@pytest.mark.parametrize("shape", [(12,), (3, 5)])
def test_field_ops_match_jax(op, shape):
    a = _operands(1, shape)
    b = _operands(2, shape).flip(0)
    two = op in ("add", "sub", "mont_mul")
    got = getattr(fb, op)(a, b) if two else getattr(fb, op)(a)
    jfn = getattr(jb, op)
    want = jfn(_to16(a), _to16(b)) if two else jfn(_to16(a))
    assert torch.equal(got, _from16(np.asarray(want)))
    # every edge against every edge
    e = fb.tensor(np.stack([fb.limbs_from_int(v) for v in EDGES]), "cpu")
    ea, eb = e[:, None].expand(4, 4, 8).contiguous(), e[None].expand(4, 4, 8).contiguous()
    got = getattr(fb, op)(ea, eb) if two else getattr(fb, op)(ea)
    want = jfn(_to16(ea), _to16(eb)) if two else jfn(_to16(ea))
    assert torch.equal(got, _from16(np.asarray(want)))


def test_field_broadcasts_and_round_trips():
    rng = np.random.default_rng(3)
    vals = _ints(rng, 6)
    x = fb.from_ints(vals, "cpu")
    assert fb.to_ints(x) == vals
    assert fb.int_from_limbs(fb.limbs_from_int(P)) == P
    assert np.array_equal(fb.limbs_from_int(P), fb.P_LIMBS)
    m = fb.from_canonical(x)
    assert fb.to_ints(fb.to_canonical(m)) == vals
    one = fb.tensor(fb.const(1), "cpu")
    assert torch.equal(fb.mont_mul(m, one), m)  # (8,) broadcasts against (6, 8)
    r_inv = pow((1 << 256) % P, -1, P)
    prod = fb.to_ints(fb.mont_mul(x, x.flip(0)))
    assert prod == [a * b * r_inv % P for a, b in zip(vals, vals[::-1])]


def test_cuda_source_constants():
    """The modulus (words and 2^52 limbs), -P^-1 mod 2^52, the R'-form
    factors K_e = 2^e mod P, the exponent bits and the quotient's 1 / P
    written into bn254.cuh."""
    src = open(os.path.join(CSRC, "bn254.cuh")).read()

    def words(name):
        body = re.search(rf"#define {name} \\\s*\n([^\n]*)", src).group(1)
        return sum(int(w, 16) << (32 * i) for i, w in enumerate(re.findall(r"0x([0-9a-f]{8})u", body)))

    def limbs(name):
        body = re.search(rf"#define {name} ([^\n]*)", src).group(1)
        return sum(int(w, 16) << (52 * i) for i, w in enumerate(re.findall(r"0x([0-9a-f]+)ull", body)))

    def const(name):
        return re.search(rf"constexpr \w+ {name} = ([^;]*);", src).group(1)

    assert words("BN254_P_WORDS") == P
    assert limbs("BN254_P_LIMBS") == P
    for e, k in fb.F64_K.items():
        assert limbs(f"BN254_K{e}_LIMBS") == k == pow(2, e, P)
    assert int(const("NP52").rstrip("ull"), 16) == fb.F64_NP == (-pow(P, -1, 1 << 52)) % (1 << 52)
    assert float.fromhex(const("INV_P4")) == fb.F64_INV
    assert int(const("LO_BITS").rstrip("ull"), 16) == fb.F64_LO_BITS
    assert int(const("HI_BITS").rstrip("ull"), 16) == fb.F64_HI_BITS


@pytest.mark.parametrize("t", [2, 3])
def test_round_constants_match_jax(t):
    """The Monty round constants, derived from the port's own constants(t)."""
    for got, want in zip(bp._dev_constants(t), jp._dev_constants(t)):
        assert torch.equal(fb.tensor(got, "cpu"), _from16(want))


def test_packing_matches_jax():
    rng = np.random.default_rng(4)
    for k in range(1, 9):
        felts = rng.integers(0, P_BB, (5, k), dtype=np.int64)
        felts[0] = P_BB - 1
        got = bp.pack_felts_dev(torch.from_numpy(felts))
        want = jp.pack_felts_dev(felts.astype(np.uint32))
        assert torch.equal(got, _from16(np.asarray(want)))
        assert fb.to_ints(got) == [mf.pack_felts(list(r))[0] for r in felts]


def _monty_states(seed, n, t):
    rng = np.random.default_rng(seed)
    states = [_ints(rng, t) for _ in range(n - 1)] + [[P - 1] * t]
    flat = fb.from_ints([v for s in states for v in s], "cpu").reshape(n, t, 8)
    return states, fb.from_canonical(flat)


@pytest.mark.parametrize("t", [2, 3])
def test_permutation_matches_host(t):
    states, monty = _monty_states(5 + t, 3, t)
    got = fb.to_ints(fb.to_canonical(bp.permute_dev(monty, t)))
    assert got == [v for s in states for v in bp.permute(s, t)]


def test_compress_and_layers_match_host():
    rng = np.random.default_rng(8)
    leaves = _ints(rng, 8)
    a, b = fb.from_ints(leaves[:4], "cpu"), fb.from_ints(leaves[4:], "cpu")
    got = fb.to_canonical(bp.compress2_dev(fb.from_canonical(a), fb.from_canonical(b)))
    assert fb.to_ints(got) == [bp.compress2(x, y) for x, y in zip(leaves[:4], leaves[4:])]
    layers = bp.merkle_layers_dev(fb.from_ints(leaves, "cpu"))
    cur = leaves
    for layer in layers[1:]:
        cur = [bp.compress2(cur[2 * i], cur[2 * i + 1]) for i in range(len(cur) // 2)]
        assert fb.to_ints(layer) == cur
    assert len(layers) == 4
    for stride in (1, 2, 4):
        out = fb.to_ints(bp.compress_layer(fb.from_ints(leaves, "cpu"), stride))
        want = [bp.compress2(leaves[2 * stride * (o // stride) + o % stride],
                             leaves[2 * stride * (o // stride) + o % stride + stride]) for o in range(4)]
        assert out == want


@pytest.mark.parametrize("w", [1, 4, 7, 8, 9, 15, 16, 17, 32, 33])
def test_hash_rows_matches_host(w):
    """Full blocks overwrite lanes 0 and 1; a last block of at most 8 felts
    lane 0 only (lane 1 keeps the previous permutation's value)."""
    rng = np.random.default_rng(w)
    mat = rng.integers(0, P_BB, (w, 3), dtype=np.int64)
    mat[:, -1] = P_BB - 1
    got = fb.to_ints(bp.hash_rows(torch.from_numpy(mat)))
    assert got == [mf.MultiFieldHasher.hash_slice(mat[:, i]) for i in range(3)]


def test_hash_rows_ext_matches_host():
    """A (w, h, 4) codeword's leaf i is its rows [c, i, e] in the order c * 4 + e."""
    rng = np.random.default_rng(11)
    mat = rng.integers(0, P_BB, (3, 2, 4), dtype=np.int64)
    got = fb.to_ints(bp.hash_rows(torch.from_numpy(mat)))
    want = [mf.MultiFieldHasher.hash_slice(mat[:, i, :].reshape(-1)) for i in range(2)]
    assert got == want


@pytest.mark.parametrize("ext,rows_per_query", [(False, 1), (False, 4), (True, 2), (True, 8)])
def test_device_tree_matches_host_tree(ext, rows_per_query):
    rng = np.random.default_rng(12)
    mat = rng.integers(0, P_BB, (1, 8, 4) if ext else (2, 8), dtype=np.int64)
    tree = tscheme.DeviceBn254Tree(torch.from_numpy(mat), rows_per_query, ext)
    s = tscheme.Bn254OuterScheme
    want = tscheme.build_host_tree(mat.astype(np.uint64), rows_per_query, ext, s.hash_slice, s.compress)
    assert [fb.to_ints(layer) for layer in tree.layers] == want.layers
    assert tree.root == want.root and tree.query_stride == want.query_stride
    idx = list(range(want.query_stride))[::-1]
    assert tree.batch_query_proofs_arr(torch.tensor(idx)) == want.batch_query_proofs(idx)
    assert tree.batch_query_proofs_arr(idx[:1]) == want.batch_query_proofs(idx[:1])


def _transcript_at(seed: int, a: int, s: int, k: int) -> mf.MultiFieldTranscript:
    """A transcript at absorb cursor a, squeeze cursor s, k pending felts."""
    rng = np.random.default_rng(seed)
    t = mf.MultiFieldTranscript()
    for d in _ints(rng, 2):
        t.observe_commit(d)  # the second fills the rate: permute, cursors (0, 2)
    for _ in range(2 - s):
        t._sponge.squeeze()
    if a == 1:
        t.observe_commit(_ints(rng, 1)[0])
    for v in rng.integers(0, P_BB, k):
        t.observe(int(v))
    assert (t._sponge.absorb_idx, t._sponge.sample_idx, len(t._obs_buf)) == (a, s, k)
    return t


# every cursor the prover reaches: absorb 0 (squeeze cursor 0, 1 or 2) or 1,
# with 0-7 pending felts; bits 1-12 over the first twelve, 1-4 over the rest
CURSORS = [(a, s, k) for a, s in ((0, 0), (0, 1), (0, 2), (1, 2)) for k in range(8)]


@pytest.mark.parametrize("i", range(len(CURSORS)))
def test_plain_grind_matches_host_loop(i):
    a, s, k = CURSORS[i]
    bits = 1 + i % 12 if i < 12 else 1 + i % 4
    host = _transcript_at(i, a, s, k)
    dev = _transcript_at(i, a, s, k)
    pending = mf.pack_felts(dev._obs_buf)[0] if dev._obs_buf else 0
    state = fb.from_ints([*dev._sponge.state, pending], "cpu")
    launches = K.BN254_GRIND.launches
    w = bp.grind(state, a, 31 * k, bits)
    assert K.BN254_GRIND.launches == launches  # the CPU takes the plain version
    assert w == host.grind(bits)
    assert bp.grind(state, a, 31 * k, bits, end=w) == -1  # below the witness, nothing
    # a transcript with a device searches there and applies the witness here
    t = _transcript_at(i, a, s, k)
    t._device = torch.device("cpu")
    assert t.grind(bits) == w
    assert t._sponge.state == host._sponge.state and t._obs_buf == host._obs_buf


def test_device_grind_transcript_logs_the_host_loops_events():
    felts = [int(v) for v in np.random.default_rng(13).integers(0, P_BB, 6)]
    logs = []
    for device in (None, "cpu"):
        t = mf.MultiFieldTranscript(record=True, device=device)
        for step, v in enumerate(felts):
            t.observe(v)
            t.grind(step % 4 + 1)
            t.sample()
        logs.append(t.log)
    assert logs[0] == logs[1]
    v = mf.MultiFieldTranscriptValidator(logs[1])
    for step, f in enumerate(felts):
        v.observe(f)
        v.grind(step % 4 + 1)
        v.sample()
    v.finish()


def test_grind_source_constants():
    """Kernel J's sample weights 2^(26 j) mod p in bn254.cu, its operand
    struct's size, and the threads a block the sweep plan counts."""
    src = open(os.path.join(CSRC, "bn254.cu")).read()
    body = re.search(r"#define BB_HALF_WEIGHTS \\\s*\n([^\n]*)", src).group(1)
    assert [int(w, 16) for w in re.findall(r"0x([0-9a-f]+)u", body)] == [pow(2, 26 * j, P_BB) for j in range(10)]
    assert "grind_kernel<<<blocks, 128, 0, s>>>" in src and bp.GRIND_THREADS == 128
    assert bp._grind_struct([1, 2, 3], 4, 0, 31, 1, 5).nbytes == 216  # 5 x 5 limbs, end, mask and a


# (absorb cursor, pending felts) of every cursor the prover reaches
GRIND_CURSORS = [(a, k) for a in (0, 1) for k in range(8)]


@pytest.mark.parametrize("bits", [5, 8])
@pytest.mark.parametrize("a,k", GRIND_CURSORS)
def test_grind_model_matches_plain_and_jax_host_loop(a, k, bits):
    """Kernel J's candidate and sample arithmetic by the model (the lane
    from one product, then an add a sweep; the sample from limb halves,
    every bound asserted), over 16 threads so that the search crosses
    sweeps, equals the plain search and the JAX package's host loop."""
    import swirl.hash.multi_field as jmf

    rng = np.random.default_rng(100 + 16 * bits + 8 * a + k)
    lanes = _ints(rng, 3)
    felts = [int(v) for v in rng.integers(0, P_BB, k)]
    pending = mf.pack_felts(felts)[0] if k else 0
    w = bp.grind_model(lanes, pending, a, 31 * k, bits, threads=16)
    assert w == bp.grind_plain(fb.from_ints([*lanes, pending], "cpu"), a, 31 * k, bits)
    assert w == bp.grind_ints(lanes, pending, a, 31 * k, bits, device="cpu")
    host = jmf.MultiFieldTranscript()
    host._sponge.state, host._sponge.absorb_idx, host._sponge.sample_idx = list(lanes), a, 2
    host._obs_buf = list(felts)
    assert host.grind(bits) == w


@pytest.mark.parametrize("threads", [1, 3, 8, 128])
def test_grind_sweeps_cover_every_candidate_below_the_witness(threads):
    """Kernel J's order on index arrays: the sweeps of a launch hold every
    index below the end once, in thread order; with the threads of a sweep
    running in any order and each leaving once the least hit so far lies
    below its next candidate, every index below the final least hit was
    tried, whatever the hits: a witness of 0, on a sweep's first and last
    index, or past the end."""
    rng = np.random.default_rng(threads)
    end = 5 * threads + 3
    sweeps = list(bp.grind_sweeps(threads, end))
    flat = [w for sweep in sweeps for _, w in sweep]
    assert flat == list(range(end))
    assert all(w % threads == t for sweep in sweeps for t, w in sweep)
    witnesses = {0, threads - 1, threads, 2 * threads, 3 * threads - 1, end - 1}
    for first in sorted(witnesses) + [end]:
        hits = {first} | {w for w in range(first + 1, end) if rng.random() < 0.3}
        for _ in range(5):
            found, gone, tried = None, set(), set()
            for sweep in sweeps:
                for t, w in (sweep[i] for i in rng.permutation(len(sweep))):
                    if t in gone or (found is not None and found < w):
                        gone.add(t)
                        continue
                    tried.add(w)
                    if w in hits:
                        found = w if found is None else min(found, w)
            assert found == (first if first < end else None)
            assert set(range(first if first < end else end)) <= tried


@pytest.mark.parametrize("threads", [128, 3 * 128, 2 * 132 * 128])
def test_grind_model_at_the_card_sweep_sizes(threads):
    """Kernel J's lanes by the model at the sweeps csrc/bn254.cu plans on
    an H100 (one block for 5 bits, 264 blocks from 15 bits) and between:
    each thread's first lane and its stride mont(threads, step) give
    (pending + w 2^shift) 2^260 mod P at every candidate tried, and the
    witness is the plain search's, from a cursor with pending felts."""
    rng = np.random.default_rng(threads)
    lanes = _ints(rng, 3)
    felts = [int(v) for v in rng.integers(0, P_BB, 3)]
    pending = mf.pack_felts(felts)[0]
    for bits in (1, 6):
        w = bp.grind_model(lanes, pending, 1, 93, bits, threads=threads)
        assert w == bp.grind_plain(fb.from_ints([*lanes, pending], "cpu"), 1, 93, bits)


def test_grind_refuses_bad_operands():
    state = fb.from_ints([0, 0, 0, 0], "cpu")
    for a, shift, bits, end in ((2, 0, 3, None), (0, 5, 3, None), (0, 0, 0, None), (0, 0, 31, None),
                                (0, 248, 3, None), (0, 0, 3, -1), (0, 0, 3, P_BB + 1)):
        with pytest.raises(ValueError):
            bp.grind(state, a, shift, bits, end)


def test_outer_memory_terms():
    """32 B digest layers in place of 64 B; the device tree reads the
    codeword in place, so no codeword copy joins the commit."""
    from swirl_torch.memory_metering import (
        DIGEST_SIZE, OUTER_DIGEST_SIZE, ProvingMemoryConfig, ProvingMemoryCounts)
    from swirl_torch.params import root_params_with_100_bits_security

    params = root_params_with_100_bits_security(21)
    inner = ProvingMemoryConfig.from_params(params)
    outer = ProvingMemoryConfig.from_params(params, digest_size=OUTER_DIGEST_SIZE)
    assert inner.digest_size == DIGEST_SIZE == 64
    counts = ProvingMemoryCounts((1 << 20) * 64, 0, (1 << 20) * 8, 0, 20)
    codeword_h = 1 << (params.l_skip + params.n_stack + params.log_blowup)
    assert inner.commit_memory_bytes(counts.main_cells) - outer.commit_memory_bytes(counts.main_cells) == \
        codeword_h * 32
    gap = inner.whir_memory_bytes(counts.main_cells) - outer.whir_memory_bytes(counts.main_cells)
    assert gap == 32 * ((codeword_h >> 1) + 2 * (codeword_h >> params.k_whir))
    assert outer.estimate(counts).total <= inner.estimate(counts).total


@pytest.mark.slow
@pytest.mark.parametrize("t", [2, 3])
def test_permute_matches_jax_permute_dev(t):
    _, monty = _monty_states(20 + t, 2, t)
    want = jp.permute_dev(_to16(monty), t)
    assert torch.equal(bp.permute_dev(monty, t), _from16(np.asarray(want)))


@pytest.mark.slow
def test_compress_matches_jax_compress2_dev():
    _, monty = _monty_states(22, 3, 2)
    a, b = monty[:, 0].contiguous(), monty[:, 1].contiguous()
    want = jp.compress2_dev(_to16(a), _to16(b))
    assert torch.equal(bp.compress2_dev(a, b), _from16(np.asarray(want)))


@pytest.mark.slow
@pytest.mark.parametrize("w", [9, 17])
def test_hash_rows_matches_jax_hash_rows_dev(w):
    rng = np.random.default_rng(30 + w)
    mat = rng.integers(0, P_BB, (w, 2), dtype=np.int64)
    want = jp.hash_rows_dev(mat.T.astype(np.uint32))
    assert torch.equal(bp.hash_rows(torch.from_numpy(mat)), _from16(np.asarray(want)))


# -- the kernels' FP64 arithmetic, modelled step by step ------------------------
#
# fields/bn254.py f64_* and hash/bn254_poseidon2.py f64_* repeat csrc/bn254.cuh
# operation by operation on Python ints (every double operation rounded as
# the card rounds it, every bound asserted); here they are held to the plain
# versions and to the JAX package.


def _monty_edges():
    return [fb.limbs_from_int(v) for v in EDGES]


@pytest.mark.parametrize("shape", [(12,), (3, 5)])
def test_f64_product_matches_plain_and_jax(shape):
    """Kernel G's mont_mul on the FP64 core (x (16 y) / 2^260) equals the plain
    mont_mul and jbn254.mont_mul, on random, batched and edge operands."""
    a = _operands(11, shape)
    b = _operands(12, shape).flip(0)
    got = fb.f64_mont_mul_model(a, b)
    assert torch.equal(got, fb.mont_mul(a, b))
    assert torch.equal(got, _from16(np.asarray(jb.mont_mul(_to16(a), _to16(b)))))
    e = fb.tensor(np.stack(_monty_edges()), "cpu")
    ea, eb = e[:, None].expand(4, 4, 8).contiguous(), e[None].expand(4, 4, 8).contiguous()
    got = fb.f64_mont_mul_model(ea, eb)
    assert torch.equal(got, fb.mont_mul(ea, eb))
    assert torch.equal(got, _from16(np.asarray(jb.mont_mul(_to16(ea), _to16(eb)))))


def test_f64_square_redc_reduce_and_canon():
    """The square equals the product of a value by itself, the quotient steps
    alone divide by 2^260, reduce keeps the value mod P below 3P, canon
    gives the least residue: on random values and edges up to the bounds the
    permutation gives an operand (below 16P) and reduce (limbs below 2^55)."""
    rng = np.random.default_rng(13)
    r_inv = pow(fb.F64_R, -1, P)
    vals = [0, 1, P - 1, P, 2 * P - 1, 16 * P - 1] + [int.from_bytes(rng.bytes(33), "little") % (16 * P)
                                                      for _ in range(20)]
    for v in vals:
        x = fb.f64_limbs(v)
        sq = fb.f64_mont(x, None, square=True)
        assert sq == fb.f64_mont(x, x)
        assert fb.f64_value(sq) % P == v * v * r_inv % P and fb.f64_value(sq) < v * v // fb.F64_R + P
        assert fb.f64_value(fb.f64_redc(x)) % P == v * r_inv % P
        if v < 2 * P:
            assert fb.f64_canon(x) == v % P
    top = (1 << 52) - 1
    for limbs in ([5 * top] * 5, [5 * top] * 4 + [0], [0, 0, 0, 5 * top, 3 * (P >> 208)], [0] * 5):
        y = fb.f64_reduce(limbs)
        assert fb.f64_value(y) % P == fb.f64_value(limbs) % P


def _model_states(t):
    """Random Monty states, all P - 1 and all 0."""
    _, monty = _monty_states(40 + t, 3, t)
    return torch.cat([monty, torch.zeros((1, t, 8), dtype=torch.int32)])


@pytest.mark.parametrize("t", [2, 3])
def test_f64_permute_model_matches_plain(t):
    """The kernels' permutation by the model (R-form lanes into R' form and
    back) equals permute_plain (which the ``slow``
    test_permute_matches_jax_permute_dev holds to the JAX package)."""
    state = _model_states(t)
    assert torch.equal(bp.permute_model(state, t), bp.permute_plain(state, t))


@pytest.mark.slow
@pytest.mark.parametrize("t", [2, 3])
def test_f64_permute_model_matches_jax_permute_dev(t):
    """The model's permutation equals jbn254_poseidon2.permute_dev (about 50 s
    of XLA compile a width)."""
    state = _model_states(t)
    assert torch.equal(bp.permute_model(state, t), _from16(np.asarray(jp.permute_dev(_to16(state), t))))


@pytest.mark.parametrize("fill", ["random", "zero", "p_minus_1"])
def test_f64_compress_model_matches_plain(fill):
    rng = np.random.default_rng(14)
    n = 8
    vals = {"random": _ints(rng, n), "zero": [0] * n, "p_minus_1": [P - 1] * n}[fill]
    layer = fb.from_ints(vals, "cpu")
    for stride in (1, 2, n // 2):
        assert torch.equal(bp.compress_layer_model(layer, stride), bp.compress_layer_plain(layer, stride))


@pytest.mark.parametrize("w", [1, 8, 9, 16, 17, 32, 33])
def test_f64_hash_rows_model_matches_plain(w):
    """Leaves of every absorb shape: one column random, one of BabyBear P - 1."""
    rng = np.random.default_rng(50 + w)
    mat = rng.integers(0, P_BB, (w, 2), dtype=np.int64)
    mat[:, 1] = P_BB - 1
    mat = torch.from_numpy(mat)
    assert torch.equal(bp.hash_rows_model(mat), bp.hash_rows_plain(mat))


def test_f64_hash_rows_model_matches_plain_in_place():
    mat = torch.full((3, 2, 4), P_BB - 1, dtype=torch.int64)
    mat[0, 0] = torch.tensor([0, 1, 2, 3])
    assert torch.equal(bp.hash_rows_model(mat), bp.hash_rows_plain(mat))


@pytest.mark.parametrize("t", [2, 3])
def test_f64_permute_bounds_hold_for_every_input(t):
    """Worst-case values through the kernels' permutation: every product
    operand below 2^260, every limb f64_reduce takes below 2^56. Inputs: a
    product's output (H's lanes, I's packed scalars: below 2P), and for
    width 3 the lane I carries from one permutation to the next (a fixed
    point of the output bound)."""
    out = bp.f64_permute_bounds(t, 2 * P)
    assert out < 16 * P
    if t == 3:
        assert bp.f64_permute_bounds(3, out) <= out
