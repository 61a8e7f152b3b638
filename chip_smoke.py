#!/usr/bin/env python3
"""Chip smoke test of the torch port (swirl_torch) on one CUDA card.

Run from the root of the repository on a machine with an NVIDIA H100:

    python3 chip_smoke.py

Phases, each printing its result on lines of its own:

1. device: the card's name and power limit, the kernels' build time, and
   whether the host C++ library (transcript grinding) loaded;
2. kernels: every hand-written CUDA kernel against its plain PyTorch
   version at the shapes of the main paths, bit for bit (the Keccak
   shapes just before the Keccak phase), with both times
   and the least time the card could take for the same work (where the
   plain version cannot hold the whole input, it takes it in column
   slices and is held to the same slices of the kernel's output). A
   kernel's time is the mean of 10 back-to-back calls by CUDA events,
   except where the kernel may run faster than the Python that enqueues
   it (``GRAPH_TIMED``: the tower, the 16-point coset NTT): there it is the
   device's own clock, a CUDA graph of 10 calls replayed between two
   events. The tower is also timed so at n = 2, one permutation (t_perm):
   13 t_perm is the chain floor of its 13 dependent levels at n = 8192;
3. golden: the four golden proofs through the port's ``run_test`` on the
   card (debug check, prove, verify), byte for byte against
   ``tests/golden`` (vk, proof, transcript log);
4. app: keygen, debug check, prove and verify of the 2^20 x 64
   ``SyntheticAir`` cell (degree 3) under
   ``app_params_with_100_bits_security(22)``;
5. leaf: the same for the 2^20 x 64 degree-4 cell under
   ``leaf_params_with_100_bits_security(25)``: 2 stacked columns of 2^25
   rows, so the RS encode is one (2, 2^27) NTT through A′;
6. keccak: the same for ``KeccakAir`` on 2^10 random permutations, the
   reference keccakf example's inputs and parameters (a 2^15 x 2633 trace,
   ``app_params_with_100_bits_security(17)``, RS encode (659, 2^18)); its
   40,535-node DAG runs through the level-scheduled interpreter, whose
   levels and ``max_live`` the phase prints, with the trace generation's
   seconds.

Phases 4 to 6 use a random trace from a seed. The debug check runs on
the card before the prove, the port's host verifier on the proof's
decoded bytes after it; each prints its seconds. They print the
per-stage spans, the prove seconds, the peak device memory and the input
shapes each kernel was launched on; each proof must re-encode
identically after a codec round trip. The kernel launch counters are
reset just before each prove and read just after it, and every kernel of
that path must have launched during it. Then two negative checks: the
proof with 1 added to one column opening must be refused by the
verifier, and a bad trace must be refused by the debug check at its bad
row: a 1 in the SyntheticAir kill column (column 0) at one row, one
a_prime bit of Keccak flipped at a row in the middle of the trace.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``. Any failure raises and exits non-zero
before those lines. Without a CUDA device it stops at once with exit code 2.
"""

from __future__ import annotations

import hashlib
import json
import math
import subprocess
import sys
import time
from contextlib import contextmanager

LOG_ROWS = 20
WIDTH = 64
APP_LOG_STACKED = 22
LEAF_LOG_STACKED = 25
SEED = 0
# the reference's keccakf example (examples/keccakf.py): 2^10 permutations,
# a (2^15, 2633) trace, app parameters at log_stacked_height
# max(15 + 2, 16) = 17, so four columns of 2^15 rows stack into one and the
# stacked matrix is 659 columns of 2^17 rows (RS encode (659, 2^18))
KECCAK_LOG_PERMS = 10
KECCAK_STACKED = 659
GOLDEN_CASES = ("fib", "interactions", "preprocessed", "cached_preprocessed")

# The least time of a kernel's work is the larger of its bytes over the
# H100's 3.35 TB/s (NVIDIA's data sheet) and its 32-bit integer operations
# over the rate of the pipes that run them. A Hopper SM issues 64 32-bit
# integer multiplies or multiply-adds a clock (its FMA pipe) and 64 other
# 32-bit integer operations a clock (add, subtract, compare, min and max:
# its ALU pipe), by the arithmetic throughput table of the CUDA C++
# Programming Guide for compute capability 9.0. The two pipes run side by
# side and the FMA pipe can also add, so m multiplies and a other
# operations take at least max(m, (m + a) / 2) clocks of 64 lanes. 132 SMs
# at the 1.98 GHz boost clock give 64 x 132 x 1.98e9 = 16.7e12 lane
# operations a second for each pipe. A field operation counts the fewest
# instructions that sm_90a issues for it (the SASS of
# swirl_torch/csrc/poseidon2.cu, by swirl_torch/tools/isa.py): a Montgomery
# product 3 multiplies (the wide a*b, q = lo*P^-1, the high half of q*P)
# and 2 other operations (hi(a*b) - hi(q*P) + P in one IADD3, then
# min(r, r - P) in one VIADDMNMX); a product left in (0, 2P) 1 other; an
# add or a subtract 2 other operations (IADD3, VIADDMNMX); a halving 1
# multiply-add and 2 others; a product by 2^-k without a Montgomery
# product 1 multiply-add (hi - 15 * 2^(27-k) * lo) and 3 others.
HBM_BYTES_PER_S = 3.35e12
INT32_LANE_OPS_PER_S = 64 * 132 * 1.98e9
MONT_MUL, ADD = (3, 2), (0, 2)  # (multiplies, other operations)
SBOX = (12, 7)  # x^7: x^2, x^4 and x^3 * x^4 reduced, x^3 left in (0, 2P)
HALVE, DIV2K = (1, 2), (1, 3)
# one Poseidon2-16 permutation: 141 S-boxes (16 in each of 8 full rounds,
# 1 in each of 13 partial rounds); 1309 adds (9 M_E layers of 72, 128 + 13
# round constants, 41 in each partial round's tree sum and diagonal); the
# diagonal's 2 halvings and 7 products by 2^-k in each partial round
PERM = tuple(141 * s + 1309 * a + 26 * h + 91 * d for s, a, h, d in zip(SBOX, ADD, HALVE, DIV2K))
# one radix-2 butterfly: a product, an add and a subtract
BUTTERFLY = (MONT_MUL[0], MONT_MUL[1] + 2 * ADD[1])


def _say(*parts) -> None:
    print(*parts, flush=True)


def _cuda_time_ms(fn, reps: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _graph_time_ms(fn, reps: int) -> float:
    """Device ms of one call of ``fn``: ``reps`` calls captured in a CUDA
    graph on a side stream (after a call there that fills the wrappers'
    caches for that stream), replayed once to warm up, then once between
    two CUDA events."""
    import torch

    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fn()
    stream.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def ntt_work(shape):
    """(bytes, (multiplies, others)) of a (batch, N) int64 NTT: one read and
    one write per element, N/2 log N butterflies per row."""
    batch, n = shape
    butterflies = batch * (n // 2) * (n.bit_length() - 1)
    return 2 * batch * n * 8, _times(BUTTERFLY, butterflies)


def hash_work(shape):
    """hash_cols on (w, H) or (w, H, d): w*d*H words in, 8*H out; one
    permutation per 8 absorbed words of each row."""
    w, h = shape[0] * (shape[2] if len(shape) == 3 else 1), shape[1]
    return (w + 8) * h * 8, _times(PERM, h * -(-w // 8))


def compress_work(shape):
    """compress_cols on (16, n): 16n words in, 8n out, n permutations."""
    _, n = shape
    return 24 * n * 8, _times(PERM, n)


def layer_work(shape):
    """compress_layer on an (8, n) layer: the work of (16, n/2) pairs."""
    return compress_work((16, shape[1] // 2))


def tower_work(shape):
    """The tower on (8, n): 8n words in, every level out."""
    _, n = shape
    return (8 * n + 8 * (n - 1)) * 8, _times(PERM, n - 1)


def _times(ops, k):
    return ops[0] * k, ops[1] * k


def bound(work):
    """(bound_ms, bound_by) of (bytes, (multiplies, others))."""
    nbytes, (muls, others) = work
    byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
    op_ms = max(muls, (muls + others) / 2) / INT32_LANE_OPS_PER_S * 1e3
    return (byte_ms, "bytes") if byte_ms >= op_ms else (op_ms, "operations")


def _cols(x, c, k):
    return x[:, c : c + k]


def _layer_cols(stride):
    """The input columns of output columns [c, c + k) of compress_layer at
    ``stride`` (k a multiple of the stride): [2c, 2c + 2k)."""
    def cols(x, c, k):
        if c % stride or k % stride:
            raise ValueError(f"columns [{c}, {c + k}) split pairs at stride {stride}")
        return x[:, 2 * c : 2 * c + 2 * k]
    return cols


def kernel_cases():
    """(kernel, label, kernel fn, plain fn, input shape, work, plain slice)
    at the main paths' shapes, each through the entry the path calls. The
    first case of each kernel is the one the ``kernels`` line reports: the
    leaf path's largest. Leaf: the RS encode (A′), the three WHIR
    codewords, the chunk iDFTs (the app's shape too), the 16-point
    transforms of the univariate-skip coset grid (both paths), the hash of
    the 2^27-row codeword (w = 2: a partial absorb) and of the first WHIR
    codeword read in place as (1, 2^26, 4), the first strided compress
    level read in place from the (8, 2^27) leaf digests at the query stride
    2^23 (the work of (16, 2^26) pairs), a level above the tower (stride
    1), the tower. App:
    the RS encode, its first two WHIR codewords, its leaf hashes, its first strided
    level (stride 2^19) and the (16, n) pairs form of ``compress_cols``.
    Keccak: the RS encode of the 659 stacked columns and their leaf hash
    (83 permutations a leaf, the last absorbing 3 words).
    ``plain slice`` is None where the plain version takes the whole input,
    else (columns of the output it takes at a time, the input columns of
    them); the kernel always runs on the whole input."""
    from swirl_torch import kernels as K
    from swirl_torch.hash import poseidon2 as p2
    from swirl_torch.prover import ntt

    fwd, inv = ntt.ntt_rows, (lambda x: ntt.ntt_rows(x, True))
    pfwd, pinv = ntt.ntt_plain, (lambda x: ntt.ntt_plain(x, True))
    hash_ = (p2.hash_cols, p2.hash_cols_plain)

    def layer(stride):
        return (lambda x: p2.compress_layer(x, stride)), (lambda x: p2.compress_layer_plain(x, stride))

    return [
        (K.NTT, "leaf_whir_codeword", fwd, pfwd, (4, 1 << 26), ntt_work, None),
        (K.NTT, "leaf_whir_codeword_2", fwd, pfwd, (4, 1 << 25), ntt_work, None),
        (K.NTT, "leaf_whir_codeword_3", fwd, pfwd, (4, 1 << 24), ntt_work, None),
        (K.NTT, "chunk_idft", inv, pinv, (1 << 22, 16), ntt_work, None),
        (K.NTT, "coset_chunks", fwd, pfwd, (196608, 16), ntt_work, None),
        (K.NTT, "app_rs_encode", fwd, pfwd, (16, 1 << 23), ntt_work, None),
        (K.NTT, "app_whir_codeword", fwd, pfwd, (4, 1 << 22), ntt_work, None),
        (K.NTT, "app_whir_codeword_2", fwd, pfwd, (4, 1 << 21), ntt_work, None),
        (K.NTT, "keccak_rs_encode", fwd, pfwd, (KECCAK_STACKED, 1 << 18), ntt_work, None),
        (K.NTT_RECURSIVE, "leaf_rs_encode", fwd, pfwd, (2, 1 << 27), ntt_work, None),
        (K.NTT_RECURSIVE, "leaf_rs_encode_inverse", inv, pinv, (2, 1 << 27), ntt_work, None),
        (K.HASH_COLS, "leaf_codeword_hash", *hash_, (2, 1 << 27), hash_work, (1 << 24, _cols)),
        (K.HASH_COLS, "leaf_whir_hash", *hash_, (1, 1 << 26, 4), hash_work, (1 << 24, _cols)),
        (K.HASH_COLS, "app_codeword_hash", *hash_, (16, 1 << 23), hash_work, None),
        (K.HASH_COLS, "app_whir_hash", *hash_, (1, 1 << 22, 4), hash_work, None),
        (K.HASH_COLS, "keccak_codeword_hash", *hash_, (KECCAK_STACKED, 1 << 18), hash_work, None),
        (K.COMPRESS, "leaf_strided_level", *layer(1 << 23), (8, 1 << 27), layer_work,
         (1 << 23, _layer_cols(1 << 23))),
        (K.COMPRESS, "leaf_tower_level", *layer(1), (8, 1 << 23), layer_work, None),
        (K.COMPRESS, "app_strided_level", *layer(1 << 19), (8, 1 << 23), layer_work, None),
        (K.COMPRESS, "app_pairs_form", p2.compress_cols, p2.compress_cols_plain, (16, 1 << 22),
         compress_work, None),
        (K.TOWER, "tower_8192", p2.compress_tower, p2.merkle_tower_plain, (8, 8192), tower_work, None),
    ]


# cases that may run faster than the Python that enqueues them
GRAPH_TIMED = ("coset_chunks", "tower_8192")
TOWER_LEVELS = 13  # of the tower's widest layer, TOWER_MAX = 2^13


def _timed_ms(fn):
    """(result, ms) of one call, by CUDA events."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def _max_abs_err(got, want) -> int:
    import torch

    if isinstance(got, list):  # the tower's layers
        got = torch.cat([t.reshape(-1) for t in got])
        want = torch.cat([t.reshape(-1) for t in want])
    if got.shape != want.shape:
        raise AssertionError(f"shape {tuple(got.shape)} against {tuple(want.shape)}")
    return int((got - want).abs().max().item()) if got.numel() else 0


def check_kernels(device, keccak: bool = False) -> dict:
    """Each kernel against its plain version on seeded random inputs, bit
    for bit; returns the results of each kernel's first case. The Keccak
    cases run apart (``keccak=True``), just before the Keccak phase: the
    2^18-point twiddle table they leave cached would otherwise count in
    the app's and the leaf's peak memory."""
    import torch

    from swirl_torch import kernels as K
    from swirl_torch.fields.babybear import P
    from swirl_torch.hash import poseidon2 as p2
    from swirl_torch.prover import ntt

    gen = torch.Generator(device=device)
    gen.manual_seed(SEED)
    if not keccak:
        pair = torch.randint(0, P, (8, 2), generator=gen, device=device, dtype=torch.int64)
        t_perm = _graph_time_ms(lambda: p2.compress_tower(pair), reps=10)
        floor_ms = TOWER_LEVELS * t_perm
    results = {}
    for kernel, label, fk, fp, shape, work, slices in kernel_cases():
        if label.startswith("keccak_") != keccak:
            continue
        x = torch.randint(0, P, shape, generator=gen, device=device, dtype=torch.int64)
        got = fk(x)
        if slices is None:
            err = _max_abs_err(got, fp(x))
            plain_ms = _cuda_time_ms(lambda: fp(x), reps=2)
            how = ""
        else:
            err, plain_ms = 0, 0.0
            cols, part = slices
            for c in range(0, got.shape[1], cols):
                want, ms = _timed_ms(lambda: fp(part(x, c, cols).contiguous()))
                err = max(err, _max_abs_err(got[:, c : c + cols], want))
                plain_ms += ms
                del want
            how = f" (plain in slices of {cols} columns)"
        if err != 0:
            raise AssertionError(f"kernel {kernel.name} [{label}] {shape}: max_abs_err {err}")
        del got
        ms = _cuda_time_ms(lambda: fk(x), reps=10)
        extra = {}
        if label in GRAPH_TIMED:
            how += f" (ms by CUDA graph replay; by events {ms:.4f})"
            ms = _graph_time_ms(lambda: fk(x), reps=10)
        if kernel is K.TOWER:
            how += f" t_perm_ms={t_perm:.4f} floor_ms={floor_ms:.4f} ({TOWER_LEVELS} t_perm)"
            extra["floor_ms"] = floor_ms
        bound_ms, bound_by = bound(work(shape))
        _say(
            f"kernel {kernel.name} [{label}] shape={shape} equal=True "
            f"max_abs_err={err} ms={ms:.4f} plain_ms={plain_ms:.4f}{how} "
            f"bound_ms={bound_ms:.4f} ({bound_by})"
        )
        results.setdefault(kernel.name, {
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            # no PyTorch call computes a BabyBear NTT or Poseidon2
            "library_ms": None, **extra,
        })
        del x
        torch.cuda.empty_cache()
    # the plain NTT's tables at 2^27 hold gigabytes; the provers never use them
    ntt._plain_twiddles.cache_clear()
    ntt._bitrev.cache_clear()
    torch.cuda.empty_cache()
    return results


def check_golden(device) -> None:
    """The golden cases through ``run_test``: debug check, prove, verify."""
    from swirl_torch.codec import encode_proof, encode_vk
    from swirl_torch.engine import StarkEngine
    from swirl_torch.testing.golden import encode_transcript_log, golden_cases, paths_for
    from swirl_torch.transcript import Transcript

    for name in GOLDEN_CASES:
        params, airs, ctxs = golden_cases()[name]()
        transcript = Transcript(record=True)
        vk, proof = StarkEngine(params, device).run_test(airs, ctxs, transcript)
        paths = paths_for(name)
        for what, got in (
            ("vk", encode_vk(vk)),
            ("proof", encode_proof(proof)),
            ("transcript", encode_transcript_log(transcript.log)),
        ):
            with open(paths[what], "rb") as f:
                if f.read() != got:
                    raise AssertionError(f"golden {name}: {what} bytes differ")
        _say(f"golden {name}: vk, proof and transcript byte-identical")


@contextmanager
def recorded_shapes():
    """Collects {kernel name: {input shape: launches}} of every launch inside
    the block; the launches and their counts are unchanged."""
    from collections import Counter

    from swirl_torch import kernels as K

    shapes = {}
    launch = K.LIB.launch

    def record(kernel, fn_name, t, *args):
        shapes.setdefault(kernel.name, Counter())[tuple(t.shape)] += 1
        return launch(kernel, fn_name, t, *args)

    K.LIB.launch = record
    try:
        yield shapes
    finally:
        del K.LIB.launch


def _synced_seconds(fn):
    """(result, host seconds) of ``fn`` ending in a device sync."""
    import torch

    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def prove_and_check(device, params, air, trace, bad_trace, bad_row: int) -> dict:
    """Keygen, debug check, prove and verify of ``air`` on ``trace``. Resets
    the launch counters just before the prove and returns them with the
    spans, seconds, the kernels' input shapes and the encoded proof size.
    Then the two negative checks: the proof with 1 added to a column
    opening must be refused by the verifier, and ``bad_trace`` by the debug
    check at ``bad_row``."""
    import torch

    from swirl_torch import kernels as K
    from swirl_torch import metrics
    from swirl_torch.codec import decode_proof, decode_vk, encode_proof, encode_vk
    from swirl_torch.engine import StarkEngine
    from swirl_torch.fields.babybear import P
    from swirl_torch.prover.backend import ProvingContext
    from swirl_torch.verifier.errors import VerifierError

    eng = StarkEngine(params, device)
    t0 = time.perf_counter()
    pk, vk = eng.keygen([air])
    dpk = eng.transport_pk(pk)
    ctx = ProvingContext([eng.context_for(0, trace, [], [])])
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    _, debug_s = _synced_seconds(lambda: eng.debug([air], pk, ctx))
    # the prove starts from the allocator state it had before the debug check
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    with metrics.run_with_metric_collection() as collector, recorded_shapes() as shapes:
        proof = eng.prove(dpk, ctx)
    prove_s = time.perf_counter() - t0
    launches = K.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    data = encode_proof(proof)
    if encode_proof(decode_proof(data)) != data:
        raise AssertionError("the proof does not survive a codec round trip")
    vk_read = decode_vk(encode_vk(vk))
    t0 = time.perf_counter()
    eng.verify(vk_read, decode_proof(data))
    verify_s = time.perf_counter() - t0

    # negative checks: both must be refused
    tampered = decode_proof(data)
    opening = tampered.batch_constraint_proof.column_openings[0][0][0]
    opening[0] = (int(opening[0]) + 1) % P
    try:
        eng.verify(vk_read, tampered)
    except VerifierError as err:
        tamper_refusal = type(err).__name__
    else:
        raise AssertionError("the verifier accepted a proof with a tampered column opening")
    bad_ctx = ProvingContext([eng.context_for(0, bad_trace, [], [])])
    try:
        eng.debug([air], pk, bad_ctx)
    except AssertionError as err:
        bad_trace_refusal = str(err)
    else:
        raise AssertionError("the debug check passed a bad trace")
    if not bad_trace_refusal.endswith(f"failed at row {bad_row}"):
        raise AssertionError(f"the debug check refused the bad trace elsewhere: {bad_trace_refusal}")
    return {
        "setup_s": setup_s,
        "debug_s": debug_s,
        "prove_s": prove_s,
        "verify_s": verify_s,
        "spans_ms": {k: v for k, v in collector.snapshot().items() if k.endswith("_time_ms")},
        "proof_bytes": len(data),
        "proof_sha256": hashlib.sha256(data).hexdigest(),
        "peak_bytes": peak,
        "launches": launches,
        "shapes": shapes,
        "tamper_refusal": tamper_refusal,
        "bad_trace_refusal": bad_trace_refusal,
        "dag": vk.per_air[0].symbolic_constraints,
    }


def prove_synthetic(device, params, degree: int, log_rows: int = LOG_ROWS,
                    width: int = WIDTH, seed: int = SEED) -> dict:
    """The bench shape with a random witness (column 0 is the SyntheticAir
    kill column and stays zero, so any other values are a valid witness);
    the bad trace has a 1 in the kill column at one row."""
    import numpy as np

    from swirl_torch.fields.babybear import P
    from swirl_torch.testing.synthetic import SyntheticAir, uniform_shape

    air = SyntheticAir(uniform_shape(log_rows, width, num_constraints=16, num_interactions=8, degree=degree))
    trace = np.random.default_rng(seed).integers(0, P, (1 << log_rows, air.common_main_width()), dtype=np.uint64)
    trace[:, 0] = 0
    bad_row = (1 << log_rows) // 3
    bad = trace.copy()
    bad[bad_row, 0] = 1
    run = prove_and_check(device, params, air, trace, bad, bad_row)
    run["size"] = f"2^{log_rows} x {width}"
    return run


def prove_keccak(device, log_perms: int = KECCAK_LOG_PERMS, seed: int = SEED) -> dict:
    """The reference keccakf example's run: 2^log_perms random permutations
    (``examples/keccakf.py``'s inputs), app parameters. The bad trace has one
    a_prime bit flipped in the middle of the trace, which breaks theta's
    parity link and A's recomposition at that row only."""
    import numpy as np

    from swirl_torch.models.keccak import Cols, KeccakAir
    from swirl_torch.params import app_params_with_100_bits_security
    from swirl_torch.prover.dag_vectorized import get_schedule

    air = KeccakAir()
    inputs = np.random.default_rng(seed).integers(0, 1 << 63, (1 << log_perms, 5, 5), dtype=np.uint64)
    t0 = time.perf_counter()
    trace = air.generate_trace(inputs)
    trace_s = time.perf_counter() - t0
    log_height = trace.shape[0].bit_length() - 1
    params = app_params_with_100_bits_security(max(log_height + 2, 16))
    bad_row = trace.shape[0] // 2 + 5
    bad = trace.copy()
    bad[bad_row, Cols.a_prime(2, 3, 17)] ^= 1
    run = prove_and_check(device, params, air, trace, bad, bad_row)
    sched = get_schedule(run["dag"])
    run["size"] = f"2^{log_perms} permutations, trace 2^{log_height} x {trace.shape[1]}"
    run["extra"] = [
        f"trace generation {trace_s:.3f} s (host numpy)",
        f"DAG {len(run['dag'].nodes)} nodes, {len(run['dag'].constraint_idx)} constraints; "
        f"schedule {len(sched.levels)} levels, {len(sched.leaf_kinds)} live leaves, max_live {sched.max_live}",
    ]
    return run


def report(tag: str, run: dict, required) -> None:
    _say(f"{tag}: {run['size']}, setup {run['setup_s']:.3f} s, prove {run['prove_s']:.3f} s")
    for line in run.get("extra", []):
        _say(f"{tag}: {line}")
    _say(f"{tag}: debug check {run['debug_s']:.3f} s (on the card, before the prove)")
    _say(f"{tag}: verify {run['verify_s']:.3f} s (host verifier, the decoded proof bytes)")
    for name, ms in sorted(run["spans_ms"].items()):
        _say(f"{tag}: span {name} {ms:.1f}")
    _say(f"{tag}: peak device memory {run['peak_bytes']} B, proof {run['proof_bytes']} B "
         f"(sha256 {run['proof_sha256'][:16]}), codec round trip ok")
    _say(f"{tag}: kernel launches {run['launches']}")
    for name, shapes in sorted(run["shapes"].items()):
        _say(f"{tag}: {name} input shapes {sorted(shapes, key=lambda s: -math.prod(s))}")
        by_shape = ", ".join(f"{s}: {n}" for s, n in sorted(shapes.items(), key=lambda kv: -math.prod(kv[0])))
        _say(f"{tag}: {name} launches by input shape {{{by_shape}}}")
    _say(f"{tag}: tampered column opening refused by the verifier: {run['tamper_refusal']}")
    _say(f"{tag}: bad trace refused by the debug check: {run['bad_trace_refusal']}")
    missing = [name for name in required if run["launches"][name] == 0]
    if missing:
        raise AssertionError(f"{tag}: the path never launched {missing}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this test runs only on the card", file=sys.stderr)
        return 2
    from swirl_torch import kernels as K
    from swirl_torch import native
    from swirl_torch.params import (
        app_params_with_100_bits_security,
        leaf_params_with_100_bits_security,
    )

    device = torch.device("cuda", 0)
    start = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    _say(smi)
    _say(f"device: torch {torch.__version__} cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    K.LIB.get()
    _say(f"build: {time.perf_counter() - t0:.2f} s ({K.LIB.path})")
    for line in K.ptxas_summary(K.LIB.build_log):
        _say(f"build: {line}")
    _say(f"native host library loaded: {native.available()}")

    results = check_kernels(device)
    K.reset_launch_counts()
    check_golden(device)
    counts = K.launch_counts()
    _say(f"golden: kernel launches {counts}")

    app_kernels = [k.name for k in K.KERNELS if k is not K.NTT_RECURSIVE]
    app = prove_synthetic(device, app_params_with_100_bits_security(APP_LOG_STACKED), 3)
    report("app", app, app_kernels)
    torch.cuda.empty_cache()
    leaf = prove_synthetic(device, leaf_params_with_100_bits_security(LEAF_LOG_STACKED), 4)
    report("leaf", leaf, [k.name for k in K.KERNELS])
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    check_kernels(device, keccak=True)
    keccak = prove_keccak(device)
    report("keccak", keccak, app_kernels)
    _say(f"keccak: phase {time.perf_counter() - t0:.1f} s (kernel cases, trace, setup, debug, prove, "
         f"verify, refusals)")
    _say(f"total: {time.perf_counter() - start:.1f} s (build included)")

    # launches: the leaf path, the one path that runs all five kernels
    kernels = [
        {
            "name": k.name,
            "route": "cuda",
            "source": k.source,
            "replaces": k.replaces,
            "launches": leaf["launches"][k.name],
            **results[k.name],
        }
        for k in K.KERNELS
    ]
    _say(json.dumps({"kernels": kernels}))
    _say(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
