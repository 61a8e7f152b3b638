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
   it (``GRAPH_TIMED``: the tower, the 16-point coset NTT; kernels E and
   F): there it is the
   device's own clock, a CUDA graph of 10 calls replayed between two
   events. The tower and E run chains of dependent permutations: their
   floor is the chain's length times one quad permutation's longest
   dependent chain of field operations (``tools/isa.py``
   ``QUAD_PERM_CHAIN``) at the latencies its latency bench measures on the
   card, at the boost clock (the tower at n = 8192: 13 levels); E's own
   layout, a state word a lane, has its chain too (``ROW_PERM_CHAIN``,
   ``row_floor_ms``). Kernel K, GKR's layer sumcheck a pass a sub-round, at
   the app's column lengths 2^22, 2^16 and 2^8 (``GKR_CASES``) by graph
   replay beside its bytes bound and the floor of one launch, and its eq
   table at 22 variables. Kernel L, the batch sumcheck's EF4 product and
   product-and-sum, at the batch phase's shapes (``EF4_CASES``) the same
   way;
3. golden: the four golden proofs through the port's ``run_test`` on the
   card (debug check, prove, verify), byte for byte against
   ``tests/golden`` (vk, proof, transcript log), then proved again on a
   ``DeviceTranscript`` (the proof's bytes);
3b. queue_b: the port's modules beside the prover, each on the card. The
   monomial constraint engine against the DAG interpreter, bit for bit,
   with each one's ms (CUDA events, after a warm-up), aten ops (a launch or
   a view each) and peak: ``KeccakAir``'s constraints on 2^15 random rows in
   the base field and 2^12 in EF, and reth segment 13's ``KeccakfPermAir``
   shape (6,365 monomials) on 2^14. The plain sumchecks (multilinear, and
   prismalinear at l_skip 4) on 2^24 random EF values, verified with fresh
   transcripts, and a 2^10 prism proof's final claim against the host
   evaluation. The stacked commit as one CUDA graph at the app's shape (16
   x 2^22) and Keccak's (659 x 2^17): the replay's codeword and layers
   against the eager commit's, its root against ``stacked_commit``'s, the
   first results unchanged by two more commits on other inputs, the
   capture's seconds, replay, clone and eager ms, and kernels A-D's
   launches a commit (the counts reset just before the commit and read
   after: a replay enqueues no wrapper, so the capture's count is the
   graph's). The generic field zoo: for each of the eight fields, add, sub,
   mul and inv on 2^20 random elements against Python ints on 257 sampled
   lanes and a * a^-1 = 1 on every lane, with mul's and inv's ms. The
   golden cases through ``testing.golden.build_case`` on the card (the
   files' bytes), verified against a ``TranscriptValidator`` of the recorded
   log, which a log with one event changed must fail. The stage roofline of
   the app and leaf cells (``swirl_torch.roofline.report``) is printed
   after their proves, joined to their spans;
4. app: keygen, debug check, prove and verify of the 2^20 x 64
   ``SyntheticAir`` cell (degree 3) under
   ``app_params_with_100_bits_security(22)``; its proof's sha256, and the
   leaf's and Keccak's, held to ``PROOF_SHA256`` (``ROADMAP.md`` §D), with
   the GKR sub-rounds that kernel K evaluated and its launches;
5. leaf: the same for the 2^20 x 64 degree-4 cell under
   ``leaf_params_with_100_bits_security(25)``: 2 stacked columns of 2^25
   rows, so the RS encode is one (2, 2^27) NTT through A′;
6. keccak: the same for ``KeccakAir`` on 2^10 random permutations, the
   reference keccakf example's inputs and parameters (a 2^15 x 2633 trace,
   ``app_params_with_100_bits_security(17)``, RS encode (659, 2^18)); its
   40,535-node DAG runs through the level-scheduled interpreter, whose
   levels and ``max_live`` the phase prints, with the trace generation's
   seconds;
7. device transcript: kernels E (the sponge's duplex launches) and F (the
   proof-of-work grind) against their plain versions at the cases of the
   path (a GKR sub-round's absorb of 12 felts and squeeze of 4 from every
   entry cursor, an EF squeeze from every sample cursor, the absorb of the
   2^10-coefficient final polynomial and one felt either side of it,
   reth segment 13's 38,952-felt column openings (against the host
   transcript's sponge there), the query indices of a WHIR round;
   F at each width a prove grinds at: the query phase's 20 bits, the logup
   grind's 18, mu's 15 and folding's 5, over 16 seeded states each at
   absorb cursor i mod 8, every witness and state bit for bit, with each
   width's mean ms, mean witness, ns a candidate and summed bound and
   floor), and, in the app and Keccak
   phases, a second prove on ``DeviceTranscript()``: its proof's sha256
   must equal the host-transcript proof's, E and F must have launched, and
   the longest absorb of E's launches is printed (the longest case of
   ``DUPLEX_CASES`` beside it), and each stage span's host reads
   (``swirl_torch.testing.host_reads``: each
   waits for the card's stream, as does each host write, a tensor made from
   host data, printed beside them) must not exceed the fixed numbers that
   the CPU tests hold (``STAGE_READS``): the sponge stays on the card from
   the RAP stage to the end of WHIR, and no round reads the host (the
   leaf too);
8. memory policy: the app proves under the default ``ProverConfig``
   (log_blowup 1: round 0's coset grids in 8 segments) and once more on the
   host transcript with ``zerocheck_save_memory=False``; the leaf once more
   with both caches off (the stacked matrix and the RS codewords recomputed
   where they are read, so kernel A or A′ launches again). Each extra
   prove's bytes must equal the verified proof's (no second debug check
   or verify). Every prove prints its peak device memory by stage span
   (the peak since the last span boundary, charged to the innermost span
   open), and for the app, leaf and Keccak proves the memory model's
   estimate (``eng.proving_memory_config().estimate``, total and each
   component) beside the measured peak, with the ratio; the estimate must
   not be below the peak, nor its batch phase (the traces, the cached
   matrices and the batch term) below the ``zerocheck_round0`` span's peak;
9. outer: the golden ``outer`` case (the BN254 outer hash scheme) through
   ``run_test`` on the card, its Merkle trees (kernels H, I) and grinds (J)
   there: its recorded transcript must equal
   ``tests/golden/outer.transcript.txt`` event for event (the first
   divergence is printed) and its vk pre-hash ``outer.prehash.txt``; H, I
   and J must launch; the port's verifier refuses a tampered commit, a
   tampered Merkle sibling and a non-scalar digest; a ``DeviceTranscript``
   is refused under the scheme;
10. outer root: the leaf's 2^20 x 64 degree-4 ``SyntheticAir`` under
   ``root_params_with_100_bits_security(21)`` with the BN254 outer scheme
   (RS (32, 2^25); WHIR 3 rounds of 88, 81 and 81 queries; grinds of 15,
   5 and 20 bits, LogUp 18 or more): debug check, prove, verify and the
   two refusals as for the other cells, with H, I and J launching in the
   prove, ``build_host_tree`` refusing to run and no device-to-host copy
   of a codeword's size; kernel J's searches of the prove and their ms,
   summed by bits (CUDA events around each call, which reads its witness).
   The codec holds the inner scheme's digests only,
   so this proof is verified as the prover returned it and its sha256 is
   taken over its fields;
11. reth: OpenVM reth segments of ``benchmarks/reth-block-23992138-atlas.json``
   (``load_segment_atlas`` at the 2^22 clamp), each as one multi-AIR proof
   of every AIR at its atlas height, random traces from a seed (the kill
   column zero), under ``benchmarks/synthetic_runner.py``'s degree-4
   parameters (``segment_fit.runner_params``): segment 204 (42 AIRs) and
   segment 13 (22 AIRs, 5.05e8 main cells, an RS codeword of (121, 2^23));
   segment 3 takes 13's place, stated, if 13 runs out of device memory.
   For each: keygen and ``audit_vk`` (total bits and findings), the debug
   check, the prove on the host transcript and on ``DeviceTranscript()``
   (the same sha256), the verifier, the two refusals, the AIRs, main cells
   and GKR leaves, the ``trace_metrics`` gauges, launches and host reads,
   the peak by span beside the memory model. Then A and B at the
   segment's codeword against their plain versions on slices;
12. fused: ``prove_fused`` (``swirl_torch/prover/fused.py``) on the app
   cell in its three modes (eager, jit, segmented) and on the leaf and
   Keccak cells segmented, each right after the cell's own proves, on its
   proving key and context: the proof's sha256 must be the cell's
   device-transcript prove's in every call, one host read a prove (the
   fetch); the first call's seconds (the eager warm-up, capture and
   instantiation of the graph modes), the mean of 3 replays, the peaks
   beside the device-transcript prove's, the aten ops the capture records
   and the kernel launches while capturing (a replay enqueues no wrapper).
   The app's jit warm-up (its eager bodies, after the eager mode made
   every table) runs under ``torch.cuda.set_sync_debug_mode("error")``; its
   segmented graphs replay a second trace of the shape (its own
   device-transcript bytes, the first proof unchanged); the
   ``interactions`` golden case, captured, refuses the unbalanced receiver
   trace on replay at the fetch; the ``cached_preprocessed`` golden case,
   captured, then its context freed and the blocks refilled, replays a
   fresh context of the same cached trace to the golden bytes. Each cell's
   graphs are released after it. The phase prints its seconds, the Keccak
   phase's apart;
13. mesh: right after the fused app cell, the app through
   ``prove_fused(mode="segmented", mesh=proof_mesh())``, a world of one on
   NCCL (``swirl_torch/parallel/``): the sha256 008305aaf187766a, one host
   read a prove, kernels A-F launched and the commits' collectives issued
   while capturing, the first call's split, the mean of 3 replays, the
   peaks and the aten ops, as in phase 12; then ``mode="jit"`` once. After
   the app is released, two gloo ranks spawned on the card
   (``chip_smoke.py --mesh-rank``) run the prover's sharded commit of the
   app's stacked shape (16, 2^22) on CUDA tensors: each rank's root,
   codeword and gathered layers equal this process's one-device commit,
   A-D launch on each rank, the wrapper refuses the collective gloo does
   not take on CUDA tensors, and both graph modes refuse the gloo mesh.
   The phase prints its seconds.

Phase 2 also holds the BN254 kernels to their plain versions: G on every
operation over 2^20 random and the edge operands; H's permutations at
widths 2 and 3 and its compress at the outer root cell's pairing strides
(plain on slices of the big levels); I on (32, 2^16) and (1, 2^16, 4)
slices of the path's codewords (then timed alone at (32, 2^25) and (1,
2^24, 4)); J, its operands by value as the outer transcript passes them,
from every sponge cursor at 5 bits (against the host loop too), 15 bits
and 18 bits (the logup grind; against the plain search on [0, w]), at
20 bits where the query grind runs (against the
plain search) and from every cursor (the witness checked by the host).
Phase 1 prints ``tools/isa.py``'s SASS census of G-J beside the bound's
model of a BN254 product and permutation, and the least SM-clocks a
permutation can take by that census; phase 2 prints the least time it
allows (``floor_ms``) beside the model's (``model_bound_ms``) for each H,
I and J case, and takes the lower of the two as the bound.

Phases 4 to 6, 10 and 11 use random traces from a seed. The debug check runs on
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
a_prime bit of Keccak flipped at a row in the middle of the trace (a reth
segment: the kill column of its first AIR with two or more constraints and
at least 2^l_skip rows).

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

from swirl_torch.roofline import (ADD, BOOST_HZ, BUTTERFLY, HBM_BYTES_PER_S, MONT_MUL, PERM, SMS, THREADS_PER_SM,
                                  bound, plus, times)

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
# the cells' proofs (ROADMAP.md §D): every transcript and mode gives these bytes
PROOF_SHA256 = {"app": "008305aaf187766a", "leaf": "50130138ca9e76e3", "keccak": "45238a82c84e1d66"}

# The least time of a kernel's work, and the per-operation model it counts
# in (MONT_MUL, ADD, PERM, BUTTERFLY: multiplies and other 32-bit integer
# operations), are swirl_torch/roofline.py's: the larger of its bytes over
# the H100's 3.35 TB/s and its operations over the rate of the pipes that
# run them, max(m, (m + a) / 2) / (64 x 132 x 1.98e9) seconds.

# BN254 (kernels G-J, csrc/bn254.cuh), the same model, kept as the yardstick
# that every design's time is read against: an 8-word CIOS product issues
# 128 32 x 32 -> 64-bit multiply-adds (IMAD.WIDE: a * b_i and m * P) and 8
# quotient products m = t_0 * (-P^-1), with about two other operations for
# each multiply-add's carry and 24 for the final conditional subtract; an
# add or a subtract 8 add-with-carry and 16 for the conditional subtract.
# The kernels' products run on the FP64 pipe, which the model does not
# count: tools/isa.py's census of their SASS is printed (phase 1), and for
# H, I and J the least time it allows (isa.bn254_perm_floor, ``floor_ms``)
# stands beside the model's (``model_bound_ms``); the lower is the bound.
BN_MONT, BN_ADD = (136, 2 * 128 + 24), (0, 24)
# a permutation: S-boxes x^5 of 3 products (width 3: 8 x 3 + 56 = 80; width
# 2: 6 x 2 + 50 = 62), the round-constant adds, the external layers'
# (t - 1) + t adds (rF + 1 of them) and the internal layers' (t - 1) + 1 + t
BN_PERM = {
    t: tuple(3 * (rf * t + rp) * m + ((rf + 1) * (2 * t - 1) + rf * t + rp + rp * 2 * t) * a
             for m, a in zip(BN_MONT, BN_ADD))
    for t, rf, rp in ((3, 8, 56), (2, 6, 50))
}
# the outer root cell: root_params_with_100_bits_security(21), RS (32,
# 2^25), WHIR codewords (1, 2^24, 4), (1, 2^23, 4), (1, 2^22, 4), 16 rows a
# query (query strides 2^21 down to 2^18)
OUTER_LOG_STACKED = 21
# the reth replay: benchmarks/synthetic_runner.py's atlas, its --max-log-height
# default (the reference runner's clamp), the segment the JAX package proved
# (204: 42 AIRs) and the heaviest screening-tier segment the memory model
# admits on 80 GB (13: 22 AIRs, 5.05e8 main cells); segment 3 takes 13's
# place if 13 runs out of device memory
RETH_ATLAS = "benchmarks/reth-block-23992138-atlas.json"
RETH_MAX_LOG_HEIGHT = 22
RETH_SEGMENTS = (204, 13)
RETH_SUBSTITUTE = {13: 3}
RETH_SLICE_ROWS = 4  # rows of A's input a plain slice takes, at three offsets
RETH_SLICE_COLS = 1 << 12  # columns of B's input a plain slice takes, at three offsets


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
    return 2 * batch * n * 8, times(BUTTERFLY, butterflies)


def hash_work(shape):
    """hash_cols on (w, H) or (w, H, d): w*d*H words in, 8*H out; one
    permutation per 8 absorbed words of each row."""
    w, h = shape[0] * (shape[2] if len(shape) == 3 else 1), shape[1]
    return (w + 8) * h * 8, times(PERM, h * -(-w // 8))


def compress_work(shape):
    """compress_cols on (16, n): 16n words in, 8n out, n permutations."""
    _, n = shape
    return 24 * n * 8, times(PERM, n)


def layer_work(shape):
    """compress_layer on an (8, n) layer: the work of (16, n/2) pairs."""
    return compress_work((16, shape[1] // 2))


def tower_work(shape):
    """The tower on (8, n): 8n words in, every level out."""
    _, n = shape
    return (8 * n + 8 * (n - 1)) * 8, times(PERM, n - 1)


def bn_hash_work(shape):
    """Kernel I on (w, h) or (w, h, d): w*d*h int64 words in, h 32-byte
    digests out; per leaf a permutation for each 16 absorbed felts, a
    conversion to Monty form for each 8 and one out of it."""
    w, h = shape[0] * (shape[2] if len(shape) == 3 else 1), shape[1]
    perms, packs = -(-w // 16), -(-w // 8)
    return w * h * 8 + 32 * h, times(plus(times(BN_PERM[3], perms), times(BN_MONT, packs + 1)), h)


def bn_layer_work(n: int):
    """Kernel H's compress on n digests: n in, n/2 out (32 B each); per
    output a width-2 permutation and three conversions."""
    return (n + n // 2) * 32, times(plus(BN_PERM[2], times(BN_MONT, 3)), n // 2)


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

# Kernel E's cases: (label, absorb cursor, sample cursor, device felts, host
# felts, squeezes, bits). A GKR sub-round absorbs its 12 evaluation felts
# and squeezes an EF challenge, from every entry cursor; an EF squeeze from
# every sample cursor (1 to 3 squeeze across a permutation); the app's
# WHIR final polynomial, 2^10 EF coefficients; the app's first WHIR round's
# 193 query indices of 19 bits, after the query grind (cursor (0, 7)); a
# run with host felts; absorbs of one felt either side of the final
# polynomial's and one of host felts after device felts that ends on a
# block's end; the longest absorb of the cells' proves, reth segment 13's
# column openings (38,952 felts; Keccak's 2,633 columns make 21,064), held
# against the host transcript's sponge (``HOST_CHECKED``: duplex_plain takes
# about 29 s there).
LONGEST_ABSORB = 38952
DUPLEX_CASES = (
    [(f"gkr_subround_from_{c}", c % 8, c, 12, 0, 4, -1) for c in range(9)]
    + [(f"sample_ext_from_{c}", 0, c, 0, 0, 4, -1) for c in range(9)]
    + [("final_poly_absorb", 0, 4, 4 << 10, 0, 0, -1),
       ("query_indices", 0, 7, 0, 0, 193, 19),
       ("host_felts", 3, 5, 5, 7, 1, -1),
       ("absorb_4095", 0, 4, (4 << 10) - 1, 0, 4, -1),
       ("absorb_4097", 0, 4, (4 << 10) + 1, 0, 4, -1),
       ("absorb_4088_and_5_host_from_3", 3, 8, (4 << 10) - 8, 5, 4, -1),
       ("longest_absorb", 0, 4, LONGEST_ABSORB, 0, 4, -1)]
)
HOST_CHECKED = ("longest_absorb",)
# Kernel F's widths: (label, bits) of the grinds of a prove: the query
# phase's, the logup grind's, mu's and the folding rounds'. Each runs over
# GRIND_STATES states (``grind_states``), at absorb cursor i mod 8.
GRIND_CASES = (("query_grind", 20), ("logup_grind", 18), ("mu_grind", 15), ("folding_grind", 5))
GRIND_STATES = 16


def grind_states(bits: int, device, n: int = GRIND_STATES):
    """(n, 16) canonical states from numpy's generator seeded 1000 + bits,
    and their absorb cursors i mod 8."""
    import numpy as np
    import torch

    from swirl_torch.fields.babybear import P

    rng = np.random.default_rng(1000 + bits)
    return torch.tensor(rng.integers(0, P, (n, 16)).astype(np.int64), device=device), [i % 8 for i in range(n)]


def transcript_inputs(device):
    """E's inputs, in case order, from one generator seeded SEED + 1:
    (case, state, absorb, host)."""
    import torch

    from swirl_torch.fields.babybear import P

    gen = torch.Generator(device=device)
    gen.manual_seed(SEED + 1)

    def rand(*shape):
        return torch.randint(0, P, shape, generator=gen, device=device, dtype=torch.int64)

    for case in DUPLEX_CASES:
        k, n_host = case[3], case[4]
        st, absorb = rand(16), rand(k) if k else None
        yield case, st, absorb, [int(v) for v in rand(n_host).cpu()]


def duplex_host(state, absorb, host, a: int, s: int, n_squeeze: int, bits: int):
    """Kernel E's function by the host transcript's sponge
    (``swirl_torch.transcript.Transcript``, its permutation the native host
    library's when loaded): (new state, squeezed values) as tensors on
    ``state``'s device."""
    import numpy as np
    import torch

    from swirl_torch.transcript import Transcript

    t = Transcript()
    t.state, t.absorb_idx, t.sample_idx = state.cpu().numpy().astype(np.uint64), a, s
    for v in ([] if absorb is None else absorb.cpu().tolist()) + list(host):
        t.observe(v)
    out = [t.sample() for _ in range(n_squeeze)]
    out = [v & ((1 << bits) - 1) for v in out] if bits >= 0 else out
    return (torch.tensor(t.state.astype(np.int64), device=state.device),
            torch.tensor(out, dtype=torch.int64, device=state.device))


def duplex_perms(a, s, k, n_squeeze) -> int:
    """The permutations, all in one dependent chain, of a duplex launch."""
    perms = (a + k) // 8
    a = (a + k) % 8
    if perms:
        s = 8
    for _ in range(n_squeeze):
        if a != 0 or s == 0:
            perms, a, s = perms + 1, 0, 8
        s -= 1
    return perms


def check_transcript_kernels(device, perm_floor_ms: float, row_floor_ms: float) -> dict:
    """Kernel E against its plain version on seeded random states and
    felts, bit for bit (the new state, the squeezed values), timed by CUDA
    graph replay (it runs faster than Python enqueues it). Its ms beside the
    bound and its floors: the chain of its
    launch's dependent permutations times ``perm_floor_ms`` (one quad
    permutation's latency floor, ``floor_ms``) and times ``row_floor_ms``
    (E's own layout, a word a lane: ``row_floor_ms``), and its ms per
    permutation; its plain version timed once, by the call that is compared
    (``HOST_CHECKED`` rows: the host transcript's sponge, ``host_ms``)."""
    import torch

    from swirl_torch import kernels as K
    from swirl_torch.hash import poseidon2 as p2

    results = {}
    for case, st0, absorb, host in transcript_inputs(device):
        label, a, s, k, n_host, n_squeeze, bits = case
        st = st0.clone()
        got = torch.cat([p2.duplex(st, absorb, host, a, s, n_squeeze, bits), st])
        ref, what = (duplex_host, "host_ms") if label in HOST_CHECKED else (p2.duplex_plain, "plain_ms")
        (new, out), plain_ms = _timed_ms(lambda: ref(st0, absorb, host, a, s, n_squeeze, bits))
        err = _max_abs_err(got, torch.cat([out, new]))
        if err:
            raise AssertionError(f"kernel duplex [{label}]: max_abs_err {err}")
        ms = _graph_time_ms(lambda: p2.duplex(st, absorb, host, a, s, n_squeeze, bits), reps=10)
        perms = duplex_perms(a, s, k + n_host, n_squeeze)
        work = ((16 + k) * 8 + (16 + n_squeeze) * 8, times(PERM, perms))
        bound_ms, bound_by = bound(work)
        floor_ms, row_ms = perms * perm_floor_ms, perms * row_floor_ms
        per = f" ({1e3 * ms / perms:.2f} us a permutation)" if perms else ""
        _say(
            f"kernel duplex [{label}] cursors=({a}, {s}) absorb={k}+{n_host} squeeze={n_squeeze} bits={bits} "
            f"equal=True max_abs_err={err} ms={ms:.4f} (by CUDA graph replay){per} {what}={plain_ms:.4f} "
            f"bound_ms={bound_ms:.6f} ({bound_by}) floor_ms={floor_ms:.4f} ({perms} x the quad permutation's "
            f"floor) row_floor_ms={row_ms:.4f} ({perms} x the row permutation's floor)"
        )
        results.setdefault(K.DUPLEX.name, {
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None, "floor_ms": floor_ms, "row_floor_ms": row_ms,
        })
    return results


def time_grind(st0, a: int, bits: int, label: str) -> tuple:
    """Kernel F from one state: one launch, its witness and advanced state
    bit for bit against ``grind_plain``'s (whose time is the plain one),
    then its ms by CUDA graph replay with the state restored before every
    call; (ms, witness, plain_ms)."""
    from swirl_torch import kernels as K
    from swirl_torch.hash import poseidon2 as p2

    st = st0.clone()
    before = K.GRIND.launches
    w = p2.grind(st, a, bits)
    if K.GRIND.launches != before + 1:
        raise AssertionError(f"kernel grind [{label}]: {K.GRIND.launches - before} launches a grind")
    (new, want_w), plain_ms = _timed_ms(lambda: p2.grind_plain(st0, a, bits))
    err = max(_max_abs_err(st, new), _max_abs_err(w, want_w))
    if err:
        raise AssertionError(f"kernel grind [{label}] cursor={a}: max_abs_err {err}")
    witness = int(w.item())

    def fk():
        st.copy_(st0)
        p2.grind(st, a, bits)

    with K.private_tickets(st0.device):  # the timing's side stream keeps no (found word, ticket) pair
        ms = _graph_time_ms(fk, reps=10)
    return ms, witness, plain_ms


def check_grind_widths(device, row_floor_ms: float, scalar_floor_ms: float) -> dict:
    """Kernel F at each width of ``GRIND_CASES`` over its ``grind_states``,
    each state by :func:`time_grind`. A state's bound: its w + 1
    candidates (``roofline.GRIND_CANDIDATE`` each) and the advance (a
    permutation); its floor: the sweeps of ``p2.grind_plan`` up to the
    witness's, each one permutation's chain (the scalar one on the sweep
    route, the row one on the rows route), then the advance's row chain.
    Prints each width's mean ms, mean witness, ns a candidate (the summed
    ms over the summed w + 1) and the summed bound and floor; returns the
    20-bit width's figures (each the mean of a grind) with every width's
    under "widths"."""
    import torch

    from swirl_torch.hash import poseidon2 as p2
    from swirl_torch.roofline import GRIND_CANDIDATE

    sms = torch.cuda.get_device_properties(device).multi_processor_count
    widths = []
    for label, bits in GRIND_CASES:
        plan = p2.grind_plan(bits, sms)
        chain_ms = scalar_floor_ms if plan["route"] == "sweep" else row_floor_ms
        states, cursors = grind_states(bits, device)
        ms, plain_ms, witnesses, bound_ms, floor_ms = [], [], [], 0.0, 0.0
        for st0, a in zip(states, cursors):
            t, witness, t_plain = time_grind(st0, a, bits, label)
            ms.append(t)
            plain_ms.append(t_plain)
            witnesses.append(witness)
            bound_ms += bound((2 * 16 * 8 + 8, plus(times(GRIND_CANDIDATE, witness + 1), PERM)))[0]
            floor_ms += (witness // plan["per_sweep"] + 1) * chain_ms + row_floor_ms
        cands = sum(witnesses) + len(witnesses)
        row = {
            "bits": bits, "states": len(ms), "route": plan["route"], "blocks": plan["blocks"],
            "per_sweep": plan["per_sweep"], "ms": sum(ms) / len(ms), "mean_witness": cands / len(ms) - 1,
            "ns_per_candidate": 1e6 * sum(ms) / cands, "plain_ms": sum(plain_ms) / len(ms),
            "bound_ms": bound_ms / len(ms), "floor_ms": floor_ms / len(ms), "max_abs_err": 0,
        }
        widths.append(row)
        _say(
            f"kernel grind [{label}] bits={bits} over {len(ms)} states (cursor i mod 8): equal=True max_abs_err=0 "
            f"route={plan['route']} ({plan['blocks']} blocks, sweeps of {plan['per_sweep']}) mean ms={row['ms']:.4f} "
            f"(by CUDA graph replay, the state's restore included) mean witness={row['mean_witness']:.1f} "
            f"({row['ns_per_candidate']:.4f} ns a candidate) plain_ms={row['plain_ms']:.4f} summed bound_ms="
            f"{bound_ms:.6f} (operations; the w + 1 candidates and the advance) summed floor_ms={floor_ms:.4f} "
            f"(the plan's sweeps up to each witness and the advance, each one permutation's chain); ms "
            f"{' '.join(f'{t:.4f}' for t in ms)}"
        )
    top = widths[0]
    return {
        "max_abs_err": 0, "ms": top["ms"], "plain_ms": top["plain_ms"], "bound_ms": top["bound_ms"],
        "bound_by": "operations", "library_ms": None, "floor_ms": top["floor_ms"], "widths": widths,
    }


def _bn_rand(gen, n: int, device):
    """(n, 8) int32 words of values below P_BN254 (the top word below P's),
    then the edge operands 0, 1, P - 1 and P itself."""
    import numpy as np
    import torch

    from swirl_torch.fields import bn254 as fb

    w = torch.randint(-(1 << 31), 1 << 31, (n, 8), generator=gen, device=device, dtype=torch.int32)
    w[:, 7] = torch.randint(0, 0x30644E72, (n,), generator=gen, device=device, dtype=torch.int32)
    edges = fb.tensor(np.stack([fb.limbs_from_int(v) for v in (0, 1, fb.P - 1, fb.P)]), device)
    return torch.cat([w, edges])


# Kernel H's compress levels in the outer root cell: (label, digests in,
# pairing stride): the main commit's first strided level (2^25 leaves, 16
# rows a query), a level of the tower (plain on all of it), the first
# strided level of each WHIR codeword's tree, then the first level above
# the main tree's query stride
BN_LAYER_CASES = (
    ("root_main_strided", 1 << 25, 1 << 21),
    ("root_tower_level", 1 << 17, 1),
    ("root_whir_strided", 1 << 24, 1 << 20),
    ("root_whir_strided_2", 1 << 23, 1 << 19),
    ("root_whir_strided_3", 1 << 22, 1 << 18),
    ("root_main_above_stride", 1 << 21, 1),
)
BN_SLICE = 1 << 12  # outputs a plain slice checks, at three offsets, on the big inputs
# Kernel I at the path's shapes: the main commit's RS codeword and WHIR's
# two codewords, read in place as (1, h, 4)
BN_LEAF_CASES = (("root_codeword", (32, 1 << 25)), ("root_whir_codeword", (1, 1 << 24, 4)),
                 ("root_whir_codeword_2", (1, 1 << 23, 4)))
# Kernel J: (label, absorb cursor, pending felts, bits, check) from every
# cursor the prover reaches (absorb 0 or 1, 0-7 pending felts): the query
# phase's 20 bits after observe_ext (4 pending felts) against the plain
# search; 15 bits against it (absorb cursor 0); 5 bits against it and the host loop; 20 bits
# with the witness checked by the host transcript's check_witness and shown
# the least by a search of [0, w) that finds nothing (the plain search
# takes 13 s a case there); the logup grind's 18 bits from every cursor
# against the plain search on [0, w] (its least hit is the whole search's)
BN_CURSORS = [(a, k) for a in (0, 1) for k in range(8)]
BN_GRIND_CASES = (
    [("query_grind", 0, 4, 20, "plain")]
    + [(f"cursor_{a}_{k}", a, k, 15, "plain") for a, k in BN_CURSORS if a == 0]
    + [(f"cursor_{a}_{k}", a, k, 5, "host") for a, k in BN_CURSORS]
    + [(f"cursor_{a}_{k}", a, k, 20, "witness") for a, k in BN_CURSORS]
    + [(f"logup_{a}_{k}", a, k, 18, "below") for a, k in BN_CURSORS]
)


def bn_grind_inputs():
    """[(case, lanes, felts)] of ``BN_GRIND_CASES``: the sponge's three
    lanes and the pending felts, from a numpy generator seeded SEED + 3."""
    import numpy as np

    from swirl_torch.fields import bn254 as fb
    from swirl_torch.fields.babybear import P

    rng = np.random.default_rng(SEED + 3)
    out = []
    for case in BN_GRIND_CASES:
        lanes = [int.from_bytes(rng.bytes(32), "little") % fb.P for _ in range(3)]
        out.append((case, lanes, [int(v) for v in rng.integers(0, P, case[2])]))
    return out


def check_bn254_kernels(device, perm_floor) -> dict:
    """Kernels G-J against their plain versions, bit for bit, at the outer
    root cell's shapes (the plain versions on slices of H's and I's big
    inputs, their times summed over the slices); G and H timed by CUDA
    events (mean of 10), I (mean of 3), J by events around each call (its
    witness's read included); each beside its bound and the plain version's
    time. H's, I's and J's bound is the lower of the work model's
    (``model_bound_ms``, which counts no FP64 pipe) and the least time
    their permutations' own SASS census allows (``floor_ms``; ``perm_floor``
    is ``isa.bn254_perm_floor``'s SM-clocks a lane's permutation of each
    width); without it they fail. The first case of each kernel is the one
    the ``kernels`` line reports."""
    import torch

    from swirl_torch import kernels as K
    from swirl_torch.fields import bn254 as fb
    from swirl_torch.fields.babybear import P
    from swirl_torch.hash import bn254_poseidon2 as bp
    from swirl_torch.hash.multi_field import MultiFieldTranscript, pack_felts

    gen = torch.Generator(device=device)
    gen.manual_seed(SEED + 2)
    results = {}

    def record(kernel, label, shape, err, ms, plain_ms, work, how="", perms=None):
        bound_ms, bound_by = bound(work)
        extra, floor = {}, ""
        if perms is not None:
            # H, I, J: the model counts no FP64 pipe, so the bound is the
            # lower of the model's and the design's own census floor
            t, count = perms
            if t not in (perm_floor or {}):
                raise AssertionError(f"kernel {kernel.name} [{label}]: no census floor for width {t}")
            clocks, pipe = perm_floor[t]
            byte_ms = work[0] / HBM_BYTES_PER_S * 1e3
            op_ms = count * clocks / (SMS * BOOST_HZ) * 1e3
            floor_ms = max(byte_ms, op_ms)
            extra = {"model_bound_ms": bound_ms, "floor_ms": floor_ms}
            floor = (f" model_bound_ms={bound_ms:.4f} ({bound_by}; the CIOS model) floor_ms={floor_ms:.4f} ({pipe}; "
                     f"the design's own census, {count} width-{t} permutations)")
            if floor_ms < bound_ms:
                bound_ms, bound_by = floor_ms, "bytes" if byte_ms >= op_ms else "operations"
        _say(f"kernel {kernel.name} [{label}] shape={shape} equal=True max_abs_err={err} ms={ms:.4f} "
             f"plain_ms={plain_ms:.4f}{how} bound_ms={bound_ms:.4f} ({bound_by}){floor}")
        results.setdefault(kernel.name, {
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None, **extra,
        })

    # G: every operation; mont_mul timed
    n = 1 << 20
    a, b = _bn_rand(gen, n, device), _bn_rand(gen, n, device).flip(0).contiguous()
    for op in ("mont_mul", "add", "sub", "from_canonical", "to_canonical", "dbl"):
        two = op in ("add", "sub", "mont_mul")
        fk = (lambda op=op: getattr(fb, op)(a, b)) if two else (lambda op=op: getattr(fb, op)(a))
        fp = lambda op=op, two=two: fb.op_plain(op, a, b if two else None)
        err = _max_abs_err(fk(), fp())
        if err:
            raise AssertionError(f"kernel bn254_field [{op}]: max_abs_err {err}")
        ms = _cuda_time_ms(fk, reps=10)
        plain_ms = _cuda_time_ms(fp, reps=2)
        ops = BN_MONT if op in ("mont_mul", "from_canonical", "to_canonical") else BN_ADD
        record(K.BN254_FIELD, op, tuple(a.shape), err, ms, plain_ms, (3 * 32 * a.shape[0], times(ops, a.shape[0])))
    del a, b

    # H: the permutations, then the compress levels
    for t in (3, 2):
        st = _bn_rand(gen, (1 << 14) * t, device)[: (1 << 14) * t].reshape(1 << 14, t, 8)
        err = _max_abs_err(bp.permute_dev(st, t), bp.permute_plain(st, t))
        if err:
            raise AssertionError(f"kernel bn254_merkle [permute width {t}]: max_abs_err {err}")
        _say(f"kernel bn254_merkle [permute width {t}] shape={tuple(st.shape)} equal=True "
             f"ms={_cuda_time_ms(lambda: bp.permute_dev(st, t), reps=10):.4f}")
    for label, n, stride in BN_LAYER_CASES:
        layer = fb.to_canonical(_bn_rand(gen, n, device)[:n])
        got = bp.compress_layer(layer, stride)
        if n <= 1 << 17:
            err = _max_abs_err(got, bp.compress_layer_plain(layer, stride))
            plain_ms = _cuda_time_ms(lambda: bp.compress_layer_plain(layer, stride), reps=2)
            how = ""
        else:
            # outputs [c, c + k): at a stride of at least k they pair the k
            # digests from 2s (c / s) + c % s with those s after; below it,
            # digests [2c, 2c + 2k) at the same stride
            err, plain_ms = 0, 0.0
            for c in (0, n // 4 + stride // 2, n // 2 - BN_SLICE):
                if stride >= BN_SLICE:
                    left = 2 * stride * (c // stride) + c % stride
                    sub = torch.cat([layer[left : left + BN_SLICE], layer[left + stride : left + stride + BN_SLICE]])
                    sub_stride = BN_SLICE
                else:
                    sub, sub_stride = layer[2 * c : 2 * c + 2 * BN_SLICE], stride
                want, ms_ = _timed_ms(lambda: bp.compress_layer_plain(sub, sub_stride))
                err = max(err, _max_abs_err(got[c : c + BN_SLICE], want))
                plain_ms += ms_
            how = f" (plain on 3 slices of {BN_SLICE} outputs)"
        if err:
            raise AssertionError(f"kernel bn254_merkle [{label}]: max_abs_err {err}")
        del got
        ms = _cuda_time_ms(lambda: bp.compress_layer(layer, stride), reps=10)
        record(K.BN254_MERKLE, f"{label}, stride {stride}", tuple(layer.shape), err, ms, plain_ms,
               bn_layer_work(n), how, (2, n // 2))
        del layer
        torch.cuda.empty_cache()

    # I: the path's shapes; rows [c, c + BN_SLICE) of the output against
    # plain on those columns of the codeword, at three offsets
    for label, shape in BN_LEAF_CASES:
        x = torch.randint(0, P, shape, generator=gen, device=device, dtype=torch.int64)
        got = bp.hash_rows(x)
        err, plain_ms = 0, 0.0
        for c in (0, shape[1] // 3, shape[1] - BN_SLICE):
            want, ms_ = _timed_ms(lambda: bp.hash_rows_plain(x[:, c : c + BN_SLICE]))
            err = max(err, _max_abs_err(got[c : c + BN_SLICE], want))
            plain_ms += ms_
        if err:
            raise AssertionError(f"kernel bn254_hash_rows [{label}]: max_abs_err {err}")
        del got
        ms = _cuda_time_ms(lambda: bp.hash_rows(x), reps=3)
        w = shape[0] * (shape[2] if len(shape) == 3 else 1)
        record(K.BN254_LEAVES, label, shape, err, ms, plain_ms, bn_hash_work(shape),
               f" (plain on 3 slices of {BN_SLICE} rows)", (3, shape[1] * -(-w // 16)))
        del x
        torch.cuda.empty_cache()

    # J: from every cursor, its operands by value as the outer transcript
    # passes them; the witness equals the plain search's (at 18 bits the
    # plain search on [0, w], whose least hit is the whole search's; at 5
    # bits also the host loop's)
    for (label, cur, k, bits, check), lanes, felts in bn_grind_inputs():
        pending = pack_felts(felts)[0] if k else 0
        state = fb.from_ints([*lanes, pending], device)
        w = bp.grind_ints(lanes, pending, cur, 31 * k, bits, device=device)
        t = MultiFieldTranscript()
        t._sponge.state, t._sponge.absorb_idx, t._sponge.sample_idx = list(lanes), cur, 2
        t._obs_buf = list(felts)
        what = f"kernel bn254_grind [{label}, {bits} bits]: witness {w}"
        if check == "witness":
            if w < 0 or not t.check_witness(bits, w):
                raise AssertionError(f"{what} fails the host's check_witness")
            below = bp.grind_ints(lanes, pending, cur, 31 * k, bits, end=w, device=device)
            if below != -1:
                raise AssertionError(f"{what}, but a search of [0, {w}) finds {below}")
            _say(f"kernel bn254_grind [{label}] cursor ({cur}, {k} felts) bits={bits} witness={w}, "
                 f"accepted by the host's check_witness; a search of [0, {w}) finds none")
            continue
        end = w + 1 if check == "below" else None
        want, plain_ms = _timed_ms(lambda: bp.grind_plain(state, cur, 31 * k, bits, end))
        if w != want or w < 0:
            raise AssertionError(f"{what} against the plain search's {want}")
        how = " (plain on [0, w])" if end else ""
        if check == "host":
            host_w = t.grind(bits)
            if host_w != w:
                raise AssertionError(f"{what} against the host loop's {host_w}")
            how = f", host loop {host_w}"
        ms = _cuda_time_ms(lambda: bp.grind_ints(lanes, pending, cur, 31 * k, bits, device=device), reps=10)
        work = (8, times(plus(BN_PERM[3], times(BN_MONT, 2)), w + 1))
        record(K.BN254_GRIND, f"{label}, cursor ({cur}, {k} felts), {bits} bits, witness {w}{how}", (4, 8),
               0, ms, plain_ms, work, " (ms by events, the witness's read included; bound: the candidates "
               "up to the witness)", (3, w + 1))
    return results


# Kernel K's passes at the app's column lengths m (2^23 interactions pad
# to 2^24 fractions: 23 layers, the largest of m = 2^23): (label, log m,
# first pass). A layer's first pass evaluates its m entries where they lie
# in p and q; its next folds them into m / 2 and evaluates; most of the 276
# passes fold 2^16 entries or fewer
GKR_CASES = (("first_2_22", 22, True), ("fold_2_22", 22, False), ("fold_2_16", 16, False),
             ("fold_2_8", 8, False))
GKR_EQ_VARS = 22  # the eq table of the app's layer of m = 2^22
# a pass's work a pair of the next sub-round: the folds of four entries of
# each of the five columns (10 products by r: 16 Montgomery products and 12
# adds each, and a subtract and an add of four words each); s(1), s(2),
# s(3): 5 differences, 10 adds, and at each point 4 products of two values
# (19 Montgomery products, 12 adds), one by lambda (16, 12) and 12 adds
GKR_FOLD = plus(times(MONT_MUL, 10 * 16), times(ADD, 10 * (12 + 8)))
GKR_EVAL = plus(times(MONT_MUL, 3 * (4 * 19 + 16)), times(ADD, 60 + 3 * (4 * 12 + 24)))


def gkr_pass_work(m: int, first: bool):
    """(bytes, (multiplies, others)) of kernel K's pass over the five int64
    EF4 columns of m entries: a first pass reads them and evaluates m / 2
    pairs, another also folds them into m / 2 and writes those, then
    evaluates m / 4 pairs; each entry read once and each output written
    once."""
    if first:
        return 5 * m * 32, times(GKR_EVAL, m // 2)
    return 5 * (m + m // 2) * 32, times(plus(GKR_FOLD, GKR_EVAL), m // 4)


def check_gkr_kernels(device) -> dict:
    """Kernel K's pass against its plain version at ``GKR_CASES``, bit for
    bit, timed by CUDA graph replay (the small passes run faster than
    Python enqueues them) beside its bound (bytes at 3.35 TB/s, or its
    operations) and the latency floor of one launch (a one-element kernel
    by graph replay), which bounds a small pass; the plain version's ms
    (one call). Then the eq table at ``GKR_EQ_VARS`` variables against
    ``eq_hypercube``."""
    import torch

    from swirl_torch import kernels as K
    from swirl_torch.fields.babybear import P
    from swirl_torch.prover import gkr
    from swirl_torch.prover.sumcheck import eq_hypercube

    gen = torch.Generator(device=device)
    gen.manual_seed(SEED + 5)

    def rand(*shape):
        return torch.randint(0, P, shape, generator=gen, device=device, dtype=torch.int64)

    one = torch.zeros(1, dtype=torch.int64, device=device)
    floor_ms = _graph_time_ms(lambda: one.add_(1), reps=100)
    results, cases = {}, {}
    for label, log_m, first in GKR_CASES:
        m = 1 << log_m
        if first:  # eq, and p0, q0, p1, q1 as the stride-2 views of the layer's p and q
            p, q = rand(2 * m, 4), rand(2 * m, 4)
            cols, r = [rand(m, 4), p[0::2], q[0::2], p[1::2], q[1::2]], None
        else:
            cols, r = list(rand(5, m, 4).unbind(0)), rand(4)
        lam = rand(4)
        got = gkr.gkr_round(cols, r, lam)
        want, plain_ms = _timed_ms(lambda: gkr.gkr_round_plain(cols, r, lam))
        err = max(_max_abs_err(torch.stack(got[0]), torch.stack(want[0])), _max_abs_err(got[1], want[1]))
        if err:
            raise AssertionError(f"kernel gkr_round [{label}]: max_abs_err {err}")
        del got, want
        ms = _graph_time_ms(lambda: gkr.gkr_round(cols, r, lam), reps=10)
        bound_ms, bound_by = bound(gkr_pass_work(m, first))
        if floor_ms > bound_ms:
            bound_ms, bound_by = floor_ms, "one launch"
        what = f"evaluate 2^{log_m}" if first else f"fold 2^{log_m} -> 2^{log_m - 1} and evaluate"
        pairs = m // 2 if first else m // 4
        _say(f"kernel gkr_round [{label}] {what}, blocks {gkr.round_blocks(pairs, SMS)}: equal=True "
             f"max_abs_err={err} ms={ms:.4f} (by CUDA graph replay) plain_ms={plain_ms:.4f} bound_ms={bound_ms:.4f} "
             f"({bound_by}) floor_ms={floor_ms:.4f} (one launch) share={bound_ms / ms:.1%}")
        cases[label] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by}
        results.setdefault(K.GKR_ROUND.name, {
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None, "floor_ms": floor_ms,
        })
        del cols
        torch.cuda.empty_cache()
    results[K.GKR_ROUND.name]["cases"] = cases
    xi = rand(GKR_EQ_VARS, 4)
    err = _max_abs_err(gkr.gkr_eq(xi), eq_hypercube(xi, device))
    if err:
        raise AssertionError(f"kernel gkr_round [eq table, {GKR_EQ_VARS} variables]: max_abs_err {err}")
    ms = _graph_time_ms(lambda: gkr.gkr_eq(xi), reps=10)
    _say(f"kernel gkr_round [eq table] {GKR_EQ_VARS} variables: equal=True ms={ms:.4f} (by CUDA graph replay) "
         f"bytes bound {(32 << GKR_EQ_VARS) / HBM_BYTES_PER_S * 1e3:.4f} ms")
    torch.cuda.empty_cache()
    return results


# Kernel L's cases at the batch phase's shapes: (label, kind, shape). A
# product: the app's multilinear round 1 (its 95-node DAG runs node by node
# on interp_mle_at_int's stride-2 views of 2^15 rows), a level group as the
# interpreter forms it (187 nodes of 2^15 rows), a table by a challenge. A
# sum: round 0's 16 constraint terms of 2^21 base values gathered from 40
# buffer rows, a round-0 coset grid segment (2^13 chunks x 48 columns) by
# the eq table, a multilinear round's eq-weighted sum of 2^15 rows, and 16
# gathered constraint rows of 2^15 EF4 values
EF4_CASES = (("mul_stride2_2_15", "mul", (1 << 15,)), ("mul_group_187_2_15", "mul", (187, 1 << 15)),
             ("mul_challenge_2_16", "mul", (1 << 16,)), ("sum_round0_base_16_2_21", "sum", (16, 1 << 21)),
             ("sum_round0_grid_2_13_48", "sum", (1 << 13, 48)), ("sum_eq_2_15", "sum", (1 << 15, 1)),
             ("sum_constraints_16_2_15", "sum", (16, 1 << 15)))
# an EF4 product of two values: 19 Montgomery products and 12 adds, then 4
# fix-up products; a term of a sum: a product by a factor (16 products, 12
# adds) and 4 adds, or 4 products and 4 adds for a base value
EF4_MUL = plus(times(MONT_MUL, 23), times(ADD, 12))
EF4_TERM, EF4_BASE_TERM = plus(times(MONT_MUL, 16), times(ADD, 16)), plus(times(MONT_MUL, 4), times(ADD, 4))


def check_ef4_kernels(device) -> dict:
    """Kernel L's product and product-and-sum against their plain versions
    at ``EF4_CASES``, bit for bit, timed by CUDA graph replay beside the
    bound (bytes: each operand element read once, the output written once,
    or the operations) and the latency floor of one launch; the plain
    version's ms (one call)."""
    import torch

    from swirl_torch import kernels as K
    from swirl_torch.fields import ef4
    from swirl_torch.fields import field as F
    from swirl_torch.fields.babybear import P

    gen = torch.Generator(device=device)
    gen.manual_seed(SEED + 6)

    def rand(*shape):
        return torch.randint(0, P, shape, generator=gen, device=device, dtype=torch.int64)

    one = torch.zeros(1, dtype=torch.int64, device=device)
    floor_ms = _graph_time_ms(lambda: one.add_(1), reps=100)
    cases = {}
    for label, kind, shape in EF4_CASES:
        if kind == "mul":
            if label.startswith("mul_stride2"):
                t = rand(2, 2 * shape[0], 4)
                a, b = t[0, 1::2], t[1, 1::2]
            elif label.startswith("mul_challenge"):
                a, b = rand(*shape, 4), rand(4)
            else:
                a, b = rand(*shape, 4), rand(*shape, 4)
            run = lambda: ef4.mul(a, b)  # noqa: E731
            plain = lambda: F.ext_mul(a, b)  # noqa: E731
            n = math.prod(shape)
            work = (8 * (a.numel() + b.numel()) + 32 * n, times(EF4_MUL, n))
        else:
            k, m = shape
            if label.startswith("sum_round0_base") or label.startswith("sum_constraints"):
                ext = not label.startswith("sum_round0_base")
                v = rand(40, m, 4) if ext else rand(40, m)
                index = torch.randperm(40, generator=gen, device=device)[:k]
                w = rand(k, 4)
            else:
                ext, index = True, None
                v, w = rand(k, m, 4) if m > 1 else rand(k, 4), rand(k, 4)
            run = lambda: ef4.mul_sum(v, w, index=index, ext=ext)  # noqa: E731
            plain = lambda: ef4.mul_sum_plain(v, w, index=index, ext=ext)  # noqa: E731
            work = ((32 if ext else 8) * k * m + 40 * k + 32 * m, times(EF4_TERM if ext else EF4_BASE_TERM, k * m))
        got = run()
        want, plain_ms = _timed_ms(plain)
        err = _max_abs_err(got, want)
        if err:
            raise AssertionError(f"kernel ef4 [{label}]: max_abs_err {err}")
        del got, want
        ms = _graph_time_ms(run, reps=10)
        bound_ms, bound_by = bound(work)
        if floor_ms > bound_ms:
            bound_ms, bound_by = floor_ms, "one launch"
        plan = f"tj, gy {ef4.sum_plan(shape[1], shape[0], SMS)}" if kind == "sum" else "a thread an element"
        _say(f"kernel ef4 [{label}] {kind} {shape} ({plan}): equal=True max_abs_err={err} ms={ms:.4f} (by CUDA "
             f"graph replay) plain_ms={plain_ms:.4f} bound_ms={bound_ms:.4f} ({bound_by}) floor_ms={floor_ms:.4f} "
             f"(one launch) share={bound_ms / ms:.1%}")
        cases[label] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by}
        torch.cuda.empty_cache()
    first = cases[EF4_CASES[0][0]]
    return {K.EF4.name: {"max_abs_err": 0, "ms": first["ms"], "plain_ms": first["plain_ms"],
                         "bound_ms": first["bound_ms"], "bound_by": first["bound_by"], "library_ms": None,
                         "floor_ms": floor_ms, "cases": cases}}


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


def check_kernels(device, perm_floor_ms: float, keccak: bool = False) -> dict:
    """Each kernel against its plain version on seeded random inputs, bit
    for bit; returns the results of each kernel's first case; the tower's
    floor is its levels times ``perm_floor_ms``. The Keccak
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
            extra["floor_ms"] = TOWER_LEVELS * perm_floor_ms
            how += f" floor_ms={extra['floor_ms']:.4f} ({TOWER_LEVELS} x the permutation's floor)"
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
    """The golden cases through ``run_test``: debug check, prove, verify;
    on the host transcript, then on a device transcript."""
    from swirl_torch.codec import encode_proof, encode_vk
    from swirl_torch.engine import StarkEngine
    from swirl_torch.prover.device_transcript import DeviceTranscript
    from swirl_torch.testing.golden import encode_transcript_log, golden_cases, paths_for
    from swirl_torch.transcript import Transcript

    for name in GOLDEN_CASES:
        params, airs, ctxs = golden_cases()[name]()
        transcript = Transcript(record=True)
        vk, proof = StarkEngine(params, device=device).run_test(airs, ctxs, transcript)
        paths = paths_for(name)
        got_proof = encode_proof(proof)
        for what, got in (
            ("vk", encode_vk(vk)),
            ("proof", got_proof),
            ("transcript", encode_transcript_log(transcript.log)),
        ):
            with open(paths[what], "rb") as f:
                if f.read() != got:
                    raise AssertionError(f"golden {name}: {what} bytes differ")
        _, proof = StarkEngine(params, device=device).run_test(airs, ctxs, DeviceTranscript(device))
        if encode_proof(proof) != got_proof:
            raise AssertionError(f"golden {name}: the device-transcript proof's bytes differ")
        _say(f"golden {name}: vk, proof and transcript byte-identical; the proof on a device transcript too")


def check_outer(device) -> None:
    """The golden ``outer`` case (BN254 outer scheme) through ``run_test``
    on the card, its trees (kernels H, I) and grinds (J) there: transcript
    events and pre-hash against ``tests/golden``; the verifier's three
    refusals; the device transcript refused."""
    import copy

    import numpy as np

    from swirl_torch.engine import StarkEngine
    from swirl_torch.hash.bn254_poseidon2 import P_BN254
    from swirl_torch.prover.backend import ProvingContext
    from swirl_torch.prover.device_transcript import DeviceTranscript
    from swirl_torch.prover.errors import ProverError
    from swirl_torch.testing.golden import (
        CASE_SCHEME, decode_transcript_log, golden_cases, paths_for, pre_hash_hex)
    from swirl_torch.verifier.errors import VerifierError

    from swirl_torch import kernels as K

    params, airs, ctxs = golden_cases()["outer"]()
    eng = StarkEngine(params, hash_scheme=CASE_SCHEME["outer"], device=device)
    transcript = eng.scheme.new_transcript(record=True, device=eng.device)
    K.reset_launch_counts()
    vk, proof = eng.run_test(airs, ctxs, transcript)
    launches = K.launch_counts()
    missing = [k.name for k in (K.BN254_MERKLE, K.BN254_LEAVES, K.BN254_GRIND) if launches[k.name] == 0]
    if missing:
        raise AssertionError(f"golden outer: the trees and grinds never launched {missing}")
    paths = paths_for("outer")
    with open(paths["transcript"], "rb") as f:
        want = decode_transcript_log(f.read())
    got = list(transcript.log)
    for i, (g, w) in enumerate(zip(got, want)):
        if g != w:
            raise AssertionError(f"golden outer: the transcript diverges at event {i}: golden {w}, card {g}")
    if len(got) != len(want):
        raise AssertionError(f"golden outer: {len(got)} transcript events against the golden {len(want)}")
    with open(paths["prehash"]) as f:
        if pre_hash_hex(vk.pre_hash) != f.read().strip():
            raise AssertionError("golden outer: the vk pre-hash differs")
    refusals = []
    for what, tamper in (
        ("commit + 1", lambda p: setattr(p, "common_main_commit", (p.common_main_commit + 1) % P_BN254)),
        ("Merkle sibling + 1", lambda p: p.whir_proof.initial_round_merkle_proofs[0][0].__setitem__(
            0, (p.whir_proof.initial_round_merkle_proofs[0][0][0] + 1) % P_BN254)),
        ("(8,) digest", lambda p: p.whir_proof.codeword_commits.__setitem__(0, np.zeros(8, dtype=np.uint64))),
    ):
        bad = copy.deepcopy(proof)
        tamper(bad)
        try:
            eng.verify(vk, bad)
        except VerifierError as err:
            refusals.append(f"{what}: {type(err).__name__}")
        else:
            raise AssertionError(f"golden outer: the verifier accepted a proof with a {what}")
    pk, _ = eng.keygen(airs)
    ctx = ProvingContext([eng.context_for(i, cm, pvs, c) for i, (cm, pvs, c) in enumerate(ctxs)])
    try:
        eng.prove(eng.transport_pk(pk), ctx, DeviceTranscript(device))
    except ProverError as err:
        device_refusal = str(err)
    else:
        raise AssertionError("golden outer: a device transcript was taken under the BN254 scheme")
    _say(f"golden outer: {len(got)} transcript events and the pre-hash equal tests/golden (BN254 digests, "
         f"commit {proof.common_main_commit:#x}; trees and grinds on the card, launches {launches}); "
         f"refused: {'; '.join(refusals)}; device transcript: {device_refusal}")


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


@contextmanager
def peaks_by_span():
    """{span: peak device bytes} of the block: the peak since the last span
    boundary, charged to the innermost span open there ("outside" for none).
    Resets the card's peak statistic at every boundary."""
    import torch

    from swirl_torch import metrics

    plain = metrics.span
    peaks, stack = {}, []

    def mark():
        where = stack[-1] if stack else "outside"
        peaks[where] = max(peaks.get(where, 0), torch.cuda.max_memory_allocated())
        torch.cuda.reset_peak_memory_stats()

    @contextmanager
    def span(name):
        mark()
        stack.append(name)
        try:
            with plain(name):
                yield
        finally:
            mark()
            stack.pop()

    metrics.span = span
    try:
        yield peaks
    finally:
        metrics.span = plain
        mark()


def memory_model(eng, vk, heights) -> dict:
    """The memory model's estimate of one prove of ``vk`` at ``heights`` (one
    trace height an AIR)."""
    from dataclasses import asdict

    from swirl_torch.memory_metering import counts_for

    counts = counts_for(vk, heights)
    cfg = eng.proving_memory_config()
    # each AIR's round 0 is summarized by the one that sets the batch term
    shown = {k: v for k, v in asdict(counts).items() if k != "round0_airs"}
    per_air = [cfg.round0_memory_bytes(*air) for air in counts.round0_airs]
    shown["round0_largest_air"] = max(range(len(per_air)), key=per_air.__getitem__)
    return {"counts": shown, **asdict(cfg.estimate(counts))}


def _synced_seconds(fn):
    """(result, host seconds) of ``fn`` ending in a device sync."""
    import torch

    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


@contextmanager
def host_copies():
    """The value count of every device-to-host copy of the prover's values
    inside the block: each ``F.to_host`` (``F.to_host_all`` included, BabyBear
    values) and each ``fb.to_ints`` (BN254 digests: the outer trees' roots
    and opened siblings)."""
    from swirl_torch.fields import bn254 as fb
    from swirl_torch.fields import field as F

    sizes = []
    plain, plain_ints = F.to_host, fb.to_ints

    def to_host(x):
        sizes.append(int(x.numel()) if hasattr(x, "numel") else 0)
        return plain(x)

    def to_ints(t):
        sizes.append(int(t.numel()) // fb.L)
        return plain_ints(t)

    F.to_host, fb.to_ints = to_host, to_ints
    try:
        yield sizes
    finally:
        F.to_host, fb.to_ints = plain, plain_ints


def proof_sha256(proof) -> str:
    """sha256 over a walk of a proof's fields (names, lengths, shapes and
    canonical values, in order): the outer scheme's proofs, whose BN254
    digests the codec does not serialize."""
    import dataclasses

    import numpy as np

    h = hashlib.sha256()

    def walk(obj):
        if dataclasses.is_dataclass(obj):
            for f in dataclasses.fields(obj):
                h.update(f.name.encode())
                walk(getattr(obj, f.name))
        elif isinstance(obj, (list, tuple)):
            h.update(f"[{len(obj)}".encode())
            for x in obj:
                walk(x)
        elif isinstance(obj, np.ndarray):
            h.update(f"a{obj.shape}".encode() + np.ascontiguousarray(obj, dtype=np.uint64).tobytes())
        else:
            h.update(repr(int(obj) if isinstance(obj, (int, np.integer)) else obj).encode())

    walk(proof)
    return h.hexdigest()


def prove_and_check(device, params, airs, traces, bad, on_card: bool = False,
                    hash_scheme=None, audit=None) -> dict:
    """Keygen, debug check, prove and verify of ``airs`` on ``traces`` (one
    host array an AIR, in one proof) under ``hash_scheme``. Resets the
    launch counters just before the prove and returns them with the spans,
    seconds, the kernels' input shapes, the host copies and the encoded
    proof size. Then the two negative checks: the proof with 1 added to a
    column opening must be refused by the verifier, and ``bad`` = (AIR
    index, its bad trace, the bad row) by the debug check at that row. With
    ``on_card``, last, the same prove on a ``DeviceTranscript`` (its
    counters, spans, seconds and peak under "on_card"), whose bytes must be
    the verified proof's. ``audit(params, vk)``, when given, runs right
    after keygen; its result is under "audit". The codec holds the inner
    scheme's digests only: an outer proof is verified and tampered as the
    prover returned it. A prove that runs out of device memory raises with
    its peak by span so far in the error's ``peaks_by_span``."""
    import copy

    import torch

    from swirl_torch import kernels as K
    from swirl_torch import metrics
    from swirl_torch.codec import decode_proof, decode_vk, encode_proof, encode_vk
    from swirl_torch.engine import StarkEngine
    from swirl_torch.fields.babybear import P
    from swirl_torch.prover.backend import ProvingContext
    from swirl_torch.verifier.errors import VerifierError

    eng = StarkEngine(params, hash_scheme=hash_scheme, device=device)
    t0 = time.perf_counter()
    pk, vk = eng.keygen(airs)
    audit_result = None if audit is None else audit(params, vk)
    dpk = eng.transport_pk(pk)
    ctx = ProvingContext([eng.context_for(i, trace, [], []) for i, trace in enumerate(traces)])
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    _, debug_s = _synced_seconds(lambda: eng.debug(airs, pk, ctx))
    # the prove starts from the allocator state it had before the debug check
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        with metrics.run_with_metric_collection() as collector, recorded_shapes() as shapes, \
                peaks_by_span() as peaks, host_copies() as copies:
            proof = eng.prove(dpk, ctx)
    except torch.cuda.OutOfMemoryError as err:
        err.peaks_by_span = dict(peaks)
        raise
    prove_s = time.perf_counter() - t0
    launches = K.launch_counts()
    peak = max(peaks.values())
    if eng.scheme.digest_is_scalar:
        data, sha, vk_read = None, proof_sha256(proof), vk
        read = lambda: copy.deepcopy(proof)  # noqa: E731
    else:
        data = encode_proof(proof)
        if encode_proof(decode_proof(data)) != data:
            raise AssertionError("the proof does not survive a codec round trip")
        sha, vk_read = hashlib.sha256(data).hexdigest(), decode_vk(encode_vk(vk))
        read = lambda: decode_proof(data)  # noqa: E731
    t0 = time.perf_counter()
    eng.verify(vk_read, read())
    verify_s = time.perf_counter() - t0

    # negative checks: both must be refused
    tampered = read()
    opening = tampered.batch_constraint_proof.column_openings[0][0][0]
    opening[0] = (int(opening[0]) + 1) % P
    try:
        eng.verify(vk_read, tampered)
    except VerifierError as err:
        tamper_refusal = type(err).__name__
    else:
        raise AssertionError("the verifier accepted a proof with a tampered column opening")
    bad_air, bad_trace, bad_row = bad
    bad_ctx = ProvingContext([eng.context_for(i, bad_trace, [], []) if i == bad_air else ctx.per_trace[i]
                              for i in range(len(traces))])
    try:
        eng.debug(airs, pk, bad_ctx)
    except AssertionError as err:
        bad_trace_refusal = str(err)
    else:
        raise AssertionError("the debug check passed a bad trace")
    if not bad_trace_refusal.endswith(f"failed at row {bad_row}"):
        raise AssertionError(f"the debug check refused the bad trace elsewhere: {bad_trace_refusal}")
    del bad_ctx  # its trace on the card would count in the next prove's peak
    card = prove_on_card(eng, dpk, ctx, sha) if on_card else None
    return {
        "on_card": card,
        "engine": eng,
        "dpk": dpk,
        "ctx": ctx,
        "memory_model": memory_model(eng, vk, [len(trace) for trace in traces]),
        "audit": audit_result,
        "peaks_by_span": peaks,
        "setup_s": setup_s,
        "debug_s": debug_s,
        "prove_s": prove_s,
        "verify_s": verify_s,
        "spans_ms": {k: v for k, v in collector.snapshot().items() if k.endswith("_time_ms")},
        "counters": dict(collector.counters),
        "proof_bytes": None if data is None else len(data),
        "proof_sha256": sha,
        "host_copies": copies,
        "peak_bytes": peak,
        "launches": launches,
        "shapes": shapes,
        "tamper_refusal": tamper_refusal,
        "bad_trace_refusal": bad_trace_refusal,
        "dag": vk.per_air[0].symbolic_constraints,
        "dag_vk": vk,
        "heights": [len(trace) for trace in traces],
    }


def prove_on_card(eng, dpk, ctx, want_sha256: str) -> dict:
    """The prove again on a ``DeviceTranscript`` on the engine's card: the
    launch counters reset just before it, its proof's sha256 held to the
    host-transcript proof's (already verified, so equal bytes need no
    second verify)."""
    import torch

    from swirl_torch import kernels as K
    from swirl_torch import metrics
    from swirl_torch.codec import encode_proof
    from swirl_torch.prover.device_transcript import DeviceTranscript
    from swirl_torch.testing.host_reads import STAGE_READS, HostReads

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    transcript = DeviceTranscript(eng.device)
    K.reset_launch_counts()
    t0 = time.perf_counter()
    with metrics.run_with_metric_collection() as collector, HostReads() as host, \
            peaks_by_span() as peaks, duplex_absorbs() as absorbs:
        proof = eng.prove(dpk, ctx, transcript)
    prove_s = time.perf_counter() - t0
    launches = K.launch_counts()
    peak = max(peaks.values())
    sha = hashlib.sha256(encode_proof(proof)).hexdigest()
    if sha != want_sha256:
        raise AssertionError(f"the device-transcript proof differs: sha256 {sha[:16]} against {want_sha256[:16]}")
    over = {k: host.reads[k] for k, n in STAGE_READS.items() if host.reads[k] > n}
    if over:
        raise AssertionError(f"device-transcript stages read the host more than {STAGE_READS}: {over}")
    return {
        "prove_s": prove_s,
        "spans_ms": {k: v for k, v in collector.snapshot().items() if k.endswith("_time_ms")},
        "peak_bytes": peak,
        "peaks_by_span": peaks,
        "launches": launches,
        "proof_sha256": sha,
        "host_reads": dict(host.reads),
        "host_writes": dict(host.writes),
        "longest_absorb": max(absorbs, default=0),
    }


@contextmanager
def duplex_absorbs():
    """[felts absorbed] of every kernel E launch inside the block."""
    from swirl_torch.hash import poseidon2 as p2

    absorbs, plain = [], p2.duplex

    def counted(state, absorb, host, *args, **kwargs):
        absorbs.append((0 if absorb is None else absorb.numel()) + len(host))
        return plain(state, absorb, host, *args, **kwargs)

    p2.duplex = counted
    try:
        yield absorbs
    finally:
        p2.duplex = plain


@contextmanager
def timed_bn254_grinds():
    """[(bits, ms)] of every kernel J search inside the block, by CUDA events
    around each call of ``grind_ints`` (the outer transcript's entry), which
    reads its witness, so nothing waits more."""
    import torch

    from swirl_torch.hash import bn254_poseidon2 as bp

    plain, calls = bp.grind_ints, []

    def timed(lanes, pending, a, shift, bits, *args, **kwargs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        w = plain(lanes, pending, a, shift, bits, *args, **kwargs)
        end.record()
        end.synchronize()
        calls.append((bits, start.elapsed_time(end)))
        return w

    bp.grind_ints = timed
    try:
        yield calls
    finally:
        bp.grind_ints = plain


def grinds_summary(calls) -> str:
    """``n searches, total ms: b bits ms (n), ...`` of :func:`timed_bn254_grinds`' list."""
    bits = sorted({b for b, _ in calls}, reverse=True)
    by_bits = ", ".join(f"{b} bits {sum(ms for x, ms in calls if x == b):.3f} ms ({sum(x == b for x, _ in calls)})"
                        for b in bits)
    return f"{len(calls)} searches, {sum(ms for _, ms in calls):.3f} ms: {by_bits}"


def prove_with_config(run: dict, config) -> dict:
    """The prove of ``run``'s cell again on the host transcript, on a new
    engine with the memory policy ``config`` (the same proving key and
    context): the launch counters reset just before it, its peak by span,
    the memory model's estimate, and its proof's sha256 held to the
    verified proof's."""
    import torch

    from swirl_torch import kernels as K
    from swirl_torch.codec import encode_proof
    from swirl_torch.engine import StarkEngine

    base = run["engine"]
    eng = StarkEngine(base.params, config, device=base.device)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    with peaks_by_span() as peaks:
        proof, prove_s = _synced_seconds(lambda: eng.prove(run["dpk"], run["ctx"]))
    launches = K.launch_counts()
    sha = hashlib.sha256(encode_proof(proof)).hexdigest()
    if sha != run["proof_sha256"]:
        raise AssertionError(f"the proof under {config} differs: sha256 {sha[:16]} against "
                             f"{run['proof_sha256'][:16]}")
    model = memory_model(eng, run["dag_vk"], run["heights"])
    return {"config": config, "prove_s": prove_s, "peak_bytes": max(peaks.values()),
            "peaks_by_span": peaks, "launches": launches, "proof_sha256": sha, "memory_model": model}


def prove_synthetic(device, params, degree: int, log_rows: int = LOG_ROWS,
                    width: int = WIDTH, seed: int = SEED, on_card: bool = False, hash_scheme=None) -> dict:
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
    run = prove_and_check(device, params, [air], [trace], (0, bad, bad_row), on_card, hash_scheme)
    run["size"] = f"2^{log_rows} x {width}"
    return run


# the largest device-to-host copy the outer root prove may make: its opened
# rows and paths (88 queries x 16 rows x 32 felts) and the like, far below
# a codeword (its smallest, WHIR's third, holds 2^24 values)
OUTER_HOST_COPY_LIMIT = 1 << 20


def prove_outer_root(device) -> dict:
    """The outer root cell: the leaf cell's SyntheticAir (2^20 x 64, degree
    4) under ``root_params_with_100_bits_security(21)`` with the BN254
    outer scheme, its trees (kernels H, I) and grinds (J) on the card.
    ``build_host_tree`` refuses to run meanwhile, and no host copy may
    reach a codeword's size."""
    from swirl_torch.hash import scheme
    from swirl_torch.params import root_params_with_100_bits_security

    def refuse(*args, **kwargs):
        raise AssertionError("the outer prove reached build_host_tree")

    plain, scheme.build_host_tree = scheme.build_host_tree, refuse
    try:
        with timed_bn254_grinds() as grinds:
            run = prove_synthetic(device, root_params_with_100_bits_security(OUTER_LOG_STACKED), 4,
                                  hash_scheme="bn254-outer")
    finally:
        scheme.build_host_tree = plain
    largest = max(run["host_copies"], default=0)
    if largest >= OUTER_HOST_COPY_LIMIT:
        raise AssertionError(f"outer root: a host copy of {largest} values (limit {OUTER_HOST_COPY_LIMIT})")
    run["extra"] = [f"host copies {len(run['host_copies'])}, the largest {largest} values "
                    f"(limit {OUTER_HOST_COPY_LIMIT}); build_host_tree not reached",
                    f"kernel J by events around each call (the witness's read included): {grinds_summary(grinds)}"]
    return run


def prove_keccak(device, log_perms: int = KECCAK_LOG_PERMS, seed: int = SEED, on_card: bool = False) -> dict:
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
    run = prove_and_check(device, params, [air], [trace], (0, bad, bad_row), on_card)
    sched = get_schedule(run["dag"])
    run["size"] = f"2^{log_perms} permutations, trace 2^{log_height} x {trace.shape[1]}"
    run["extra"] = [
        f"trace generation {trace_s:.3f} s (host numpy)",
        f"DAG {len(run['dag'].nodes)} nodes, {len(run['dag'].constraint_idx)} constraints; "
        f"schedule {len(sched.levels)} levels, {len(sched.leaf_kinds)} live leaves, max_live {sched.max_live}",
    ]
    return run


def prove_reth_segment(device, segment_idx: int, max_log_height: int = RETH_MAX_LOG_HEIGHT) -> dict:
    """One reth segment of the atlas as one multi-AIR proof, every AIR at its
    atlas height (clamped at ``max_log_height``), random traces from
    ``segment_fit.seeded_traces`` (the kill column zero), under the
    synthetic runner's parameters (``segment_fit.runner_params``): keygen
    and ``audit_vk``, the debug
    check, the prove on the host transcript and again on
    ``DeviceTranscript()``, the verifier and the two refusals. The bad
    trace has a 1 in the kill column at one row of the first AIR with two
    or more constraints and at least 2^l_skip rows."""
    import os

    from swirl_torch import metrics
    from swirl_torch.soundness import audit_vk
    from swirl_torch.testing.synthetic import SyntheticAir, load_segment_atlas
    from swirl_torch.tools.segment_fit import runner_params, seeded_traces

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), RETH_ATLAS)
    seg = next(s for s in load_segment_atlas(path, max_log_height) if s["segment_idx"] == segment_idx)
    shapes = seg["shapes"]
    params = runner_params(max_log_height, seg["max_constraint_degree"])
    airs = [SyntheticAir(shape) for shape in shapes]
    t0 = time.perf_counter()
    traces = seeded_traces(airs, SEED)
    trace_s = time.perf_counter() - t0
    bad_air = next(i for i, sh in enumerate(shapes)
                   if sh.num_constraints >= 2 and sh.log_height >= params.l_skip)
    bad_row = len(traces[bad_air]) // 3
    bad = traces[bad_air].copy()
    bad[bad_row, 0] = 1
    run = prove_and_check(device, params, airs, traces, (bad_air, bad, bad_row), on_card=True, audit=audit_vk)
    with metrics.run_with_metric_collection() as collector:
        metrics.trace_metrics([a.name() for a in airs], [a.width for a in airs], [sh.log_height for sh in shapes])
    gauges = collector.snapshot()
    cells = int(gauges["main_trace_cells"])
    leaves = sum(sh.num_interactions << max(sh.log_height, params.l_skip) for sh in shapes)
    audit = run["audit"]
    findings = "; ".join(f"{f.severity}: {f.message}" for f in audit.findings) or "none"
    per_air = ", ".join(f"{k[len('trace_cells.'):]} {int(v)}" for k, v in gauges.items() if k.startswith("trace_cells."))
    run["size"] = (f"segment {segment_idx}: {len(airs)} AIRs, {cells} main cells, GKR {leaves} leaves "
                   f"({int(run['counters'].get('gkr_interaction_cells', 0))} padded), heights 2^"
                   f"{min(sh.log_height for sh in shapes)} to 2^{max(sh.log_height for sh in shapes)}, "
                   f"degree {seg['max_constraint_degree']}, clamped {seg['clamped']}")
    run["extra"] = [
        f"params l_skip {params.l_skip}, n_stack {params.n_stack}, w_stack {params.w_stack}, log_blowup "
        f"{params.log_blowup}, WHIR queries {[r.num_queries for r in params.whir.rounds]}",
        f"audit_vk: {audit.achieved_bits:.4f} bits (target {audit.target_bits}), ok {audit.ok}, findings {findings}",
        f"trace_metrics: main_trace_cells {cells}; trace_cells by AIR {{{per_air}}}",
        f"bad trace: AIR {bad_air} ({airs[bad_air].name()}), row {bad_row}",
        f"trace generation {trace_s:.3f} s (host numpy, seed {SEED}, kill column zero)",
    ]
    if not audit.ok:
        raise AssertionError(f"segment {segment_idx}: audit_vk failed: {findings}")
    return run


def check_rs_kernels(device, shape) -> None:
    """A and B at a reth segment's codeword ``shape`` (w, 2^23), on seeded
    random inputs: the kernel on the whole input, held bit for bit to the
    plain version on three slices (A: RETH_SLICE_ROWS rows, B:
    RETH_SLICE_COLS columns, at the start, the middle and the end); the
    kernel's ms by CUDA events (mean of 10), the plain ms summed over the
    slices, the bound."""
    import torch

    from swirl_torch import kernels as K
    from swirl_torch.fields.babybear import P
    from swirl_torch.hash import poseidon2 as p2
    from swirl_torch.prover import ntt

    gen = torch.Generator(device=device)
    gen.manual_seed(SEED)
    for kernel, fk, fp, work, axis, k in (
        (K.NTT, ntt.ntt_rows, ntt.ntt_plain, ntt_work, 0, RETH_SLICE_ROWS),
        (K.HASH_COLS, p2.hash_cols, p2.hash_cols_plain, hash_work, 1, RETH_SLICE_COLS),
    ):
        x = torch.randint(0, P, shape, generator=gen, device=device, dtype=torch.int64)
        got = fk(x)
        err, plain_ms = 0, 0.0
        for c in (0, (shape[axis] // 2) // k * k, shape[axis] - k):
            sl = slice(c, c + k)
            part = x[sl] if axis == 0 else x[:, sl]
            want, ms = _timed_ms(lambda: fp(part.contiguous()))
            err = max(err, _max_abs_err(got[sl] if axis == 0 else got[:, sl], want))
            plain_ms += ms
            del want
        if err != 0:
            raise AssertionError(f"kernel {kernel.name} at the reth codeword {shape}: max_abs_err {err}")
        del got
        ms = _cuda_time_ms(lambda: fk(x), reps=10)
        bound_ms, bound_by = bound(work(shape))
        _say(f"kernel {kernel.name} [reth_codeword] shape={shape} equal=True max_abs_err={err} ms={ms:.4f} "
             f"plain_ms={plain_ms:.4f} (plain on 3 slices of {k} {'rows' if axis == 0 else 'columns'}) "
             f"bound_ms={bound_ms:.4f} ({bound_by})")
        del x
        torch.cuda.empty_cache()


def reth_phase(device, memory: list) -> None:
    """Every segment of RETH_SEGMENTS through :func:`prove_reth_segment`,
    reported as the other cells are (their kernels A-D on the host
    transcript, E and F on the device transcript), each prove's peak beside
    the memory model in ``memory``. A segment with a substitute that runs
    out of device memory prints its peak by span at the failure, and its
    substitute is proved in its place (a failure there fails the run).
    Then A and B at the last segment's codeword shape against their plain
    versions."""
    import gc

    import torch

    from swirl_torch import kernels as K

    required = [k.name for k in (K.NTT, K.HASH_COLS, K.COMPRESS, K.TOWER)]
    codeword = None
    for idx in RETH_SEGMENTS:
        t0 = time.perf_counter()
        failure = None
        try:
            run = prove_reth_segment(device, idx)
        except torch.cuda.OutOfMemoryError as err:
            if idx not in RETH_SUBSTITUTE:
                raise
            failure = (str(err).splitlines()[0], getattr(err, "peaks_by_span", None))
        if failure is not None:
            # the failed prove's engine and traces were held by the traceback
            gc.collect()
            torch.cuda.empty_cache()
            message, peaks = failure
            spans = ", ".join(f"{k} {v}" for k, v in sorted((peaks or {}).items(), key=lambda kv: -kv[1]))
            _say(f"reth segment {idx}: out of device memory ({message}); peak by span at the failure (B): "
                 f"{spans or 'not in the prove'}; segment {RETH_SUBSTITUTE[idx]} takes its place")
            idx = RETH_SUBSTITUTE[idx]
            run = prove_reth_segment(device, idx)
        tag = f"reth {idx}"
        report(tag, run, required)
        memory.append(report_memory(tag, run))
        report_memory(f"{tag}, device transcript", run["on_card"])
        codeword = max(run["shapes"][K.NTT.name], key=math.prod)
        release(run)
        _say(f"{tag}: phase {time.perf_counter() - t0:.1f} s (setup, audit, debug, two proves, verify, refusals)")
    check_rs_kernels(device, codeword)


# the queue_b phase: rows of the monomial-engine cases, the plain sumchecks'
# size, the generic fields' lanes and sampled lanes
MONOMIAL_CASES = (("keccak", 15, False), ("keccak", 12, True), ("keccakf_perm", 14, False))
SUMCHECK_LOG_N, SUMCHECK_L_SKIP = 24, 4
FIELD_LANES, FIELD_SAMPLES = 1 << 20, 257


class AtenOps:
    """Counts the aten ops dispatched inside the block (on the card, each
    is a launch or a host-side view)."""

    def __enter__(self):
        from torch.utils._python_dispatch import TorchDispatchMode

        outer = self

        class Count(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                outer.n += 1
                return func(*args, **(kwargs or {}))

        self.n, self._mode = 0, Count()
        self._mode.__enter__()
        return self

    def __exit__(self, *exc):
        self._mode.__exit__(*exc)


def _monomial_dag(name: str):
    """KeccakAir's DAG, or the SyntheticAir of segment 13's KeccakfPermAir
    record in the reth atlas."""
    from swirl_torch.keygen import _air_widths, run_symbolic
    from swirl_torch.models.keccak import KeccakAir
    from swirl_torch.testing.synthetic import SyntheticAir, load_segment_atlas

    if name == "keccak":
        air = KeccakAir()
    else:
        seg = next(s for s in load_segment_atlas(RETH_ATLAS, RETH_MAX_LOG_HEIGHT) if s["segment_idx"] == 13)
        air = SyntheticAir(next(sh for sh in seg["shapes"] if sh.air_name == "KeccakfPermAir"))
    return run_symbolic(air, _air_widths(air)).build_dag()


def check_monomial(device, name: str, log_rows: int, ext: bool) -> None:
    """The monomial engine against the interpreter on random rows from
    ``default_rng(SEED)``: bit for bit, each one's ms, aten ops and peak."""
    import numpy as np
    import torch

    from swirl_torch.fields.babybear import P
    from swirl_torch.prover import dag_eval as de
    from swirl_torch.prover.monomial import acc_constraints_monomial, expand_monomials

    dag = _monomial_dag(name)
    t0 = time.perf_counter()
    expanded = expand_monomials(dag)
    expand_s = time.perf_counter() - t0
    rng = np.random.default_rng(SEED)
    width = 1 + max(n[4] for n in dag.nodes if n[0] == "var" and n[1] == "main")
    tail = (1 << log_rows, 4) if ext else (1 << log_rows,)

    def rand(*shape):
        return torch.from_numpy(rng.integers(0, P, shape, dtype=np.int64)).to(device)

    sels, local, lam = rand(3, *tail), rand(width, *tail), rand(len(dag.constraint_idx), 4)
    ev = de.DeviceEvaluator(sels, None, [(local, torch.roll(local, -1, dims=1))], [], ext)
    engines = (("interpreter", lambda: de.acc_constraints(dag, ev, lam)),
               ("monomial", lambda: acc_constraints_monomial(expanded, ev, lam)))
    out = {}
    for engine, fn in engines:
        fn()  # the index tensors, made once per device
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
        with AtenOps() as ops:
            value = fn()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated(device) - base
        out[engine] = (value, _cuda_time_ms(fn, reps=2), ops.n, peak)
    if not torch.equal(out["monomial"][0], out["interpreter"][0]):
        raise AssertionError(f"queue_b monomial {name}: the monomial engine differs from the interpreter")
    tag = f"queue_b monomial [{name}, 2^{log_rows} rows, {'EF' if ext else 'base'}]"
    _say(f"{tag}: {len(dag.nodes)} DAG nodes, {len(dag.constraint_idx)} constraints, {len(expanded.leaves)} "
         f"leaves, {expanded.num_monomials()} monomials, expansion {expand_s:.3f} s; equal to the interpreter")
    for engine, (_, ms, ops, peak) in out.items():
        _say(f"{tag}: {engine} ms={ms:.3f} aten_ops={ops} peak={peak} B")


def prism_eval(evals, l_skip: int, r):
    """The prism polynomial of host EF ``evals`` at (r0, r1, ...): each
    chunk's univariate (its iDFT) at r0 by Horner, then the MLE at the rest."""
    import numpy as np

    from swirl_torch import poly as hpoly

    chunks = evals.reshape(-1, 1 << l_skip, 4)
    folded = np.stack([hpoly.horner_eval(hpoly.idft_ef(c), r[0]) for c in chunks])
    return hpoly.eval_mle_evals_at_point(folded, np.stack(r[1:])) if len(r) > 1 else folded[0]


def check_plain_sumcheck(device) -> None:
    """Both plain sumchecks on 2^24 random EF values on the card, verified
    with fresh transcripts; a 2^10 prism proof's final claim against the
    host evaluation."""
    import numpy as np
    import torch

    from swirl_torch.fields import ext
    from swirl_torch.fields import field as F
    from swirl_torch.fields.babybear import P
    from swirl_torch.prover import plain_sumcheck as ps
    from swirl_torch.transcript import Transcript

    gen = torch.Generator(device=device)
    gen.manual_seed(SEED)
    evals = torch.randint(0, P, (1 << SUMCHECK_LOG_N, 4), generator=gen, device=device, dtype=torch.int64)
    n = SUMCHECK_LOG_N
    for kind, prove, verify in (
        ("multilinear", lambda t: ps.sumcheck_multilinear(t, evals),
         lambda t, pr: ps.verify_sumcheck_multilinear(t, pr, n)),
        ("prismalinear", lambda t: ps.sumcheck_prismalinear(t, SUMCHECK_L_SKIP, evals),
         lambda t, pr: ps.verify_sumcheck_prismalinear(t, pr, SUMCHECK_L_SKIP, n - SUMCHECK_L_SKIP)),
    ):
        (proof, r), prove_s = _synced_seconds(lambda: prove(Transcript()))
        r2 = verify(Transcript(), proof)
        if not all(ext.eeq(a, b) for a, b in zip(r, r2)) or len(r) != len(r2):
            raise AssertionError(f"queue_b sumcheck {kind}: the verifier's challenges differ")
        _say(f"queue_b sumcheck {kind} (2^{n} EF values, {evals.numel() * 8} B): prove {prove_s * 1e3:.1f} ms, "
             f"{len(proof.round_polys_eval)} rounds, verified")
    host = np.random.default_rng(SEED).integers(0, P, (1 << 10, 4), dtype=np.uint64)
    proof, r = ps.sumcheck_prismalinear(Transcript(), SUMCHECK_L_SKIP, F.const_arr(host, device))
    ps.verify_sumcheck_prismalinear(Transcript(), proof, SUMCHECK_L_SKIP, 10 - SUMCHECK_L_SKIP)
    if not ext.eeq(proof.eval_claim, prism_eval(host, SUMCHECK_L_SKIP, r)):
        raise AssertionError("queue_b sumcheck: the 2^10 prism proof's final claim is not the polynomial at r")
    _say("queue_b sumcheck: the 2^10 prism proof's final claim equals the host evaluation")


def check_commit_graph(device, tag: str, params, width: int, log_h: int) -> None:
    """``commit_kernel`` at one shape: the graph replay against the eager
    commit and ``stacked_commit``'s root, results kept through two more
    commits, capture s, replay / clone / eager ms, A-D's launches a
    commit (the counts reset just before, read just after)."""
    import numpy as np
    import torch

    from swirl_torch import kernels as K
    from swirl_torch.fields import field as F
    from swirl_torch.fields.babybear import P
    from swirl_torch.prover import commit_kernel as ck
    from swirl_torch.prover.stacked_pcs import stacked_commit

    ls, lb, kw = params.l_skip, params.log_blowup, params.k_whir
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED)
    x, y, z = (torch.randint(0, P, (width, 1 << log_h), generator=gen, device=device, dtype=torch.int64)
               for _ in range(3))
    want = ck.commit_eager(ls, lb, kw, x)
    K.reset_launch_counts()
    ck.commit_eager(ls, lb, kw, x)
    eager_launches = K.launch_counts()
    K.reset_launch_counts()
    graph, capture_s = _synced_seconds(lambda: ck.commit_graph(ls, lb, kw, x))
    captured = K.launch_counts()
    code, layers = ck.commit_kernel(ls, lb, kw, x)
    torch.cuda.synchronize()
    if K.launch_counts() != captured:
        raise AssertionError(f"queue_b commit [{tag}]: a replay went through a kernel wrapper")
    path = [k.name for k in (K.NTT, K.HASH_COLS, K.COMPRESS, K.TOWER)]
    if any(captured[k] == 0 or captured[k] != 2 * eager_launches[k] for k in path):
        raise AssertionError(f"queue_b commit [{tag}]: warm-up and capture launched {captured}, "
                             f"an eager commit {eager_launches}")

    def same(got, ref):
        return torch.equal(got[0], ref[0]) and len(got[1]) == len(ref[1]) and all(
            torch.equal(a, b) for a, b in zip(got[1], ref[1]))

    if not same((code, layers), want):
        raise AssertionError(f"queue_b commit [{tag}]: the replay differs from the eager commit")
    root, data = stacked_commit(ls, log_h - ls, lb, kw, [x])
    if not np.array_equal(F.to_host(layers[-1][:, 0]), root):
        raise AssertionError(f"queue_b commit [{tag}]: the root differs from stacked_commit's")
    del data
    second = ck.commit_kernel(ls, lb, kw, y)
    ck.commit_kernel(ls, lb, kw, z)
    if not same((code, layers), want) or not same(second, ck.commit_eager(ls, lb, kw, y)):
        raise AssertionError(f"queue_b commit [{tag}]: a later commit changed an earlier one's results")
    replay_ms = _cuda_time_ms(lambda: graph.replay(x), reps=10)
    clone_ms = _cuda_time_ms(lambda: (graph.code.clone(), [t.clone() for t in graph.layers]), reps=10)
    eager_ms = _cuda_time_ms(lambda: ck.commit_eager(ls, lb, kw, x), reps=10)
    per_commit = {k: eager_launches[k] for k in path}
    _say(f"queue_b commit [{tag}] ({width} x 2^{log_h}, l_skip {ls}, log_blowup {lb}, k_whir {kw}): replay "
         f"equal to eager (codeword and {len(layers)} layers), root equal to stacked_commit's, results kept "
         f"through two more commits; capture {capture_s:.3f} s (its eager warm-up included), "
         f"replay_ms={replay_ms:.4f} clone_ms={clone_ms:.4f} eager_ms={eager_ms:.4f}, kernel launches a commit "
         f"{per_commit} (warm-up and capture: {({k: captured[k] for k in path})})")
    ck.release_graphs()


def field_oracle_mul(p: int, reduction, a, b):
    """Python-int products of (d, n) or (n,) host columns."""
    if reduction is None:
        return [int(x) * int(y) % p for x, y in zip(a, b)]
    d = len(reduction)
    red = [c % p for c in reduction]
    out = []
    for col in range(a.shape[1]):
        conv = [0] * (2 * d - 1)
        for i in range(d):
            for j in range(d):
                conv[i + j] = (conv[i + j] + int(a[i, col]) * int(b[j, col])) % p
        for k in range(2 * d - 2, d - 1, -1):
            for i, c in enumerate(red):
                conv[k - d + i] = (conv[k - d + i] + conv[k] * c) % p
        out.append(conv[:d])
    return out


def check_generic_fields(device) -> None:
    """Each field of the zoo on FIELD_LANES random elements on the card."""
    import numpy as np

    from swirl_torch.fields import generic as G

    rng = np.random.default_rng(SEED)
    for name, field in G.FIELDS.items():
        gl = name in ("goldilocks", "gl3")
        d = 3 if name == "gl3" else getattr(field, "d", 1)
        p = G.GL_P if gl else field.base.p if d > 1 else field.p
        reduction = (1, 1, 0) if name == "gl3" else field.reduction if d > 1 else None
        shape = (d, FIELD_LANES) if d > 1 else (FIELD_LANES,)
        a, b = rng.integers(1, p, shape, dtype=np.uint64), rng.integers(0, p, shape, dtype=np.uint64)
        to_dev = field.to_dev if gl else field.to_monty
        ta, tb = to_dev(a, device), to_dev(b, device)
        lanes = np.sort(rng.choice(FIELD_LANES, FIELD_SAMPLES, replace=False))
        cols = lambda v: v[..., lanes]  # noqa: E731
        for op in ("add", "sub", "mul"):
            got = cols(field.to_host(getattr(field, op)(ta, tb)))
            if op == "mul":
                want = field_oracle_mul(p, reduction, cols(a), cols(b))
                got = [list(map(int, g)) for g in got.T] if d > 1 else [int(g) for g in got]
            else:
                sign = 1 if op == "add" else -1
                want = [(int(x) + sign * int(y)) % p for x, y in zip(cols(a).ravel(), cols(b).ravel())]
                got = [int(g) for g in got.ravel()]
            if got != want:
                raise AssertionError(f"queue_b field {name}: {op} differs from the Python-int oracle")
        inv = field.inv(ta)
        got = cols(field.to_host(inv))
        want_one = [[1] + [0] * (d - 1)] * FIELD_SAMPLES if d > 1 else [1] * FIELD_SAMPLES
        if field_oracle_mul(p, reduction, cols(a), got) != want_one:
            raise AssertionError(f"queue_b field {name}: inv is not the oracle's inverse")
        one = field.to_host(field.mul(ta, inv))
        if not ((one[0] == 1).all() and (one[1:] == 0).all() if d > 1 else (one == 1).all()):
            raise AssertionError(f"queue_b field {name}: a * a^-1 != 1 on some lane")
        mul_ms = _cuda_time_ms(lambda: field.mul(ta, tb), reps=10)
        inv_ms = _cuda_time_ms(lambda: field.inv(ta), reps=1)
        _say(f"queue_b field {name} (2^{FIELD_LANES.bit_length() - 1} elements of degree {d}): add, sub, mul, "
             f"inv equal to Python ints on {FIELD_SAMPLES} lanes, a * a^-1 = 1 on all; mul_ms={mul_ms:.4f} "
             f"inv_ms={inv_ms:.3f}")


def check_golden_tools(device) -> None:
    """The golden cases through ``build_case`` on the card against
    ``tests/golden``, verified against a validator of the recorded log; a
    log with one event changed must diverge."""
    from swirl_torch.engine import StarkEngine
    from swirl_torch.fields.babybear import P
    from swirl_torch.testing.golden import build_case, encode_transcript_log, golden_cases, paths_for
    from swirl_torch.transcript import TranscriptDivergence, TranscriptValidator

    for name in GOLDEN_CASES:
        vk_bytes, pre_hash, proof_bytes, log, vk, proof = build_case(name, device)
        paths = paths_for(name)
        for what, got in (("vk", vk_bytes), ("proof", proof_bytes), ("transcript", encode_transcript_log(log)),
                          ("prehash", (pre_hash + "\n").encode())):
            with open(paths[what], "rb") as f:
                if f.read() != got:
                    raise AssertionError(f"queue_b golden {name}: build_case's {what} bytes differ")
        eng = StarkEngine(golden_cases()[name]()[0], device=device)
        validator = TranscriptValidator(log)
        eng.verify(vk, proof, transcript=validator)
        validator.finish()
        at = len(log) // 2
        bad = list(log)
        bad[at] = (bad[at][0], (bad[at][1] + 1) % P)
        try:
            eng.verify(vk, proof, transcript=TranscriptValidator(bad))
        except TranscriptDivergence as err:
            refusal = str(err)
        else:
            raise AssertionError(f"queue_b golden {name}: a tampered log did not diverge")
        _say(f"queue_b golden {name}: build_case on the card byte-identical to tests/golden; the verifier "
             f"replays the {len(log)}-event log; a tampered log diverges ({refusal})")


def queue_b_phase(device) -> None:
    import torch

    from swirl_torch.params import app_params_with_100_bits_security

    t0 = time.perf_counter()
    for name, log_rows, ext in MONOMIAL_CASES:
        check_monomial(device, name, log_rows, ext)
        torch.cuda.empty_cache()
    check_plain_sumcheck(device)
    torch.cuda.empty_cache()
    check_commit_graph(device, "app", app_params_with_100_bits_security(APP_LOG_STACKED), 16, APP_LOG_STACKED)
    torch.cuda.empty_cache()
    check_commit_graph(device, "keccak", app_params_with_100_bits_security(KECCAK_LOG_PERMS + 7),
                       KECCAK_STACKED, KECCAK_LOG_PERMS + 7)
    torch.cuda.empty_cache()
    check_generic_fields(device)
    torch.cuda.empty_cache()
    check_golden_tools(device)
    torch.cuda.empty_cache()
    _say(f"queue_b: phase {time.perf_counter() - t0:.1f} s")


# the fused phase: each cell's modes of prove_fused (the graph modes after
# eager, segmented last: the second trace replays it), the replays timed a
# graph mode, and the seed of the app's second trace
FUSED_MODES = {"app": ("eager", "jit", "segmented"), "leaf": ("segmented",), "keccak": ("segmented",)}
FUSED_REPLAYS = 3
FUSED_SECOND_SEED = SEED + 1


@contextmanager
def capture_counts(stats: dict, warm_ops: bool, sync_check: bool):
    """Counts, into ``stats``, the hand-kernel launches of the fused
    prover's capture and, with ``warm_ops``, the aten ops of its eager
    warm-up (the op sequence the capture records; the warm-up's seconds
    then include the count). With ``sync_check`` the warm-up runs under
    ``torch.cuda.set_sync_debug_mode("error")``: no op of the bodies may
    wait for the card (the tables exist since the cell's eager mode)."""
    import torch

    from swirl_torch import kernels as K
    from swirl_torch.prover import fused

    warm, record = fused._warm_up, fused._record

    def counted_warm(*args, **kwargs):
        if sync_check:
            torch.cuda.set_sync_debug_mode("error")
        try:
            with AtenOps() as ops:
                out = warm(*args, **kwargs)
        except RuntimeError as err:
            if sync_check:
                raise AssertionError(f"fused: a body synchronizes: {err}") from err
            raise
        finally:
            torch.cuda.set_sync_debug_mode("default")
        stats["aten_ops"] = ops.n
        return out

    def counted_record(*args, **kwargs):
        before = K.launch_counts()
        out = record(*args, **kwargs)
        after = K.launch_counts()
        stats["captured_launches"] = {k: after[k] - before[k] for k in after if after[k] != before[k]}
        return out

    fused._record = counted_record
    if warm_ops:
        fused._warm_up = counted_warm
    try:
        yield stats
    finally:
        fused._warm_up, fused._record = warm, record


def fused_sha256(proof) -> str:
    from swirl_torch.codec import encode_proof

    return hashlib.sha256(encode_proof(proof)).hexdigest()


def fused_mode(tag: str, run: dict, mode: str, required, smi: str, stats: dict, mesh=None,
               replays: int = FUSED_REPLAYS):
    """One mode of ``prove_fused`` on a cell's proving key and context: the
    first call (the eager prove; or the eager warm-up, capture and
    instantiation), then ``replays`` replays of a graph mode (on ``mesh``
    when given), each
    proof's sha256 held to the cell's device-transcript prove, one host
    read each, peaks beside the device transcript's. The launch counters
    are reset just before the first call and read after it (a replay
    enqueues no wrapper). The aten ops are counted in the cell's first
    graph mode's warm-up, which runs under the sync check when the eager
    mode ran before it. Returns the first call's proof."""
    import torch

    from swirl_torch import kernels as K
    from swirl_torch.prover import fused
    from swirl_torch.testing.host_reads import HostReads

    eng, dpk, ctx = run["engine"], run["dpk"], run["ctx"]
    want, d_peak = run["on_card"]["proof_sha256"], run["on_card"]["peak_bytes"]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    warm_ops = "aten_ops" not in stats and mode != "eager"
    sync_check = warm_ops and stats.get("eager_ran", False)
    K.reset_launch_counts()
    with HostReads() as host, capture_counts(stats, warm_ops, sync_check):
        proof, first_s = _synced_seconds(lambda: fused.prove_fused(eng.backend, dpk, ctx, mode, mesh))
    launches = K.launch_counts()
    first_peak = torch.cuda.max_memory_allocated()
    reads = [host.reads["total"]]
    if fused_sha256(proof) != want:
        raise AssertionError(f"fused {tag} [{mode}]: the first proof differs from the device-transcript prove's")
    missing = [k for k in required if launches[k] == 0]
    if missing:
        raise AssertionError(f"fused {tag} [{mode}]: the path never launched {missing}")
    entry = fused.fused_graphs(dpk, fused.graph_key(eng.backend, ctx.sorted_for_stacking(), mode, mesh))
    if (entry is None) != (mode == "eager"):
        raise AssertionError(f"fused {tag} [{mode}]: the cache does not hold what the mode captures")
    if entry is None:
        stats["eager_ran"] = True
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(replays if entry is not None else 0):
        with HostReads() as host:
            again, secs = _synced_seconds(lambda: fused.prove_fused(eng.backend, dpk, ctx, mode, mesh))
        times.append(secs)
        reads.append(host.reads["total"])
        if fused_sha256(again) != want:
            raise AssertionError(f"fused {tag} [{mode}]: a replay's proof differs")
    if entry is not None and K.launch_counts() != launches:
        raise AssertionError(f"fused {tag} [{mode}]: a replay went through a kernel wrapper")
    if reads != [1] * len(reads):
        raise AssertionError(f"fused {tag} [{mode}]: host reads a prove {reads}, not 1")
    replay_peak, reserved = torch.cuda.max_memory_allocated(), torch.cuda.memory_reserved()
    if entry is None:
        _say(f"fused {tag} [eager]: sha256 {want[:16]} (the device-transcript prove's); prove {first_s:.3f} s "
             f"(device-transcript prove {run['on_card']['prove_s']:.3f} s); host reads 1; peak {first_peak} B "
             f"(device-transcript prove {d_peak} B); launches {launches} [{smi}]")
        return proof
    st = entry.stats
    counted = " (the aten op count on)" if warm_ops else ""
    replayed = (f"mean of {replays} replays {sum(times) / replays:.3f} s ({', '.join(f'{t:.3f}' for t in times)}; "
                f"device-transcript prove {run['on_card']['prove_s']:.3f} s)" if replays else "no replay")
    _say(f"fused {tag} [{mode}]: sha256 {want[:16]} (the device-transcript prove's) in every call; first call "
         f"{first_s:.3f} s (eager warm-up {st['warm_up_s']:.3f} s{counted}, capture {st['capture_s']:.3f} s, "
         f"instantiation {st['instantiate_s']:.3f} s; {st['graphs']} graphs); {replayed}; host reads a prove 1; "
         f"peak first call {first_peak} B, replays {replay_peak} B, reserved {reserved} B (device-transcript prove "
         f"{d_peak} B) [{smi}]")
    if sync_check:
        _say(f"fused {tag} [{mode}]: the warm-up's five bodies ran under set_sync_debug_mode('error') without a sync")
    source = "this mode's warm-up" if warm_ops else "the cell's first graph mode's warm-up"
    _say(f"fused {tag} [{mode}]: aten ops {stats['aten_ops']} (counted in {source}: the sequence the capture "
         f"records), hand-kernel launches recorded while capturing {stats['captured_launches']}; launches of the "
         f"first call {launches}")
    return proof


def fused_second_trace(run: dict, first, smi: str) -> None:
    """A replay of the app's segmented graphs on a second trace of the same
    shape (seed ``FUSED_SECOND_SEED``): that trace's device-transcript bytes,
    the same cache entry, and ``first``, the first trace's proof by those
    graphs, unchanged."""
    import torch

    from swirl_torch.fields.babybear import P
    from swirl_torch.prover import fused
    from swirl_torch.prover.backend import ProvingContext
    from swirl_torch.prover.device_transcript import DeviceTranscript

    eng, dpk, ctx = run["engine"], run["dpk"], run["ctx"]
    common = ctx.per_trace[0][1].common_main
    gen = torch.Generator(device=common.device)
    gen.manual_seed(FUSED_SECOND_SEED)
    trace = torch.randint(0, P, tuple(common.shape), generator=gen, device=common.device, dtype=torch.int64)
    trace[0] = 0  # the kill column
    other = ProvingContext([eng.context_for(0, trace)])
    want = fused_sha256(eng.prove(dpk, other, DeviceTranscript(eng.device)))
    entries = {k: id(v) for k, v in dpk._fused_cache.items()}
    got, secs = _synced_seconds(lambda: fused.prove_fused(eng.backend, dpk, other, "segmented"))
    if fused_sha256(got) != want or want == run["on_card"]["proof_sha256"]:
        raise AssertionError("fused app: the replay on a second trace did not give its own bytes")
    if {k: id(v) for k, v in dpk._fused_cache.items()} != entries:
        raise AssertionError("fused app: the second trace was captured again, not replayed")
    if fused_sha256(first) != run["on_card"]["proof_sha256"]:
        raise AssertionError("fused app: the replay on a second trace changed the first proof")
    _say(f"fused app [segmented]: second trace (seed {FUSED_SECOND_SEED}) replayed in {secs:.3f} s, sha256 "
         f"{want[:16]} (its device-transcript prove's); the first proof unchanged [{smi}]")


def fused_refusal(device) -> None:
    """The ``interactions`` golden case captured (segmented), then replayed
    on the unbalanced receiver of ``tests/test_torch_prove.py``: the GKR
    zero check, deferred to the fetch, refuses the replayed sum."""
    import numpy as np

    from swirl_torch.engine import StarkEngine
    from swirl_torch.prover import fused
    from swirl_torch.prover.backend import ProvingContext
    from swirl_torch.testing.fixtures import DummyInteractionAir
    from swirl_torch.testing.golden import golden_cases, paths_for

    params, airs, ctxs = golden_cases()["interactions"]()
    eng = StarkEngine(params, device=device)
    pk, _ = eng.keygen(airs)
    dpk = eng.transport_pk(pk)
    ctx = ProvingContext([eng.context_for(i, *c) for i, c in enumerate(ctxs)])
    with open(paths_for("interactions")["proof"], "rb") as f:
        if fused_sha256(fused.prove_fused(eng.backend, dpk, ctx, "segmented")) != hashlib.sha256(f.read()).hexdigest():
            raise AssertionError("fused interactions: the captured proof is not the golden one")
    recv = np.array(ctxs[1][0], dtype=np.uint64)
    recv[0, 1] = 8  # (7, 9) -> (8, 9): no sender matches
    bad = ProvingContext([ctx.per_trace[0], eng.context_for(1, DummyInteractionAir.make_trace(recv.tolist()))])
    entries = {k: id(v) for k, v in dpk._fused_cache.items()}
    try:
        fused.prove_fused(eng.backend, dpk, bad, "segmented")
    except ValueError as err:
        refusal = str(err)
    else:
        raise AssertionError("fused interactions: a non-zero LogUp sum was not refused on replay")
    if "fractional sum is non-zero" not in refusal or {k: id(v) for k, v in dpk._fused_cache.items()} != entries:
        raise AssertionError(f"fused interactions: refused otherwise ({refusal}) or captured again")
    fused.release_fused(dpk)
    _say(f"fused interactions [segmented]: golden bytes captured; the unbalanced trace refused on replay at the "
         f"fetch: {refusal}")


def fused_cached(device) -> None:
    """The ``cached_preprocessed`` golden case captured (segmented); its
    context freed and the freed blocks filled with other values; a fresh
    ``context_for`` of the same cached trace hits the entry and replays to
    the golden bytes: the graphs read their own copies of the cached
    mains."""
    import torch

    from swirl_torch.engine import StarkEngine
    from swirl_torch.prover import fused
    from swirl_torch.prover.backend import ProvingContext
    from swirl_torch.testing.golden import golden_cases, paths_for

    params, airs, ctxs = golden_cases()["cached_preprocessed"]()
    eng = StarkEngine(params, device=device)
    pk, _ = eng.keygen(airs)
    dpk = eng.transport_pk(pk)
    with open(paths_for("cached_preprocessed")["proof"], "rb") as f:
        want = hashlib.sha256(f.read()).hexdigest()
    ctx = ProvingContext([eng.context_for(i, *c) for i, c in enumerate(ctxs)])
    if fused_sha256(fused.prove_fused(eng.backend, dpk, ctx, "segmented")) != want:
        raise AssertionError("fused cached_preprocessed: the captured proof is not the golden one")
    entries = {k: id(v) for k, v in dpk._fused_cache.items()}
    freed = fused.cached_tensors([tc.cached_mains for _, tc in ctx.per_trace])
    shapes = [(t.shape, t.dtype) for t in freed + [tc.common_main for _, tc in ctx.per_trace]]
    del ctx, freed
    junk = [torch.full(shape, 12345, dtype=dtype, device=device) for shape, dtype in shapes]
    fresh = ProvingContext([eng.context_for(i, *c) for i, c in enumerate(ctxs)])
    got = fused_sha256(fused.prove_fused(eng.backend, dpk, fresh, "segmented"))
    if got != want or {k: id(v) for k, v in dpk._fused_cache.items()} != entries:
        raise AssertionError("fused cached_preprocessed: the replay on a fresh context of the cached trace did not "
                             "give the golden bytes from the same entry")
    fused.release_fused(dpk)
    _say(f"fused cached_preprocessed [segmented]: golden bytes captured; the context freed and {len(junk)} blocks "
         f"refilled; a fresh context of the same cached trace replayed to the golden bytes")


def fused_cell(tag: str, run: dict, required, smi: str) -> float:
    """The fused phase's share of a cell: its modes (the graphs of one
    released before the next), and for the app the second trace and the
    refusal; ``release_fused`` after. Returns seconds."""
    import torch

    from swirl_torch.prover import fused

    t0 = time.perf_counter()
    stats = {}
    for mode in FUSED_MODES[tag]:
        proof = fused_mode(tag, run, mode, required, smi, stats)
        if mode != FUSED_MODES[tag][-1]:
            fused.release_fused(run["dpk"])
    if tag == "app":
        fused_second_trace(run, proof, smi)
        fused_refusal(run["engine"].device)
        fused_cached(run["engine"].device)
    fused.release_fused(run["dpk"])
    torch.cuda.empty_cache()
    return time.perf_counter() - t0


MESH_APP_SHA256 = "008305aaf187766a"  # the app's proof (PRs 10-15)
MESH_WORLD = 2  # gloo ranks on the one card
MESH_TIMEOUT_S = 300


def mesh_app(run: dict, required, smi: str) -> float:
    """World of one, NCCL: the app's ``prove_fused(mode="segmented",
    mesh=proof_mesh())`` (first call split, aten ops of its warm-up, mean of
    ``FUSED_REPLAYS`` replays, peaks, one host read) with kernels A-F and
    the commits' collectives captured, its sha256 the app's; then
    ``mode="jit"`` once. Returns seconds."""
    import torch
    import torch.distributed as dist

    from swirl_torch.parallel import multihost, sharded
    from swirl_torch.prover import fused

    t0 = time.perf_counter()
    if not run["on_card"]["proof_sha256"].startswith(MESH_APP_SHA256):
        raise AssertionError(f"mesh app: the app's proof is {run['on_card']['proof_sha256'][:16]}, not {MESH_APP_SHA256}")
    mesh = multihost.proof_mesh()
    backend = dist.get_backend(mesh.get_group())
    if (backend, mesh.size()) != ("nccl", 1):
        raise AssertionError(f"mesh app: proof_mesh() gave a {backend} mesh of {mesh.size()}")
    for mode, replays in (("segmented", FUSED_REPLAYS), ("jit", 0)):
        stats = {} if mode == "segmented" else {"aten_ops": stats["aten_ops"]}
        sharded.reset_collective_counts()
        fused_mode("mesh app", run, mode, required, smi, stats, mesh=mesh, replays=replays)
        collectives = sharded.collective_counts()
        missing = [k for k in required if stats["captured_launches"].get(k, 0) == 0]
        if missing or not collectives["all_gather"]:
            raise AssertionError(f"mesh app [{mode}]: the capture never launched {missing} or gathered nothing")
        _say(f"mesh app [{mode}]: world of one, {backend}; collectives a prove (warm-up and capture) {collectives}; "
             f"the mesh in the cache key")
        fused.release_fused(run["dpk"])
    dist.destroy_process_group()
    torch.cuda.empty_cache()
    return time.perf_counter() - t0


def mesh_stacked(device):
    """The app's stacked matrix shape (16, 2^22), random from ``SEED``."""
    import torch

    from swirl_torch.fields.babybear import P

    gen = torch.Generator(device=device)
    gen.manual_seed(SEED)
    return torch.randint(0, P, (16, 1 << APP_LOG_STACKED), generator=gen, device=device, dtype=torch.int64)


def _tensor_sha(t) -> str:
    return hashlib.sha256(t.contiguous().cpu().numpy().tobytes()).hexdigest()


def mesh_commit_digest(code, layers) -> dict:
    return {"root": [int(v) for v in layers[-1][:, 0].tolist()], "code": _tensor_sha(code),
            "layers": [_tensor_sha(layer) for layer in layers]}


def mesh_rank_main(rank: int, port: int, out: str) -> int:
    """One gloo rank of :func:`mesh_world_of_two` on ``cuda:0``: the app's
    commit across the ranks (the codeword's and layers' sha256, the root),
    A-D's launches and the collectives, gloo's refusal of a collective it
    does not take on CUDA, and the graph modes' refusal of a gloo mesh."""
    import torch
    import torch.distributed as dist

    from swirl_torch import kernels as K
    from swirl_torch.engine import StarkEngine
    from swirl_torch.params import app_params_with_100_bits_security
    from swirl_torch.parallel import annotate, multihost, sharded
    from swirl_torch.prover import fused
    from swirl_torch.prover.backend import ProvingContext
    from swirl_torch.prover.commit_kernel import commit_eager
    from swirl_torch.prover.errors import ProverError
    from swirl_torch.testing.golden import golden_cases

    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank, world_size=MESH_WORLD)
    try:
        mesh = multihost.proof_mesh(device_type="cuda")
        p = app_params_with_100_bits_security(APP_LOG_STACKED)
        stacked = mesh_stacked(device)
        K.LIB.get()
        K.reset_launch_counts()
        sharded.reset_collective_counts()
        t0 = time.perf_counter()
        with annotate.spmd_mesh(mesh):
            code, layers = commit_eager(p.l_skip, p.log_blowup, p.k_whir, stacked)
        torch.cuda.synchronize()
        result = {"rank": dist.get_rank(), "backend": dist.get_backend(mesh.get_group()), "size": mesh.size(),
                  "seconds": time.perf_counter() - t0, "launches": K.launch_counts(),
                  "collectives": sharded.collective_counts(), **mesh_commit_digest(code, layers)}
        del code, layers
        try:
            sharded.ppermute(stacked[:, :8], mesh, [(0, 1), (1, 0)])
        except ProverError as err:
            result["ppermute"] = str(err)
        params, airs, ctxs = golden_cases()["fib"]()
        eng = StarkEngine(params, device=device)
        pk, _ = eng.keygen(airs)
        ctx = ProvingContext([eng.context_for(i, *c) for i, c in enumerate(ctxs)])
        for mode in ("segmented", "jit"):
            try:
                fused.prove_fused(eng.backend, eng.transport_pk(pk), ctx, mode=mode, mesh=mesh)
            except ProverError as err:
                result[f"refusal_{mode}"] = str(err)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    with open(out, "w") as f:
        json.dump(result, f)
    return 0


def mesh_world_of_two(device, smi: str) -> float:
    """``MESH_WORLD`` gloo ranks spawned on the one card run the prover's
    sharded commit of the app's stacked shape on CUDA tensors
    (:func:`mesh_rank_main`): every rank's root, codeword and gathered
    layers must equal this process's one-device commit, A-D launch on each
    rank, gloo takes the collectives of the commit and the wrapper refuses
    the one it does not take, and the graph modes refuse the gloo mesh.
    Every process started is stopped. Returns seconds."""
    import os
    import shutil
    import socket
    import tempfile

    import torch

    from swirl_torch import kernels as K
    from swirl_torch.params import app_params_with_100_bits_security
    from swirl_torch.prover.commit_kernel import commit_eager

    t0 = time.perf_counter()
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    tmp = tempfile.mkdtemp(dir=os.path.join(os.path.dirname(os.path.abspath(__file__)), "build"))
    outs = [os.path.join(tmp, f"rank{r}.json") for r in range(MESH_WORLD)]
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--mesh-rank", str(r), str(port), outs[r]],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE) for r in range(MESH_WORLD)]
    try:
        p = app_params_with_100_bits_security(APP_LOG_STACKED)
        code, layers = commit_eager(p.l_skip, p.log_blowup, p.k_whir, mesh_stacked(device))
        want = mesh_commit_digest(code, layers)
        del code, layers
        torch.cuda.empty_cache()
        for proc in procs:
            _, err = proc.communicate(timeout=MESH_TIMEOUT_S)
            if proc.returncode != 0:
                raise AssertionError(f"mesh world of two: a rank failed:\n{err.decode(errors='replace')[-3000:]}")
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    required = [k.name for k in (K.NTT, K.HASH_COLS, K.COMPRESS, K.TOWER)]
    results = []
    for path in outs:
        with open(path) as f:
            results.append(json.load(f))
    shutil.rmtree(tmp)
    for res in results:
        tag = f"mesh world of two, rank {res['rank']}"
        if (res["backend"], res["size"]) != ("gloo", MESH_WORLD):
            raise AssertionError(f"{tag}: a {res['backend']} mesh of {res['size']}")
        if {k: res[k] for k in ("root", "code", "layers")} != want:
            raise AssertionError(f"{tag}: the sharded commit differs from the one-device commit")
        missing = [k for k in required if res["launches"][k] == 0]
        if missing:
            raise AssertionError(f"{tag}: the sharded commit never launched {missing}")
        refusals = [res.get(k) for k in ("ppermute", "refusal_segmented", "refusal_jit")]
        if not all(refusals) or not all("cannot be captured" in r for r in refusals[1:]):
            raise AssertionError(f"{tag}: a refusal is missing: {refusals}")
        _say(f"{tag}: the app's commit (16, 2^{APP_LOG_STACKED}) on CUDA tensors over gloo in {res['seconds']:.3f} s; "
             f"root {res['root']}, codeword and {len(res['layers'])} layers equal to the one-device commit's; "
             f"launches {res['launches']}; collectives {res['collectives']} (gloo took them on CUDA tensors) [{smi}]")
        _say(f"{tag}: refused: {refusals[0]}; segmented: {refusals[1]}; jit: {refusals[2]}")
    return time.perf_counter() - t0


def report_roofline(tag: str, run: dict, params) -> None:
    """The stage roofline of a uniform SyntheticAir cell beside its
    host-transcript prove's spans."""
    from swirl_torch import roofline

    spans = {k[: -len("_time_ms")]: v for k, v in run["spans_ms"].items()}
    for stage, entry in roofline.report(params, LOG_ROWS, WIDTH, 8, spans).items():
        _say(f"queue_b roofline [{tag}] {stage}: {json.dumps(entry)}")


def report(tag: str, run: dict, required) -> None:
    _say(f"{tag}: {run['size']}, setup {run['setup_s']:.3f} s, prove {run['prove_s']:.3f} s")
    want = PROOF_SHA256.get(tag)
    if want is not None:
        _say(f"{tag}: proof sha256 {run['proof_sha256'][:16]} (ROADMAP.md §D: {want}); GKR sub-rounds by kernel "
             f"K {run['counters'].get('gkr_kernel_subrounds', 0)}, its launches {run['launches']['gkr_round']}; "
             f"the batch phase's kernel L launches {run['counters'].get('batch_ef4_launches', 0)} and F.ext_mul "
             f"calls left {run['counters'].get('batch_ef4_aten', 0)}")
        if not run["proof_sha256"].startswith(want):
            raise AssertionError(f"{tag}: proof sha256 {run['proof_sha256'][:16]}, not {want}")
    for line in run.get("extra", []):
        _say(f"{tag}: {line}")
    _say(f"{tag}: debug check {run['debug_s']:.3f} s (on the card, before the prove)")
    _say(f"{tag}: verify {run['verify_s']:.3f} s (host verifier, the decoded proof bytes)")
    for name, ms in sorted(run["spans_ms"].items()):
        _say(f"{tag}: span {name} {ms:.1f}")
    if run["proof_bytes"] is None:
        _say(f"{tag}: peak device memory {run['peak_bytes']} B, proof sha256 {run['proof_sha256'][:16]} "
             f"(over its fields: the codec holds the inner scheme's digests only)")
    else:
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
    card = run["on_card"]
    if card is None:
        return
    _say(f"{tag}, device transcript: prove {card['prove_s']:.3f} s, peak device memory "
         f"{card['peak_bytes']} B, proof sha256 {card['proof_sha256'][:16]} (the host-transcript proof's)")
    for name, ms in sorted(card["spans_ms"].items()):
        _say(f"{tag}, device transcript: span {name} {ms:.1f}")
    _say(f"{tag}, device transcript: kernel launches {card['launches']}; kernel E's longest absorb "
         f"{card['longest_absorb']} felts (the longest of DUPLEX_CASES: {max(c[3] + c[4] for c in DUPLEX_CASES)})")
    for name in sorted(card["host_reads"].keys() | card["host_writes"].keys()):
        _say(f"{tag}, device transcript: span {name} host reads {card['host_reads'].get(name, 0)}, "
             f"host writes {card['host_writes'].get(name, 0)}")
    missing = [name for name in [*required, "duplex", "grind"] if card["launches"][name] == 0]
    if missing:
        raise AssertionError(f"{tag}, device transcript: the path never launched {missing}")


def release(run: dict) -> None:
    """Drops a cell's engine, proving key and context (its trace on the
    card) before the next cell, whose peak would count them."""
    import torch

    for key in ("engine", "dpk", "ctx"):
        run.pop(key, None)
    torch.cuda.empty_cache()


def report_memory(tag: str, run: dict) -> dict:
    """Prints a prove's peak by span and the memory model beside its peak;
    returns the row of the memory table."""
    spans = ", ".join(f"{k} {v}" for k, v in sorted(run["peaks_by_span"].items(), key=lambda kv: -kv[1]))
    _say(f"{tag}: peak device memory by span (B): {spans}")
    model = run.get("memory_model")
    if model is None:
        return {}
    parts = ", ".join(f"{k} {v}" for k, v in model.items() if k != "counts")
    ratio = model["total"] / run["peak_bytes"]
    _say(f"{tag}: memory model {model['counts']}: {parts}; measured peak {run['peak_bytes']} B, "
         f"estimate / measured {ratio:.4f}")
    round0 = run["peaks_by_span"].get("zerocheck_round0")
    if round0 is not None:
        _say(f"{tag}: zerocheck_round0 span peak {round0} B against the model's batch phase (traces, "
             f"cached matrices, batch term) {model['batch_phase']} B, ratio {model['batch_phase'] / round0:.4f}")
    return {"tag": tag, "estimate": model["total"], "measured": run["peak_bytes"], "ratio": ratio,
            "round0": round0, "batch_phase": model["batch_phase"]}


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
    from swirl_torch.prover.backend import ProverConfig
    from swirl_torch.tools import isa

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
    cycles, ghz = isa.latency_bench()
    clocks = isa.perm_clocks(isa.QUAD_PERM_CHAIN, cycles)
    perm_floor_ms = clocks / BOOST_HZ * 1e3
    row_clocks = isa.perm_clocks(isa.ROW_PERM_CHAIN, cycles)
    row_floor_ms = row_clocks / BOOST_HZ * 1e3
    scalar_floor_ms = isa.perm_clocks(isa.SCALAR_PERM_CHAIN, cycles) / BOOST_HZ * 1e3
    _say(f"latency: SM clocks a dependent operation {cycles} (at {ghz:.3f} GHz); one quad permutation's "
         f"chain {isa.QUAD_PERM_CHAIN}: {clocks:.0f} clocks, floor {perm_floor_ms:.6f} ms at the boost clock; "
         f"one row permutation's (kernel E) {isa.ROW_PERM_CHAIN}: {row_clocks:.0f} clocks, floor "
         f"{row_floor_ms:.6f} ms; one scalar permutation's (B, C, F's sweep route) {isa.SCALAR_PERM_CHAIN}: floor "
         f"{scalar_floor_ms:.6f} ms")

    bn_perm_floor = None
    try:
        found = isa.report_census("bn254")
        for label, (outside, loops) in found.items():
            trips = [isa.pipe_counts(body) for _, body in loops]
            _say(f"census {label}: outside loops (wide, fma, alu, fp64) {isa.pipe_counts(outside)}, one trip of each "
                 f"loop {trips}")
        bn_perm_floor = isa.bn254_perm_floor(found)
        _say(f"census floor: SM-clocks a lane's permutation, by width (the pipe that sets it) {bn_perm_floor}, at "
             f"{isa.PIPE_RATES} lane operations a clock an SM, {isa.ISSUE_RATE} issued")
    except (OSError, subprocess.SubprocessError, SystemExit, ValueError) as err:
        _say(f"census: not read ({err})")
    _say(f"model: a BN254 product {BN_MONT}, add {BN_ADD}, permutation width 3 {BN_PERM[3]}, "
         f"width 2 {BN_PERM[2]} (multiplies, others)")

    results = check_kernels(device, perm_floor_ms)
    results.update(check_transcript_kernels(device, perm_floor_ms, row_floor_ms))
    results[K.GRIND.name] = check_grind_widths(device, row_floor_ms, scalar_floor_ms)
    results.update(check_gkr_kernels(device))
    results.update(check_ef4_kernels(device))
    t0 = time.perf_counter()
    results.update(check_bn254_kernels(device, bn_perm_floor))
    torch.cuda.empty_cache()
    _say(f"bn254 kernels: phase {time.perf_counter() - t0:.1f} s")
    K.reset_launch_counts()
    check_golden(device)
    counts = K.launch_counts()
    _say(f"golden: kernel launches {counts}")
    queue_b_phase(device)
    check_outer(device)

    # the host-transcript prove launches neither E nor F
    app_kernels = [k.name for k in (K.NTT, K.HASH_COLS, K.COMPRESS, K.TOWER)]
    memory = []
    app = prove_synthetic(device, app_params_with_100_bits_security(APP_LOG_STACKED), 3, on_card=True)
    report("app", app, app_kernels)
    report_roofline("app", app, app_params_with_100_bits_security(APP_LOG_STACKED))
    if not app["engine"].backend.config.zerocheck_save_memory:
        raise AssertionError("app: the default ProverConfig does not segment round 0 at log_blowup 1")
    memory.append(report_memory("app (default config: round 0 in 8 segments)", app))
    report_memory("app, device transcript", app["on_card"])
    full = prove_with_config(app, ProverConfig(zerocheck_save_memory=False))
    _say(f"app, zerocheck_save_memory=False: prove {full['prove_s']:.3f} s, peak {full['peak_bytes']} B "
         f"(segmented {app['peak_bytes']} B), proof sha256 {full['proof_sha256'][:16]} (the default's)")
    memory.append(report_memory("app, zerocheck_save_memory=False", full))
    fused_path = [*app_kernels, K.DUPLEX.name, K.GRIND.name]
    fused_s = fused_cell("app", app, fused_path, smi)
    mesh_s = mesh_app(app, fused_path, smi)
    release(app)
    mesh_s += mesh_world_of_two(device, smi)
    _say(f"mesh: phase {mesh_s:.1f} s (the app on a world of one, NCCL; the commit over {MESH_WORLD} gloo ranks)")
    leaf = prove_synthetic(device, leaf_params_with_100_bits_security(LEAF_LOG_STACKED), 4, on_card=True)
    leaf_kernels = [*app_kernels, K.NTT_RECURSIVE.name]
    report("leaf", leaf, leaf_kernels)
    report_roofline("leaf", leaf, leaf_params_with_100_bits_security(LEAF_LOG_STACKED))
    memory.append(report_memory("leaf", leaf))
    report_memory("leaf, device transcript", leaf["on_card"])
    _say(f"leaf: peak device memory host transcript {leaf['peak_bytes']} B, device transcript "
         f"{leaf['on_card']['peak_bytes']} B")
    lean = prove_with_config(leaf, ProverConfig(cache_stacked_matrix=False, cache_rs_code_matrix=False))
    ntt_launches = [r["launches"][K.NTT.name] + r["launches"][K.NTT_RECURSIVE.name] for r in (leaf, lean)]
    _say(f"leaf, both caches off: prove {lean['prove_s']:.3f} s, peak {lean['peak_bytes']} B (cached "
         f"{leaf['peak_bytes']} B), proof sha256 {lean['proof_sha256'][:16]} (the cached proof's); "
         f"A and A′ launches {ntt_launches[1]} (cached {ntt_launches[0]}), kernel launches {lean['launches']}")
    if ntt_launches[1] <= ntt_launches[0]:
        raise AssertionError("leaf, both caches off: the recompute launched no more NTTs than the cached prove")
    memory.append(report_memory("leaf, both caches off", lean))
    fused_s += fused_cell("leaf", leaf, [*fused_path, K.NTT_RECURSIVE.name], smi)
    release(leaf)
    t0 = time.perf_counter()
    check_kernels(device, perm_floor_ms, keccak=True)
    keccak = prove_keccak(device, on_card=True)
    report("keccak", keccak, app_kernels)
    memory.append(report_memory("keccak", keccak))
    report_memory("keccak, device transcript", keccak["on_card"])
    keccak_s = time.perf_counter() - t0
    fused_s += fused_cell("keccak", keccak, fused_path, smi)
    _say(f"fused: phase {fused_s:.1f} s (app in three modes, leaf and Keccak segmented)")
    release(keccak)
    _say(f"keccak: phase {keccak_s:.1f} s (kernel cases, trace, setup, debug, prove, verify, refusals; the "
         f"fused cell apart)")
    t0 = time.perf_counter()
    outer = prove_outer_root(device)
    outer_kernels = [k.name for k in (K.NTT, K.BN254_MERKLE, K.BN254_LEAVES, K.BN254_GRIND)]
    report("outer root", outer, outer_kernels)
    memory.append(report_memory("outer root", outer))
    release(outer)
    _say(f"outer root: phase {time.perf_counter() - t0:.1f} s (setup, debug, prove, verify, refusals)")
    t0 = time.perf_counter()
    reth_phase(device, memory)
    _say(f"reth: phase {time.perf_counter() - t0:.1f} s")
    _say(f"total: {time.perf_counter() - start:.1f} s (build included)")
    below = [row["tag"] for row in memory if row["estimate"] < row["measured"]]
    if below:
        raise AssertionError(f"the memory model's estimate is below the measured peak: {below}")
    below = [row["tag"] for row in memory if row["round0"] is not None and row["batch_phase"] < row["round0"]]
    if below:
        raise AssertionError(f"the memory model's batch phase is below the zerocheck_round0 span's peak: {below}")

    # launches: the leaf path, the one path that runs A-D and A′; E and F
    # on the app's device-transcript prove, K and L on its host-transcript prove;
    # G-J on the outer root prove (G,
    # the elementwise field kernel, is phase 2's and the tests': 0 there)
    bn254 = (K.BN254_FIELD, K.BN254_MERKLE, K.BN254_LEAVES, K.BN254_GRIND)

    def source_run(k):
        if k in (K.GKR_ROUND, K.EF4):
            return app
        return app["on_card"] if k in (K.DUPLEX, K.GRIND) else outer if k in bn254 else leaf

    launches = {k.name: source_run(k)["launches"][k.name] for k in K.KERNELS}
    kernels = [
        {
            "name": k.name,
            "route": "cuda",
            "source": k.source,
            "replaces": k.replaces,
            "launches": launches[k.name],
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
    if len(sys.argv) == 5 and sys.argv[1] == "--mesh-rank":  # a rank of mesh_world_of_two
        sys.exit(mesh_rank_main(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]))
    sys.exit(main())
