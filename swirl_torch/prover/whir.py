"""WHIR opening proof on torch tensors.

Peer of ``prove_whir_opening`` (``swirl/prover/whir.py:115-391``) and its
device-transcript form (``_fold_round_jit`` :38, ``_whir_device``): all
committed stacked columns batch into one MLE with mu powers; each WHIR
round runs k sumcheck folds of sum_x f(x) * w(x), commits RS(g) (NTT +
Merkle tree over EF leaves), takes an out-of-domain value, grinds, opens
the queries and adds the gamma terms to the weight polynomial.

Every value stays on the device, and the proof is assembled from one copy
at the end (``whir.py:737-745``; :func:`whir_opening_deferred` leaves it to
the fused prover's one copy of the proof). On a
:class:`~.device_transcript.DeviceTranscript` nothing is read back before
that copy: a fold round is a sponge launch for its evaluations, the
folding grind (kernel F), a launch for alpha and the two folds; the query
indices are one launch, the openings one gather a tree (a level a tree for
the paths). On a host transcript each observe reads its value first.
"""

from __future__ import annotations

from typing import Sequence

import torch

from .. import metrics
from ..fields.babybear import P, two_adic_generator
from ..params import SystemParams
from ..proof import WhirProof
from .errors import WhirProverError

from ..fields import field as F
from .deferred import Deferred
from .device_transcript import device_view
from .merkle import build_merkle_tree, get_opened_rows_batch
from .ntt import mobius_transform, zeta_transform
from .stacked_pcs import ENCODE_TIMING, MERKLE_TIMING, StackedPcsData, rs_encode, rs_message
from .sumcheck import (
    eq_pows_base_batch,
    eq_pows_hypercube,
    fold_mle,
    interp_mle_at_int,
    mobius_eq_hypercube,
    pow_hypercube,
)

QUERY_CHUNK = 32  # queries per eq-table batch: bounds the (chunk, 2^m) buffer


def prove_whir_opening(
    transcript,
    params: SystemParams,
    committed: Sequence[StackedPcsData],
    u,
    tree_builder=None,
) -> WhirProof:
    """:func:`whir_opening_deferred`, its values read in one copy."""
    return whir_opening_deferred(transcript, params, committed, u, tree_builder).fetch()


def whir_opening_deferred(
    transcript,
    params: SystemParams,
    committed: Sequence[StackedPcsData],
    u,
    tree_builder=None,
) -> Deferred:
    """The opening with its proof values left on the device: a
    :class:`~.deferred.Deferred` of the proof. ``transcript``: a host :class:`~swirl_torch.transcript.Transcript` or
    a :class:`~.device_transcript.DeviceTranscript` on the data's device; u:
    the opening point, an (m, 4) tensor there or m host EF values.
    ``tree_builder``: when set, ``(matrix, rows_per_query, ext) -> (root,
    tree)`` replaces the Poseidon2 Merkle build of the codeword commits
    (the hash-scheme hook; None for the default scheme); its tree answers
    ``batch_query_proofs_arr``."""
    whir = params.whir
    l_skip = params.l_skip
    k = whir.k
    num_rounds = whir.num_whir_rounds()
    if not committed:
        raise WhirProverError("prove_whir_opening: no committed data")
    if not whir.rounds:
        # the JAX package proves on here, and its own verifier refuses the
        # proof (WhirShapeMismatch: codeword_commits should have -1 entries)
        raise WhirProverError(
            "prove_whir_opening: params.whir.rounds == () (no WHIR round); "
            "the opening needs at least one round"
        )
    expected_h = committed[0].layout.height
    for d in committed:
        h = d.layout.height
        if h != expected_h:
            raise WhirProverError(f"prove_whir_opening: tree height {h} != expected {expected_h}")
    device = committed[0].device
    tr = device_view(transcript, device)

    mu_pow_witness = tr.grind(whir.mu_pow_bits)
    total_width = sum(d.layout.width for d in committed)
    mu_pows = F.epowers(tr.sample_ext(), total_width)

    m = expected_h.bit_length() - 1
    log_rs = m + params.log_blowup

    # f = sum_j mu^j * hatF_j, hatF_j the zeta transform of the RS message
    f_evals = None
    off = 0
    for d in committed:
        hatf = zeta_transform(rs_message(l_skip, d.get_matrix()), m)  # (w, 2^m) base
        for j in range(hatf.shape[0]):
            term = F.mul(hatf[j][:, None], mu_pows[off + j])
            f_evals = term if f_evals is None else F.add(f_evals, term)
        off += hatf.shape[0]
        del hatf
    del mu_pows  # not live at the rounds' peaks
    w_evals = mobius_eq_hypercube(u, device)  # (2^m, 4)

    # the proof's values: on the device until the one copy at the end (a
    # host transcript hands back the host copies it observed)
    sumcheck_polys, folding_wits, query_wits = [], [], []
    commits, oods = [], []
    initial_rows, initial_paths = [], []
    codeword_rows, codeword_paths = [], []
    final_poly = None
    rs_tree = None
    rs_codeword = None  # (1, H, 4)

    cur_m = m
    for whir_round in range(num_rounds):
        is_last = whir_round == num_rounds - 1
        num_queries = whir.rounds[whir_round].num_queries

        for _ in range(k):
            evals = torch.stack(
                [
                    F.ext_sum(
                        F.ext_mul(interp_mle_at_int(f_evals, x), interp_mle_at_int(w_evals, x)),
                        axis=0,
                    )
                    for x in (1, 2)
                ]
            )
            sumcheck_polys.append(tr.observe_slice(evals))
            del evals  # kept only as observed (a host copy on a host transcript)
            folding_wits.append(tr.grind(whir.folding_pow_bits))
            alpha = tr.sample_ext()
            f_evals = fold_mle(f_evals, alpha)
            w_evals = fold_mle(w_evals, alpha)
        cur_m -= k

        g_coeffs = mobius_transform(f_evals[None], cur_m, ext=True)[0]  # (2^cur_m, 4)
        if not is_last:
            with metrics.device_interval(ENCODE_TIMING):
                padded = torch.zeros((1 << (log_rs - 1), 4), dtype=F.DTYPE, device=device)
                padded[: 1 << cur_m] = g_coeffs
                g_rs = rs_encode(padded[None], ext=True)  # (1, H, 4)
            with metrics.device_interval(MERKLE_TIMING):
                if tree_builder is None:
                    g_tree = build_merkle_tree(g_rs, 1 << k, ext=True)
                    g_commit = g_tree.layers[-1][:, 0]
                else:
                    g_commit, g_tree = tree_builder(g_rs, 1 << k, True)
            commits.append(tr.observe_commit(g_commit))

            z0 = tr.sample_ext()
            # OOD value: the MLE at (z0, z0^2, ...) is the univariate value at z0
            y0 = F.ext_sum(F.ext_mul(g_coeffs, pow_hypercube(z0, cur_m, device)), axis=0)
            oods.append(tr.observe_ext(y0))
        else:
            final_poly = tr.observe_slice(g_coeffs)

        query_wits.append(tr.grind(whir.query_phase_pow_bits))
        indices = tr.sample_bits_batch(log_rs - k, num_queries)  # (nq,) on the device
        if whir_round == 0:
            for d in committed:
                # one recompute a commitment where the codewords were dropped
                initial_rows.append(get_opened_rows_batch(d.get_rs_matrix(), indices, 1 << k))
                initial_paths.append(d.tree.batch_query_proofs_arr(indices))
        else:
            codeword_rows.append(get_opened_rows_batch(rs_codeword, indices, 1 << k)[:, :, 0])
            codeword_paths.append(rs_tree.batch_query_proofs_arr(indices))

        if not is_last:
            rs_tree = g_tree
            rs_codeword = g_rs

        gamma = tr.sample_ext()
        if not is_last:
            # w += gamma * eq(pow(z0)) + sum_i gamma^(2+i) * eq(pow(z_i))
            upd = F.ext_mul(gamma, eq_pows_hypercube(z0, cur_m, device))
            if num_queries:
                zs = F.pow_exps(two_adic_generator(log_rs - k), indices, log_rs - k)
                gamma_pows = F.epowers(gamma, num_queries + 2)[2:]
                for base in range(0, num_queries, QUERY_CHUNK):
                    tab = eq_pows_base_batch(zs[base : base + QUERY_CHUNK], cur_m)
                    gc = gamma_pows[base : base + QUERY_CHUNK]
                    upd = F.add(upd, F.ext_sum(F.mul(tab[:, :, None], gc[:, None, :]), axis=0))
            w_evals = F.add(w_evals, upd)
        log_rs -= 1

    values = [mu_pow_witness, *folding_wits, *query_wits, *sumcheck_polys, *commits, *oods,
              final_poly, *initial_rows, *initial_paths, *codeword_rows, *codeword_paths]
    counts = (len(folding_wits), len(query_wits), len(sumcheck_polys), len(commits), len(oods),
              len(committed), len(codeword_rows), len(codeword_paths))
    return Deferred(values, lambda host: _build_whir_proof(host, *counts))


def _build_whir_proof(host, n_fold, n_query, n_polys, n_commits, n_oods, n_com, n_rows, n_paths) -> WhirProof:
    """The proof from the host copies of ``whir_opening_deferred``'s values."""
    host = iter(host)

    def take(n):
        return [next(host) for _ in range(n)]

    witnesses = take(1 + n_fold + n_query)
    if any(int(w) >= P for w in witnesses):
        raise RuntimeError("failed to find PoW witness")
    witnesses = [int(w) for w in witnesses]
    polys = take(n_polys)
    commits_h, oods_h = take(n_commits), take(n_oods)
    (final_h,) = take(1)
    rows0, paths0 = take(n_com), take(n_com)
    rows_cw, paths_cw = take(n_rows), take(n_paths)
    return WhirProof(
        mu_pow_witness=witnesses[0],
        whir_sumcheck_polys=[[e[0], e[1]] for e in polys],
        codeword_commits=commits_h,
        ood_values=oods_h,
        folding_pow_witnesses=witnesses[1 : 1 + n_fold],
        query_phase_pow_witnesses=witnesses[1 + n_fold :],
        initial_round_opened_rows=[list(r) for r in rows0],
        initial_round_merkle_proofs=[[list(p) for p in paths] for paths in paths0],
        codeword_opened_values=[list(r) for r in rows_cw],
        codeword_merkle_proofs=[[list(p) for p in paths] for paths in paths_cw],
        final_poly=list(final_h),
    )
