"""WHIR opening proof on torch tensors (host transcript).

Peer of the host-transcript branch of ``prove_whir_opening``
(``swirl/prover/whir.py:115-391``): all committed stacked columns batch into
one MLE with mu powers; each WHIR round runs k sumcheck folds of
sum_x f(x) * w(x), commits RS(g) (NTT + Merkle tree over EF leaves), takes
an out-of-domain value, grinds, opens the queries and adds the gamma terms
to the weight polynomial.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from ..fields import ext as hext
from ..fields.babybear import P, two_adic_generator
from ..params import SystemParams
from ..proof import WhirProof
from .errors import WhirProverError
from ..transcript import Transcript

from ..fields import field as F
from .merkle import build_merkle_tree, get_opened_rows
from .ntt import mobius_transform, ntt, zeta_transform
from .stacked_pcs import StackedPcsData, rs_message
from .sumcheck import (
    ef_dev,
    eq_pows_base_batch,
    eq_pows_hypercube,
    fold_mle,
    interp_mle_at_int,
    mobius_eq_hypercube,
    pow_hypercube,
)

QUERY_CHUNK = 32  # queries per eq-table batch: bounds the (chunk, 2^m) buffer


def prove_whir_opening(
    transcript: Transcript,
    params: SystemParams,
    committed: Sequence[StackedPcsData],
    u: List[np.ndarray],
    tree_builder=None,
) -> WhirProof:
    """``tree_builder``: when set, ``(matrix, rows_per_query, ext) -> (root,
    tree)`` replaces the Poseidon2 Merkle build of the codeword commits
    (the hash-scheme hook; None for the default scheme)."""
    whir = params.whir
    l_skip = params.l_skip
    k = whir.k
    num_rounds = whir.num_whir_rounds()
    if not committed:
        raise WhirProverError("prove_whir_opening: no committed data")
    expected_h = int(committed[0].matrix.shape[1])
    for d in committed:
        h = int(d.matrix.shape[1])
        if h != expected_h:
            raise WhirProverError(f"prove_whir_opening: tree height {h} != expected {expected_h}")
    device = committed[0].matrix.device

    mu_pow_witness = transcript.grind(whir.mu_pow_bits)
    mu = transcript.sample_ext()
    total_width = sum(int(d.matrix.shape[0]) for d in committed)
    mu_pows = hext.epowers(mu, total_width)

    m = expected_h.bit_length() - 1
    log_rs = m + params.log_blowup

    # f = sum_j mu^j * hatF_j, hatF_j the zeta transform of the RS message
    f_evals = None
    off = 0
    for d in committed:
        hatf = zeta_transform(rs_message(l_skip, d.matrix), m)  # (w, 2^m) base
        for j in range(hatf.shape[0]):
            term = F.mul(hatf[j][:, None], ef_dev(mu_pows[off + j], device))
            f_evals = term if f_evals is None else F.add(f_evals, term)
        off += hatf.shape[0]
        del hatf
    w_evals = mobius_eq_hypercube(np.stack(u), device)  # (2^m, 4)

    whir_sumcheck_polys: List[List[np.ndarray]] = []
    codeword_commits: List[np.ndarray] = []
    ood_values: List[np.ndarray] = []
    folding_pow_witnesses: List[int] = []
    query_phase_pow_witnesses: List[int] = []
    initial_opened_rows: List[List[np.ndarray]] = [[] for _ in committed]
    initial_merkle_proofs: List[List[List[np.ndarray]]] = [[] for _ in committed]
    codeword_opened_values: List[List[np.ndarray]] = []
    codeword_merkle_proofs: List[List[List[np.ndarray]]] = []
    final_poly = None
    rs_tree = None
    rs_codeword = None  # (1, H, 4)

    cur_m = m
    for whir_round in range(num_rounds):
        is_last = whir_round == num_rounds - 1
        num_queries = whir.rounds[whir_round].num_queries

        for _ in range(k):
            evals = F.to_host(
                torch.stack(
                    [
                        F.ext_sum(
                            F.ext_mul(interp_mle_at_int(f_evals, x), interp_mle_at_int(w_evals, x)),
                            axis=0,
                        )
                        for x in (1, 2)
                    ]
                )
            )
            evals = [evals[0], evals[1]]
            for e in evals:
                transcript.observe_ext(e)
            whir_sumcheck_polys.append(evals)
            folding_pow_witnesses.append(transcript.grind(whir.folding_pow_bits))
            a_dev = ef_dev(transcript.sample_ext(), device)
            f_evals = fold_mle(f_evals, a_dev)
            w_evals = fold_mle(w_evals, a_dev)
        cur_m -= k

        g_coeffs = mobius_transform(f_evals[None], cur_m, ext=True)[0]  # (2^cur_m, 4)
        if not is_last:
            padded = torch.zeros((1 << (log_rs - 1), 4), dtype=F.DTYPE, device=device)
            padded[: 1 << cur_m] = g_coeffs
            g_rs = ntt(padded[None], ext=True)  # (1, H, 4)
            if tree_builder is None:
                g_tree = build_merkle_tree(g_rs, 1 << k, ext=True)
                g_commit = g_tree.root
            else:
                g_commit, g_tree = tree_builder(g_rs, 1 << k, True)
            transcript.observe_commit(g_commit)
            codeword_commits.append(g_commit)

            z0 = transcript.sample_ext()
            # OOD value: the MLE at (z0, z0^2, ...) is the univariate value at z0
            y0 = F.to_host(F.ext_sum(F.ext_mul(g_coeffs, pow_hypercube(z0, cur_m, device)), axis=0))
            transcript.observe_ext(y0)
            ood_values.append(y0)
        else:
            fp = F.to_host(g_coeffs)
            final_poly = [fp[i] for i in range(fp.shape[0])]
            for c in final_poly:
                transcript.observe_ext(c)

        query_phase_pow_witnesses.append(transcript.grind(whir.query_phase_pow_bits))
        indices = [transcript.sample_bits(log_rs - k) for _ in range(num_queries)]
        if whir_round == 0:
            for com_idx, d in enumerate(committed):
                proofs = d.tree.batch_query_proofs(indices) if num_queries else []
                for qi, index in enumerate(indices):
                    initial_opened_rows[com_idx].append(
                        get_opened_rows(d.rs_matrix, index, 1 << k, ext=False)
                    )
                    initial_merkle_proofs[com_idx].append(proofs[qi])
        else:
            proofs = rs_tree.batch_query_proofs(indices) if num_queries else []
            codeword_opened_values.append(
                [get_opened_rows(rs_codeword, index, 1 << k, ext=True)[:, 0, :] for index in indices]
            )
            codeword_merkle_proofs.append(proofs)
        omega = two_adic_generator(log_rs - k)
        zs = [pow(omega, int(i), P) for i in indices]

        if not is_last:
            rs_tree = g_tree
            rs_codeword = g_rs

        gamma = transcript.sample_ext()
        if not is_last:
            # w += gamma * eq(pow(z0)) + sum_i gamma^(2+i) * eq(pow(z_i))
            upd = F.ext_mul(ef_dev(gamma, device), eq_pows_hypercube(z0, cur_m, device))
            gamma_pows = hext.epowers(gamma, num_queries + 2)
            if num_queries:
                zs_vec = F.const_arr(zs, device)
                gp_dev = ef_dev(gamma_pows[2 : num_queries + 2], device)
                for base in range(0, num_queries, QUERY_CHUNK):
                    tab = eq_pows_base_batch(zs_vec[base : base + QUERY_CHUNK], cur_m)
                    gc = gp_dev[base : base + QUERY_CHUNK]
                    upd = F.add(upd, F.ext_sum(F.mul(tab[:, :, None], gc[:, None, :]), axis=0))
            w_evals = F.add(w_evals, upd)
        log_rs -= 1

    return WhirProof(
        mu_pow_witness=mu_pow_witness,
        whir_sumcheck_polys=whir_sumcheck_polys,
        codeword_commits=codeword_commits,
        ood_values=ood_values,
        folding_pow_witnesses=folding_pow_witnesses,
        query_phase_pow_witnesses=query_phase_pow_witnesses,
        initial_round_opened_rows=initial_opened_rows,
        initial_round_merkle_proofs=initial_merkle_proofs,
        codeword_opened_values=codeword_opened_values,
        codeword_merkle_proofs=codeword_merkle_proofs,
        final_poly=final_poly,
    )
