"""WHIR verifier (host).

Cf. reference ``crates/stark-backend/src/verifier/whir.rs``: mu-batches the
stacking openings, replays the per-round sumcheck folds, OOD samples, PoW
gates and in-domain queries (with binary k-fold evaluation of opened coset
rows and Merkle verification), and performs the final constrained-RS check
against the final polynomial.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

from ..fields import ext
from ..fields.babybear import P, U64, finv, two_adic_generator
from ..hash.poseidon2 import compress_np, hash_rows_np, hash_slice_np
from ..proof import WhirProof
from ..transcript import Transcript
from .. import poly as hpoly


from .errors import (
    FinalPolyConstraint,
    FinalPolyDegree,
    FoldingPoWInvalid,
    MerkleVerify,
    MuPoWInvalid,
    QueryPhasePoWInvalid,
    WhirError,
)

__all__ = ["WhirError", "verify_whir", "merkle_verify", "binary_k_fold"]


def _default_digest_eq(a, b) -> bool:
    return np.array_equal(np.asarray(a) % U64(P), np.asarray(b) % U64(P))


def merkle_verify(
    root,
    idx: int,
    leaf_hash,
    proof: Sequence[np.ndarray],
    compress=compress_np,
    digest_eq=_default_digest_eq,
):
    cur = leaf_hash
    for sibling in proof:
        if idx & 1 == 0:
            cur = compress(cur, sibling)
        else:
            cur = compress(sibling, cur)
        idx >>= 1
    if not digest_eq(cur, root):
        raise MerkleVerify(context="path recomputation")


def tree_compress(hashes: List[np.ndarray], compress=compress_np):
    assert len(hashes) & (len(hashes) - 1) == 0
    while len(hashes) > 1:
        hashes = [
            compress(hashes[2 * i], hashes[2 * i + 1])
            for i in range(len(hashes) // 2)
        ]
    return hashes[0]


def binary_k_fold(values: np.ndarray, alphas: List[np.ndarray], x: int) -> np.ndarray:
    """Evaluate the k-fold of f at x^{2^k} from its evals on the coset
    {x, wx, ..., w^{2^k-1} x}: per fold,
    lo += (alpha - t) * (lo - hi) / (2 t), t the point of lo."""
    n = values.shape[0]
    k = len(alphas)
    assert n == 1 << k
    omega = two_adic_generator(k)
    omega_inv = finv(omega)
    tw = [pow(omega, i, P) for i in range(1 << max(k - 1, 0))]
    inv_tw = [pow(omega_inv, i, P) for i in range(1 << max(k - 1, 0))]
    vals = [values[i] for i in range(n)]
    x_pow = x % P
    x_inv_pow = finv(x)
    half = finv(2)
    for j, alpha in enumerate(alphas):
        m = n >> (j + 1)
        new_vals = []
        for i in range(m):
            t = tw[i << j] * x_pow % P
            t_inv = inv_tw[i << j] * x_inv_pow % P
            lo, hi = vals[i], vals[m + i]
            upd = ext.emul(
                ext.esub(alpha, ext.from_base(t)),
                ext.escale(ext.esub(lo, hi), t_inv * half % P),
            )
            new_vals.append(ext.eadd(lo, upd))
        vals = new_vals
        x_pow = x_pow * x_pow % P
        x_inv_pow = x_inv_pow * x_inv_pow % P
    return vals[0]


def verify_whir(
    transcript: Transcript,
    params,
    whir_proof: WhirProof,
    stacking_openings,
    commitments: List[np.ndarray],
    u: List[np.ndarray],
    scheme=None,
):
    """``scheme`` (swirl_torch/hash/scheme.py) selects the Merkle hash family;
    None = inner BabyBear Poseidon2-16."""
    if scheme is None or scheme.name == "babybear-poseidon2":
        _hash, _compress, _eq = hash_slice_np, compress_np, _default_digest_eq
    else:
        _hash, _compress, _eq = (
            scheme.hash_slice,
            scheme.compress,
            scheme.digest_eq,
        )
    whir = params.whir
    widths = [len(v) for v in stacking_openings]

    if not transcript.check_witness(whir.mu_pow_bits, whir_proof.mu_pow_witness):
        raise MuPoWInvalid()
    mu = transcript.sample_ext()

    m = params.l_skip + params.n_stack
    k = whir.k
    num_rounds = whir.num_whir_rounds()
    log_rs = m + params.log_blowup

    mu_pows = ext.epowers(mu, sum(widths))
    claim = ext.ezero()
    i = 0
    for opens in stacking_openings:
        for op in opens:
            claim = ext.eadd(claim, ext.emul(mu_pows[i], op))
            i += 1

    sumcheck_iter = iter(whir_proof.whir_sumcheck_polys)
    folding_iter = iter(whir_proof.folding_pow_witnesses)
    gammas = []
    zs_all = []
    z0s = []
    alphas: List[np.ndarray] = []

    for whir_round in range(num_rounds):
        is_initial = whir_round == 0
        is_final = whir_round == num_rounds - 1
        alphas_round = []
        for _ in range(k):
            ev1, ev2 = next(sumcheck_iter)
            transcript.observe_ext(ev1)
            transcript.observe_ext(ev2)
            pow_witness = next(folding_iter)
            if not transcript.check_witness(whir.folding_pow_bits, pow_witness):
                raise FoldingPoWInvalid(round=whir_round)
            alpha = transcript.sample_ext()
            alphas_round.append(alpha)
            ev0 = ext.esub(claim, ev1)
            claim = hpoly.interpolate_quadratic_at_012([ev0, ev1, ev2], alpha)

        y0 = None
        if is_final:
            for c in whir_proof.final_poly:
                transcript.observe_ext(c)
        else:
            commit = whir_proof.codeword_commits[whir_round]
            transcript.observe_commit(commit)
            z0 = transcript.sample_ext()
            z0s.append(z0)
            y0 = whir_proof.ood_values[whir_round]
            transcript.observe_ext(y0)

        if not transcript.check_witness(
            whir.query_phase_pow_bits,
            whir_proof.query_phase_pow_witnesses[whir_round],
        ):
            raise QueryPhasePoWInvalid(round=whir_round)

        num_queries = whir.rounds[whir_round].num_queries
        indices = [transcript.sample_bits(log_rs - k) for _ in range(num_queries)]
        omega = two_adic_generator(log_rs)
        # every query's leaves and Merkle path are hashed as one batch a
        # round (the program's copy hashes them leaf by leaf)
        q_arr = np.asarray(indices, dtype=np.int64)
        zi_roots = [pow(omega, index, P) for index in indices]
        zs_round = [pow(z, 1 << k, P) for z in zi_roots]
        if is_initial:
            codeword_vals = np.zeros((num_queries, 1 << k, 4), dtype=U64)
            mu_i = 0
            for c_idx, commit in enumerate(commitments):
                rows = np.asarray(whir_proof.initial_round_opened_rows[c_idx], dtype=U64) % U64(P)
                rows = rows.reshape(num_queries, 1 << k, widths[c_idx])
                leaves = _hash_rows(rows.reshape(num_queries << k, widths[c_idx]), _hash)
                digests = _tree_compress_batch(leaves.reshape(num_queries, 1 << k, -1), _compress)
                _merkle_verify_batch(commit, q_arr, digests, whir_proof.initial_round_merkle_proofs[c_idx],
                                     _compress, _eq)
                mp = np.asarray(mu_pows[mu_i : mu_i + widths[c_idx]], dtype=U64)
                mu_i += widths[c_idx]
                for c0 in range(0, widths[c_idx], _COLUMN_BLOCK):
                    part = rows[:, :, c0 : c0 + _COLUMN_BLOCK, None] * mp[None, None, c0 : c0 + _COLUMN_BLOCK] % U64(P)
                    codeword_vals = (codeword_vals + part.sum(axis=2, dtype=U64)) % U64(P)
            ys_round = [binary_k_fold(codeword_vals[q], alphas_round, zi_roots[q]) for q in range(num_queries)]
        else:
            opened = np.asarray(whir_proof.codeword_opened_values[whir_round - 1], dtype=U64) % U64(P)
            opened = opened.reshape(num_queries, 1 << k, 4)
            leaves = _hash_rows(opened.reshape(num_queries << k, 4), _hash)
            digests = _tree_compress_batch(leaves.reshape(num_queries, 1 << k, -1), _compress)
            _merkle_verify_batch(whir_proof.codeword_commits[whir_round - 1], q_arr, digests,
                                 whir_proof.codeword_merkle_proofs[whir_round - 1], _compress, _eq)
            ys_round = [binary_k_fold(opened[q], alphas_round, zi_roots[q]) for q in range(num_queries)]

        gamma = transcript.sample_ext()
        if y0 is not None:
            claim = ext.eadd(claim, ext.emul(y0, gamma))
        gp = ext.emul(gamma, gamma)
        for yi in ys_round:
            claim = ext.eadd(claim, ext.emul(yi, gp))
            gp = ext.emul(gp, gamma)
        gammas.append(gamma)
        zs_all.append(zs_round)
        alphas.extend(alphas_round)
        log_rs -= 1

    if len(whir_proof.final_poly) != 1 << params.log_final_poly_len():
        raise FinalPolyDegree()

    t = k * num_rounds
    final_poly = np.stack(whir_proof.final_poly)
    prefix = hpoly.eval_mobius_eq_mle(np.stack(u[:t]), np.stack(alphas[:t]))
    suffix = hpoly.eval_mle_evals_at_point(
        final_poly, np.stack(u[t:]) if len(u) > t else np.zeros((0, 4), U64)
    )
    acc = ext.emul(prefix, suffix)
    j = k
    for i in range(num_rounds):
        gamma = gammas[i]
        alpha_slc = np.stack(alphas[j:t]) if t > j else np.zeros((0, 4), U64)
        slc_len = (t - j) + 1
        if i != num_rounds - 1:
            z0_pows = _pows_of_2_ext(z0s[i], slc_len)
            acc = ext.eadd(
                acc,
                ext.emul(
                    gamma,
                    ext.emul(
                        hpoly.eval_eq_mle(alpha_slc, np.stack(z0_pows[:-1]))
                        if slc_len > 1
                        else ext.eone(),
                        hpoly.horner_eval(final_poly, z0_pows[-1]),
                    ),
                ),
            )
        gp = ext.emul(gamma, gamma)
        zi_pows_all = [_pows_of_2_base(zi, slc_len) for zi in zs_all[i]]
        at_zi = _horner_many(final_poly, np.stack([pows[-1] for pows in zi_pows_all])) if zi_pows_all else []
        for zi_pows, f_at in zip(zi_pows_all, at_zi):
            acc = ext.eadd(
                acc,
                ext.emul(
                    gp,
                    ext.emul(
                        hpoly.eval_eq_mle(alpha_slc, np.stack(zi_pows[:-1]))
                        if slc_len > 1
                        else ext.eone(),
                        f_at,
                    ),
                ),
            )
            gp = ext.emul(gp, gamma)
        j += k

    if not ext.eeq(acc, claim):
        raise FinalPolyConstraint()


# columns of the opened rows weighted at once (a (queries, 2^k, block, 4)
# product stays a few MB)
_COLUMN_BLOCK = 64


def _hash_rows(rows: np.ndarray, hash_one) -> np.ndarray:
    """(n, w) canonical rows -> (n, 8) digests: the numpy sponge over all
    rows at once, or ``hash_one`` row by row for another hash family."""
    if hash_one is hash_slice_np:
        return hash_rows_np(rows)
    return np.stack([np.asarray(hash_one(r)) for r in rows])


def _compress_pairs(left: np.ndarray, right: np.ndarray, compress) -> np.ndarray:
    if compress is compress_np:
        return compress_np(left, right)
    return np.stack([np.asarray(compress(a, b)) for a, b in zip(left, right)])


def _tree_compress_batch(leaves: np.ndarray, compress) -> np.ndarray:
    """(q, 2^k, 8) leaf digests -> (q, 8): :func:`tree_compress` of each
    query's leaves, a level of every query at once."""
    cur = leaves
    while cur.shape[1] > 1:
        cur = _compress_pairs(cur[:, 0::2].reshape(-1, cur.shape[2]), cur[:, 1::2].reshape(-1, cur.shape[2]),
                              compress).reshape(cur.shape[0], cur.shape[1] // 2, -1)
    return cur[:, 0]


def _merkle_verify_batch(root, indices: np.ndarray, digests: np.ndarray, proofs, compress, digest_eq) -> None:
    """:func:`merkle_verify` of every query at once: ``proofs[q]`` is query
    q's sibling path, one level of every path compressed together."""
    depth = {len(path) for path in proofs}
    if len(depth) != 1 or len(proofs) != len(indices):
        raise MerkleVerify(context="path recomputation")
    cur, idx = digests, indices.copy()
    for level in range(depth.pop()):
        sib = np.stack([np.asarray(path[level], dtype=U64) for path in proofs])
        right = (idx & 1).astype(bool)[:, None]
        cur = _compress_pairs(np.where(right, sib, cur), np.where(right, cur, sib), compress)
        idx >>= 1
    if not all(digest_eq(c, root) for c in cur):
        raise MerkleVerify(context="path recomputation")


def _horner_many(coeffs: np.ndarray, xs: np.ndarray) -> np.ndarray:
    """(n, 4) values of the EF polynomial ``coeffs`` at the (n, 4) points
    ``xs``: :func:`poly.horner_eval` over all points at once."""
    acc = np.zeros(xs.shape, dtype=U64)
    for c in reversed(np.asarray(coeffs, U64).reshape(-1, 4)):
        acc = ext.eadd(ext.emul(acc, xs), c)
    return acc


def _pows_of_2_ext(z: np.ndarray, count: int):
    out = [np.asarray(z, U64)]
    for _ in range(count - 1):
        out.append(ext.emul(out[-1], out[-1]))
    return out


def _pows_of_2_base(z: int, count: int):
    out = [ext.from_base(z % P)]
    for _ in range(count - 1):
        out.append(ext.emul(out[-1], out[-1]))
    return out
