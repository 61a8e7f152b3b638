"""Versioned byte-level encoding/decoding of proofs (recursion-friendly).

The proof codec reproduces the reference byte layout EXACTLY
(``crates/stark-backend/src/codec.rs`` primitives + ``proof.rs:224-446``
Encode/Decode impls, ``CODEC_VERSION = 3``): a proof encoded here
byte-decodes under the reference ``Decode`` and vice versa. Conventions:

- ``usize``/lengths: u32 little-endian (codec.rs:197-201)
- F: canonical u32 LE, decode rejects values >= p (codec.rs:213-232)
- EF: 4 base coefficients; Digest: 8 F values, no length prefix
- ``Vec<T>``: u32 length + elements; fixed arrays: elements only
- trace_vdata: count + presence bitmap (LSB-first per byte, canonical
  zero padding) + present entries (proof.rs:230-246)
- GKR sumcheck poly shape, WHIR round/row shapes are derived, not encoded
  (see the per-section comments below).

The vk codec further down is swirl's own layout (the reference serializes
vks with serde/postcard, not the byte codec — ``keygen/mod.rs:198-216``).
"""

from __future__ import annotations

import io
import struct
from typing import List

import numpy as np

from .fields.babybear import P
from .proof import (
    BatchConstraintProof,
    GkrLayerClaims,
    GkrProof,
    Proof,
    StackingProof,
    TraceVData,
    WhirProof,
)

# Reference codec version (proof.rs:224). The proof byte layout below is the
# reference's; bump only in lock-step with the reference format.
CODEC_VERSION = 3


class CodecError(Exception):
    pass


# -- primitives ---------------------------------------------------------------


def _w_u32(buf, v: int):
    buf.write(struct.pack("<I", v & 0xFFFFFFFF))


def _r_u32(buf) -> int:
    b = buf.read(4)
    if len(b) != 4:
        raise CodecError("unexpected EOF")
    return struct.unpack("<I", b)[0]


def _w_usize(buf, v: int):
    # usize encodes as u32 LE (codec.rs:197-201); lengths must fit.
    if not 0 <= v < (1 << 32):
        raise CodecError("usize out of u32 range")
    buf.write(struct.pack("<I", v))


def _r_usize(buf) -> int:
    return _r_u32(buf)


def _w_bool(buf, v: bool):
    buf.write(b"\x01" if v else b"\x00")


def _r_bool(buf) -> bool:
    b = buf.read(1)
    if len(b) != 1:
        raise CodecError("unexpected EOF")
    if b not in (b"\x00", b"\x01"):
        raise CodecError("non-canonical bool byte")
    return b == b"\x01"


def _w_felt(buf, v: int):
    v = int(v)
    if not 0 <= v < P:
        raise CodecError("field element out of range")
    _w_u32(buf, v)


def _r_felt(buf) -> int:
    v = _r_u32(buf)
    if v >= P:
        raise CodecError("non-canonical field element")
    return v


def _w_ef(buf, v):
    v = np.asarray(v).reshape(4)
    for c in v:
        _w_felt(buf, int(c))


def _r_ef(buf) -> np.ndarray:
    return np.array([_r_felt(buf) for _ in range(4)], dtype=np.uint64)


def _w_digest(buf, d):
    d = np.asarray(d).reshape(8)
    for c in d:
        _w_felt(buf, int(c))


def _r_digest(buf) -> np.ndarray:
    return np.array([_r_felt(buf) for _ in range(8)], dtype=np.uint64)


def _w_ef_vec(buf, vec):
    _w_usize(buf, len(vec))
    for v in vec:
        _w_ef(buf, v)


def _r_ef_vec(buf) -> List[np.ndarray]:
    n = _r_usize(buf)
    return [_r_ef(buf) for _ in range(n)]


# -- proof sections -----------------------------------------------------------


def encode_proof(proof: Proof) -> bytes:
    buf = io.BytesIO()
    _w_u32(buf, CODEC_VERSION)
    _w_digest(buf, proof.common_main_commit)

    num_airs = len(proof.trace_vdata)
    _w_usize(buf, num_airs)
    # presence bitmap
    for i in range(0, num_airs, 8):
        byte = 0
        for j, v in enumerate(proof.trace_vdata[i : i + 8]):
            if v is not None:
                byte |= 1 << j
        buf.write(bytes([byte]))
    for v in proof.trace_vdata:
        if v is not None:
            _w_usize(buf, v.log_height)
            _w_usize(buf, len(v.cached_commitments))
            for c in v.cached_commitments:
                _w_digest(buf, c)

    _w_usize(buf, len(proof.public_values))
    for pvs in proof.public_values:
        _w_usize(buf, len(pvs))
        for pv in pvs:
            _w_felt(buf, pv)

    g = proof.gkr_proof
    _w_felt(buf, g.logup_pow_witness)
    _w_ef(buf, g.q0_claim)
    _w_usize(buf, len(g.claims_per_layer))
    for cl in g.claims_per_layer:
        _w_ef(buf, cl.p_xi_0)
        _w_ef(buf, cl.p_xi_1)
        _w_ef(buf, cl.q_xi_0)
        _w_ef(buf, cl.q_xi_1)
    # sumcheck_polys shape derivable from claims count
    for rnd in g.sumcheck_polys:
        for arr in rnd:
            for v in arr:
                _w_ef(buf, v)

    b = proof.batch_constraint_proof
    _w_ef_vec(buf, b.numerator_term_per_air)
    for v in b.denominator_term_per_air:
        _w_ef(buf, v)
    _w_ef_vec(buf, b.univariate_round_coeffs)
    _w_usize(buf, len(b.sumcheck_round_polys))
    if b.sumcheck_round_polys:
        _w_usize(buf, len(b.sumcheck_round_polys[0]))
        for rnd in b.sumcheck_round_polys:
            for v in rnd:
                _w_ef(buf, v)
    for parts in b.column_openings:
        _w_usize(buf, len(parts))
        for cols in parts:
            _w_ef_vec(buf, cols)

    s = proof.stacking_proof
    _w_ef_vec(buf, s.univariate_round_coeffs)
    _w_usize(buf, len(s.sumcheck_round_polys))
    for pair in s.sumcheck_round_polys:
        _w_ef(buf, pair[0])
        _w_ef(buf, pair[1])
    _w_usize(buf, len(s.stacking_openings))
    for opens in s.stacking_openings:
        _w_ef_vec(buf, opens)

    w = proof.whir_proof
    _w_felt(buf, w.mu_pow_witness)
    _w_usize(buf, len(w.whir_sumcheck_polys))
    for pair in w.whir_sumcheck_polys:
        _w_ef(buf, pair[0])
        _w_ef(buf, pair[1])
    num_whir_sumcheck_rounds = len(w.whir_sumcheck_polys)
    _w_usize(buf, len(w.codeword_commits))
    for c in w.codeword_commits:
        _w_digest(buf, c)
    for v in w.ood_values:
        _w_ef(buf, v)
    num_whir_rounds = len(w.codeword_commits) + 1
    if num_whir_sumcheck_rounds % num_whir_rounds != 0:
        raise CodecError(
            "num_whir_sumcheck_rounds must be a multiple of num_whir_rounds"
        )
    if num_whir_rounds != len(w.query_phase_pow_witnesses):
        raise CodecError("query_phase_pow_witnesses length mismatch")
    for pw in w.folding_pow_witnesses:
        _w_felt(buf, pw)
    for pw in w.query_phase_pow_witnesses:
        _w_felt(buf, pw)

    # Initial round (proof.rs:352-398): num_commits, num_queries, then — only
    # when queries exist — merkle depth, ALL per-commit stacked widths, ALL
    # opened rows (no per-row prefixes), then ALL merkle proofs.
    num_commits = len(w.initial_round_opened_rows)
    if num_commits == 0:
        raise CodecError("num_commits must be nonzero")
    _w_usize(buf, num_commits)
    nq0 = len(w.initial_round_opened_rows[0])
    _w_usize(buf, nq0)
    if nq0 > 0:
        depth = len(w.initial_round_merkle_proofs[0][0])
        _w_usize(buf, depth)
        widths = []
        for commit_rows in w.initial_round_opened_rows:
            width = (
                np.asarray(commit_rows[0]).shape[-1]
                if commit_rows and np.asarray(commit_rows[0]).size
                else 0
            )
            widths.append(width)
            _w_usize(buf, width)
        for commit_rows in w.initial_round_opened_rows:
            for rows in commit_rows:
                for row in np.asarray(rows).reshape(-1):
                    _w_felt(buf, int(row))
        for proofs in w.initial_round_merkle_proofs:
            for pf in proofs:
                for d in pf:
                    _w_digest(buf, d)

    # Non-initial rounds: outer length (= num_whir_rounds - 1) is derived
    # from codeword_commits, NOT encoded (proof.rs:400-407).
    for rnd_vals in w.codeword_opened_values:
        _w_usize(buf, len(rnd_vals))
        for vals in rnd_vals:
            for v in np.asarray(vals).reshape(-1, 4):
                _w_ef(buf, v)
    # First non-initial merkle depth; later rounds are one shallower each
    # (proof.rs:409-421).
    if len(w.codeword_commits) > 0 and nq0 > 0:
        first_depth = len(w.codeword_merkle_proofs[0][0])
    else:
        first_depth = 0
    _w_usize(buf, first_depth)
    for rnd_proofs in w.codeword_merkle_proofs:
        for pf in rnd_proofs:
            for d in pf:
                _w_digest(buf, d)

    _w_ef_vec(buf, w.final_poly)
    return buf.getvalue()


def decode_proof(data: bytes) -> Proof:
    buf = io.BytesIO(data)
    version = _r_u32(buf)
    if version != CODEC_VERSION:
        raise CodecError(f"codec version mismatch: {version} != {CODEC_VERSION}")
    common_main_commit = _r_digest(buf)

    num_airs = _r_usize(buf)
    bitmap = []
    for _ in range((num_airs + 7) // 8):
        byte = buf.read(1)
        if len(byte) != 1:
            raise CodecError("unexpected EOF")
        bitmap.append(byte[0])
    present = []
    for i in range(num_airs):
        present.append((bitmap[i // 8] >> (i % 8)) & 1 == 1)
    # canonical encoding: padding bits must be zero
    if num_airs % 8 != 0 and bitmap and (bitmap[-1] >> (num_airs % 8)) != 0:
        raise CodecError("non-canonical presence bitmap")
    trace_vdata: List = []
    for p in present:
        if p:
            lh = _r_usize(buf)
            nc = _r_usize(buf)
            trace_vdata.append(
                TraceVData(log_height=lh, cached_commitments=[_r_digest(buf) for _ in range(nc)])
            )
        else:
            trace_vdata.append(None)

    n_pvs = _r_usize(buf)
    public_values = []
    for _ in range(n_pvs):
        k = _r_usize(buf)
        public_values.append([_r_felt(buf) for _ in range(k)])

    logup_pow = _r_felt(buf)
    q0 = _r_ef(buf)
    n_layers = _r_usize(buf)
    claims = []
    for _ in range(n_layers):
        p0, p1, q0_, q1_ = _r_ef(buf), _r_ef(buf), _r_ef(buf), _r_ef(buf)
        claims.append(GkrLayerClaims(p_xi_0=p0, p_xi_1=p1, q_xi_0=q0_, q_xi_1=q1_))
    sumcheck_polys = []
    for rnd in range(1, n_layers):
        sumcheck_polys.append(
            [[_r_ef(buf), _r_ef(buf), _r_ef(buf)] for _ in range(rnd)]
        )
    gkr = GkrProof(
        logup_pow_witness=logup_pow,
        q0_claim=q0,
        claims_per_layer=claims,
        sumcheck_polys=sumcheck_polys,
    )

    numer = _r_ef_vec(buf)
    denom = [_r_ef(buf) for _ in range(len(numer))]
    uni = _r_ef_vec(buf)
    n_rounds = _r_usize(buf)
    round_polys = []
    if n_rounds:
        per = _r_usize(buf)
        for _ in range(n_rounds):
            round_polys.append([_r_ef(buf) for _ in range(per)])
    col_openings = []
    for _ in range(len(numer)):
        n_parts = _r_usize(buf)
        col_openings.append([_r_ef_vec(buf) for _ in range(n_parts)])
    batch = BatchConstraintProof(
        numerator_term_per_air=numer,
        denominator_term_per_air=denom,
        univariate_round_coeffs=uni,
        sumcheck_round_polys=round_polys,
        column_openings=col_openings,
    )

    s_uni = _r_ef_vec(buf)
    n_s = _r_usize(buf)
    s_rounds = [[_r_ef(buf), _r_ef(buf)] for _ in range(n_s)]
    n_open = _r_usize(buf)
    s_opens = [_r_ef_vec(buf) for _ in range(n_open)]
    stacking = StackingProof(
        univariate_round_coeffs=s_uni,
        sumcheck_round_polys=s_rounds,
        stacking_openings=s_opens,
    )

    mu_pow = _r_felt(buf)
    n_ws = _r_usize(buf)
    w_polys = [[_r_ef(buf), _r_ef(buf)] for _ in range(n_ws)]
    n_cc = _r_usize(buf)
    cw_commits = [_r_digest(buf) for _ in range(n_cc)]
    num_whir_rounds = n_cc + 1
    oods = [_r_ef(buf) for _ in range(num_whir_rounds - 1)]
    fold_pows = [_r_felt(buf) for _ in range(n_ws)]
    query_pows = [_r_felt(buf) for _ in range(num_whir_rounds)]

    if n_ws % num_whir_rounds != 0:
        raise CodecError(
            "num_whir_sumcheck_rounds must be a multiple of num_whir_rounds"
        )
    k_whir = n_ws // num_whir_rounds
    k_exp = 1 << k_whir

    n_commits = _r_usize(buf)
    if n_commits == 0:
        raise CodecError("num_commits must be nonzero")
    nq0 = _r_usize(buf)
    init_rows: List[List[np.ndarray]] = [[] for _ in range(n_commits)]
    init_proofs: List[List[List[np.ndarray]]] = [[] for _ in range(n_commits)]
    if nq0 > 0:
        depth = _r_usize(buf)
        widths = [_r_usize(buf) for _ in range(n_commits)]
        for c in range(n_commits):
            width = widths[c]
            for _ in range(nq0):
                vals = np.array(
                    [_r_felt(buf) for _ in range(k_exp * width)], dtype=np.uint64
                ).reshape(k_exp, width)
                init_rows[c].append(vals)
        for c in range(n_commits):
            for _ in range(nq0):
                init_proofs[c].append([_r_digest(buf) for _ in range(depth)])

    # num_whir_rounds - 1 non-initial rounds; length derived, not encoded.
    cw_opened = []
    for _ in range(num_whir_rounds - 1):
        nq = _r_usize(buf)
        vals_round = []
        for _ in range(nq):
            vals_round.append(np.stack([_r_ef(buf) for _ in range(k_exp)]))
        cw_opened.append(vals_round)
    depth0 = _r_usize(buf)
    cw_proofs = []
    d = depth0
    for rnd_vals in cw_opened:
        cw_proofs.append(
            [[_r_digest(buf) for _ in range(d)] for _ in rnd_vals]
        )
        d -= 1
    final_poly = _r_ef_vec(buf)

    whir = WhirProof(
        mu_pow_witness=mu_pow,
        whir_sumcheck_polys=w_polys,
        codeword_commits=cw_commits,
        ood_values=oods,
        folding_pow_witnesses=fold_pows,
        query_phase_pow_witnesses=query_pows,
        initial_round_opened_rows=init_rows,
        initial_round_merkle_proofs=init_proofs,
        codeword_opened_values=cw_opened,
        codeword_merkle_proofs=cw_proofs,
        final_poly=final_poly,
    )
    if buf.read(1) != b"":
        raise CodecError("trailing bytes")
    return Proof(
        common_main_commit=common_main_commit,
        trace_vdata=trace_vdata,
        public_values=public_values,
        gkr_proof=gkr,
        batch_constraint_proof=batch,
        stacking_proof=stacking,
        whir_proof=whir,
    )


# -- vk codec -----------------------------------------------------------------
# Peer of the reference's EncodableConfig + vk Encode/Decode impls
# (codec.rs:53, keygen/types.rs): a versioned, non-self-describing byte
# layout for MultiStarkVerifyingKey including the full SystemParams and
# each AIR's symbolic constraint DAG, so a verifier can be instantiated
# from bytes alone.


def _w_i64(buf, v: int):
    buf.write(struct.pack("<q", int(v)))


def _r_i64(buf) -> int:
    b = buf.read(8)
    if len(b) != 8:
        raise CodecError("unexpected EOF")
    return struct.unpack("<q", b)[0]


def _w_str(buf, s: str):
    b = s.encode()
    _w_usize(buf, len(b))
    buf.write(b)


def _r_str(buf) -> str:
    n = _r_usize(buf)
    b = buf.read(n)
    if len(b) != n:
        raise CodecError("unexpected EOF")
    return b.decode()


def _encode_params(buf, params):
    _w_usize(buf, params.l_skip)
    _w_usize(buf, params.n_stack)
    _w_usize(buf, params.w_stack)
    _w_usize(buf, params.log_blowup)
    _w_usize(buf, params.max_constraint_degree)
    w = params.whir
    _w_usize(buf, w.k)
    _w_usize(buf, w.mu_pow_bits)
    _w_usize(buf, w.query_phase_pow_bits)
    _w_usize(buf, w.folding_pow_bits)
    _w_usize(buf, len(w.rounds))
    for r in w.rounds:
        _w_usize(buf, r.num_queries)
    pr = w.proximity
    _w_usize(buf, pr.m)
    _w_usize(buf, pr.list_start_round)
    _w_str(buf, pr.kind)
    _w_usize(buf, params.logup.max_interaction_count)
    _w_usize(buf, params.logup.log_max_message_length)
    _w_usize(buf, params.logup.pow_bits)


def _decode_params(buf):
    from .params import (
        LogUpSecurityParameters,
        SystemParams,
        WhirConfig,
        WhirProximityStrategy,
        WhirRoundConfig,
    )

    l_skip = _r_usize(buf)
    n_stack = _r_usize(buf)
    w_stack = _r_usize(buf)
    log_blowup = _r_usize(buf)
    maxd = _r_usize(buf)
    k = _r_usize(buf)
    mu_pow = _r_usize(buf)
    qp_pow = _r_usize(buf)
    fold_pow = _r_usize(buf)
    nr = _r_usize(buf)
    rounds = tuple(WhirRoundConfig(_r_usize(buf)) for _ in range(nr))
    m = _r_usize(buf)
    lsr = _r_usize(buf)
    kind = _r_str(buf)
    prox = WhirProximityStrategy(kind=kind, m=m, list_start_round=lsr)
    logup = LogUpSecurityParameters(
        max_interaction_count=_r_usize(buf),
        log_max_message_length=_r_usize(buf),
        pow_bits=_r_usize(buf),
    )
    whir = WhirConfig(
        k=k,
        rounds=rounds,
        mu_pow_bits=mu_pow,
        query_phase_pow_bits=qp_pow,
        folding_pow_bits=fold_pow,
        proximity=prox,
    )
    return SystemParams(
        l_skip=l_skip,
        n_stack=n_stack,
        w_stack=w_stack,
        log_blowup=log_blowup,
        whir=whir,
        logup=logup,
        max_constraint_degree=maxd,
    )


_NODE_TAGS = ["const", "var", "sel", "add", "sub", "mul", "neg"]


def _encode_dag(buf, dag):
    _w_usize(buf, len(dag.nodes))
    for n in dag.nodes:
        tag = n[0]
        buf.write(bytes([_NODE_TAGS.index(tag)]))
        if tag == "const":
            _w_u32(buf, int(n[1]))
        elif tag == "var":
            _w_str(buf, n[1])
            _w_usize(buf, n[2])
            _w_usize(buf, n[3])
            _w_usize(buf, n[4])
        elif tag == "sel":
            _w_str(buf, n[1])
        elif tag in ("add", "sub", "mul"):
            _w_usize(buf, n[1])
            _w_usize(buf, n[2])
            _w_usize(buf, n[3])
        else:  # neg
            _w_usize(buf, n[1])
            _w_usize(buf, n[2])
    _w_usize(buf, len(dag.constraint_idx))
    for i in dag.constraint_idx:
        _w_usize(buf, i)
    _w_usize(buf, len(dag.interactions))
    for it in dag.interactions:
        _w_usize(buf, len(it.message))
        for mi in it.message:
            _w_usize(buf, mi)
        _w_usize(buf, it.count)
        _w_usize(buf, it.bus_index)
        _w_i64(buf, it.count_weight)


def _decode_dag(buf):
    from .symbolic import ConstraintsDag, Interaction

    nn = _r_usize(buf)
    nodes = []
    for _ in range(nn):
        t = buf.read(1)
        if len(t) != 1:
            raise CodecError("unexpected EOF")
        tag = _NODE_TAGS[t[0]]
        if tag == "const":
            nodes.append(("const", _r_u32(buf)))
        elif tag == "var":
            nodes.append(
                ("var", _r_str(buf), _r_usize(buf), _r_usize(buf), _r_usize(buf))
            )
        elif tag == "sel":
            nodes.append(("sel", _r_str(buf)))
        elif tag in ("add", "sub", "mul"):
            nodes.append((tag, _r_usize(buf), _r_usize(buf), _r_usize(buf)))
        else:
            nodes.append(("neg", _r_usize(buf), _r_usize(buf)))
    cidx = [_r_usize(buf) for _ in range(_r_usize(buf))]
    its = []
    for _ in range(_r_usize(buf)):
        msg = [_r_usize(buf) for _ in range(_r_usize(buf))]
        its.append(
            Interaction(
                message=msg,
                count=_r_usize(buf),
                bus_index=_r_usize(buf),
                count_weight=_r_i64(buf),
            )
        )
    return ConstraintsDag(nodes=nodes, constraint_idx=cidx, interactions=its)


def encode_vk(mvk) -> bytes:
    """MultiStarkVerifyingKey -> versioned bytes."""
    buf = io.BytesIO()
    _w_u32(buf, CODEC_VERSION)
    _encode_params(buf, mvk.params)
    _w_usize(buf, len(mvk.per_air))
    for vk in mvk.per_air:
        w = vk.params.width
        _w_i64(buf, -1 if w.preprocessed is None else w.preprocessed)
        _w_usize(buf, len(w.cached_mains))
        for c in w.cached_mains:
            _w_usize(buf, c)
        _w_usize(buf, w.common_main)
        _w_usize(buf, vk.params.num_public_values)
        _w_bool(buf, vk.params.need_rot)
        _w_usize(buf, vk.max_constraint_degree)
        _w_bool(buf, vk.is_required)
        _w_bool(buf, vk.preprocessed_data is not None)
        if vk.preprocessed_data is not None:
            _w_digest(buf, vk.preprocessed_data.commit)
            _w_i64(buf, vk.preprocessed_data.hypercube_dim)
            _w_usize(buf, vk.preprocessed_data.stacking_width)
        _encode_dag(buf, vk.symbolic_constraints)
        unused = getattr(vk, "unused_variables", [])
        _w_usize(buf, len(unused))
        for entry, part, offset, index in unused:
            _w_str(buf, entry)
            _w_usize(buf, part)
            _w_usize(buf, offset)
            _w_usize(buf, index)
    _w_usize(buf, len(mvk.trace_height_constraints))
    for c in mvk.trace_height_constraints:
        _w_usize(buf, len(c.coefficients))
        for co in c.coefficients:
            _w_usize(buf, co)
        _w_usize(buf, c.threshold)
    _w_digest(buf, mvk.pre_hash)
    return buf.getvalue()


def decode_vk(data: bytes):
    """Bytes -> MultiStarkVerifyingKey (roundtrip of :func:`encode_vk`)."""
    from .keygen import (
        LinearConstraint,
        MultiStarkVerifyingKey,
        StarkVerifyingKey,
        StarkVerifyingParams,
        TraceWidth,
        VerifierPreprocessedData,
    )

    buf = io.BytesIO(data)
    if _r_u32(buf) != CODEC_VERSION:
        raise CodecError("codec version mismatch")
    params = _decode_params(buf)
    per_air = []
    for _ in range(_r_usize(buf)):
        prep_w = _r_i64(buf)
        cached = [_r_usize(buf) for _ in range(_r_usize(buf))]
        common = _r_usize(buf)
        npv = _r_usize(buf)
        need_rot = _r_bool(buf)
        maxd = _r_usize(buf)
        is_required = _r_bool(buf)
        prep = None
        if _r_bool(buf):
            prep = VerifierPreprocessedData(
                commit=_r_digest(buf),
                hypercube_dim=_r_i64(buf),
                stacking_width=_r_usize(buf),
            )
        dag = _decode_dag(buf)
        unused = [
            (_r_str(buf), _r_usize(buf), _r_usize(buf), _r_usize(buf))
            for _ in range(_r_usize(buf))
        ]
        per_air.append(
            StarkVerifyingKey(
                preprocessed_data=prep,
                params=StarkVerifyingParams(
                    width=TraceWidth(
                        preprocessed=None if prep_w < 0 else prep_w,
                        cached_mains=cached,
                        common_main=common,
                    ),
                    num_public_values=npv,
                    need_rot=need_rot,
                ),
                symbolic_constraints=dag,
                max_constraint_degree=maxd,
                is_required=is_required,
                unused_variables=unused,
            )
        )
    constraints = []
    for _ in range(_r_usize(buf)):
        coeffs = [_r_usize(buf) for _ in range(_r_usize(buf))]
        constraints.append(
            LinearConstraint(coefficients=coeffs, threshold=_r_usize(buf))
        )
    pre_hash = _r_digest(buf)
    return MultiStarkVerifyingKey(
        params=params,
        per_air=per_air,
        trace_height_constraints=constraints,
        pre_hash=pre_hash,
    )
