"""Golden parity fixtures: the case builders, schemes, log codec, file
paths, ``build_case`` and ``regenerate`` of ``swirl/testing/golden.py``,
copied for the port.

``tests/golden/`` holds frozen proof bytes, vk bytes and transcript event
logs of small deterministic proofs made by the JAX package. The port must
reproduce them byte for byte: ``build_case(name, device)`` proves a case on
the port's engine on ``device`` (the card unless the caller passes
``"cpu"``) with a recording transcript, and ``regenerate`` writes the files
of its cases from it, as the JAX package's does.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, List, Tuple

import numpy as np

GOLDEN_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "tests",
    "golden",
)


def golden_cases() -> Dict[str, Callable]:
    """name -> zero-arg builder returning (params, airs, ctxs).

    ctxs: per AIR (common_main, public_values, cached_mains) as accepted by
    ``StarkEngine.run_test``. Everything is pinned: traces, heights, params.
    """
    from ..params import test_system_params_small
    from .fixtures import (
        DummyInteractionAir,
        FibonacciAir,
        FibonacciSelectorAir,
    )

    def fib():
        params = test_system_params_small(2, 6, 3)
        air = FibonacciAir()
        trace = air.generate_trace(0, 1, 64)
        return params, [air], [(trace, air.pvs(0, 1, 64), [])]

    def interactions():
        params = test_system_params_small(2, 4, 3)
        sender = DummyInteractionAir(2, is_send=True, bus_index=3)
        receiver = DummyInteractionAir(2, is_send=False, bus_index=3)
        send_rows = [[2, 7, 9], [1, 3, 4], [0, 0, 0], [0, 0, 0]]
        recv_rows = [
            [1, 7, 9],
            [1, 7, 9],
            [1, 3, 4],
            [0, 0, 0],
            [0, 0, 0],
            [0, 0, 0],
            [0, 0, 0],
            [0, 0, 0],
        ]
        return (
            params,
            [sender, receiver],
            [
                (DummyInteractionAir.make_trace(send_rows), [], []),
                (DummyInteractionAir.make_trace(recv_rows), [], []),
            ],
        )

    def preprocessed():
        params = test_system_params_small(2, 6, 3)
        sels = [i % 3 != 2 for i in range(16)]
        air = FibonacciSelectorAir(sels)
        trace = air.generate_trace(1, 1)
        return params, [air], [(trace, air.pvs(1, 1), [])]

    def cached_preprocessed():
        # cached-main partitions AND a preprocessed AIR in ONE proof
        # (round-4 verdict item 9: pin the cached + preprocessed paths)
        from .fixtures import MultiCachedAir

        params = test_system_params_small(2, 6, 3)
        mc = MultiCachedAir()
        common, cached = MultiCachedAir.generate_traces(16, seed=5)
        sels = [i % 2 == 0 for i in range(16)]
        fsel = FibonacciSelectorAir(sels)
        ftrace = fsel.generate_trace(2, 3)
        return (
            params,
            [mc, fsel],
            [
                (common, [], cached),
                (ftrace, fsel.pvs(2, 3), []),
            ],
        )

    def outer():
        # the BN254 outer hash scheme (CASE_SCHEME): its fixtures are the
        # multi-field transcript's events and the pre-hash; the codec is the
        # inner scheme's only
        params = test_system_params_small(2, 6, 3)
        air = FibonacciAir()
        trace = air.generate_trace(0, 1, 64)
        return params, [air], [(trace, air.pvs(0, 1, 64), [])]

    return {
        "fib": fib,
        "interactions": interactions,
        "preprocessed": preprocessed,
        "cached_preprocessed": cached_preprocessed,
        "outer": outer,
    }


# per-case hash scheme (None = the default BabyBear Poseidon2)
CASE_SCHEME = {"outer": "bn254-outer"}


def case_has_codec(name: str) -> bool:
    """Whether vk and proof byte fixtures exist for the case (the codec
    serializes the inner scheme's digests only)."""
    return CASE_SCHEME.get(name) is None


def pre_hash_hex(pre_hash) -> str:
    """The ``*.prehash.txt`` text of a vk pre-hash: 8 hex words of the
    inner digest, or one 64-digit BN254 scalar."""
    if isinstance(pre_hash, int):
        return f"{pre_hash:064x}"
    return "".join(f"{int(x):08x}" for x in np.asarray(pre_hash).ravel())


def encode_transcript_log(log: List[Tuple[str, int]]) -> bytes:
    """One event per line: 'o <v>' / 's <v>' — plain text, diffable; values
    are Python ints, so a 254-bit BN254 digest is written in full."""
    lines = []
    for kind, value in log:
        lines.append(("o" if kind == "observe" else "s") + " " + str(value))
    return ("\n".join(lines) + "\n").encode()


def decode_transcript_log(data: bytes) -> List[Tuple[str, int]]:
    out = []
    for line in data.decode().splitlines():
        kind, value = line.split()
        out.append(("observe" if kind == "o" else "sample", int(value)))
    return out


def build_case(name: str, device="cuda"):
    """Prove one golden case on the port's engine on ``device``; returns
    (vk_bytes, pre_hash_hex, proof_bytes, transcript_log, vk, proof). The
    recording transcript is the scheme's, made on the engine's device (the
    outer scheme grinds there)."""
    from ..codec import encode_proof, encode_vk
    from ..engine import StarkEngine
    from ..prover.backend import ProvingContext

    params, airs, ctxs = golden_cases()[name]()
    eng = StarkEngine(params, hash_scheme=CASE_SCHEME.get(name), device=device)
    pk, vk = eng.keygen(airs)
    per_trace = [
        eng.context_for(i, cm, pvs, cached)
        for i, (cm, pvs, cached) in enumerate(ctxs)
    ]
    ctx = ProvingContext(per_trace)
    dpk = eng.transport_pk(pk)
    transcript = eng.scheme.new_transcript(record=True, device=eng.device)
    proof = eng.prove(dpk, ctx, transcript=transcript)
    eng.verify(vk, proof)
    if case_has_codec(name):
        vk_bytes, proof_bytes = encode_vk(vk), encode_proof(proof)
    else:
        vk_bytes, proof_bytes = b"", b""
    return (
        vk_bytes,
        pre_hash_hex(vk.pre_hash),
        proof_bytes,
        list(transcript.log),
        vk,
        proof,
    )


def paths_for(name: str) -> Dict[str, str]:
    return {
        "vk": os.path.join(GOLDEN_DIR, f"{name}.vk.bin"),
        "prehash": os.path.join(GOLDEN_DIR, f"{name}.prehash.txt"),
        "proof": os.path.join(GOLDEN_DIR, f"{name}.proof.bin"),
        "transcript": os.path.join(GOLDEN_DIR, f"{name}.transcript.txt"),
    }


def regenerate(names=None, device="cuda") -> None:
    """Write the golden files of ``names`` (every case by default) from
    :func:`build_case` on ``device``."""
    os.makedirs(GOLDEN_DIR, exist_ok=True)
    for name in names or golden_cases():
        vk_bytes, pre_hash, proof_bytes, log, _, _ = build_case(name, device)
        p = paths_for(name)
        if case_has_codec(name):
            with open(p["vk"], "wb") as f:
                f.write(vk_bytes)
            with open(p["proof"], "wb") as f:
                f.write(proof_bytes)
        with open(p["prehash"], "w") as f:
            f.write(pre_hash + "\n")
        with open(p["transcript"], "wb") as f:
            f.write(encode_transcript_log(log))
        print(
            f"golden: {name}: proof {len(proof_bytes)} B, vk {len(vk_bytes)} B, "
            f"{len(log)} transcript events"
        )
