"""Where the host verifier's time goes, for the app and leaf proofs (and,
with ``--profile``, the Keccak proof).

    python -m swirl_torch.tools.verify_cost            # estimate, any host
    python -m swirl_torch.tools.verify_cost --profile  # measure, on the card

The estimate counts the two loops of ``swirl_torch/verifier/whir.py`` that
grow with the WHIR parameters, and times one call of their inner step on
this host:

- the Merkle checks: in each round r, for each of its q_r queries, 2^k
  leaf hashes (``hash_slice_np``; round 0 hashes a row of the stacked
  width, later rounds one EF4 value), 2^k - 1 compressions to the query
  digest and log_rs - k - r compressions up the path (the codeword
  halves each round);
- the final check: the final polynomial, 2^log_final_poly_len EF4
  coefficients, evaluated by Horner (one EF4 product and one sum a
  coefficient) at every query point and at each round's out-of-domain
  point.

``--profile`` proves the app and leaf cells and the Keccak workload of
``chip_smoke.py`` on the card (the same AIRs, params and seeded inputs)
and runs the verifier once on each proof's decoded bytes under
``cProfile``, printing its seconds and the functions that take the most
of them.
"""

from __future__ import annotations

import cProfile
import io
import pstats
import sys
import time

import numpy as np

from ..fields import ext
from ..fields.babybear import P
from ..hash.poseidon2 import compress_np, hash_slice_np
from ..params import app_params_with_100_bits_security, leaf_params_with_100_bits_security

# the cells of chip_smoke.py: 2^20 rows x 64 columns under these presets
CELLS = (
    ("app", app_params_with_100_bits_security(22), 3),
    ("leaf", leaf_params_with_100_bits_security(25), 4),
)
ROWS_LOG, WIDTH, SEED = 20, 64, 0


def _seconds_per_call(fn, *args, reps: int = 200) -> float:
    fn(*args)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn(*args)
    return (time.perf_counter() - t0) / reps


def merkle_calls(params, width: int):
    """({row width: hash_slice calls}, compress calls) of one verification."""
    whir = params.whir
    k = whir.k
    log_rs = params.l_skip + params.n_stack + params.log_blowup
    hashes, compresses = {}, 0
    for r, rnd in enumerate(whir.rounds):
        row = width if r == 0 else 4
        hashes[row] = hashes.get(row, 0) + rnd.num_queries * (1 << k)
        compresses += rnd.num_queries * ((1 << k) - 1 + log_rs - k - r)
    return hashes, compresses


def horner_steps(params) -> int:
    """EF4 product-and-sum steps of the final check's Horner evaluations."""
    points = sum(rnd.num_queries for rnd in params.whir.rounds) + len(params.whir.rounds) - 1
    return points << params.log_final_poly_len()


def estimate() -> None:
    rng = np.random.default_rng(0)
    left, right, a, b = (rng.integers(0, P, n, dtype=np.uint64) for n in (8, 8, 4, 4))
    t_compress = _seconds_per_call(compress_np, left, right)
    t_step = _seconds_per_call(lambda: ext.eadd(ext.emul(a, b), a))
    print(f"compress_np {t_compress * 1e6:.1f} us, Horner step {t_step * 1e6:.1f} us a call")
    for name, params, _ in CELLS:
        # the stacked width: the trace's cells over the stacked height
        width = max(1, (WIDTH << ROWS_LOG) >> (params.l_skip + params.n_stack))
        hashes, compresses = merkle_calls(params, width)
        merkle = compresses * t_compress
        for row, count in sorted(hashes.items()):
            t_hash = _seconds_per_call(hash_slice_np, rng.integers(0, P, row, dtype=np.uint64))
            print(f"{name}: hash_slice_np of {row} words {t_hash * 1e6:.1f} us a call, {count} calls")
            merkle += count * t_hash
        steps = horner_steps(params)
        print(f"{name}: compress_np {compresses} calls; Merkle checks {merkle:.3f} s")
        print(f"{name}: Horner {steps} steps; final check {steps * t_step:.3f} s")
        print(f"{name}: estimate {merkle + steps * t_step:.3f} s")


def profile() -> None:
    import torch

    from ..codec import decode_proof, decode_vk, encode_proof, encode_vk
    from ..engine import StarkEngine
    from ..prover.backend import ProvingContext
    from ..testing.synthetic import SyntheticAir, uniform_shape
    from ..verifier import verify

    from .prove_profile import keccak_workload

    def workloads():
        for name, params, degree in CELLS:
            air = SyntheticAir(uniform_shape(ROWS_LOG, WIDTH, num_constraints=16, num_interactions=8, degree=degree))
            trace = np.random.default_rng(SEED).integers(0, P, (1 << ROWS_LOG, air.common_main_width()),
                                                         dtype=np.uint64)
            trace[:, 0] = 0
            yield name, params, air, trace
        yield ("keccak", *keccak_workload())

    for name, params, air, trace in workloads():
        eng = StarkEngine(params)
        pk, vk = eng.keygen([air])
        proof = eng.prove(eng.transport_pk(pk), ProvingContext([eng.context_for(0, trace, [], [])]))
        vk, proof = decode_vk(encode_vk(vk)), decode_proof(encode_proof(proof))
        del pk, eng
        torch.cuda.empty_cache()
        prof = cProfile.Profile()
        t0 = time.perf_counter()
        prof.runcall(verify, params, vk, proof)
        seconds = time.perf_counter() - t0
        out = io.StringIO()
        pstats.Stats(prof, stream=out).sort_stats("cumulative").print_stats(16)
        print(f"{name}: verify {seconds:.3f} s under cProfile")
        print(out.getvalue())


if __name__ == "__main__":
    profile() if "--profile" in sys.argv[1:] else estimate()
