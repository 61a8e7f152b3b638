"""One gloo rank on the CPU for ``tests/test_torch_parallel.py``.

Usage: python tests/_torch_parallel_worker.py <port> <rank> <world> <out.pkl>

It imports torch, numpy and swirl_torch only. It joins the world through
``swirl_torch.parallel.multihost.initialize`` (the coordinator on
127.0.0.1:<port>), runs every check of the test file in that one world
on inputs made from ``np.random.default_rng`` seeds (the case functions
below, which the parent calls too), and writes a pickle of host values
(numpy arrays, bytes, strings) for the parent, which holds them against
the one-device port and the JAX package.
"""

from __future__ import annotations

import pickle
import sys

import numpy as np

P = 0x78000001  # BabyBear

NTT_ROWS, NTT_LOG_H = 3, 8  # the all-to-all shape at 2 and 4 ranks (B % A == 0)
COMMIT_STEP = dict(width=4, log_rows=10, l_skip=2, log_blowup=1, k_whir=2, seed=7)
GKR_LEAVES = WHIR_LEAVES = 1 << 6
# the prover's sharded commit: stacked (3, 2^7), l_skip 2, log_blowup 1
COMMIT_ROWS, COMMIT_LOG_H, COMMIT_L_SKIP, COMMIT_LOG_BLOWUP = 3, 7, 2, 1
COMMIT_K_WHIR = (2, 3)
# Fibonacci proofs: tests/test_spmd.py:24-41 and tests/_distributed_worker.py
PROOFS = {"fib16": ((2, 3, 3), 16), "fib128": ((2, 5, 3), 128)}


def gather_log_h(world: int) -> int:
    """A gather-fallback length: B = 2^log_h / A below A (B % A != 0)."""
    return 2 * (world.bit_length() - 1) - 1


def field(seed: int, shape) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, P, shape, dtype=np.uint64)


def ntt_input(log_h: int) -> np.ndarray:
    return field(log_h, (NTT_ROWS, 1 << log_h))


def commit_step_input() -> np.ndarray:
    c = COMMIT_STEP
    return field(c["seed"], (c["width"], 1 << c["log_rows"]))


def gkr_input():
    rng = np.random.default_rng(11)
    return tuple(rng.integers(0, P, (GKR_LEAVES, 4), dtype=np.uint64) for _ in range(2))


def whir_input():
    rng = np.random.default_rng(13)
    f, w = (rng.integers(0, P, (WHIR_LEAVES, 4), dtype=np.uint64) for _ in range(2))
    return f, w, rng.integers(0, P, (4,), dtype=np.uint64)


def commit_input(ext: bool) -> np.ndarray:
    """The stacked matrix (base), or the zero-padded EF coefficients of a
    WHIR codeword commit, (2^(log_h + log_blowup), 4)."""
    if not ext:
        return field(17, (COMMIT_ROWS, 1 << COMMIT_LOG_H))
    padded = np.zeros((1 << (COMMIT_LOG_H + COMMIT_LOG_BLOWUP), 4), dtype=np.uint64)
    padded[: 1 << COMMIT_LOG_H] = field(19, (1 << COMMIT_LOG_H, 4))
    return padded


def fib_case(name: str):
    """(params, air, trace, public values) of a Fibonacci proof, port objects."""
    from swirl_torch.params import test_system_params_small
    from swirl_torch.testing.fixtures import FibonacciAir

    args, h = PROOFS[name]
    air = FibonacciAir()
    return test_system_params_small(*args), air, air.generate_trace(0, 1, h), air.pvs(0, 1, h)


def _t(a):
    import torch

    return torch.from_numpy(np.asarray(a, dtype=np.uint64).astype(np.int64))


def _np(t):
    return t.detach().cpu().numpy().astype(np.uint64)


def _shard(a, rank: int, world: int, axis: int):
    n = a.shape[axis] // world
    return np.take(a, np.arange(rank * n, (rank + 1) * n), axis=axis)


def _gathered(t, mesh, axis: int):
    """The shards of every rank, concatenated on ``axis`` (host copy)."""
    from swirl_torch.parallel import sharded

    return np.concatenate(list(_np(sharded.all_gather(t, mesh))), axis=axis)


def run_checks(rank: int, world: int) -> dict:
    import torch
    import torch.distributed as dist

    from swirl_torch.codec import encode_proof
    from swirl_torch.engine import StarkEngine
    from swirl_torch.parallel import annotate, multihost, sharded
    from swirl_torch.prover import fused
    from swirl_torch.prover.backend import ProvingContext
    from swirl_torch.prover.commit_kernel import commit_eager
    from swirl_torch.prover.merkle import build_merkle_tree
    from swirl_torch.prover.stacked_pcs import rs_encode
    from swirl_torch.testing.host_reads import HostReads

    out = {}
    multihost.initialize()  # the group exists: a no-op
    mesh = multihost.proof_mesh(device_type="cpu")
    local = multihost.host_local_mesh(2, device_type="cpu")
    hier = multihost.hierarchical_mesh(device_type="cpu")
    out["meshes"] = {
        "world": dist.get_world_size(), "rank": dist.get_rank(),
        "proof_mesh": (mesh.mesh_dim_names, mesh.size(), mesh.mesh.tolist()),
        "host_local": (local.mesh_dim_names, local.size(), local.mesh.tolist()),
        "hierarchical": (hier.mesh_dim_names, tuple(hier.mesh.shape)),
    }

    ntts = {}
    for tag, log_h in (("all_to_all", NTT_LOG_H), ("gather", gather_log_h(world))):
        x = _shard(ntt_input(log_h), rank, world, 1)
        ntts[tag] = _gathered(sharded.distributed_ntt(_t(x), mesh, log_h), mesh, 1)
    out["ntt"] = ntts

    c = COMMIT_STEP
    step = sharded.sharded_commit_step(mesh, c["l_skip"], c["log_blowup"], c["k_whir"])
    root, evals = step(_t(_shard(commit_step_input(), rank, world, 1)))
    out["commit_step"] = (_np(root), _np(evals))

    p, q = (_t(_shard(a, rank, world, 0)) for a in gkr_input())
    out["gkr"] = tuple(_np(v) for v in sharded.sharded_gkr_layer_step(mesh)(p, q))

    f, w, alpha = whir_input()
    f_fold, w_fold, evals = sharded.sharded_whir_fold_step(mesh)(
        _t(_shard(f, rank, world, 0)), _t(_shard(w, rank, world, 0)), _t(alpha))
    out["whir"] = (_gathered(f_fold, mesh, 0), _gathered(w_fold, mesh, 0), _np(evals))

    commits = {}
    for ext in (False, True):
        for k in COMMIT_K_WHIR:
            sharded.reset_collective_counts()
            with annotate.spmd_mesh(mesh):
                if ext:
                    code = rs_encode(_t(commit_input(True))[None], ext=True)
                    layers = build_merkle_tree(code, 1 << k, ext=True).layers
                else:
                    code, layers = commit_eager(COMMIT_L_SKIP, COMMIT_LOG_BLOWUP, k, _t(commit_input(False)))
            # the kernels on the card take contiguous operands only
            contiguous = code.is_contiguous() and all(layer.is_contiguous() for layer in layers)
            commits[(ext, k)] = (_np(code), [_np(layer) for layer in layers], sharded.collective_counts(), contiguous)
    out["commit"] = commits

    proofs, counts = {}, {}
    for name in PROOFS:
        params, air, trace, pvs = fib_case(name)
        eng = StarkEngine(params, device="cpu")
        pk, _ = eng.keygen([air])
        dpk = eng.transport_pk(pk)
        ctx = ProvingContext([eng.context_for(0, trace, pvs)])
        modes = ("segmented", "jit") if name == "fib16" and world == 2 else ("segmented",)
        for mode in modes:
            sharded.reset_collective_counts()
            with HostReads() as reads:
                proof = fused.prove_fused(eng.backend, dpk, ctx, mode=mode, mesh=mesh)
            proofs[(name, mode)] = encode_proof(proof)
            counts[(name, mode)] = dict(sharded.collective_counts(), host_reads=reads.reads["total"])
        if name == "fib16":
            try:
                fused.prove_fused(eng.backend, dpk, ctx, mode="eager", mesh=mesh)
            except ValueError as err:
                out["eager_refusal"] = str(err)
            sorted_ctx = ctx.sorted_for_stacking()
            with HostReads() as reads:  # the card computes the key at every prove
                key = fused.graph_key(eng.backend, sorted_ctx, "segmented", mesh)
            out["keys_differ"] = key != fused.graph_key(eng.backend, sorted_ctx, "segmented")
            out["key_reads"] = reads.reads["total"]
    out["proofs"], out["prove_collectives"] = proofs, counts
    return out


def main() -> int:
    port, rank, world, path = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
    import torch
    import torch.distributed as dist

    from swirl_torch.parallel import multihost

    torch.set_num_threads(1)
    multihost.initialize(f"127.0.0.1:{port}", world, rank, device_type="cpu")
    try:
        out = run_checks(rank, world)
    finally:
        dist.destroy_process_group()
    with open(path, "wb") as f:
        pickle.dump(out, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
