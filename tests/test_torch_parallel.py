"""The port's mesh path (``swirl_torch/parallel/``, ``prove_fused(...,
mesh=)``) on the CPU, in worlds of 2 and 4 gloo ranks.

Each world is spawned once for the module (``tests/_torch_parallel_worker.py``,
which imports swirl_torch only; its coordinator on a port taken by binding
port 0, so no two xdist workers share a rendezvous) and runs every check in
that one world. Here the ranks' results are held against:

- the multihost functions: peers of ``tests/test_multihost.py:14-43``;
- ``distributed_ntt`` on the all-to-all shape and on a gather-fallback
  shape: the port's ``ntt`` and ``swirl.prover.ntt.ntt``;
- the three sharded steps: the JAX package's steps on the 8-device CPU mesh
  of ``tests/conftest.py`` (their results do not depend on a power-of-two
  rank count): the commit step at ``tests/_distributed_worker.py``'s
  (4, 2^10), seed 7; the GKR layer at 2^6 EF leaves; the WHIR fold at 2^6;
- the prover's sharded commit at k_whir 2 and 3, base and EF: the one-device
  codeword and digest layers (root included);
- ``prove_fused(mode="segmented", mesh=...)`` on the 16-row Fibonacci of
  ``tests/test_spmd.py:24-41`` and the 2^7-row one of
  ``tests/_distributed_worker.py``: every rank's bytes equal the port's
  one-device ``Coordinator.prove`` and the JAX package's ``eng.prove``
  (``tests/golden/mesh_fib*.proof.bin``, made by it: ``JAX_PLATFORMS=cpu
  PYTHONPATH=. python tests/test_torch_parallel.py`` writes them again, and
  the ``slow`` test ``test_mesh_golden_jax_bytes`` compares, since its two
  proves cost about 50 s of the JAX engine's compiles), and
  ``swirl.verifier`` accepts them; ``mode="jit"`` once, at 2 ranks;
- refusals: a mesh with ``mode="eager"``; a graph key with a mesh is not
  the key without one.

Inputs come from ``np.random.default_rng`` seeds. Tolerance: exact
equality (field arithmetic, proof bytes).
"""

import os
import pickle
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

jax.config.update("jax_platforms", "cpu")

import _torch_parallel_worker as W  # noqa: E402
from swirl_torch.fields import field as F  # noqa: E402

WORLDS = (2, 4)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN_DIR = os.path.join(REPO, "tests", "golden")
TIMEOUT_S = 300


def _golden_path(name: str) -> str:
    return os.path.join(GOLDEN_DIR, f"mesh_{name}.proof.bin")


def _spawn(world: int, out_dir):
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=REPO)
    paths = [str(out_dir / f"world{world}_rank{r}.pkl") for r in range(world)]
    worker = os.path.join(REPO, "tests", "_torch_parallel_worker.py")
    procs = [
        subprocess.Popen([sys.executable, worker, str(port), str(r), str(world), paths[r]],
                         env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        for r in range(world)
    ]
    return procs, paths


def _jax_references() -> dict:
    """The JAX package's NTTs and sharded steps on the worker's inputs."""
    from swirl.fields import jfield as jf
    from swirl.parallel.sharded import make_mesh, sharded_commit_step, sharded_gkr_layer_step, sharded_whir_fold_step
    from swirl.prover.ntt import ntt as jntt

    def port(x):
        return F.from_jax(np.asarray(x)).numpy().astype(np.uint64)

    mesh = make_mesh(jax.devices()[:8])
    ref = {"ntt": {}}
    for log_h in {W.NTT_LOG_H} | {W.gather_log_h(w) for w in WORLDS}:
        ref["ntt"][log_h] = port(jntt(jf.const_arr(W.ntt_input(log_h))))
    c = W.COMMIT_STEP
    root, evals = sharded_commit_step(mesh, c["l_skip"], c["log_blowup"], c["k_whir"])(
        jf.const_arr(W.commit_step_input()))
    ref["commit_step"] = (port(root), port(evals))
    ref["gkr"] = tuple(port(v) for v in sharded_gkr_layer_step(mesh)(*(jf.const_arr(a) for a in W.gkr_input())))
    ref["whir"] = tuple(port(v) for v in sharded_whir_fold_step(mesh)(*(jf.const_arr(a) for a in W.whir_input())))
    return ref


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{"ranks": {world: [each rank's results]}, "jax": the JAX references}:
    both worlds spawned at once, the JAX steps computed while they run."""
    out_dir = tmp_path_factory.mktemp("mesh")
    spawned = {w: _spawn(w, out_dir) for w in WORLDS}
    try:
        ref = _jax_references()
        ranks = {}
        for w, (procs, paths) in spawned.items():
            for p in procs:
                _, err = p.communicate(timeout=TIMEOUT_S)
                assert p.returncode == 0, err.decode(errors="replace")[-3000:]
            ranks[w] = []
            for path in paths:
                with open(path, "rb") as f:
                    ranks[w].append(pickle.load(f))
    finally:
        for procs, _ in spawned.values():
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    return {"ranks": ranks, "jax": ref}


def _t(a):
    return torch.from_numpy(np.asarray(a, dtype=np.uint64).astype(np.int64))


def _np(t):
    return t.numpy().astype(np.uint64)


def test_initialize_single_process_is_a_noop():
    import torch.distributed as dist

    from swirl_torch.parallel import multihost

    env = {k: os.environ.pop(k) for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK") if k in os.environ}
    try:
        multihost.initialize(device_type="cpu")
        multihost.initialize(device_type="cpu")  # idempotent
        assert not dist.is_initialized()
    finally:
        os.environ.update(env)


@pytest.mark.parametrize("world", WORLDS)
def test_meshes(runs, world):
    """``proof_mesh`` covers the world on one axis, ``host_local_mesh(2)``
    is this host's first two ranks, ``hierarchical_mesh`` is (1 host,
    world ranks)."""
    for rank, res in enumerate(runs["ranks"][world]):
        m = res["meshes"]
        assert (m["world"], m["rank"]) == (world, rank)
        assert m["proof_mesh"] == (("rows",), world, list(range(world)))
        assert m["host_local"] == (("rows",), 2, [0, 1])
        assert m["hierarchical"] == (("host", "chip"), (1, world))


@pytest.mark.parametrize("tag", ["all_to_all", "gather"])
@pytest.mark.parametrize("world", WORLDS)
def test_distributed_ntt(runs, world, tag):
    """The shards gathered equal the port's one-device ``ntt`` and the JAX
    package's, on every rank."""
    from swirl_torch.prover.ntt import ntt

    log_h = W.NTT_LOG_H if tag == "all_to_all" else W.gather_log_h(world)
    b = (1 << log_h) // world
    assert (b % world == 0) == (tag == "all_to_all")
    want = _np(ntt(_t(W.ntt_input(log_h))))
    assert np.array_equal(want, runs["jax"]["ntt"][log_h])
    for res in runs["ranks"][world]:
        assert np.array_equal(res["ntt"][tag], want)


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_commit_step(runs, world):
    root, evals = runs["jax"]["commit_step"]
    for res in runs["ranks"][world]:
        assert np.array_equal(res["commit_step"][0], root)
        assert np.array_equal(res["commit_step"][1], evals)


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_gkr_layer_step(runs, world):
    for res in runs["ranks"][world]:
        for got, want in zip(res["gkr"], runs["jax"]["gkr"]):
            assert np.array_equal(got, want)


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_whir_fold_step(runs, world):
    for res in runs["ranks"][world]:
        for got, want in zip(res["whir"], runs["jax"]["whir"]):
            assert np.array_equal(got, want)


@pytest.mark.parametrize("k_whir", W.COMMIT_K_WHIR)
@pytest.mark.parametrize("ext", [False, True], ids=["base", "ef"])
@pytest.mark.parametrize("world", WORLDS)
def test_prover_sharded_commit(runs, world, ext, k_whir):
    """The codeword and every digest layer (the root among them) gathered
    whole on every rank equal the one-device commit's (``commit_eager``;
    for EF, WHIR's ``rs_encode`` + ``build_merkle_tree(ext=True)``), are
    contiguous, and came after three all-to-alls and two all-gathers
    (codeword, layers)."""
    from swirl_torch.prover.commit_kernel import commit_eager
    from swirl_torch.prover.merkle import build_merkle_tree
    from swirl_torch.prover.stacked_pcs import rs_encode

    if ext:
        code = rs_encode(_t(W.commit_input(True))[None], ext=True)
        layers = build_merkle_tree(code, 1 << k_whir, ext=True).layers
    else:
        code, layers = commit_eager(W.COMMIT_L_SKIP, W.COMMIT_LOG_BLOWUP, k_whir, _t(W.commit_input(False)))
    for res in runs["ranks"][world]:
        got_code, got_layers, counts, contiguous = res["commit"][(ext, k_whir)]
        assert contiguous  # as the kernels on the card take them
        assert np.array_equal(got_code, _np(code))
        assert len(got_layers) == len(layers)
        assert all(np.array_equal(g, _np(w)) for g, w in zip(got_layers, layers))
        assert counts == {"all_to_all": 3, "all_gather": 2, "ppermute": 0}


def _one_device_bytes(name: str):
    """(the port's one-device Coordinator bytes, the port's vk)."""
    from swirl_torch.codec import encode_proof
    from swirl_torch.engine import StarkEngine
    from swirl_torch.prover.backend import ProvingContext

    params, air, trace, pvs = W.fib_case(name)
    eng = StarkEngine(params, device="cpu")
    pk, vk = eng.keygen([air])
    ctx = ProvingContext([eng.context_for(0, trace, pvs)])
    return encode_proof(eng.prove(eng.transport_pk(pk), ctx)), vk


@pytest.mark.parametrize("name", list(W.PROOFS))
@pytest.mark.parametrize("world", WORLDS)
def test_prove_fused_on_a_mesh(runs, world, name):
    """Every rank's segmented proof is the one-device Coordinator's bytes
    and the JAX package's ``eng.prove`` bytes; ``swirl.verifier`` accepts
    them; the commits went through the mesh's collectives; one host read
    a prove (the fetch), as without a mesh."""
    from swirl.codec import decode_proof, decode_vk
    from swirl.verifier import verify
    from swirl_torch.codec import encode_vk

    want, vk = _one_device_bytes(name)
    with open(_golden_path(name), "rb") as f:
        assert f.read() == want
    for res in runs["ranks"][world]:
        assert res["proofs"][(name, "segmented")] == want
        counts = res["prove_collectives"][(name, "segmented")]
        assert counts["all_gather"] >= 2 and counts["ppermute"] == 0
        assert counts["host_reads"] == 1  # the fetch: the mesh reads nothing from the device
    jvk = decode_vk(encode_vk(vk))
    verify(jvk.params, jvk, decode_proof(want))


def test_prove_fused_jit_on_a_mesh(runs):
    want, _ = _one_device_bytes("fib16")
    for res in runs["ranks"][2]:
        assert res["proofs"][("fib16", "jit")] == want


@pytest.mark.parametrize("world", WORLDS)
def test_mesh_refusals_and_key(runs, world):
    for res in runs["ranks"][world]:
        assert res["eager_refusal"] == "mesh sharding requires mode='jit' or 'segmented'"
        assert res["keys_differ"] and res["key_reads"] == 0


def build_jax_golden() -> dict:
    """name -> the JAX package's ``eng.prove`` bytes of each Fibonacci case."""
    from swirl.codec import encode_proof
    from swirl.engine import StarkEngine
    from swirl.params import test_system_params_small
    from swirl.prover.backend import ProvingContext
    from swirl.testing.fixtures import FibonacciAir

    out = {}
    for name, (args, h) in W.PROOFS.items():
        eng = StarkEngine(test_system_params_small(*args))
        air = FibonacciAir()
        pk, _ = eng.keygen([air])
        ctx = ProvingContext([eng.context_for(0, air.generate_trace(0, 1, h), air.pvs(0, 1, h))])
        out[name] = encode_proof(eng.prove(eng.transport_pk(pk), ctx))
    return out


@pytest.mark.slow
def test_mesh_golden_jax_bytes():
    for name, proof in build_jax_golden().items():
        with open(_golden_path(name), "rb") as f:
            assert f.read() == proof


if __name__ == "__main__":
    for name, proof in build_jax_golden().items():
        with open(_golden_path(name), "wb") as f:
            f.write(proof)
        print(f"golden mesh_{name}: proof {len(proof)} B")
