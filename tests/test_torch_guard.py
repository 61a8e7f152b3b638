"""Guards of the torch port (swirl_torch): neither jax nor the JAX package
(swirl) on its import path, the chip smoke test refuses to run without a
card, the engine targets the card unless told otherwise, and CPU tensors
never reach a kernel."""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

BLOCK_JAX = """
import importlib.abc, sys

class _BlockJax(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name in ("jax", "swirl") or name.startswith(("jax.", "jaxlib", "swirl.")):
            raise ImportError("blocked: " + name)
        return None

sys.meta_path.insert(0, _BlockJax())
"""


# the verifier, the pre-prove checks, the models, the DAG interpreter, the
# device transcript, the memory model, the soundness calculator, the BN254
# outer scheme's modules (its field among them), the monomial engine, the
# plain sumchecks, the commit graph, the roofline, the generic fields,
# the host protocol tools, the fused prover and the mesh path, which the
# walk must reach
NEW_MODULES = {f"swirl_torch.verifier.{m}" for m in (
    "errors", "proof_shape", "gkr", "stacked_reduction", "whir", "batch_constraints",
    "transcript_extractor")} | {
    "swirl_torch.verifier", "swirl_torch.debug", "swirl_torch.sanitize", "swirl_torch.testing.pipeline",
    "swirl_torch.models", "swirl_torch.models.keccak", "swirl_torch.prover.dag_vectorized",
    "swirl_torch.prover.device_transcript", "swirl_torch.memory_metering", "swirl_torch.soundness"} | {
    f"swirl_torch.hash.{m}" for m in (
        "bn254_constants", "grain", "bn254_rc3", "bn254_poseidon2", "multi_field", "scheme")} | {
    "swirl_torch.fields.bn254"} | {
    "swirl_torch.prover.monomial", "swirl_torch.prover.plain_sumcheck", "swirl_torch.prover.commit_kernel",
    "swirl_torch.roofline", "swirl_torch.fields.generic", "swirl_torch.lean_extraction",
    "swirl_torch.transcript", "swirl_torch.testing.golden"} | {
    "swirl_torch.prover.fused", "swirl_torch.prover.deferred"} | {
    f"swirl_torch.parallel.{m}" for m in ("multihost", "annotate", "sharded")}


def _is_blocked(module: str) -> bool:
    return module in ("jax", "swirl") or module.startswith(("jax.", "jaxlib", "swirl."))


def _run(code_or_args, cwd=REPO, **kw):
    args = code_or_args if isinstance(code_or_args, list) else [sys.executable, "-c", code_or_args]
    env = dict(os.environ, PYTHONPATH=cwd)
    return subprocess.run(args, cwd=cwd, env=env, capture_output=True, text=True, timeout=300, **kw)


def test_port_imports_with_jax_blocked():
    """Every module of the port, and chip_smoke, imports with jax and every
    swirl / swirl.* name refused (swirl_torch itself must stay allowed)."""
    assert not _is_blocked("swirl_torch") and not _is_blocked("swirl_torch.engine")
    assert _is_blocked("swirl") and _is_blocked("swirl.codec") and _is_blocked("jax.numpy")
    code = BLOCK_JAX + (
        "import importlib, pkgutil, swirl_torch\n"
        "for m in pkgutil.walk_packages(swirl_torch.__path__, 'swirl_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m in ('jax', 'swirl') or m.startswith(('jax.', 'swirl.'))]\n"
        "assert not bad, bad\n"
        "walked = {m for m in sys.modules if m.startswith('swirl_torch')}\n"
        f"missing = {sorted(NEW_MODULES)!r}\n"
        "assert not [m for m in missing if m not in walked], walked\n"
        "print('imported', sum(m.startswith('swirl_torch') for m in sys.modules))"
    )
    r = _run(code)
    assert r.returncode == 0 and "imported" in r.stdout, r.stderr
    assert int(r.stdout.split()[-1]) >= 30  # every module was reached


def _imports_in(path):
    with open(path) as f:
        for line in f:
            words = line.split()
            if words[:1] in (["import"], ["from"]) and len(words) > 1:
                yield words[1].rstrip(","), line.strip()


def test_port_sources_never_import_jax():
    """No source of the port, nor chip_smoke.py, names jax or swirl in an
    import statement: ``import swirl``, ``from swirl.x``, ``from swirl
    import``, ``import jax``, ``from jax...``."""
    paths = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(os.path.join(REPO, "swirl_torch")):
        paths += [os.path.join(root, f) for f in files if f.endswith(".py")]
    assert len(paths) > 30
    for path in paths:
        for module, line in _imports_in(path):
            assert not _is_blocked(module), f"{path}: {line}"


def test_chip_smoke_fails_without_a_card():
    r = _run([sys.executable, "chip_smoke.py"])
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


def test_chip_smoke_alone_fails(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path / "chip_smoke.py")
    r = _run([sys.executable, "chip_smoke.py"], cwd=str(tmp_path))
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


def test_engine_targets_the_card_by_default():
    """With no device, StarkEngine and TorchBackend target CUDA: on a box
    without a card they raise instead of proving on the CPU."""
    from swirl_torch.engine import StarkEngine
    from swirl_torch.params import test_system_params_small
    from swirl_torch.prover.backend import TorchBackend
    from swirl_torch.prover.errors import ProverError

    params = test_system_params_small(2, 6, 3)
    if torch.cuda.is_available():
        assert StarkEngine(params).device.type == "cuda"
        assert TorchBackend(params).device.type == "cuda"
    else:
        with pytest.raises(ProverError, match="no CUDA device"):
            StarkEngine(params)
        with pytest.raises(ProverError, match="no CUDA device"):
            TorchBackend(params)
    assert StarkEngine(params, device="cpu").device.type == "cpu"


def test_ntt_refuses_lengths_without_a_root():
    """BabyBear's two-adicity is 27: no 2^28-point transform exists, so the
    wrapper refuses it before touching data (a meta tensor holds none)."""
    from swirl_torch.prover import ntt

    assert ntt.MAX_LOG_N == 27
    with pytest.raises(ValueError, match="2\\^27"):
        ntt.ntt_rows(torch.empty(1, 1 << 28, dtype=torch.int64, device="meta"))


def test_cpu_tensors_leave_every_launch_count_at_zero():
    from swirl_torch import kernels as K
    from swirl_torch.hash import poseidon2 as p2
    from swirl_torch.prover import ntt

    K.reset_launch_counts()
    x = torch.from_numpy(np.arange(16 * 32, dtype=np.int64).reshape(16, 32))
    ntt.ntt(x)
    ntt.intt(x)
    p2.hash_cols(x)
    p2.compress_cols(x)
    p2.merkle_tower(x[:8].contiguous())
    # a CUDA transform above 2^26 counts as A′ (ntt_recursive), below as A
    assert ntt.kernel_for(ntt.RECURSIVE_LOG_N + 1) is K.NTT_RECURSIVE
    assert ntt.kernel_for(ntt.RECURSIVE_LOG_N) is K.NTT
    assert K.launch_counts() == {k.name: 0 for k in K.KERNELS}
    assert "ntt_recursive" in K.launch_counts()
