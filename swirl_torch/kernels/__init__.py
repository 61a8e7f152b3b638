"""The port's hand-written CUDA kernels: build, load, launch bookkeeping.

Peer of ``swirl/tpu/__init__.py``. The sources under ``swirl_torch/csrc/``
are compiled once per process by ``nvcc`` for ``sm_90a`` into one shared
library with a plain C interface under ``build/`` (named by a hash of the
sources, so a stale build is never loaded) and bound with ``ctypes``.
Nothing is built at import time: the first launch on a CUDA tensor builds.

Every kernel wrapper takes the kernel on a CUDA tensor and its plain
PyTorch version on a CPU tensor; there is no switch and no fallback on the
card. Each wrapper counts its launches in a :class:`Kernel` below. A
kernel that hands its work between blocks or launches takes its counters
from :func:`tickets`, a capture's own inside :func:`private_tickets`.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
from contextlib import contextmanager
from typing import NamedTuple

import numpy as np
import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


class Kernel:
    """Launch counter of one kernel family; its wrapper adds one per launch."""

    def __init__(self, name: str, source: str, replaces: str):
        self.name = name
        self.source = source
        self.replaces = replaces
        self.launches = 0


NTT = Kernel(
    "ntt", "swirl_torch/csrc/ntt.cu",
    "swirl/tpu/ntt_pallas.py:164 (_kernel1 :147 + _kernel2 :156)",
)
# the same entry point above 2^26, where it runs A′'s 2^14-point rows
NTT_RECURSIVE = Kernel(
    "ntt_recursive", "swirl_torch/csrc/ntt.cu",
    "swirl/tpu/ntt_pallas.py:249 (_kernel1_only) via ntt :300-312",
)
HASH_COLS = Kernel(
    "hash_cols", "swirl_torch/csrc/poseidon2.cu",
    "swirl/tpu/poseidon2_pallas.py:143 (_hash_kernel)",
)
COMPRESS = Kernel(
    "compress_cols", "swirl_torch/csrc/poseidon2.cu",
    "swirl/tpu/poseidon2_pallas.py:259 (_compress_kernel)",
)
TOWER = Kernel(
    "merkle_tower", "swirl_torch/csrc/poseidon2.cu",
    "swirl/tpu/poseidon2_pallas.py:327 (_tower_kernel)",
)
# the port's own kernels: the JAX package runs its device transcript as
# jitted permutations, with no Pallas kernel
DUPLEX = Kernel(
    "duplex", "swirl_torch/csrc/poseidon2.cu",
    "none: swirl/prover/device_transcript.py:134 (DeviceTranscript, jitted permutations)",
)
GRIND = Kernel(
    "grind", "swirl_torch/csrc/poseidon2.cu",
    "none: swirl/prover/device_transcript.py:290 (grind, a jitted while loop)",
)
# the BN254 outer scheme's kernels: the JAX package runs its BN254 device
# library (swirl/fields/jbn254.py, swirl/hash/jbn254_poseidon2.py) under XLA,
# with no Pallas kernel
BN254_FIELD = Kernel(
    "bn254_field", "swirl_torch/csrc/bn254.cu",
    "none: swirl/fields/jbn254.py:110-179 (add, sub, mont_mul, from/to_canonical, dbl; XLA)",
)
BN254_MERKLE = Kernel(
    "bn254_merkle", "swirl_torch/csrc/bn254.cu",
    "none: swirl/hash/jbn254_poseidon2.py:74 (permute_dev), :97 (compress2_dev), :168 (merkle_layers_dev)",
)
BN254_LEAVES = Kernel(
    "bn254_hash_rows", "swirl_torch/csrc/bn254.cu",
    "none: swirl/hash/jbn254_poseidon2.py:104 (pack_felts_dev) + :137 (hash_rows_dev)",
)
BN254_GRIND = Kernel(
    "bn254_grind", "swirl_torch/csrc/bn254.cu",
    "none: swirl/hash/multi_field.py:210 (MultiFieldTranscript.grind, a host loop)",
)
# the port's own: the JAX package runs a GKR sub-round as XLA ops
GKR_ROUND = Kernel(
    "gkr_round", "swirl_torch/csrc/gkr.cu",
    "none: swirl/prover/gkr.py:58 (_gkr_round_evals) + :82 (_gkr_fold), XLA ops",
)
# the port's own: the JAX package runs EF4 products and sums as XLA ops
EF4 = Kernel(
    "ef4", "swirl_torch/csrc/ef4.cu",
    "none: swirl/fields/jfield.py:256 (ext_mul) and :311 (ext_sum), XLA ops",
)
KERNELS = (NTT, NTT_RECURSIVE, HASH_COLS, COMPRESS, TOWER, DUPLEX, GRIND,
           BN254_FIELD, BN254_MERKLE, BN254_LEAVES, BN254_GRIND, GKR_ROUND, EF4)


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0


def launch_counts() -> dict:
    return {k.name: k.launches for k in KERNELS}


def ptxas_summary(log: str) -> list:
    """``name: registers ..., spills ...`` for each entry function in the
    output of ``nvcc -Xptxas -v``."""
    out, name = [], "?"
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif "registers" in line or "spill" in line:
            out.append(f"{name}: {line.split(':', 1)[-1].strip()}")
    return out


class KernelError(RuntimeError):
    """A kernel failed to build, was refused at launch, or faulted."""


class _Library:
    def __init__(self):
        self._lock = threading.Lock()
        self._lib = None
        self._constants_on = set()  # device indices holding the Poseidon2 constants
        self.path = None
        self.build_log = ""

    def _sources(self):
        return sorted(glob.glob(os.path.join(CSRC, "*.cu"))) + sorted(
            glob.glob(os.path.join(CSRC, "*.cuh"))
        )

    def build(self) -> str:
        """Compile each ``.cu`` to an object with its own ``nvcc``, all
        started together, then link them into one library."""
        srcs = self._sources()
        h = hashlib.sha256()
        for s in srcs:
            with open(s, "rb") as f:
                h.update(os.path.basename(s).encode() + b"\0" + f.read())
        h.update(" ".join(NVCC_FLAGS).encode())
        out = os.path.join(BUILD_DIR, f"libswirl_kernels-{h.hexdigest()[:16]}.so")
        if os.path.exists(out):
            return out
        nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
        if not os.path.exists(nvcc):
            raise KernelError("nvcc not found: the CUDA toolkit is required")
        os.makedirs(BUILD_DIR, exist_ok=True)
        tag = f"{h.hexdigest()[:16]}.{os.getpid()}"
        cus = [s for s in srcs if s.endswith(".cu")]
        objs = [os.path.join(BUILD_DIR, f"{os.path.basename(s)}.{tag}.o") for s in cus]
        compile_flags = [f for f in NVCC_FLAGS if f != "-shared"]
        procs = [
            subprocess.Popen([nvcc, *compile_flags, "-c", "-o", o, s],
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for s, o in zip(cus, objs)
        ]
        logs, failed = [], []
        try:
            for s, p in zip(cus, procs):
                log = p.communicate(timeout=900)[0]
                logs.append(f"== {os.path.basename(s)}\n{log}")
                if p.returncode != 0:
                    failed.append(os.path.basename(s))
        finally:
            for p in procs:  # none outlives a failed wait
                if p.poll() is None:
                    p.kill()
                    p.wait()
        tmp = f"{out}.{os.getpid()}.tmp"
        if not failed:
            r = subprocess.run([nvcc, *NVCC_FLAGS[:2], "-shared", "-o", tmp, *objs],  # the target, then link
                               capture_output=True, text=True, timeout=600)
            logs.append(r.stdout + r.stderr)
            if r.returncode != 0:
                failed.append("link")
        for o in objs:
            if os.path.exists(o):
                os.remove(o)
        self.build_log = "\n".join(logs)
        if failed:
            raise KernelError(f"nvcc failed ({', '.join(failed)}):\n{self.build_log}")
        os.replace(tmp, out)
        return out

    def get(self):
        if self._lib is not None:
            return self._lib
        with self._lock:
            if self._lib is None:
                self.path = self.build()
                lib = ctypes.CDLL(self.path)
                vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
                sigs = {
                    "swirl_ntt": [vp, vp, vp, i64, i32, vp, vp],
                    "swirl_p2_set_constants": [vp, vp, vp, vp],
                    "swirl_p2_hash_cols": [vp, vp, i32, i64, i32, vp],
                    "swirl_p2_compress": [vp, vp, i64, i64, i32, i64, vp],
                    "swirl_p2_tower": [vp, vp, i32, vp, vp],
                    "swirl_p2_duplex": [vp, vp, i64, vp, i32, i32, i32, i32, i32, vp, vp],
                    "swirl_p2_grind": [vp, i32, i32, vp, vp, vp],
                    "swirl_bn254_set_constants": [vp, vp],
                    "swirl_bn254_op": [i32, vp, vp, vp, i64, vp],
                    "swirl_bn254_permute": [vp, vp, i64, i32, vp],
                    "swirl_bn254_compress": [vp, vp, i64, i32, vp],
                    "swirl_bn254_hash_rows": [vp, vp, i32, i64, i32, vp],
                    "swirl_bn254_grind": [vp, vp, vp],
                    "swirl_gkr_eq": [vp, i32, vp, i32, vp],
                    "swirl_gkr_round": [vp, vp, vp, vp, vp, i64, i64, vp, vp, vp, vp, vp, vp, i32, vp],
                    "swirl_ef4_mul": [vp, vp, vp, i64, vp, i32, vp],
                    "swirl_ef4_mul_sum": [vp, i64, vp, vp, i32, i64, i32, i32, i32, vp, vp, vp, vp],
                }
                for name, args in sigs.items():
                    fn = getattr(lib, name)
                    fn.argtypes = args
                    fn.restype = i32
                lib.swirl_cuda_error_string.argtypes = [i32]
                lib.swirl_cuda_error_string.restype = ctypes.c_char_p
                lib.swirl_graph_nodes.argtypes = [vp, ctypes.POINTER(ctypes.c_ulonglong)]
                lib.swirl_graph_nodes.restype = i32
                self._lib = lib
        return self._lib

    def launch(self, kernel: Kernel, fn_name: str, t: torch.Tensor, *args) -> None:
        """Call ``fn_name(*args, stream)`` on ``t``'s device and stream, raise
        on the returned CUDA error, and count one launch of ``kernel``."""
        lib = self.get()
        with torch.cuda.device(t.device):
            if t.device.index not in self._constants_on:
                # __constant__ memory is per device
                _upload_poseidon2_constants(lib)
                _upload_bn254_constants(lib)
                self._constants_on.add(t.device.index)
            check(getattr(lib, fn_name)(*args, torch.cuda.current_stream().cuda_stream))
        kernel.launches += 1


LIB = _Library()


def check(rc: int) -> None:
    """Raise on a non-zero cudaError_t returned after a launch."""
    if rc != 0:
        msg = LIB.get().swirl_cuda_error_string(rc).decode()
        raise KernelError(f"CUDA error {rc}: {msg}")


def graph_nodes(graph: "torch.cuda.CUDAGraph") -> int:
    """The nodes of a captured ``CUDAGraph`` made with ``keep_graph=True``
    (``cudaGraphGetNodes``)."""
    n = ctypes.c_ulonglong()
    check(LIB.get().swirl_graph_nodes(graph.raw_cuda_graph(), ctypes.byref(n)))
    return n.value


def require(t: torch.Tensor, ndim, what: str, dtype=torch.int64) -> None:
    """Validate a kernel operand: CUDA, ``dtype``, contiguous, ``ndim`` dims
    (an int or a tuple of the dims allowed)."""
    dims = ndim if isinstance(ndim, tuple) else (ndim,)
    if not t.is_cuda or t.dtype != dtype or not t.is_contiguous() or t.dim() not in dims:
        raise KernelError(
            f"{what}: expected a contiguous {ndim}-d {dtype} CUDA tensor, got "
            f"{t.dtype} {tuple(t.shape)} on {t.device} "
            f"(contiguous={t.is_contiguous()})"
        )


# the counters of each (device index, stream): the tower's ticket, the
# grind's (found word, ticket) pair, the GKR pass's ticket and the EF4
# product-and-sum's as :class:`Tickets`, zero (the found word all ones)
# between launches, views of one allocation (:func:`_counters`). torch hands
# out pooled streams round robin, so a stream's handle recurs; a capture
# takes its own (private_tickets) instead.
_TICKETS = {}
_PRIVATE = threading.local()


class Tickets(NamedTuple):
    """One stream's or capture's counters: kernel D's ticket (int32) and
    kernel F's (found word, ticket) pair (int64, ``hash/poseidon2.py``),
    kernel K's ticket (int32, ``prover/gkr.py``) and kernel L's (int32,
    ``fields/ef4.py``)."""

    tower: torch.Tensor
    grind: torch.Tensor
    gkr: torch.Tensor
    ef4: torch.Tensor


def _counters(device) -> Tickets:
    """One int64 quintuple (F's found word, all ones; F's ticket; D's, K's
    and L's tickets, each the int32 low half of its word), as its four
    views."""
    t = torch.tensor([-1, 0, 0, 0, 0], dtype=torch.int64, device=device)
    low = lambda i: t[i : i + 1].view(torch.int32)[:1]  # noqa: E731
    return Tickets(low(2), t[:2], low(3), low(4))


@contextmanager
def private_tickets(device):
    """Kernel D's, F's, K's and L's launches on ``device`` from this thread
    inside it use counters made here (armed) and yielded, as :class:`Tickets`, for the
    caller to keep: the graphs captured inside it read them at every replay,
    and no other launch shares them."""
    own = _counters(device)
    prev = getattr(_PRIVATE, "own", None)
    _PRIVATE.own = own
    try:
        yield own
    finally:
        _PRIVATE.own = prev


def tickets(device) -> Tickets:
    """The counters of the capture inside :func:`private_tickets`, else of
    ``device``'s current stream (made at its first call, outside a capture)."""
    own = getattr(_PRIVATE, "own", None)
    if own is not None and own.tower.device == device:
        return own
    key = (device.index, torch.cuda.current_stream(device).cuda_stream)
    if key not in _TICKETS:
        if torch.cuda.is_current_stream_capturing():  # a captured fill runs only at replay
            raise KernelError("compress_tower, grind, gkr_round, ef4_mul_sum: call one on this stream "
                              "before capturing it")
        _TICKETS[key] = _counters(device)
    return _TICKETS[key]


def _upload_poseidon2_constants(lib) -> None:
    from ..fields.babybear import P
    from ..hash.poseidon2 import constants

    r = np.uint64((1 << 32) % P)
    mont = [
        np.ascontiguousarray((np.asarray(c, np.uint64) * r) % np.uint64(P), dtype=np.uint32)
        for c in constants()  # ext_init, internal, ext_final, diagonal
    ]
    rc = lib.swirl_p2_set_constants(*[m.ctypes.data for m in mont])
    if rc != 0:
        raise KernelError(f"poseidon2 constant upload failed: CUDA error {rc}")


def _upload_bn254_constants(lib) -> None:
    """The BN254 Poseidon2 round constants of widths 3 and 2 in the kernels'
    form (c 2^260 mod P, 5 uint64 limbs of 2^52), each flat in the order
    external initial, internal, external final."""
    from ..hash.bn254_poseidon2 import f64_constant_words

    flat = [f64_constant_words(t) for t in (3, 2)]
    rc = lib.swirl_bn254_set_constants(*[f.ctypes.data for f in flat])
    if rc != 0:
        raise KernelError(f"bn254 constant upload failed: CUDA error {rc}")
