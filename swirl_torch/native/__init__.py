"""Native host library: build-on-first-use C++ kernels with ctypes bindings.
The copy of ``swirl/native`` for the port; the library is built with
``g++`` into the repository's ``build/`` directory, not beside the source.

Provides Poseidon2-BabyBear-16 batch permutation, sponge row hashing,
2-to-1 compression and PoW grinding for the *host* side (transcript,
verifier, keygen). Falls back transparently to the numpy implementations
when no C++ toolchain is available (``available()`` returns False).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "swirl_host.cpp")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_HERE)), "build")
_LOCK = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _build() -> Optional[str]:
    so_path = os.path.join(BUILD_DIR, "libswirl_host.so")
    if os.path.exists(so_path) and os.path.getmtime(so_path) >= os.path.getmtime(_SRC):
        return so_path
    try:
        os.makedirs(BUILD_DIR, exist_ok=True)
    except OSError:
        return None
    tmp = f"{so_path}.{os.getpid()}.tmp"  # processes may build at once
    for extra in (["-fopenmp"], []):
        cmd = [
            "g++", "-O3", "-march=native", "-shared", "-fPIC", "-std=c++17",
            *extra, _SRC, "-o", tmp,
        ]
        try:
            r = subprocess.run(cmd, capture_output=True, timeout=120)
            if r.returncode == 0:
                os.replace(tmp, so_path)
                return so_path
        except (OSError, subprocess.TimeoutExpired):
            return None
    return None


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _tried:
        return _lib
    with _LOCK:
        if _tried:
            return _lib
        _tried = True
        path = _build()
        if path is None:
            return None
        try:
            lib = ctypes.CDLL(path)
        except OSError:
            return None
        u64p = ctypes.POINTER(ctypes.c_uint64)
        lib.swirl_p2_set_constants.argtypes = [u64p, u64p, u64p, u64p,
                                               ctypes.c_int, ctypes.c_int]
        lib.swirl_p2_permute_batch.argtypes = [u64p, ctypes.c_int64]
        lib.swirl_p2_hash_rows.argtypes = [u64p, ctypes.c_int64,
                                           ctypes.c_int64, u64p]
        lib.swirl_p2_compress_rows.argtypes = [u64p, ctypes.c_int64, u64p]
        lib.swirl_p2_grind.argtypes = [u64p, ctypes.c_int, ctypes.c_int,
                                       ctypes.c_int]
        lib.swirl_p2_grind.restype = ctypes.c_int64
        # inject the Grain-LFSR round constants so numpy/native never drift
        from ..hash.poseidon2 import constants

        ext_init, internal, ext_final, diag = constants()
        n_half = ext_init.shape[0]
        n_partial = internal.shape[0]
        lib.swirl_p2_set_constants(
            _ptr(np.ascontiguousarray(ext_init, dtype=np.uint64)),
            _ptr(np.ascontiguousarray(internal, dtype=np.uint64)),
            _ptr(np.ascontiguousarray(ext_final, dtype=np.uint64)),
            _ptr(np.ascontiguousarray(diag, dtype=np.uint64)),
            n_half,
            n_partial,
        )
        _lib = lib
        return _lib


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64))


def available() -> bool:
    return _load() is not None


def permute_batch(states: np.ndarray) -> np.ndarray:
    """(..., 16) canonical uint64 -> same shape, permuted."""
    lib = _load()
    assert lib is not None
    buf = np.ascontiguousarray(states, dtype=np.uint64).copy()
    n = buf.size // 16
    lib.swirl_p2_permute_batch(_ptr(buf), n)
    return buf.reshape(states.shape)


def hash_rows(mat: np.ndarray) -> np.ndarray:
    """(n, w) canonical uint64 rows -> (n, 8) digests."""
    lib = _load()
    assert lib is not None
    mat = np.ascontiguousarray(mat, dtype=np.uint64)
    n, w = mat.shape
    out = np.empty((n, 8), dtype=np.uint64)
    lib.swirl_p2_hash_rows(_ptr(mat), n, w, _ptr(out))
    return out


def grind(state: np.ndarray, absorb_idx: int, sample_idx: int, bits: int) -> int:
    """Smallest PoW witness for the sponge snapshot, or -1."""
    lib = _load()
    assert lib is not None
    state = np.ascontiguousarray(state, dtype=np.uint64)
    return int(lib.swirl_p2_grind(_ptr(state), absorb_idx, sample_idx, bits))
