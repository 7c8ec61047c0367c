"""Native (C++) runtime tier: compile-on-demand ctypes bindings.

The reference's build-side parallelism is Go goroutines + atomics
(pkg/accelerator/bvh.go:454-483); here the scene-load hot path (BVH
construction) is a multithreaded C++ library compiled once per machine and
loaded via ctypes.  Device-side compute stays JAX/Pallas — this tier covers
the host runtime around it, like the reference's native (Go) runtime around
its render kernel.

Falls back cleanly to the NumPy builder when no C++ toolchain is present.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sysconfig
import threading
from pathlib import Path
from typing import Optional

import numpy as np

_SRC_DIR = Path(__file__).resolve().parent
_BUILD_DIR = _SRC_DIR / "_build"
_LIB_BASENAME = "libgopbrt_native"

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_lib_failed = False


def _so_path() -> Path:
    suffix = sysconfig.get_config_var("EXT_SUFFIX") or ".so"
    # one lib per source hash so edits trigger rebuilds; built with
    # portable flags (no -march=native), so a library left in a checkout
    # that moves to another host still loads there
    import hashlib

    src = (_SRC_DIR / "bvh_builder.cpp").read_bytes()
    h = hashlib.sha256(src).hexdigest()[:16]
    return _BUILD_DIR / f"{_LIB_BASENAME}-{h}{suffix}"


def _compile(so: Path) -> None:
    _BUILD_DIR.mkdir(exist_ok=True)
    cmd = [
        os.environ.get("CXX", "g++"),
        "-O3",
        "-std=c++17",
        "-shared",
        "-fPIC",
        "-pthread",
        str(_SRC_DIR / "bvh_builder.cpp"),
        "-o",
        str(so),
    ]
    subprocess.run(cmd, check=True, capture_output=True, text=True)


def load() -> Optional[ctypes.CDLL]:
    """Load (compiling if needed) the native library; None if unavailable."""
    global _lib, _lib_failed
    if _lib is not None or _lib_failed:
        return _lib
    with _lock:
        if _lib is not None or _lib_failed:
            return _lib
        try:
            so = _so_path()
            if not so.exists():
                _compile(so)
            lib = ctypes.CDLL(str(so))
            lib.gopbrt_bvh_build.restype = ctypes.c_int64
            lib.gopbrt_bvh_build.argtypes = [
                ctypes.POINTER(ctypes.c_float),  # lo
                ctypes.POINTER(ctypes.c_float),  # hi
                ctypes.c_int64,  # n
                ctypes.c_int32,  # max_leaf
                ctypes.c_int32,  # n_buckets
                ctypes.c_int32,  # n_threads
                ctypes.c_int32,  # method
                ctypes.POINTER(ctypes.c_float),  # node_lo
                ctypes.POINTER(ctypes.c_float),  # node_hi
                ctypes.POINTER(ctypes.c_int32),  # node_right
                ctypes.POINTER(ctypes.c_int32),  # node_first
                ctypes.POINTER(ctypes.c_int32),  # node_count
                ctypes.POINTER(ctypes.c_int32),  # node_axis
                ctypes.POINTER(ctypes.c_int32),  # prim_order
            ]
            assert lib.gopbrt_native_abi_version() == 1
            _lib = lib
        except Exception:
            _lib_failed = True
    return _lib


def available() -> bool:
    return load() is not None


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _iptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def bvh_build(
    lo: np.ndarray,
    hi: np.ndarray,
    max_leaf: int = 4,
    n_buckets: int = 12,
    n_threads: int = 0,
    method: str = "sah",
):
    """Build a flat BVH natively. Returns numpy arrays
    (node_lo, node_hi, node_right, node_first, node_count, node_axis,
    prim_order) matching ops.bvh.LinearBVH, or None if native unavailable.

    method: "sah" (binned SAH, bvh.go:272-411) or "hlbvh" (Morton radix +
    parallel treelets + upper SAH, bvh.go:413-630).
    """
    lib = load()
    if lib is None:
        return None
    lo = np.ascontiguousarray(lo, np.float32)
    hi = np.ascontiguousarray(hi, np.float32)
    n = lo.shape[0]
    assert lo.shape == (n, 3) and hi.shape == (n, 3)
    cap = 2 * n
    node_lo = np.empty((cap, 3), np.float32)
    node_hi = np.empty((cap, 3), np.float32)
    node_right = np.empty((cap,), np.int32)
    node_first = np.empty((cap,), np.int32)
    node_count = np.empty((cap,), np.int32)
    node_axis = np.empty((cap,), np.int32)
    prim_order = np.empty((n,), np.int32)
    n_nodes = lib.gopbrt_bvh_build(
        _fptr(lo),
        _fptr(hi),
        n,
        max_leaf,
        n_buckets,
        n_threads,
        1 if method == "hlbvh" else 0,
        _fptr(node_lo),
        _fptr(node_hi),
        _iptr(node_right),
        _iptr(node_first),
        _iptr(node_count),
        _iptr(node_axis),
        _iptr(prim_order),
    )
    if n_nodes <= 0:
        return None
    s = slice(0, n_nodes)
    return (
        node_lo[s].copy(),
        node_hi[s].copy(),
        node_right[s].copy(),
        node_first[s].copy(),
        node_count[s].copy(),
        node_axis[s].copy(),
        prim_order,
    )
