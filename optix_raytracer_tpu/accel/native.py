"""ctypes bridge to the native (C++) runtime: host-side SAH BVH builder.

The framework's compute path is JAX/XLA/Pallas; the *runtime around it* is
native where the reference's is (the driver's accel builder behind
`optixAccelBuild`, `include/optix_host.h:562`). `native/bvh_builder.cpp`
implements a binned-SAH builder that emits the same threaded DFS layout the
traversal kernel consumes — higher-quality trees than the on-device LBVH for
static scenes, built once on the host at scene-finalize time. The shared
library is compiled on first use (g++, no deps) and the loader degrades
gracefully to the device LBVH when no toolchain exists.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional

import numpy as np

_lock = threading.Lock()
_lib = None
_lib_failed = False

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "native")
_SO_PATH = os.path.join(_NATIVE_DIR, "libort_native.so")


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _lib_failed
    with _lock:
        if _lib is not None or _lib_failed:
            return _lib
        try:
            srcs = [os.path.join(_NATIVE_DIR, f)
                    for f in ("bvh_builder.cpp", "mesh_loader.cpp")]
            stale = (not os.path.exists(_SO_PATH)
                     or any(os.path.getmtime(s) > os.path.getmtime(_SO_PATH)
                            for s in srcs))
            if stale:
                subprocess.run(
                    ["g++", "-O3", "-march=native", "-fPIC", "-std=c++17",
                     "-shared", "-o", _SO_PATH] + srcs,
                    check=True, capture_output=True, timeout=300)
            lib = ctypes.CDLL(_SO_PATH)
            lib.ort_build_bvh_sah.restype = ctypes.c_int32
            lib.ort_build_bvh_sah.argtypes = [
                ctypes.POINTER(ctypes.c_float)] * 3 + [ctypes.c_int32] + [
                ctypes.POINTER(ctypes.c_float)] * 2 + [
                ctypes.POINTER(ctypes.c_int32)] * 2
            lib.ort_build_bvh_sah_mt.restype = ctypes.c_int32
            lib.ort_build_bvh_sah_mt.argtypes = (
                lib.ort_build_bvh_sah.argtypes + [ctypes.c_int32])
            lib.ort_bvh_sah_cost.restype = ctypes.c_float
            lib.ort_bvh_sah_cost.argtypes = [
                ctypes.POINTER(ctypes.c_float),
                ctypes.POINTER(ctypes.c_float),
                ctypes.POINTER(ctypes.c_int32), ctypes.c_int32]
            _lib = lib
        except Exception:
            _lib_failed = True
            _lib = None
        return _lib


def available() -> bool:
    return _load() is not None


def get_lib():
    """The loaded native library (None when unavailable) — for sibling
    modules binding additional entry points (io/meshio.py)."""
    return _load()


def _fptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _iptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def _build_threads() -> int:
    """Worker count for the parallel subtree phase (ORT_NATIVE_THREADS
    overrides; output is byte-identical for any value)."""
    env = os.environ.get("ORT_NATIVE_THREADS")
    if env:
        return max(1, int(env))
    return max(1, os.cpu_count() or 1)


def build_bvh_sah(geom, num_threads: Optional[int] = None) \
        -> Optional["LBVH"]:
    """Build a threaded SAH BVH on the host → accel.lbvh.LBVH, or None when
    the native library is unavailable. Large builds run the deferred-
    subtree phase across `num_threads` workers (default: all cores) —
    deterministic, byte-identical to the serial build."""
    lib = _load()
    if lib is None:
        return None
    from .lbvh import LBVH
    import jax.numpy as jnp

    v0 = np.asarray(geom.v0, np.float32)
    e1 = np.asarray(geom.e1, np.float32)
    e2 = np.asarray(geom.e2, np.float32)
    v1 = v0 + e1
    v2 = v0 + e2
    tri_lo = np.ascontiguousarray(np.minimum(v0, np.minimum(v1, v2)))
    tri_hi = np.ascontiguousarray(np.maximum(v0, np.maximum(v1, v2)))
    centroid = np.ascontiguousarray(0.5 * (tri_lo + tri_hi))

    n = tri_lo.shape[0]
    num_nodes = 2 * n - 1
    node_lo = np.empty((num_nodes, 3), np.float32)
    node_hi = np.empty((num_nodes, 3), np.float32)
    node_skip = np.empty(num_nodes, np.int32)
    node_prim = np.empty(num_nodes, np.int32)

    written = lib.ort_build_bvh_sah_mt(
        _fptr(tri_lo), _fptr(tri_hi), _fptr(centroid), n,
        _fptr(node_lo), _fptr(node_hi), _iptr(node_skip), _iptr(node_prim),
        _build_threads() if num_threads is None else num_threads)
    if written != num_nodes:
        return None
    return LBVH(node_lo=jnp.asarray(node_lo), node_hi=jnp.asarray(node_hi),
                node_skip=jnp.asarray(node_skip),
                node_prim=jnp.asarray(node_prim))


def sah_cost(bvh) -> float:
    """Relative SAH cost of a threaded BVH (lower = better tree)."""
    lib = _load()
    if lib is None:
        return float("nan")
    node_lo = np.ascontiguousarray(np.asarray(bvh.node_lo, np.float32))
    node_hi = np.ascontiguousarray(np.asarray(bvh.node_hi, np.float32))
    node_prim = np.ascontiguousarray(np.asarray(bvh.node_prim, np.int32))
    return float(lib.ort_bvh_sah_cost(_fptr(node_lo), _fptr(node_hi),
                                      _iptr(node_prim),
                                      node_prim.shape[0]))
