"""ctypes loader for the native C++ runtime components (csrc/).

Compiles csrc/*.cpp into a shared library on first use (g++, cached in
build/ under a name keyed by a hash of the sources and flags, so a fresh
checkout never loads a library built from other sources). Every native
entry point has a pure numpy fallback in its Python caller, so the
framework works without a toolchain; a failed build says so on stderr.
The native path is the production one for large scenes.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import sys
import tempfile
import threading

import numpy as np

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_CSRC = os.path.join(_REPO_ROOT, "csrc")
_BUILD = os.path.join(_REPO_ROOT, "build")
_CXX = ["g++", "-O3", "-shared", "-fPIC"]

_lock = threading.Lock()
_lib = None
_lib_failed = False


def library_path(csrc: str = _CSRC, build: str = _BUILD) -> str:
    """Where the library built from the current sources lives."""
    h = hashlib.sha256(" ".join(_CXX).encode())
    for name in sorted(f for f in os.listdir(csrc) if f.endswith(".cpp")):
        h.update(name.encode())
        with open(os.path.join(csrc, name), "rb") as f:
            h.update(f.read())
    return os.path.join(build, f"libtpt_native-{h.hexdigest()[:16]}.so")


def build_library(csrc: str = _CSRC, build: str = _BUILD) -> str:
    """Compile csrc/*.cpp unless the library for these sources exists.

    The compiler writes a private temporary file that is renamed into
    place, so concurrent builders (test workers) never load a half-written
    library. Raises subprocess.CalledProcessError on a compiler error."""
    out = library_path(csrc, build)
    if os.path.exists(out):
        return out
    os.makedirs(build, exist_ok=True)
    srcs = sorted(os.path.join(csrc, f) for f in os.listdir(csrc)
                  if f.endswith(".cpp"))
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=build)
    os.close(fd)
    try:
        subprocess.run([*_CXX, "-o", tmp, *srcs], check=True,
                       capture_output=True, text=True, timeout=300)
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def _compile_and_load():
    global _lib, _lib_failed
    with _lock:
        if _lib is not None or _lib_failed:
            return _lib
        try:
            lib = ctypes.CDLL(build_library())
        except subprocess.CalledProcessError as e:
            print("WARNING: native BVH builder failed to compile; using the "
                  f"numpy builder:\n{e.stderr}", file=sys.stderr)
            _lib_failed = True
            return None
        except (OSError, subprocess.TimeoutExpired) as e:
            print("WARNING: native BVH builder unavailable; using the numpy "
                  f"builder: {e}", file=sys.stderr)
            _lib_failed = True
            return None
        lib.tpt_build_bvh.restype = ctypes.c_int
        lib.tpt_build_bvh.argtypes = [
            ctypes.POINTER(ctypes.c_float),  # centroids
            ctypes.POINTER(ctypes.c_float),  # amins
            ctypes.POINTER(ctypes.c_float),  # amaxs
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int32),  # left
            ctypes.POINTER(ctypes.c_int32),  # right
            ctypes.POINTER(ctypes.c_int32),  # axis
            ctypes.POINTER(ctypes.c_int32),  # leaf [M,2]
            ctypes.POINTER(ctypes.c_float),  # bounds [M,6]
            ctypes.POINTER(ctypes.c_int32),  # perm
        ]
        lib.tpt_bvh8_collapse.restype = ctypes.c_int
        lib.tpt_bvh8_collapse.argtypes = [
            ctypes.POINTER(ctypes.c_int32),   # left
            ctypes.POINTER(ctypes.c_int32),   # right
            ctypes.POINTER(ctypes.c_int32),   # leaf [M,2]
            ctypes.POINTER(ctypes.c_float),   # bounds [M,6]
            ctypes.c_int,                     # num_nodes
            ctypes.POINTER(ctypes.c_float),   # tri_pack [T,9]
            ctypes.POINTER(ctypes.c_uint8),   # tri_leaf_mat [T]
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_float),   # table out
            ctypes.POINTER(ctypes.c_int32),   # counts out [2]
            ctypes.c_int,                     # policy (0 greedy, 1 sah)
        ]
        _lib = lib
        return _lib


def native_available() -> bool:
    return _compile_and_load() is not None


def native_build_bvh(centroids: np.ndarray, amins: np.ndarray,
                     amaxs: np.ndarray, max_leaf_size: int):
    """Run the C++ SAH builder. Returns (left, right, axis, leaf, bounds,
    perm) numpy arrays trimmed to the node count, or None if the native
    library is unavailable."""
    lib = _compile_and_load()
    if lib is None:
        return None
    n = centroids.shape[0]
    mmax = 2 * n
    c = np.ascontiguousarray(centroids, np.float32)
    mn = np.ascontiguousarray(amins, np.float32)
    mx = np.ascontiguousarray(amaxs, np.float32)
    left = np.empty(mmax, np.int32)
    right = np.empty(mmax, np.int32)
    axis = np.empty(mmax, np.int32)
    leaf = np.empty((mmax, 2), np.int32)
    bounds = np.empty((mmax, 6), np.float32)
    perm = np.empty(n, np.int32)

    fp = ctypes.POINTER(ctypes.c_float)
    ip = ctypes.POINTER(ctypes.c_int32)
    m = lib.tpt_build_bvh(
        c.ctypes.data_as(fp), mn.ctypes.data_as(fp), mx.ctypes.data_as(fp),
        n, int(max_leaf_size), mmax,
        left.ctypes.data_as(ip), right.ctypes.data_as(ip),
        axis.ctypes.data_as(ip), leaf.ctypes.data_as(ip),
        bounds.ctypes.data_as(fp), perm.ctypes.data_as(ip))
    if m <= 0:
        return None
    return (left[:m].copy(), right[:m].copy(), axis[:m].copy(),
            leaf[:m].copy(), bounds[:m].copy(), perm)


def native_bvh8_collapse(bvh, tri_pack: np.ndarray,
                         tri_is_leaf_mat: np.ndarray, leaf_tris: int,
                         row_width: int, policy: str = "sah"):
    """Run the C++ BVH8 collapse (exact ports of scene/bvh8.collapse_py /
    collapse_sah_py, selected by `policy`). Returns
    (table [R, row_width] f32, num_nodes, num_leaves) or None."""
    lib = _compile_and_load()
    if lib is None:
        return None
    t = tri_pack.shape[0]
    m = bvh.num_nodes
    max_rows = 2 * t + 9
    left = np.ascontiguousarray(bvh.left, np.int32)
    right = np.ascontiguousarray(bvh.right, np.int32)
    leaf = np.ascontiguousarray(bvh.leaf, np.int32)
    bounds = np.ascontiguousarray(bvh.bounds, np.float32)
    tp = np.ascontiguousarray(tri_pack, np.float32)
    lm = np.ascontiguousarray(tri_is_leaf_mat, np.uint8)
    table = np.empty((max_rows, row_width), np.float32)
    counts = np.zeros(2, np.int32)

    fp = ctypes.POINTER(ctypes.c_float)
    ip = ctypes.POINTER(ctypes.c_int32)
    up = ctypes.POINTER(ctypes.c_uint8)
    rows = lib.tpt_bvh8_collapse(
        left.ctypes.data_as(ip), right.ctypes.data_as(ip),
        leaf.ctypes.data_as(ip), bounds.ctypes.data_as(fp), m,
        tp.ctypes.data_as(fp), lm.ctypes.data_as(up),
        t, int(leaf_tris), int(row_width), max_rows,
        table.ctypes.data_as(fp), counts.ctypes.data_as(ip),
        1 if policy == "sah" else 0)
    if rows <= 0:
        return None
    return table[:rows].copy(), int(counts[0]), int(counts[1])
