"""ctypes binding of the host builders in ``native/drt_native.cpp``.

Counterpart of ``distributionraytracer_tpu.native``: the SAH BVH build, the
grid cell insertion, the Chebyshev distance transform and the bulk float
tokenizer of P3F mesh blocks.  These are host-side table builds, not device
work.  The source is compiled at first use with

    g++ -O3 -std=c++17 -shared -fPIC -pthread native/drt_native.cpp \\
        -o distributionraytracer_tpu_torch/_build/libdrt_native_<hash>.so

into the port's own build directory (named by a hash of the source, written
atomically), so the tracked ``native/libdrt_native.so`` is never rebuilt.
Where no compiler is found or the build fails, every function returns None
and the callers take their NumPy builders instead; :func:`builder` says
which one builds the tables.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from typing import Optional

import numpy as np

_PKG = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(os.path.dirname(_PKG), "native", "drt_native.cpp")
BUILD_DIR = os.path.join(_PKG, "_build")
CXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC", "-pthread"]


def _compile() -> Optional[str]:
    """Path of the built library, building it when needed; None when the
    source or a C++ compiler is missing or the build fails."""
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if not cxx or not os.path.isfile(SOURCE):
        return None
    with open(SOURCE, "rb") as f:
        tag = hashlib.sha256(f.read() + " ".join(CXX_FLAGS).encode()
                             ).hexdigest()[:16]
    path = os.path.join(BUILD_DIR, f"libdrt_native_{tag}.so")
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    try:
        p = subprocess.run([cxx, *CXX_FLAGS, SOURCE, "-o", tmp],
                           capture_output=True, text=True)
        if p.returncode != 0:
            return None
        os.replace(tmp, path)  # atomic: concurrent builders never see half
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return path


@functools.lru_cache(maxsize=1)
def _load() -> Optional[ctypes.CDLL]:
    path = _compile()
    if path is None:
        return None
    lib = ctypes.CDLL(path)
    i64 = ctypes.c_int64
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    lib.drt_build_bvh.restype = i64
    lib.drt_build_bvh.argtypes = [i64, f32p, f32p, f32p, f32p, u8p, i32p,
                                  i32p, i32p]
    lib.drt_grid_insert.restype = i64
    lib.drt_grid_insert.argtypes = [
        i64, f32p, f32p, f64p, f64p, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_void_p, ctypes.c_void_p]
    lib.drt_chebyshev_dist.restype = None
    lib.drt_chebyshev_dist.argtypes = [
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, u8p, i32p,
        ctypes.c_int32]
    lib.drt_parse_floats.restype = i64
    lib.drt_parse_floats.argtypes = [ctypes.c_char_p, i64,
                                     ctypes.POINTER(i64), f64p, i64]
    return lib


def available() -> bool:
    return _load() is not None


def builder() -> str:
    """Which builder makes the accel tables: ``native`` or ``numpy``."""
    return "native" if available() else "numpy"


def build_bvh_native(bmin: np.ndarray, bmax: np.ndarray):
    """SAH BVH build; (node_min, node_max, leaf, index, nobjs, order), or
    None without the library."""
    lib = _load()
    if lib is None:
        return None
    n = len(bmin)
    cap = max(2 * n, 1)
    node_min = np.empty((cap, 3), np.float32)
    node_max = np.empty((cap, 3), np.float32)
    leaf = np.empty(cap, np.uint8)
    index = np.empty(cap, np.int32)
    nobjs = np.empty(cap, np.int32)
    order = np.empty(max(n, 1), np.int32)
    nn = lib.drt_build_bvh(
        n, np.ascontiguousarray(bmin, np.float32).reshape(-1, 3),
        np.ascontiguousarray(bmax, np.float32).reshape(-1, 3),
        node_min.reshape(-1), node_max.reshape(-1), leaf, index, nobjs,
        order)
    return (node_min[:nn], node_max[:nn], leaf[:nn].astype(bool),
            index[:nn], nobjs[:nn], order[:n])


def grid_insert_native(bmin, bmax, gmin, gmax, nx, ny, nz):
    """Grid cell insertion; (cell_ids, obj_ids), or None."""
    lib = _load()
    if lib is None:
        return None
    n = len(bmin)
    bmin = np.ascontiguousarray(bmin, np.float32).reshape(-1, 3)
    bmax = np.ascontiguousarray(bmax, np.float32).reshape(-1, 3)
    gmin = np.ascontiguousarray(gmin, np.float64)
    gmax = np.ascontiguousarray(gmax, np.float64)
    total = lib.drt_grid_insert(n, bmin, bmax, gmin, gmax, nx, ny, nz, None,
                                None)
    cells = np.empty(total, np.int64)
    objs = np.empty(total, np.int32)
    lib.drt_grid_insert(n, bmin, bmax, gmin, gmax, nx, ny, nz,
                        cells.ctypes.data, objs.ctypes.data)
    return cells, objs


def chebyshev_dist_native(occupied: np.ndarray, nx: int, ny: int, nz: int,
                          cap: int = 127):
    """Chessboard distance to the nearest occupied cell (flat, x fastest),
    int32[nx*ny*nz], or None."""
    lib = _load()
    if lib is None:
        return None
    occ = np.ascontiguousarray(occupied.reshape(-1), np.uint8)
    dist = np.empty(occ.size, np.int32)
    lib.drt_chebyshev_dist(nx, ny, nz, occ, dist, cap)
    return dist


def parse_floats_native(text: bytes, pos: int, count: int):
    """``count`` floats from ``text`` at byte ``pos``: (float64[count],
    new pos), or None."""
    lib = _load()
    if lib is None:
        return None
    out = np.empty(count, np.float64)
    p = ctypes.c_int64(pos)
    got = lib.drt_parse_floats(text, len(text), ctypes.byref(p), out, count)
    if got != count:
        raise ValueError(f"expected {count} floats, got {got}")
    return out, p.value
