"""Build the CUDA kernels in ``csrc/`` at first use and load them with ctypes.

Each ``.cu`` source is compiled by its own ``nvcc`` for Hopper (``sm_90a``),
all started together, and the objects are linked into one shared library
with a plain C interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \\
         -Xcompiler -fPIC -c csrc/<name>.cu -o _build/<name>_<hash>.o
    nvcc -gencode arch=compute_90a,code=sm_90a -shared \\
         -o _build/libdrt_kernels_<hash>.so _build/*_<hash>.o

The compiles run side by side because the build is part of every fresh
checkout's first run; a failed build leaves no object behind.  The library
name carries a hash of every source file, so a stale library is never
loaded.  ``--use_fast_math`` is deliberately absent: the
intersection tests rely on IEEE ``inf`` and exact division.  Nothing here
runs at import time; a missing ``nvcc`` or a failed build raises.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from typing import NamedTuple

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C signatures of the launch functions; every one returns cudaError_t.
SIGNATURES = {
    # runs, ids, n_sph, n_tri, n_pln, n_box, table, types, mats, o, d,
    # time, valid, n, motion_blur, hit, t, normal, obj, mat, stream
    "drt_closest_hit": [_P, _P, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P,
                        _I, _I, _P, _P, _P, _P, _P, _P],
    # runs, ids, n_sph, n_tri, n_pln, n_box, o, d, dist, excl, valid, n,
    # mode, occ, stream
    "drt_any_hit": [_P, _P, _I, _I, _I, _I, _P, _P, _P, _P, _P, _I, _I, _P,
                    _P],
    # table, types, mrow, n_obj, lights, light_quad, n_lights, gbox, rays,
    # n, motion_blur, spawn, ref_shadow, out, next, tile, refr_k, refl_k,
    # stream
    "drt_whitted_level": [_P, _P, _P, _I, _P, _P, _I, _P, _P, _I, _I, _I,
                          _I, _P, _P, _I, _I, _I, _P],
    # nodes, n_nodes, objs, rays, n, motion_blur, walk, out_f, out_i, stream
    "drt_packet_closest": [_P, _I, _P, _P, _I, _I, _I, _P, _P, _P],
    # nodes, n_nodes, objs, rays, n, motion_blur, walk, grid_mode, occ,
    # stream
    "drt_packet_shadow": [_P, _I, _P, _P, _I, _I, _I, _I, _P, _P],
    # objs, chain_start, n_chains, cand, cand_dist, o, d, time, valid, n,
    # motion_blur, keys, item_start, counter, t, normal, obj, stream
    "drt_binned_closest": [_P, _P, _I, _P, _P, _P, _P, _P, _P, _I, _I, _P,
                           _P, _P, _P, _P, _P, _P],
    # objs, tile_start, frames, K, group, gdist, light_id, o, d, dist,
    # valid, n, grid_mode, chains, rows, item_start, counter, occ, stream
    "drt_binned_shadow": [_P, _P, _P, _I, _P, _P, _P, _P, _P, _P, _P, _I,
                          _I, _P, _P, _P, _P, _P, _P],
    # table, mats, n_tri, n_sph, n_msph, o, d, time, n, hit, t, pos,
    # normal, mat, stream
    "drt_pt_closest": [_P, _P, _I, _I, _I, _P, _P, _P, _I, _P, _P, _P, _P,
                       _P, _P],
    # table, n_tri, n_sph, n_msph, o, d, time, tmax, tmax_all, n, occ,
    # stream
    "drt_pt_any_hit": [_P, _I, _I, _I, _P, _P, _P, _P, _F, _I, _P, _P],
    # table, mrow, n_tri, n_sph, n_msph, plights, n_pl, qlights, n_ql,
    # state, uniforms, n, russian_roulette, gradient_sky, stream
    "drt_pt_bounce": [_P, _P, _I, _I, _I, _P, _I, _P, _I, _P, _P, _I, _I,
                      _I, _P],
    # table, mrow, n_tri, n_sph, n_msph, plights, n_pl, qlights, n_ql, o,
    # d, time, n, n_bounces, uniform pointers, uniform strides,
    # russian_roulette, gradient_sky, col, mw, md, live, stream
    "drt_pt_trace": [_P, _P, _I, _I, _I, _P, _I, _P, _I, _P, _P, _P, _I, _I,
                     _P, _P, _I, _I, _P, _P, _P, _P, _P],
}


class Built(NamedTuple):
    lib: ctypes.CDLL
    path: str
    seconds: float  # build wall time, 0.0 when the library was already built
    log: str  # nvcc's output (register and spill report)
    # wall seconds of each source's nvcc, run side by side (empty when the
    # library was already built); their sum is what one after another takes
    compile_seconds: dict


def sources():
    return sorted(os.path.join(CSRC, f) for f in os.listdir(CSRC)
                  if f.endswith((".cu", ".cuh")))


def _find_nvcc() -> str:
    cands = [shutil.which("nvcc")]
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root:
            cands.append(os.path.join(root, "bin", "nvcc"))
    for c in cands:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


def _digest(paths) -> str:
    h = hashlib.sha256()
    for p in paths:
        h.update(os.path.basename(p).encode())
        with open(p, "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _run(cmd):
    """(completed process, wall seconds) of one command."""
    t0 = time.perf_counter()
    p = subprocess.run(cmd, cwd=CSRC, stdout=subprocess.PIPE,
                       stderr=subprocess.STDOUT, text=True)
    return p, time.perf_counter() - t0


def _run_all(cmds):
    """Run the commands concurrently; raise on the first that fails.
    Returns their combined output, in command order, and each one's wall
    seconds."""
    with concurrent.futures.ThreadPoolExecutor(len(cmds)) as pool:
        done = list(pool.map(_run, cmds))
    for c, (p, _) in zip(cmds, done):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({p.returncode}):\n"
                               f"{' '.join(c)}\n{p.stdout}")
    return "".join(p.stdout for p, _ in done), [s for _, s in done]


@functools.lru_cache(maxsize=1)
def load() -> Built:
    """Compile (when needed) and load the kernel library; cached per process."""
    srcs = sources()
    tag = _digest(srcs)
    path = os.path.join(BUILD_DIR, f"libdrt_kernels_{tag}.so")
    seconds, log, compile_seconds = 0.0, "", {}
    if not os.path.exists(path):
        nvcc = _find_nvcc()
        os.makedirs(BUILD_DIR, exist_ok=True)
        pid = os.getpid()
        cus = [s for s in srcs if s.endswith(".cu")]
        objs = [os.path.join(BUILD_DIR, f"{os.path.basename(s)[:-3]}_{tag}"
                             f".{pid}.o") for s in cus]
        tmp = f"{path}.{pid}.tmp"
        t0 = time.perf_counter()
        try:
            log, secs = _run_all([[nvcc, *NVCC_FLAGS, "-c", s, "-o", o]
                                  for s, o in zip(cus, objs)])
            compile_seconds = {os.path.basename(s): x
                               for s, x in zip(cus, secs)}
            log += _run_all([[nvcc, *ARCH_FLAGS, "-shared", "-o", tmp,
                              *objs]])[0]
            seconds = time.perf_counter() - t0
            os.replace(tmp, path)  # atomic: concurrent builders never see half
        finally:
            for f in (*objs, tmp):
                if os.path.exists(f):
                    os.remove(f)
    lib = ctypes.CDLL(path)
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return Built(lib, path, seconds, log, compile_seconds)


def check(err: int, name: str):
    """Raise on a nonzero cudaError_t returned by a launch function."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")
