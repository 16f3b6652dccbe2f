"""Uniform grid, host half (counterpart of ``distributionraytracer_tpu.accel.grid``).

The build mirrors ``Grid::Build`` (grid.cpp:30-97): the world AABB padded by
EPSILON, cell counts ``n = m * w * (N/V)^(1/3) + 1`` with ``m = 2``
(rayAccelerator.h:30), every object inserted into each cell its AABB
overlaps, the cell lists flattened CSR-style.  All tables are NumPy.

The port renders grid scenes through the emulation of ``accel/cuda_grid.py``
(a BVH over per-object boxes plus the grid's observable gates), whose slab
gate is :func:`grid_slab`, the slab half of the JAX package's
``_init_traverse_batched``.  Its 3D-DDA traversals (the differentiable
route) are not ported yet.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from distributionraytracer_tpu_torch import native
from distributionraytracer_tpu_torch.ops.common import EPSILON
from distributionraytracer_tpu_torch.scene.types import (
    OBJ_BOX, OBJ_PLANE, OBJ_SPHERE, OBJ_TRIANGLE, SceneData,
)


def _np(a) -> np.ndarray:
    return a.detach().cpu().numpy().astype(np.float32)


def object_bboxes(scene: SceneData) -> np.ndarray:
    """(O, 2, 3) f32 per-object AABBs with the reference's semantics:

    - sphere: centre +- r (scene.cpp:201-206);
    - triangle: vertex min/max padded by EPSILON (scene.cpp:14-35);
    - plane: the default Object box (-1,-1,-1)..(1,1,1), which Plane never
      overrides (scene.h:116, 125-136), a reference bug kept;
    - box: min/max (scene.cpp:214-216).
    """
    st = scene.static
    types = np.array(st.obj_types, np.int64)
    tidx = np.array(st.obj_tidx, np.int64)
    out = np.zeros((st.n_objects, 2, 3), np.float32)
    m = types == OBJ_SPHERE
    if m.any():
        c, r = _np(scene.sph_center)[tidx[m]], _np(scene.sph_radius)[tidx[m]]
        out[m, 0] = c - r[:, None]
        out[m, 1] = c + r[:, None]
    m = types == OBJ_TRIANGLE
    if m.any():
        i = tidx[m]
        v0 = _np(scene.tri_v0)[i]
        pts = np.stack([v0, v0 + _np(scene.tri_e1)[i],
                        v0 + _np(scene.tri_e2)[i]], axis=1)
        out[m, 0] = pts.min(1) - EPSILON
        out[m, 1] = pts.max(1) + EPSILON
    m = types == OBJ_PLANE
    if m.any():
        out[m, 0] = -1.0
        out[m, 1] = 1.0
    m = types == OBJ_BOX
    if m.any():
        out[m, 0] = _np(scene.box_min)[tidx[m]]
        out[m, 1] = _np(scene.box_max)[tidx[m]]
    return out


class GridArrays(NamedTuple):
    bbox_min: np.ndarray  # (3,) f32
    bbox_max: np.ndarray  # (3,) f32
    ncells: np.ndarray  # (3,) i32 (nx, ny, nz)
    cell_start: np.ndarray  # (nx*ny*nz + 1,) i32
    cell_objs: np.ndarray  # (total,) i32 global object ids
    cell_dist: np.ndarray  # (nx*ny*nz,) i32 chessboard distance to occupied


_DIST_CAP = 127


def _chebyshev_dist(occupied: np.ndarray, nx: int, ny: int, nz: int,
                    cap: int = _DIST_CAP, use_native: bool = True
                    ) -> np.ndarray:
    """Chessboard distance to the nearest occupied cell, capped: the native
    two-pass chamfer, or one 3x3x3 dilation ring per pass in NumPy."""
    if use_native:
        res = native.chebyshev_dist_native(occupied, nx, ny, nz, cap)
        if res is not None:
            return res
    occ = occupied.reshape(nz, ny, nx).astype(bool)
    dist = np.where(occ, 0, cap).astype(np.int32)
    frontier = occ
    for k in range(1, cap):
        if frontier.all():
            break
        grown = frontier.copy()
        for ax in range(3):  # separable +-1 dilation = the 3^3 cube
            g = grown
            grown = g.copy()
            lo = tuple(slice(None, -1) if a == ax else slice(None)
                       for a in range(3))
            hi = tuple(slice(1, None) if a == ax else slice(None)
                       for a in range(3))
            grown[lo] |= g[hi]
            grown[hi] |= g[lo]
        dist[grown & ~frontier] = k
        frontier = grown
    return dist.reshape(-1)


def build_grid(scene: SceneData, m: float = 2.0,
               use_native: bool = True) -> GridArrays:
    st = scene.static
    if st.n_objects == 0:
        raise ValueError("empty scene")
    bb = object_bboxes(scene)
    gmin = bb[:, 0].min(0) - EPSILON
    gmax = bb[:, 1].max(0) + EPSILON
    w = (gmax - gmin).astype(np.float64)
    s = (st.n_objects / (w[0] * w[1] * w[2])) ** (1.0 / 3.0)
    n = (m * w * s + 1).astype(np.int64)  # truncation as in grid.cpp:63-65
    nx, ny, nz = int(n[0]), int(n[1]), int(n[2])

    res = (native.grid_insert_native(bb[:, 0], bb[:, 1],
                                     gmin.astype(np.float64),
                                     gmax.astype(np.float64), nx, ny, nz)
           if use_native else None)
    if res is not None:
        cell_ids, obj_ids = res
    else:
        # clamp((p - min) * n / (max - min), 0, n - 1), truncated
        # (grid.cpp:80-85)
        cell_of = lambda p: np.clip((p - gmin) * n / (gmax - gmin), 0,
                                    n - 1).astype(np.int64)
        lo, hi = cell_of(bb[:, 0]), cell_of(bb[:, 1])
        cells, objs = [], []
        for gid in range(st.n_objects):
            cz, cy, cx = np.meshgrid(np.arange(lo[gid, 2], hi[gid, 2] + 1),
                                     np.arange(lo[gid, 1], hi[gid, 1] + 1),
                                     np.arange(lo[gid, 0], hi[gid, 0] + 1),
                                     indexing="ij")
            c = (cx + nx * cy + nx * ny * cz).ravel()
            cells.append(c)
            objs.append(np.full(len(c), gid, np.int64))
        cell_ids, obj_ids = np.concatenate(cells), np.concatenate(objs)
    # CSR by cell, object insertion order kept within a cell
    order = np.argsort(cell_ids, kind="stable")
    cell_ids, obj_ids = cell_ids[order], obj_ids[order]
    counts = np.bincount(cell_ids, minlength=nx * ny * nz)
    start = np.zeros(nx * ny * nz + 1, np.int64)
    np.cumsum(counts, out=start[1:])
    return GridArrays(
        bbox_min=np.asarray(gmin, np.float32),
        bbox_max=np.asarray(gmax, np.float32),
        ncells=np.asarray([nx, ny, nz], np.int32),
        cell_start=start.astype(np.int32),
        cell_objs=obj_ids.astype(np.int32),
        cell_dist=_chebyshev_dist((counts > 0).astype(np.uint8), nx, ny, nz,
                                  use_native=use_native))


def grid_slab(bbox_min, bbox_max, o, d):
    """Init_Traverse's slab test over the grid box (grid.cpp:124-152):
    ``(ok, tmin (R,3), tmax (R,3), t0, t1)``; ``ok`` is false where the ray
    misses the box or leaves it behind its origin."""
    f32 = dict(dtype=torch.float32, device=o.device)
    lo = torch.as_tensor(bbox_min, **f32)
    hi = torch.as_tensor(bbox_max, **f32)
    a = 1.0 / d  # +-inf on zeros; the sign of zero matters, as in C++
    tmin = torch.where(a >= 0, (lo - o) * a, (hi - o) * a)
    tmax = torch.where(a >= 0, (hi - o) * a, (lo - o) * a)
    t0 = torch.amax(tmin, dim=-1)
    t1 = torch.amin(tmax, dim=-1)
    return ~((t0 > t1) | (t1 < 0)), tmin, tmax, t0, t1

