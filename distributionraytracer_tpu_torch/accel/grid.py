"""Uniform grid, host half (counterpart of ``distributionraytracer_tpu.accel.grid``).

The build mirrors ``Grid::Build`` (grid.cpp:30-97): the world AABB padded by
EPSILON, cell counts ``n = m * w * (N/V)^(1/3) + 1`` with ``m = 2``
(rayAccelerator.h:30), every object inserted into each cell its AABB
overlaps, the cell lists flattened CSR-style.  All tables are NumPy.

The renderer's kernel route draws grid scenes through the emulation of
``accel/cuda_grid.py`` (a BVH over per-object boxes plus the grid's
observable gates, whose slab gate is :func:`grid_slab`).  This module also
holds the Amanatides & Woo 3D-DDA (grid.cpp:100-306) in plain torch, the
route ``RenderConfig(accel_backend='traversal')`` selects:

- :func:`make_grid_intersectors`, the batched DDA: one loop over the whole
  ray batch, each iteration testing up to K objects of a lane's cell and
  advancing it through up to M cells, with the proximity-cloud leap over
  empty space;
- :func:`make_grid_scalar_intersectors`, the per-ray state machine (one
  object test or one cell step an iteration), a cross-check for tests.

Reference semantics kept: ``Init_Traverse``'s slab test with IEEE
infinities for zero direction components (grid.cpp:124-152); the
closest-hit early exit ``best_t < t_next`` (grid.cpp:277-304); walking out
of the grid is a miss even with a hit recorded beyond the cell; shadow: any
object with ``t < dist`` occludes, and a failed ``Init_Traverse`` counts as
occluded (grid.cpp:321-324).  The arithmetic is the JAX package's as XLA
compiles it, so that both packages walk the same cells and stop at the same
answer: its float-to-int conversion (NaN to 0, out-of-range values
saturate), and its one-hot products, which XLA turns into selects (an
axis-aligned ray's infinite ``dt`` on its zero axes leaves ``t_next``
finite there, where ``0 * inf`` would make it NaN).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from distributionraytracer_tpu_torch import native
from distributionraytracer_tpu_torch.ops.common import EPSILON, FLT_MAX
from distributionraytracer_tpu_torch.ops.intersect import (
    HitResult, hit_packed,
)
from distributionraytracer_tpu_torch.scene.types import (
    OBJ_BOX, OBJ_PLANE, OBJ_SPHERE, OBJ_TRIANGLE, SceneData,
)
from distributionraytracer_tpu_torch.utils import spans


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


# --------------------------------------------------------------- traversal
def grid_tables(grid: GridArrays, device) -> GridArrays:
    """``grid``'s arrays as tensors on ``device`` (int64 for the ints)."""
    f = lambda a, dt: torch.as_tensor(a, dtype=dt, device=device)
    return GridArrays(f(grid.bbox_min, torch.float32),
                      f(grid.bbox_max, torch.float32),
                      f(grid.ncells, torch.int64),
                      f(grid.cell_start, torch.int64),
                      f(grid.cell_objs, torch.int64),
                      f(grid.cell_dist, torch.int64))


def _cells_of(p, g: GridArrays):
    """``clip(int((p - lo) * n / (hi - lo)), 0, n - 1)`` with XLA's
    float-to-int conversion (NaN to 0, out-of-range values saturate), which
    torch's does not give (NaN and overflow become INT_MIN): the clip is
    taken on the float, before any gather."""
    f = (p - g.bbox_min) * g.ncells.to(torch.float32) / (g.bbox_max
                                                         - g.bbox_min)
    f = torch.nan_to_num(f, nan=0.0)
    return torch.minimum(torch.clamp(f, min=0.0),
                         (g.ncells - 1).to(torch.float32)).to(torch.int64)


def _cell_linear(cell, n):
    return cell[:, 0] + n[0] * cell[:, 1] + n[0] * n[1] * cell[:, 2]


def _t_next(g: GridArrays, cell, tmin, dt, d):
    """Each axis's next cell-boundary crossing; FLT_MAX where d is 0."""
    n = g.ncells
    t = torch.where(d > 0, tmin + (cell + 1).to(torch.float32) * dt,
                    tmin + (n - cell).to(torch.float32) * dt)
    return torch.where(d == 0.0, torch.full_like(t, FLT_MAX), t)


def _next_axis(tn):
    """The axis whose cell boundary comes first; 2 when a NaN compares."""
    return torch.where((tn[:, 0] < tn[:, 1]) & (tn[:, 0] < tn[:, 2]), 0,
                       torch.where(tn[:, 1] < tn[:, 2], 1, 2))


def _step_t(tn, onehot_i, dt):
    """``tn + onehot * dt`` as XLA compiles it: a select, so that an
    infinite ``dt`` on another axis adds 0, not NaN."""
    return tn + torch.where(onehot_i.bool(), dt, torch.zeros_like(dt))


def _init_traverse_batched(g: GridArrays, o, d):
    """Init_Traverse (grid.cpp:100-244) over rays (R, 3): ``(ok, cell,
    dt, t_next, step, stop, tmin, t1)``; ``g`` from :func:`grid_tables`."""
    ok, tmin, tmax, t0, t1 = grid_slab(g.bbox_min, g.bbox_max, o, d)
    n = g.ncells
    inside = ((o > g.bbox_min) & (o < g.bbox_max)).all(-1)
    p = torch.where(inside[:, None], o, o + d * t0[:, None])
    cell = _cells_of(p, g)
    dt = (tmax - tmin) / n.to(torch.float32)
    pos = d > 0
    step = torch.where(pos, 1, -1)
    stop = torch.where(pos, n, -1)
    return ok, cell, dt, _t_next(g, cell, tmin, dt, d), step, stop, tmin, t1


def _init_traverse(g: GridArrays, o, d):
    """Init_Traverse of the per-ray DDA: ``(ok, cell, dt, t_next, step,
    stop)``, the batched one's first six (the JAX package's per-ray twin
    computes the same values one ray at a time)."""
    return _init_traverse_batched(g, o, d)[:6]


def _pick_unroll(cell_start) -> int:
    """Objects tested per iteration of the batched DDA: the median
    *entry-weighted* cell population, the size of the cell a random
    ray-object test sits in (dense mesh grids multi-insert heavily, so the
    plain per-cell median understates it), clipped to 1..24.  Host-side."""
    cs = np.asarray(cell_start.cpu() if isinstance(cell_start, torch.Tensor)
                    else cell_start, np.int64)
    counts = np.diff(cs)
    counts = counts[counts > 0]
    if counts.size == 0:
        return 1
    per_entry_median = np.percentile(np.repeat(counts, counts), 50)
    return int(np.clip(per_entry_median, 1, 24))


# Iterations between the batched DDA's checks for live lanes (the first
# before the first iteration): a check synchronises with the host, and a
# finished lane's iteration is a no-op.
CHECK_EVERY = 8


def make_grid_intersectors(scene: SceneData, grid: GridArrays,
                           motion_blur: bool = False,
                           unroll: Optional[int] = None,
                           adv_unroll: int = 2, leap: bool = True):
    """The batched 3D-DDA over ``grid`` (its tables move to the scene's
    device here, once).

    Each iteration a live lane tests up to ``unroll`` (K) objects of its
    cell, first minimum winning a tie in t (the reference's sequential
    strict ``<``), and once the cell is exhausted advances through up to
    ``adv_unroll`` (M) cells.  ``leap``: a lane entering a cell whose
    chessboard distance ``v`` to the nearest occupied cell is at least 3
    jumps ahead by ``(v - 2) * min(dt)``, re-deriving its cell and
    ``t_next`` from the landing point; the skipped cells are empty, so the
    result is bit-identical.  Every lane stops after ``sum(n) + entries //
    K + 64`` iterations (a NaN-born walk would otherwise run on); the loop
    checks for live lanes every :data:`CHECK_EVERY` iterations and drops
    the finished ones from its batch once they are half of it.  K and M
    set the work an iteration does, not the answer.
    """
    from distributionraytracer_tpu_torch.integrator.whitted import (
        Intersectors,
    )
    if unroll is None:
        unroll = _pick_unroll(grid.cell_start)
    K = int(unroll)
    M = max(1, int(adv_unroll))
    g = grid_tables(grid, scene.device)
    n = g.ncells
    data, types, mats = scene.packed_objects()
    cs, co = g.cell_start, g.cell_objs
    cell_se = torch.stack([cs[:-1], cs[1:]], dim=1)
    # object rows in cell order: [12 parameters, type, material, object id],
    # the ints as exact float values (all < 2^24), as in the reference
    fenc = lambda a: a.to(torch.float32)[:, None]
    obj_row = torch.cat([data, fenc(types), fenc(mats)], dim=1)[co]
    obj_row = torch.cat([obj_row, fenc(co)], dim=1)
    n_entries = co.shape[0]
    types_present = tuple(sorted(set(scene.static.obj_types)))
    max_iters = int(n.sum()) + n_entries // K + 64
    karange = torch.arange(K, device=scene.device)

    def _traverse(o, d, time, shadow_dist=None, valid=None):
        is_shadow = shadow_dist is not None
        R = o.shape[0]
        ok, cell, dt, tn, step, stop, tmin, t1 = _init_traverse_batched(
            g, o, d)
        if valid is not None:
            ok = ok & valid  # dead ray-tree lanes end at once
        se = cell_se[_cell_linear(cell, n)]
        zero = torch.zeros_like(se[:, 0])
        s = dict(cell=cell, tn=tn, ptr=torch.where(ok, se[:, 0], zero),
                 end=torch.where(ok, se[:, 1], zero),
                 best_t=torch.full((R,), FLT_MAX, dtype=torch.float32,
                                   device=o.device),
                 best_n=torch.zeros((R, 3), dtype=torch.float32,
                                    device=o.device),
                 best_obj=torch.full_like(zero, -1),
                 # a failed Init_Traverse counts as shadowed
                 occluded=~ok if is_shadow else torch.zeros_like(ok),
                 active=ok, found=torch.zeros_like(ok))
        # per-lane constants, subset with the state when lanes drop out
        c = dict(o=o, d=d, time=time, dt=dt, min_dt=dt.amin(-1),
                 step=step, stop=stop, tmin=tmin, t1=t1,
                 lane=torch.arange(R, device=o.device))
        if is_shadow:
            c["dist"] = shadow_dist
        done = []  # (lanes, state) of lanes that dropped out, all final
        for it in range(max_iters):
            if it % CHECK_EVERY == 0:
                spans.host_read(s["active"])  # nonzero reads its size
                live = torch.nonzero(s["active"]).squeeze(1)
                if live.numel() == 0:
                    break
                if live.numel() <= s["active"].shape[0] // 2:
                    gone = ~s["active"]
                    done.append((c["lane"][gone],
                                 {k: v[gone] for k, v in s.items()}))
                    s = {k: v[live] for k, v in s.items()}
                    c = {k: v[live] for k, v in c.items()}
            s = _body(s, c)
        done.append((c["lane"], s))
        lanes = torch.cat([x[0] for x in done])
        order = torch.empty_like(lanes)
        order[lanes] = torch.arange(R, device=o.device)
        out = {k: torch.cat([x[1][k] for x in done])[order]
               for k in ("best_t", "best_n", "best_obj", "occluded",
                         "found")}
        if is_shadow:
            return out["occluded"]
        hit = out["found"]
        return (hit, torch.where(hit, out["best_t"],
                                 torch.full_like(out["best_t"], FLT_MAX)),
                out["best_n"], torch.where(hit, out["best_obj"],
                                           torch.full_like(out["best_obj"],
                                                           -1)))

    def _body(s, c):
        """One iteration for every lane of the batch (the JAX package's
        while-loop body, operation for operation)."""
        o, d = c["o"], c["d"]
        Rw = o.shape[0]
        is_shadow = "dist" in c
        act = s["active"]
        # ---- test up to K objects of the current cell ----
        ptrs = s["ptr"][:, None] + karange
        omask = act[:, None] & (ptrs < s["end"][:, None])
        rows = obj_row[torch.clamp(ptrs, 0, n_entries - 1)]  # (Rw, K, 15)
        rep = lambda a: a[:, None].expand((Rw, K) + a.shape[1:]).reshape(
            (Rw * K,) + a.shape[1:])
        t, nrm = hit_packed(rep(o), rep(d), rep(c["time"]),
                            rows[..., 0:12].reshape(Rw * K, 12),
                            rows[..., 12].reshape(-1).to(torch.int64),
                            motion_blur, types_present=types_present)
        t = torch.where(omask, t.reshape(Rw, K),
                        torch.full((Rw, K), FLT_MAX, dtype=torch.float32,
                                   device=o.device))
        best_t, best_n, best_obj = s["best_t"], s["best_n"], s["best_obj"]
        if is_shadow:
            occ = (t < c["dist"][:, None]).any(1)
        else:
            occ = torch.zeros_like(act)
            kb = torch.argmin(t, dim=1, keepdim=True)  # first minimum
            tb = torch.gather(t, 1, kb)[:, 0]
            better = tb < best_t
            best_t = torch.where(better, tb, best_t)
            nb = torch.gather(nrm.reshape(Rw, K, 3), 1,
                              kb[:, :, None].expand(Rw, 1, 3))[:, 0]
            best_n = torch.where(better[:, None], nb, best_n)
            gb = torch.gather(rows[..., 14], 1, kb)[:, 0].to(torch.int64)
            best_obj = torch.where(better, gb, best_obj)
        ptr = s["ptr"] + omask.sum(1)

        # ---- advance the DDA through up to M cells once exhausted ----
        cell, tn, end, found = s["cell"], s["tn"], s["end"], s["found"]
        dt, step, stop = c["dt"], c["step"], c["stop"]
        occluded = s["occluded"] | occ
        active = act & ~occ
        adv = active & (ptr >= end)
        for _ in range(M):
            axis = _next_axis(tn)
            onehot_i = torch.nn.functional.one_hot(axis, 3)
            tn_axis = torch.gather(tn, 1, axis[:, None])[:, 0]
            # closest-hit early exit (grid.cpp:277-304)
            hit_now = (torch.zeros_like(adv) if is_shadow
                       else adv & (best_t < tn_axis))
            found = found | hit_now
            stepping0 = adv & ~hit_now
            tn = torch.where(stepping0[:, None], _step_t(tn, onehot_i, dt),
                             tn)
            # clamp into [-1, n]: NaN-born cells must not run off
            cell = torch.minimum(torch.clamp(
                torch.where(stepping0[:, None], cell + onehot_i * step,
                            cell), min=-1), n)
            out = stepping0 & ((cell * onehot_i).sum(-1)
                               == (stop * onehot_i).sum(-1))
            stepping = stepping0 & ~out
            inner = _cell_linear(torch.minimum(torch.clamp(cell, min=0),
                                               n - 1), n)
            se2 = cell_se[inner]
            ptr = torch.where(stepping, se2[:, 0], ptr)
            end = torch.where(stepping, se2[:, 1], end)
            active = active & ~hit_now & ~out
            adv = stepping & (ptr >= end)  # only lanes whose cell is empty
            if leap:
                # proximity-cloud jump over provably empty space: the entry
                # t of the current (empty) cell is the crossing just taken;
                # (v - 2) * min_dt stays inside the empty ball of radius v-1
                dv = g.cell_dist[inner]
                lp = adv & (dv >= 3)
                t_new = tn_axis + (dv.to(torch.float32) - 2.0) * c["min_dt"]
                lp_out = lp & (t_new >= c["t1"])
                ncell = _cells_of(o + d * t_new[:, None], g)
                tn_leap = _t_next(g, ncell, c["tmin"], dt, d)
                se3 = cell_se[_cell_linear(ncell, n)]
                do_leap = lp & ~lp_out
                cell = torch.where(do_leap[:, None], ncell, cell)
                tn = torch.where(do_leap[:, None], tn_leap, tn)
                ptr = torch.where(do_leap, se3[:, 0], ptr)
                end = torch.where(do_leap, se3[:, 1], end)
                if not is_shadow:
                    # a best_t inside the grid stands even if the jump
                    # leaves it (float-boundary insertions)
                    found = found | (lp_out & (best_t < c["t1"]))
                active = active & ~lp_out
                # the landing cell is empty by the ball guarantee; gate on
                # ptr/end anyway, so that a float-boundary landing on an
                # occupied cell has its objects tested
                adv = (adv & ~lp) | (do_leap & (ptr >= end))
        return dict(cell=cell, tn=tn, ptr=ptr, end=end, best_t=best_t,
                    best_n=best_n, best_obj=best_obj, occluded=occluded,
                    active=active, found=found)

    def closest(o, d, time, valid=None):
        hit, t, nrm, gid = _traverse(o, d, time, valid=valid)
        return HitResult(hit=hit, t=t, normal=nrm,
                         obj_id=gid.to(torch.int32),
                         mat_id=mats[torch.clamp(gid, min=0)])

    def shadow(o, d, dist, exclude_obj, valid=None):
        del exclude_obj  # the grid traversal has no self-exclusion
        return _traverse(o, d, torch.zeros_like(dist), shadow_dist=dist,
                         valid=valid)

    return Intersectors(closest, shadow)


def make_grid_scalar_intersectors(scene: SceneData, grid: GridArrays,
                                  motion_blur: bool = False):
    """The per-ray DDA state machine (grid.cpp:247-358's shape: each
    iteration tests one object of the cell or steps one cell), batched
    over rays with each finished lane frozen, as the JAX package's
    vmapped ``while_loop`` is.  A cross-check of
    :func:`make_grid_intersectors`; ``valid`` is ignored."""
    from distributionraytracer_tpu_torch.integrator.whitted import (
        Intersectors,
    )
    g = grid_tables(grid, scene.device)
    n = g.ncells
    data, types, mats = scene.packed_objects()
    cs, co = g.cell_start, g.cell_objs
    n_entries = co.shape[0]
    # each iteration consumes one cell entry or steps one cell along an
    # axis towards its stop: a walk cannot take more
    bound = n_entries + int(n.sum()) + 64

    def _walk(o, d, time, dist=None):
        R = o.shape[0]
        ok, cell, dt, tn, step, stop = _init_traverse(g, o, d)
        cid = _cell_linear(cell, n)
        zero = torch.zeros_like(cid)
        s = dict(cell=cell, tn=tn, ptr=torch.where(ok, cs[cid], zero),
                 end=torch.where(ok, cs[cid + 1], zero),
                 best_t=torch.full((R,), FLT_MAX, dtype=torch.float32,
                                   device=o.device),
                 best_n=torch.zeros((R, 3), dtype=torch.float32,
                                    device=o.device),
                 best_obj=torch.full_like(zero, -1),
                 occluded=~ok, active=ok, found=torch.zeros_like(ok))
        for _ in range(bound):
            act = s["active"]
            spans.host_read(act)
            if not bool(act.any()):
                break
            has_obj = s["ptr"] < s["end"]
            gid = co[torch.clamp(s["ptr"], 0, n_entries - 1)]
            t, nrm = hit_packed(o, d, time, data[gid], types[gid],
                                motion_blur)
            tn = s["tn"]
            axis = _next_axis(tn)
            onehot_i = torch.nn.functional.one_hot(axis, 3)
            adv = ~has_obj
            new = dict(s)
            if dist is None:
                better = has_obj & (t < s["best_t"])
                new["best_t"] = torch.where(better, t, s["best_t"])
                new["best_n"] = torch.where(better[:, None], nrm, s["best_n"])
                new["best_obj"] = torch.where(better, gid, s["best_obj"])
                hit_now = new["best_t"] < torch.gather(tn, 1,
                                                       axis[:, None])[:, 0]
                occ = torch.zeros_like(adv)
            else:
                occ = has_obj & (t < dist)
                new["occluded"] = s["occluded"] | occ
                hit_now = torch.zeros_like(adv)
            go = adv & ~hit_now
            new["tn"] = torch.where(go[:, None], _step_t(tn, onehot_i, dt), tn)
            new["cell"] = torch.where(go[:, None],
                                      s["cell"] + onehot_i * step, s["cell"])
            out = (torch.gather(new["cell"], 1, axis[:, None])
                   == torch.gather(stop, 1, axis[:, None]))[:, 0]
            stepping = go & ~out
            cid2 = _cell_linear(torch.minimum(torch.clamp(new["cell"],
                                                          min=0), n - 1), n)
            new["ptr"] = torch.where(stepping, cs[cid2],
                                     torch.where(has_obj, s["ptr"] + 1,
                                                 s["ptr"]))
            new["end"] = torch.where(stepping, cs[cid2 + 1], s["end"])
            new["found"] = s["found"] | (adv & hit_now)
            new["active"] = act & ~occ & ~(adv & (hit_now | out))
            # finished lanes keep their state (vmap's per-lane stop)
            s = {k: torch.where(act.reshape((-1,) + (1,) * (v.dim() - 1)),
                                v, s[k]) for k, v in new.items()}
        else:
            raise RuntimeError("scalar grid walk did not end")
        if dist is not None:
            return s["occluded"]
        hit = s["found"]
        return (hit, torch.where(hit, s["best_t"],
                                 torch.full_like(s["best_t"], FLT_MAX)),
                s["best_n"], torch.where(hit, s["best_obj"],
                                         torch.full_like(s["best_obj"], -1)))

    def closest(o, d, time, valid=None):
        del valid  # the per-ray walk answers every lane
        hit, t, nrm, gid = _walk(o, d, time)
        return HitResult(hit=hit, t=t, normal=nrm,
                         obj_id=gid.to(torch.int32),
                         mat_id=mats[torch.clamp(gid, min=0)])

    def shadow(o, d, dist, exclude_obj, valid=None):
        del exclude_obj, valid  # no self-exclusion; every lane answered
        return _walk(o, d, torch.zeros_like(dist), dist=dist)

    return Intersectors(closest, shadow)
