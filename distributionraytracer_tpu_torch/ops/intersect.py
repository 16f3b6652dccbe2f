"""Batched ray-primitive intersection in plain torch.

Counterpart of ``distributionraytracer_tpu.ops.intersect``.  Each primitive
type has a masked, vectorized function returning a ``(R, N)`` t matrix;
misses are ``+FLT_MAX`` so an argmin reproduces the reference's strict
``rec.t < hitRec.t`` first-wins scan (main.cpp:315-326).
:func:`closest_hit_brute` and :func:`any_hit_brute` are the plain versions
of the CUDA kernels K1 and K2 (:mod:`ops.cuda_intersect`).

Semantics preserved exactly:

- sphere (scene.cpp:152-197): nearest positive root with ``t > EPSILON``;
  motion blur moves the center by ``(0,1,0) * ray.time``.
- triangle (scene.cpp:44-92): Moller-Trumbore, ``a == 0`` is a miss,
  ``t > EPSILON``.
- plane (scene.cpp:118-149): parallel when ``|PN.D| < EPSILON``; ``t > 0``.
- aaBox (scene.cpp:218-278): slab test; hit only when ``tmin > EPSILON``;
  face normal selected by EPSILON-comparing the hit point to each face.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from distributionraytracer_tpu_torch.ops.common import (
    EPSILON, FLT_MAX, cross, dot, normalize, safe_sqrt,
)
from distributionraytracer_tpu_torch.scene.types import (
    OBJ_BOX, OBJ_PLANE, OBJ_SPHERE, OBJ_TRIANGLE, SceneData,
)

_VEL = (0.0, 1.0, 0.0)  # motion-blur velocity, hardwired (scene.cpp:159-161)


class HitResult(NamedTuple):
    hit: torch.Tensor  # (R,) bool
    t: torch.Tensor  # (R,) f32 (+FLT_MAX on miss)
    normal: torch.Tensor  # (R,3) geometric normal of the winner (unflipped)
    obj_id: torch.Tensor  # (R,) i32 global insertion-order object id (-1 miss)
    mat_id: torch.Tensor  # (R,) i32


def _miss(ok, t):
    return torch.where(ok, t, torch.full_like(t, FLT_MAX))


def _moved(center, time):
    vel = torch.tensor(_VEL, dtype=center.dtype, device=center.device)
    return center + vel * time[..., None]


# ---------------------------------------------------------------- spheres
def _dot3(a, b):
    """x*x' + y*y' + z*z', left to right, one rounding per operation (the
    order of pallas_intersect.py::_dot3 and of the CUDA kernels)."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def sphere_t(o, d, time, center, radius, motion_blur: bool):
    """t matrix for rays (R,3) x spheres (N,3): returns (R,N) f32.

    The discriminant cancels catastrophically for small, distant spheres,
    so its operations keep a fixed order that the kernels share."""
    if motion_blur:
        c = _moved(center[None, :, :], time[:, None])  # (R,N,3)
        oc = o[:, None, :] - c
    else:
        oc = o[:, None, :] - center[None, :, :]
    a = _dot3(d, d)[:, None]
    b = 2.0 * _dot3(oc, d[:, None, :])
    cq = _dot3(oc, oc) - (radius * radius)[None, :]
    disc = b * b - 4.0 * a * cq
    sq = safe_sqrt(disc)  # sqrt's backward at disc <= 0 would be 0 * inf
    t1 = (-b - sq) / (2.0 * a)
    t2 = (-b + sq) / (2.0 * a)
    t = torch.where(t1 > EPSILON, t1, t2)
    return _miss((disc >= 0.0) & (t > EPSILON), t)


def sphere_normal(o, d, t, time, center, radius, motion_blur: bool):
    """Normal for one winning sphere per ray (gathered params), with the
    operation order the kernels share."""
    if motion_blur:
        center = _moved(center, time)
    p = o + d * t[..., None] - center
    return p / torch.sqrt(_dot3(p, p))[..., None]


# ---------------------------------------------------------------- triangles
def triangle_t(o, d, v0, e1, e2):
    """Moller-Trumbore t matrix (R,N); edges precomputed (scene.cpp:58-77)."""
    h = cross(d[:, None, :], e2[None, :, :])  # (R,N,3)
    a = dot(e1[None, :, :], h)
    nz = a != 0.0
    f = 1.0 / torch.where(nz, a, torch.ones_like(a))
    s = o[:, None, :] - v0[None, :, :]
    u = f * dot(s, h)
    q = cross(s, e1[None, :, :])
    v = f * dot(q, d[:, None, :])
    t = f * dot(e2[None, :, :], q)
    ok = (nz & (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (u + v <= 1.0)
          & (t > EPSILON))
    return _miss(ok, t)


def triangle_normal(e1, e2):
    return normalize(cross(e1, e2))


# ---------------------------------------------------------------- planes
def plane_t(o, d, pn, pd):
    """Plane t matrix (R,N) (scene.cpp:118-149)."""
    denom = dot(d[:, None, :], pn[None, :, :])
    nz = torch.abs(denom) >= EPSILON
    num = dot(o[:, None, :], pn[None, :, :]) + pd[None, :]
    t = -num / torch.where(nz, denom, torch.ones_like(denom))
    return _miss(nz & (t > 0.0), t)


# ---------------------------------------------------------------- aa boxes
def box_t(o, d, bmin, bmax):
    """Axis-aligned box slab-test t matrix (R,N) (scene.cpp:218-258)."""
    inv = 1.0 / d  # +-inf for zero components
    t0 = (bmin[None, :, :] - o[:, None, :]) * inv[:, None, :]
    t1 = (bmax[None, :, :] - o[:, None, :]) * inv[:, None, :]
    tmin = torch.minimum(t0, t1).amax(dim=-1)
    tmax = torch.maximum(t0, t1).amin(dim=-1)
    return _miss((tmin <= tmax) & (tmin > EPSILON), tmin)


def box_normal(o, d, t, bmin, bmax):
    """Face normal by EPSILON-compare of hit point (scene.cpp:262-274)."""
    p = o + d * t[..., None]
    n = torch.zeros_like(p)
    taken = torch.zeros(p.shape[:-1], dtype=torch.bool, device=p.device)
    # ordered if/else chain; first match wins, default (0,0,0)
    for axis, bound, sign in ((0, bmin, -1.0), (0, bmax, 1.0),
                              (1, bmin, -1.0), (1, bmax, 1.0),
                              (2, bmin, -1.0), (2, bmax, 1.0)):
        c = torch.abs(p[..., axis] - bound[..., axis]) < EPSILON
        n[..., axis] = torch.where(c & ~taken, sign, n[..., axis])
        taken = taken | c
    return n


# ---------------------------------------------------------------- combined
def _type_gids(scene: SceneData, typ: int, device) -> torch.Tensor:
    obj_types = np.array(scene.static.obj_types, np.int64)
    return torch.as_tensor(np.nonzero(obj_types == typ)[0].astype(np.int32),
                           device=device)


def _type_tmats(scene: SceneData, o, d, time, motion_blur: bool):
    """(type, gids, t matrix) for every primitive type present."""
    st = scene.static
    out = []
    if st.n_spheres:
        out.append((OBJ_SPHERE, sphere_t(o, d, time, scene.sph_center,
                                         scene.sph_radius, motion_blur)))
    if st.n_triangles:
        out.append((OBJ_TRIANGLE, triangle_t(o, d, scene.tri_v0,
                                             scene.tri_e1, scene.tri_e2)))
    if st.n_planes:
        out.append((OBJ_PLANE, plane_t(o, d, scene.pln_n, scene.pln_d)))
    if st.n_boxes:
        out.append((OBJ_BOX, box_t(o, d, scene.box_min, scene.box_max)))
    return [(typ, _type_gids(scene, typ, o.device), tm) for typ, tm in out]


def closest_hit_brute(scene: SceneData, o, d, time,
                      motion_blur: bool) -> HitResult:
    """Linear scan over every object, returning the reference's winner.

    Cross-type ties resolve by smallest global object id, matching the
    insertion-order scan of main.cpp:315-326.  Plain version of K1.
    """
    st = scene.static
    R, dev = o.shape[0], o.device
    best_t = torch.full((R,), FLT_MAX, dtype=torch.float32, device=dev)
    best_gid = torch.full((R,), -1, dtype=torch.int32, device=dev)
    best_type = torch.full((R,), -1, dtype=torch.int32, device=dev)
    for typ, gids, tmat in _type_tmats(scene, o, d, time, motion_blur):
        t, idx = torch.min(tmat, dim=1)  # first minimum on ties
        gid = torch.where(t < FLT_MAX, gids[idx], -1)
        # lexicographic (t, gid): ties across types pick smaller object id
        better = (t < best_t) | ((t == best_t) & (gid >= 0)
                                 & ((gid < best_gid) | (best_gid < 0)))
        best_t = torch.where(better, t, best_t)
        best_gid = torch.where(better, gid, best_gid)
        best_type = torch.where(better, typ, best_type)

    hit = best_t < FLT_MAX
    t_n = torch.where(hit, best_t, torch.ones_like(best_t))
    tidx = torch.as_tensor(np.array(st.obj_tidx or (0,), np.int64),
                           device=dev)
    sub = tidx[torch.clamp(best_gid, min=0).long()]

    normal = torch.zeros_like(o)
    mat_id = torch.zeros((R,), dtype=torch.int32, device=dev)
    if st.n_spheres:
        m = best_type == OBJ_SPHERE
        i = torch.clamp(sub, 0, st.n_spheres - 1)
        n_s = sphere_normal(o, d, t_n, time, scene.sph_center[i],
                            scene.sph_radius[i], motion_blur)
        normal = torch.where(m[:, None], n_s, normal)
        mat_id = torch.where(m, scene.sph_mat[i], mat_id)
    if st.n_triangles:
        m = best_type == OBJ_TRIANGLE
        i = torch.clamp(sub, 0, st.n_triangles - 1)
        n_t = triangle_normal(scene.tri_e1[i], scene.tri_e2[i])
        normal = torch.where(m[:, None], n_t, normal)
        mat_id = torch.where(m, scene.tri_mat[i], mat_id)
    if st.n_planes:
        m = best_type == OBJ_PLANE
        i = torch.clamp(sub, 0, st.n_planes - 1)
        normal = torch.where(m[:, None], scene.pln_n[i], normal)
        mat_id = torch.where(m, scene.pln_mat[i], mat_id)
    if st.n_boxes:
        m = best_type == OBJ_BOX
        i = torch.clamp(sub, 0, st.n_boxes - 1)
        n_b = box_normal(o, d, t_n, scene.box_min[i], scene.box_max[i])
        normal = torch.where(m[:, None], n_b, normal)
        mat_id = torch.where(m, scene.box_mat[i], mat_id)

    return HitResult(hit=hit, t=best_t, normal=normal,
                     obj_id=torch.where(hit, best_gid, -1),
                     mat_id=mat_id.to(torch.int32))


def hit_packed(o, d, time, row, typ, motion_blur: bool,
               types_present=(OBJ_SPHERE, OBJ_TRIANGLE, OBJ_PLANE, OBJ_BOX)):
    """Each ray against its own packed object row (accel leaves).

    ``row`` (R, >=12) packed parameters, ``typ`` (R,) type tags (-1: an
    inert slot, a miss).  Returns ``(t, normal)``, t = FLT_MAX on a miss.
    Only the types in ``types_present`` are evaluated.  Every sum and
    product is its own rounded operation, left to right, in the order of
    the packet kernels (``csrc/primitives.cuh``), so that kernel and plain
    version pick the same winners.
    """
    x = lambda a, k: a[:, k]
    dx, dy, dz = x(d, 0), x(d, 1), x(d, 2)
    ox, oy, oz = x(o, 0), x(o, 1), x(o, 2)
    R = o.shape[0]
    t = torch.full((R,), FLT_MAX, dtype=torch.float32, device=o.device)
    n = torch.zeros((R, 3), dtype=torch.float32, device=o.device)

    def take(tag, tk, nk):
        nonlocal t, n
        m = typ == tag
        t = torch.where(m, tk, t)
        n = torch.where(m[:, None], nk, n)

    if OBJ_SPHERE in types_present:
        center = row[:, 0:3]
        if motion_blur:
            center = _moved(center, time)
        oc = o - center
        a = _dot3(d, d)
        b = 2.0 * _dot3(oc, d)
        cq = _dot3(oc, oc) - row[:, 3] * row[:, 3]
        disc = b * b - 4.0 * a * cq
        sq = safe_sqrt(disc)
        t1 = (-b - sq) / (2.0 * a)
        t2 = (-b + sq) / (2.0 * a)
        ts = torch.where(t1 > EPSILON, t1, t2)
        p = o + d * ts[:, None] - center
        take(OBJ_SPHERE, _miss((disc >= 0.0) & (ts > EPSILON), ts),
             p / torch.sqrt(_dot3(p, p))[:, None])
    if OBJ_TRIANGLE in types_present:
        v0, e1, e2 = row[:, 0:3], row[:, 3:6], row[:, 6:9]
        e = lambda v, k: v[:, k]
        hx = dy * e(e2, 2) - dz * e(e2, 1)
        hy = dz * e(e2, 0) - dx * e(e2, 2)
        hz = dx * e(e2, 1) - dy * e(e2, 0)
        a = e(e1, 0) * hx + e(e1, 1) * hy + e(e1, 2) * hz
        nz = a != 0.0
        f = 1.0 / torch.where(nz, a, torch.ones_like(a))
        sx, sy, sz = ox - e(v0, 0), oy - e(v0, 1), oz - e(v0, 2)
        u = f * (sx * hx + sy * hy + sz * hz)
        qx = sy * e(e1, 2) - sz * e(e1, 1)
        qy = sz * e(e1, 0) - sx * e(e1, 2)
        qz = sx * e(e1, 1) - sy * e(e1, 0)
        v = f * (qx * dx + qy * dy + qz * dz)
        tt = f * (e(e2, 0) * qx + e(e2, 1) * qy + e(e2, 2) * qz)
        ok = (nz & (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (u + v <= 1.0)
              & (tt > EPSILON))
        gx = e(e1, 1) * e(e2, 2) - e(e1, 2) * e(e2, 1)
        gy = e(e1, 2) * e(e2, 0) - e(e1, 0) * e(e2, 2)
        gz = e(e1, 0) * e(e2, 1) - e(e1, 1) * e(e2, 0)
        g = torch.stack([gx, gy, gz], -1)
        take(OBJ_TRIANGLE, _miss(ok, tt), g / torch.sqrt(_dot3(g, g))[:, None])
    if OBJ_PLANE in types_present:
        pn = row[:, 0:3]
        denom = _dot3(d, pn)
        par = torch.abs(denom) >= EPSILON
        tp = -(_dot3(o, pn) + row[:, 3]) / torch.where(
            par, denom, torch.ones_like(denom))
        take(OBJ_PLANE, _miss(par & (tp > 0.0), tp), pn)
    if OBJ_BOX in types_present:
        bmin, bmax = row[:, 0:3], row[:, 3:6]
        inv = 1.0 / d
        ta = (bmin - o) * inv
        tb = (bmax - o) * inv
        tmin = torch.minimum(ta, tb).amax(dim=-1)
        tmax = torch.maximum(ta, tb).amin(dim=-1)
        take(OBJ_BOX, _miss((tmin <= tmax) & (tmin > EPSILON), tmin),
             box_normal(o, d, tmin, bmin, bmax))
    return t, n


def any_hit_brute(scene: SceneData, o, d, time, max_dist, exclude_obj,
                  motion_blur: bool, mode: str = "none"):
    """Occlusion test; plain version of K2.

    ``mode`` selects the occluder comparison:

    - ``none`` (main.cpp:432-440): ``1e-4 < t < max_dist``, skipping the
      object ``exclude_obj`` (-1 skips nothing);
    - ``grid`` (grid.cpp:330-352): ``t < max_dist``, no self-exclusion;
    - ``bvh`` (bvh.cpp:376): ``t <= max_dist + EPSILON``, no self-exclusion.
    """
    if mode not in ("none", "grid", "bvh"):
        raise ValueError(f"bad any-hit mode: {mode}")
    occluded = torch.zeros(o.shape[:-1], dtype=torch.bool, device=o.device)
    for _typ, gids, tmat in _type_tmats(scene, o, d, time, motion_blur):
        occluded |= occluders(tmat, max_dist, gids, exclude_obj,
                              mode).any(dim=1)
    return occluded


def occluders(tmat, max_dist, gids, exclude_obj, mode: str):
    """(R, N) bool: which objects of a t matrix occlude each shadow ray of
    length ``max_dist`` (R,), by ``mode``'s compare (:func:`any_hit_brute`);
    ``gids`` (N,) are the objects' ids for ``exclude_obj``."""
    dist = max_dist[:, None]
    if mode == "grid":
        return tmat < dist
    if mode == "bvh":
        return tmat <= dist + EPSILON
    ok = (tmat < dist) & (tmat > 1e-4)
    if exclude_obj is not None:
        ok &= gids[None, :] != exclude_obj[:, None]
    return ok
