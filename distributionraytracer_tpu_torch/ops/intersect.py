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


def _unit(v):
    """``v / |v|`` in the kernels' order; a zero vector stays zero instead
    of 0/0, so that its backward gives no NaN (:func:`hit_packed` evaluates
    each type's formula on every lane, where the triangle normal of a
    sphere's, plane's or box's row is the zero vector)."""
    vv = _dot3(v, v)
    return v / torch.sqrt(torch.where(vv > 0.0, vv, 1.0))[..., None]


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
def _slab_t(bound, o, d):
    """``(bound - o) * (1 / d)``, an infinity (or NaN) on a zero component
    of ``d`` as in IEEE, with no gradient through those components: the
    backward of an infinite factor is 0 * inf = NaN even where the value is
    never selected (a dead lane's, or another type's row in
    :func:`hit_packed`)."""
    nz = d != 0.0
    ieee = ((bound - o) * (1.0 / d)).detach()
    return torch.where(nz, (bound - o) * (1.0 / torch.where(nz, d, 1.0)),
                       ieee)


def slab_interval(bmin, bmax, o, d):
    """``(t_enter, t_exit)`` of rays through axis-aligned boxes, the slab
    test of scene.cpp:218-258 (broadcast over the leading axes)."""
    ta, tb = _slab_t(bmin, o, d), _slab_t(bmax, o, d)
    return (torch.minimum(ta, tb).amax(dim=-1),
            torch.maximum(ta, tb).amin(dim=-1))


def box_t(o, d, bmin, bmax):
    """Axis-aligned box slab-test t matrix (R,N) (scene.cpp:218-258)."""
    tmin, tmax = slab_interval(bmin[None, :, :], bmax[None, :, :],
                               o[:, None, :], d[:, None, :])
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


def closest_hit_brute(scene: SceneData, o, d, time, motion_blur: bool,
                      exclude_obj=None) -> HitResult:
    """Linear scan over every object, returning the reference's winner.

    Cross-type ties resolve by smallest global object id, matching the
    insertion-order scan of main.cpp:315-326.  Plain version of K1.

    ``exclude_obj`` (optional (R,) int): a per-ray object id to skip, -1
    skipping nothing: the "scene without this pixel's winner" query that
    the soft-silhouette estimator blends against
    (:func:`integrator.whitted.trace_whitted_soft`).
    """
    st = scene.static
    R, dev = o.shape[0], o.device
    best_t = torch.full((R,), FLT_MAX, dtype=torch.float32, device=dev)
    best_gid = torch.full((R,), -1, dtype=torch.int32, device=dev)
    best_type = torch.full((R,), -1, dtype=torch.int32, device=dev)
    for typ, gids, tmat in _type_tmats(scene, o, d, time, motion_blur):
        if exclude_obj is not None:
            tmat = _miss(gids[None, :] != exclude_obj[:, None], tmat)
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


def soft_visibility(scene: SceneData, o, d, time, max_dist, exclude_obj,
                    tau: float, motion_blur: bool):
    """Smooth shadow visibility in [0, 1]: the shadow-edge gradient
    estimator.

    Hard occlusion ``prod_i 1[ray misses i]`` is a step function of the
    occluders' parameters: its expected derivative at a shadow edge is a
    boundary term that pointwise autodiff through ``where`` never produces
    (the reference's shadow gate, main.cpp:383-451, has the same step; it
    just never differentiates).  Each occluder's indicator becomes a
    sigmoid of a signed world-space margin that is smooth in every
    parameter and crosses zero at the silhouette (exact as tau -> 0):

    - sphere: ``r - b``, b the ray's closest approach to the centre;
    - triangle: the smallest of (barycentric coordinate x its height) at
      the ray/plane intersection, the world distance to the nearest edge,
      negative outside;
    - box: ``t_exit - t_enter`` of the slab test, negative on a miss;
    - plane: no silhouette, kept hard.

    Uses correct shadow semantics (normalized direction, true light
    distance) whatever ``shadow_mode`` is: a training estimator, not a
    reference-fidelity path.  A brute scan in plain torch on any device,
    as the JAX package's is a jnp scan outside its kernels.
    """
    st = scene.static
    vis = torch.ones(o.shape[0], dtype=torch.float32, device=o.device)
    excl = exclude_obj[:, None]
    dist = max_dist[:, None]

    def fold(occ, gate, typ):
        nonlocal vis
        gate = gate & (_type_gids(scene, typ, o.device)[None, :] != excl)
        vis = vis * torch.prod(1.0 - torch.where(gate, occ, 0.0), dim=1)

    if st.n_spheres:
        c = scene.sph_center[None, :, :]
        if motion_blur:
            c = _moved(c, time[:, None])
        oc = c - o[:, None, :]  # (R,N,3)
        proj = torch.einsum("rnk,rk->rn", oc, d)
        b = torch.sqrt(torch.clamp(dot(oc, oc) - proj * proj, min=1e-12))
        fold(torch.sigmoid((scene.sph_radius[None, :] - b) / tau),
             (proj > 1e-4) & (proj < dist), OBJ_SPHERE)

    if st.n_triangles:
        v0, e1, e2 = scene.tri_v0, scene.tri_e1, scene.tri_e2
        n = cross(e1, e2)  # (T,3), length = 2 * area
        denom = torch.einsum("rk,nk->rn", d, n)
        ok = torch.abs(denom) > 1e-12
        safe = torch.where(ok, denom, 1e-12)
        tpl = torch.einsum("nk,rnk->rn", n, v0[None] - o[:, None, :]) / safe
        rel = o[:, None, :] + d[:, None, :] * tpl[..., None] - v0[None]
        margin = _edge_margin(rel, e1[None], e2[None], n[None])
        t = _miss(ok, tpl)
        fold(torch.sigmoid(margin / tau), (t < dist) & (t > 1e-4),
             OBJ_TRIANGLE)

    if st.n_boxes:
        tmin, tmax = slab_interval(scene.box_min[None], scene.box_max[None],
                                   o[:, None, :], d[:, None, :])
        fold(torch.sigmoid((tmax - tmin) / tau),
             (tmin < dist) & (tmin > 1e-4), OBJ_BOX)

    if st.n_planes:  # infinite: no silhouette, hard occlusion
        t = plane_t(o, d, scene.pln_n, scene.pln_d)
        gids = _type_gids(scene, OBJ_PLANE, o.device)
        hit = ((t < dist) & (t > 1e-4) & (gids[None, :] != excl)).any(dim=1)
        vis = vis * (1.0 - hit.to(torch.float32))
    return vis


def _edge_margin(rel, e1, e2, n):
    """Signed world distance from points ``rel`` (relative to v0, in the
    triangle's plane) to the triangle's nearest edge, positive inside:
    barycentrics from the 2x2 metric, each times its triangle height."""
    d11, d22, d12 = dot(e1, e1), dot(e2, e2), dot(e1, e2)
    r1, r2 = dot(rel, e1), dot(rel, e2)
    det = torch.clamp(d11 * d22 - d12 * d12, min=1e-20)
    u = (d22 * r1 - d12 * r2) / det
    v = (d11 * r2 - d12 * r1) / det
    w = 1.0 - u - v
    a2 = torch.linalg.norm(n, dim=-1)  # 2 * area
    h = lambda e: a2 / torch.clamp(torch.linalg.norm(e, dim=-1), min=1e-12)
    return torch.minimum(torch.minimum(u * h(e2), v * h(e1)), w * h(e2 - e1))


def triangle_edge_margin(o, d, v0, e1, e2):
    """Signed world distance from the ray/plane intersection point to the
    nearest edge of a per-ray triangle (positive inside, negative
    outside).  Inputs are (R,3): one triangle per ray (the gathered
    winner's).  Smooth away from degenerate triangles; its zero crossing is
    the triangle's silhouette along the ray.  Returns ``(margin (R,),
    t (R,))``, t the ray/plane parameter."""
    n = cross(e1, e2)
    denom = dot(d, n)
    safe = torch.where(torch.abs(denom) > 1e-12, denom, 1e-12)
    t = dot(n, v0 - o) / safe
    return _edge_margin(o + d * t[..., None] - v0, e1, e2, n), t


def aabb_entry_t(o, d, bmin, bmax):
    """``AABB::hit`` (boundingBox.cpp:64-124): ``(hit, t)``, t the largest
    entry, or the exit when the origin is inside (``t = t1 if t0 < 0``)."""
    t0, t1 = slab_interval(bmin, bmax, o, d)
    return (t0 < t1) & (t1 > 0), torch.where(t0 < 0, t1, t0)


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
             _unit(p))
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
        take(OBJ_TRIANGLE, _miss(ok, tt), _unit(g))
    if OBJ_PLANE in types_present:
        pn = row[:, 0:3]
        denom = _dot3(d, pn)
        par = torch.abs(denom) >= EPSILON
        tp = -(_dot3(o, pn) + row[:, 3]) / torch.where(
            par, denom, torch.ones_like(denom))
        take(OBJ_PLANE, _miss(par & (tp > 0.0), tp), pn)
    if OBJ_BOX in types_present:
        bmin, bmax = row[:, 0:3], row[:, 3:6]
        tmin, tmax = slab_interval(bmin, bmax, o, d)
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
