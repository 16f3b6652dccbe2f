"""Brute-force closest hit (K1) and any hit (K2) as CUDA kernels.

Counterpart of ``distributionraytracer_tpu.ops.pallas_intersect``.  K1 and
K2 (``csrc/intersect.cu`` over ``csrc/primitives.cuh``) test the objects in
type runs (:func:`type_runs`), each lane's fold split over a group of
threads (K1: always, so that a launch fills the card; K2: where its block
holds few valid lanes), and read the callers' tensors in place.  K1 keeps
the strict-``<`` first-wins winner of the insertion-order scan: a tie in t
goes to the lower object id.  Their plain versions are
:func:`ops.intersect.closest_hit_brute` and
:func:`ops.intersect.any_hit_brute`; :func:`closest_hit_runs` and
:func:`any_hit_runs` are the kernels' folds over the type runs in plain
torch, in their operation order.

Dispatch is by the tensors' device: CPU tensors take the plain version,
CUDA tensors launch the kernel (a failed build or launch raises).  Each
launch adds one to ``LAUNCHES``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from distributionraytracer_tpu_torch.ops import build
from distributionraytracer_tpu_torch.ops.common import EPSILON, FLT_MAX
from distributionraytracer_tpu_torch.ops.intersect import (
    HitResult, any_hit_brute, box_t, closest_hit_brute, occluders, sphere_t,
)
from distributionraytracer_tpu_torch.scene.types import (
    OBJ_BOX, OBJ_PLANE, OBJ_SPHERE, OBJ_TRIANGLE, SceneData,
)
from distributionraytracer_tpu_torch.utils import spans

ANY_HIT_MODES = {"none": 0, "grid": 1, "bvh": 2}

# Kernel launches since the last reset_launches(), by kernel.
LAUNCHES = {"closest_hit": 0, "any_hit": 0}


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# K2's type runs, in the order it tests them, with each type's row width.
RUN_TYPES = (OBJ_SPHERE, OBJ_TRIANGLE, OBJ_PLANE, OBJ_BOX)
RUN_WIDTHS = (4, 12, 12, 12)


class ObjectTables(NamedTuple):
    data: torch.Tensor  # (O,12) f32, insertion order (K1's normals)
    types: torch.Tensor  # (O,) i32
    mats: torch.Tensor  # (O,) i32
    runs: torch.Tensor  # f32 rows in type runs (K1, K2), see type_runs
    ids: torch.Tensor  # (O,) i32 each run row's object id
    counts: tuple  # objects of each type of RUN_TYPES


def type_runs(data, types, n_obj: int):
    """K1's and K2's tables: ``(runs, ids, counts)``.

    ``runs`` is one flat f32 tensor: the spheres' ``[cx, cy, cz, r]`` rows
    (16 bytes), then the triangles', planes' and boxes' 12-float rows of
    ``data`` (``packed_objects``' layout), each type in insertion order;
    ``ids`` (O,) i32 gives each run row's object id, the one an excluded id
    is compared with; ``counts`` the number of each type of RUN_TYPES.
    Every row starts 16 bytes into the tensor times a whole number."""
    data, types = data[:n_obj], types[:n_obj]
    spans.host_read(types, len(RUN_TYPES))  # each nonzero reads its size
    rows, ids, counts = [], [], []
    for typ, width in zip(RUN_TYPES, RUN_WIDTHS):
        k = torch.nonzero(types == typ)[:, 0]
        rows.append(data[k, :width].reshape(-1))
        ids.append(k)
        counts.append(int(k.numel()))
    runs = torch.cat(rows).to(torch.float32).contiguous()
    if runs.numel() == 0:  # no object: one row nothing reads
        runs = data.new_zeros(4)
    return runs, torch.cat(ids).to(torch.int32).contiguous(), tuple(counts)


def object_tables(scene: SceneData) -> ObjectTables:
    spans.count("tables.builds.object_tables")
    data, types, mats = scene.packed_objects()
    runs, ids, counts = type_runs(data, types, scene.static.n_objects)
    return ObjectTables(data.contiguous(), types.contiguous(),
                        mats.contiguous(), runs, ids, counts)


def run_rows(tb: ObjectTables):
    """The runs of ``tb`` as ``(type, (n, width) rows, (n,) ids)``."""
    out, a, b = [], 0, 0
    for typ, width, n in zip(RUN_TYPES, RUN_WIDTHS, tb.counts):
        out.append((typ, tb.runs[a:a + n * width].reshape(n, width),
                    tb.ids[b:b + n]))
        a, b = a + n * width, b + n
    return out


def _run_tmat(typ: int, o, d, rows, time=None, motion_blur: bool = False):
    """(R, N) t matrix of rays (R, 3) against run rows (N, width), a miss
    FLT_MAX: every sum and product its own rounded operation, left to
    right, in the kernels' order (as :func:`ops.intersect.hit_packed`),
    so the plain folds decide every hit as K1 and K2 do.  Motion blur
    moves a sphere's centre by (0, 1, 0) * the ray's ``time``."""
    c = lambda a, k: a[:, k][:, None]  # (R,) component -> (R, 1)
    r = lambda k: rows[:, k][None, :]  # (N,) field -> (1, N)
    dx, dy, dz, ox, oy, oz = (c(d, 0), c(d, 1), c(d, 2), c(o, 0), c(o, 1),
                              c(o, 2))
    if typ == OBJ_SPHERE:
        return sphere_t(o, d, time, rows[:, 0:3], rows[:, 3], motion_blur)
    if typ == OBJ_TRIANGLE:
        hx = dy * r(8) - dz * r(7)
        hy = dz * r(6) - dx * r(8)
        hz = dx * r(7) - dy * r(6)
        a = r(3) * hx + r(4) * hy + r(5) * hz
        nz = a != 0.0
        f = 1.0 / torch.where(nz, a, torch.ones_like(a))
        sx, sy, sz = ox - r(0), oy - r(1), oz - r(2)
        u = f * (sx * hx + sy * hy + sz * hz)
        qx = sy * r(5) - sz * r(4)
        qy = sz * r(3) - sx * r(5)
        qz = sx * r(4) - sy * r(3)
        v = f * (qx * dx + qy * dy + qz * dz)
        t = f * (r(6) * qx + r(7) * qy + r(8) * qz)
        ok = (nz & (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (u + v <= 1.0)
              & (t > EPSILON))
        return torch.where(ok, t, FLT_MAX)
    if typ == OBJ_PLANE:
        denom = dx * r(0) + dy * r(1) + dz * r(2)
        par = torch.abs(denom) >= EPSILON
        t = -((ox * r(0) + oy * r(1) + oz * r(2)) + r(3)) / torch.where(
            par, denom, torch.ones_like(denom))
        return torch.where(par & (t > 0.0), t, FLT_MAX)
    return box_t(o, d, rows[:, 0:3], rows[:, 3:6])


def any_hit_runs(tb: ObjectTables, o, d, max_dist, exclude_obj,
                 mode: str = "none"):
    """K2's fold over its type runs in plain torch: occluded (R,) bool,
    shadow rays at time 0, the compares of :func:`any_hit_brute`'s
    ``mode`` with each row's object id for the excluded one.  Each test in
    the kernels' operation order (:func:`_run_tmat`), so it equals K2 on
    every lane; :func:`any_hit_brute` gives the same occlusion up to the
    rounding of torch's cross product at a triangle's edges."""
    occ = torch.zeros(o.shape[:-1], dtype=torch.bool, device=o.device)
    for typ, rows, ids in run_rows(tb):
        if rows.shape[0]:
            occ |= occluders(_run_tmat(typ, o, d, rows), max_dist, ids,
                             exclude_obj, mode).any(dim=1)
    return occ


def closest_hit_runs(tb: ObjectTables, o, d, time, motion_blur: bool):
    """K1's fold over its type runs in plain torch: ``(t, object id)``,
    (R,) f32 (FLT_MAX on a miss) and (R,) i32 (-1).  Each test in the
    kernels' operation order (:func:`_run_tmat`), and of equal t the lower
    object id wins, whatever run it is in: the winner of the
    insertion-order scan, and K1's on every lane.
    :func:`ops.intersect.closest_hit_brute` gives the same winners up to
    the rounding of torch's cross product at a triangle's edges."""
    R = o.shape[0]
    best_t = torch.full((R,), FLT_MAX, dtype=torch.float32, device=o.device)
    best = torch.full((R,), -1, dtype=torch.int32, device=o.device)
    for typ, rows, ids in run_rows(tb):
        if not rows.shape[0]:
            continue
        # a run's first minimum is its lowest id (a run ascends in id)
        t, k = torch.min(_run_tmat(typ, o, d, rows, time, motion_blur), 1)
        gid = ids[k]
        better = (t < best_t) | ((t == best_t) & (t < FLT_MAX)
                                 & (gid < best))
        best_t = torch.where(better, t, best_t)
        best = torch.where(better, gid, best)
    return best_t, best


def refuse_grad(name: str, *tensors):
    """Raise where a gradient is being recorded and a tensor requires one.

    The kernels write their outputs through raw pointers into tensors that
    carry no autograd graph, so a gradient through them would be silently
    wrong: every geometry and camera term would be missing.  Gradients go
    through ``parallel.mesh.accel_intersectors(..., differentiable=True)``,
    which runs the kernels under ``torch.no_grad()`` on detached tensors
    and recomputes the winning hits in plain torch."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: the CUDA kernel is forward-only, and a tensor it was "
            "given requires a gradient; take gradients through "
            "accel_intersectors(scene, cfg, accel, differentiable=True) "
            "(distributionraytracer_tpu_torch.parallel.mesh), or run under "
            "torch.no_grad()")


def geometry_leaves(scene: SceneData):
    """The scene leaves that ``packed_objects`` (every kernel's object
    table) is built from.  The packet and binned tables are built on the
    host from their values, so their wrappers hand these to
    :func:`refuse_grad` beside the rays."""
    return (scene.sph_center, scene.sph_radius, scene.tri_v0, scene.tri_e1,
            scene.tri_e2, scene.pln_n, scene.pln_d, scene.box_min,
            scene.box_max)


class ObjectColumns(NamedTuple):
    """What the packet and binned wrappers read of a scene besides their
    tables: each object's material, the object types present, and the
    geometry leaves they hand :func:`refuse_grad`."""

    mats: torch.Tensor  # (O,) i32: ``scene.packed_objects()[2]``
    types_present: tuple  # sorted object type tags
    geometry: tuple  # :func:`geometry_leaves`


def object_columns(scene: SceneData) -> ObjectColumns:
    """The scene's :class:`ObjectColumns` (one ``packed_objects``)."""
    return ObjectColumns(scene.packed_objects()[2],
                         tuple(sorted(set(scene.static.obj_types))),
                         geometry_leaves(scene))


def require_cuda(name: str, *tensors):
    """Raise unless every tensor is a contiguous CUDA tensor on one device
    that needs no gradient (:func:`refuse_grad`); each wrapper hands it its
    rays and every table it passes the kernel."""
    refuse_grad(name, *tensors)
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda":
            raise ValueError(f"{name}: the CUDA kernel needs CUDA tensors, "
                             f"got a tensor on {t.device}")
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensor is not contiguous")


def ray_streams(n: int, *cols) -> torch.Tensor:
    """Stack (R,) columns into one contiguous (k, R) f32 SoA tensor."""
    for c in cols:
        if c.shape != (n,):
            raise ValueError(f"expected a ({n},) stream, got {tuple(c.shape)}")
    return torch.stack([c.to(torch.float32) for c in cols]).contiguous()


def closest_outputs(R: int, device) -> HitResult:
    """Uninitialised outputs of K1, which writes every field."""
    e = lambda *shape, dtype=torch.float32: torch.empty(
        shape, dtype=dtype, device=device)
    return HitResult(hit=e(R, dtype=torch.bool), t=e(R), normal=e(R, 3),
                     obj_id=e(R, dtype=torch.int32),
                     mat_id=e(R, dtype=torch.int32))


# The launch_* functions run a kernel on inputs that are already in its
# layout; they count nothing.  The *_kernel wrappers check, launch and
# count.
def launch_closest_hit(tb: ObjectTables, o, d, time, valid,
                       motion_blur: bool, out: HitResult):
    """K1 on (R,3) o and d, (R,) f32 time and (R,) bool valid or None
    (every lane), read in place, into ``out`` (:func:`closest_outputs`)."""
    with torch.cuda.device(o.device):
        err = build.load().lib.drt_closest_hit(
            tb.runs.data_ptr(), tb.ids.data_ptr(), *tb.counts,
            tb.data.data_ptr(), tb.types.data_ptr(), tb.mats.data_ptr(),
            o.data_ptr(), d.data_ptr(), time.data_ptr(), _ptr(valid),
            o.shape[0], int(motion_blur), *(x.data_ptr() for x in out),
            torch.cuda.current_stream().cuda_stream)
    build.check(err, "drt_closest_hit")


def _ptr(t):
    return None if t is None else t.data_ptr()


def launch_any_hit(tb: ObjectTables, o, d, dist, excl, valid, mode: str,
                   occ):
    """K2 on (R,3) o and d, (R,) f32 dist, (R,) i32 excluded ids or None,
    (R,) bool valid or None (every lane) into (R,) bool, read in place."""
    with torch.cuda.device(o.device):
        err = build.load().lib.drt_any_hit(
            tb.runs.data_ptr(), tb.ids.data_ptr(), *tb.counts, o.data_ptr(),
            d.data_ptr(), dist.data_ptr(), _ptr(excl), _ptr(valid),
            o.shape[0], ANY_HIT_MODES[mode], occ.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    build.check(err, "drt_any_hit")


def closest_hit_kernel(scene: SceneData, o, d, time, motion_blur: bool,
                       valid=None, tables: Optional[ObjectTables] = None
                       ) -> HitResult:
    """K1 on CUDA tensors.  Lanes with ``valid`` false report a miss."""
    tb = tables if tables is not None else object_tables(scene)
    time = time.to(torch.float32).contiguous()
    valid = None if valid is None else valid.to(torch.bool).contiguous()
    o, d = ray_inputs("closest_hit", o, d, time, valid)
    require_cuda("closest_hit", o, tb.runs, tb.ids, tb.data, tb.types,
                 tb.mats)
    if tb.runs.data_ptr() % 16:
        raise ValueError("closest_hit: the type runs must be 16-byte "
                         "aligned")
    out = closest_outputs(o.shape[0], o.device)
    launch_closest_hit(tb, o, d, time, valid, motion_blur, out)
    LAUNCHES["closest_hit"] += 1
    return out


def ray_inputs(name: str, o, d, *cols):
    """``o`` and ``d`` as contiguous (R, 3) f32, each (R,) column as given
    (already of its type), checked for shape and device: the tensors a
    kernel reads in place (no copy where the caller's already are)."""
    R = o.shape[0]
    o = o.to(torch.float32).contiguous()
    d = d.to(torch.float32).contiguous()
    for t in (o, d):
        if t.shape != (R, 3):
            raise ValueError(f"{name}: expected ({R}, 3) rays, got "
                             f"{tuple(t.shape)}")
    for c in cols:
        if c is not None and c.shape != (R,):
            raise ValueError(f"{name}: expected a ({R},) stream, got "
                             f"{tuple(c.shape)}")
    require_cuda(name, o, d, *(c for c in cols if c is not None))
    return o, d


def any_hit_kernel(scene: SceneData, o, d, max_dist, exclude_obj,
                   motion_blur: bool, mode: str = "none", valid=None,
                   tables: Optional[ObjectTables] = None):
    """K2 on CUDA tensors; returns occluded (R,) bool.  Shadow rays carry
    time 0, where motion blur moves no sphere, so ``motion_blur`` changes
    nothing; lanes with ``valid`` false report no occluder."""
    if mode not in ANY_HIT_MODES:
        raise ValueError(f"bad any-hit mode: {mode}")
    tb = tables if tables is not None else object_tables(scene)
    dist = max_dist.to(torch.float32).contiguous()
    excl = (None if exclude_obj is None
            else exclude_obj.to(torch.int32).contiguous())
    valid = None if valid is None else valid.to(torch.bool).contiguous()
    o, d = ray_inputs("any_hit", o, d, dist, excl, valid)
    require_cuda("any_hit", o, tb.runs, tb.ids)
    if tb.runs.data_ptr() % 16:
        raise ValueError("any_hit: the type runs must be 16-byte aligned")
    occ = torch.empty((o.shape[0],), dtype=torch.bool, device=o.device)
    launch_any_hit(tb, o, d, dist, excl, valid, mode, occ)
    LAUNCHES["any_hit"] += 1
    return occ


def closest_hit(scene: SceneData, o, d, time, motion_blur: bool, valid=None,
                tables: Optional[ObjectTables] = None) -> HitResult:
    """K1: plain version for CPU tensors, the kernel for CUDA tensors."""
    if o.device.type == "cpu":
        return closest_hit_brute(scene, o, d, time, motion_blur)
    return closest_hit_kernel(scene, o, d, time, motion_blur, valid, tables)


def any_hit(scene: SceneData, o, d, max_dist, exclude_obj, motion_blur: bool,
            mode: str = "none", valid=None,
            tables: Optional[ObjectTables] = None):
    """K2: plain version for CPU tensors, the kernel for CUDA tensors."""
    if o.device.type == "cpu":
        time = torch.zeros_like(max_dist)
        return any_hit_brute(scene, o, d, time, max_dist, exclude_obj,
                             motion_blur, mode)
    return any_hit_kernel(scene, o, d, max_dist, exclude_obj, motion_blur,
                          mode, valid, tables)
