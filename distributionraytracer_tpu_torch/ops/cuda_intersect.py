"""Brute-force closest hit (K1) and any hit (K2) as CUDA kernels.

Counterpart of ``distributionraytracer_tpu.ops.pallas_intersect``.  The
kernels (``csrc/intersect.cu`` over ``csrc/primitives.cuh``) walk the packed
``(O, 12)`` object table in insertion order with the strict-``<`` first-wins
update, one thread per ray.  Their plain versions are
:func:`ops.intersect.closest_hit_brute` and :func:`ops.intersect.any_hit_brute`.

Dispatch is by the tensors' device: CPU tensors take the plain version,
CUDA tensors launch the kernel (a failed build or launch raises).  Each
launch adds one to ``LAUNCHES``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from distributionraytracer_tpu_torch.ops import build
from distributionraytracer_tpu_torch.ops.common import FLT_MAX
from distributionraytracer_tpu_torch.ops.intersect import (
    HitResult, any_hit_brute, closest_hit_brute,
)
from distributionraytracer_tpu_torch.scene.types import SceneData

ANY_HIT_MODES = {"none": 0, "grid": 1, "bvh": 2}

# Kernel launches since the last reset_launches(), by kernel.
LAUNCHES = {"closest_hit": 0, "any_hit": 0}


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


class ObjectTables(NamedTuple):
    data: torch.Tensor  # (O,12) f32
    types: torch.Tensor  # (O,) i32
    mats: torch.Tensor  # (O,) i32


def object_tables(scene: SceneData) -> ObjectTables:
    data, types, mats = scene.packed_objects()
    return ObjectTables(data.contiguous(), types.contiguous(),
                        mats.contiguous())


def require_cuda(name: str, *tensors):
    """Raise unless every tensor is a contiguous CUDA tensor on one device."""
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


def _valid_stream(valid, like):
    if valid is None:
        return torch.ones_like(like)
    return valid.to(torch.float32)


# The launch_* functions run a kernel on streams that are already packed;
# they count nothing.  The *_kernel wrappers pack, launch and count.
def launch_closest_hit(tb: ObjectTables, n_obj: int, rays, motion_blur: bool,
                       out_f, out_i):
    """K1 on packed (8, R) rays into (4, R) f32 and (2, R) i32 outputs."""
    with torch.cuda.device(rays.device):
        err = build.load().lib.drt_closest_hit(
            tb.data.data_ptr(), tb.types.data_ptr(), tb.mats.data_ptr(),
            n_obj, rays.data_ptr(), rays.shape[1],
            int(motion_blur), out_f.data_ptr(), out_i.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    build.check(err, "drt_closest_hit")


def launch_any_hit(tb: ObjectTables, n_obj: int, rays, excl, mode: str,
                   motion_blur: bool, occ):
    """K2 on packed (8, R) rays and (R,) i32 excluded ids into (R,) bool."""
    with torch.cuda.device(rays.device):
        err = build.load().lib.drt_any_hit(
            tb.data.data_ptr(), tb.types.data_ptr(), n_obj,
            rays.data_ptr(), excl.data_ptr(), rays.shape[1],
            ANY_HIT_MODES[mode], int(motion_blur), occ.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    build.check(err, "drt_any_hit")


def closest_hit_kernel(scene: SceneData, o, d, time, motion_blur: bool,
                       valid=None, tables: Optional[ObjectTables] = None
                       ) -> HitResult:
    """K1 on CUDA tensors.  Lanes with ``valid`` false report a miss."""
    R = o.shape[0]
    tb = tables if tables is not None else object_tables(scene)
    rays = ray_streams(R, o[:, 0], o[:, 1], o[:, 2], d[:, 0], d[:, 1],
                       d[:, 2], time, _valid_stream(valid, time))
    require_cuda("closest_hit", rays, tb.data, tb.types, tb.mats)
    out_f = torch.empty((4, R), dtype=torch.float32, device=rays.device)
    out_i = torch.empty((2, R), dtype=torch.int32, device=rays.device)
    launch_closest_hit(tb, scene.static.n_objects, rays, motion_blur, out_f,
                       out_i)
    LAUNCHES["closest_hit"] += 1
    t = out_f[0]
    return HitResult(hit=t < FLT_MAX, t=t, normal=out_f[1:4].T,
                     obj_id=out_i[0], mat_id=out_i[1])


def any_hit_kernel(scene: SceneData, o, d, max_dist, exclude_obj,
                   motion_blur: bool, mode: str = "none", valid=None,
                   tables: Optional[ObjectTables] = None):
    """K2 on CUDA tensors; returns occluded (R,) bool.  Shadow rays carry
    time 0; lanes with ``valid`` false report no occluder."""
    if mode not in ANY_HIT_MODES:
        raise ValueError(f"bad any-hit mode: {mode}")
    R = o.shape[0]
    tb = tables if tables is not None else object_tables(scene)
    rays = ray_streams(R, o[:, 0], o[:, 1], o[:, 2], d[:, 0], d[:, 1],
                       d[:, 2], max_dist, _valid_stream(valid, max_dist))
    if exclude_obj is None:
        exclude_obj = torch.full((R,), -1, dtype=torch.int32,
                                 device=rays.device)
    excl = exclude_obj.to(torch.int32).contiguous()
    require_cuda("any_hit", rays, excl, tb.data, tb.types)
    occ = torch.empty((R,), dtype=torch.bool, device=rays.device)
    launch_any_hit(tb, scene.static.n_objects, rays, excl, mode, motion_blur,
                   occ)
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
