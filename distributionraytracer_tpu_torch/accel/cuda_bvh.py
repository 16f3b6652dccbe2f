"""Packet traversal of the threaded BVH: K8's tables, and the wrappers of
K7 and K8.

Counterpart of ``distributionraytracer_tpu.accel.pallas_bvh``.
:func:`pack_threaded` packs a leaf-collapsed :class:`ThreadedBVH` into the
packet tables (object slots in ``obj_order``).  It takes every tree: the
JAX package refuses a leaf of 128 or more objects and first-object offsets
past 2^24 / 128, limits of its f32-valued integers that the port's int32
records do not have, so K8 also takes the trees the JAX package walks by
its XLA threaded route (``bvh-xla``).

:func:`packet_intersectors` is the counterpart of both
``make_pallas_bvh_intersectors`` (K8) and ``pallas_packet.
make_grouped_intersectors`` (K7, whose tables ``accel/cuda_packet.py``
packs), as the JAX renderer's ``packet_intersectors`` dispatches between
them: the tables' ``kind`` selects the kernel of ``csrc/bvh.cu`` on CUDA
tensors (K7 on grouped tables, K8 on threaded ones; both run one per-lane
walk, which beat the JAX package's warp-packet union walk on K8's tables);
CPU tensors take the plain version, :func:`accel.bvh.threaded_walk`.  The
two kernels compute the same function and differ in their tables.  Each
launch adds one to ``LAUNCHES`` under its kernel's name and query
(``grouped_closest``, ``legacy_shadow``, ...).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from distributionraytracer_tpu_torch.accel.bvh import (
    PacketTables, ThreadedBVH, hit_result, pack_nodes, pack_slots,
    threaded_walk,
)
from distributionraytracer_tpu_torch.integrator.whitted import Intersectors
from distributionraytracer_tpu_torch.ops import build
from distributionraytracer_tpu_torch.ops.cuda_intersect import (
    ObjectColumns, object_columns, ray_streams, refuse_grad, require_cuda,
)
from distributionraytracer_tpu_torch.scene.types import SceneData

# Leaf size the packet tables are collapsed to (bvh.collapse_leaves).
PACKET_LEAF = 16

WALKS = {"grouped": 0, "threaded": 1}  # PacketTables.kind -> csrc walk
LAUNCH_NAMES = {"grouped": "grouped", "threaded": "legacy"}

# Kernel launches since the last reset_launches(): K7 and K8, by query.
LAUNCHES = {f"{w}_{q}": 0 for w in ("grouped", "legacy")
            for q in ("closest", "shadow")}


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def packed_objects_np(scene: SceneData):
    """NumPy copies of ``scene.packed_objects()``: (O,12) f32 data, (O,)
    i32 types, (O,) i32 materials."""
    data, types, mats = (x.detach().cpu().numpy()
                         for x in scene.packed_objects())
    return data, types.astype(np.int32), mats.astype(np.int32)


def pack_threaded(scene: SceneData, tb: ThreadedBVH) -> PacketTables:
    """K8's tables from a (leaf-collapsed) threaded tree."""
    meta = np.asarray(tb.node_meta, np.int64)
    data, types, _ = packed_objects_np(scene)
    nodes = pack_nodes(np.asarray(tb.node_box, np.float32), meta[:, 0],
                       meta[:, 1], meta[:, 2])
    objs = pack_slots(data, types, np.asarray(tb.obj_order, np.int64))
    return PacketTables("threaded", torch.from_numpy(nodes),
                        torch.from_numpy(objs))


def from_jax_threaded(scene: SceneData, node_box, node_meta, obj_order
                      ) -> PacketTables:
    """K8's tables from the JAX package's threaded arrays (NumPy), so that
    both packages walk the same tree."""
    return pack_threaded(scene, ThreadedBVH(
        np.asarray(node_box, np.float32), np.asarray(node_meta, np.int32),
        np.asarray(obj_order, np.int32)))


# ------------------------------------------------------------ kernel launch
def launch_packet_closest(tabs: PacketTables, rays, motion_blur: bool,
                          out_f, out_i):
    """K7 or K8 closest hit on packed (8, R) rays into (4, R) f32 and (R,)
    i32 outputs; counts nothing."""
    with torch.cuda.device(rays.device):
        err = build.load().lib.drt_packet_closest(
            tabs.nodes.data_ptr(), tabs.n_nodes, tabs.objs.data_ptr(),
            rays.data_ptr(), rays.shape[1], int(motion_blur),
            WALKS[tabs.kind], out_f.data_ptr(), out_i.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    build.check(err, "drt_packet_closest")


def launch_packet_shadow(tabs: PacketTables, rays, motion_blur: bool,
                         shadow_mode: str, occ):
    """K7 or K8 any hit on packed (8, R) rays into (R,) bool; counts
    nothing."""
    with torch.cuda.device(rays.device):
        err = build.load().lib.drt_packet_shadow(
            tabs.nodes.data_ptr(), tabs.n_nodes, tabs.objs.data_ptr(),
            rays.data_ptr(), rays.shape[1], int(motion_blur),
            WALKS[tabs.kind], int(shadow_mode == "grid"), occ.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    build.check(err, "drt_packet_shadow")


def _rays(o, d, t, valid):
    R = o.shape[0]
    v = (torch.ones_like(t) if valid is None else valid.to(torch.float32))
    return ray_streams(R, o[:, 0], o[:, 1], o[:, 2], d[:, 0], d[:, 1],
                       d[:, 2], t, v)


def packet_closest_kernel(tabs: PacketTables, o, d, time, valid=None,
                          motion_blur: bool = False):
    """K7/K8 closest hit on CUDA tensors: (t, normal, object id)."""
    rays = _rays(o, d, time, valid)
    require_cuda("packet_closest", rays, tabs.nodes, tabs.objs)
    R = o.shape[0]
    out_f = torch.empty((4, R), dtype=torch.float32, device=rays.device)
    out_i = torch.empty((R,), dtype=torch.int32, device=rays.device)
    launch_packet_closest(tabs, rays, motion_blur, out_f, out_i)
    LAUNCHES[LAUNCH_NAMES[tabs.kind] + "_closest"] += 1
    return out_f[0], out_f[1:4].T, out_i


def packet_shadow_kernel(tabs: PacketTables, o, d, dist, valid=None,
                         motion_blur: bool = False,
                         shadow_mode: str = "bvh"):
    """K7/K8 any hit on CUDA tensors: occluded (R,) bool."""
    rays = _rays(o, d, dist, valid)
    require_cuda("packet_shadow", rays, tabs.nodes, tabs.objs)
    occ = torch.empty((o.shape[0],), dtype=torch.bool, device=rays.device)
    launch_packet_shadow(tabs, rays, motion_blur, shadow_mode, occ)
    LAUNCHES[LAUNCH_NAMES[tabs.kind] + "_shadow"] += 1
    return occ


def packet_intersectors(scene: SceneData, tabs: PacketTables,
                        motion_blur: bool = False, shadow_mode: str = "bvh",
                        plain: bool = False,
                        cols: Optional[ObjectColumns] = None):
    """Closest and shadow over ``tabs``: the kernel of its kind (K7 or K8)
    for CUDA tensors, the plain walk for CPU tensors or with ``plain``.
    ``cols`` are the scene's :func:`object_columns` where the caller keeps
    them.  The kernels refuse a scene whose geometry requires a gradient:
    the host-built tables would not carry it (``refuse_grad``)."""
    mats, types_present, geometry = (object_columns(scene) if cols is None
                                     else cols)

    def use_plain(o):
        return plain or o.device.type == "cpu"

    def closest(o, d, time, valid=None):
        if use_plain(o):
            t, n, gid = threaded_walk(tabs, o, d, time, valid,
                                      motion_blur=motion_blur,
                                      types_present=types_present)
        else:
            refuse_grad("packet_closest", *geometry)
            t, n, gid = packet_closest_kernel(tabs, o, d, time, valid,
                                              motion_blur)
        return hit_result(t, n, gid, mats)

    def shadow(o, d, dist, exclude_obj, valid=None):
        del exclude_obj  # the accelerated shadows have no self-exclusion
        if use_plain(o):
            return threaded_walk(tabs, o, d, None, valid, shadow_dist=dist,
                                 shadow_mode=shadow_mode,
                                 motion_blur=motion_blur,
                                 types_present=types_present)
        refuse_grad("packet_shadow", *geometry)
        return packet_shadow_kernel(tabs, o, d, dist, valid, motion_blur,
                                    shadow_mode)

    return Intersectors(closest, shadow)

