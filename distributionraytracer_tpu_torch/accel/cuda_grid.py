"""Uniform-grid scenes on the packet kernels, by emulation.

Counterpart of ``distributionraytracer_tpu.accel.pallas_grid``.  The grid's
observable semantics (grid.cpp:100-358) are a set of tested objects and
three gates, so grid scenes ride the BVH packet kernels (K7, or K8) and the
binned route (K9, and K10 for the primary shadows) instead of a per-lane DDA:

1. Tested set: the DDA tests an object iff the ray crosses a cell of the
   object's span, its AABB quantized outward to cell boundaries.  Every hit
   of a static triangle, box or sphere lies inside its true AABB, so a BVH
   over true boxes finds the same hits; planes (whose default box gates
   which rays test them, scene.h:116) and, under motion blur, moving spheres
   keep their quantized boxes (:func:`emulation_bboxes`).
2. Closest hit: cells are visited in increasing t, so the DDA's early exit
   never changes the winner; walking out of the grid drops the record,
   which is ``t < t1`` with ``t1`` the grid slab's exit; a failed slab init
   is a miss.
3. Shadow: occluded iff a tested object has ``t < dist`` (strict), and a
   failed Init_Traverse counts as shadowed (grid.cpp:321-324).

Exact-tie winners follow BVH leaf order instead of per-cell insertion order,
and rays exactly on cell faces may differ from DDA stepping: measure-zero
cases the JAX package budgets (< 2% of object ids).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from distributionraytracer_tpu_torch.accel.bvh import (
    PacketTables, build_bvh, collapse_leaves, protect_mask, thread_bvh,
)
from distributionraytracer_tpu_torch.accel.cuda_binned import (
    leveled_binned_intersectors,
)
from distributionraytracer_tpu_torch.accel.cuda_bvh import (
    PACKET_LEAF, pack_threaded, packet_intersectors,
)
from distributionraytracer_tpu_torch.accel.cuda_packet import (
    GROUPED_LEAF, pack_grouped,
)
from distributionraytracer_tpu_torch.accel.grid import (
    GridArrays, grid_slab, object_bboxes,
)
from distributionraytracer_tpu_torch.integrator.whitted import Intersectors
from distributionraytracer_tpu_torch.ops import cuda_intersect as CI
from distributionraytracer_tpu_torch.ops.common import FLT_MAX
from distributionraytracer_tpu_torch.ops.intersect import (
    HitResult, any_hit_brute, closest_hit_brute,
)
from distributionraytracer_tpu_torch.scene.types import (
    OBJ_BOX, OBJ_SPHERE, OBJ_TRIANGLE, SceneData,
)
from distributionraytracer_tpu_torch.utils import spans


class CudaGrid(NamedTuple):
    """Packet tables of the emulation tree and the grid box the gates
    read (NumPy)."""

    tabs: PacketTables
    bbox_min: np.ndarray  # (3,) f32
    bbox_max: np.ndarray  # (3,) f32
    ncells: np.ndarray  # (3,) i32

    def to(self, device) -> "CudaGrid":
        return self._replace(tabs=self.tabs.to(device))


def quantized_bboxes(scene: SceneData, grid: GridArrays) -> np.ndarray:
    """Object AABBs expanded outward to the cell boundaries they overlap,
    by the insertion pass's cell mapping (grid.cpp:80-85)."""
    bb = object_bboxes(scene).astype(np.float64)
    gmin = np.asarray(grid.bbox_min, np.float64)
    gmax = np.asarray(grid.bbox_max, np.float64)
    n = np.asarray(grid.ncells, np.float64)
    scale = n / (gmax - gmin)
    lo_cell = np.clip(np.trunc((bb[:, 0] - gmin) * scale), 0, n - 1)
    hi_cell = np.clip(np.trunc((bb[:, 1] - gmin) * scale), 0, n - 1)
    q = np.empty_like(bb)
    q[:, 0] = gmin + lo_cell / scale
    q[:, 1] = gmin + (hi_cell + 1.0) / scale
    return q.astype(np.float32)


def emulation_bboxes(scene: SceneData, grid: GridArrays,
                     motion_blur: bool = False) -> np.ndarray:
    """True AABBs where every hit lies inside them (triangles, boxes, and
    spheres without motion blur), cell-quantized boxes elsewhere."""
    true_bb = object_bboxes(scene)
    q = quantized_bboxes(scene, grid)
    types = np.array(scene.static.obj_types, np.int64)
    tight = (types == OBJ_TRIANGLE) | (types == OBJ_BOX)
    if not motion_blur:
        tight = tight | (types == OBJ_SPHERE)
    q[tight] = true_bb[tight]
    return q


def pack_grid(scene: SceneData, grid: GridArrays, motion_blur: bool = False,
              packet_kernel: str = "grouped",
              use_native: bool = True) -> CudaGrid:
    """SAH BVH over the emulation boxes, threaded, leaf-collapsed (objects
    whose hits can escape their boxes keep their own leaves) and packed for
    the selected kernel (K8's where the grouped packer refuses the tree).
    ``motion_blur`` must match the render config."""
    q = emulation_bboxes(scene, grid, motion_blur)
    tb = thread_bvh(build_bvh(scene, use_native=use_native, bboxes=q))
    prot = protect_mask(scene, motion_blur)
    tabs = None
    if packet_kernel == "grouped":
        tabs = pack_grouped(scene, collapse_leaves(tb, GROUPED_LEAF,
                                                   protect=prot))
    if tabs is None:
        tabs = pack_threaded(scene, collapse_leaves(tb, PACKET_LEAF,
                                                    protect=prot))
    return CudaGrid(tabs, np.asarray(grid.bbox_min, np.float32),
                    np.asarray(grid.bbox_max, np.float32),
                    np.asarray(grid.ncells, np.int32))


def gate_closest(pg: CudaGrid, h: HitResult, o, d) -> HitResult:
    """The grid's closest-hit gates on top of a hit: a failed slab init is
    a miss, walking out of the grid drops the record (grid.cpp:258-304).
    Recorded as an ``accel.grid_gate`` span; ``grid.gate_rays`` counts
    the query's rays."""
    with spans.span("accel.grid_gate"):
        spans.count("grid.gate_rays", o.shape[0])
        ok, *_, t1 = grid_slab(pg.bbox_min, pg.bbox_max, o, d)
        hit = h.hit & ok & (h.t < t1)
        return HitResult(hit=hit,
                         t=torch.where(hit, h.t,
                                       torch.full_like(h.t, FLT_MAX)),
                         normal=h.normal,
                         obj_id=torch.where(hit, h.obj_id,
                                            torch.full_like(h.obj_id, -1)),
                         mat_id=h.mat_id)


def gate_shadow(pg: CudaGrid, occ, o, d):
    """A failed Init_Traverse counts as shadowed (grid.cpp:321-324).
    Recorded as :func:`gate_closest` is."""
    with spans.span("accel.grid_gate"):
        spans.count("grid.gate_rays", o.shape[0])
        return occ | ~grid_slab(pg.bbox_min, pg.bbox_max, o, d)[0]


def make_brute_grid_intersectors(scene: SceneData, pg: CudaGrid,
                                 motion_blur: bool = False,
                                 plain: bool = False):
    """The cost-selected brute backend of small grid scenes: every object
    tested by K1 (closest) and K2 in grid mode (shadow), the grid's gates on
    top; the plain brute scans with ``plain``.  Exact against the DDA for
    scenes without planes or moving spheres (the renderer's cost-brute
    predicate refuses the others)."""
    tb = None if plain else CI.object_tables(scene)

    def closest(o, d, time, valid=None):
        if plain:
            h = closest_hit_brute(scene, o, d, time, motion_blur)
        else:
            h = CI.closest_hit(scene, o, d, time, motion_blur, valid=valid,
                               tables=tb)
        return gate_closest(pg, h, o, d)

    def shadow(o, d, dist, exclude_obj, valid=None):
        if plain:
            occ = any_hit_brute(scene, o, d, torch.zeros_like(dist), dist,
                                None, motion_blur, mode="grid")
        else:
            occ = CI.any_hit(scene, o, d, dist, None, motion_blur, "grid",
                             valid=valid, tables=tb)
        return gate_shadow(pg, occ, o, d)

    return Intersectors(closest, shadow)


def make_cuda_grid_intersectors(scene: SceneData, pg: CudaGrid,
                                motion_blur: bool = False, bins=None,
                                plain: bool = False):
    """The packet kernel over the emulation tree (grid shadow mode), or the
    binned route (``bins``, accel/cuda_binned.py, grid shadow mode) for the
    primary level, with the grid's gates on top of either."""
    inner = packet_intersectors(scene, pg.tabs, motion_blur,
                                shadow_mode="grid", plain=plain)
    if bins is not None:
        inner = leveled_binned_intersectors(scene, pg.tabs, bins, inner,
                                            motion_blur, plain=plain,
                                            shadow_mode="grid")
    return gated_intersectors(pg, inner)


def gated_intersectors(pg: CudaGrid, inner: Intersectors) -> Intersectors:
    """``inner`` (a walk of ``pg``'s tables in grid shadow mode) with the
    grid's gates on top of each query."""

    def closest(o, d, time, valid=None):
        return gate_closest(pg, inner.closest(o, d, time, valid=valid), o, d)

    def shadow(o, d, dist, exclude_obj, valid=None):
        return gate_shadow(pg, inner.shadow(o, d, dist, exclude_obj,
                                            valid=valid), o, d)

    return Intersectors(closest, shadow)
