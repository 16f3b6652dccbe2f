"""Binned rays: K9 streams each primary chain's candidate object groups, K10
each primary shadow chain's occluder groups.

Counterpart of ``distributionraytracer_tpu.accel.pallas_binned``.  Every
ray of a 128-lane chain goes through a known pixel rectangle
(``integrator/render.py::_block_perm``), so a host-side conservative
screen projection of the grouped tables' 8-object groups gives each chain
its complete candidate list, sorted front to back by a lower bound of any
member's hit distance from the eye.  K9 (``csrc/binned.cu``) streams the
list and stops once every live lane's best hit is nearer than the next
group; its plain version, :func:`binned_closest_plain`, streams the same
lists in torch.  The result is the strict-< closest hit over a superset of
the objects a primary ray can hit, ties going to the earlier candidate.
K9 splits each chain's list into segments of at most ``SEGMENT_GROUPS``
groups that warps all over the card stream, each stopping against the best
hit found so far, and merges their winners by (t, list position);
:func:`closest_work_plain` and :func:`closest_units_plain` are the plain
versions of its work list, :func:`binned_closest_segments_plain` of its
segmented stream.

Shadow rays all point at a light.  :func:`build_light_bins` tiles each
point light's view of the scene box K x K (a shadow-map parametrization)
and bins every group into the tiles its box covers, each tile's groups
sorted by their least distance from the light.  A shadow chain (one light,
128 origins near each other) tests the groups of the tile rectangle its
live origins cover that are no farther from the light than its farthest
origin: an occluder on the segment from an origin to the light lies in
the origin's tile and nearer the light.  K10 (``csrc/binned.cu``) and its
plain version :func:`binned_shadow_plain` compute that any-hit, with the
BVH compare ``t <= dist + EPSILON`` or the grid's ``t < dist``.  The
chains' streams are skewed (a few hold thousands of entries), so K10
splits each into work items of at most ``ITEM_ENTRIES`` entries that warps
all over the card take and OR into the output; :func:`shadow_work_plain`
and :func:`shadow_item_entries` are the plain versions of its work list.

Eligibility (:func:`binned_supported`) is the JAX package's: no infinite
planes (their default boxes gate which rays test them), no motion blur
(moving spheres escape their static boxes), no depth of field (its
primaries do not share the pinhole projection).  The light bins also need
every light punctual (:func:`shadow_binning_ok`) and outside the scene box
(1.05 units for grid scenes, whose shadow window is the unit direction).
The route takes K10 only while ``SHADOW_BINNING`` is set; it is off, as in
the JAX package, whose TPU measurements found the packet walk faster.

Three defects of the reference are not copied: the candidate total is
capped (``MAX_CANDIDATES``; past it the frame takes the packet route), the
candidate arrays are padded to a bucket, not to their exact length, and a
shadow batch whose per-light runs do not fill whole chains goes to the
packet walk instead of taking light 0 for every lane.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from distributionraytracer_tpu_torch.accel.bvh import PacketTables, hit_result
from distributionraytracer_tpu_torch.accel.grid import object_bboxes
from distributionraytracer_tpu_torch.integrator.render import _block_perm
from distributionraytracer_tpu_torch.integrator.whitted import Intersectors
from distributionraytracer_tpu_torch.ops import build
from distributionraytracer_tpu_torch.ops.common import EPSILON, FLT_MAX
from distributionraytracer_tpu_torch.ops.cuda_intersect import (
    ObjectColumns, object_columns, ray_inputs, refuse_grad, require_cuda,
)
from distributionraytracer_tpu_torch.ops.intersect import hit_packed
from distributionraytracer_tpu_torch.scene.types import (
    ACCEL_GRID, OBJ_BOX, OBJ_PLANE, OBJ_SPHERE, OBJ_TRIANGLE, SceneData,
)
from distributionraytracer_tpu_torch.utils import spans

LANES = 128  # rays per chain
GROUP = 8  # object slots per group
PAD_PX = 2.0  # conservative screen-projection padding (pixel jitter + 1)
MAX_CHAINS = 16384  # past this many chains the packet walk takes the frame
MAX_CANDIDATES = 1 << 24  # (chain, group) pairs kept at most
P_BUCKET = 16384  # candidate arrays are padded to a multiple of this
LIGHT_K = 128  # light-frustum tiles per axis
SHADOW_PAIRS = 1 << 17  # (lane, entry) pairs a step of binned_shadow_plain
# K9: candidate groups a segment at most; csrc/binned.cu's kSegGroups,
# which the kernel uses (chosen by measurement, PERF.md)
SEGMENT_GROUPS = 32
# K10: stream positions (bin entries) a work item at most; csrc/binned.cu's
# kItemEntries, which the kernel uses (chosen by measurement, PERF.md)
ITEM_ENTRIES = 128
# The renderer builds light bins (and routes the primary shadow query to
# K10) only while this is set.  Off, as in the JAX package.
SHADOW_BINNING = False

# Kernel launches since the last reset_launches().
LAUNCHES = {"binned_closest": 0, "binned_shadow": 0}


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def group_boxes(scene: SceneData, tabs: PacketTables) -> np.ndarray:
    """(G, 7) f32 ``[min3, max3, n_members]``: the true-AABB union of each
    object group of the grouped tables."""
    ints = tabs.objs.view(torch.int32).cpu().numpy()
    types = ints[:, 12].reshape(-1, GROUP)
    ids = ints[:, 13].astype(np.int64).reshape(-1, GROUP)
    live = types >= 0
    bb = object_bboxes(scene)
    mb = bb[np.clip(ids, 0, max(bb.shape[0] - 1, 0))]  # (G, 8, 2, 3)
    out = np.empty((types.shape[0], 7), np.float32)
    out[:, 0:3] = np.where(live[:, :, None], mb[:, :, 0, :],
                           np.float32(np.inf)).min(axis=1)
    out[:, 3:6] = np.where(live[:, :, None], mb[:, :, 1, :],
                           np.float32(-np.inf)).max(axis=1)
    out[:, 6] = live.sum(axis=1)
    return out


def _host_camera(scene: SceneData):
    """NumPy float64 twin of scene.types.derive_camera (camera.h:44-57)."""
    st = scene.static
    spans.host_read(scene.cam_eye, 3)
    g = lambda a: a.detach().cpu().numpy().astype(np.float64)
    eye, at, up = g(scene.cam_eye), g(scene.cam_at), g(scene.cam_up)
    n = eye - at
    pd = np.linalg.norm(n)
    n = n / pd
    u = np.cross(up, n)
    u = u / np.linalg.norm(u)
    v = np.cross(n, u)
    h = 2.0 * pd * np.tan((np.pi * st.fovy / 180.0) / 2.0)
    w = (st.res_x / st.res_y) * h
    return eye, u, v, n, pd, w, h


def _chain_grid(H: int, W: int, S: int, perm: Optional[np.ndarray] = None):
    """The chain-to-pixel-rectangle structure of ``_block_perm``:
    ``(rw, rh, grid)`` where chains tile the image in (rh, rw) pixel
    rectangles and ``grid[y // rh, x // rw]`` is the chain owning pixel
    (x, y); None when it is no uniform tiling (odd S, resolutions that do
    not divide), and such frames take the packet route.  ``perm`` is
    ``_block_perm(H, W, S)`` where the caller holds it."""
    spans.count("tables.builds.chain_grid")
    if S > LANES or (LANES % S) != 0:
        return None
    if perm is None:
        perm = _block_perm(H, W, S)
    R = perm.shape[0]
    if R % LANES:
        return None
    C = R // LANES
    pix = perm.reshape(C, LANES) // S
    xs, ys = pix % W, pix // W
    x0, x1 = xs.min(axis=1), xs.max(axis=1)
    y0, y1 = ys.min(axis=1), ys.max(axis=1)
    rw, rh = int(x1[0] - x0[0] + 1), int(y1[0] - y0[0] + 1)
    if (W % rw) or (H % rh):
        return None
    if not (np.all(x1 - x0 + 1 == rw) and np.all(y1 - y0 + 1 == rh)):
        return None
    grid = np.full((H // rh, W // rw), -1, np.int64)
    grid[y0 // rh, x0 // rw] = np.arange(C)
    if (grid < 0).any():
        return None
    return rw, rh, grid


class PrimaryBins(NamedTuple):
    """Per-frame chain candidates (host-built, camera-dependent): chain c's
    groups are ``cand[chain_start[c]:chain_start[c + 1]]``, ascending in
    ``cand_dist``, a lower bound of the eye distance of any member's hit.
    ``cand`` and ``cand_dist`` are padded to a multiple of ``P_BUCKET``."""

    chain_start: torch.Tensor  # (C+1,) i32
    cand: torch.Tensor  # (P,) i32 group ids
    cand_dist: torch.Tensor  # (P,) f32

    @property
    def n_chains(self) -> int:
        return self.chain_start.shape[0] - 1

    def to(self, device) -> "PrimaryBins":
        return PrimaryBins(*(t.to(device) for t in self))


def _corners(bmin, bmax):
    """(8, G, 3) corners of the boxes [bmin, bmax] (G, 3); (8, 1, 3) for
    one box (3,)."""
    return np.stack([np.where((np.arange(8)[:, None] >> k) & 1,
                              bmax[..., k][None, ...], bmin[..., k][None, ...])
                     for k in range(3)], axis=-1)


def build_primary_bins(scene: SceneData, gbox: np.ndarray, H: int, W: int,
                       S: int, chain_grid=None) -> Optional[PrimaryBins]:
    """Conservative screen binning of the object groups to the chains.

    Each group's 8 box corners are projected through the exact inverse of
    the pinhole mapping (ops/camera.py::primary_rays); the padded screen
    box covers every pixel whose primary ray can hit a member (the
    projection of a convex hull contains its points' projections).  A group
    with a corner at or behind the eye plane goes into every chain's list.
    None where the chain structure is no uniform tiling, or past
    ``MAX_CHAINS`` chains or ``MAX_CANDIDATES`` pairs.  ``chain_grid`` is
    ``_chain_grid(H, W, S)`` where the caller keeps it (else built here).
    """
    cg = _chain_grid(H, W, S) if chain_grid is None else chain_grid
    if cg is None:
        return None
    rw, rh, grid = cg
    C = grid.size
    if C > MAX_CHAINS:
        return None
    eye, u, v, n, pd, w, h = _host_camera(scene)
    gids = np.nonzero(gbox[:, 6] > 0)[0]
    if gids.size == 0:
        return _finish_primary_bins(np.zeros((C + 1,), np.int64),
                                    np.zeros((0,), np.int32),
                                    np.zeros((0,), np.float32))
    bmin = gbox[gids, 0:3].astype(np.float64)
    bmax = gbox[gids, 3:6].astype(np.float64)
    # 8 corners -> viewport coordinates (a ray through viewport (px, py)
    # has direction ~ u*w*(px/W - .5) + v*h*(py/H - .5) - n*pd)
    vec = _corners(bmin, bmax) - eye
    a, b, c = vec @ u, vec @ v, vec @ n
    front = c < -1e-9  # the camera looks along -n
    s = np.where(front, -c / pd, 1.0)
    px = (a / (s * w) + 0.5) * W
    py = (b / (s * h) + 0.5) * H
    unbounded = ~front.all(axis=0)
    px0 = np.where(unbounded, 0.0, px.min(axis=0) - PAD_PX)
    px1 = np.where(unbounded, W - 1.0, px.max(axis=0) + PAD_PX)
    py0 = np.where(unbounded, 0.0, py.min(axis=0) - PAD_PX)
    py1 = np.where(unbounded, H - 1.0, py.max(axis=0) + PAD_PX)
    keep = np.nonzero((px1 >= 0) & (px0 <= W - 1) & (py1 >= 0)
                      & (py0 <= H - 1))[0]
    gids = gids[keep]
    gx0 = np.clip(px0[keep], 0, W - 1).astype(np.int64) // rw
    gx1 = np.clip(px1[keep], 0, W - 1).astype(np.int64) // rw
    gy0 = np.clip(py0[keep], 0, H - 1).astype(np.int64) // rh
    gy1 = np.clip(py1[keep], 0, H - 1).astype(np.int64) // rh
    # eye-to-box distance: a lower bound of any member hit's t (primary
    # directions are unit, so t is a distance)
    dv = np.maximum(np.maximum(bmin[keep] - eye, eye - bmax[keep]), 0.0)
    gdist = np.sqrt((dv * dv).sum(axis=1)).astype(np.float32)
    ngx, ngy = gx1 - gx0 + 1, gy1 - gy0 + 1
    cnt = ngx * ngy
    total = int(cnt.sum())
    if total > MAX_CANDIDATES:
        return None
    rep = np.repeat(np.arange(gids.size), cnt)
    k = np.arange(total) - np.repeat(np.cumsum(cnt) - cnt, cnt)
    chain = grid[gy0[rep] + k // ngx[rep], gx0[rep] + k % ngx[rep]]
    order = np.lexsort((gdist[rep], chain))
    chain_start = np.searchsorted(chain[order], np.arange(C + 1))
    return _finish_primary_bins(chain_start,
                                gids[rep[order]].astype(np.int32),
                                gdist[rep[order]])


def _finish_primary_bins(chain_start, cand, cdist) -> PrimaryBins:
    """Tensors of the CSR, the candidates padded to a ``P_BUCKET``
    multiple (so the arrays' sizes change only in steps)."""
    P = max(-(-len(cand) // P_BUCKET) * P_BUCKET, P_BUCKET)
    cand_p = np.zeros((P,), np.int32)
    cand_p[:len(cand)] = cand
    dist_p = np.full((P,), FLT_MAX, np.float32)
    dist_p[:len(cdist)] = cdist
    return PrimaryBins(torch.from_numpy(np.asarray(chain_start, np.int32)),
                       torch.from_numpy(cand_p), torch.from_numpy(dist_p))


def from_jax_primary_bins(chain_start, cand, cand_dist) -> PrimaryBins:
    """The port's bins from the JAX package's PrimaryBins CSR (NumPy)."""
    chain_start = np.asarray(chain_start, np.int64)
    n = int(chain_start[-1])
    return _finish_primary_bins(chain_start, np.asarray(cand)[:n],
                                np.asarray(cand_dist, np.float32)[:n])


def binned_supported(scene: SceneData, cfg) -> bool:
    """Scene-level eligibility: no infinite planes, no motion blur, no
    depth of field, at least one object."""
    st = scene.static
    if OBJ_PLANE in set(st.obj_types):
        return False
    if cfg.motion_blur or cfg.dof:
        return False
    return st.n_objects > 0


# ------------------------------------------------------------ light bins
class LightBins(NamedTuple):
    """Per-scene occluder bins of the point lights (host-built once).

    Light l's K x K frustum tile (tx, ty) holds the object groups
    ``group[tile_start[i]:tile_start[i + 1]]``, i = (l * K + ty) * K + tx
    (x fastest, so the tiles tx0..tx1 of one row are one contiguous span),
    ascending in ``dist``, the least distance of the group's box from the
    light.  ``frames`` rows are ``[light xyz, u xyz, v xyz, w xyz, sx, sy,
    0, 0]``: the frustum axis w (light to scene-box centre), the tile axes
    u and v, and the half-extents of the frustum's tangent plane.
    ``group`` and ``dist`` are padded to a multiple of ``P_BUCKET`` (group
    0, distance FLT_MAX)."""

    tile_start: torch.Tensor  # (L*K*K+1,) i32
    frames: torch.Tensor  # (L, 16) f32
    group: torch.Tensor  # (Q,) i32 group ids
    dist: torch.Tensor  # (Q,) f32

    @property
    def n_lights(self) -> int:
        return self.frames.shape[0]

    @property
    def k(self) -> int:
        """Tiles per axis."""
        return math.isqrt((self.tile_start.shape[0] - 1) // self.n_lights)

    def to(self, device) -> "LightBins":
        return LightBins(*(t.to(device) for t in self))


def build_light_bins(scene: SceneData, gbox: np.ndarray, K: int = LIGHT_K
                     ) -> Optional[LightBins]:
    """Conservative per-light frustum binning of the object groups, in
    float64 NumPy with the JAX package's operations (so its tiles, frames
    and entry order come out equal).

    None when the scene has no lights or no groups, or when a light is
    inside the scene box or nearer it than ``min_dist``: the frustum axis
    needs the light outside, and a grid scene's shadow window (``t < 1``
    along the unit direction, main.cpp:411-420) must not reach past the
    light, where the direction binning no longer covers (1.05 for grid
    scenes, 1e-3 otherwise); also when the box reaches behind the light's
    lateral plane."""
    st = scene.static
    min_dist = 1.05 if st.accel == ACCEL_GRID else 1e-3
    L = st.n_lights
    live = gbox[:, 6] > 0
    if not live.any() or L == 0:
        return None
    smin = gbox[live, 0:3].min(axis=0).astype(np.float64)
    smax = gbox[live, 3:6].max(axis=0).astype(np.float64)
    center = (smin + smax) / 2.0
    half = (smax - smin) / 2.0
    lpos = scene.light_pos.detach().cpu().numpy().astype(np.float64)
    frames = np.zeros((L, 16), np.float32)
    gids = np.nonzero(live)[0]
    bmin = gbox[gids, 0:3].astype(np.float64)
    bmax = gbox[gids, 3:6].astype(np.float64)
    corners = _corners(bmin, bmax)  # (8, G, 3)
    scorn = _corners(smin, smax)  # (8, 1, 3)
    starts, entries = [], []
    for li in range(L):
        Lp = lpos[li]
        gap = np.maximum(np.abs(Lp - center) - half, 0.0)
        if np.linalg.norm(gap) < min_dist:
            return None
        wax = center - Lp
        wax = wax / np.linalg.norm(wax)
        tmp = (np.array([0.0, 1.0, 0.0]) if abs(wax[1]) < 0.9
               else np.array([1.0, 0.0, 0.0]))
        ua = np.cross(tmp, wax)
        ua /= np.linalg.norm(ua)
        va = np.cross(wax, ua)
        # the frustum's half-extents: the largest tangent of a box corner
        svec = scorn - Lp
        sw = svec @ wax
        if np.any(sw <= 1e-9):
            return None  # the box reaches behind the light's lateral plane
        sx = float(np.max(np.abs(svec @ ua) / sw)) * 1.001 + 1e-6
        sy = float(np.max(np.abs(svec @ va) / sw)) * 1.001 + 1e-6
        frames[li, 0:3], frames[li, 3:6] = Lp, ua
        frames[li, 6:9], frames[li, 9:12] = va, wax
        frames[li, 12], frames[li, 13] = sx, sy

        vec = corners - Lp
        aw = vec @ wax
        # a group box that reaches the light's lateral plane goes into
        # every tile: it covers occluders just past the light that the BVH
        # compare t <= dist + EPSILON still accepts
        behind = np.any(aw <= 1e-9, axis=0)
        den = np.where(aw > 1e-9, aw, 1.0)
        sa, ta = (vec @ ua) / den, (vec @ va) / den

        def tile(a, s, fn, edge):
            return np.where(behind, edge, np.clip(
                ((fn(a, axis=0) / s) * 0.5 + 0.5) * K, 0, K - 1).astype(
                    np.int64))

        tx0, tx1 = tile(sa, sx, np.min, 0), tile(sa, sx, np.max, K - 1)
        ty0, ty1 = tile(ta, sy, np.min, 0), tile(ta, sy, np.max, K - 1)
        ntx = tx1 - tx0 + 1
        cnt = ntx * (ty1 - ty0 + 1)
        total = int(cnt.sum())
        rep = np.repeat(np.arange(gids.size), cnt)
        k2 = np.arange(total) - np.repeat(np.cumsum(cnt) - cnt, cnt)
        tiles = (ty0[rep] + k2 // ntx[rep]) * K + tx0[rep] + k2 % ntx[rep]
        # the least distance from the light to the group's box: the cut
        # key, ascending within each tile
        dv = np.maximum(np.maximum(bmin - Lp, Lp - bmax), 0.0)
        gd = np.sqrt((dv * dv).sum(axis=1)).astype(np.float32)
        order = np.lexsort((gd[rep], tiles))
        starts.append(np.searchsorted(tiles[order], np.arange(K * K)))
        entries.append((gids[rep[order]].astype(np.int32), gd[rep[order]]))
    offs = np.cumsum([0] + [e[0].size for e in entries])
    start = np.concatenate([starts[i] + offs[i] for i in range(L)]
                           + [offs[-1:]])
    return _finish_light_bins(start, frames,
                              np.concatenate([e[0] for e in entries]),
                              np.concatenate([e[1] for e in entries]))


def _finish_light_bins(start, frames, group, dist) -> LightBins:
    """Tensors of the bins, the entries padded to a ``P_BUCKET`` multiple."""
    Q = max(-(-len(group) // P_BUCKET) * P_BUCKET, P_BUCKET)
    group_p = np.zeros((Q,), np.int32)
    group_p[:len(group)] = group
    dist_p = np.full((Q,), FLT_MAX, np.float32)
    dist_p[:len(dist)] = dist
    return LightBins(torch.from_numpy(np.array(start, np.int32)),
                     torch.from_numpy(np.array(frames, np.float32)),
                     torch.from_numpy(group_p), torch.from_numpy(dist_p))


def from_jax_light_bins(tabs: PacketTables, tile_start, frames, slab
                        ) -> LightBins:
    """The port's bins from the JAX package's LightBins (NumPy): each entry's
    group is the one of ``tabs`` that holds the object in slot 0 of the
    entry's slab column (every object lies in one group); its distance is
    the slab's distance row."""
    start = np.asarray(tile_start, np.int64)
    n = int(start[-1])
    slab = np.asarray(slab, np.float32)
    if not (slab[12 * GROUP, :n] >= 0).all():
        raise ValueError("a light-bin entry's first slot is inert")
    ints = tabs.objs.view(torch.int32).cpu().numpy()
    live = ints[:, 12] >= 0
    group_of = np.full(int(ints[live, 13].max()) + 1, -1, np.int64)
    group_of[ints[live, 13]] = np.nonzero(live)[0] // GROUP
    group = group_of[slab[13 * GROUP, :n].astype(np.int64)]
    return _finish_light_bins(start, frames, group.astype(np.int32),
                              slab[14 * GROUP, :n])


def shadow_binning_ok(scene: SceneData, lbins: Optional[LightBins]) -> bool:
    """Light bins route shadows only where they built (every light outside
    the scene box) and every light is punctual: a quad light's shadow rays
    end at jittered points the frustum of its corner does not cover."""
    return lbins is not None and not any(scene.static.light_quad)


class BinSet(NamedTuple):
    """Camera-dependent primary bins and scene-static light bins (None where
    they did not build or the route is off)."""

    primary: Optional[PrimaryBins]
    lights: Optional[LightBins] = None


# ------------------------------------------------------------------ K9
def _pad_lanes(x, n):
    pad = n - x.shape[0]
    if pad == 0:
        return x
    return torch.cat([x, torch.zeros((pad,) + x.shape[1:], dtype=x.dtype,
                                     device=x.device)])


def binned_closest_plain(tabs: PacketTables, bins: PrimaryBins, o, d, time,
                         valid=None, motion_blur: bool = False,
                         types_present=None, stats: Optional[dict] = None):
    """Plain version of K9: every chain streams its candidate groups in
    order, all chains one candidate per step, and a chain stops once every
    live lane's best t is below the next group's ``cand_dist``.  Returns
    ``(t, normal, object id)``; ``stats`` receives the groups streamed and
    the object tests made (the kernel's work on these inputs): ``groups``,
    ``obj_tests`` and ``type_tests`` (by type + 1, as
    :func:`accel.bvh.threaded_walk`), and per chain (C,) int64 tensors
    ``chain_groups`` (groups streamed) and ``chain_tests`` (slot tests:
    each live lane against each live slot of each group streamed)."""
    if types_present is None:
        types_present = (OBJ_SPHERE, OBJ_TRIANGLE, OBJ_PLANE, OBJ_BOX)
    R, dev = o.shape[0], o.device
    C = bins.n_chains
    if -(-R // LANES) != C:
        raise ValueError(f"{R} rays do not fill the bins' {C} chains")
    n = C * LANES
    v = (torch.ones((R,), dtype=torch.bool, device=dev) if valid is None
         else valid.to(torch.bool))
    O = _pad_lanes(o, n).reshape(C, LANES, 3)
    D = _pad_lanes(d, n).reshape(C, LANES, 3)
    T = _pad_lanes(time, n).reshape(C, LANES)
    V = _pad_lanes(v, n).reshape(C, LANES)
    bt = torch.full((C, LANES), FLT_MAX, dtype=torch.float32, device=dev)
    bn = torch.zeros((C, LANES, 3), dtype=torch.float32, device=dev)
    bid = torch.full((C, LANES), -1, dtype=torch.int32, device=dev)
    cs = bins.chain_start.to(dev).long()
    cnt = cs[1:] - cs[:-1]
    cand, cdist = bins.cand.to(dev).long(), bins.cand_dist.to(dev)
    oints = tabs.objs.view(torch.int32)
    slot8 = torch.arange(GROUP, device=dev)
    groups = tests = 0
    type_tests = torch.zeros((5,), dtype=torch.int64, device=dev)
    chain_groups = torch.zeros((C,), dtype=torch.int64, device=dev)
    chain_tests = torch.zeros((C,), dtype=torch.int64, device=dev)
    act = torch.nonzero(cnt > 0).squeeze(1)
    k = 0
    while act.numel():
        act = act[cnt[act] > k]
        if not act.numel():
            break
        # front-to-back stop vote of each chain before its k-th group
        dist_k = cdist[cs[act] + k]
        stop = (~V[act] | (bt[act] < dist_k[:, None])).all(dim=1)
        act = act[~stop]
        if not act.numel():
            break
        slots = cand[cs[act] + k][:, None] * GROUP + slot8  # (Ca, 8)
        na = act.numel()
        rows = tabs.objs[slots][:, None].expand(na, LANES, GROUP, 16)
        typ = oints[slots, 12][:, None].expand(na, LANES, GROUP)
        lane3 = lambda x: x[act][:, :, None].expand(na, LANES, GROUP,
                                                    3).reshape(-1, 3)
        t, nrm = hit_packed(lane3(O), lane3(D),
                            T[act][:, :, None].expand(na, LANES,
                                                      GROUP).reshape(-1),
                            rows.reshape(-1, 16), typ.reshape(-1),
                            motion_blur, types_present)
        t = t.reshape(na, LANES, GROUP)
        # strict < in slot order: the first slot of the minimum
        tmin, j = torch.min(t, dim=2)
        va = V[act]
        better = va & (tmin < bt[act])
        pick = lambda a: a.reshape(na, LANES, GROUP, -1).gather(
            2, j[:, :, None, None].expand(na, LANES, 1, a.shape[-1]))[:, :, 0]
        gid = oints[slots, 13].gather(1, j)
        bt[act] = torch.where(better, tmin, bt[act])
        bn[act] = torch.where(better[:, :, None], pick(nrm), bn[act])
        bid[act] = torch.where(better, gid, bid[act])
        groups += na
        if stats is not None:
            # each live lane tests the group's live slots
            per_slot = va.sum(1)[:, None].expand(na, GROUP)  # (Ca, 8)
            live = oints[slots, 12].long()
            type_tests.index_add_(0, (live + 1).reshape(-1),
                                  per_slot.reshape(-1).long())
            per_chain = (per_slot * (live >= 0)).sum(1)
            tests += int(per_chain.sum())
            chain_groups[act] += 1
            chain_tests[act] += per_chain
        k += 1
    if stats is not None:
        stats["groups"] = stats.get("groups", 0) + groups
        stats["obj_tests"] = stats.get("obj_tests", 0) + tests
        stats["type_tests"] = stats.get("type_tests", 0) + type_tests.cpu()
        stats["chain_groups"] = chain_groups.cpu()
        stats["chain_tests"] = chain_tests.cpu()
    return bt.reshape(n)[:R], bn.reshape(n, 3)[:R], bid.reshape(n)[:R]


class ClosestWork(NamedTuple):
    """K9's work list: ``item_start`` (C+1,) i32, the exclusive scan of
    each chain's segments past its first (the total at C); ``counter``
    (1,) i32, the units taken (the kernel's scratch)."""

    item_start: torch.Tensor
    counter: torch.Tensor


def closest_work_plain(bins: PrimaryBins,
                       segment_groups: int = SEGMENT_GROUPS) -> ClosestWork:
    """Plain version of K9's first pass: chain c's list of n groups makes
    ceil(n / segment_groups) segments, and its tail items are the
    segments past its first."""
    cs = bins.chain_start.long()
    cnt = cs[1:] - cs[:-1]
    tail = torch.clamp(-(-cnt // segment_groups) - 1, min=0)
    item_start = torch.zeros((cnt.numel() + 1,), dtype=torch.int64,
                             device=cs.device)
    item_start[1:] = torch.cumsum(tail, 0)
    return ClosestWork(item_start.to(torch.int32),
                       torch.zeros((1,), dtype=torch.int32, device=cs.device))


def closest_units_plain(bins: PrimaryBins, work: ClosestWork,
                        segment_groups: int = SEGMENT_GROUPS):
    """K9's units in the order its warps take them: (chain, quarter, first,
    end) (U,) int64 tensors, a quarter being 32 of the chain's lanes and
    [first, end) the positions of its segment in ``bins.cand``.  Every
    chain's first segment comes first, chain by chain, then the tail
    items, each item's chain the last whose item_start is at or below
    it."""
    cs = bins.chain_start.long()
    ist = work.item_start.long()
    C, dev = cs.numel() - 1, cs.device
    q = LANES // 32
    item = torch.arange(int(ist[-1]), device=dev)
    ic = torch.searchsorted(ist, item, right=True) - 1
    chain = torch.cat([torch.arange(C, device=dev), ic])
    seg = torch.cat([torch.zeros((C,), dtype=torch.int64, device=dev),
                     1 + item - ist[ic]])
    chain = torch.repeat_interleave(chain, q)
    seg = torch.repeat_interleave(seg, q)
    quarter = torch.arange(chain.numel(), device=dev) % q
    first = cs[chain] + seg * segment_groups
    end = torch.minimum(first + segment_groups, cs[chain + 1])
    return chain, quarter, first, end


def binned_closest_segments_plain(tabs: PacketTables, bins: PrimaryBins, o,
                                  d, time, valid=None,
                                  motion_blur: bool = False,
                                  types_present=None,
                                  segment_groups: int = SEGMENT_GROUPS):
    """K9's segmented stream in plain torch, one schedule of it: the
    segments' rounds in turn (every chain's first segment, then every
    second one, ...), each unit a quarter of a chain that stops before
    the first group whose ``cand_dist`` its every live lane's best (the
    best of the rounds before, or its own) beats, every slot hit merged
    by the least (t, position * 8 + slot).  Returns ``(t, normal, object
    id)``: :func:`binned_closest_plain`'s on every lane, whatever the
    order of the segments, since a stop skips only groups that cannot
    win."""
    if types_present is None:
        types_present = (OBJ_SPHERE, OBJ_TRIANGLE, OBJ_PLANE, OBJ_BOX)
    R, dev = o.shape[0], o.device
    C = bins.n_chains
    if -(-R // LANES) != C:
        raise ValueError(f"{R} rays do not fill the bins' {C} chains")
    n, Q = C * LANES, LANES // 32
    v = (torch.ones((R,), dtype=torch.bool, device=dev) if valid is None
         else valid.to(torch.bool))
    O = _pad_lanes(o, n).reshape(C * Q, 32, 3)
    D = _pad_lanes(d, n).reshape(C * Q, 32, 3)
    T = _pad_lanes(time, n).reshape(C * Q, 32)
    V = _pad_lanes(v, n).reshape(C * Q, 32)
    cand, cdist = bins.cand.to(dev).long(), bins.cand_dist.to(dev)
    oints = tabs.objs.view(torch.int32)
    slot8 = torch.arange(GROUP, device=dev)
    bt = torch.full((C * Q, 32), FLT_MAX, dtype=torch.float32, device=dev)
    code = torch.full((C * Q, 32), -1, dtype=torch.int64, device=dev)
    work = closest_work_plain(bins.to(dev), segment_groups)
    chain, quarter, first, end = closest_units_plain(bins.to(dev), work,
                                                     segment_groups)
    seg = (first - bins.chain_start.to(dev).long()[chain]) // segment_groups
    for s in range(int(seg.max()) + 1 if seg.numel() else 0):
        unit = chain[seg == s] * Q + quarter[seg == s]
        ufirst, uend = first[seg == s], end[seg == s]
        known = bt[unit].clone()  # the rounds before this one
        own = torch.full_like(known, FLT_MAX)
        act = torch.ones_like(ufirst, dtype=torch.bool)
        for k in range(segment_groups):
            pos = ufirst + k
            act &= pos < uend
            if not act.any():
                break
            pk = torch.where(act, pos, 0)
            best = torch.minimum(known, own)
            stop = (~V[unit] | (best < cdist[pk][:, None])).all(1)
            act &= ~stop
            if not act.any():
                break
            u, pa = unit[act], pk[act]
            slots = cand[pa][:, None] * GROUP + slot8  # (Ua, 8)
            na = u.numel()
            rows = tabs.objs[slots][:, None].expand(na, 32, GROUP, 16)
            typ = oints[slots, 12][:, None].expand(na, 32, GROUP)
            lane3 = lambda x: x[u][:, :, None].expand(na, 32, GROUP,
                                                      3).reshape(-1, 3)
            t, _ = hit_packed(lane3(O), lane3(D),
                              T[u][:, :, None].expand(na, 32,
                                                      GROUP).reshape(-1),
                              rows.reshape(-1, 16), typ.reshape(-1),
                              motion_blur, types_present)
            t = t.reshape(na, 32, GROUP)
            tmin, j = torch.min(t, dim=2)  # strict < in slot order
            c = pa[:, None] * GROUP + j
            ok = V[u] & (tmin < FLT_MAX)
            better = ok & ((tmin < bt[u]) | ((tmin == bt[u])
                                             & (c < code[u])))
            bt[u] = torch.where(better, tmin, bt[u])
            code[u] = torch.where(better, c, code[u])
            own[act] = torch.where(ok, torch.minimum(own[act], tmin),
                                   own[act])
    bt, code = bt.reshape(n)[:R], code.reshape(n)[:R]
    hit = code >= 0
    sl = torch.where(hit, cand[torch.clamp(code, min=0) // GROUP] * GROUP
                     + torch.clamp(code, min=0) % GROUP, 0)
    gid = torch.where(hit, oints[sl, 13], -1).to(torch.int32)
    _, nrm = hit_packed(o, d, time, tabs.objs[sl], torch.where(
        hit, oints[sl, 12], -1), motion_blur, types_present)
    nrm = torch.where(hit[:, None], nrm, 0.0)
    return bt, nrm, gid


def launch_binned_closest(tabs: PacketTables, bins: PrimaryBins, o, d,
                          time, valid, motion_blur: bool, t, normal,
                          obj) -> ClosestWork:
    """K9 on (R,3) o and d, (R,) f32 time and (R,) bool valid or None
    (every lane), read in place, into (R,) f32 t, (R,3) f32 normal and
    (R,) i32 object ids; counts nothing.  Returns the work list it wrote
    into its scratch (one allocation: the lanes' keys, then the work
    list)."""
    R, C = o.shape[0], bins.n_chains
    scratch = torch.empty((2 * R + C + 2,), dtype=torch.int32,
                          device=o.device)
    keys, ist, counter = scratch.split([2 * R, C + 1, 1])
    with torch.cuda.device(o.device):
        err = build.load().lib.drt_binned_closest(
            tabs.objs.data_ptr(), bins.chain_start.data_ptr(), C,
            bins.cand.data_ptr(), bins.cand_dist.data_ptr(), o.data_ptr(),
            d.data_ptr(), time.data_ptr(),
            None if valid is None else valid.data_ptr(), R,
            int(motion_blur), keys.data_ptr(), ist.data_ptr(),
            counter.data_ptr(), t.data_ptr(), normal.data_ptr(),
            obj.data_ptr(), torch.cuda.current_stream().cuda_stream)
    build.check(err, "drt_binned_closest")
    return ClosestWork(ist, counter)


def binned_closest_inputs(o, d, time, valid):
    """K9's inputs as it reads them in place: (o, d, time, valid or
    None), checked for shape and device."""
    time = time.to(torch.float32).contiguous()
    valid = None if valid is None else valid.to(torch.bool).contiguous()
    o, d = ray_inputs("binned_closest", o, d, time, valid)
    return o, d, time, valid


def binned_closest_kernel(tabs: PacketTables, bins: PrimaryBins, o, d, time,
                          valid=None, motion_blur: bool = False):
    """K9 on CUDA tensors: (t, normal, object id)."""
    R = o.shape[0]
    if -(-R // LANES) != bins.n_chains:
        raise ValueError(f"{R} rays do not fill the bins' "
                         f"{bins.n_chains} chains")
    o, d, time, valid = binned_closest_inputs(o, d, time, valid)
    require_cuda("binned_closest", o, tabs.objs, *bins)
    if tabs.objs.data_ptr() % 16:
        raise ValueError("binned_closest: the slot records must be 16-byte "
                         "aligned")
    t = torch.empty((R,), dtype=torch.float32, device=o.device)
    nrm = torch.empty((R, 3), dtype=torch.float32, device=o.device)
    gid = torch.empty((R,), dtype=torch.int32, device=o.device)
    launch_binned_closest(tabs, bins, o, d, time, valid, motion_blur, t, nrm,
                          gid)
    LAUNCHES["binned_closest"] += 1
    return t, nrm, gid


# ------------------------------------------------------------------ K10
def _chain_rects(lbins: LightBins, light_id, O, V):
    """Each chain's light (its first lane's), the tile rectangle of its live
    lanes' origins (tx0, tx1, ty0, ty1; ty1 = -1 where no lane is live)
    and its distance cut maxd.  Every f32 operation is rounded on its own,
    in the kernel's order."""
    K = lbins.k
    lid = light_id[:, 0].long()
    fr = lbins.frames[lid]  # (C, 16)
    f = lambda k: fr[:, k:k + 1]
    vx, vy, vz = O[..., 0] - f(0), O[..., 1] - f(1), O[..., 2] - f(2)
    aw = vx * f(9) + vy * f(10) + vz * f(11)
    aws = torch.where(aw > 1e-9, aw, torch.ones_like(aw))
    su = (vx * f(3) + vy * f(4) + vz * f(5)) / aws
    tv = (vx * f(6) + vy * f(7) + vz * f(8)) / aws

    def tile(s, sk):
        x = torch.clamp((s / sk) * 0.5 + 0.5, 0.0, 1.0) * float(K)
        return torch.clamp(x.to(torch.int32), 0, K - 1)

    tx, ty = tile(su, f(12)), tile(tv, f(13))
    big, none = torch.full_like(tx, K), torch.full_like(tx, -1)
    tx0 = torch.where(V, tx, big).amin(1).long()
    tx1 = torch.where(V, tx, none).amax(1).long()
    ty0 = torch.where(V, ty, big).amin(1).long()
    ty1 = torch.where(V, ty, none).amax(1).long()  # -1: no live lane
    od2 = vx * vx + vy * vy + vz * vz
    maxd = torch.sqrt(torch.clamp(torch.where(V, od2, torch.zeros_like(od2))
                                  .amax(1), min=0.0)) + 1e-3
    return lid, tx0, tx1, ty0, ty1, maxd


def _chain_spans(lbins: LightBins, light_id, O, V):
    """Each chain's light, rectangle and cut (:func:`_chain_rects`), then its
    bin entries in streaming order (row by row, tile by tile, each tile's
    entries ascending in distance) no farther from the light than the cut.
    Returns the entries' chains and positions in ``lbins.group``, sorted by
    chain."""
    C, dev = O.shape[0], O.device
    K = lbins.k
    lid, tx0, tx1, ty0, ty1, maxd = _chain_rects(lbins, light_id, O, V)
    # (chain, tile) pairs, row by row, x fastest
    nrow = torch.where(ty1 >= 0, ty1 - ty0 + 1, torch.zeros_like(ty1))
    ncol = torch.where(ty1 >= 0, tx1 - tx0 + 1, torch.zeros_like(tx1))
    cnt = nrow * ncol
    ch = torch.repeat_interleave(torch.arange(C, device=dev), cnt)
    k = torch.arange(ch.numel(), device=dev) - torch.repeat_interleave(
        torch.cumsum(cnt, 0) - cnt, cnt)
    t = (lid[ch] * K + ty0[ch] + k // ncol[ch]) * K + tx0[ch] + k % ncol[ch]
    ts = lbins.tile_start.long()
    s, e = ts[t], ts[t + 1]
    # every entry of those tiles, then the distance cut
    n = e - s
    ech = torch.repeat_interleave(ch, n)
    pos = torch.repeat_interleave(s - (torch.cumsum(n, 0) - n), n) + \
        torch.arange(ech.numel(), device=dev)
    keep = lbins.dist[pos] <= maxd[ech]
    return ech[keep], pos[keep]


def binned_shadow_plain(tabs: PacketTables, lbins: LightBins, light_id, o, d,
                        dist, valid=None, shadow_mode: str = "bvh",
                        types_present=None, stats: Optional[dict] = None):
    """Plain version of K10: occluded (R,) bool.

    Chain c (lanes 128c..128c+127) takes the light of its first lane and the
    bin entries of :func:`_chain_spans`.  A live lane is occluded when any
    slot of its chain's entries hits it at time 0, with ``t <= dist +
    EPSILON`` (``shadow_mode`` ``bvh``) or ``t < dist`` (``grid``).  That is
    an OR over the entries, so their order does not change it: the (live
    lane, chain entry) pairs are tested ``SHADOW_PAIRS`` at a time, keeping
    each lane's first occluding slot in streaming order.

    ``stats`` receives the kernel's work on these inputs, which streams each
    chain's entries in order, tests a lane's slots up to its first occluder
    and stops a chain once every live lane is occluded: ``entries`` (the
    entries streamed) and ``chain_entries`` (per chain), ``obj_tests``,
    ``type_tests`` (by type + 1, as :func:`accel.bvh.threaded_walk`), and
    the distinct ``bin_entries`` and ``groups`` among the entries streamed."""
    if types_present is None:
        types_present = (OBJ_SPHERE, OBJ_TRIANGLE, OBJ_PLANE, OBJ_BOX)
    R, dev = o.shape[0], o.device
    C = -(-R // LANES)
    n = C * LANES
    v = (torch.ones((R,), dtype=torch.bool, device=dev) if valid is None
         else valid.to(torch.bool))
    O = _pad_lanes(o, n).reshape(C, LANES, 3)
    D = _pad_lanes(d, n).reshape(C, LANES, 3)
    SD = _pad_lanes(dist, n).reshape(C, LANES)
    V = _pad_lanes(v, n).reshape(C, LANES)
    lid = _pad_lanes(light_id.to(dev), n).reshape(C, LANES)
    lb = lbins.to(dev)
    ech, pos = _chain_spans(lb, lid, O, V)
    cnt = torch.bincount(ech, minlength=C)
    cs = torch.cumsum(cnt, 0) - cnt
    slot8 = torch.arange(GROUP, device=dev)
    slots = lb.group[pos].long()[:, None] * GROUP + slot8  # (N, 8)
    typ = tabs.objs.view(torch.int32)[slots, 12]
    lc, ll = torch.nonzero(V, as_tuple=True)  # the live lanes
    npair = cnt[lc]
    ends = torch.cumsum(npair, 0)
    start = ends - npair
    none = GROUP * max(ech.numel(), 1)  # past every slot of a chain
    first = torch.full_like(lc, none)  # each lane's first occluding slot
    ends_h, start_h = ends.cpu(), start.cpu()
    a, m = 0, lc.numel()
    while a < m:  # the lanes a..b-1: about SHADOW_PAIRS pairs
        b = max(int(torch.searchsorted(ends_h, start_h[a] + SHADOW_PAIRS,
                                       right=True)), a + 1)
        li = torch.repeat_interleave(torch.arange(a, b, device=dev),
                                     npair[a:b])
        k = torch.arange(li.numel(), device=dev) + start[a] - start[li]
        ent = cs[lc[li]] + k
        lane = lambda x: x[lc[li], ll[li]][:, None].expand(
            -1, GROUP, 3).reshape(-1, 3)
        t, _ = hit_packed(lane(O), lane(D),
                          torch.zeros((li.numel() * GROUP,), device=dev),
                          tabs.objs[slots[ent]].reshape(-1, 16),
                          typ[ent].reshape(-1), False, types_present)
        sd = SD[lc[li], ll[li]][:, None]
        t = t.reshape(-1, GROUP)
        hit = (t < sd) if shadow_mode == "grid" else (t <= sd + EPSILON)
        flat = torch.where(hit, k[:, None] * GROUP + slot8, none).amin(1)
        first.scatter_reduce_(0, li, flat, "amin")
        a = b
    occl = first < none
    occ = torch.zeros((C, LANES), dtype=torch.bool, device=dev)
    occ[lc, ll] = occl
    if stats is not None:
        # a lane tests every slot up to its first occluder, or all of them
        fk = torch.where(occl, first // GROUP, npair)
        per = torch.nn.functional.one_hot(typ.long() + 1, 5)  # (N, 8, 5)
        cum = torch.cat([per.new_zeros((1, 5)), torch.cumsum(per.sum(1), 0)])
        base = cs[lc]
        tt = cum[base + fk] - cum[base]
        fs = (slot8 <= (first % GROUP)[:, None]) & occl[:, None]
        tt += (per[torch.where(occl, base + fk, 0)] * fs[..., None]).sum(1)
        type_tests = tt.sum(0)
        # a chain streams up to the entry that occludes its last live lane
        streamed = torch.zeros_like(cnt).scatter_reduce_(
            0, lc, torch.where(occl, fk + 1, npair), "amax")
        sent = (torch.arange(ech.numel(), device=dev) - cs[ech]
                < streamed[ech])
        stats["entries"] = stats.get("entries", 0) + int(streamed.sum())
        stats["chain_entries"] = streamed.cpu()
        stats["obj_tests"] = (stats.get("obj_tests", 0)
                              + int(type_tests[1:].sum()))
        stats["type_tests"] = stats.get("type_tests", 0) + type_tests.cpu()
        stats["bin_entries"] = int(torch.unique(pos[sent]).numel())
        stats["groups"] = int(torch.unique(slots[sent, 0]).numel())
    return occ.reshape(n)[:R]


class ShadowWork(NamedTuple):
    """K10's work list (its first two passes' output): ``chains`` (C, 8) i32
    rows ``[light, tx0, tx1, ty0, ty1, maxd (f32 bits), positions,
    items]``; ``rows`` (C, K+1) i32, row r of chain c's rectangle starting
    at position ``rows[c, r]`` of its stream (``rows[c, nrow]``: its
    positions; entries past nrow are not written); ``item_start`` (C+1,)
    i32, the exclusive scan of the items; ``counter`` (1,) i32, the units
    taken (the kernel's scratch)."""

    chains: torch.Tensor
    rows: torch.Tensor
    item_start: torch.Tensor
    counter: torch.Tensor


def shadow_work_plain(lbins: LightBins, light_id, o, valid=None,
                      item_entries: int = ITEM_ENTRIES) -> ShadowWork:
    """Plain version of K10's first two passes.  Chain c's stream is the
    rows ty0..ty1 of its rectangle, each row the bin entries of its tiles
    tx0..tx1, one contiguous span of ``lbins.group`` (x fastest); its
    entries are the positions no farther from the light than maxd, which
    in each tile is the list up to the cut (distances ascend in a tile).
    A work item is ``item_entries`` consecutive positions of one chain's
    stream; ``rows`` is zero past each chain's rows."""
    C = -(-o.shape[0] // LANES)
    n, dev, K = C * LANES, o.device, lbins.k
    lb = lbins.to(dev)
    v = (torch.ones((o.shape[0],), dtype=torch.bool, device=dev)
         if valid is None else valid.to(torch.bool))
    lid, tx0, tx1, ty0, ty1, maxd = _chain_rects(
        lb, _pad_lanes(light_id.to(dev), n).reshape(C, LANES),
        _pad_lanes(o, n).reshape(C, LANES, 3),
        _pad_lanes(v, n).reshape(C, LANES))
    nrow = torch.where(ty1 >= 0, ty1 - ty0 + 1, torch.zeros_like(ty1))
    r = torch.arange(K, device=dev)
    live = r[None, :] < nrow[:, None]  # (C, K)
    base = (lid[:, None] * K + ty0[:, None] + r[None, :]) * K
    ts = lb.tile_start.long()
    ix = lambda t: ts[torch.where(live, t, 0)]
    span = torch.where(live, ix(base + tx1[:, None] + 1)
                       - ix(base + tx0[:, None]), 0)
    rows = torch.zeros((C, K + 1), dtype=torch.int64, device=dev)
    rows[:, 1:] = torch.cumsum(span, 1)
    rows = torch.where(torch.arange(K + 1, device=dev)[None, :]
                       <= nrow[:, None], rows, 0)
    positions = span.sum(1)
    items = -(-positions // item_entries)
    item_start = torch.zeros((C + 1,), dtype=torch.int64, device=dev)
    item_start[1:] = torch.cumsum(items, 0)
    chains = torch.stack([lid, tx0, tx1, ty0, ty1,
                          maxd.view(torch.int32).long(), positions, items], 1)
    i32 = lambda x: x.to(torch.int32)
    return ShadowWork(i32(chains), i32(rows), i32(item_start),
                      torch.zeros((1,), dtype=torch.int32, device=dev))


def shadow_item_entries(lbins: LightBins, work: ShadowWork,
                        item_entries: int = ITEM_ENTRIES):
    """The entries each work item of ``work`` streams, as the kernel finds
    them: item (c, k) takes positions k E .. k E + E - 1 of chain c's
    stream, a position's row is the last whose start is at or below it,
    and it keeps those no farther from the light than maxd.  Returns the
    entries' items and positions in ``lbins.group``, in streaming order."""
    dev, K = work.chains.device, lbins.k
    lb = lbins.to(dev)
    ch = work.chains.long()
    ist = work.item_start.long()
    C = ch.shape[0]
    items = ch[:, 7]
    item = torch.arange(int(ist[-1]), device=dev)
    c = torch.repeat_interleave(torch.arange(C, device=dev), items)
    first = (item - ist[c]) * item_entries
    n = torch.minimum(ch[c, 6] - first, torch.full_like(first,
                                                        item_entries))
    ie = torch.repeat_interleave(item, n)
    ce = c[ie]
    v = first[ie] + torch.arange(ie.numel(), device=dev) - \
        torch.repeat_interleave(torch.cumsum(n, 0) - n, n)
    nrow = ch[ce, 4] - ch[ce, 3] + 1
    rows = work.rows.long()
    # the last row whose start is at or below v (rows past nrow: never)
    past = torch.arange(K + 1, device=dev)[None, :] >= nrow[:, None]
    ro = ((rows[ce] <= v[:, None]) & ~past).sum(1) - 1
    ts = lb.tile_start.long()
    t0 = (ch[ce, 0] * K + ch[ce, 3] + ro) * K + ch[ce, 1]
    pos = ts[t0] + v - rows[ce, ro]
    keep = lb.dist[pos] <= ch[ce, 5].to(torch.int32).view(torch.float32)
    return ie[keep], pos[keep]


def launch_binned_shadow(tabs: PacketTables, lbins: LightBins, light_id, o,
                         d, dist, valid, shadow_mode: str,
                         occ) -> ShadowWork:
    """K10 on (R,3) o and d, (R,) f32 dist, (R,) bool valid or None (every
    lane live) and (R,) i32 light ids, read in place, into an (R,) bool
    output; counts nothing.  Returns the work list it wrote into its
    scratch (one allocation, views into it)."""
    C, K = -(-o.shape[0] // LANES), lbins.k
    scratch = torch.empty((C * (8 + K + 2) + 2,), dtype=torch.int32,
                          device=o.device)
    cut = scratch.split([C * 8, C * (K + 1), C + 1, 1])
    work = ShadowWork(cut[0].view(C, 8), cut[1].view(C, K + 1), cut[2],
                      cut[3])
    with torch.cuda.device(o.device):
        err = build.load().lib.drt_binned_shadow(
            tabs.objs.data_ptr(), lbins.tile_start.data_ptr(),
            lbins.frames.data_ptr(), K, lbins.group.data_ptr(),
            lbins.dist.data_ptr(), light_id.data_ptr(), o.data_ptr(),
            d.data_ptr(), dist.data_ptr(),
            None if valid is None else valid.data_ptr(), o.shape[0],
            int(shadow_mode == "grid"), *(t.data_ptr() for t in work),
            occ.data_ptr(), torch.cuda.current_stream().cuda_stream)
    build.check(err, "drt_binned_shadow")
    return work


def shadow_inputs(o, d, dist, valid, light_id):
    """K10's inputs as it reads them in place: (o, d, dist, valid or None,
    light ids), checked for shape and device."""
    dist = dist.to(torch.float32).contiguous()
    valid = None if valid is None else valid.to(torch.bool).contiguous()
    lid = light_id.to(torch.int32).contiguous()
    o, d = ray_inputs("binned_shadow", o, d, dist, valid, lid)
    return o, d, dist, valid, lid


def binned_shadow_kernel(tabs: PacketTables, lbins: LightBins, light_id, o,
                         d, dist, valid=None, shadow_mode: str = "bvh"):
    """K10 on CUDA tensors: occluded (R,) bool."""
    o, d, dist, valid, lid = shadow_inputs(o, d, dist, valid, light_id)
    require_cuda("binned_shadow", tabs.objs, *lbins)
    if tabs.objs.data_ptr() % 16:
        raise ValueError("binned_shadow: the slot records must be 16-byte "
                         "aligned")
    R = o.shape[0]
    occ = torch.empty((R,), dtype=torch.bool, device=o.device)
    launch_binned_shadow(tabs, lbins, lid, o, d, dist, valid, shadow_mode,
                         occ)
    LAUNCHES["binned_shadow"] += 1
    return occ


def shadow_light_ids(R: int, n_lights: int, device):
    """Per-lane light ids of a shadow batch that concatenates one run of
    R / n_lights lanes per light (``_shade_node``), or None where the runs
    do not fill whole chains: a chain must hold one light's lanes."""
    if n_lights == 1:
        return torch.zeros((R,), dtype=torch.int32, device=device)
    rn = R // max(n_lights, 1)
    if n_lights < 1 or rn * n_lights != R or rn % LANES:
        return None
    return torch.arange(R, dtype=torch.int32, device=device) // rn


def leveled_binned_intersectors(scene: SceneData, tabs: PacketTables,
                                bins: BinSet, inner, motion_blur: bool = False,
                                plain: bool = False,
                                shadow_mode: str = "bvh",
                                cols: Optional[ObjectColumns] = None):
    """The primary level's closest hit by K9 and its shadow query by K10,
    everything else by ``inner`` (the packet walk).  ``trace_whitted``
    calls closest and shadow once per tree level in order, so the first
    calls are the primary level's.  The closest call goes to K9 only when
    the batch fills the bins' chains exactly (a chunked or padded batch
    would misalign them); the shadow call to K10 only where light bins
    exist and every chain holds one light's lanes (:func:`shadow_light_ids`).
    Deeper levels scatter sparse live lanes over every chain, whose tile
    rectangles then grow towards the whole frustum: the packet walk takes
    them.  ``cols`` are the scene's :func:`object_columns` where the
    caller keeps them.  The kernels refuse a scene whose geometry requires
    a gradient, as the packet walk's do."""
    mats, types_present, geometry = (object_columns(scene) if cols is None
                                     else cols)
    state = {"calls": 0, "shadow_calls": 0}
    pb, lb = bins.primary, bins.lights

    def closest(o, d, time, valid=None):
        state["calls"] += 1
        if (state["calls"] == 1 and pb is not None
                and -(-o.shape[0] // LANES) == pb.n_chains):
            if plain or o.device.type == "cpu":
                t, n, gid = binned_closest_plain(tabs, pb, o, d, time, valid,
                                                 motion_blur, types_present)
            else:
                refuse_grad("binned_closest", *geometry)
                t, n, gid = binned_closest_kernel(tabs, pb, o, d, time, valid,
                                                  motion_blur)
            return hit_result(t, n, gid, mats)
        return inner.closest(o, d, time, valid=valid)

    def shadow(o, d, dist, exclude_obj, valid=None):
        state["shadow_calls"] += 1
        lid = None
        if lb is not None and state["shadow_calls"] == 1:
            lid = shadow_light_ids(o.shape[0], lb.n_lights, o.device)
        if lid is None:
            return inner.shadow(o, d, dist, exclude_obj, valid=valid)
        if plain or o.device.type == "cpu":
            return binned_shadow_plain(tabs, lb, lid, o, d, dist, valid,
                                       shadow_mode, types_present)
        refuse_grad("binned_shadow", *geometry)
        return binned_shadow_kernel(tabs, lb, lid, o, d, dist, valid,
                                    shadow_mode)

    return Intersectors(closest, shadow)
