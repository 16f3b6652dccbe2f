"""Binned primary rays: K9 streams each chain's candidate object groups.

Counterpart of the primary half of ``distributionraytracer_tpu.accel.
pallas_binned``.  Every ray of a 128-lane chain goes through a known pixel
rectangle (``integrator/render.py::_block_perm``), so a host-side
conservative screen projection of the grouped tables' 8-object groups
gives each chain its complete candidate list, sorted front to back by a
lower bound of any member's hit distance from the eye.  K9
(``csrc/binned.cu``) streams the list and stops once every live lane's
best hit is nearer than the next group; its plain version,
:func:`binned_closest_plain`, streams the same lists in torch.  The result
is the strict-< closest hit over a superset of the objects a primary ray
can hit, ties going to the earlier candidate.

Eligibility (:func:`binned_supported`) is the JAX package's: no infinite
planes (their default boxes gate which rays test them), no motion blur
(moving spheres escape their static boxes), no depth of field (its
primaries do not share the pinhole projection).  The light-frustum shadow
binning (``build_light_bins``, ``binned_shadow``, K10) is not ported yet;
the JAX package does not route to it either (``SHADOW_BINNING``), so the
shadow queries go to the packet walk.

Two defects of the reference are not copied: the candidate total is capped
(``MAX_CANDIDATES``; past it the frame takes the packet route), and the
candidate arrays are padded to a bucket, not to their exact length.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from distributionraytracer_tpu_torch.accel.bvh import PacketTables, hit_result
from distributionraytracer_tpu_torch.accel.cuda_bvh import _rays
from distributionraytracer_tpu_torch.accel.grid import object_bboxes
from distributionraytracer_tpu_torch.integrator.render import _block_perm
from distributionraytracer_tpu_torch.integrator.whitted import Intersectors
from distributionraytracer_tpu_torch.ops import build
from distributionraytracer_tpu_torch.ops.common import FLT_MAX
from distributionraytracer_tpu_torch.ops.cuda_intersect import require_cuda
from distributionraytracer_tpu_torch.ops.intersect import hit_packed
from distributionraytracer_tpu_torch.scene.types import (
    OBJ_BOX, OBJ_PLANE, OBJ_SPHERE, OBJ_TRIANGLE, SceneData,
)

LANES = 128  # rays per chain
GROUP = 8  # object slots per group
PAD_PX = 2.0  # conservative screen-projection padding (pixel jitter + 1)
MAX_CHAINS = 16384  # past this many chains the packet walk takes the frame
MAX_CANDIDATES = 1 << 24  # (chain, group) pairs kept at most
P_BUCKET = 16384  # candidate arrays are padded to a multiple of this
SHADOW_BINNING = False  # the light-frustum shadow kernel (K10): not ported

# Kernel launches since the last reset_launches().
LAUNCHES = {"binned_closest": 0}


def reset_launches():
    LAUNCHES["binned_closest"] = 0


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


def _chain_grid(H: int, W: int, S: int):
    """The chain-to-pixel-rectangle structure of ``_block_perm``:
    ``(rw, rh, grid)`` where chains tile the image in (rh, rw) pixel
    rectangles and ``grid[y // rh, x // rw]`` is the chain owning pixel
    (x, y); None when it is no uniform tiling (odd S, resolutions that do
    not divide), and such frames take the packet route."""
    if S > LANES or (LANES % S) != 0:
        return None
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


def build_primary_bins(scene: SceneData, gbox: np.ndarray, H: int, W: int,
                       S: int) -> Optional[PrimaryBins]:
    """Conservative screen binning of the object groups to the chains.

    Each group's 8 box corners are projected through the exact inverse of
    the pinhole mapping (ops/camera.py::primary_rays); the padded screen
    box covers every pixel whose primary ray can hit a member (the
    projection of a convex hull contains its points' projections).  A group
    with a corner at or behind the eye plane goes into every chain's list.
    None where the chain structure is no uniform tiling, or past
    ``MAX_CHAINS`` chains or ``MAX_CANDIDATES`` pairs."""
    cg = _chain_grid(H, W, S)
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
    corners = np.stack([np.where((np.arange(8)[:, None] >> k) & 1,
                                 bmax[:, k][None, :], bmin[:, k][None, :])
                        for k in range(3)], axis=-1)  # (8, G, 3)
    vec = corners - eye
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


class BinSet(NamedTuple):
    """Camera-dependent primary bins; ``lights`` (the light-frustum shadow
    bins of K10) stays None until that kernel is ported."""

    primary: Optional[PrimaryBins]
    lights: Optional[object] = None


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
    :func:`accel.bvh.threaded_walk`)."""
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
            tests += int((per_slot * (live >= 0)).sum())
        k += 1
    if stats is not None:
        stats["groups"] = stats.get("groups", 0) + groups
        stats["obj_tests"] = stats.get("obj_tests", 0) + tests
        stats["type_tests"] = stats.get("type_tests", 0) + type_tests.cpu()
    return bt.reshape(n)[:R], bn.reshape(n, 3)[:R], bid.reshape(n)[:R]


def launch_binned_closest(tabs: PacketTables, bins: PrimaryBins, rays,
                          motion_blur: bool, out_f, out_i):
    """K9 on packed (8, R) rays into (4, R) f32 and (R,) i32 outputs;
    counts nothing."""
    with torch.cuda.device(rays.device):
        err = build.load().lib.drt_binned_closest(
            tabs.objs.data_ptr(), bins.chain_start.data_ptr(),
            bins.n_chains, bins.cand.data_ptr(), bins.cand_dist.data_ptr(),
            rays.data_ptr(), rays.shape[1], int(motion_blur),
            out_f.data_ptr(), out_i.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    build.check(err, "drt_binned_closest")


def binned_closest_kernel(tabs: PacketTables, bins: PrimaryBins, o, d, time,
                          valid=None, motion_blur: bool = False):
    """K9 on CUDA tensors: (t, normal, object id)."""
    R = o.shape[0]
    if -(-R // LANES) != bins.n_chains:
        raise ValueError(f"{R} rays do not fill the bins' "
                         f"{bins.n_chains} chains")
    rays = _rays(o, d, time, valid)
    require_cuda("binned_closest", rays, tabs.objs, *bins)
    out_f = torch.empty((4, R), dtype=torch.float32, device=rays.device)
    out_i = torch.empty((R,), dtype=torch.int32, device=rays.device)
    launch_binned_closest(tabs, bins, rays, motion_blur, out_f, out_i)
    LAUNCHES["binned_closest"] += 1
    return out_f[0], out_f[1:4].T, out_i


def leveled_binned_intersectors(scene: SceneData, tabs: PacketTables,
                                bins: BinSet, inner, motion_blur: bool = False,
                                plain: bool = False):
    """The primary level's closest hit by K9, everything else by ``inner``
    (the packet walk).  ``trace_whitted`` calls closest once per tree level
    in order, so the first call is the primary level; it goes to K9 only
    when the batch fills the bins' chains exactly (a chunked or padded batch
    would misalign them)."""
    mats = scene.packed_objects()[2]
    types_present = tuple(sorted(set(scene.static.obj_types)))
    state = {"calls": 0}
    pb = bins.primary

    def closest(o, d, time, valid=None):
        state["calls"] += 1
        if (state["calls"] == 1 and pb is not None
                and -(-o.shape[0] // LANES) == pb.n_chains):
            if plain or o.device.type == "cpu":
                t, n, gid = binned_closest_plain(tabs, pb, o, d, time, valid,
                                                 motion_blur, types_present)
            else:
                t, n, gid = binned_closest_kernel(tabs, pb, o, d, time, valid,
                                                  motion_blur)
            return hit_result(t, n, gid, mats)
        return inner.closest(o, d, time, valid=valid)

    return Intersectors(closest, inner.shadow)
