"""One fused Whitted tree level (K3) as a CUDA kernel.

Counterpart of ``distributionraytracer_tpu.ops.pallas_whitted``.  One launch
per tree level does the closest hit (with the winner's 13 material fields),
one shadow fold per light with the accel-NONE conventions, Blinn-Phong
direct light and the refraction/reflection spawn (``csrc/whitted_level.cu``).
The result is the ``_shade_node`` dict minus ``miss_color``, which the
caller adds.  ``grid_bbox`` (the grid's ``(bbox_min, bbox_max)``) switches
the kernel to the uniform grid's observable semantics: the Init_Traverse
slab gates the closest hit (``ok and t < t1``), occluders compare with a
strict ``t < dist`` and no self-exclusion, and a shadow ray that misses the
grid box is shadowed.

:func:`fused_level_plain` computes what the kernel computes, from the plain
closest/any-hit; it keeps the kernel's own formulas where they differ from
``_shade_node`` (``rsqrt(max(x, 1e-24))`` normalisation, the clamped
Schlick term).

The tree loop (``integrator.whitted.trace_whitted``) runs each level by
:func:`fused_level_into` on the level's (11, n*R) ray streams: K3 writes
the rows the bottom-up combine reads and each child's rays straight into
the next level's streams, in the lane order the loop reads them.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from distributionraytracer_tpu_torch.accel.grid import grid_slab
from distributionraytracer_tpu_torch.ops import build
from distributionraytracer_tpu_torch.ops.common import (
    OFFSET, dot, safe_sqrt,
)
from distributionraytracer_tpu_torch.ops.cuda_intersect import (
    ray_streams, require_cuda,
)
from distributionraytracer_tpu_torch.ops.intersect import (
    any_hit_brute, closest_hit_brute,
)
from distributionraytracer_tpu_torch.scene.types import SceneData
from distributionraytracer_tpu_torch.utils import spans

# Kernel launches since the last reset_launches(), by mode: calls of the
# launcher.  A call while a CUDA graph captures records its launch into
# the graph, and the graph's replays launch it again without a call.
LAUNCHES = {"fused_level": 0, "fused_level_grid": 0}
# Tile graphs captured and replayed (integrator.render.TileGraphs).
GRAPHS = {"captures": 0, "replays": 0}


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def fused_supported(scene: SceneData, cfg) -> bool:
    """The fused level kernel takes every accel-NONE scene with lights (the
    tables are read from global memory, so the object count is unbounded)
    and hard shadows: it has no soft-shadow visibility."""
    return scene.static.n_lights > 0 and cfg.soft_shadow == 0.0


def pack_whitted_mats(scene: SceneData) -> torch.Tensor:
    """(O, 13) f32 per-OBJECT material rows: [cd3, cs3, kd, ks, kr, shine,
    T, ior, pad]."""
    spans.count("tables.builds.pack_whitted_mats")
    _, _, mats = scene.packed_objects()
    m = mats.long()
    cols = [scene.mat_kd, scene.mat_ks, scene.mat_kr, scene.mat_shine,
            scene.mat_T, scene.mat_ior]
    row = torch.cat([scene.mat_cd[m], scene.mat_cs[m],
                     torch.stack([c[m] for c in cols], dim=1),
                     torch.zeros((m.shape[0], 1), dtype=torch.float32,
                                 device=m.device)], dim=1)
    return row.to(torch.float32).contiguous()


class LevelTables(NamedTuple):
    data: torch.Tensor  # (O,12) f32 packed objects
    types: torch.Tensor  # (O,) i32
    mrow: torch.Tensor  # (O,13) f32 per-object materials
    lights: torch.Tensor  # (L,9) f32 [pos, e1, e2]
    light_quad: torch.Tensor  # (L,) i32


def level_tables(scene: SceneData) -> LevelTables:
    spans.count("tables.builds.level_tables")
    data, types, _ = scene.packed_objects()
    lights = torch.cat([scene.light_pos, scene.light_e1, scene.light_e2],
                       dim=1).to(torch.float32).contiguous()
    quad = torch.as_tensor([int(q) for q in scene.static.light_quad],
                           dtype=torch.int32, device=data.device)
    return LevelTables(data.contiguous(), types.contiguous(),
                       pack_whitted_mats(scene), lights, quad)


def _norm3(x):
    return x * torch.rsqrt(torch.clamp(dot(x, x), min=1e-24))[..., None]


def _unpack(outs, valid, spawn: bool):
    """(n_out, R) kernel outputs -> the ``_shade_node`` dict."""
    hit = outs[3] > 0.0
    res = {"direct": outs[0:3].T, "miss": valid & ~hit, "valid": valid,
           "_hit": hit}
    if spawn:
        res.update({
            "refr_valid": outs[4] > 0.0,
            "refr_o": outs[5:8].T,
            "refr_d": outs[8:11].T,
            "refr_ior": outs[11],
            "refr_weight": outs[12:15].T,
            "refl_valid": outs[15] > 0.0,
            "refl_o": outs[16:19].T,
            "refl_d": outs[19:22].T,
            "refl_ior": outs[22],
            "refl_weight": outs[23:26].T,
            "child_ls": outs[26:29].T,
        })
    return res


def fused_level_plain(scene: SceneData, cfg, o, d, time, ior, light_sample,
                      valid, spawn: bool,
                      tables: Optional[LevelTables] = None, grid_bbox=None):
    """Plain torch version of K3 (same outputs as the kernel)."""
    return _unpack(_plain_rows(scene, cfg, o, d, time, ior, light_sample,
                               valid, spawn, tables, grid_bbox), valid, spawn)


def _plain_rows(scene: SceneData, cfg, o, d, time, ior, light_sample, valid,
                spawn: bool, tables: Optional[LevelTables], grid_bbox):
    """The plain K3's (4 or 29, R) output rows, the kernel's layout."""
    tb = tables if tables is not None else level_tables(scene)
    st = scene.static
    R = o.shape[0]
    f32 = dict(dtype=torch.float32, device=o.device)
    h = closest_hit_brute(scene, o, d, time, cfg.motion_blur)
    hit, gid = h.hit, h.obj_id
    # the fold winner's material, kept when the grid gate drops the hit
    m = torch.where(hit[:, None], tb.mrow[torch.clamp(gid, min=0).long()],
                    torch.zeros((), **f32))
    if grid_bbox is not None:
        ok, *_, t1 = grid_slab(*grid_bbox, o, d)
        hit = hit & ok & (h.t < t1)
    cd, cs = m[:, 0:3], m[:, 3:6]
    kd, ks, kr, shine, trans, mat_ior = (m[:, k] for k in range(6, 12))

    n = _norm3(h.normal)
    hit_mask = hit & valid
    t_hit = h.t
    t_safe = torch.where(hit, t_hit, torch.ones_like(t_hit))
    p = o + d * t_safe[:, None]
    outside = dot(d, n) < 0.0
    N = n * torch.where(outside, 1.0, -1.0)[:, None]
    v = -_norm3(d)

    # ---- direct lighting (main.cpp:383-451) ----
    direct = torch.zeros((R, 3), **f32)
    ll = torch.zeros((R, 3), **f32)
    pending = []
    for j in range(st.n_lights):
        lp = tb.lights[j, 0:3]
        if st.light_quad[j]:
            lp = (lp + tb.lights[j, 3:6] * light_sample[:, 0:1]
                  + tb.lights[j, 6:9] * light_sample[:, 1:2])
        else:
            lp = lp.expand(R, 3)
        ll = lp
        ul = lp - p
        dist_true = torch.sqrt(torch.clamp(dot(ul, ul), min=1e-24))
        L = ul / dist_true[:, None]
        H = _norm3(L + v)
        ndl = torch.clamp(dot(N, L), min=0.0)
        ndh = torch.clamp(dot(N, H), min=0.0)
        spec = torch.pow(torch.clamp(ndh, min=1e-12), shine)
        contrib = cd * (kd * ndl)[:, None] + cs * (ks * spec)[:, None]
        sdist = (torch.ones_like(dist_true) if cfg.shadow_mode == "reference"
                 else dist_true)
        pending.append((contrib, L, sdist))
    if pending:
        nl = len(pending)
        sorg = p + N * OFFSET
        so, sd = sorg.repeat(nl, 1), torch.cat([q[1] for q in pending])
        if grid_bbox is None:
            occ = any_hit_brute(scene, so, sd, torch.zeros((nl * R,), **f32),
                                torch.cat([q[2] for q in pending]),
                                gid.repeat(nl), cfg.motion_blur)
        else:
            occ = any_hit_brute(scene, so, sd, torch.zeros((nl * R,), **f32),
                                torch.cat([q[2] for q in pending]), None,
                                cfg.motion_blur, mode="grid")
            occ = occ | ~grid_slab(*grid_bbox, so, sd)[0]
        occ = occ.reshape(nl, R)
        for (contrib, _, _), oc in zip(pending, occ):
            lit = hit_mask & ~oc
            direct = direct + torch.where(lit[:, None], contrib,
                                          torch.zeros((), **f32))

    outs = [direct[:, 0], direct[:, 1], direct[:, 2], hit.to(torch.float32)]
    if spawn:
        ior1 = ior
        ior2 = torch.where(outside, mat_ior, torch.ones_like(mat_ior))
        eta = ior1 / ior2
        vdn = dot(v, N)
        vt = N * vdn[:, None] - v
        sin_i = safe_sqrt(dot(vt, vt))
        th = vt * (1.0 / torch.clamp(sin_i, min=1e-12))[:, None]
        sin_t = eta * sin_i
        no_tir = sin_t < 1.0
        cos_t = safe_sqrt(1.0 - sin_t * sin_t)
        rn = torch.where((sin_i > 0.0)[:, None],
                         th * sin_t[:, None] - N * cos_t[:, None], -N)
        rd = _norm3(rn)
        cos_theta = torch.where(ior1 > ior2, cos_t, vdn)
        r0 = ((ior1 - ior2) / (ior1 + ior2)) ** 2
        fres = r0 + (1.0 - r0) * torch.clamp(1.0 - cos_theta, min=0.0) ** 5
        do_refr = hit_mask & (trans == 1.0) & no_tir
        krf = torch.where(do_refr, fres, torch.where(
            hit_mask & (trans > 0.0) & ~no_tir, torch.ones_like(kr), kr))
        t_beer = torch.where(hit_mask & ~outside, t_hit,
                             torch.zeros_like(t_hit))
        fl = _norm3(N * (2.0 * vdn)[:, None] - v)
        do_refl = hit_mask & (ks > 0.0) & (dot(fl, N) > 0.0)
        beer = torch.where(outside[:, None], torch.ones_like(cd),
                           torch.exp((1.0 - cd) * (-t_beer[:, None])))
        refr_w = torch.where(do_refr[:, None], beer * (1.0 - krf)[:, None],
                             torch.zeros((), **f32))
        refl_w = torch.where(do_refl[:, None], cs * krf[:, None],
                             torch.zeros((), **f32))
        ro, fo = p - N * OFFSET, p + N * OFFSET
        outs += ([do_refr.to(torch.float32)] + list(ro.T) + list(rd.T)
                 + [ior2] + list(refr_w.T)
                 + [do_refl.to(torch.float32)] + list(fo.T) + list(fl.T)
                 + [ior1] + list(refl_w.T) + list(ll.T))
    return torch.stack(outs)


# The tree loop's route (``next`` given): K3's (10, R) output rows are the
# rows of its 29-row output that the bottom-up combine reads, [direct3,
# hit, refr_weight3, refl_weight3]; a child's 11 rays rows (ox oy oz dx dy
# dz time ior lsx lsy valid) are these rows of the 29, None for time 0.
COMBINE_ROWS = (0, 1, 2, 3, 12, 13, 14, 23, 24, 25)
_CHILD_ROWS = {"refr": (5, 6, 7, 8, 9, 10, None, 11, 26, 27, 4),
               "refl": (16, 17, 18, 19, 20, 21, None, 22, 26, 27, 15)}


def level_into_plain(scene: SceneData, cfg, rays, next, tile: int, kinds,
                     tables: Optional[LevelTables] = None, grid_bbox=None):
    """Plain torch version of :func:`fused_level_into`: writes every row of
    ``next`` (the kernel writes only a dead child's valid row)."""
    o, d, ls = (rays[a:a + w].T.contiguous() for a, w in ((0, 3), (3, 3),
                                                          (8, 2)))
    rows = _plain_rows(scene, cfg, o, d, rays[6], rays[7], ls,
                       rays[10] != 0.0, next is not None, tables, grid_bbox)
    if next is None:
        return rows
    zero = torch.zeros_like(rows[0])
    kids = [torch.stack([zero if r is None else rows[r]
                         for r in _CHILD_ROWS[k]]).reshape(11, -1, tile)
            for k in kinds]  # each (11, n, tile)
    next.copy_(torch.stack(kids, dim=2).reshape(next.shape))
    return rows[list(COMBINE_ROWS)]


def grid_box(grid_bbox, device) -> torch.Tensor:
    """The grid's (bbox_min, bbox_max) as K3's (6,) f32 tensor."""
    spans.count("tables.builds.grid_box")
    lo, hi = (torch.as_tensor(b, dtype=torch.float32).reshape(3).to(device)
              for b in grid_bbox)
    return torch.cat([lo, hi]).contiguous()


def launch_level(tb: LevelTables, n_obj: int, rays, cfg, spawn: bool, out,
                 gbox: Optional[torch.Tensor] = None, next=None,
                 tile: int = 0, kinds=()):
    """K3 on packed (11, R) rays into (4 or 29, R) f32 outputs, in grid
    mode when ``gbox`` (:func:`grid_box`) is given; counts nothing (the
    wrappers below pack, launch and count).  Given ``next`` (spawn only),
    into (10, R) ``out`` (:data:`COMBINE_ROWS`) and the children into
    ``next``, as :func:`fused_level_into` says."""
    refr_k, refl_k = (kinds.index(k) if k in kinds else -1
                      for k in ("refr", "refl"))
    with torch.cuda.device(rays.device):
        err = build.load().lib.drt_whitted_level(
            tb.data.data_ptr(), tb.types.data_ptr(), tb.mrow.data_ptr(),
            n_obj, tb.lights.data_ptr(),
            tb.light_quad.data_ptr(), tb.lights.shape[0],
            None if gbox is None else gbox.data_ptr(),
            rays.data_ptr(), rays.shape[1], int(cfg.motion_blur), int(spawn),
            int(cfg.shadow_mode == "reference"), out.data_ptr(),
            None if next is None else next.data_ptr(), tile, refr_k, refl_k,
            torch.cuda.current_stream().cuda_stream)
    build.check(err, "drt_whitted_level")


def _checked_launch(scene: SceneData, cfg, rays, spawn: bool, n_out: int,
                    tb: LevelTables, grid_bbox, next=None, tile: int = 0,
                    kinds=()):
    """Checks the tensors, launches K3 on packed (11, R) ``rays`` into a
    new (``n_out``, R) output, counts the launch; returns the output."""
    gbox = None if grid_bbox is None else grid_box(grid_bbox, rays.device)
    require_cuda("fused_level", rays, tb.data, tb.types, tb.mrow, tb.lights,
                 tb.light_quad, *(() if gbox is None else (gbox,)),
                 *(() if next is None else (next,)))
    out = torch.empty((n_out, rays.shape[1]), dtype=torch.float32,
                      device=rays.device)
    launch_level(tb, scene.static.n_objects, rays, cfg, spawn, out, gbox,
                 next, tile, kinds)
    LAUNCHES["fused_level" if gbox is None else "fused_level_grid"] += 1
    return out


def fused_level_kernel(scene: SceneData, cfg, o, d, time, ior, light_sample,
                       valid, spawn: bool,
                       tables: Optional[LevelTables] = None, grid_bbox=None):
    """K3 on CUDA tensors.  Lanes with ``valid`` false get zero outputs."""
    tb = tables if tables is not None else level_tables(scene)
    R = o.shape[0]
    rays = ray_streams(R, o[:, 0], o[:, 1], o[:, 2], d[:, 0], d[:, 1],
                       d[:, 2], time, ior, light_sample[:, 0],
                       light_sample[:, 1], valid.to(torch.float32))
    return _unpack(_checked_launch(scene, cfg, rays, spawn, 29 if spawn
                                   else 4, tb, grid_bbox), valid, spawn)


def fused_level(scene: SceneData, cfg, o, d, time, ior, light_sample, valid,
                spawn: bool, tables: Optional[LevelTables] = None,
                grid_bbox=None):
    """K3: plain version for CPU tensors, the kernel for CUDA tensors;
    ``grid_bbox`` selects the grid mode."""
    if o.device.type == "cpu":
        return fused_level_plain(scene, cfg, o, d, time, ior, light_sample,
                                 valid, spawn, tables, grid_bbox)
    return fused_level_kernel(scene, cfg, o, d, time, ior, light_sample,
                              valid, spawn, tables, grid_bbox)


def level_into_kernel(scene: SceneData, cfg, rays, next, tile: int, kinds,
                      tables: Optional[LevelTables] = None, grid_bbox=None):
    """K3 on CUDA tensors, as :func:`fused_level_into` says."""
    tb = tables if tables is not None else level_tables(scene)
    n = rays.shape[1]
    if next is not None and (n % tile or not kinds
                             or next.shape != (11, len(kinds) * n)):
        raise ValueError(f"next must be (11, {len(kinds) * n}) for {n} "
                         f"lanes of tile {tile}, kinds {kinds}; got "
                         f"{tuple(next.shape)}")
    return _checked_launch(scene, cfg, rays, next is not None,
                           4 if next is None else len(COMBINE_ROWS), tb,
                           grid_bbox, next, tile, kinds)


def fused_level_into(scene: SceneData, cfg, rays, next, tile: int, kinds,
                     tables: Optional[LevelTables] = None, grid_bbox=None):
    """One tree level on its (11, n * tile) f32 ray streams (:func:`
    launch_level`'s rows): lane ``j * tile + r`` is node ``j`` of primary
    ray ``r``.  Returns the rows the bottom-up combine reads: (4, .) [direct3,
    hit] on the last level (``next`` None), else (10, .) [direct3, hit,
    refr_weight3, refl_weight3]; and writes child ``k`` (the index of its
    kind in ``kinds``) of lane ``j * tile + r`` into lane ``(j * b + k) *
    tile + r`` of ``next``, the next level's (11, b * n * tile) streams, b =
    ``len(kinds)``.  The kernel writes a dead child (of an invalid lane)
    only its valid row, 0.  The plain version on CPU tensors and with
    ``kernels='off'`` (the grid mode's plain route), else K3."""
    if rays.device.type == "cpu" or cfg.kernels == "off":
        return level_into_plain(scene, cfg, rays, next, tile, kinds, tables,
                                grid_bbox)
    return level_into_kernel(scene, cfg, rays, next, tile, kinds, tables,
                             grid_bbox)
