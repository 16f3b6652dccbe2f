"""Whitted/distribution integrator as a bounded ray tree.

Counterpart of ``distributionraytracer_tpu.integrator.whitted``.  The
reference's ``rayTracing`` (main.cpp:294-521) is a depth-bounded recursion
spawning at most a refraction child (``T == 1`` and no TIR) and a
reflection child (``ks > 0``) per hit, clamping every child's colour at the
call site.  The clamp is non-linear, so the complete fixed tree is
evaluated:

- a top-down pass expands rays level by level (``max_depth + 1`` levels,
  31 nodes for depth 4), batched over rays x nodes;
- a bottom-up pass combines colours with the exact clamp placement:
  ``clamp(direct + clamp(c_refr) * beer * (1-F) + clamp(c_refl) * F * cs)``.

Statically dead subtrees (no ``T == 1`` material, no ``Ks > 0`` material)
are pruned.  Each level runs on one of three routes (:func:`level_route`):
the fused level kernel K3, the staged brute kernels K1/K2 with
:func:`_shade_node`, or the staged plain torch code.  Given intersectors
(an accel's), every level is staged on them; given ``fused_grid``, every
level runs on K3 in grid mode.  On CPU tensors every kernel wrapper runs
its plain version.

Reference quirks kept: normal flip when hit from inside; Blinn-Phong
ignoring the light colour; the accel-NONE shadow distance 1.0 in
'reference' shadow mode; Schlick cos selection; Beer on exit; TIR forcing
F = 1; children carry ``time = 0``; children receive the last light's
world position as their light sample (main.cpp:489, 512).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from distributionraytracer_tpu_torch.config import RenderConfig
from distributionraytracer_tpu_torch.ops import cuda_intersect as CI
from distributionraytracer_tpu_torch.ops import cuda_whitted as CW
from distributionraytracer_tpu_torch.ops.common import (
    OFFSET, clamp_color, dot, normalize, safe_div, safe_normalize, safe_sqrt,
)
from distributionraytracer_tpu_torch.ops.cubemap import skybox_color
from distributionraytracer_tpu_torch.ops.intersect import (
    HitResult, any_hit_brute, closest_hit_brute,
)
from distributionraytracer_tpu_torch.scene.types import ACCEL_BVH, SceneData

class Intersectors(NamedTuple):
    """Closest-hit / shadow functions for one accel structure.

    ``closest(o, d, time, valid=None) -> HitResult``
    ``shadow(o, d, dist, exclude_obj, valid=None) -> occluded (R,) bool``
    ``valid`` marks lanes whose result is consumed.
    """

    closest: Callable
    shadow: Callable


def level_route(scene: SceneData, cfg: RenderConfig) -> str:
    """How ``trace_whitted`` runs each tree level of an accel-NONE scene:

    - ``fused-level``: one K3 launch per level;
    - ``brute-kernel``: K1 closest hit, ``_shade_node``, K2 shadows
      (scenes without lights, so no shadow rays);
    - ``plain``: the staged path in plain torch (``kernels='off'``).

    Passing ``inter=brute_intersectors(scene, cfg)`` to ``trace_whitted``
    takes the brute-kernel route on any scene.
    """
    if cfg.kernels == "off":
        return "plain"
    if CW.fused_supported(scene, cfg):
        return "fused-level"
    return "brute-kernel"


def brute_intersectors(scene: SceneData, cfg: RenderConfig,
                       tables: Optional[CI.ObjectTables] = None
                       ) -> Intersectors:
    """Accel NONE: linear scans (main.cpp:310-336, 432-440), through the
    K1/K2 wrappers unless the route is ``plain``."""
    mb = cfg.motion_blur
    if level_route(scene, cfg) == "plain":
        def closest(o, d, time, valid=None):
            return closest_hit_brute(scene, o, d, time, mb)

        def shadow(o, d, dist, exclude_obj, valid=None):
            return any_hit_brute(scene, o, d, torch.zeros_like(dist), dist,
                                 exclude_obj, mb)

        return Intersectors(closest, shadow)

    tb = tables if tables is not None else CI.object_tables(scene)

    def closest(o, d, time, valid=None):
        return CI.closest_hit(scene, o, d, time, mb, valid=valid, tables=tb)

    def shadow(o, d, dist, exclude_obj, valid=None):
        return CI.any_hit(scene, o, d, dist, exclude_obj, mb, "none",
                          valid=valid, tables=tb)

    return Intersectors(closest, shadow)


def _shadow_terms(scene, cfg, accel, hit_p, N, light_pos, inter):
    """One light's shadow direction and distance with the reference's
    per-accel quirks (main.cpp:411-440)."""
    L_un = light_pos - hit_p
    dist_true = torch.linalg.norm(L_un, dim=-1)
    L = safe_normalize(L_un)
    if cfg.shadow_mode == "correct" or accel == ACCEL_BVH:
        return L, dist_true
    # NONE and GRID compare against a normalized direction: |L| == 1.0
    return L, torch.ones_like(dist_true)


def trace_whitted(scene: SceneData, cfg: RenderConfig, o, d, time,
                  light_sample, inter: Optional[Intersectors] = None,
                  fused_grid=None):
    """Trace a batch of primary rays; returns (color (R,3), stats dict).

    ``light_sample``: (R,3) per-ray sample for quad lights (only .x/.y
    used), the ``lightSample`` argument of ``rayTracing`` (main.cpp:294).
    ``fused_grid`` (the grid's ``(bbox_min, bbox_max)``) runs each level on
    K3 in grid mode (its plain version with ``kernels='off'``).
    The stats ``rays_traced`` and ``shadow_rays`` are int64 tensors.
    """
    level_tabs = None
    fused = CW.fused_level
    if inter is None:
        if fused_grid is not None:
            level_tabs = CW.level_tables(scene)
            if cfg.kernels == "off":
                fused = CW.fused_level_plain
        elif level_route(scene, cfg) == "fused-level":
            level_tabs = CW.level_tables(scene)
        else:
            inter = brute_intersectors(scene, cfg)
    st = scene.static
    R, dev = o.shape[0], o.device

    kinds = tuple(
        k for k, possible in (("refr", st.any_refr), ("refl", st.any_refl))
        if possible or not cfg.static_prune)
    branching = len(kinds)
    levels = (cfg.max_depth + 1) if branching else 1

    # ---------------- top-down expansion ----------------
    lvl = []
    node_o = o[:, None, :]
    node_d = d[:, None, :]
    node_t = time[:, None]
    node_ior = torch.ones((R, 1), dtype=torch.float32, device=dev)
    node_ls = light_sample[:, None, :]
    node_valid = torch.ones((R, 1), dtype=torch.bool, device=dev)
    rays_traced = torch.zeros((), dtype=torch.int64, device=dev)
    shadow_rays = torch.zeros((), dtype=torch.int64, device=dev)

    for level in range(levels):
        depth = level + 1
        n = node_o.shape[1]

        # node-major flattening: lanes run rays-within-node
        def flat(a, n=n):
            return a.transpose(0, 1).reshape((R * n,) + a.shape[2:])

        def unflat(a, n=n):
            return a.reshape((n, R) + a.shape[1:]).transpose(0, 1)

        spawn = depth <= cfg.max_depth and branching > 0
        fv = flat(node_valid)
        if level_tabs is not None:
            res = fused(
                scene, cfg, flat(node_o), flat(node_d), flat(node_t),
                flat(node_ior), flat(node_ls), fv, spawn=spawn,
                tables=level_tabs, grid_bbox=fused_grid)
            hit_flags = res.pop("_hit")
            res["miss_color"] = _miss_color(scene, flat(node_d))
        else:
            hit: HitResult = inter.closest(flat(node_o), flat(node_d),
                                           flat(node_t), valid=fv)
            res = _shade_node(scene, cfg, inter, flat(node_o), flat(node_d),
                              flat(node_t), flat(node_ior), flat(node_ls),
                              fv, hit, spawn_children=spawn)
            hit_flags = hit.hit
        cur = {k: unflat(v) for k, v in res.items()}
        rays_traced += fv.sum()
        shadow_rays += st.n_lights * (fv & hit_flags).sum()

        if spawn:
            # children: interleave the spawned kinds per node -> b*n nodes
            def interleave(arrs):
                if len(arrs) == 1:
                    return arrs[0]
                stacked = torch.stack(arrs, dim=2)  # (R, n, b, ...)
                return stacked.reshape((R, branching * n) + arrs[0].shape[2:])
            node_o = interleave([cur[k + "_o"] for k in kinds])
            node_d = interleave([cur[k + "_d"] for k in kinds])
            node_ior = interleave([cur[k + "_ior"] for k in kinds])
            node_ls = interleave([cur["child_ls"]] * branching)
            node_valid = interleave([cur[k + "_valid"] for k in kinds])
            node_t = torch.zeros((R, branching * n), dtype=torch.float32,
                                 device=dev)  # children carry time = 0
        # keep only what the bottom-up combine reads
        lvl.append({k: v for k, v in cur.items()
                    if k in ("direct", "miss", "miss_color", "valid",
                             "refr_weight", "refl_weight")})

    # ---------------- bottom-up combine ----------------
    child_color = None
    for level in reversed(range(levels)):
        cur = lvl[level]
        if child_color is None:
            color = cur["direct"]
        else:
            acc = cur["direct"]
            for ci, k in enumerate(kinds):
                acc = acc + (clamp_color(child_color[:, ci::branching])
                             * cur[k + "_weight"])
            color = clamp_color(acc)
        color = torch.where(cur["miss"][..., None], cur["miss_color"], color)
        color = torch.where(cur["valid"][..., None], color,
                            torch.zeros((), dtype=color.dtype, device=dev))
        child_color = color

    return child_color[:, 0], {"rays_traced": rays_traced,
                               "shadow_rays": shadow_rays}


def _miss_color(scene: SceneData, d):
    """The colour of rays ``d`` that hit nothing: the skybox texel when the
    scene has one, else the background colour (main.cpp:328-357)."""
    if scene.static.has_skybox:
        return clamp_color(skybox_color(scene.sky_faces, scene.sky_res, d))
    return clamp_color(scene.bg_color.to(torch.float32)).expand(d.shape[0], 3)


def _shade_node(scene: SceneData, cfg: RenderConfig, inter: Intersectors,
                o, d, time, ior1, light_sample, valid, hit: HitResult,
                spawn_children: bool):
    """Shade one tree level (flattened rays) and emit child specs."""
    st = scene.static
    Rn = o.shape[0]
    f32 = dict(dtype=torch.float32, device=o.device)

    ior1 = ior1.reshape(Rn)
    hit_mask = hit.hit & valid
    t_hit = torch.where(hit.hit, hit.t, torch.ones_like(hit.t))
    hit_p = o + d * t_hit[:, None]
    # contiguous: the packet walks return the normal as a transposed (3, R)
    # view, and a sum over a strided axis rounds in another order, so the
    # shading would depend on which intersector found the hit
    N = safe_normalize(hit.normal.contiguous())
    outside = dot(d, N) < 0.0
    N = torch.where(outside[:, None], N, -N)
    V = -normalize(d)

    # material fetch: an index gather (miss lanes read material 0; every
    # consumer is gated by hit_mask)
    m = torch.clamp(hit.mat_id, min=0).long()
    cd, cs = scene.mat_cd[m], scene.mat_cs[m]
    kd, ks, kr = scene.mat_kd[m], scene.mat_ks[m], scene.mat_kr[m]
    shine, trans, mat_ior = scene.mat_shine[m], scene.mat_T[m], scene.mat_ior[m]

    # ---------------- direct lighting (main.cpp:383-451) ----------------
    direct = torch.zeros((Rn, 3), **f32)
    last_light_pos = torch.zeros((Rn, 3), **f32)
    pending = []
    for j in range(st.n_lights):
        if st.light_quad[j]:
            light_pos = (scene.light_pos[j]
                         + scene.light_e1[j] * light_sample[..., 0:1]
                         + scene.light_e2[j] * light_sample[..., 1:2])
        else:
            light_pos = scene.light_pos[j].expand(Rn, 3)
        last_light_pos = light_pos

        L_un = light_pos - hit_p
        Lb = safe_normalize(L_un)
        H = safe_normalize(Lb + V)
        NdotL = torch.clamp(dot(N, Lb), min=0.0)
        NdotH = torch.clamp(dot(N, H), min=0.0)
        spec = torch.pow(torch.clamp(NdotH, min=1e-12), shine)
        contrib = cd * (kd * NdotL)[:, None] + cs * (ks * spec)[:, None]
        sdir, sdist = _shadow_terms(scene, cfg, st.accel, hit_p, N,
                                    light_pos, inter)
        pending.append((contrib, sdir, sdist))

    # all lights' occlusion queries in one intersector call
    if pending:
        nl = len(pending)
        sorg = hit_p + N * OFFSET
        occ_all = inter.shadow(
            sorg.repeat(nl, 1), torch.cat([p[1] for p in pending]),
            torch.cat([p[2] for p in pending]), hit.obj_id.repeat(nl),
            valid=hit_mask.repeat(nl))
        for (contrib, _, _), occluded in zip(pending,
                                             occ_all.reshape(nl, Rn)):
            lit = hit_mask & ~occluded
            direct = direct + torch.where(lit[:, None], contrib,
                                          torch.zeros((), **f32))

    out = {
        "direct": direct,
        "miss": valid & ~hit.hit,
        "miss_color": _miss_color(scene, d),
        "valid": valid,
    }
    if not spawn_children:
        return out

    # ---------------- children (main.cpp:456-518) ----------------
    ior2 = torch.where(outside, mat_ior, torch.ones_like(mat_ior))
    eta = ior1 / ior2
    VdotN = dot(V, N)
    Vt = N * VdotN[:, None] - V
    sin_i = torch.linalg.norm(Vt, dim=-1)
    t_hat = safe_div(Vt, sin_i[:, None])
    sin_t = eta * sin_i
    no_tir = sin_t < 1.0
    cos_t = safe_sqrt(1.0 - sin_t * sin_t)
    # sin_i -> 0: refraction dir -> -N (the reference yields NaN there)
    refr_num = torch.where((sin_i > 0.0)[:, None],
                           t_hat * sin_t[:, None] - N * cos_t[:, None], -N)
    refr_dir = safe_normalize(refr_num)

    cos_theta = torch.where(ior1 > ior2, cos_t, VdotN)
    r0 = ((ior1 - ior2) / (ior1 + ior2)) ** 2
    fresnel = r0 + (1.0 - r0) * (1.0 - cos_theta) ** 5

    do_refr = hit_mask & (trans == 1.0) & no_tir
    # kr_fresnel: kr by default; Schlick when refracting; 1 on TIR
    krf = torch.where(do_refr, fresnel, torch.where(
        hit_mask & (trans > 0.0) & ~no_tir, torch.ones_like(kr), kr))

    # Beer term exp((1-cd) * (-t)) when exiting a medium (main.cpp:491-494)
    t_beer = torch.where(hit_mask & ~outside, hit.t, torch.zeros_like(hit.t))
    beer = torch.where(outside[:, None], torch.ones_like(cd),
                       torch.exp((1.0 - cd) * (-t_beer[:, None])))

    refl_dir = normalize(N * (2.0 * VdotN)[:, None] - V)
    do_refl = hit_mask & (ks > 0.0) & (dot(refl_dir, N) > 0.0)
    zero = torch.zeros((), **f32)
    out.update({
        "refr_valid": do_refr,
        "refr_o": hit_p - N * OFFSET,
        "refr_d": refr_dir,
        "refr_ior": ior2,
        "refr_weight": torch.where(do_refr[:, None],
                                   beer * (1.0 - krf)[:, None], zero),
        "refl_valid": do_refl,
        "refl_o": hit_p + N * OFFSET,
        "refl_d": refl_dir,
        "refl_ior": ior1,
        "refl_weight": torch.where(do_refl[:, None], cs * krf[:, None], zero),
        # recursion passes the last light's world pos as the sample
        "child_ls": last_light_pos,
    })
    return out
