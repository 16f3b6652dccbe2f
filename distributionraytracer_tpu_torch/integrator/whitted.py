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

Gradients: the kernels are forward-only and refuse tensors that require a
gradient (``ops.cuda_intersect.refuse_grad``).  On CPU tensors every route
differentiates by plain autodiff; on the card, gradients go through
:func:`differentiable_intersectors` (``parallel.mesh.accel_intersectors(...,
differentiable=True)``).  The two discontinuity estimators, soft shadows
(``cfg.soft_shadow``, in :func:`_shade_node`) and soft silhouettes
(:func:`trace_whitted_soft`), are plain torch on every device, as they are
jnp outside any Pallas kernel in the JAX package.

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
    EPSILON, FLT_MAX, OFFSET, clamp_color, dot, normalize, safe_div,
    safe_normalize, safe_sqrt,
)
from distributionraytracer_tpu_torch.ops.cubemap import skybox_color
from distributionraytracer_tpu_torch.ops.intersect import (
    HitResult, _moved, _type_gids, any_hit_brute, closest_hit_brute,
    hit_packed, slab_interval, soft_visibility, triangle_edge_margin,
)
from distributionraytracer_tpu_torch.scene.types import (
    ACCEL_BVH, OBJ_BOX, OBJ_PLANE, OBJ_SPHERE, OBJ_TRIANGLE, SceneData,
)
from distributionraytracer_tpu_torch.utils import spans

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
      (scenes without lights, so no shadow rays, and soft shadows, whose
      visibility ``_shade_node`` computes in plain torch);
    - ``plain``: the staged path in plain torch (``kernels='off'``).

    Passing ``inter=brute_intersectors(scene, cfg)`` to ``trace_whitted``
    takes the brute-kernel route on any scene.
    """
    if cfg.kernels == "off":
        return "plain"
    if CW.fused_supported(scene, cfg):
        return "fused-level"
    return "brute-kernel"


def _tile_mode(route: str, inter=None, fused_grid=None,
               soft_silhouette: float = 0.0, device_type: str = "cpu",
               needs_grad: bool = False, skybox: bool = False) -> str:
    """How each tile of a frame on level route ``route`` runs: ``staged``
    on ``inter`` (else on :func:`brute_intersectors`, off the K3 routes),
    ``soft`` (:func:`trace_whitted_soft`), ``k3`` (the fused-level route or
    ``fused_grid``), or ``graph``: K3 replayed as CUDA graphs
    (``integrator.render.TileGraphs``) for CUDA tiles with no gradient
    recorded (the kernels refuse one) and no skybox (its lookup copies
    host constants, which a capture does not allow).  The defaults are an
    eager hard trace's, :func:`trace_whitted`'s."""
    if inter is not None:
        return "staged"
    if soft_silhouette > 0.0:
        return "soft"
    if fused_grid is None and route != "fused-level":
        return "staged"
    if (fused_grid is None and device_type == "cuda" and not needs_grad
            and not skybox):
        return "graph"
    return "k3"


def brute_intersectors(scene: SceneData, cfg: RenderConfig,
                       tables: Optional[CI.ObjectTables] = None
                       ) -> Intersectors:
    """Accel NONE: linear scans (main.cpp:310-336, 432-440), through the
    K1/K2 wrappers unless ``kernels='off'`` (the ``plain`` route)."""
    mb = cfg.motion_blur
    if cfg.kernels == "off":
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


def differentiable_intersectors(scene: SceneData, cfg: RenderConfig,
                                base: Intersectors) -> Intersectors:
    """Make forward-only intersectors differentiable.

    The kernels (and the accel walks' discrete decisions: visit order,
    early exits) carry no gradient.  ``base`` runs under
    ``torch.no_grad()`` on detached rays to select each lane's winning
    object; that object's hit (t, normal) is then recomputed in plain torch
    from ``scene``'s gradient-carrying packed rows (:func:`hit_packed`, the
    kernels' operation order), so gradients reach geometry and camera as
    on the plain brute route.  Shadow occlusion stays the base's hard
    boolean (``cfg.soft_shadow`` is the relaxed estimator).  ``base`` must
    be built from detached tables (``parallel.mesh.accel_intersectors(...,
    differentiable=True)`` builds it so).
    """
    data, types, _ = scene.packed_objects()
    types_present = tuple(sorted(set(scene.static.obj_types)))
    mb = cfg.motion_blur

    def closest(o, d, time, valid=None):
        with torch.no_grad():
            h = base.closest(o.detach(), d.detach(), time.detach(),
                             valid=valid)
        gid = torch.clamp(h.obj_id, min=0).long()
        t, nrm = hit_packed(o, d, time, torch.index_select(data, 0, gid),
                            types[gid], mb, types_present=types_present)
        # a lane the base hits keeps its hit: where the recomputation
        # rounds to a miss (an edge, in the last bit), the base's t, which
        # carries no gradient, stands in for FLT_MAX
        return HitResult(
            hit=h.hit, t=torch.where(h.hit & (t < FLT_MAX), t, h.t),
            normal=torch.where(h.hit[:, None], nrm, 0.0),
            obj_id=h.obj_id, mat_id=h.mat_id)

    def shadow(o, d, dist, exclude_obj, valid=None):
        with torch.no_grad():
            return base.shadow(o.detach(), d.detach(), dist.detach(),
                               exclude_obj, valid=valid)

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


def _tree_shape(scene: SceneData, cfg: RenderConfig):
    """(kinds, levels) of the ray tree: the child kinds a node spawns
    (statically dead ones pruned) and the number of levels."""
    st = scene.static
    kinds = tuple(
        k for k, possible in (("refr", st.any_refr), ("refl", st.any_refl))
        if possible or not cfg.static_prune)
    return kinds, (cfg.max_depth + 1) if kinds else 1


def tree_nodes(scene: SceneData, cfg: RenderConfig) -> int:
    """Nodes of one primary ray's tree (31 at depth 4 with both kinds):
    ``whitted.lanes`` counts this many lanes a sample."""
    kinds, levels = _tree_shape(scene, cfg)
    return sum(len(kinds) ** level for level in range(levels))


def levels_in_place(scene: SceneData, cfg: RenderConfig) -> int:
    """Levels of a K3-route tree whose children K3 writes into the next
    level's ray streams (``whitted.levels_in_place``): all but the last."""
    return _tree_shape(scene, cfg)[1] - 1


def trace_whitted(scene: SceneData, cfg: RenderConfig, o, d, time,
                  light_sample, inter: Optional[Intersectors] = None,
                  fused_grid=None, count_rays: bool = False,
                  tables: Optional[CW.LevelTables] = None):
    """Trace a batch of primary rays; returns (color (R,3), stats dict).

    ``light_sample``: (R,3) per-ray sample for quad lights (only .x/.y
    used), the ``lightSample`` argument of ``rayTracing`` (main.cpp:294).
    ``fused_grid`` (the grid's ``(bbox_min, bbox_max)``) runs each level on
    K3 in grid mode (its plain version with ``kernels='off'``).

    The rays are counted only when someone reads the counts: with
    ``count_rays`` the stats hold ``rays_traced`` (tree nodes) and
    ``shadow_rays`` as int64 tensors, else they are empty; while the
    recorder (``utils.spans``) is on, each level adds its live lanes
    (``whitted.lanes_live``, the level's share of ``rays_traced``) and its
    shadow rays (``whitted.shadow_rays``) to the recorder's device counts.
    Otherwise nothing is launched to count rays.

    Given ``inter``, every level is staged on it (:func:`_expand_staged`);
    else, given ``tables`` (``CW.level_tables(scene)``, built by the caller
    once for all its tiles), on K3 (:func:`_expand_k3`).  Given neither,
    the K3 routes (:func:`_tile_mode`) raise, and every other is staged on
    :func:`brute_intersectors`.
    """
    if inter is None and tables is None:
        if _tile_mode(level_route(scene, cfg), None, fused_grid) != "staged":
            raise ValueError("the K3 routes read the caller's K3 tables: "
                             "pass tables=CW.level_tables(scene)")
        inter = brute_intersectors(scene, cfg)
    counting = count_rays or spans.enabled()
    if inter is None:
        lvl, live, shadows = _expand_k3(scene, cfg, o, d, time, light_sample,
                                        tables, fused_grid, counting)
    else:
        lvl, live, shadows = _expand_staged(scene, cfg, o, d, time,
                                            light_sample, inter, counting)
    with spans.span("whitted.combine"):
        color = _combine(lvl, _tree_shape(scene, cfg)[0], o.device)
    stats = {}
    if count_rays:
        stats = {"rays_traced": torch.stack(live).sum(),
                 "shadow_rays": torch.stack(shadows).sum()}
    return color, stats


def _count_level(scene, R, n, valid, hit, live, shadows, counting):
    """A level's ray counts: ``whitted.lanes`` always; its live lanes and
    shadow rays, on the device, only when they are read."""
    spans.count("whitted.lanes", R * n)
    if counting:
        live.append(valid.sum())
        shadows.append(scene.static.n_lights * (valid & hit).sum())
        spans.count_device("whitted.lanes_live", live[-1])
        spans.count_device("whitted.shadow_rays", shadows[-1])


def _expand_k3(scene, cfg, o, d, time, light_sample, tables, fused_grid,
               counting):
    """The top-down pass on K3 (:func:`CW.fused_level_into`): one (11,
    n*R) f32 ray-stream buffer a level, node-major (lane ``j*R + r`` is
    node ``j`` of ray ``r``), into which the level before wrote its
    children; returns the levels' combine inputs, node-major (R, n, ...)
    views of K3's output rows, and the count lists."""
    kinds, levels = _tree_shape(scene, cfg)
    R, dev = o.shape[0], o.device
    ones = torch.ones((R,), dtype=torch.float32, device=dev)
    rays = CI.ray_streams(R, o[:, 0], o[:, 1], o[:, 2], d[:, 0], d[:, 1],
                          d[:, 2], time, ones, light_sample[:, 0],
                          light_sample[:, 1], ones)
    # _miss_color's skybox lookup reads every lane's d, so there a dead
    # child's rows, which K3 does not write, are zeros
    alloc = torch.zeros if scene.static.has_skybox else torch.empty
    lvl, live, shadows = [], [], []
    for level in range(levels):
        with spans.span("whitted.level"):
            n = rays.shape[1] // R
            nxt = None
            if level < levels - 1:
                nxt = alloc((11, len(kinds) * n * R), dtype=torch.float32,
                            device=dev)
            with spans.span("whitted.intersect"):
                out = CW.fused_level_into(scene, cfg, rays, nxt, R, kinds,
                                          tables, fused_grid)

            def unflat(a, n=n):
                return a.reshape((n, R) + a.shape[1:]).transpose(0, 1)

            valid, hit = rays[10] != 0.0, out[3] > 0.0
            _count_level(scene, R, n, valid, hit, live, shadows, counting)
            cur = {"direct": unflat(out[0:3].T), "valid": unflat(valid),
                   "miss": unflat(valid & ~hit),
                   "miss_color": unflat(_miss_color(scene, rays[3:6].T))}
            if nxt is not None:
                spans.count("whitted.levels_in_place")
                cur["refr_weight"] = unflat(out[4:7].T)
                cur["refl_weight"] = unflat(out[7:10].T)
                rays = nxt
            lvl.append(cur)
    return lvl, live, shadows


def _expand_staged(scene, cfg, o, d, time, light_sample, inter, counting):
    """The top-down pass staged on ``inter`` (:func:`_shade_node`), on
    (R, n, ...) node arrays with autograd; returns the levels' combine
    inputs and the count lists."""
    kinds, levels = _tree_shape(scene, cfg)
    branching = len(kinds)
    R, dev = o.shape[0], o.device
    lvl = []
    node_o = o[:, None, :]
    node_d = d[:, None, :]
    node_t = time[:, None]
    node_ior = torch.ones((R, 1), dtype=torch.float32, device=dev)
    node_ls = light_sample[:, None, :]
    node_valid = torch.ones((R, 1), dtype=torch.bool, device=dev)
    live, shadows = [], []

    for level in range(levels):
        with spans.span("whitted.level"):
            depth = level + 1
            n = node_o.shape[1]

            # node-major flattening: lanes run rays-within-node
            def flat(a, n=n):
                return a.transpose(0, 1).reshape((R * n,) + a.shape[2:])

            def unflat(a, n=n):
                return a.reshape((n, R) + a.shape[1:]).transpose(0, 1)

            spawn = depth <= cfg.max_depth and branching > 0
            fv = flat(node_valid)
            with spans.span("whitted.intersect"):
                hit: HitResult = inter.closest(
                    flat(node_o), flat(node_d), flat(node_t), valid=fv)
            res = _shade_node(scene, cfg, inter, flat(node_o),
                              flat(node_d), flat(node_t), flat(node_ior),
                              flat(node_ls), fv, hit, spawn_children=spawn)
            cur = {k: unflat(v) for k, v in res.items()}
            _count_level(scene, R, n, fv, hit.hit, live, shadows, counting)

            if spawn:
                # children: interleave the spawned kinds per node -> b*n
                def interleave(arrs):
                    if len(arrs) == 1:
                        return arrs[0]
                    stacked = torch.stack(arrs, dim=2)  # (R, n, b, ...)
                    return stacked.reshape((R, branching * n)
                                           + arrs[0].shape[2:])
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
    return lvl, live, shadows


def _combine(lvl, kinds, dev):
    """The bottom-up pass: each level's colour from its direct light and
    its children's clamped colours (see the module's docstring); returns
    the primary rays' (R, 3) colours."""
    branching = len(kinds)
    child_color = None
    for cur in reversed(lvl):
        if child_color is None:
            color = cur["direct"]
        else:
            acc = cur["direct"]
            for ci, k in enumerate(kinds):
                acc = acc + (clamp_color(child_color[:, ci::branching])
                             * cur[k + "_weight"])
            color = clamp_color(acc)
        color = torch.where(cur["miss"][..., None], cur["miss_color"],
                            color)
        color = torch.where(cur["valid"][..., None], color,
                            torch.zeros((), dtype=color.dtype, device=dev))
        child_color = color
    return child_color[:, 0]


def _miss_color(scene: SceneData, d):
    """The colour of rays ``d`` that hit nothing: the skybox texel when the
    scene has one, else the background colour (main.cpp:328-357)."""
    if scene.static.has_skybox:
        # contiguous: K3's streams hand a transposed view, whose sums
        # would round in another order
        return clamp_color(skybox_color(scene.sky_faces, scene.sky_res,
                                        d.contiguous()))
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
    # consumer is gated by hit_mask).  index_select, not x[m]: on the card
    # the backward of x[m] sorts the lanes' few distinct indices and sums
    # each run serially, where index_select's scatters with atomics (on an
    # H100, 68 against 0.63 ms a tree level of a 65,536-sample tile)
    m = torch.clamp(hit.mat_id, min=0).long()
    cd, cs, kd, ks, kr, shine, trans, mat_ior = (
        torch.index_select(x, 0, m) for x in (
            scene.mat_cd, scene.mat_cs, scene.mat_kd, scene.mat_ks,
            scene.mat_kr, scene.mat_shine, scene.mat_T, scene.mat_ior))

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
        if cfg.soft_shadow > 0.0:
            # relaxed visibility, smooth in the occluders' geometry so that
            # shadow edges have gradients (RenderConfig.soft_shadow); shadow
            # rays carry time 0
            vis = soft_visibility(
                scene, hit_p + N * OFFSET, Lb, torch.zeros((Rn,), **f32),
                torch.linalg.norm(L_un, dim=-1), hit.obj_id,
                cfg.soft_shadow, False) * hit_mask.to(torch.float32)
            direct = direct + contrib * vis[:, None]
            continue
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


# -------------------------------------------------- soft primary silhouettes
def _object_table(scene: SceneData, field: str, gid):
    """The static per-object ``obj_types`` / ``obj_tidx`` entry of each
    object id in ``gid`` (a miss, -1, reads object 0's)."""
    vals = getattr(scene.static, field) or (0,)
    tab = torch.as_tensor(vals, dtype=torch.int64, device=gid.device)
    return tab[torch.clamp(gid, min=0).long()]


def primary_coverage(scene: SceneData, o, d, time, hit: HitResult,
                     tau: float, motion_blur: bool):
    """Smooth coverage in [0, 1] of each ray's winning primitive.

    The counterpart of ``ops.intersect.soft_visibility`` for primary hits:
    hit-vs-miss of the closest primitive is a step in geometry and camera;
    its silhouette becomes a sigmoid of a signed world margin (sphere:
    r - closest approach; triangle: distance to the nearest edge; box: slab
    overlap).  Planes have no silhouette; misses return 1.
    """
    st = scene.static
    sub = _object_table(scene, "obj_tidx", hit.obj_id)
    wtype = _object_table(scene, "obj_types", hit.obj_id)
    alpha = torch.ones(o.shape[0], dtype=torch.float32, device=o.device)
    if st.n_spheres:
        i = torch.clamp(sub, 0, st.n_spheres - 1)
        c = scene.sph_center[i]
        if motion_blur:
            c = _moved(c, time)
        oc = c - o
        proj = dot(oc, d)
        b = torch.sqrt(torch.clamp(dot(oc, oc) - proj * proj, min=1e-12))
        a_s = torch.sigmoid((torch.abs(scene.sph_radius[i]) - b) / tau)
        alpha = torch.where(wtype == OBJ_SPHERE, a_s, alpha)
    if st.n_triangles:
        i = torch.clamp(sub, 0, st.n_triangles - 1)
        m, _ = triangle_edge_margin(o, d, scene.tri_v0[i], scene.tri_e1[i],
                                    scene.tri_e2[i])
        alpha = torch.where(wtype == OBJ_TRIANGLE, torch.sigmoid(m / tau),
                            alpha)
    if st.n_boxes:
        i = torch.clamp(sub, 0, st.n_boxes - 1)
        tmin, tmax = slab_interval(scene.box_min[i], scene.box_max[i], o, d)
        alpha = torch.where(wtype == OBJ_BOX,
                            torch.sigmoid((tmax - tmin) / tau), alpha)
    return torch.where(hit.hit, alpha, 1.0)


def _near_sphere(scene: SceneData, o, d, time, motion_blur: bool):
    """Per ray, the sphere in front of the origin with the smallest
    closest-approach distance ``b``: the silhouette candidate of rays that
    do not already hit a solid.  None when the scene has no sphere."""
    st = scene.static
    if not st.n_spheres:
        return None
    c = scene.sph_center[None, :, :]
    if motion_blur:
        c = _moved(c, time[:, None])
    oc = c - o[:, None, :]  # (R,N,3)
    proj = torch.einsum("rnk,rk->rn", oc, d)
    b = torch.sqrt(torch.clamp(dot(oc, oc) - proj * proj, min=1e-12))
    front = proj > 1e-3
    j = torch.argmin(torch.where(front, b, 3.4e38), dim=1)  # first minimum
    take = lambda m: torch.gather(m, 1, j[:, None])[:, 0]
    center = scene.sph_center[j]
    if motion_blur:
        center = _moved(center, time)
    return dict(b=take(b), proj=take(proj), has=take(front), center=center,
                radius=scene.sph_radius[j],
                gid=_type_gids(scene, OBJ_SPHERE, o.device)[j],
                mat=scene.sph_mat[j])


def trace_whitted_soft(scene: SceneData, cfg: RenderConfig, o, d, time,
                       light_sample, count_rays: bool = False):
    """Silhouette-aware trace: per ray, pick a silhouette candidate (the
    winning primitive, or, when the winner is a plane or a miss, the
    nearest in-front sphere closer than the winner, so that a sphere behind
    a wall never bleeds through) and blend

        c = alpha * c_with + (1 - alpha) * c_without

    ``alpha`` is the candidate's smooth coverage (:func:`primary_coverage`,
    or the sphere sigmoid), ``c_with`` forces near-miss rays onto the
    candidate sphere (shaded at the closest-approach point, whose limit at
    the edge is the grazing hit) and ``c_without`` excludes the candidate.
    The ramp spans both sides of the silhouette, so d(pixel)/d(geometry,
    camera) matches finite differences at sphere hit-vs-miss edges; away
    from edges alpha saturates and c is the hard image.

    A training estimator in plain torch on any device (``kernels='off'``,
    as the JAX package forces ``pallas='off'``), ~2x a hard forward.
    Winner triangles and boxes get the inside half of the ramp only.  The
    candidate is forced and excluded on the primary level only: child rays
    trace the full scene.  The statistics are ``c_with``'s trace's
    (``count_rays`` as in :func:`trace_whitted`).
    """
    cfg = cfg.replace(kernels="off")
    mb, tau = cfg.motion_blur, cfg.soft_silhouette
    R = o.shape[0]
    h1 = closest_hit_brute(scene, o, d, time, mb)
    ns = _near_sphere(scene, o, d, time, mb)
    wtype = _object_table(scene, "obj_types", h1.obj_id)
    winner_solid = h1.hit & (wtype != OBJ_PLANE)
    if ns is not None:
        sph_ok = ns["has"] & (ns["proj"] < h1.t) & ~winner_solid
        cand = torch.where(winner_solid, h1.obj_id,
                           torch.where(sph_ok, ns["gid"], -1))
        a_f = torch.sigmoid((torch.abs(ns["radius"]) - ns["b"]) / tau)
    else:
        sph_ok = torch.zeros((R,), dtype=torch.bool, device=o.device)
        cand, a_f = torch.where(winner_solid, h1.obj_id, -1), 1.0
    alpha = torch.where(sph_ok, a_f, torch.where(
        winner_solid, primary_coverage(scene, o, d, time, h1, tau, mb), 1.0))

    plain = brute_intersectors(scene, cfg)

    def primary_first(query):
        """Intersectors whose first closest call, the primary level's,
        is ``query``; every later level and every shadow ray take the
        plain scans."""
        calls = []

        def closest(o2, d2, t2, valid=None):
            calls.append(None)
            if len(calls) > 1:
                return plain.closest(o2, d2, t2)
            return query(o2, d2, t2)
        return Intersectors(closest, plain.shadow)

    def closest_with(o2, d2, t2):
        h = closest_hit_brute(scene, o2, d2, t2, mb)
        if ns is None:
            return h
        f = sph_ok  # the candidate sphere as a grazing pseudo-hit
        # EPSILON toward the camera: at the exact closest approach the
        # normal is perpendicular to the ray, and the shader's facing test
        # dot(d, N) < 0 becomes a coin flip that flips the shading; just
        # before it the classification is stably "outside", the
        # grazing-hit limit, and the colour stays continuous
        t_f = ns["proj"] - EPSILON
        n_f = safe_normalize(o2 + d2 * t_f[:, None] - ns["center"])
        return HitResult(
            hit=h.hit | f, t=torch.where(f, t_f, h.t),
            normal=torch.where(f[:, None], n_f, h.normal),
            obj_id=torch.where(f, ns["gid"], h.obj_id),
            mat_id=torch.where(f, ns["mat"], h.mat_id))

    def closest_without(o2, d2, t2):
        return closest_hit_brute(scene, o2, d2, t2, mb, exclude_obj=cand)

    c1, stats = trace_whitted(scene, cfg, o, d, time, light_sample,
                              inter=primary_first(closest_with),
                              count_rays=count_rays)
    c2, _ = trace_whitted(scene, cfg, o, d, time, light_sample,
                          inter=primary_first(closest_without))
    return alpha[:, None] * c1 + (1.0 - alpha[:, None]) * c2, stats
