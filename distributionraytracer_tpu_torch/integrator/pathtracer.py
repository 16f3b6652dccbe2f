"""Monte Carlo path tracer with P3D_RT.glsl semantics.

Counterpart of ``distributionraytracer_tpu.integrator.pathtracer``.
``rayColor`` (P3D_RT.glsl:583-676) becomes a Python loop over
``cfg.max_bounces`` (=10) with masked lanes instead of ``break``:

- ``hit_world``: linear scan over the scene tables with first-wins strict-<
  ordering (quads as two triangles, common.glsl:459-464; negative-radius
  normal flip, common.glsl:545; moving spheres with the shader's quadratic
  in d1 = velocity, common.glsl:551-605);
- emissive add when any component != 0 (P3D_RT.glsl:593-597);
- per-scene direct lighting: point lights cast hard shadow rays
  (P3D_RT.glsl:543-548), quad lights sample a jittered point but cast NO
  shadow ray (P3D_RT.glsl:491-494) — both reference quirks preserved, along
  with the quad version passing ``-viewDir = r.d`` as the GGX view vector
  (P3D_RT.glsl:511 vs 564) and the doubled ``max(N.L, 0)`` factor on the
  diffuse term (P3D_RT.glsl:500+519);
- ``scatter`` per material type (common.glsl:300-407);
- Russian roulette on the max throughput channel with 1/p boost
  (P3D_RT.glsl:651-656);
- miss: sky gradient (scene 0) or GL cubemap with SRGBToLinear (x1 or x3,
  P3D_RT.glsl:661-671).

``ray_color`` has the JAX package's two bodies: the fused body, K6 with
the cubemap miss latched and gathered once after the loop, and the staged
body (closest query, per-light occlusion, direct light, ``scatter``,
roulette, sky) over a :class:`PTQueries` pair.  The fused body is one
``cuda_pt.pt_trace`` call for every bounce: one looped K6 launch on CUDA
tensors, B plain bounces on CPU tensors.  Random numbers come from a
``torch.Generator``, drawn per bounce in one fixed order by both bodies
(the looped launch draws its B bounces up front in that order:
:func:`draw_bounces`), or are injected (:class:`BounceUniforms`).

GLSL leaves ``atten`` undefined on some non-writing paths (out-param
semantics); those paths use atten = 1 here, documented deviations.

Spans and counters (``utils/spans.py``, off by default): ``pt.frame``
(``render_pt``), ``pt.tile`` (one ``ray_color`` call of
``ray_color_tiled``), ``pt.bounce`` (one bounce of the staged body; the
fused body's one ``pt_trace`` call, every bounce), ``pt.intersect`` (the staged body's
queries), ``pt.sky`` (the fused body's cubemap gather); ``pt.paths`` (a
tile's paths at each bounce) and ``pt.paths_live`` (those alive at the
bounce's start, counted on the device only while the recorder is on: by
the looped K6 itself on CUDA tensors); ``pt.draws`` (the generator's
``torch.rand`` calls: a frame's jitter and times, and each bounce's five
uniforms, where nothing is injected).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from distributionraytracer_tpu_torch.config import RenderConfig
from distributionraytracer_tpu_torch.ops import cuda_pt as CP
from distributionraytracer_tpu_torch.ops.common import (
    cross, dot, normalize, safe_normalize, safe_sqrt,
)
from distributionraytracer_tpu_torch.ops.cubemap import gl_cubemap_color
from distributionraytracer_tpu_torch.scene.pt_scenes import (
    MT_DIELECTRIC, MT_DIFFUSE, MT_METAL, MT_PLASTIC, PTScene,
    SKY_CUBEMAP_X3, SKY_GRADIENT,
)
from distributionraytracer_tpu_torch.utils import spans

EPS = 1e-3  # common.glsl:7
PI = 3.14159265358979
_INF = float(np.float32(3.4e38))


class PTHit(NamedTuple):
    hit: torch.Tensor
    t: torch.Tensor
    pos: torch.Tensor
    normal: torch.Tensor
    mat: torch.Tensor  # material id


def _cols(a):
    """(N,3) table -> three (N,1) columns (broadcast against (R,))."""
    return a[:, 0:1], a[:, 1:2], a[:, 2:3]


def _first_min(tm):
    """(N,R) -> (min over N, first index attaining it)."""
    idx = torch.argmin(tm, dim=0)
    return tm.gather(0, idx[None])[0], idx


def _tri_t(scene: PTScene, o, d, tmin):
    """hit_triangle (common.glsl:418-447) over every triangle: (T,R) t."""
    ox, oy, oz = o[:, 0], o[:, 1], o[:, 2]
    dx, dy, dz = d[:, 0], d[:, 1], d[:, 2]
    v0x, v0y, v0z = _cols(scene.tri_v0)
    e1x, e1y, e1z = _cols(scene.tri_e1)
    e2x, e2y, e2z = _cols(scene.tri_e2)
    hx = dy * e2z - dz * e2y
    hy = dz * e2x - dx * e2z
    hz = dx * e2y - dy * e2x
    a = e1x * hx + e1y * hy + e1z * hz
    nz = a != 0.0
    f = 1.0 / torch.where(nz, a, 1.0)
    sx, sy, sz = ox - v0x, oy - v0y, oz - v0z
    u = f * (sx * hx + sy * hy + sz * hz)
    qx = sy * e1z - sz * e1y
    qy = sz * e1x - sx * e1z
    qz = sx * e1y - sy * e1x
    v = f * (qx * dx + qy * dy + qz * dz)
    t = f * (e2x * qx + e2y * qy + e2z * qz)
    ok = (nz & (u >= 0) & (u <= 1) & (v >= 0) & (u + v <= 1) & (t > tmin))
    return t, ok


def _roots(a, b, disc):
    pos_d = disc > 0
    sq = torch.where(pos_d, torch.sqrt(torch.where(pos_d, disc, 1.0)), 0.0)
    t1 = (-b - sq) / (2 * a)
    t2 = (-b + sq) / (2 * a)
    return t1, torch.where(t1 > EPS, t1, t2)


def _sph_t(scene: PTScene, o, d, a_dd, tmin):
    """hit_sphere (common.glsl:513-549) over every sphere: (S,R) t."""
    cx, cy, cz = _cols(scene.sph_center)
    rad2 = (scene.sph_radius ** 2)[:, None]
    ocx, ocy, ocz = o[:, 0] - cx, o[:, 1] - cy, o[:, 2] - cz
    dx, dy, dz = d[:, 0], d[:, 1], d[:, 2]
    b = 2.0 * (ocx * dx + ocy * dy + ocz * dz)
    c = ocx * ocx + ocy * ocy + ocz * ocz - rad2
    disc = b * b - 4 * a_dd * c
    _, t = _roots(a_dd, b, disc)
    return t, (disc >= 0) & (t > EPS) & (t > tmin)


def _msph_quadratic(scene: PTScene, o, d, time, a_dd, tmin):
    """hit_movingSphere (common.glsl:551-605) over every moving sphere.

    center(t) = c0 + (c1-c0) * time; the GLSL path evaluates
    d1 = center(time+EPS) - center(time) = (c1-c0) * EPS, which is
    time-independent — an (M,1) column, not an (M,R) plane."""
    ax_, ay_, az_ = _cols(scene.msph_c0)
    bx_ = scene.msph_c1[:, 0:1] - ax_
    by_ = scene.msph_c1[:, 1:2] - ay_
    bz_ = scene.msph_c1[:, 2:3] - az_
    c0 = (ax_ + bx_ * time, ay_ + by_ * time, az_ + bz_ * time)  # (M,R)
    d1 = (bx_ * EPS, by_ * EPS, bz_ * EPS)  # (M,1)
    rad2 = (scene.msph_radius ** 2)[:, None]
    dx, dy, dz = d[:, 0], d[:, 1], d[:, 2]
    ocx, ocy, ocz = o[:, 0] - c0[0], o[:, 1] - c0[1], o[:, 2] - c0[2]
    dd1 = dx * d1[0] + dy * d1[1] + dz * d1[2]
    a = a_dd - dd1 * dd1
    oc_d = ocx * dx + ocy * dy + ocz * dz
    oc_d1 = ocx * d1[0] + ocy * d1[1] + ocz * d1[2]
    b = 2.0 * (oc_d - oc_d1 * dd1)
    c = ocx * ocx + ocy * ocy + ocz * ocz - oc_d1 * oc_d1 - rad2
    disc = b * b - 4 * a * c
    t1, t = _roots(a, b, disc)
    ok = (disc >= 0) & (t > EPS) & (t > tmin)
    return t, ok, t1 > EPS, c0, d1


# ----------------------------------------------------------------- hit_world
def hit_world(scene: PTScene, o, d, time, tmin=1e-3, tmax=1e4) -> PTHit:
    """Closest hit over the PT scene tables (first-wins on exact ties in
    table order: triangles, spheres, moving spheres — matching the
    sequential if-chain of P3D_RT.glsl:16-481).  The plain version of K4.

    Every per-(primitive, ray) intermediate is an (N, R) plane."""
    R = o.shape[0]
    f32 = dict(dtype=torch.float32, device=o.device)
    best_t = torch.ones((R,), **f32) * tmax
    best_n = torch.zeros((R, 3), **f32)
    best_m = torch.zeros((R,), dtype=torch.int32, device=o.device)
    found = torch.zeros((R,), dtype=torch.bool, device=o.device)

    def take(tbest, n, mat):
        nonlocal best_t, best_n, best_m, found
        better = tbest < best_t
        best_n = torch.where(better[:, None], n, best_n)
        best_m = torch.where(better, mat, best_m)
        best_t = torch.where(better, tbest, best_t)
        found = found | better

    if scene.tri_v0.shape[0]:
        t, ok = _tri_t(scene, o, d, tmin)
        tbest, idx = _first_min(torch.where(ok, t, _INF))
        n = normalize(cross(scene.tri_e1, scene.tri_e2))[idx]
        take(tbest, n, scene.tri_mat[idx].to(torch.int32))

    a_dd = d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1] + d[:, 2] * d[:, 2]

    if scene.sph_center.shape[0]:
        t, ok = _sph_t(scene, o, d, a_dd, tmin)
        tbest, idx = _first_min(torch.where(ok, t, _INF))
        p = o + d * tbest[:, None]
        n = safe_normalize(p - scene.sph_center[idx])
        n = torch.where((scene.sph_radius[idx] < 0)[:, None], -n, n)
        take(tbest, n, scene.sph_mat[idx].to(torch.int32))

    if scene.msph_c0.shape[0]:
        t, ok, outside, c0, d1 = _msph_quadratic(scene, o, d, time, a_dd,
                                                 tmin)
        tbest, idx = _first_min(torch.where(ok, t, _INF))
        p = o + d * tbest[:, None]
        gat = lambda m: m.gather(0, idx[None])[0]  # (M,R) -> (R,)
        out_sel = gat(outside)
        ctr = torch.stack([
            torch.where(out_sel, gat(c0[k]), gat(c0[k] + d1[k]))
            for k in range(3)], dim=-1)
        n = safe_normalize(p - ctr)
        take(tbest, n, scene.msph_mat[idx].to(torch.int32))

    pos = o + d * torch.where(found, best_t, 1.0)[:, None]
    return PTHit(hit=found, t=best_t, pos=pos, normal=best_n, mat=best_m)


def any_hit(scene: PTScene, o, d, time, tmin, tmax):
    """Occlusion-only hit_world (point-light shadows, P3D_RT.glsl:546): any
    primitive with a valid ``t`` strictly between ``tmin`` and ``tmax``.
    The plain version of K5."""
    occ = torch.zeros((o.shape[0],), dtype=torch.bool, device=o.device)
    if scene.tri_v0.shape[0]:
        t, ok = _tri_t(scene, o, d, tmin)
        occ = occ | (ok & (t < tmax)).any(dim=0)
    a_dd = d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1] + d[:, 2] * d[:, 2]
    if scene.sph_center.shape[0]:
        t, ok = _sph_t(scene, o, d, a_dd, tmin)
        occ = occ | (ok & (t < tmax)).any(dim=0)
    if scene.msph_c0.shape[0]:
        t, ok = _msph_quadratic(scene, o, d, time, a_dd, tmin)[:2]
        occ = occ | (ok & (t < tmax)).any(dim=0)
    return occ


# ------------------------------------------------------------- GGX (common.glsl:243-298)
def fresnel_schlick(cos_theta, f0):
    c = torch.clamp(1.0 - cos_theta, min=0.0)
    return f0 + (1.0 - f0) * (c * ((c * c) * (c * c)))


def d_ggx(noh, rough):
    r2 = rough * rough
    alpha2 = r2 * r2
    b = noh * noh * (alpha2 - 1.0) + 1.0
    return alpha2 / (PI * b * b + EPS)


def g1_schlick(nov, rough):
    r = 0.25 * rough  # Disney remap (common.glsl:267)
    k = r * r / 2.0
    return torch.clamp(nov, min=0.0) / (nov * (1.0 - k) + k + EPS)


def brdf_ggx(n, v, l, f0, rough):
    h = safe_normalize(l + v)
    nov = torch.clamp(dot(n, v), min=0.0)
    nol = torch.clamp(dot(n, l), min=0.0)
    noh = torch.clamp(dot(n, h), min=0.0)
    cos_t = torch.clamp(dot(v, h), min=0.0)
    D = d_ggx(noh, rough)
    G = g1_schlick(nol, rough) * g1_schlick(nov, rough)
    F = fresnel_schlick(cos_t[..., None], f0)
    return (D * G)[..., None] * F / (4.0 * nov * nol + EPS)[..., None]


def srgb_to_linear(rgb):
    """SRGBToLinear (common.glsl:23-32)."""
    rgb = torch.clamp(rgb, 0.0, 1.0)
    lo = rgb / 12.92
    hi = ((rgb + 0.055) / 1.055) ** 2.4
    return torch.where(rgb < 0.04045, lo, hi)


# ----------------------------------------------------------- direct lighting
def _mat_gather(scene: PTScene, mid, pos):
    mid = mid.long()
    alb = scene.mat_albedo[mid]
    stripe = scene.mat_stripe[mid]
    # striped background shade (P3D_RT.glsl:149)
    shade = torch.floor(torch.remainder(pos[..., 0], 1.0) * 2.0)
    alb = torch.where(stripe[..., None], shade[..., None], alb)
    return dict(
        typ=scene.mat_type[mid], albedo=alb, spec=scene.mat_spec[mid],
        emissive=scene.mat_emissive[mid], rough=scene.mat_rough[mid],
        refidx=scene.mat_refidx[mid], refract=scene.mat_refract[mid])


def _direct_common(m, N, light_dir, view_for_ggx, diff_view, light_color):
    """Shared tail of both directlighting variants (P3D_RT.glsl:496-520,
    550-575).  ``view_for_ggx`` is the (possibly sign-quirked) GGX V."""
    ndl = torch.clamp(dot(N, light_dir), min=0.0)
    diff = m["albedo"] * ndl[..., None]
    H = safe_normalize(light_dir + diff_view)
    r2 = m["rough"] * m["rough"]
    shin = 8.0 / (r2 * r2 + EPS) - 2.0
    spec = m["spec"] * (torch.clamp(dot(N, H), min=0.0) ** shin)[..., None]
    ggx = brdf_ggx(N, view_for_ggx, light_dir, m["spec"], m["rough"])
    is_gm = (m["typ"] == MT_METAL) | (m["typ"] == MT_PLASTIC)
    spec = torch.where(is_gm[..., None], ggx, spec)
    ks = fresnel_schlick(
        torch.clamp(dot(N, view_for_ggx), min=0.0)[..., None], m["spec"])
    kd_diff = (1.0 - ks) * m["albedo"] / PI
    diff = torch.where((m["typ"] == MT_PLASTIC)[..., None], kd_diff, diff)
    lit = dot(N, light_dir) > 0.0
    out = (diff + spec) * light_color * ndl[..., None]
    return torch.where(lit[..., None], out, 0.0)


def direct_point(scene: PTScene, lpos, lcolor, r_d, hit: PTHit, m, time,
                 occl: Callable):
    """directlighting(pointLight) with hard shadow (P3D_RT.glsl:525-578).
    ``occl(o, d, time, tmin, tmax)`` is the occlusion query."""
    N = safe_normalize(hit.normal)
    ldir_un = lpos - hit.pos
    dist = torch.linalg.norm(ldir_un, dim=-1)
    ldir = safe_normalize(ldir_un)
    shadowed = occl(hit.pos + N * 1e-3, ldir, time, 1e-3, dist - 1e-3)
    # viewDir = normalize(r.d); GGX gets -viewDir; Blinn H uses -viewDir too
    view = -normalize(r_d)
    out = _direct_common(m, N, ldir, view, view, lcolor)
    return torch.where(shadowed[..., None], 0.0, out)


def direct_quad(scene: PTScene, j, r_d, hit: PTHit, m, u1, u2):
    """directlighting(quadLight): jittered point, NO shadow ray
    (P3D_RT.glsl:483-523)."""
    N = safe_normalize(hit.normal)
    lpos = (scene.qlight_pos[j] + scene.qlight_e1[j] * u1[..., None]
            + scene.qlight_e2[j] * u2[..., None])
    ldir = safe_normalize(lpos - hit.pos)
    # quirk: viewDir = normalize(-r.d) but BRDF_GGX receives -viewDir
    # (= the raw ray direction, P3D_RT.glsl:503+511); Blinn-H uses +viewDir
    view_blinn = -normalize(r_d)
    view_ggx = -view_blinn
    return _direct_common(m, N, ldir, view_ggx, view_blinn,
                          scene.qlight_color[j])


# ------------------------------------------------------------------- scatter
def _rand_unit_sphere(u3):
    """randomInUnitSphere from 3 uniforms (common.glsl:102-108); u3 in
    [0,1), so the cube root is a power."""
    h0 = u3[..., 0] * 2.0 - 1.0
    phi = u3[..., 1] * 6.28318530718
    r = torch.pow(u3[..., 2], 1.0 / 3.0)
    s = safe_sqrt(1.0 - h0 * h0)
    return r[..., None] * torch.stack(
        [s * torch.sin(phi), s * torch.cos(phi), h0], dim=-1)


def scatter(scene: PTScene, r_o, r_d, hit: PTHit, m, u_choice, u3a, u3b):
    """common.glsl:300-407.  Returns (ok, new_o, new_d, atten).

    ``u_choice``: the branch uniform (dielectric reflect prob / plastic
    fresnel prob); ``u3a``/``u3b``: 3-uniform blocks for direction samples.
    """
    V = -normalize(r_d)
    N = safe_normalize(hit.normal)
    outside = dot(r_d, N) < 0.0
    N = torch.where(outside[..., None], N, -N)
    typ = m["typ"]
    rough = m["rough"][..., None]
    ones = torch.ones_like(outside)

    unit_vec = safe_normalize(_rand_unit_sphere(u3a))
    sph_b = _rand_unit_sphere(u3b)

    # ---- DIFFUSE: dir = N + unit vector, unnormalized (common.glsl:310-312)
    d_dif = N + unit_vec
    o_dif = hit.pos + N * EPS
    a_dif = m["albedo"] * torch.clamp(dot(N, d_dif), min=0.0)[..., None]

    # ---- METAL (common.glsl:314-324)
    refl = r_d - 2.0 * dot(r_d, N)[..., None] * N  # GLSL reflect()
    d_met = safe_normalize(refl + sph_b * rough)
    ok_met = dot(d_met, N) > 0.0
    o_met = hit.pos + N * EPS
    a_met = m["spec"]

    # ---- DIELECTRIC (common.glsl:325-375)
    one = torch.ones_like(m["refidx"])
    ior1 = torch.where(outside, one, m["refidx"])
    ior2 = torch.where(outside, m["refidx"], one)
    eta = ior1 / ior2
    Vt = N * dot(N, V)[..., None] - V
    sin_i = torch.linalg.norm(Vt, dim=-1)
    sin_t = eta * sin_i
    cos_t = safe_sqrt(1.0 - sin_t * sin_t)
    cos_i = dot(V, N)
    cos_sel = torch.where(ior1 > ior2, cos_t, cos_i)
    q = (ior1 - ior2) / (ior1 + ior2)
    r0 = q * q
    c5 = torch.clamp(1.0 - cos_sel, min=0.0)
    schlick_p = r0 + (1.0 - r0) * (c5 * ((c5 * c5) * (c5 * c5)))
    refl_prob = torch.where(sin_t >= 1.0, 1.0, schlick_p)
    take_refl = u_choice < refl_prob
    d_refl = safe_normalize(refl + sph_b * rough)
    # GLSL refract(normalize(r_d), N, eta)
    I = normalize(r_d)
    ndi = dot(N, I)
    k = 1.0 - eta * eta * (1.0 - ndi * ndi)
    refr = torch.where(
        (k >= 0.0)[..., None],
        eta[..., None] * I - (eta * ndi + safe_sqrt(k))[..., None] * N, 0.0)
    d_refr = safe_normalize(refr + sph_b * rough)
    d_die = torch.where(take_refl[..., None], d_refl, d_refr)
    o_die = torch.where(take_refl[..., None],
                        hit.pos + N * EPS, hit.pos - N * EPS)
    beer = torch.exp(-m["refract"] * torch.where(hit.hit, hit.t, 0.0)[..., None])
    # atten: 1 on reflect (when dir above surface; undefined otherwise -> 1),
    # Beer when refracting from inside, else 1 (common.glsl:359-373)
    a_die = torch.where((take_refl | outside)[..., None],
                        torch.ones_like(beer), beer)

    # ---- PLASTIC (common.glsl:376-405)
    light_dir = safe_normalize(r_o - hit.pos)
    Hp = safe_normalize(V + light_dir)
    cos_p = dot(V, Hp)
    f_vec = fresnel_schlick(cos_p[..., None], m["spec"])
    prob = torch.mean(f_vec, dim=-1)
    take_spec = u_choice < prob
    d_spec = safe_normalize(refl + sph_b * rough)
    gate = dot(d_spec, N) > 0.0
    a_spec = torch.where(
        gate[..., None],
        m["spec"] / torch.clamp(prob, min=1e-8)[..., None],
        torch.ones_like(f_vec))  # undefined in GLSL when gate fails -> 1
    d_dplastic = safe_normalize(N + sph_b)
    a_dplastic = ((1.0 - f_vec) * m["albedo"] / PI
                  / torch.clamp(1.0 - prob, min=1e-8)[..., None])
    d_pla = torch.where(take_spec[..., None], d_spec, d_dplastic)
    a_pla = torch.where(take_spec[..., None], a_spec, a_dplastic)
    o_pla = hit.pos + N * EPS

    def sel(dif, met, die, pla, vec=True):
        c = (lambda x: x[..., None]) if vec else (lambda x: x)
        return torch.where(c(typ == MT_DIFFUSE), dif, torch.where(
            c(typ == MT_METAL), met,
            torch.where(c(typ == MT_DIELECTRIC), die, pla)))

    new_o = sel(o_dif, o_met, o_die, o_pla)
    new_d = sel(d_dif, d_met, d_die, d_pla)
    atten = sel(a_dif, a_met, a_die, a_pla)
    ok = sel(ones, ok_met, ones, ones, vec=False)
    return ok, new_o, new_d, atten


# ------------------------------------------------------------ random numbers
class BounceUniforms(NamedTuple):
    """Per-bounce uniforms, stacked over bounces (leading axis B) or for one
    bounce (no leading axis): ``uq (B,R,2*max(n_ql,1))`` quad-light jitter,
    ``uch (B,R)`` branch choice, ``u3a``/``u3b (B,R,3)`` direction samples,
    ``urr (B,R)`` Russian roulette."""

    uq: torch.Tensor
    uch: torch.Tensor
    u3a: torch.Tensor
    u3b: torch.Tensor
    urr: torch.Tensor

    def bounce(self, b: int) -> "BounceUniforms":
        return BounceUniforms(*(x[b] for x in self))

    def lanes(self, a: int, b: int) -> "BounceUniforms":
        return BounceUniforms(*(x[:, a:b] for x in self))

    def to(self, device) -> "BounceUniforms":
        return BounceUniforms(*(x.to(device) for x in self))


def _uniform_shapes(scene: PTScene, R: int):
    nq = max(scene.qlight_pos.shape[0], 1)
    return (R, 2 * nq), (R,), (R, 3), (R, 3), (R,)


def draw_uniforms(scene: PTScene, R: int, generator: torch.Generator,
                  device) -> BounceUniforms:
    """One bounce's uniforms, drawn in the fixed order uq, uch, u3a, u3b,
    urr (both bodies of ``ray_color`` draw them so)."""
    shapes = _uniform_shapes(scene, R)
    spans.count("pt.draws", len(shapes))
    return BounceUniforms(*(torch.rand(sh, generator=generator, device=device)
                            for sh in shapes))


def draw_bounces(scene: PTScene, R: int, B: int, generator: torch.Generator,
                 device) -> BounceUniforms:
    """B bounces' uniforms drawn up front and stacked (B, R, ...): the
    numbers, in the order, of B :func:`draw_uniforms` calls, one a
    bounce."""
    shapes = _uniform_shapes(scene, R)
    spans.count("pt.draws", B * len(shapes))
    out = BounceUniforms(*(torch.empty((B,) + sh, device=device)
                           for sh in shapes))
    for b in range(B):
        for x, sh in zip(out, shapes):
            torch.rand(sh, generator=generator, out=x[b])
    return out


@dataclasses.dataclass
class PTSamples:
    """Explicit random numbers of a ``render_pt`` frame: pixel ``jitter
    (H,W,S,2)``, motion ``time (H,W,S)`` and, optionally, the trace's
    :class:`BounceUniforms` over all H*W*S paths."""

    jitter: torch.Tensor
    time: torch.Tensor
    uniforms: Optional[BounceUniforms] = None


# ------------------------------------------------------------------ rayColor
class PTQueries(NamedTuple):
    """Scene queries of the staged body: ``closest(o, d, time) -> PTHit``
    and ``occluded(o, d, time, tmin, tmax) -> (R,) bool``."""

    closest: Callable
    occluded: Callable


def plain_queries(scene: PTScene) -> PTQueries:
    return PTQueries(
        lambda o, d, t: hit_world(scene, o, d, t),
        lambda o, d, t, tmin, tmax: any_hit(scene, o, d, t, tmin, tmax))


def kernel_queries(scene: PTScene) -> PTQueries:
    """K4 and K5 (their plain versions on CPU tensors).  K5's tmin is the
    GLSL 1e-3, which is what the staged body asks for."""
    tb = CP.pt_tables(scene)
    return PTQueries(
        lambda o, d, t: CP.pt_closest(scene, o, d, t, tables=tb),
        lambda o, d, t, tmin, tmax: CP.pt_any_hit(scene, o, d, t, tmax,
                                                  tables=tb))


def ray_color(scene: PTScene, cfg: RenderConfig, o, d, time,
              generator: Optional[torch.Generator] = None,
              uniforms: Optional[BounceUniforms] = None,
              queries: Optional[PTQueries] = None,
              tables: Optional[CP.PTTables] = None):
    """Trace a batch of camera rays to radiance (P3D_RT.glsl:583-676).

    ``queries=None`` takes the fused body (the looped K6, ``pt_trace``)
    unless ``cfg.kernels == 'off'``, which takes the staged body with
    :func:`plain_queries`; ``queries`` given takes the staged body with
    them (``kernel_queries(scene)``: K4 and K5).  ``uniforms`` (stacked over bounces) replaces the generator's
    draws."""
    R = o.shape[0]
    if generator is None and uniforms is None:
        generator = torch.Generator(device=o.device).manual_seed(0)

    def draws(b):
        if uniforms is not None:
            return uniforms.bounce(b)
        return draw_uniforms(scene, R, generator, o.device)

    if queries is None and cfg.kernels == "off":
        queries = plain_queries(scene)
    if queries is not None:
        return _ray_color_staged(scene, cfg, o, d, time, draws, queries)
    B = cfg.max_bounces
    if uniforms is None:
        uniforms = draw_bounces(scene, R, B, generator, o.device)
    elif uniforms.uch.shape[0] < B:
        raise ValueError(f"ray_color: uniforms of {uniforms.uch.shape[0]} "
                         f"bounces for {B}")
    return _ray_color_fused(scene, cfg, o, d, time,
                            BounceUniforms(*(x[:B] for x in uniforms)),
                            tables)


def _sky_factor(scene: PTScene) -> float:
    return 3.0 if scene.sky_mode == SKY_CUBEMAP_X3 else 1.0


def _sky_gather(scene, col, mw, md):
    """Cubemap skies latch (throughput, direction) at the miss bounce —
    misses are terminal — and pay one texel gather per path after the
    loop (P3D_RT.glsl:661-671)."""
    if scene.sky_mode == SKY_GRADIENT:
        return col
    with spans.span("pt.sky"):
        tex = srgb_to_linear(gl_cubemap_color(scene.sky_faces, scene.sky_res,
                                              md))
        return col + mw * tex * _sky_factor(scene)


def _ray_color_fused(scene, cfg, o, d, time, uniforms, tables):
    """The looped K6 (``cuda_pt.pt_trace``): every bounce of every path in
    one call, one launch on CUDA tensors, on the stacked ``uniforms`` of
    ``cfg.max_bounces`` bounces."""
    tb = tables if tables is not None else CP.pt_tables(scene)
    with spans.span("pt.bounce"):
        out = CP.pt_trace(scene, o, d, time, uniforms, cfg.russian_roulette,
                          tables=tb)
    return _sky_gather(scene, out.col, out.mw, out.md)


def _ray_color_staged(scene, cfg, o, d, time, draws, queries: PTQueries):
    R = o.shape[0]
    f32 = dict(dtype=torch.float32, device=o.device)
    n_pl = scene.plight_pos.shape[0]
    n_ql = scene.qlight_pos.shape[0]
    col = torch.zeros((R, 3), **f32)
    thr = torch.ones((R, 3), **f32)
    alive = torch.ones((R,), dtype=torch.bool, device=o.device)
    t_ray = time
    zero_t = torch.zeros((R,), **f32)  # shadow and scattered rays: time 0

    def occluded(*args):
        with spans.span("pt.intersect"):
            return queries.occluded(*args)

    for b in range(cfg.max_bounces):
        with spans.span("pt.bounce"):
            spans.count("pt.paths", R)
            if spans.enabled():
                spans.count_device("pt.paths_live", alive.sum())
            # scattered rays are built with the 2-arg createRay -> time = 0
            # (common.glsl:43-46): only camera rays see motion
            u = draws(b)
            with spans.span("pt.intersect"):
                hit = queries.closest(o, d, t_ray)
            m = _mat_gather(scene, hit.mat, hit.pos)

            live_hit = alive & hit.hit
            emis_on = torch.any(m["emissive"] != 0.0, dim=-1)
            col = col + torch.where((live_hit & emis_on)[..., None],
                                    m["emissive"] * thr, 0.0)

            # direct lighting (per-scene static light lists)
            dl = torch.zeros_like(col)
            for j in range(n_pl):
                dl = dl + direct_point(scene, scene.plight_pos[j],
                                       scene.plight_color[j], d, hit, m,
                                       zero_t, occluded)
            for j in range(n_ql):
                dl = dl + direct_quad(scene, j, d, hit, m,
                                      u.uq[:, 2 * j], u.uq[:, 2 * j + 1])
            col = col + torch.where(live_hit[..., None], dl * thr, 0.0)

            ok, new_o, new_d, atten = scatter(scene, o, d, hit, m,
                                              u.uch, u.u3a, u.u3b)
            # no-scatter (metal absorbed): col += thr * emissive, stop
            # (P3D_RT.glsl:641-645)
            col = col + torch.where((live_hit & ~ok)[..., None],
                                    thr * m["emissive"], 0.0)
            thr = torch.where((live_hit & ok)[..., None], thr * atten, thr)

            # Russian roulette (P3D_RT.glsl:651-656)
            if cfg.russian_roulette:
                p = torch.amax(thr, dim=-1)
                killed = u.urr > p
                thr = torch.where((live_hit & ok & ~killed)[..., None],
                                  thr / torch.clamp(p, min=1e-12)[..., None],
                                  thr)
            else:
                killed = torch.zeros_like(alive)

            # miss: sky (P3D_RT.glsl:659-672)
            if scene.sky_mode == SKY_GRADIENT:
                tsky = torch.clamp(0.8 * (d[..., 1] + 1.0), 0.0,
                                   1.0)[..., None]
                sky = ((1.0 - tsky) * torch.ones(3, **f32)
                       + tsky * torch.tensor([0.5, 0.7, 1.0], **f32))
            else:
                sky = srgb_to_linear(gl_cubemap_color(
                    scene.sky_faces, scene.sky_res, d)) * _sky_factor(scene)
            miss = alive & ~hit.hit
            col = col + torch.where(miss[..., None], thr * sky, 0.0)

            alive = alive & hit.hit & ok & ~killed
            o = torch.where(alive[..., None], new_o, o)
            d = torch.where(alive[..., None], new_d, d)
            t_ray = zero_t
    return col


def trace_tiles(R: int, cfg: RenderConfig, device, injected: bool,
                queries: Optional[PTQueries] = None):
    """The lane ranges ``[(a, b), ...]`` of :func:`ray_color_tiled`'s
    ``ray_color`` calls.

    Where the looped K6 launches (the fused body on CUDA tensors) on
    injected uniforms, one range of all R paths: the launch keeps each
    block's state on the chip, and one launch over the frame leaves one
    tail where a launch a tile leaves one each (an 800x600 spp16 frame of
    scene 0 on an H100: about 19 ms a frame against 26).  Otherwise tiles
    of ``cfg.pt_tile_rays`` paths (0: one tile), the last shorter: a
    generator draws each tile's uniforms in turn (so its image stays what
    tiles give), and the plain versions' per-bounce planes grow with the
    tile."""
    whole = (injected and queries is None and cfg.kernels != "off"
             and torch.device(device).type == "cuda")
    tile = R if whole else (min(cfg.pt_tile_rays, R) if cfg.pt_tile_rays
                            else R)
    tile = max(tile, 1)
    return [(a, min(a + tile, R)) for a in range(0, R, tile)]


def ray_color_tiled(scene: PTScene, cfg: RenderConfig, o, d, time,
                    generator: Optional[torch.Generator] = None,
                    uniforms: Optional[BounceUniforms] = None,
                    queries: Optional[PTQueries] = None):
    """``ray_color`` over the lane ranges of :func:`trace_tiles`: tiles of
    ``cfg.pt_tile_rays`` paths, or one call over all R where the looped K6
    takes injected uniforms.  Tiles draw from one generator in turn; the
    last tile is shorter, not padded."""
    R = o.shape[0]
    tb = CP.pt_tables(scene) if queries is None else None
    if generator is None and uniforms is None:
        generator = torch.Generator(device=o.device).manual_seed(0)
    cols = []
    for a, b in trace_tiles(R, cfg, o.device, uniforms is not None, queries):
        with spans.span("pt.tile"):
            cols.append(ray_color(
                scene, cfg, o[a:b], d[a:b], time[a:b], generator,
                uniforms.lanes(a, b) if uniforms is not None else None,
                queries, tables=tb))
    return torch.cat(cols) if cols else o.new_zeros((0, 3))


def camera_basis(eye, at, res_x: int, res_y: int, fovy: float):
    """The shader camera (common.glsl:125-168) in host float32 math:
    (u, v, n, plane_dist, width, height)."""
    up = np.array([0.0, 1.0, 0.0], np.float32)
    w = np.asarray(eye, np.float32) - np.asarray(at, np.float32)
    plane_dist = np.linalg.norm(w)
    n = w / plane_dist
    u = np.cross(up, n)
    u = u / np.linalg.norm(u)
    v = np.cross(n, u)
    height = 2.0 * plane_dist * math.tan(fovy * math.pi / 180.0 * 0.5)
    width = (res_x / res_y) * height
    return u, v, n, plane_dist, width, height


def primary_rays(res_x: int, res_y: int, jitter, eye=None, at=None,
                 fovy: float = 60.0, row_offset: int = 0):
    """Camera rays of the pixel samples ``jitter (H', W, S, 2)``, rows
    ``row_offset`` to ``row_offset + H'`` of the frame, on the jitter's
    device: (o, d) of shape (H' * W * S, 3).  The GLSL camera
    (common.glsl:125-168) with focus distance 1; its default looks down +z
    from distance 5 (P3D_RT.glsl:712-718 with the mouse at the origin)."""
    dev = jitter.device
    if eye is None:
        eye = np.array([0.0, 0.0, -5.0], np.float32)
        at = np.array([0.0, 0.0, 1.0], np.float32) + eye
    eye = np.asarray(eye, np.float32)
    u, v, n, plane_dist, width, height = camera_basis(eye, at, res_x, res_y,
                                                      fovy)
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    rows = jitter.shape[0]
    xy = np.stack(
        np.meshgrid(np.arange(res_x, dtype=np.float32),
                    np.arange(row_offset, row_offset + rows,
                              dtype=np.float32), indexing="xy"),
        axis=-1)
    ps = t(xy)[:, :, None, :] + jitter
    px = (ps[..., 0] / res_x - 0.5) * float(width)
    py = (ps[..., 1] / res_y - 0.5) * float(height)
    d = normalize(t(u) * px[..., None] + t(v) * py[..., None]
                  - t(n * plane_dist)).reshape(-1, 3)
    return torch.zeros_like(d) + t(eye), d


def render_pt(scene: PTScene, cfg: RenderConfig, res_x: int, res_y: int,
              generator: Optional[torch.Generator] = None, eye=None, at=None,
              fovy: float = 60.0, spp: int = 1,
              samples: Optional[PTSamples] = None,
              queries: Optional[PTQueries] = None):
    """Full-frame path trace on the scene's device: jittered pixel samples
    through :func:`primary_rays`, ``spp`` samples averaged in linear space.
    Returns (res_y, res_x, 3) f32, row 0 at the bottom.

    ``samples`` replaces the generator's jitter, time and (when it has
    them) trace uniforms; ``queries`` as in :func:`ray_color`."""
    with spans.span("pt.frame"):
        dev = scene.device
        if samples is None:
            if generator is None:
                generator = torch.Generator(device=dev).manual_seed(0)
            spans.count("pt.draws", 2)
            jitter = torch.rand((res_y, res_x, spp, 2), generator=generator,
                                device=dev)
            time = torch.rand((res_y, res_x, spp), generator=generator,
                              device=dev)
            uniforms = None
        else:
            jitter, time = samples.jitter.to(dev), samples.time.to(dev)
            uniforms = (samples.uniforms.to(dev)
                        if samples.uniforms is not None else None)
        o, d = primary_rays(res_x, res_y, jitter, eye, at, fovy)
        col = ray_color_tiled(scene, cfg, o, d, time.reshape(-1), generator,
                              uniforms, queries)
        return torch.mean(col.reshape(res_y, res_x, spp, 3), dim=2)


def to_gamma(c):
    return torch.clamp(c, min=0.0) ** (1.0 / 2.2)
