"""The reference path tracer: ``rayColor`` of the upstream's WebGL path
tracer (P3D_RT.glsl:583-676) for what its scene 0 uses, in plain PyTorch,
in the scene's floating type.

Each path is a loop of up to ``max_bounces`` bounces (``MAX_BOUNCES`` 10,
P3D_RT.glsl:581).  A bounce of a live path:

- ``hit_world`` (P3D_RT.glsl:16-481): every triangle (common.glsl:418-447),
  sphere (common.glsl:513-549; a negative radius flips the normal, :545)
  and moving sphere (common.glsl:551-605: the quadratic in the velocity
  d1 = (c1 - c0) * EPS, the centre moved by d1 for the far root) in that
  group order, the least t winning and the first on a tie (strict <),
  between EPS and 1e4;
- the emissive colour added (P3D_RT.glsl:593-597);
- each point light's direct light (P3D_RT.glsl:525-578): a hard shadow
  ray from the point lifted by EPS along the normal, blocked by any
  primitive between EPS and the light's distance less 1e-3; Blinn-Phong
  for diffuse surfaces and GGX for metal ones (common.glsl:243-298), both
  times the light's colour and max(N.L, 0), which the diffuse term has
  already taken once (the shader's doubled factor, P3D_RT.glsl:500+519);
- ``scatter`` (common.glsl:300-407) for diffuse (N plus a unit vector,
  unnormalised), metal (the reflection fuzzed by the roughness; absorbed
  when it points into the surface, P3D_RT.glsl:641-645) and dielectric
  (Schlick's reflection probability, total internal reflection, the Beer
  colour on a ray refracted out of the body) materials;
- Russian roulette on the throughput's largest channel, the survivors'
  throughput divided by it (P3D_RT.glsl:651-656);
- on a miss, the gradient sky, mix(white, (0.5, 0.7, 1)) by
  0.8 * (d.y + 1) of the ray's own direction (P3D_RT.glsl:659-672).

Camera rays carry their own time (the moving spheres' centre is c0 +
(c1 - c0) * time); scattered and shadow rays carry time 0, as the two
argument ``createRay`` makes them (common.glsl:43-46).  The camera is the
shader's (common.glsl:125-168) with the focus distance 1.

Where the shader leaves the dielectric's attenuation undefined (a
reflected ray), it is 1, as the program documents.  Quad lights, the
cubemap sky, the plastic material and striped albedo, which scene 0 does
not use, raise.

Random numbers are injected: per bounce, ``uch`` chooses the
dielectric's branch, ``u3a`` draws the diffuse direction, ``u3b`` the
fuzz, ``urr`` plays roulette (``uq``, the quad lights' jitter, is unused).
Only live paths are traced, ``BLOCK`` at a time, with TF32 off.

``counts`` (a dict) collects, per bounce, what ``portbench.roofline_pt``
needs: the live paths; the folds (one closest-hit fold a live path, one
shadow fold a light that a hit faces); and the primitive tests of those
folds, a sphere's and a moving sphere's by whether the discriminant is
non-negative, a shadow fold's up to its first occluder.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from portbench.reference.pt_scene import DIELECTRIC, DIFFUSE, METAL

EPS = 1e-3  # common.glsl:7
TMAX = 1e4  # hit_world's far limit
PI = 3.14159265358979
BLOCK = 1 << 16  # live paths a block traces at once
COUNT_KEYS = ("paths", "folds", "tri", "sph", "sph_miss", "msph",
              "msph_miss")


class Uniforms(NamedTuple):
    """Per-bounce uniforms over paths: ``uq (B, R, 2)``, ``uch (B, R)``,
    ``u3a``, ``u3b (B, R, 3)``, ``urr (B, R)``."""

    uq: torch.Tensor
    uch: torch.Tensor
    u3a: torch.Tensor
    u3b: torch.Tensor
    urr: torch.Tensor

    def paths(self, idx):
        return Uniforms(*(x[:, idx] for x in self))


def dot(a, b):
    return (a * b).sum(-1)


def unit(x):
    """``x / |x|``; a zero vector stays zero."""
    n2 = dot(x, x)
    ok = n2 > 0
    return torch.where(ok[..., None],
                       x / torch.sqrt(torch.where(ok, n2, 1.0))[..., None],
                       0.0)


def sqrt0(x):
    return torch.sqrt(torch.clamp(x, min=0.0))


def check_scene(rs):
    """Raise on what this reference does not trace."""
    lacks = []
    if rs.qlight_pos.shape[0]:
        lacks.append("quad lights")
    if rs.sky != "gradient":
        lacks.append(f"the {rs.sky} sky")
    if bool((rs.mat_type > DIELECTRIC).any()):
        lacks.append("the plastic material")
    if bool(rs.mat_stripe.any()):
        lacks.append("striped albedo")
    if lacks:
        raise ValueError("the reference path tracer does not trace "
                         + ", ".join(lacks))


# ------------------------------------------------------------------ camera
class Camera:
    """The shader's camera (common.glsl:125-168) looking from ``eye`` at
    ``at`` with world up +y, ``fovy`` degrees, focus distance 1."""

    def __init__(self, eye, at, fovy, res_x, res_y):
        eye, at = np.asarray(eye, np.float32), np.asarray(at, np.float32)
        w = eye - at
        self.dist = np.float32(np.linalg.norm(w))
        self.n = w / self.dist
        u = np.cross(np.array([0.0, 1.0, 0.0], np.float32), self.n)
        self.u = u / np.linalg.norm(u)
        self.v = np.cross(self.n, self.u)
        self.height = 2.0 * self.dist * math.tan(math.radians(fovy) * 0.5)
        self.width = res_x / res_y * self.height
        self.eye, self.res = eye, (res_x, res_y)

    def rays(self, rows, cols, jitter):
        """(o, d), each (P * S, 3), of pixels (``rows``, ``cols``) (P,)
        through their samples ``jitter`` (P, S, 2), in its type."""
        t = lambda a: torch.as_tensor(np.asarray(a, np.float32),
                                      device=jitter.device).to(jitter.dtype)
        x = cols.to(jitter.dtype)[:, None] + jitter[..., 0]
        y = rows.to(jitter.dtype)[:, None] + jitter[..., 1]
        px = (x / self.res[0] - 0.5) * float(self.width)
        py = (y / self.res[1] - 0.5) * float(self.height)
        d = unit(t(self.u) * px[..., None] + t(self.v) * py[..., None]
                 - t(self.n * self.dist)).reshape(-1, 3)
        return t(self.eye).expand_as(d), d


# -------------------------------------------------------------- hit_world
def _quadratic_t(a, b, c):
    """(t, discriminant >= 0, near root beyond EPS) of a t^2 + b t + c."""
    disc = b * b - 4.0 * a * c
    sq = sqrt0(disc)
    t1 = (-b - sq) / (2.0 * a)
    t2 = (-b + sq) / (2.0 * a)
    near = t1 > EPS
    return torch.where(near, t1, t2), disc >= 0, near


def tests(rs, o, d, time):
    """Every primitive against every ray (R, K), in group order: (t with
    inf where the test fails, discriminant >= 0 (True for a triangle),
    the moving spheres' (near root, centre at ``time``))."""
    inf = float("inf")
    dx, dy, dz = (d[:, k:k + 1] for k in range(3))
    # triangles, Moller-Trumbore
    e1, e2, v0 = rs.tri_e1[None], rs.tri_e2[None], rs.tri_v0[None]
    hx = dy * e2[..., 2] - dz * e2[..., 1]
    hy = dz * e2[..., 0] - dx * e2[..., 2]
    hz = dx * e2[..., 1] - dy * e2[..., 0]
    a = e1[..., 0] * hx + e1[..., 1] * hy + e1[..., 2] * hz
    nz = a != 0
    f = 1.0 / torch.where(nz, a, 1.0)
    s = o[:, None, :] - v0
    u = f * (s[..., 0] * hx + s[..., 1] * hy + s[..., 2] * hz)
    q = torch.stack([s[..., 1] * e1[..., 2] - s[..., 2] * e1[..., 1],
                     s[..., 2] * e1[..., 0] - s[..., 0] * e1[..., 2],
                     s[..., 0] * e1[..., 1] - s[..., 1] * e1[..., 0]], -1)
    v = f * dot(q, d[:, None, :])
    tt = f * dot(q, e2)
    ok = nz & (u >= 0) & (u <= 1) & (v >= 0) & (u + v <= 1) & (tt > EPS)
    t_tri = torch.where(ok, tt, inf)
    real_tri = torch.ones_like(ok)
    # spheres
    dd = dot(d, d)[:, None]
    oc = o[:, None, :] - rs.sph_center[None]
    t_s, real_s, _ = _quadratic_t(dd, 2.0 * dot(oc, d[:, None, :]),
                                  dot(oc, oc) - rs.sph_radius[None] ** 2)
    t_sph = torch.where(real_s & (t_s > EPS), t_s, inf)
    # moving spheres: centre c0 + (c1 - c0) * time, d1 = (c1 - c0) * EPS
    vel = rs.msph_c1 - rs.msph_c0
    centre = rs.msph_c0[None] + vel[None] * time[:, None, None]
    d1 = vel[None] * EPS
    dd1 = dot(d[:, None, :], d1)
    oc = o[:, None, :] - centre
    ocd1 = dot(oc, d1)
    t_m, real_m, near = _quadratic_t(
        dd - dd1 * dd1, 2.0 * (dot(oc, d[:, None, :]) - ocd1 * dd1),
        dot(oc, oc) - ocd1 * ocd1 - rs.msph_radius[None] ** 2)
    t_msph = torch.where(real_m & (t_m > EPS), t_m, inf)
    return (torch.cat([t_tri, t_sph, t_msph], 1),
            torch.cat([real_tri, real_s, real_m], 1), (near, centre))


def closest(rs, o, d, time):
    """(hit, t, point, unit normal, primitive index, discriminants >= 0
    (R, K)) of the closest hit."""
    T, S, _ = rs.counts
    t_all, real, (near, centre) = tests(rs, o, d, time)
    g = t_all.argmin(1)  # the first of equal minima
    t = t_all.gather(1, g[:, None])[:, 0]
    hit = t < TMAX
    t = torch.where(hit, t, 0.0)
    p = o + d * t[:, None]
    zero = torch.zeros_like(p)
    n_tri = (unit(torch.linalg.cross(rs.tri_e1, rs.tri_e2))[
        g.clamp(max=T - 1)] if T else zero)
    gs = (g - T).clamp(0, max(S - 1, 0))
    n_sph = zero
    if S:
        n_sph = unit(p - rs.sph_center[gs])
        n_sph = torch.where((rs.sph_radius[gs] < 0)[:, None], -n_sph, n_sph)
    n_msph = zero
    if centre.shape[1]:
        gm = (g - T - S).clamp(0, centre.shape[1] - 1)
        rows = torch.arange(o.shape[0], device=o.device)
        c = centre[rows, gm]
        c = torch.where(near[rows, gm][:, None], c,
                        c + (rs.msph_c1 - rs.msph_c0)[gm] * EPS)
        n_msph = unit(p - c)
    n = torch.where((g < T)[:, None], n_tri,
                    torch.where((g < T + S)[:, None], n_sph, n_msph))
    return hit, t, p, n, g, real


def shadow_tests(rs, o, d, tmax):
    """(occluded (R,), tests made (R, K): every primitive up to the first
    whose t lies in (EPS, tmax), all of them where none does)."""
    zero = torch.zeros(o.shape[0], dtype=o.dtype, device=o.device)
    t_all, real, _ = tests(rs, o, d, zero)
    block = t_all < tmax[:, None]
    occ = block.any(1)
    K = block.shape[1]
    first = torch.where(occ, block.to(torch.int8).argmax(1), K - 1)
    made = torch.arange(K, device=o.device)[None] <= first[:, None]
    return occ, made, real


# ---------------------------------------------------------------- shading
def _schlick(cos_t, f0):
    c = torch.clamp(1.0 - cos_t, min=0.0)
    return f0 + (1.0 - f0) * (c * ((c * c) * (c * c)))


def _in_sphere(u):
    """randomInUnitSphere from three uniforms (common.glsl:102-108)."""
    h0 = u[..., 0] * 2.0 - 1.0
    phi = u[..., 1] * 6.28318530718
    r = torch.pow(u[..., 2], 1.0 / 3.0)
    s = sqrt0(1.0 - h0 * h0)
    return r[..., None] * torch.stack(
        [s * torch.sin(phi), s * torch.cos(phi), h0], -1)


def _point_light(n, l, v, alb, spec, rough, metal, lcol):
    """One point light's colour at a hit (before the throughput): the
    diffuse or Blinn terms, or GGX for metal, times the light's colour and
    max(N.L, 0) (P3D_RT.glsl:550-575)."""
    ndl = torch.clamp(dot(n, l), min=0.0)
    h = unit(l + v)
    r4 = (rough * rough) ** 2
    shin = 8.0 / (r4 + EPS) - 2.0
    blinn = spec * (torch.clamp(dot(n, h), min=0.0) ** shin)[:, None]
    nov = torch.clamp(dot(n, v), min=0.0)
    ndh = torch.clamp(dot(n, h), min=0.0)
    bb = ndh * ndh * (r4 - 1.0) + 1.0
    D = r4 / (PI * bb * bb + EPS)
    k = (0.25 * rough) ** 2 / 2.0
    G = (ndl / (ndl * (1.0 - k) + k + EPS)) * (nov / (nov * (1.0 - k) + k
                                                      + EPS))
    ggx = ((D * G) / (4.0 * nov * ndl + EPS))[:, None] * _schlick(
        torch.clamp(dot(v, h), min=0.0)[:, None], spec)
    spec_term = torch.where(metal[:, None], ggx, blinn)
    return (alb * ndl[:, None] + spec_term) * lcol * ndl[:, None]


def _scatter(p, d, n, t, typ, alb, spec, rough, refidx, refract, uch, u3a,
             u3b):
    """(scattered, new o, new d, attenuation) (common.glsl:300-407)."""
    outside = dot(d, n) < 0
    N = torch.where(outside[:, None], n, -n)
    rough3 = rough[:, None]
    fuzz = _in_sphere(u3b)
    refl = d - 2.0 * dot(d, N)[:, None] * N
    # diffuse
    d_dif = N + unit(_in_sphere(u3a))
    a_dif = alb * torch.clamp(dot(N, d_dif), min=0.0)[:, None]
    # metal
    d_met = unit(refl + fuzz * rough3)
    ok_met = dot(d_met, N) > 0
    # dielectric
    one = torch.ones_like(refidx)
    ior1 = torch.where(outside, one, refidx)
    ior2 = torch.where(outside, refidx, one)
    eta = ior1 / ior2
    v = -unit(d)
    vdn = dot(v, N)
    sin_t = eta * torch.sqrt(dot(N * vdn[:, None] - v,
                                 N * vdn[:, None] - v).clamp(min=0))
    cos_t = sqrt0(1.0 - sin_t * sin_t)
    r0 = ((ior1 - ior2) / (ior1 + ior2)) ** 2
    prob = torch.where(sin_t >= 1.0, 1.0,
                       _schlick(torch.where(ior1 > ior2, cos_t, vdn), r0))
    reflects = uch < prob
    i = unit(d)
    ndi = dot(N, i)
    k = 1.0 - eta * eta * (1.0 - ndi * ndi)
    refr = torch.where((k >= 0)[:, None],
                       eta[:, None] * i - (eta * ndi + sqrt0(k))[:, None] * N,
                       0.0)
    d_die = torch.where(reflects[:, None], d_met, unit(refr + fuzz * rough3))
    a_die = torch.where((reflects | outside)[:, None], 1.0,
                        torch.exp(-refract * t[:, None]))
    below = (typ == DIELECTRIC) & ~reflects
    lift = torch.full_like(t, EPS)
    new_o = p + N * torch.where(below, -lift, lift)[:, None]
    dif, met = (typ == DIFFUSE)[:, None], (typ == METAL)[:, None]
    new_d = torch.where(dif, d_dif, torch.where(met, d_met, d_die))
    atten = torch.where(dif, a_dif, torch.where(met, spec, a_die))
    ok = (typ != METAL) | ok_met
    return ok, new_o, new_d, atten


def _sky(d):
    t = torch.clamp(0.8 * (d[:, 1] + 1.0), 0.0, 1.0)[:, None]
    blue = torch.tensor([0.5, 0.7, 1.0], dtype=d.dtype, device=d.device)
    return (1.0 - t) + t * blue


def _add(counts, b, **kw):
    c = counts.setdefault(b, {k: 0 for k in COUNT_KEYS})
    for k, v in kw.items():
        c[k] += int(v)


def _count_tests(counts, b, rs, made, real):
    T, S, M = rs.counts
    sph, msph = made[:, T:T + S], made[:, T + S:]
    _add(counts, b, tri=made[:, :T].sum(),
         sph=(sph & real[:, T:T + S]).sum(),
         sph_miss=(sph & ~real[:, T:T + S]).sum(),
         msph=(msph & real[:, T + S:]).sum(),
         msph_miss=(msph & ~real[:, T + S:]).sum())


def bounce(rs, o, d, time, thr, uni, rr, counts=None, b=0, boost=True):
    """One bounce of live paths: (colour added, survives, new o, new d,
    new throughput).  ``boost=False`` leaves the roulette's survivors
    unboosted (a fault the benchmark's control reads)."""
    hit, t, p, n, g, real = closest(rs, o, d, time)
    if counts is not None:
        _add(counts, b, paths=o.shape[0], folds=o.shape[0])
        _count_tests(counts, b, rs, torch.ones_like(real), real)
    mid = torch.cat([rs.tri_mat, rs.sph_mat, rs.msph_mat])[g].long()
    typ, alb, spec = rs.mat_type[mid], rs.mat_albedo[mid], rs.mat_spec[mid]
    rough, emis = rs.mat_rough[mid], rs.mat_emissive[mid]
    col = torch.where((hit & (emis != 0).any(1))[:, None], emis * thr, 0.0)
    # point lights, each with its shadow ray at time 0
    v = -unit(d)
    for j in range(rs.plight_pos.shape[0]):
        to = rs.plight_pos[j] - p
        dist = torch.sqrt(dot(to, to))
        l = to / dist[:, None]
        faces = hit & (dot(n, l) > 0)
        occ, made, sreal = shadow_tests(rs, p + n * EPS, l, dist - 1e-3)
        if counts is not None:
            _add(counts, b, folds=faces.sum())
            _count_tests(counts, b, rs, made & faces[:, None], sreal)
        lit = _point_light(n, l, v, alb, spec, rough, typ == METAL,
                           rs.plight_color[j])
        col = col + torch.where((faces & ~occ)[:, None], lit * thr, 0.0)
    ok, new_o, new_d, atten = _scatter(
        p, d, n, t, typ, alb, spec, rough, rs.mat_refidx[mid],
        rs.mat_refract[mid], uni.uch, uni.u3a, uni.u3b)
    col = col + torch.where((hit & ~ok)[:, None], thr * emis, 0.0)
    thr = torch.where((hit & ok)[:, None], thr * atten, thr)
    killed = torch.zeros_like(hit)
    if rr:
        pmax = thr.amax(1)
        killed = uni.urr > pmax
        if boost:
            thr = torch.where((hit & ok & ~killed)[:, None],
                              thr / torch.clamp(pmax, min=1e-12)[:, None],
                              thr)
    col = col + torch.where((~hit)[:, None], thr * _sky(d), 0.0)
    return col, hit & ok & ~killed, new_o, new_d, thr


def trace(rs, o, d, time, uni, max_bounces, rr=True, counts=None,
          boost=True):
    """Radiance (R, 3) of the paths of camera rays (o, d) (R, 3) at their
    ``time`` (R,), with ``uni`` (:class:`Uniforms` over the same R
    paths)."""
    check_scene(rs)
    # a float32 product on the card may otherwise run in TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    R, dt = o.shape[0], rs.dtype
    o, d, time = o.to(dt).clone(), d.to(dt).clone(), time.to(dt)
    uni = Uniforms(*(x.to(dt) for x in uni))
    col = torch.zeros((R, 3), dtype=dt, device=o.device)
    thr = torch.ones_like(col)
    live = torch.arange(R, device=o.device)
    for b in range(max_bounces):
        keep = []
        for a in range(0, live.shape[0], BLOCK):
            i = live[a:a + BLOCK]
            c, alive, o2, d2, thr2 = bounce(
                rs, o[i], d[i], time[i] if b == 0 else torch.zeros_like(
                    time[i]), thr[i],
                Uniforms(*(x[b, i] for x in uni)), rr, counts, b, boost)
            col[i] += c
            thr[i] = thr2
            o[i], d[i] = o2, d2
            keep.append(i[alive])
        live = torch.cat(keep) if keep else live[:0]
        if not live.shape[0]:
            break
    return col


def _paths(rows, cols, W, S):
    """The path indices of pixels (rows, cols), S each, in the frame's
    (row, column, sample) order."""
    base = (rows.long() * W + cols.long()) * S
    return (base[:, None] + torch.arange(S, device=rows.device)).reshape(-1)


def render_pixels(rs, cam, rows, cols, jitter, time, uni, max_bounces,
                  rr=True, counts=None, boost=True):
    """(P, 3) linear radiance of pixels (``rows``, ``cols``) (P,): the
    mean of their S paths, from the frame's samples ``jitter`` (H, W, S,
    2), ``time`` (H, W, S) and ``uni`` (:class:`Uniforms` over the frame's
    H * W * S paths)."""
    W, S = jitter.shape[1], jitter.shape[2]
    jit = jitter[rows, cols].to(rs.dtype)
    o, d = cam.rays(rows, cols, jit)
    idx = _paths(rows, cols, W, S)
    col = trace(rs, o, d, time[rows, cols].reshape(-1),
                uni.paths(idx), max_bounces, rr, counts, boost)
    return col.reshape(-1, S, 3).mean(1)


def render(rs, cam, jitter, time, uni, max_bounces, rr=True, counts=None,
           boost=True):
    """(H, W, 3) linear radiance of the whole frame."""
    H, W = jitter.shape[:2]
    rows, cols = torch.meshgrid(torch.arange(H, device=jitter.device),
                                torch.arange(W, device=jitter.device),
                                indexing="ij")
    return render_pixels(rs, cam, rows.reshape(-1), cols.reshape(-1),
                         jitter, time, uni, max_bounces, rr, counts,
                         boost).reshape(H, W, 3)
