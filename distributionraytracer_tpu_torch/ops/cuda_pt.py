"""The GLSL path tracer's kernels K4 ``pt_closest``, K5 ``pt_any_hit`` and
K6 ``pt_bounce`` as CUDA kernels (``csrc/pt.cu``).

Counterpart of ``distributionraytracer_tpu.ops.pallas_pt``.  The kernels walk
the packed ``(K, 12)`` primitive table in ``hit_world``'s group order
(triangles, spheres, moving spheres) with the strict-``<`` first-wins
update, one thread per ray lane; K4 and K5 read the callers' tensors in
place and test in rounds of rows side by side, and K4 writes ``PTHit``'s
fields in their layouts.  Plain versions:
``pathtracer.hit_world`` (K4), ``pathtracer.any_hit`` (K5) and
:func:`pt_bounce_plain` (K6).

Dispatch is by the tensors' device: CPU tensors take the plain version,
CUDA tensors launch the kernel (a failed build or launch raises).  Each
launch adds one to ``LAUNCHES``.

K6 runs one bounce a launch (:func:`pt_bounce`) on a tile's path state in
one contiguous ``(STATE_ROWS, R)`` f32 tensor, updated in place, or a
path's whole bounce loop in one launch (:func:`pt_trace`, the path
tracer's fused body), which keeps each block's state on the chip
and reads every bounce's uniforms in place from the stacked
:class:`~distributionraytracer_tpu_torch.integrator.pathtracer.BounceUniforms`.
Its plain version, :func:`pt_trace_plain`, is B bounces of
:func:`pt_bounce_plain`.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import numpy as np
import torch

from distributionraytracer_tpu_torch.integrator import pathtracer as PT
from distributionraytracer_tpu_torch.ops import build
from distributionraytracer_tpu_torch.ops.cuda_intersect import (
    ray_inputs, refuse_grad, require_cuda,
)
from distributionraytracer_tpu_torch.scene.pt_scenes import (
    MT_DIELECTRIC, MT_DIFFUSE, MT_METAL, MT_PLASTIC, PTScene, SKY_GRADIENT,
)
from distributionraytracer_tpu_torch.utils import spans

EPS = 1e-3  # common.glsl:7
PI = float(np.float32(3.14159265358979))

# Kernel launches since the last reset_launches(), by kernel.
LAUNCHES = {"pt_closest": 0, "pt_any_hit": 0, "pt_bounce": 0, "pt_trace": 0}

# Rows of K6's in-place path state (STATE_ROWS, R).
ST_O, ST_D, ST_TIME = slice(0, 3), slice(3, 6), 6
ST_COL, ST_THR, ST_ALIVE = slice(7, 10), slice(10, 13), 13
ST_MW, ST_MD = slice(14, 17), slice(17, 20)  # latched cubemap miss
STATE_ROWS = 20
# Rows of K6's uniform streams: uch, u3a (3), u3b (3), urr, then 2 per
# quad light.
UNIFORM_ROWS = 8


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


class PTTables(NamedTuple):
    data: torch.Tensor  # (K,12) f32 primitives, tri/sph/msph rows
    mats: torch.Tensor  # (K,) i32 material id per primitive
    mrow: torch.Tensor  # (K,16) f32 material row per primitive
    plights: torch.Tensor  # (Lp,6) f32 [pos, color]
    qlights: torch.Tensor  # (Lq,12) f32 [pos, e1, e2, color]
    counts: tuple  # (triangles, spheres, moving spheres)


def pack_pt(scene: PTScene):
    """PTScene -> ((K,12) f32 rows, (K,) i32 mats, (T, S, M) counts).

    Row layouts: tri [v0, e1, e2, 0]; sphere [c, r, 0]; moving sphere
    [c0, c1-c0, r, 0].  Group order matches hit_world's scan order."""
    T, S, M = (scene.tri_v0.shape[0], scene.sph_center.shape[0],
               scene.msph_c0.shape[0])
    z = lambda n, k: torch.zeros((n, k), dtype=torch.float32,
                                 device=scene.device)
    data = torch.cat([
        torch.cat([scene.tri_v0, scene.tri_e1, scene.tri_e2, z(T, 3)], 1),
        torch.cat([scene.sph_center, scene.sph_radius[:, None], z(S, 8)], 1),
        torch.cat([scene.msph_c0, scene.msph_c1 - scene.msph_c0,
                   scene.msph_radius[:, None], z(M, 5)], 1),
    ]).to(torch.float32).contiguous()
    mats = torch.cat([scene.tri_mat, scene.sph_mat, scene.msph_mat]).to(
        torch.int32).contiguous()
    return data, mats, (T, S, M)


def material_rows(scene: PTScene) -> torch.Tensor:
    """(n_materials, 16) f32: [type, albedo3, spec3, emissive3, rough,
    refidx, refract3 (the Beer color), stripe]."""
    f = lambda a: a.to(torch.float32)
    return torch.cat([
        f(scene.mat_type)[:, None], f(scene.mat_albedo), f(scene.mat_spec),
        f(scene.mat_emissive), f(scene.mat_rough)[:, None],
        f(scene.mat_refidx)[:, None], f(scene.mat_refract),
        f(scene.mat_stripe)[:, None]], dim=1)


def pack_pt_mats(scene: PTScene) -> torch.Tensor:
    """(K, 16) f32 per-PRIMITIVE material rows (see :func:`material_rows`),
    in :func:`pack_pt` order: the closest fold fetches the winner's row."""
    _, mats, _ = pack_pt(scene)
    return material_rows(scene)[mats.long()].contiguous()


def pt_tables(scene: PTScene) -> PTTables:
    spans.count("tables.builds.pt_tables")
    data, mats, counts = pack_pt(scene)
    f = lambda *a: torch.cat(a, dim=1).to(torch.float32).contiguous()
    return PTTables(
        data, mats, pack_pt_mats(scene),
        f(scene.plight_pos, scene.plight_color),
        f(scene.qlight_pos, scene.qlight_e1, scene.qlight_e2,
          scene.qlight_color), counts)


def _tables(scene, tables):
    return tables if tables is not None else pt_tables(scene)


def _stream():
    return torch.cuda.current_stream().cuda_stream


# ---------------------------------------------------------------- K4, K5
# The launch_* functions run a kernel on tensors already checked; they count
# nothing.  The *_kernel wrappers check, allocate, launch and count.
def launch_closest(tb: PTTables, o, d, time, out: PT.PTHit):
    """K4 on (R,3) o and d and (R,) f32 time, read in place, into ``out``'s
    tensors: hit (R,) bool, t (R,), pos (R,3), normal (R,3), mat (R,)
    i32."""
    with torch.cuda.device(o.device):
        err = build.load().lib.drt_pt_closest(
            tb.data.data_ptr(), tb.mats.data_ptr(), *tb.counts,
            o.data_ptr(), d.data_ptr(), time.data_ptr(), o.shape[0],
            *(x.data_ptr() for x in out), _stream())
    build.check(err, "drt_pt_closest")


def closest_outputs(R: int, device) -> PT.PTHit:
    """Uninitialised outputs of K4."""
    e = lambda *shape, dtype=torch.float32: torch.empty(
        shape, dtype=dtype, device=device)
    return PT.PTHit(hit=e(R, dtype=torch.bool), t=e(R), pos=e(R, 3),
                    normal=e(R, 3), mat=e(R, dtype=torch.int32))


def launch_any_hit(tb: PTTables, o, d, time, tmax, occ):
    """K5 on (R,3) o and d, (R,) f32 time, and tmax (R,) f32 or one float
    for every lane, into an (R,) bool output, read in place."""
    each = isinstance(tmax, torch.Tensor)
    with torch.cuda.device(o.device):
        err = build.load().lib.drt_pt_any_hit(
            tb.data.data_ptr(), *tb.counts, o.data_ptr(), d.data_ptr(),
            time.data_ptr(), tmax.data_ptr() if each else None,
            0.0 if each else float(tmax), o.shape[0], occ.data_ptr(),
            _stream())
    build.check(err, "drt_pt_any_hit")


def pt_closest_kernel(scene: PTScene, o, d, time,
                      tables: Optional[PTTables] = None) -> PT.PTHit:
    """K4 on CUDA tensors: hit_world at its default tmax."""
    tb = _tables(scene, tables)
    time = time.to(torch.float32).contiguous()
    o, d = ray_inputs("pt_closest", o, d, time)
    require_cuda("pt_closest", o, tb.data, tb.mats)
    if tb.data.data_ptr() % 16:
        raise ValueError("pt_closest: the table must be 16-byte aligned")
    out = closest_outputs(o.shape[0], o.device)
    launch_closest(tb, o, d, time, out)
    LAUNCHES["pt_closest"] += 1
    return out


def pt_any_hit_kernel(scene: PTScene, o, d, time, tmax,
                      tables: Optional[PTTables] = None):
    """K5 on CUDA tensors: occluded (R,) bool, tmin fixed at 1e-3.  ``tmax``
    is an (R,) tensor or one value for every lane, which the kernel
    broadcasts."""
    tb = _tables(scene, tables)
    R = o.shape[0]
    time = time.to(torch.float32).contiguous()
    if isinstance(tmax, torch.Tensor) and tmax.dim() > 0:
        tmax = tmax.to(torch.float32).contiguous()
        o, d = ray_inputs("pt_any_hit", o, d, time, tmax)
    else:
        tmax = float(tmax)
        o, d = ray_inputs("pt_any_hit", o, d, time)
    require_cuda("pt_any_hit", o, tb.data)
    if tb.data.data_ptr() % 16:
        raise ValueError("pt_any_hit: the table must be 16-byte aligned")
    occ = torch.empty((R,), dtype=torch.bool, device=o.device)
    launch_any_hit(tb, o, d, time, tmax, occ)
    LAUNCHES["pt_any_hit"] += 1
    return occ


def pt_closest(scene: PTScene, o, d, time,
               tables: Optional[PTTables] = None) -> PT.PTHit:
    """K4: ``hit_world`` for CPU tensors, the kernel for CUDA tensors."""
    if o.device.type == "cpu":
        return PT.hit_world(scene, o, d, time)
    return pt_closest_kernel(scene, o, d, time, tables)


def pt_any_hit(scene: PTScene, o, d, time, tmax,
               tables: Optional[PTTables] = None):
    """K5: ``any_hit`` (tmin 1e-3) for CPU tensors, the kernel for CUDA."""
    if o.device.type == "cpu":
        return PT.any_hit(scene, o, d, time, EPS, tmax)
    return pt_any_hit_kernel(scene, o, d, time, tmax, tables)


# -------------------------------------------------------------------- K6
def bounce_state(o, d, time) -> torch.Tensor:
    """A tile's initial path state: camera rays, colour 0, throughput 1,
    alive, no latched miss."""
    R = o.shape[0]
    st = torch.zeros((STATE_ROWS, R), dtype=torch.float32, device=o.device)
    st[ST_O] = o.T
    st[ST_D] = d.T
    st[ST_TIME] = time
    st[ST_THR] = 1.0
    st[ST_ALIVE] = 1.0
    return st


def bounce_streams(uch, u3a, u3b, urr, uq, n_ql: int) -> torch.Tensor:
    """One bounce's uniforms as (UNIFORM_ROWS + 2*n_ql, R) f32 streams."""
    return torch.cat([uch[None], u3a.T, u3b.T, urr[None],
                      uq[:, :2 * n_ql].T]).to(torch.float32).contiguous()


def _check_bounce(tb: PTTables, state, uni):
    R = state.shape[1]
    n_u = UNIFORM_ROWS + 2 * tb.qlights.shape[0]
    if state.shape != (STATE_ROWS, R) or state.dtype != torch.float32:
        raise ValueError(f"pt_bounce: state must be ({STATE_ROWS}, R) f32, "
                         f"got {tuple(state.shape)} {state.dtype}")
    if uni.shape != (n_u, R) or uni.dtype != torch.float32:
        raise ValueError(f"pt_bounce: uniforms must be ({n_u}, {R}) f32, "
                         f"got {tuple(uni.shape)} {uni.dtype}")


def _norm3(x, y, z):
    inv = torch.rsqrt(torch.clamp(x * x + y * y + z * z, min=1e-24))
    return x * inv, y * inv, z * inv


def _pow5(c):
    return c * ((c * c) * (c * c))


def _fresnel1(cos_t, f0):
    return f0 + (1.0 - f0) * _pow5(torch.clamp(1.0 - cos_t, min=0.0))


def _dot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def _brdf_terms(n, l, v_blinn, v_ggx, rough):
    """Blinn and GGX factors shared by point and quad lights: (ndl, lit,
    Blinn specular, D*G term, cos(v,h), n.v) with the GGX view ``v_ggx``."""
    ndl_raw = _dot(n, l)
    ndl = torch.clamp(ndl_raw, min=0.0)
    hb = _norm3(*(l[k] + v_blinn[k] for k in range(3)))
    r2 = rough * rough
    r4 = r2 * r2
    shin = 8.0 / (r4 + EPS) - 2.0
    spec_b = torch.clamp(_dot(n, hb), min=0.0) ** shin
    hg = hb if v_ggx is v_blinn else _norm3(*(l[k] + v_ggx[k]
                                              for k in range(3)))
    nov = torch.clamp(_dot(n, v_ggx), min=0.0)
    ndh = torch.clamp(_dot(n, hg), min=0.0)
    cos_vh = torch.clamp(_dot(v_ggx, hg), min=0.0)
    bb = ndh * ndh * (r4 - 1.0) + 1.0
    Dg = r4 / (PI * bb * bb + EPS)
    rr_ = 0.25 * rough
    kk = rr_ * rr_ / 2.0
    g1l = torch.clamp(ndl, min=0.0) / (ndl * (1.0 - kk) + kk + EPS)
    g1v = torch.clamp(nov, min=0.0) / (nov * (1.0 - kk) + kk + EPS)
    DG = (Dg * g1l * g1v) / (4.0 * nov * ndl + EPS)
    return ndl, ndl_raw > 0.0, spec_b, DG, cos_vh, nov


def _light_add(col, thr, gate, m, ndl, spec_b, DG, cos_vh, nov, lcolor):
    is_gm = (m["typ"] == MT_METAL) | (m["typ"] == MT_PLASTIC)
    is_pla = m["typ"] == MT_PLASTIC
    for k in range(3):
        ks_f = _fresnel1(torch.clamp(nov, min=0.0), m["spec"][k])
        ggx_k = DG * _fresnel1(cos_vh, m["spec"][k])
        spec_k = torch.where(is_gm, ggx_k, m["spec"][k] * spec_b)
        diff_k = torch.where(is_pla, (1.0 - ks_f) * m["alb"][k] / PI,
                             m["alb"][k] * ndl)
        contrib = (diff_k + spec_k) * lcolor[k] * ndl
        col[k] = col[k] + torch.where(gate, contrib * thr[k], 0.0)


def _unit_sphere(u0, u1, u2):
    h0 = u0 * 2.0 - 1.0
    phi = u1 * 6.28318530718
    r3 = torch.pow(torch.clamp(u2, min=0.0), 1.0 / 3.0)
    s = torch.sqrt(torch.clamp(1.0 - h0 * h0, min=0.0))
    return (r3 * s * torch.sin(phi), r3 * s * torch.cos(phi), r3 * h0)


def pt_bounce_plain(scene: PTScene, state, uni, rr: bool,
                    tables: Optional[PTTables] = None):
    """Plain torch version of K6: one bounce of every lane of ``state``,
    updated in place (and returned).

    Computes what ``pallas_pt._bounce_kernel`` computes, from the plain
    closest/any-hit, keeping the kernel's formulas where they differ from
    the staged body (``pow(u, 1/3)``, ``rsqrt(max(x, 1e-24))``
    normalisation, the latched cubemap miss)."""
    tb = _tables(scene, tables)
    _check_bounce(tb, state, uni)
    R = state.shape[1]
    o = state[ST_O].T
    d = state[ST_D].T
    dx, dy, dz = state[3], state[4], state[5]
    col = [state[7 + k].clone() for k in range(3)]
    thr = [state[10 + k].clone() for k in range(3)]
    alive = state[ST_ALIVE] > 0.0
    zero = torch.zeros((R,), dtype=torch.float32, device=state.device)

    # ---- closest hit and the winner's material row ----
    h = PT.hit_world(scene, o, d, state[ST_TIME])
    hit = h.hit
    n = _norm3(h.normal[:, 0], h.normal[:, 1], h.normal[:, 2])
    mr = torch.where(hit[:, None], material_rows(scene)[h.mat.long()], 0.0)
    m = {"typ": mr[:, 0], "alb": [mr[:, 1 + k] for k in range(3)],
         "spec": [mr[:, 4 + k] for k in range(3)],
         "emis": [mr[:, 7 + k] for k in range(3)], "rough": mr[:, 10],
         "refidx": mr[:, 11], "refract": [mr[:, 12 + k] for k in range(3)]}
    t_safe = torch.where(hit, h.t, 1.0)
    p = [state[k] + state[3 + k] * t_safe for k in range(3)]
    # striped background shade (P3D_RT.glsl:149)
    shade = torch.floor(torch.remainder(p[0], 1.0) * 2.0)
    m["alb"] = [torch.where(mr[:, 15] > 0.5, shade, a) for a in m["alb"]]

    live_hit = alive & hit
    emis_on = ((m["emis"][0] != 0.0) | (m["emis"][1] != 0.0)
               | (m["emis"][2] != 0.0))
    for k in range(3):
        col[k] = col[k] + torch.where(live_hit & emis_on,
                                      m["emis"][k] * thr[k], 0.0)

    # ---- point lights with shadow rays (time 0) ----
    v = [-c for c in _norm3(dx, dy, dz)]  # viewDir (P3D_RT.glsl:526)
    for j in range(tb.plights.shape[0]):
        L = tb.plights[j]
        lu = [L[k] - p[k] for k in range(3)]
        dist = torch.sqrt(torch.clamp(_dot(lu, lu), min=1e-24))
        l = [c / dist for c in lu]
        so = torch.stack([p[k] + n[k] * EPS for k in range(3)], dim=-1)
        shadowed = PT.any_hit(scene, so, torch.stack(l, dim=-1), zero, EPS,
                              dist - 1e-3)
        ndl, lit, spec_b, DG, cos_vh, nov = _brdf_terms(n, l, v, v,
                                                        m["rough"])
        _light_add(col, thr, live_hit & lit & ~shadowed, m, ndl, spec_b, DG,
                   cos_vh, nov, L[3:6])

    # ---- quad lights: jittered point, NO shadow ray, and the GGX view
    # sign quirk — BRDF_GGX receives -viewDir = the raw ray direction
    # while Blinn-H keeps +viewDir (P3D_RT.glsl:483-523) ----
    g = [-c for c in v]
    for j in range(tb.qlights.shape[0]):
        Q = tb.qlights[j]
        u1, u2 = uni[UNIFORM_ROWS + 2 * j], uni[UNIFORM_ROWS + 2 * j + 1]
        lp = [Q[k] + Q[3 + k] * u1 + Q[6 + k] * u2 for k in range(3)]
        l = _norm3(*(lp[k] - p[k] for k in range(3)))
        ndl, lit, spec_b, DG, cos_vh, nov = _brdf_terms(n, l, v, g,
                                                        m["rough"])
        _light_add(col, thr, live_hit & lit, m, ndl, spec_b, DG, cos_vh, nov,
                   Q[9:12])

    # ---- scatter (common.glsl:300-407) ----
    uch = uni[0]
    outside = (dx * n[0] + dy * n[1] + dz * n[2]) < 0.0
    sgn = torch.where(outside, 1.0, -1.0)
    N = [c * sgn for c in n]
    rough, spec, alb = m["rough"], m["spec"], m["alb"]
    uv = _norm3(*_unit_sphere(uni[1], uni[2], uni[3]))
    sb = _unit_sphere(uni[4], uni[5], uni[6])

    # DIFFUSE: dir = N + unit vector, unnormalized
    dd = [N[k] + uv[k] for k in range(3)]
    ndd = torch.clamp(_dot(N, dd), min=0.0)
    a_dif = [alb[k] * ndd for k in range(3)]
    # METAL: reflect + rough fuzz
    ddn = dx * N[0] + dy * N[1] + dz * N[2]
    rf = [state[3 + k] - 2.0 * ddn * N[k] for k in range(3)]
    md = _norm3(*(rf[k] + sb[k] * rough for k in range(3)))
    ok_met = _dot(md, N) > 0.0
    # DIELECTRIC
    one = torch.ones_like(rough)
    ior1 = torch.where(outside, one, m["refidx"])
    ior2 = torch.where(outside, m["refidx"], one)
    eta = ior1 / ior2
    vdn = _dot(v, N)
    vt = [N[k] * vdn - v[k] for k in range(3)]
    sin_i = torch.sqrt(torch.clamp(_dot(vt, vt), min=0.0))
    sin_t = eta * sin_i
    cos_t = torch.sqrt(torch.clamp(1.0 - sin_t * sin_t, min=0.0))
    cos_sel = torch.where(ior1 > ior2, cos_t, vdn)
    q = (ior1 - ior2) / (ior1 + ior2)
    r0 = q * q
    schl = r0 + (1.0 - r0) * _pow5(torch.clamp(1.0 - cos_sel, min=0.0))
    refl_prob = torch.where(sin_t >= 1.0, 1.0, schl)
    take_refl = uch < refl_prob
    i3 = _norm3(dx, dy, dz)
    ndi = _dot(N, i3)
    kref = 1.0 - eta * eta * (1.0 - ndi * ndi)
    kok = kref >= 0.0
    rt = eta * ndi + torch.sqrt(torch.clamp(kref, min=0.0))
    rr3 = [torch.where(kok, eta * i3[k] - rt * N[k], 0.0) for k in range(3)]
    qd = _norm3(*(rr3[k] + sb[k] * rough for k in range(3)))
    de = [torch.where(take_refl, md[k], qd[k]) for k in range(3)]
    t_beer = torch.where(hit, h.t, 0.0)
    a_die = [torch.where(take_refl | outside, 1.0,
                         torch.exp(-m["refract"][k] * t_beer))
             for k in range(3)]
    # PLASTIC
    lpl = _norm3(*(state[k] - p[k] for k in range(3)))
    hp = _norm3(*(v[k] + lpl[k] for k in range(3)))
    cos_p = _dot(v, hp)
    f_vec = [_fresnel1(cos_p, spec[k]) for k in range(3)]
    prob = (f_vec[0] + f_vec[1] + f_vec[2]) / 3.0
    take_spec = uch < prob
    gate_p = _dot(md, N) > 0.0
    pd = _norm3(*(N[k] + sb[k] for k in range(3)))
    pl = [torch.where(take_spec, md[k], pd[k]) for k in range(3)]

    typ = m["typ"]
    is_dif, is_met = typ == MT_DIFFUSE, typ == MT_METAL
    is_die = typ == MT_DIELECTRIC

    def sel(a_dif_, a_met_, a_die_, a_pla_):
        r = torch.where(is_dif, a_dif_, a_pla_)
        r = torch.where(is_met, a_met_, r)
        return torch.where(is_die, a_die_, r)

    new_d = [sel(dd[k], md[k], de[k], pl[k]) for k in range(3)]
    off = torch.where(is_die & ~take_refl, -EPS, EPS)
    new_o = [p[k] + N[k] * off for k in range(3)]
    ok = ~is_met | ok_met
    g_ab = live_hit & ~ok
    for k in range(3):
        a_spec_k = torch.where(gate_p,
                               spec[k] / torch.clamp(prob, min=1e-8), 1.0)
        a_dpla_k = ((1.0 - f_vec[k]) * alb[k] / PI
                    / torch.clamp(1.0 - prob, min=1e-8))
        atten = sel(a_dif[k], spec[k], a_die[k],
                    torch.where(take_spec, a_spec_k, a_dpla_k))
        # no-scatter absorbed: col += thr * emissive (P3D_RT.glsl:641-645)
        col[k] = col[k] + torch.where(g_ab, thr[k] * m["emis"][k], 0.0)
        thr[k] = torch.where(live_hit & ok, thr[k] * atten, thr[k])

    # Russian roulette (P3D_RT.glsl:651-656)
    if rr:
        pmax = torch.maximum(thr[0], torch.maximum(thr[1], thr[2]))
        killed = uni[7] > pmax
        boost = 1.0 / torch.clamp(pmax, min=1e-12)
        for k in range(3):
            thr[k] = torch.where(live_hit & ok & ~killed, thr[k] * boost,
                                 thr[k])
    else:
        killed = torch.zeros_like(alive)

    # miss (P3D_RT.glsl:659-672): the gradient sky folds in; cubemap modes
    # latch (throughput, direction) for one texel gather after the loop
    miss = alive & ~hit
    if scene.sky_mode == SKY_GRADIENT:
        tsky = torch.clamp(0.8 * (dy + 1.0), 0.0, 1.0)
        for k, c in enumerate((0.5, 0.7, 1.0)):
            col[k] = col[k] + torch.where(miss, thr[k] * (1.0 - tsky
                                                          + tsky * c), 0.0)
    else:
        state[ST_MW] = torch.where(miss, torch.stack(thr), state[ST_MW])
        state[ST_MD] = torch.where(miss, state[ST_D], state[ST_MD])

    alive2 = alive & hit & ok & ~killed
    state[ST_O] = torch.where(alive2, torch.stack(new_o), state[ST_O])
    state[ST_D] = torch.where(alive2, torch.stack(new_d), state[ST_D])
    state[ST_TIME] = 0.0  # scattered rays carry time 0 (common.glsl:43-46)
    state[ST_COL] = torch.stack(col)
    state[ST_THR] = torch.stack(thr)
    state[ST_ALIVE] = alive2.to(torch.float32)
    return state


def launch_bounce(tb: PTTables, state, uni, rr: bool, grad_sky: bool):
    """K6 on a (STATE_ROWS, R) state, in place, with (n_u, R) uniforms."""
    with torch.cuda.device(state.device):
        err = build.load().lib.drt_pt_bounce(
            tb.data.data_ptr(), tb.mrow.data_ptr(), *tb.counts,
            tb.plights.data_ptr(), tb.plights.shape[0],
            tb.qlights.data_ptr(), tb.qlights.shape[0],
            state.data_ptr(), uni.data_ptr(), state.shape[1], int(rr),
            int(grad_sky), _stream())
    build.check(err, "drt_pt_bounce")


def pt_bounce_kernel(scene: PTScene, state, uni, rr: bool,
                     tables: Optional[PTTables] = None):
    """K6 on CUDA tensors: one bounce, ``state`` updated in place."""
    tb = _tables(scene, tables)
    _check_bounce(tb, state, uni)
    require_cuda("pt_bounce", state, uni, tb.data, tb.mrow, tb.plights,
                 tb.qlights)
    launch_bounce(tb, state, uni, rr, scene.sky_mode == SKY_GRADIENT)
    LAUNCHES["pt_bounce"] += 1
    return state


def pt_bounce(scene: PTScene, state, uni, rr: bool,
              tables: Optional[PTTables] = None):
    """K6: the plain version for CPU tensors, the kernel for CUDA tensors."""
    if state.device.type == "cpu":
        return pt_bounce_plain(scene, state, uni, rr, tables)
    return pt_bounce_kernel(scene, state, uni, rr, tables)


# ------------------------------------------------------------- looped K6
class Traced(NamedTuple):
    """The looped K6's outputs: each path's colour (R,3) and, for cubemap
    skies (None under the gradient sky), the throughput and direction
    latched at its miss (R,3), zero where it never missed."""

    col: torch.Tensor
    mw: Optional[torch.Tensor]
    md: Optional[torch.Tensor]


def _trace_uniforms(uniforms, R: int, n_ql: int):
    """The stacked uniforms as f32 tensors the looped K6 reads in place
    through their bounce and lane strides: shapes and devices checked, a
    vector's components adjacent (a copy only where they are not)."""
    B = uniforms.uch.shape[0]
    tails = ((2 * max(n_ql, 1),), (), (3,), (3,), ())
    out = []
    for name, x, tail in zip(uniforms._fields, uniforms, tails):
        x = x.to(torch.float32)
        if tuple(x.shape) != (B, R) + tail:
            raise ValueError(f"pt_trace: {name} must be "
                             f"{(B, R) + tail}, got {tuple(x.shape)}")
        if x.dim() == 3 and x.stride(2) != 1:
            x = x.contiguous()
        out.append(x)
    return type(uniforms)(*out)


def launch_trace(tb: PTTables, o, d, time, uni, rr: bool, grad_sky: bool,
                 out: Traced, live=None):
    """The looped K6 on (R,3) o and d and (R,) f32 time, read in place,
    over every bounce of the stacked uniforms ``uni``, into ``out``'s
    tensors; ``live`` (B,) i32, if given, gains each bounce's live paths."""
    ptrs = (ctypes.c_void_p * 5)(*(x.data_ptr() for x in uni))
    strides = (ctypes.c_longlong * 10)(*(x.stride(0) for x in uni),
                                       *(x.stride(1) for x in uni))
    ptr = lambda x: None if x is None else x.data_ptr()
    with torch.cuda.device(o.device):
        err = build.load().lib.drt_pt_trace(
            tb.data.data_ptr(), tb.mrow.data_ptr(), *tb.counts,
            tb.plights.data_ptr(), tb.plights.shape[0],
            tb.qlights.data_ptr(), tb.qlights.shape[0], o.data_ptr(),
            d.data_ptr(), time.data_ptr(), o.shape[0], uni.uch.shape[0],
            ptrs, strides, int(rr), int(grad_sky), out.col.data_ptr(),
            ptr(out.mw), ptr(out.md), ptr(live), _stream())
    build.check(err, "drt_pt_trace")


def pt_trace_plain(scene: PTScene, o, d, time, uniforms, rr: bool,
                   tables: Optional[PTTables] = None) -> Traced:
    """The looped K6's plain version: B bounces of :func:`pt_bounce_plain`
    on one ``(STATE_ROWS, R)`` state, bounce b on ``uniforms.bounce(b)``."""
    tb = _tables(scene, tables)
    n_ql = scene.qlight_pos.shape[0]
    B = uniforms.uch.shape[0]
    state = bounce_state(o, d, time)
    live = (torch.zeros((), dtype=torch.int64, device=o.device)
            if spans.enabled() else None)
    for b in range(B):
        if live is not None:
            live += torch.count_nonzero(state[ST_ALIVE])
        u = uniforms.bounce(b)
        pt_bounce_plain(scene, state, bounce_streams(
            u.uch, u.u3a, u.u3b, u.urr, u.uq, n_ql), rr, tb)
    _count_paths(o.shape[0] * B, live)
    if scene.sky_mode == SKY_GRADIENT:
        return Traced(state[ST_COL].T, None, None)
    return Traced(state[ST_COL].T, state[ST_MW].T, state[ST_MD].T)


def _count_paths(paths: int, live):
    """``pt.paths`` and, while the recorder is on, ``pt.paths_live``: the
    counts of one bounce loop, as a launch a bounce gives them."""
    spans.count("pt.paths", paths)
    if live is not None:
        spans.count_device("pt.paths_live", live)


def pt_trace_kernel(scene: PTScene, o, d, time, uniforms, rr: bool,
                    tables: Optional[PTTables] = None) -> Traced:
    """The looped K6 on CUDA tensors: every bounce of the paths from camera
    rays ``o``, ``d`` (R,3) at ``time`` (R,), one bounce a leading index of
    the stacked ``uniforms`` (``pathtracer.BounceUniforms``, (B, R, ...)),
    in one launch; the live paths of each bounce are summed on the card."""
    tb = _tables(scene, tables)
    R = o.shape[0]
    time = time.to(torch.float32).contiguous()
    o, d = ray_inputs("pt_trace", o, d, time)
    require_cuda("pt_trace", o, tb.data, tb.mrow, tb.plights, tb.qlights)
    uni = _trace_uniforms(uniforms, R, tb.qlights.shape[0])
    refuse_grad("pt_trace", *uni)
    for x in uni:
        if x.device != o.device:
            raise ValueError(f"pt_trace: uniforms on {x.device}, rays on "
                             f"{o.device}")
    B = uni.uch.shape[0]
    grad_sky = scene.sky_mode == SKY_GRADIENT
    rows = lambda: torch.empty((R, 3), dtype=torch.float32, device=o.device)
    out = Traced(rows(), None if grad_sky else rows(),
                 None if grad_sky else rows())
    live = (torch.zeros((B,), dtype=torch.int32, device=o.device)
            if spans.enabled() else None)
    launch_trace(tb, o, d, time, uni, rr, grad_sky, out, live)
    LAUNCHES["pt_trace"] += 1
    _count_paths(R * B, None if live is None else live.sum())
    return out


def pt_trace(scene: PTScene, o, d, time, uniforms, rr: bool,
             tables: Optional[PTTables] = None) -> Traced:
    """The looped K6: the plain version for CPU tensors, one launch for
    every bounce on CUDA tensors.  Counts ``pt.paths`` (R a bounce) and,
    while the recorder is on, ``pt.paths_live`` (those alive at each
    bounce's start)."""
    if o.device.type == "cpu":
        return pt_trace_plain(scene, o, d, time, uniforms, rr, tables)
    return pt_trace_kernel(scene, o, d, time, uniforms, rr, tables)
