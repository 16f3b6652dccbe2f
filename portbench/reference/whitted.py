"""The reference Whitted ray tree (main.cpp:294-521 of the upstream
renderer) in plain PyTorch, in the scene's floating type.

A ray that hits spawns at most a refraction child (``T == 1`` and no total
internal reflection) and a reflection child (``Ks > 0``), down to
``max_depth``; the children's colours are clamped where they are added and
every level but the last clamps its own.  Shadows follow the scene's
accelerator: with none, the occluder test runs against the unit distance
(``1e-4 < t < 1``) and skips the shaded object (main.cpp:432-440); under a
BVH against the true light distance (``t <= dist + EPSILON``, bvh.cpp:376).
Each level traces only the rays that exist (no dead lanes), in blocks.

Objects are tested by brute force.  Triangles are first culled by bounding
spheres of runs of ``CLUSTER`` triangles in Morton order of their
centroids, a cull that drops no triangle a ray can hit, so that a
100k-triangle mesh stays affordable; the ray blocks are square pixel
tiles, whose rays meet few of the spheres.

``counts`` (a dict) collects, per tree level, the rays traced, the shadow
rays and the FP32 operations of the object tests a fused level kernel
needs for them (``portbench.roofline``).
"""

from __future__ import annotations

import torch

from portbench import roofline

EPSILON = 1e-3  # macros.h:1
OFFSET = 1e-4  # secondary and shadow origins (main.cpp:378)
CLUSTER = 64  # triangles a culling sphere covers
BLOCK = 1 << 17  # rays a sphere block tests at once
TRI_BLOCK = 1024  # rays a triangle block tests at once
TRI_PAIRS = 1 << 25  # (ray, triangle) pairs a triangle block holds


def dot(a, b):
    return (a * b).sum(-1)


def safe_sqrt(x):
    ok = x > 0
    return torch.where(ok, torch.sqrt(torch.where(ok, x, 1.0)), 0.0)


def unit(x):
    """``x / |x|``; a zero vector stays zero (and has no NaN gradient)."""
    n2 = dot(x, x)
    ok = n2 > 1e-30
    return torch.where(ok[..., None],
                       x / torch.sqrt(torch.where(ok, n2, 1.0))[..., None],
                       0.0)


def clamp01(c):
    return torch.clamp(c, 0.0, 1.0)


# ------------------------------------------------------------- primitives
def sphere_t(o, d, c, r):
    """(t (R, N) with inf for a miss, discriminant >= 0 (R, N)): the
    nearest root beyond EPSILON (scene.cpp:152-197)."""
    oc = o[:, None, :] - c[None]
    a = dot(d, d)[:, None]
    b = 2.0 * dot(oc, d[:, None, :])
    cq = dot(oc, oc) - (r * r)[None]
    disc = b * b - 4.0 * a * cq
    sq = safe_sqrt(disc)
    t1 = (-b - sq) / (2.0 * a)
    t2 = (-b + sq) / (2.0 * a)
    t = torch.where(t1 > EPSILON, t1, t2)
    hit = (disc >= 0) & (t > EPSILON)
    return torch.where(hit, t, float("inf")), disc >= 0


def triangle_t(o, d, v0, e1, e2):
    """(R, N) Moller-Trumbore t, inf for a miss (scene.cpp:44-92)."""
    dx, dy, dz = (d[:, k:k + 1] for k in range(3))
    e1x, e1y, e1z = (e1[None, :, k] for k in range(3))
    e2x, e2y, e2z = (e2[None, :, k] for k in range(3))
    hx = dy * e2z - dz * e2y
    hy = dz * e2x - dx * e2z
    hz = dx * e2y - dy * e2x
    a = e1x * hx + e1y * hy + e1z * hz
    nz = a != 0
    f = 1.0 / torch.where(nz, a, 1.0)
    sx, sy, sz = (o[:, k:k + 1] - v0[None, :, k] for k in range(3))
    u = f * (sx * hx + sy * hy + sz * hz)
    qx = sy * e1z - sz * e1y
    qy = sz * e1x - sx * e1z
    qz = sx * e1y - sy * e1x
    v = f * (qx * dx + qy * dy + qz * dz)
    t = f * (e2x * qx + e2y * qy + e2z * qz)
    ok = nz & (u >= 0) & (u <= 1) & (v >= 0) & (u + v <= 1) & (t > EPSILON)
    return torch.where(ok, t, float("inf"))


def _morton(p):
    """30-bit Morton codes of points (N, 3) in their bounding box."""
    lo, hi = p.amin(0), p.amax(0)
    q = ((p - lo) / torch.clamp(hi - lo, min=1e-12) * 1023).long()
    code = torch.zeros(p.shape[0], dtype=torch.int64, device=p.device)
    for bit in range(10):
        for axis in range(3):
            code |= ((q[:, axis] >> bit) & 1) << (3 * bit + axis)
    return code


def _clusters(sc):
    """(order, centre, radius): the triangles in Morton order of their
    centroids, and bounding spheres of each run of CLUSTER of them
    (cached on the scene)."""
    if getattr(sc, "_clu", None) is None:
        v0 = sc.tri_v0.float()
        verts = torch.stack([v0, v0 + sc.tri_e1.float(),
                             v0 + sc.tri_e2.float()], 1)  # (n, 3, 3)
        order = torch.argsort(_morton(verts.mean(1)))
        n = order.shape[0]
        k = (n + CLUSTER - 1) // CLUSTER
        pad = torch.cat([order, order[-1:].expand(k * CLUSTER - n)])
        vs = verts[pad].reshape(k, CLUSTER * 3, 3)
        lo, hi = vs.amin(1), vs.amax(1)
        center = (lo + hi) / 2
        rad = torch.sqrt(((vs - center[:, None]) ** 2).sum(-1)).amax(1)
        sc._clu = (order, center, rad * 1.001 + 1e-4)
    return sc._clu


def _triangle_candidates(sc, o, d):
    """Indices of the triangles whose culling sphere some ray of the block
    meets in front of its origin."""
    order, center, rad = _clusters(sc)
    oc = o.float()[:, None, :] - center[None]
    df = d.float()
    a = dot(df, df)[:, None]
    b = dot(oc, df[:, None, :])
    cq = dot(oc, oc) - (rad * rad)[None]
    disc = b * b - a * cq
    far = (-b + safe_sqrt(disc)) / a
    keep = ((disc >= 0) & (far > 0)).any(0).nonzero()[:, 0]
    pos = (keep[:, None] * CLUSTER
           + torch.arange(CLUSTER, device=o.device)[None]).reshape(-1)
    return order[pos[pos < order.shape[0]]]


def _tri_blocks(sc, o, d):
    """(block start, block end, triangle ids, t matrix) over the ray
    blocks and their culled candidates."""
    R = o.shape[0]
    for a in range(0, R, TRI_BLOCK):
        b = min(a + TRI_BLOCK, R)
        cand = _triangle_candidates(sc, o[a:b], d[a:b])
        step = max(TRI_PAIRS // (b - a), CLUSTER)
        for c0 in range(0, cand.shape[0], step):
            ids = cand[c0:c0 + step]
            yield a, b, ids, triangle_t(o[a:b], d[a:b], sc.tri_v0[ids],
                                        sc.tri_e1[ids], sc.tri_e2[ids])


def _triangle_min(sc, o, d):
    """(t, triangle index) of each ray's nearest triangle (inf, 0 on a
    miss), the lowest object id on a tie."""
    R = o.shape[0]
    big = torch.iinfo(torch.int64).max
    best_t = torch.full((R,), float("inf"), dtype=o.dtype, device=o.device)
    best_g = torch.full((R,), big, dtype=torch.int64, device=o.device)
    for a, b, ids, tm in _tri_blocks(sc, o, d):
        t = tm.min(1).values
        g = torch.where((tm == t[:, None]) & torch.isfinite(tm),
                        sc.tri_gid[ids][None], big).min(1).values
        better = (t < best_t[a:b]) | ((t == best_t[a:b]) & (g < best_g[a:b]))
        best_t[a:b] = torch.where(better, t, best_t[a:b])
        best_g[a:b] = torch.where(better, g, best_g[a:b])
    idx = torch.searchsorted(sc.tri_gid, torch.clamp(best_g, max=int(
        sc.tri_gid[-1])))
    return best_t, idx


def _triangle_any(sc, o, d, dist):
    """Whether a triangle occludes each shadow ray (``t <= dist +
    EPSILON``, the BVH compare)."""
    occ = torch.zeros((o.shape[0],), dtype=torch.bool, device=o.device)
    for a, b, ids, tm in _tri_blocks(sc, o, d):
        occ[a:b] |= (tm <= dist[a:b, None] + EPSILON).any(1)
    return occ


# ------------------------------------------------------------ hit queries
def closest(sc, o, d, counts=None):
    """(hit, t, unit normal, object id, material) of each ray's nearest
    object; a tie in t goes to the lower object id."""
    R = o.shape[0]
    t = torch.full((R,), float("inf"), dtype=o.dtype, device=o.device)
    gid = torch.full((R,), -1, dtype=torch.int64, device=o.device)
    normal = torch.zeros_like(o)
    mat = torch.zeros((R,), dtype=torch.int64, device=o.device)
    if sc.sph_c.shape[0]:
        tm, real = sphere_t(o, d, sc.sph_c, sc.sph_r)
        ts, j = tm.min(1)
        if counts is not None:
            counts["closest_ops"] += roofline.sphere_ops(real) + (
                roofline.FOLD_OPS * R)
        hs = torch.isfinite(ts)
        t = torch.where(hs, ts, t)
        gid = torch.where(hs, sc.sph_gid[j], gid)
        p = o + d * torch.where(hs, ts, 1.0)[:, None] - sc.sph_c[j]
        normal = torch.where(hs[:, None], unit(p), normal)
        mat = torch.where(hs, sc.sph_mat[j], mat)
    if sc.tri_v0.shape[0]:
        tt, j = _triangle_min(sc, o.detach(), d.detach())
        if counts is not None:
            counts["closest_ops"] += roofline.TRI_OPS * R * sc.tri_v0.shape[0]
        tg = sc.tri_gid[j]
        better = (tt < t) | ((tt == t) & torch.isfinite(tt) & (tg < gid))
        t = torch.where(better, tt, t)
        gid = torch.where(better, tg, gid)
        nt = unit(torch.linalg.cross(sc.tri_e1[j], sc.tri_e2[j]))
        normal = torch.where(better[:, None], nt, normal)
        mat = torch.where(better, sc.tri_mat[j], mat)
    return torch.isfinite(t), t, normal, gid, mat


def occluded(sc, o, d, dist, exclude, counts=None):
    """Whether an object occludes each shadow ray, with the compare of the
    scene's accelerator (module docstring)."""
    bvh = sc.accel == 2
    occ = torch.zeros((o.shape[0],), dtype=torch.bool, device=o.device)
    if sc.sph_c.shape[0]:
        tm, real = sphere_t(o, d, sc.sph_c, sc.sph_r)
        if bvh:
            hit = tm <= dist[:, None] + EPSILON
        else:
            hit = ((tm > OFFSET) & (tm < dist[:, None])
                   & (sc.sph_gid[None] != exclude[:, None]))
        occ |= hit.any(1)
        if counts is not None:
            counts["shadow_ops"] += roofline.shadow_sphere_ops(
                real, hit, sc.sph_gid[None] == exclude[:, None])
    if sc.tri_v0.shape[0]:
        occ |= _triangle_any(sc, o.detach(), d.detach(), dist.detach())
    return occ


# ---------------------------------------------------------------- the tree
def _level(counts, level):
    if counts is None:
        return None
    return counts.setdefault(level, dict(rays=0, shadow_rays=0,
                                         closest_ops=0.0, shadow_ops=0.0))


def trace(sc, o, d, ior, level, max_depth, counts=None):
    """Colour (R, 3) of the ray tree rooted at rays (o, d) in a medium of
    index ``ior``, at tree level ``level``."""
    cnt = _level(counts, level)
    if cnt is not None:
        cnt["rays"] += o.shape[0]
    hit, t, nrm, gid, mat = closest(sc, o, d, cnt)
    color = clamp01(sc.bg).expand(o.shape[0], 3)
    hi = hit.nonzero()[:, 0]
    if hi.numel() == 0:
        return color
    o, d, t, nrm, gid, m, ior1 = (x[hi] for x in (o, d, t, nrm, gid, mat,
                                                   ior))
    p = o + d * t[:, None]
    outside = dot(d, nrm) < 0
    N = torch.where(outside[:, None], nrm, -nrm)
    V = -unit(d)
    cd, cs = sc.cd[m], sc.cs[m]
    kd, ks, shine, trans, mior = sc.kd[m], sc.ks[m], sc.shine[m], sc.T[m], \
        sc.ior[m]
    # direct light, every light's shadow ray in one query
    L_un = sc.lights[None] - p[:, None]  # (n, L, 3)
    L = unit(L_un)
    H = unit(L + V[:, None])
    ndl = torch.clamp(dot(N[:, None], L), min=0.0)
    ndh = torch.clamp(dot(N[:, None], H), min=0.0)
    spec = torch.pow(torch.clamp(ndh, min=1e-12), shine[:, None])
    contrib = (cd[:, None] * (kd[:, None] * ndl)[..., None]
               + cs[:, None] * (ks[:, None] * spec)[..., None])
    n, nl = p.shape[0], L.shape[1]
    sorg = (p + N * OFFSET)[:, None].expand(n, nl, 3).reshape(-1, 3)
    if sc.accel == 2:
        dist = torch.sqrt(dot(L_un, L_un)).reshape(-1)
    else:
        dist = torch.ones((n * nl,), dtype=p.dtype, device=p.device)
    if cnt is not None:
        cnt["shadow_rays"] += n * nl
    with torch.no_grad():
        occ = occluded(sc, sorg.detach(), L.reshape(-1, 3).detach(),
                       dist.detach(), gid[:, None].expand(n, nl).reshape(-1),
                       cnt).reshape(n, nl)
    direct = torch.where(occ[..., None], 0.0, contrib).sum(1)
    if level >= max_depth:
        out = direct
    else:
        ior2 = torch.where(outside, mior, 1.0)
        eta = ior1 / ior2
        vdn = dot(V, N)
        vt = N * vdn[:, None] - V
        sin_i = safe_sqrt(dot(vt, vt))
        th = vt / torch.where(sin_i > 0, sin_i, 1.0)[:, None]
        sin_t = eta * sin_i
        no_tir = sin_t < 1.0
        cos_t = safe_sqrt(1.0 - sin_t * sin_t)
        rdir = unit(torch.where((sin_i > 0)[:, None],
                                th * sin_t[:, None] - N * cos_t[:, None], -N))
        cos_th = torch.where(ior1 > ior2, cos_t, vdn)
        r0 = ((ior1 - ior2) / (ior1 + ior2)) ** 2
        fres = r0 + (1.0 - r0) * torch.clamp(1.0 - cos_th, min=0.0) ** 5
        do_refr = (trans == 1.0) & no_tir
        krf = torch.where(do_refr, fres,
                          torch.where((trans > 0) & ~no_tir, 1.0, ks))
        beer = torch.where(outside[:, None], 1.0,
                           torch.exp((1.0 - cd) * (-t[:, None])))
        fdir = unit(N * (2.0 * vdn)[:, None] - V)
        do_refl = (ks > 0) & (dot(fdir, N) > 0)
        acc = direct
        for want, co, cdir, cior, w in (
                (do_refr, p - N * OFFSET, rdir, ior2,
                 beer * (1.0 - krf)[:, None]),
                (do_refl, p + N * OFFSET, fdir, ior1, cs * krf[:, None])):
            ci = want.nonzero()[:, 0]
            if ci.numel():
                c = trace(sc, co[ci], cdir[ci], cior[ci], level + 1,
                          max_depth, counts)
                add = torch.zeros_like(acc).index_put((ci,), clamp01(c)
                                                      * w[ci])
                acc = acc + add
        out = clamp01(acc)
    return color.index_put((hi,), out)


def trace_rays(sc, o, d, max_depth, counts=None, block=BLOCK):
    """Root colours of primary rays (o, d), traced in blocks."""
    out = []
    for a in range(0, o.shape[0], block):
        b = min(a + block, o.shape[0])
        ior = torch.ones((b - a,), dtype=o.dtype, device=o.device)
        out.append(trace(sc, o[a:b], d[a:b], ior, 0, max_depth, counts))
    return torch.cat(out)


def _tile_order(h, w, s, device, tile=32):
    """Ray order of an (h, w, s) grid in square pixel tiles, a pixel's
    samples together."""
    yy, xx = torch.meshgrid(torch.arange(h, device=device),
                            torch.arange(w, device=device), indexing="ij")
    key = (((yy // tile) * ((w + tile - 1) // tile) + xx // tile)
           * tile * tile + (yy % tile) * tile + xx % tile)
    pix = torch.argsort(key.reshape(-1))
    return (pix[:, None] * s + torch.arange(s, device=device)).reshape(-1)


def render(sc, pixel, max_depth, rows=None, counts=None, block=BLOCK):
    """The (H, W, 3) image of pixel samples ``pixel`` (H, W, S, 2), the mean
    of each pixel's samples; ``rows`` traces only those pixel rows
    (returns (len(rows), W, 3))."""
    H, W, S, _ = pixel.shape
    ys = torch.arange(H, device=pixel.device) if rows is None else rows
    pix = pixel[ys].to(sc.dtype)
    xs = torch.arange(W, device=pixel.device).to(sc.dtype)
    px = (xs[None, :, None] + pix[..., 0]).reshape(-1)
    py = (ys.to(sc.dtype)[:, None, None] + pix[..., 1]).reshape(-1)
    order = _tile_order(len(ys), W, S, pixel.device)
    o, d = sc.primary_rays(px[order], py[order])
    col = torch.empty((order.shape[0], 3), dtype=sc.dtype,
                      device=pixel.device)
    col[order] = trace_rays(sc, o, d, max_depth, counts, block)
    return col.reshape(len(ys), W, S, 3).mean(2)


def render_pixels(sc, pixel, ys, xs, max_depth, counts=None, block=BLOCK):
    """Colours (n, 3) of the pixels (``ys``, ``xs``): the mean of their
    samples ``pixel[ys, xs]`` (n, S, 2)."""
    pix = pixel[ys, xs].to(sc.dtype)
    px = xs.to(sc.dtype)[:, None] + pix[..., 0]
    py = ys.to(sc.dtype)[:, None] + pix[..., 1]
    o, d = sc.primary_rays(px.reshape(-1), py.reshape(-1))
    col = trace_rays(sc, o, d, max_depth, counts, block)
    return col.reshape(len(ys), -1, 3).mean(1)
