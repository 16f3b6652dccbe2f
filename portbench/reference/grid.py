"""The reference Whitted ray tree under the upstream's uniform grid
(grid.cpp:100-358 of the upstream renderer) in plain PyTorch, in the
scene's floating type: the tree, shading and children of
``reference.whitted`` (main.cpp:294-521), with the grid's own queries.

The grid's observable semantics, written from grid.cpp:

- the grid box is the union of the objects' boxes (a sphere's c +- r, a
  triangle's vertices' extent padded by EPSILON, scene.cpp:14-35 and
  201-206) padded by EPSILON on every side (grid.cpp:30-60), in float32;
- ``Init_Traverse``'s slab test (grid.cpp:124-152): with ``a = 1 / d``
  per axis, a ray's entry ``t0`` is the largest of the slabs' near
  distances and its exit ``t1`` the least of their far ones; the test
  fails where ``t0 > t1`` or ``t1 < 0``;
- closest hit (grid.cpp:247-304): a ray whose slab test fails misses;
  the cells are visited in increasing t and the walk stops at the first
  cell whose exit lies past the record, so the record is the nearest hit
  of the objects the ray's cells hold, kept only while ``t < t1``
  (walking out of the grid drops it).  Every hit of a sphere or a
  triangle lies in a cell the ray crosses, so the nearest hit of all
  objects is the same record;
- shadow (grid.cpp:309-358): a ray whose slab test fails counts as
  shadowed (grid.cpp:321-324); otherwise it is occluded where an object
  has a hit ``t < dist``, strict, with no object skipped.  ``dist`` is the
  length of the shadow ray's direction, which main.cpp:411-420 normalises
  before the grid sees it (the dangling ``else``): the grid compares each
  occluder against 1, not against the light's distance.

Dot products are summed in the upstream's order, (x + y) + z
(``Vector::operator*``), written out: a ``sum`` over the last axis of a
CUDA tensor adds in another order, and on the flake, whose reflection
rays leave tangent spheres 1e-4 from their surface, the last bit of a
dot product decides which sphere some rays meet (on an H100 a ``sum``
in the tests and shading moved 4% of a band's pixels by more than
0.02).  A hit's lights are added in order for the same reason.  The
camera rays are the reference scene's own (``RefScene.primary_rays``,
as every Whitted cell's): their directions are normalised by that
``sum``, as the program's camera normalises them on either device, and
the same last bit there moves 0.3-0.6% of a flake frame's pixels.

A tie in t goes to the lower object id.  Spheres are tested in culled
pairs: each run of CLUSTER spheres in Morton order of their centres gets a
bounding sphere, padded outward, and a ray is tested against the spheres
of the runs whose bounding sphere it meets in front of its origin (and,
for a shadow ray, nearer than its distance).  A sphere a ray hits lies in
its run's bounding sphere, so the cull drops no sphere a ray can hit.
The two triangles of a ground are tested by brute force.

``counts`` (a dict) collects, per tree level, the rays traced and the
shadow rays (``portbench.roofline.accel_bytes_s``).
"""

from __future__ import annotations

import torch

from portbench.reference import whitted as W

EPSILON = W.EPSILON  # the grid box's pad, and the hit tests' near limit
OFFSET = W.OFFSET
CLUSTER = 32  # spheres a culling sphere covers
RAY_BLOCK = 1 << 14  # rays a cull tests against every culling sphere
PAIRS = 1 << 22  # (ray, sphere) pairs tested at once
BLOCK = 1 << 17  # primary rays whose trees are traced together
PAD = 1e-4  # the culling spheres' outward pad, beyond 0.1% of the radius


def dot(a, b):
    """``a . b`` over the last axis, summed (x + y) + z on every device."""
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]) \
        + a[..., 2] * b[..., 2]


def unit(x):
    """``x / |x|``; a zero vector stays zero."""
    n2 = dot(x, x)
    ok = n2 > 1e-30
    return torch.where(ok[..., None],
                       x / torch.sqrt(torch.where(ok, n2, 1.0))[..., None],
                       0.0)


# ---------------------------------------------------------------- the grid
def grid_box(sc):
    """(lo, hi) float32 of the grid: the union of the objects' boxes
    padded by EPSILON (cached on the scene)."""
    if getattr(sc, "_gbox", None) is None:
        f = lambda x: x.float()
        lows, highs = [], []
        if sc.sph_c.shape[0]:
            c, r = f(sc.sph_c), f(sc.sph_r)[:, None]
            lows.append(c - r)
            highs.append(c + r)
        if sc.tri_v0.shape[0]:
            v0 = f(sc.tri_v0)
            vs = torch.cat([v0, v0 + f(sc.tri_e1), v0 + f(sc.tri_e2)])
            lows.append(vs - EPSILON)
            highs.append(vs + EPSILON)
        lo = torch.cat(lows).amin(0) - EPSILON
        hi = torch.cat(highs).amax(0) + EPSILON
        sc._gbox = (lo, hi)
    return sc._gbox


def slab(sc, o, d):
    """(slab test passed (R,), exit distance t1 (R,)) of rays (o, d)
    against the grid box, in float32 (grid.cpp:124-152)."""
    lo, hi = grid_box(sc)
    o, d = o.float(), d.float()
    a = 1.0 / d  # +-inf on a zero component, as in C++
    near = torch.where(a >= 0, (lo - o) * a, (hi - o) * a)
    far = torch.where(a >= 0, (hi - o) * a, (lo - o) * a)
    t0, t1 = near.amax(-1), far.amin(-1)
    return ~((t0 > t1) | (t1 < 0)), t1


# ----------------------------------------------------------- sphere pairs
def _clusters(sc):
    """(sphere rows in runs of CLUSTER, padded by repeating the last; the
    runs' bounding spheres' centres and radii), cached on the scene."""
    if getattr(sc, "_sclu", None) is None:
        c, r = sc.sph_c.float(), sc.sph_r.float()
        order = torch.argsort(W._morton(c))
        n = order.shape[0]
        k = (n + CLUSTER - 1) // CLUSTER
        pad = torch.cat([order, order[-1:].expand(k * CLUSTER - n)])
        cs, rs = c[pad].reshape(k, CLUSTER, 3), r[pad].reshape(k, CLUSTER)
        lo = (cs - rs[..., None]).amin(1)
        hi = (cs + rs[..., None]).amax(1)
        centre = (lo + hi) / 2
        rad = (torch.sqrt(((cs - centre[:, None]) ** 2).sum(-1))
               + rs).amax(1)
        sc._sclu = (pad, centre, rad * 1.001 + PAD)
    return sc._sclu


def _sphere_pairs(sc, o, d, dist=None):
    """Chunks (ray rows, sphere rows) of the pairs the cull keeps: each
    ray with every sphere of the runs whose bounding sphere it meets in
    front of its origin (and nearer than ``dist``, where given)."""
    pad, centre, rad = _clusters(sc)
    arange = torch.arange(CLUSTER, device=o.device)
    for a in range(0, o.shape[0], RAY_BLOCK):
        b = min(a + RAY_BLOCK, o.shape[0])
        df = d[a:b].float()
        oc = o[a:b].float()[:, None, :] - centre[None]
        qa = dot(df, df)[:, None]
        qb = dot(oc, df[:, None, :])
        disc = qb * qb - qa * (dot(oc, oc) - (rad * rad)[None])
        sq = W.safe_sqrt(disc)
        keep = (disc >= 0) & ((-qb + sq) / qa > 0)
        if dist is not None:
            keep &= (-qb - sq) / qa < dist[a:b, None].float()
        ray, run = keep.nonzero(as_tuple=True)
        step = max(PAIRS // CLUSTER, 1)
        for c0 in range(0, ray.shape[0], step):
            rr, kk = ray[c0:c0 + step], run[c0:c0 + step]
            yield ((a + rr)[:, None].expand(-1, CLUSTER).reshape(-1),
                   pad[(kk[:, None] * CLUSTER + arange).reshape(-1)])


def pair_t(o, d, c, r):
    """t (P,) of each ray (o, d) (P, 3) against its sphere (c, r) (P, 3),
    (P,), inf for a miss: ``reference.whitted.sphere_t`` pair by pair."""
    oc = o - c
    a = dot(d, d)
    b = 2.0 * dot(oc, d)
    cq = dot(oc, oc) - r * r
    disc = b * b - 4.0 * a * cq
    sq = W.safe_sqrt(disc)
    t1 = (-b - sq) / (2.0 * a)
    t2 = (-b + sq) / (2.0 * a)
    t = torch.where(t1 > EPSILON, t1, t2)
    return torch.where((disc >= 0) & (t > EPSILON), t, float("inf"))


def _sphere_min(sc, o, d):
    """(t, sphere row) of each ray's nearest sphere (inf on a miss), the
    lower row (object id) on a tie."""
    # a pair's key: t's float32 bits (t > 0 orders as its bits do), then
    # the sphere's row
    big = torch.iinfo(torch.int64).max
    key = torch.full((o.shape[0],), big, dtype=torch.int64, device=o.device)
    for ray, s in _sphere_pairs(sc, o, d):
        t = pair_t(o[ray], d[ray], sc.sph_c[s], sc.sph_r[s])
        bits = t.float().view(torch.int32).to(torch.int64)
        key.scatter_reduce_(0, ray, (bits << 32) | s, "amin")
    t = (key >> 32).to(torch.int32).view(torch.float32).to(o.dtype)
    miss = key == big
    return (torch.where(miss, float("inf"), t),
            torch.where(miss, 0, key & 0xFFFFFFFF))


# ------------------------------------------------------------ hit queries
def closest(sc, o, d):
    """(hit, t, unit normal, object id, material) of each ray's record
    under the grid: the nearest hit, dropped where the slab test fails or
    the hit lies past the grid's exit."""
    R = o.shape[0]
    t = torch.full((R,), float("inf"), dtype=o.dtype, device=o.device)
    gid = torch.full((R,), -1, dtype=torch.int64, device=o.device)
    normal = torch.zeros_like(o)
    mat = torch.zeros((R,), dtype=torch.int64, device=o.device)
    if sc.sph_c.shape[0]:
        ts, j = _sphere_min(sc, o, d)
        hs = torch.isfinite(ts)
        t = torch.where(hs, ts, t)
        gid = torch.where(hs, sc.sph_gid[j], gid)
        p = o + d * torch.where(hs, ts, 1.0)[:, None] - sc.sph_c[j]
        normal = torch.where(hs[:, None], unit(p), normal)
        mat = torch.where(hs, sc.sph_mat[j], mat)
    if sc.tri_v0.shape[0]:
        tm = W.triangle_t(o, d, sc.tri_v0, sc.tri_e1, sc.tri_e2)
        tt, j = tm.min(1)  # the first of equal minima: the lower id
        tg = sc.tri_gid[j]
        better = (tt < t) | ((tt == t) & torch.isfinite(tt) & (tg < gid))
        t = torch.where(better, tt, t)
        gid = torch.where(better, tg, gid)
        nt = unit(torch.linalg.cross(sc.tri_e1[j], sc.tri_e2[j]))
        normal = torch.where(better[:, None], nt, normal)
        mat = torch.where(better, sc.tri_mat[j], mat)
    ok, t1 = slab(sc, o, d)
    hit = torch.isfinite(t) & ok & (t.float() < t1)
    return hit, t, normal, gid, mat


def occluded(sc, o, d, dist):
    """Whether each shadow ray is shadowed under the grid: its slab test
    fails, or an object has a hit ``t < dist``."""
    occ = ~slab(sc, o, d)[0]
    if sc.sph_c.shape[0]:
        for ray, s in _sphere_pairs(sc, o, d, dist):
            t = pair_t(o[ray], d[ray], sc.sph_c[s], sc.sph_r[s])
            occ[ray[t < dist[ray]]] = True
    if sc.tri_v0.shape[0]:
        tm = W.triangle_t(o, d, sc.tri_v0, sc.tri_e1, sc.tri_e2)
        occ |= (tm < dist[:, None]).any(1)
    return occ


# ---------------------------------------------------------------- the tree
def _level(counts, level):
    if counts is None:
        return None
    return counts.setdefault(level, dict(rays=0, shadow_rays=0))


def trace(sc, o, d, ior, level, max_depth, counts=None, dark=None):
    """Colour (R, 3) of the ray tree rooted at rays (o, d) in a medium of
    index ``ior``, at tree level ``level``.  ``dark`` (a light's index)
    drops that light's shadow rays, lit everywhere: a fault the
    benchmark's control reads."""
    cnt = _level(counts, level)
    if cnt is not None:
        cnt["rays"] += o.shape[0]
    hit, t, nrm, gid, mat = closest(sc, o, d)
    color = W.clamp01(sc.bg).expand(o.shape[0], 3)
    hi = hit.nonzero()[:, 0]
    if hi.numel() == 0:
        return color
    o, d, t, nrm, m, ior1 = (x[hi] for x in (o, d, t, nrm, mat, ior))
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
    # the grid sees the normalised direction: every distance is 1
    dist = torch.ones((n * nl,), dtype=p.dtype, device=p.device)
    if cnt is not None:
        cnt["shadow_rays"] += n * nl
    with torch.no_grad():
        occ = occluded(sc, sorg, L.reshape(-1, 3), dist).reshape(n, nl)
    if dark is not None:
        occ[:, dark] = False
    lit = torch.where(occ[..., None], 0.0, contrib)
    direct = lit[:, 0]
    for j in range(1, nl):  # the lights in order, as the upstream adds them
        direct = direct + lit[:, j]
    if level >= max_depth:
        out = direct
    else:
        ior2 = torch.where(outside, mior, 1.0)
        eta = ior1 / ior2
        vdn = dot(V, N)
        vt = N * vdn[:, None] - V
        sin_i = W.safe_sqrt(dot(vt, vt))
        th = vt / torch.where(sin_i > 0, sin_i, 1.0)[:, None]
        sin_t = eta * sin_i
        no_tir = sin_t < 1.0
        cos_t = W.safe_sqrt(1.0 - sin_t * sin_t)
        rdir = unit(torch.where((sin_i > 0)[:, None],
                                  th * sin_t[:, None] - N * cos_t[:, None],
                                  -N))
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
                          max_depth, counts, dark)
                add = torch.zeros_like(acc).index_put((ci,), W.clamp01(c)
                                                      * w[ci])
                acc = acc + add
        out = W.clamp01(acc)
    return color.index_put((hi,), out)


def trace_rays(sc, o, d, max_depth, counts=None, dark=None):
    """Root colours of primary rays (o, d), traced in blocks."""
    out = []
    for a in range(0, o.shape[0], BLOCK):
        b = min(a + BLOCK, o.shape[0])
        ior = torch.ones((b - a,), dtype=o.dtype, device=o.device)
        out.append(trace(sc, o[a:b], d[a:b], ior, 0, max_depth, counts,
                         dark))
    return torch.cat(out)


def render(sc, pixel, max_depth, counts=None, dark=None):
    """The (H, W, 3) image of pixel samples ``pixel`` (H, W, S, 2), the mean
    of each pixel's samples."""
    H, W_, S, _ = pixel.shape
    pix = pixel.to(sc.dtype)
    xs = torch.arange(W_, device=pixel.device).to(sc.dtype)
    ys = torch.arange(H, device=pixel.device).to(sc.dtype)
    px = (xs[None, :, None] + pix[..., 0]).reshape(-1)
    py = (ys[:, None, None] + pix[..., 1]).reshape(-1)
    order = W._tile_order(H, W_, S, pixel.device)
    o, d = sc.primary_rays(px[order], py[order])
    col = torch.empty((order.shape[0], 3), dtype=sc.dtype,
                      device=pixel.device)
    col[order] = trace_rays(sc, o, d, max_depth, counts, dark)
    return col.reshape(H, W_, S, 3).mean(2)


def render_pixels(sc, pixel, ys, xs, max_depth, counts=None, dark=None):
    """Colours (n, 3) of the pixels (``ys``, ``xs``): the mean of their
    samples ``pixel[ys, xs]`` (n, S, 2)."""
    pix = pixel[ys, xs].to(sc.dtype)
    px = xs.to(sc.dtype)[:, None] + pix[..., 0]
    py = ys.to(sc.dtype)[:, None] + pix[..., 1]
    o, d = sc.primary_rays(px.reshape(-1), py.reshape(-1))
    col = trace_rays(sc, o, d, max_depth, counts, dark)
    return col.reshape(len(ys), -1, 3).mean(1)
