"""Inputs shared by the port's tests, with no JAX import, so that the card
tests (``test_torch_cuda.py``) run where JAX is not installed."""

import numpy as np


def random_rays(n, seed=0, spread=3.0):
    """numpy origins, unit directions and times in [0, 1)."""
    rng = np.random.default_rng(seed)
    o = rng.normal(0, spread, (n, 3)).astype(np.float32)
    d = rng.normal(0, 1, (n, 3))
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    t = rng.random(n).astype(np.float32)
    return o, d, t


def prim_scene(builder_cls, ties=False, twice=False):
    """Every primitive type, interleaved in insertion order; glass, metal
    and diffuse materials; one point and one quad light.  ``builder_cls``
    is either package's SceneBuilder, so both build the same scene.

    ``ties``: each sphere and triangle is added a second time, after all
    the others and in another material, so every hit on one is an exact
    tie in t that the lower object id must win (its id and material).
    ``twice``: every object, planes and boxes too, is added a second time
    after all the others, in another material."""
    b = builder_cls()
    b.set_camera([0, 1, 6], [0, 0, 0], [0, 1, 0], 45, 0.01, 16, 12, 0, 1)
    m0 = b.add_material([0.6, 0.6, 0.2], 0.8, [0.2, 0.2, 0.2], 0.0, 10, 0, 1)
    m1 = b.add_material([0.1, 0.9, 0.2], 0.0, [1, 1, 1], 0.5, 30, 1, 1.5)
    m2 = b.add_material([0.9, 0.1, 0.1], 0.9, [1, 1, 1], 0.3, 50, 0, 1)
    spheres = (([-0.8, 0, 0], 0.8, m2), ([0.5, 1.5, -1], 0.6, m1))
    tris = (([0, 0, 0], [1.5, 0, 0], [0, 1.5, 0.5], m1),
            ([-2, -1, -2], [2, -1, -2], [0, 2, -2], m0))
    objs = ((b.add_sphere, spheres[0]),
            (b.add_plane_hessian, ([0, 1, 0], 1.0, m0)),
            (b.add_triangle, tris[0]),
            (b.add_box, ([1, -1, -1], [2, 0.5, 0], m2)),
            (b.add_sphere, spheres[1]),
            (b.add_triangle, tris[1]),
            (b.add_box, ([-2.5, -0.5, 1], [-1.5, 0.5, 2], m1)),
            (b.add_plane_hessian, ([0, 0, 1], 4.0, m2)))
    for add, args in objs:
        add(*args)
    other = {m0: m1, m1: m2, m2: m0}
    if ties:
        for c, r, m in spheres:
            b.add_sphere(c, r, other[m])
        for v0, v1, v2, m in tris:
            b.add_triangle(v0, v1, v2, other[m])
    if twice:
        for add, args in objs:
            add(*args[:-1], other[args[-1]])
    b.add_point_light([2, 4, 2], [1, 1, 1])
    b.add_quad_light([-2, 4, 2], [1, 1, 1], [-1, 4, 2], [-2, 4, 3], 4)
    return b.build()


def tie_scene(builder_cls):
    """Objects of every type whose hits tie exactly in t, listed so that
    the lower object id lies in a later type run (K1's runs go sphere,
    triangle, plane, box): a box (id 0) whose top face, a triangle (id 2)
    and a plane (id 3) all lie in y = 0, and two copies of one sphere (ids
    1 and 4) whose tops touch y = 0.  A ray straight down from y = 5
    (:func:`tie_rays`) meets the box, the triangle and the plane at t = 5
    exactly, so the box must win; one through the sphere's centre meets
    both copies and the plane at t = 5 too (the box at 5 as well where its
    footprint covers it), and under motion blur the spheres rise by the
    ray's time, so the copy with the lower id wins.  Each object has its
    own material."""
    b = builder_cls()
    b.set_camera([0, 6, 6], [0, 0, 0], [0, 1, 0], 45, 0.01, 16, 12, 0, 1)
    mats = [b.add_material([0.2 * k, 0.5, 0.5], 0.8, [0.2, 0.2, 0.2], 0.0,
                           10, 0, 1) for k in range(5)]
    b.add_box([-1, -1, -1], [1, 0, 1], mats[0])
    b.add_sphere([0.5, -1, 0.5], 1.0, mats[1])
    b.add_triangle([-1, 0, -1], [1, 0, -1], [-1, 0, 1], mats[2])
    b.add_plane_hessian([0, 1, 0], 0.0, mats[3])
    b.add_sphere([0.5, -1, 0.5], 1.0, mats[4])
    b.add_point_light([2, 4, 2], [1, 1, 1])
    return b.build()


def tie_rays(n, seed=0):
    """Rays for :func:`tie_scene`: a third straight down from y = 5 on a
    grid of x, z in eighths inside (-1.5, 1.5) (never on a box face), a
    third straight down through the spheres' centre, the rest from
    :func:`random_rays` about the scene; times in [0, 1)."""
    rng = np.random.default_rng(seed)
    o, d, t = random_rays(n, seed)
    k = n // 3
    xz = (rng.integers(-11, 12, (k, 2)) + 0.5) / 8.0
    o[:k] = np.stack([xz[:, 0], np.full(k, 5.0), xz[:, 1]], 1)
    o[k:2 * k] = (0.5, 5.0, 0.5)
    d[:2 * k] = (0.0, -1.0, 0.0)
    return o.astype(np.float32), d.astype(np.float32), t


def crowd_scene(builder_cls, n=1100, seed=5):
    """``n`` small spheres on a plane under one point light: more objects
    than the TPU kernels' 1024-row table holds."""
    rng = np.random.default_rng(seed)
    b = builder_cls()
    b.set_camera([0, 2, 8], [0, 0, 0], [0, 1, 0], 45, 0.01, 16, 12, 0, 1)
    m0 = b.add_material([0.6, 0.6, 0.2], 0.8, [0.2, 0.2, 0.2], 0.0, 10, 0, 1)
    m1 = b.add_material([0.9, 0.1, 0.1], 0.9, [1, 1, 1], 0.3, 50, 0, 1)
    b.add_plane_hessian([0, 1, 0], 1.0, m0)
    for c in rng.uniform([-4, -1, -4], [4, 2, 2], (n - 1, 3)):
        b.add_sphere(list(c), 0.08, m1)
    b.add_point_light([2, 4, 2], [1, 1, 1])
    return b.build()


def _torus_grid(n_quads):
    """(nu, nv) with nu * nv == n_quads, nv the divisor nearest to
    sqrt(n_quads / 2) (the tube's rings, about half the ring count)."""
    divs = [k for k in range(1, int(n_quads ** 0.5) + 1) if n_quads % k == 0]
    nv = min(divs, key=lambda k: abs(k - (n_quads / 2) ** 0.5))
    return n_quads // nv, nv


MESH_GROUND_BOX = ((-8.0, -0.25, -8.0), (8.0, 0.0, 8.0))


def mesh_scene(builder_cls, n_tri=100_000, accel=2, seed=0, res=(512, 512),
               ground="sphere", twice=False):
    """A scanned-mesh stand-in: a closed, displaced torus of exactly
    ``n_tri`` triangles (even) in a reflective material, a glass, a metal
    and two diffuse spheres, a ground, three point lights above the scene
    box; ``spp`` 0, no plane, no motion blur, no depth of field.  ``accel``
    is the P3F code (1 grid, 2 bvh).  ``ground`` is ``"sphere"`` (radius
    1000) or ``"box"`` (``MESH_GROUND_BOX``, same material): the finite
    ground keeps the lights outside the scene box, so the light-frustum
    shadow bins build.  ``twice``: every triangle and sphere is added a
    second time, after all the others and in another material, so every
    hit on one is an exact tie in t.  Built from ``seed`` with either
    package's SceneBuilder, so both build the same scene."""
    if n_tri % 2:
        raise ValueError("mesh_scene tessellates quads: n_tri must be even")
    if ground not in ("sphere", "box"):
        raise ValueError(f"bad ground: {ground!r}")
    rng = np.random.default_rng(seed)
    nu, nv = _torus_grid(n_tri // 2)
    u = np.arange(nu) * (2 * np.pi / nu)
    v = np.arange(nv) * (2 * np.pi / nv)
    U, V = np.meshgrid(u, v, indexing="ij")
    # displacement: a few random low-order waves, so the surface's
    # orientation and triangle density vary as a scan's do
    disp = np.zeros_like(U)
    for a, fu, fv, ph in zip(rng.uniform(0.03, 0.08, 4),
                             rng.integers(2, 7, 4), rng.integers(2, 9, 4),
                             rng.uniform(0, 2 * np.pi, 4)):
        disp += a * np.sin(fu * U + fv * V + ph)
    r = 0.55 * (1.0 + disp)
    R0 = 1.5
    x = (R0 + r * np.cos(V)) * np.cos(U)
    z = (R0 + r * np.cos(V)) * np.sin(U)
    y = r * np.sin(V)
    tilt = 0.45  # about the x axis
    y, z = y * np.cos(tilt) - z * np.sin(tilt), y * np.sin(tilt) + z * np.cos(
        tilt)
    verts = np.stack([x, y + 1.4, z], -1).reshape(-1, 3).astype(np.float32)
    iu, iv = np.meshgrid(np.arange(nu), np.arange(nv), indexing="ij")
    a0 = iu * nv + iv
    a1 = ((iu + 1) % nu) * nv + iv
    a2 = ((iu + 1) % nu) * nv + (iv + 1) % nv
    a3 = iu * nv + (iv + 1) % nv
    faces = np.concatenate([np.stack([a0, a1, a2], -1).reshape(-1, 3),
                            np.stack([a0, a2, a3], -1).reshape(-1, 3)])
    b = builder_cls()
    b.accel = accel
    b.set_camera([0.5, 3.2, 7.5], [0, 1.0, 0], [0, 1, 0], 45, 0.01, res[0],
                 res[1], 0, 1)
    mesh = b.add_material([0.75, 0.6, 0.35], 0.7, [0.9, 0.85, 0.8], 0.35, 40,
                          0, 1)
    glass = b.add_material([0.9, 0.95, 0.9], 0.0, [1, 1, 1], 0.5, 60, 1, 1.5)
    metal = b.add_material([0.1, 0.1, 0.1], 0.1, [0.9, 0.9, 0.95], 0.9, 200,
                           0, 1)
    matte = b.add_material([0.3, 0.4, 0.8], 0.9, [0.2, 0.2, 0.2], 0.0, 10, 0,
                           1)
    gmat = b.add_material([0.5, 0.5, 0.45], 0.9, [0.3, 0.3, 0.3], 0.2, 20,
                          0, 1)
    b.add_triangles_bulk(verts, faces, mesh)
    if ground == "box":
        b.add_box(*(list(c) for c in MESH_GROUND_BOX), gmat)
    else:
        b.add_sphere([0.0, -1000.0, 0.0], 1000.0, gmat)
    spheres = [([-2.6, 0.8, 1.6], 0.8, glass), ([2.6, 0.8, 1.2], 0.8, metal),
               ([0.4, 0.45, 2.9], 0.45, matte),
               ([-1.2, 0.35, -2.8], 0.35, matte)]
    for c, r_, m in spheres:
        b.add_sphere(c, r_, m)
    if twice:
        b.add_triangles_bulk(verts, faces, matte)
        if ground == "sphere":
            spheres.insert(0, ([0.0, -1000.0, 0.0], 1000.0, gmat))
        for c, r_, _ in spheres:
            b.add_sphere(c, r_, mesh)
    for p in ([6, 12, 6], [-7, 10, 3], [1, 14, -8]):
        b.add_point_light(p, [1, 1, 1])
    return b.build()


def stacked_scene(builder_cls, accel, n_stack=150):
    """A few spheres and ``n_stack`` coincident small spheres: the SAH
    build leaves the stack in one fallback leaf of ``n_stack`` objects,
    which the JAX package's packers refuse.  ``accel`` is the P3F code (1
    grid, 2 bvh); either package's SceneBuilder."""
    b = builder_cls()
    b.accel = accel
    b.set_camera([0, 1, 6], [0, 0.5, 0], [0, 1, 0], 45, 0.01, 16, 12, 0, 1)
    m0 = b.add_material([0.6, 0.6, 0.2], 0.8, [0.2, 0.2, 0.2], 0.3, 10, 0, 1)
    m1 = b.add_material([0.1, 0.9, 0.2], 0.0, [1, 1, 1], 0.5, 30, 1, 1.5)
    b.add_sphere([0, -1000, 0], 999.5, m0)
    b.add_sphere([-1.2, 0.5, 0], 0.6, m1)
    b.add_sphere([1.2, 0.5, 0.3], 0.5, m0)
    for _ in range(n_stack):
        b.add_sphere([0.1, 0.6, 0.8], 0.3, m0)
    b.add_point_light([2, 4, 2], [1, 1, 1])
    return b.build()


MESH_BOX = ((-3.0, -0.5, -3.0), (3.0, 3.5, 3.0))  # about mesh_scene's torus


def accel_rays(n, seed=0, box=MESH_BOX):
    """Rays about the box [lo, hi] (the JAX packet tests' ``_rays_for``):
    origins scattered around its centre, unit directions towards targets
    inside it; returns origins, directions, the target distances (shadow
    ``dist``) and a valid mask with every 7th lane dead."""
    rng = np.random.default_rng(seed)
    lo, hi = (np.asarray(b, np.float64) for b in box)
    ctr = (lo + hi) / 2
    o = ctr + rng.standard_normal((n, 3)) * (hi - lo).max() * 1.2
    d = ctr + rng.uniform(-0.5, 0.5, (n, 3)) * (hi - lo) - o
    dist = np.linalg.norm(d, axis=1)
    d = d / dist[:, None]
    valid = np.ones(n, bool)
    valid[::7] = False
    return (o.astype(np.float32), d.astype(np.float32),
            dist.astype(np.float32), valid)


def scattered_shadow_batch(light_pos, n_per_light, seed=0, box=MESH_BOX):
    """Shadow rays towards each light in turn (runs of ``n_per_light``
    lanes) from origins scattered over ``box``: a chain's origins cover
    much of its light's view, so its stream holds thousands of bin
    entries.  numpy origins, unit directions, distances, a valid mask
    (every 5th lane dead) and the lanes' light ids."""
    rng = np.random.default_rng(seed)
    lp = np.asarray(light_pos, np.float64)
    L = lp.shape[0]
    o = rng.uniform(box[0], box[1], (L * n_per_light, 3))
    lid = np.repeat(np.arange(L), n_per_light)
    d = lp[lid] - o
    dist = np.linalg.norm(d, axis=1)
    valid = np.ones(o.shape[0], bool)
    valid[::5] = False
    f = lambda a: np.asarray(a, np.float32)
    return (f(o), f(d / dist[:, None]), f(dist), valid,
            lid.astype(np.int32))


def first_entry_batch(tabs, lbins, light_pos, n_chains, seed=0,
                      box=((-8.0, -3.0, -8.0), (8.0, 3.5, 8.0))):
    """Shadow rays whose every lane is occluded by the first bin entry its
    128-lane chain streams.  Chain c takes light c % L; its lanes share one
    origin, drawn in ``box`` among those whose ray to the light is hit,
    nearer than the light (the plain slot test), by a slot of the first
    entry (the nearest the light) of the tile the origin maps to.  Torch
    tensors on ``tabs``' device: origins, unit directions, distances, a
    valid mask (all live) and light ids."""
    import torch

    from distributionraytracer_tpu_torch.accel import cuda_binned as CBN
    from distributionraytracer_tpu_torch.ops.intersect import hit_packed

    dev = tabs.objs.device
    lb = lbins.to(dev)
    K, ts = lb.k, lb.tile_start.long()
    ints = tabs.objs.view(torch.int32)
    rng = np.random.default_rng(seed)
    cand = torch.as_tensor(rng.uniform(box[0], box[1], (8192, 3)),
                           dtype=torch.float32, device=dev)
    lp = torch.as_tensor(light_pos, dtype=torch.float32, device=dev)
    slot8 = torch.arange(CBN.GROUP, device=dev)
    picks = []
    for li in range(lp.shape[0]):
        n = cand.shape[0]
        lid = torch.full((n, 1), li, dtype=torch.int32, device=dev)
        ones = torch.ones((n, 1), dtype=torch.bool, device=dev)
        _, tx, _, ty, _, _ = CBN._chain_rects(lb, lid, cand[:, None], ones)
        t = (li * K + ty) * K + tx
        lead = ts[t] < ts[t + 1]
        slots = lb.group[ts[t]].long()[:, None] * CBN.GROUP + slot8
        v = lp[li] - cand
        dist = torch.linalg.norm(v, dim=1)
        d = v / dist[:, None]
        rep = lambda x: x.repeat_interleave(CBN.GROUP, 0)
        th, _ = hit_packed(rep(cand), rep(d), torch.zeros(n * CBN.GROUP,
                                                          device=dev),
                           tabs.objs[slots].reshape(-1, 16),
                           ints[slots, 12].reshape(-1), False, (0, 1, 2, 3))
        hit = ((th.reshape(n, CBN.GROUP) < dist[:, None])
               & (ints[slots, 12] >= 0)).any(1)
        picks.append(torch.nonzero(lead & hit)[:, 0])
    per = -(-n_chains // lp.shape[0])
    if min(p.shape[0] for p in picks) < per:
        raise ValueError("too few origins are hit by their tile's first "
                         "entry")
    lid = torch.arange(n_chains, device=dev) % lp.shape[0]
    org = torch.stack([cand[picks[int(li)][int(k)]] for li, k in zip(
        lid, torch.arange(n_chains, device=dev) // lp.shape[0])])
    o = org.repeat_interleave(CBN.LANES, 0)
    lids = lid.repeat_interleave(CBN.LANES).to(torch.int32)
    v = lp[lids.long()] - o
    dist = torch.linalg.norm(v, dim=1)
    return (o, v / dist[:, None], dist,
            torch.ones((o.shape[0],), dtype=torch.bool, device=dev), lids)


def occlusion_inputs(n_objects, n, seed):
    """Shadow rays: origins, directions, max distances, excluded ids."""
    o, d, _ = random_rays(n, seed=seed)
    rng = np.random.default_rng(seed + 100)
    dist = (rng.random(n) * 6).astype(np.float32)
    ex = rng.integers(-1, n_objects, n).astype(np.int32)
    return o, d, dist, ex


def level_inputs(n, seed):
    """One tree level's lanes: rays, times, incoming ior, light samples
    and a valid mask."""
    o, d, t = random_rays(n, seed=seed)
    rng = np.random.default_rng(seed + 50)
    ior = np.where(rng.random(n) < 0.3, 1.5, 1.0).astype(np.float32)
    ls = np.concatenate([rng.random((n, 2)), np.zeros((n, 1))],
                        axis=1).astype(np.float32)
    valid = rng.random(n) < 0.8
    return o, d, t, ior, ls, valid


def synthetic_faces(seed=0, sizes=((8, 6), (5, 7), (6, 6), (4, 3), (7, 5),
                                   (6, 8))):
    """A six-face skybox as ``load_skybox`` returns it: (6, H, W, 3) f32
    faces padded to the largest face, and a (6, 2) i32 (width, height)
    table.  Each face has its own base colour plus per-texel noise, and the
    faces differ in size."""
    rng = np.random.default_rng(seed)
    H = max(h for _, h in sizes)
    W = max(w for w, _ in sizes)
    faces = np.zeros((6, H, W, 3), np.float32)
    res = np.zeros((6, 2), np.int32)
    base = np.eye(3)[[0, 1, 2, 0, 1, 2]] * 0.6 + 0.2 * (np.arange(6)[:, None]
                                                       % 2)
    for i, (w, h) in enumerate(sizes):
        faces[i, :h, :w] = base[i] + 0.2 * rng.random((h, w, 3))
        res[i] = (w, h)
    return faces, res


# Per path-tracer scene: an eye and a box of ray targets around the
# scene's spheres (scenes 1 and 2 share their layout).
# The path-tracer scene leaves that hold primitives (triangles, spheres,
# moving spheres); emptying them leaves materials, lights and sky.
PT_PRIM_LEAVES = ("tri_v0", "tri_e1", "tri_e2", "tri_mat", "sph_center",
                  "sph_radius", "sph_mat", "msph_c0", "msph_c1",
                  "msph_radius", "msph_mat")

PT_VIEWS = {
    0: ([6, 1.6, -6], (-3, 0, -3), (3, 2, 3)),
    1: ([0, 2, -8], (-20, -12, -2), (20, 4, 4)),
    2: ([0, 2, -8], (-20, -12, -2), (20, 4, 4)),
    3: ([0, -3, -4], (-8, -12, 15), (8, 6, 25)),
    4: ([0, -1, -2], (-8, -9, 16), (8, 2, 24)),
}


def pt_tie_leaves(leaves):
    """A path-tracer scene's numpy leaves with every triangle and sphere
    listed a second time, after the originals and in the next material:
    every hit on one is an exact tie in t that the lower index (the
    original, with its material) must win."""
    out = dict(leaves)
    n_mat = leaves["mat_type"].shape[0]
    for pre in ("tri_", "sph_"):
        for k in [k for k in leaves if k.startswith(pre)]:
            v = leaves[k]
            copy = (v + 1) % n_mat if k.endswith("_mat") else v
            out[k] = np.concatenate([v, copy.astype(v.dtype)])
    return out


def pt_own_material_leaves(leaves):
    """A path-tracer scene's numpy leaves with each primitive in a material
    of its own, a copy of its material: a hit's material is then the
    winner's index in the packed table (triangles, spheres, moving
    spheres)."""
    out = dict(leaves)
    old = np.concatenate([leaves[k] for k in ("tri_mat", "sph_mat",
                                              "msph_mat")])
    for k in [k for k in leaves if k.startswith("mat_")]:
        out[k] = leaves[k][old]
    at = 0
    for k in ("tri_mat", "sph_mat", "msph_mat"):
        n = leaves[k].shape[0]
        out[k] = np.arange(at, at + n).astype(leaves[k].dtype)
        at += n
    return out


def pt_crowd_leaves(leaves, n=1000, seed=9):
    """A path-tracer scene's numpy leaves with its spheres copied, jittered
    and shrunk to ``n`` spheres: a primitive table ten times scene 0's."""
    rng = np.random.default_rng(seed)
    out = dict(leaves)
    S = leaves["sph_center"].shape[0]
    pick = rng.integers(0, S, n)
    out["sph_center"] = (leaves["sph_center"][pick] + rng.uniform(
        -2, 2, (n, 3))).astype(leaves["sph_center"].dtype)
    out["sph_radius"] = (leaves["sph_radius"][pick] * 0.3).astype(
        leaves["sph_radius"].dtype)
    out["sph_mat"] = leaves["sph_mat"][pick]
    return out


def pt_rays(n, seed, eye, lo=(-3, 0, -3), hi=(3, 2, 3)):
    """Rays from ``eye`` towards random targets in the box [lo, hi], with
    motion times in [0, 1) (the rays of ``test_pallas_pt``)."""
    rng = np.random.default_rng(seed)
    o = np.tile(np.asarray(eye, np.float32)[None], (n, 1))
    d = rng.uniform(lo, hi, (n, 3)).astype(np.float32) - o
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    return o, d, rng.random(n).astype(np.float32)


# Fused-level outputs that are points in space: the children's origins,
# offset from hit points that reach |x| ~ 1e3 on the infinite planes.
POINT_KEYS = ("refr_o", "refl_o")


def compare_levels(ref, res, valid, atol=2e-4, rtol=1e-5, lane_budget=0.0):
    """Fused-level outputs on valid lanes.  A lane differs where a flag
    differs, a point (``POINT_KEYS``) is off by more than ``rtol`` times
    its magnitude (``max(1, max |x_i|)``), or another float is off by more
    than ``atol``; at most ``lane_budget`` of the lanes may differ.
    ``ref`` holds numpy arrays, ``res`` tensors."""
    v = np.asarray(valid)
    assert set(ref) == set(res)
    bad = np.zeros_like(v)
    for k in sorted(ref):
        a = np.asarray(ref[k])
        b = res[k].detach().cpu().numpy()
        if a.dtype == bool:
            off = a != b
        else:
            lim = (rtol * np.maximum(1.0, np.abs(a).max(-1, keepdims=True))
                   if k in POINT_KEYS else atol)
            off = ~(np.abs(a - b) <= lim)
            off = off if off.ndim == 1 else off.any(-1)
        assert (off & v).mean() <= lane_budget, (k, (off & v).mean())
        bad |= off
    assert (bad & v).mean() <= lane_budget, (bad & v).mean()


def shadow_edge_scene(builder_cls, occluder="sphere"):
    """``test_grad``'s shadow-edge constructions: an overhead camera sees
    only a floor (y = -1) crossed by the shadow edge of a sphere (r 0.4 at
    y = 1, edge at floor x = 0.6) or of a triangle hovering at y = 1 (edge
    at x ~ 0.675) from a point light at (0, 5, 0).  Columns 0..18 of the
    32x32 frame cover floor x in [1.23, 0.48]: the edge, but not the
    occluder itself, so no primary silhouette enters a loss over them."""
    b = builder_cls()
    b.set_camera([0.6, 8.0, 1e-3], [0.6, -1.0, 0.0], [0, 0, 1],
                 8.0, 0.01, 32, 32, 0, 1)
    floor = b.add_material([0.7, 0.7, 0.7], 0.9, [0, 0, 0], 0.0, 10, 0, 1)
    b.add_plane_hessian([0, 1, 0], 1.0, floor)
    occ = b.add_material([0.8, 0.2, 0.2], 0.9, [0, 0, 0], 0.0, 10, 0, 1)
    if occluder == "sphere":
        b.add_sphere([0.0, 1.0, 0.0], 0.4, occ)
    else:
        b.add_triangle([-0.6, 1.0, -2.0], [0.45, 1.0, 0.0],
                       [-0.6, 1.0, 2.0], occ)
    b.add_point_light([0.0, 5.0, 0.0], [1, 1, 1])
    return b.build()


def silhouette_scene(builder_cls):
    """``test_grad``'s sphere-edge construction: a camera looking straight
    at a floating diffuse sphere against the background, the frame
    spanning its silhouette."""
    b = builder_cls()
    b.set_camera([0.0, 0.0, 6.0], [0.0, 0.0, 0.0], [0, 1, 0],
                 20.0, 0.01, 32, 32, 0, 1)
    m = b.add_material([0.8, 0.3, 0.2], 0.9, [0, 0, 0], 0.0, 10, 0, 1)
    b.add_sphere([0.0, 0.0, 0.0], 0.8, m)
    b.add_point_light([3.0, 4.0, 6.0], [1, 1, 1])
    b.bg_color = np.array([0.1, 0.1, 0.6], np.float32)
    return b.build()


def one_kind_scene(builder_cls, kind):
    """A scene whose ray tree spawns one child kind: ``"refl"`` (metal and
    shiny diffuse, no T == 1 material) or ``"refr"`` (glass with ks = 0
    and matte walls); a point and a quad light.  ``builder_cls`` is either
    package's SceneBuilder."""
    b = builder_cls()
    b.set_camera([0, 1.5, 6], [0, 0.5, 0], [0, 1, 0], 45, 0.01, 16, 12, 0, 1)
    if kind == "refl":
        ground = b.add_material([0.7, 0.7, 0.6], 0.8, [0.5, 0.5, 0.5], 0.3,
                                20, 0, 1)
        a = b.add_material([0.9, 0.4, 0.1], 0.2, [0.9, 0.9, 0.9], 0.9, 80,
                           0, 1)
        c = b.add_material([0.2, 0.3, 0.9], 0.6, [1, 1, 1], 0.4, 40, 0.5, 1)
    else:
        ground = b.add_material([0.7, 0.7, 0.6], 0.9, [0, 0, 0], 0.0, 10, 0,
                                1)
        a = b.add_material([0.9, 0.95, 0.9], 0.1, [1, 1, 1], 0.0, 60, 1,
                           1.5)
        c = b.add_material([0.6, 0.9, 0.7], 0.2, [1, 1, 1], 0.0, 30, 1,
                           1.33)
    b.add_plane_hessian([0, 1, 0], 1.0, ground)
    b.add_sphere([-0.9, 0, 0], 0.9, a)
    b.add_sphere([0.9, 0.2, -0.5], 0.7, c)
    b.add_sphere([0.2, -0.4, 1.2], 0.5, a)
    b.add_box([1.5, -1, 0.5], [2.3, 0.2, 1.3], c)
    b.add_point_light([2, 4, 3], [1, 1, 1])
    b.add_quad_light([-2, 4, 2], [1, 1, 1], [-1, 4, 2], [-2, 4, 3], 4)
    return b.build()


def with_skybox(scene):
    """A port scene with ``synthetic_faces(4)`` as its skybox."""
    import dataclasses

    import torch

    faces, res = synthetic_faces(4)
    return dataclasses.replace(
        scene, sky_faces=torch.from_numpy(faces),
        sky_res=torch.from_numpy(res),
        static=dataclasses.replace(scene.static, has_skybox=True))
