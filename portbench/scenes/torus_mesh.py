"""A scanned-mesh stand-in with the shape of the upstream renderer's
``dragon_assignment1.p3f`` (a 100k-triangle mesh under a BVH, 512x512,
spp 0, depth 4): a closed, displaced torus of ``cfg["n_triangles"]``
triangles in a reflective material, a glass, a metal and two diffuse
spheres, a radius-1000 ground sphere and three point lights above the
scene.  The asset and its skybox are not in the repository, so the mesh is
generated from ``cfg["scene_seed"]`` and misses take the background colour.
A frozen copy of the test scene the program's tests use."""

from __future__ import annotations

import numpy as np


def _torus_grid(n_quads):
    """(nu, nv) with nu * nv == n_quads, nv the divisor nearest to
    sqrt(n_quads / 2)."""
    divs = [k for k in range(1, int(n_quads ** 0.5) + 1) if n_quads % k == 0]
    nv = min(divs, key=lambda k: abs(k - (n_quads / 2) ** 0.5))
    return n_quads // nv, nv


def build(b, cfg):
    n_tri = cfg["n_triangles"]
    if n_tri % 2:
        raise ValueError("the torus tessellates quads: n_triangles is even")
    rng = np.random.default_rng(cfg["scene_seed"])
    nu, nv = _torus_grid(n_tri // 2)
    u = np.arange(nu) * (2 * np.pi / nu)
    v = np.arange(nv) * (2 * np.pi / nv)
    U, V = np.meshgrid(u, v, indexing="ij")
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
    b.accel = 2
    b.spp = 0
    b.set_camera([0.5, 3.2, 7.5], [0, 1.0, 0], [0, 1, 0], 45, 0.01,
                 cfg["res_x"], cfg["res_y"], 0, 1)
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
    b.add_sphere([0.0, -1000.0, 0.0], 1000.0, gmat)
    for c, r_, m in (([-2.6, 0.8, 1.6], 0.8, glass),
                     ([2.6, 0.8, 1.2], 0.8, metal),
                     ([0.4, 0.45, 2.9], 0.45, matte),
                     ([-1.2, 0.35, -2.8], 0.35, matte)):
        b.add_sphere(c, r_, m)
    for p in ([6, 12, 6], [-7, 10, 3], [1, 14, -8]):
        b.add_point_light(p, [1, 1, 1])
