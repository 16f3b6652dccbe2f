"""Eric Haines' sphereflake, the Standard Procedural Databases' "balls"
scene (``balls.c``), as the upstream renderer's ``balls_high.p3f`` holds
it at size factor 4: 1 + 9 + 81 + 729 + 6,561 = 7,381 reflective spheres
on a ground square of 2 triangles, three white point lights and SPD's
camera, under the uniform grid.

A sphere of radius r at c has nine children of radius r / 3, each at
c + (r + r / 3) * dir: three above it, 54.7 degrees off its axis, and six
around its equator, so that none points back toward its own parent.  The
nine directions are SPD's ``objset`` (three trios, each turned 120
degrees about +z) turned from +z onto the parent's axis; the root's axis
is +z.  Values are rounded to the six significant digits SPD prints
(``%g``): the first child reads ``s 0.272166 0.272166 0.544331
0.166667``.

SPD's scene is z-up.  The whole scene, camera included, is turned by (x,
y, z) -> (x, z, -y), so that the benchmark's orbit about +y circles the
flake above its ground; the turn changes no work.  The asset's skybox is
not in the repository: misses take SPD's background colour.  A frozen
copy: nothing of the program builds it.
"""

from __future__ import annotations

import math

import numpy as np

ACCEL_GRID = 1
RADIUS = 0.5  # the root's
FLOOR = 12.0  # the ground square's half width, at z = -RADIUS
SPHERE_MAT = ((1.0, 0.9, 0.7), 0.5, 0.5, 3.0827)  # cd, Kd, Ks, shine
FLOOR_MAT = ((1.0, 0.75, 0.33), 0.8, 0.0, 0.0)
LIGHTS = ((4.0, 3.0, 2.0), (1.0, -4.0, 4.0), (-3.0, 1.0, 5.0))
BACKGROUND = (0.078, 0.361, 0.753)
CAMERA = dict(eye=(2.1, 1.3, 1.7), at=(0.0, 0.0, 0.0), up=(0.0, 0.0, 1.0),
              fovy=45.0, hither=0.01)


def _rotation(axis, angle):
    """The matrix that turns a column vector by ``angle`` about the unit
    ``axis`` (right-handed)."""
    x, y, z = axis
    c, s = math.cos(angle), math.sin(angle)
    k = np.array([[0.0, -z, y], [z, 0.0, -x], [-y, x, 0.0]])
    return c * np.eye(3) + s * k + (1.0 - c) * np.outer(axis, axis)


def objset():
    """(9, 3) unit directions of a +z parent's children, in SPD's order."""
    d = 1.0 / math.sqrt(2.0)
    trio = np.array([[d, d, 0.0], [d, 0.0, -d], [0.0, d, -d]])
    tilt = _rotation(np.array([1.0, -1.0, 0.0]) * d,
                     math.asin(2.0 / math.sqrt(6.0)))
    trio = trio @ tilt.T
    out = [trio @ _rotation(np.array([0.0, 0.0, 1.0]),
                            k * 2.0 * math.pi / 3.0).T for k in range(3)]
    return np.concatenate(out)


def _onto(direction):
    """The rotation taking +z onto the unit ``direction``."""
    z = direction[2]
    if z >= 1.0:
        return np.eye(3)
    if z <= -1.0:
        return _rotation(np.array([0.0, 1.0, 0.0]), math.pi)
    axis = np.cross([0.0, 0.0, 1.0], direction)
    return _rotation(axis / np.linalg.norm(axis), math.acos(z))


def spheres(size):
    """(n, 4) rows (x, y, z, radius) of the flake of ``size`` levels below
    the root, in SPD's order (a sphere, then each child's whole flake), in
    double precision before rounding, z-up."""
    dirs = objset()
    out = []

    def emit(centre, radius, direction, depth):
        out.append((*centre, radius))
        if depth == 0:
            return
        rot = _onto(direction)
        scale = radius * (1.0 + 1.0 / 3.0)
        for v in dirs:
            child_dir = rot @ v
            emit(centre + scale * child_dir, radius / 3.0, child_dir,
                 depth - 1)

    emit(np.zeros(3), RADIUS, np.array([0.0, 0.0, 1.0]), size)
    return np.array(out)


def spd(x):
    """``x`` rounded as SPD's ``%g`` prints it."""
    return np.vectorize(lambda v: float(f"{v:g}"))(np.asarray(x, float))


def y_up(p):
    """(x, y, z) -> (x, z, -y) of points or vectors (..., 3)."""
    p = np.asarray(p, float)
    return np.stack([p[..., 0], p[..., 2], -p[..., 1]], -1)


def build(b, cfg):
    b.accel = ACCEL_GRID
    b.spp = cfg["spp"]
    b.bg_color = np.array(BACKGROUND, np.float32)
    b.set_camera(eye=y_up(CAMERA["eye"]), at=y_up(CAMERA["at"]),
                 up=y_up(CAMERA["up"]), fovy=CAMERA["fovy"],
                 hither=CAMERA["hither"], res_x=cfg["res_x"],
                 res_y=cfg["res_y"], aperture_ratio=0.0, focal_ratio=1.0)
    for p in LIGHTS:
        b.add_point_light(y_up(p), [1, 1, 1])
    cd, kd, ks, shine = FLOOR_MAT
    floor = b.add_material(cd, kd, cd, ks, shine, 0, 1)
    f, z = FLOOR, -RADIUS
    verts = y_up([[f, f, z], [-f, f, z], [-f, -f, z], [f, -f, z]])
    b.add_triangles_bulk(verts.astype(np.float32),
                         np.array([[0, 1, 2], [0, 2, 3]]), floor)
    cd, kd, ks, shine = SPHERE_MAT
    ball = b.add_material(cd, kd, cd, ks, shine, 0, 1)
    rows = spd(spheres(cfg["size_factor"]))
    for c, r in zip(y_up(rows[:, :3]), rows[:, 3]):
        b.add_sphere(c.astype(np.float32), float(r), ball)
