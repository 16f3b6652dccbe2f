"""Scene 0 of the upstream's WebGL path tracer, Shirley's "Weekend" scene
with moving spheres (P3D_RT.glsl:21-123): a ground quad, four big spheres
(a diffuse one, a metal one, a hollow glass sphere whose inner radius is
negative, a tinted glass one), a 10 x 10 field of small spheres placed and
coloured by the shader's hash chain (common.glsl:55-78), of which those
whose draw is under 0.3 move upwards over the frame's time, and three
white point lights under a gradient sky.

A small sphere's rise is ``hash1(gSeed)`` in the shader, a per-fragment
state no table can hold: it is one fixed draw of
``numpy.random.default_rng(MOTION_SEED)`` per moving sphere, in the order
the field is walked.  The hash values are taken in double precision and
rounded to float32 where the tables store them (a float32 quotient in
the shader can differ in the last bit).

``build(b, cfg)`` drives a builder ``b`` with ``diffuse(albedo)``,
``metal(spec, rough)``, ``glass(refract, refidx, rough)`` (each returns a
material id), ``quad(a, b, c, d, m)``, ``sphere(centre, radius, m)``,
``moving_sphere(c0, c1, radius, m)`` and ``point_light(pos, colour)``.
The program takes its own ``scene0()``; the reference records these calls
(``reference.pt_scene``).  A frozen copy: later changes to the program's
scene do not move the benchmark's.
"""

from __future__ import annotations

import numpy as np

MOTION_SEED = 0


def base_hash(x, y):
    """baseHash(uvec2(x, y)) (common.glsl:55-60) on 32-bit words."""
    m = 0xFFFFFFFF
    qx = (1103515245 * ((x >> 1) ^ y)) & m
    qy = (1103515245 * ((y >> 1) ^ x)) & m
    h = (1103515245 * (qx ^ (qy >> 3))) & m
    return h ^ (h >> 16)


class Seed:
    """The shader's ``inout float seed``: each hash reads the words of
    ``seed += 0.1`` twice, in float32."""

    def __init__(self, seed):
        self.s = np.float32(seed)

    def _word(self):
        self.s = np.float32(self.s + np.float32(0.1))
        return int(np.array(self.s, np.float32).view(np.uint32))

    def _hash(self):
        x = self._word()
        return base_hash(x, self._word())

    def hash1(self):
        """hash1 (common.glsl:62-66): a float in [0, 1]."""
        return self._hash() / 0xFFFFFFFF

    def hash3(self):
        """hash3 (common.glsl:72-78): three floats in [0, 1]."""
        n = self._hash()
        words = [n, (n * 16807) & 0xFFFFFFFF, (n * 48271) & 0xFFFFFFFF]
        return np.array([w & 0x7FFFFFFF for w in words],
                        np.float64) / 0x7FFFFFFF


def build(b, cfg):
    b.quad((-10, -0.05, 10), (10, -0.05, 10), (10, -0.05, -10),
           (-10, -0.05, -10), b.diffuse((0.2, 0.2, 0.2)))
    b.sphere((-4, 1, 0), 1.0, b.diffuse((0.2, 0.95, 0.1)))
    b.sphere((4, 1, 0), 1.0, b.metal((0.562, 0.565, 0.578), 0.4))
    b.sphere((-1.5, 1, 0), 1.0, b.glass((0, 0, 0), 1.33, 0.0))
    b.sphere((-1.5, 1, 0), -0.5, b.glass((0, 0, 0), 1.33, 0.0))
    b.sphere((1.5, 1, 0), 1.0, b.glass((0, 0.9, 0.9), 1.5, 0.0))
    rise = np.random.default_rng(MOTION_SEED)
    for x in range(-5, 5):
        for y in range(-5, 5):
            seed = Seed(np.float32(x) + np.float32(y) / np.float32(1000.0))
            r = seed.hash3()
            centre = np.array([x + 0.9 * r[0], 0.2, y + 0.9 * r[1]],
                              np.float32)
            if np.linalg.norm(centre - np.array([4.0, 0.2, 0.0])) <= 0.9:
                continue
            if r[2] < 0.3:
                top = centre + np.array([0.0, rise.random() * 0.5, 0.0],
                                        np.float32)
                b.moving_sphere(centre, top, 0.2,
                                b.diffuse(seed.hash3() * seed.hash3()))
            elif r[2] < 0.5:
                b.sphere(centre, 0.2, b.diffuse(seed.hash3() * seed.hash3()))
            elif r[2] < 0.7:
                b.sphere(centre, 0.2, b.metal((seed.hash3() + 1.0) * 0.5,
                                              0.0))
            elif r[2] < 0.9:
                spec = (seed.hash3() + 1.0) * 0.5
                b.sphere(centre, 0.2, b.metal(spec, seed.hash1()))
            else:
                b.sphere(centre, 0.2, b.glass(seed.hash3(), 1.33, 0.0))
    for pos in ((-10, 15, 0), (8, 15, 3), (1, 15, -9)):
        b.point_light(pos, (1, 1, 1))
