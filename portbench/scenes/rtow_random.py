"""The "Ray Tracing in One Weekend" final scene (Scene::create_random_scene,
scene.cpp:742-815 of the upstream renderer): a ground sphere, a 10x10 field
of random diffuse, metal and glass spheres, three big spheres, three white
point lights and a fixed camera.  The upstream seeds ``rand()`` with the
wall clock; here ``cfg["scene_seed"]`` seeds NumPy, so the instance is
fixed.  A frozen copy: later changes to the program's own generator do not
move the benchmark's scene."""

from __future__ import annotations

import numpy as np


def build(b, cfg):
    rng = np.random.default_rng(cfg["scene_seed"])
    b.accel = 0
    b.spp = 0
    b.bg_color = np.array([0.5, 0.7, 1.0], np.float32)
    b.set_camera(eye=[-5.312192, 4.456562, 11.963158], at=[0, 0, 0],
                 up=[0, 1, 0], fovy=40.0, hither=0.01, res_x=cfg["res_x"],
                 res_y=cfg["res_y"], aperture_ratio=0.0, focal_ratio=1.5)
    for p in ([7, 10, -5], [-7, 10, -5], [0, 10, 7]):
        b.add_point_light(p, [1, 1, 1])
    ground = b.add_material([0.5, 0.5, 0.5], 1.0, [0, 0, 0], 0.0, 10, 0, 1)
    b.add_sphere([0.0, -1000.0, 0.0], 1000.0, ground)
    for a in range(-5, 5):
        for c in range(-5, 5):
            choose = rng.random()
            center = np.array(
                [a + 0.9 * rng.random(), 0.2, c + 0.9 * rng.random()],
                np.float32)
            if np.linalg.norm(center - np.array([4.0, 0.2, 0.0])) <= 0.9:
                continue
            if choose < 0.4:  # diffuse
                m = b.add_material(rng.random(3), 1.0, [0, 0, 0], 0.0, 10, 0,
                                   1)
            elif choose < 0.7:  # metal
                m = b.add_material([0, 0, 0], 0.0, rng.uniform(0.5, 1, 3),
                                   1.0, 220, 0, 1)
            else:  # glass
                m = b.add_material(rng.uniform(0.6, 1, 3), 0.0, [1, 1, 1],
                                   0.7, 20, 1, 1.5)
            b.add_sphere(center, 0.2, m)
    m = b.add_material([1, 1, 1], 0.0, [1, 1, 1], 0.7, 20, 1, 1.5)
    b.add_sphere([0, 1, 0], 1.0, m)
    m = b.add_material([0.4, 0.2, 0.1], 0.9, [1, 1, 1], 0.0, 10, 0, 1.0)
    b.add_sphere([-4, 1, 0], 1.0, m)
    m = b.add_material([0.4, 0.2, 0.1], 0.0, [0.7, 0.6, 0.5], 1.0, 220, 0, 1.0)
    b.add_sphere([4, 1, 0], 1.0, m)
