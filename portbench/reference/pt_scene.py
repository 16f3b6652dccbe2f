"""The tables of a path-tracer scene (the GLSL path tracer's scene 0,
P3D_RT.glsl:21-123), recorded from its frozen generator's calls
(``portbench/scenes/<generator>.py``) in plain NumPy and PyTorch.

Leaves (named as the program's path-tracer scene names them): triangles
``tri_v0, tri_e1, tri_e2, tri_mat`` (a quad is two, hit_quad's order
a-b-c then a-c-d, common.glsl:459-464); spheres ``sph_center, sph_radius,
sph_mat`` (a negative radius flips the normal); moving spheres ``msph_c0,
msph_c1, msph_radius, msph_mat`` (centre c0 at time 0, c1 at time 1); one
material per call of the generator (a quad's two triangles share one)
``mat_type`` (0 diffuse, 1 metal, 2 dielectric, 3 plastic), ``mat_albedo,
mat_spec, mat_emissive, mat_rough, mat_refidx, mat_refract`` (the Beer
colour), ``mat_stripe``; point lights ``plight_pos, plight_color``; quad
lights ``qlight_pos, qlight_color, qlight_e1, qlight_e2`` (none here).
"""

from __future__ import annotations

import importlib

import numpy as np
import torch

DIFFUSE, METAL, DIELECTRIC, PLASTIC = 0, 1, 2, 3  # common.glsl:171-174
FLOAT_LEAVES = ("tri_v0", "tri_e1", "tri_e2", "sph_center", "sph_radius",
                "msph_c0", "msph_c1", "msph_radius", "mat_albedo",
                "mat_spec", "mat_emissive", "mat_rough", "mat_refidx",
                "mat_refract", "plight_pos", "plight_color", "qlight_pos",
                "qlight_color", "qlight_e1", "qlight_e2")
INT_LEAVES = ("tri_mat", "sph_mat", "msph_mat", "mat_type")
LEAVES = FLOAT_LEAVES + INT_LEAVES + ("mat_stripe",)


# ------------------------------------------------------------- the scene
class _Tables:
    def __init__(self):
        self.tri, self.sph, self.msph, self.mats = [], [], [], []
        self.lights = []

    def material(self, typ, albedo=(0, 0, 0), spec=(0, 0, 0), rough=1.0,
                 refidx=1.0, refract=(0, 0, 0)):
        self.mats.append((typ, albedo, spec, rough, refidx, refract))
        return len(self.mats) - 1

    def diffuse(self, albedo):  # createDiffuseMaterial: roughness 1
        return self.material(DIFFUSE, albedo=albedo)

    def metal(self, spec, rough):
        return self.material(METAL, spec=spec, rough=rough)

    def glass(self, refract, refidx, rough):  # specular colour 0.04
        return self.material(DIELECTRIC, spec=(0.04,) * 3, rough=rough,
                             refidx=refidx, refract=refract)

    def quad(self, a, b, c, d, m):
        a, b, c, d = (np.array(v, np.float32) for v in (a, b, c, d))
        self.tri += [(a, b - a, c - a, m), (a, c - a, d - a, m)]

    def sphere(self, centre, radius, m):
        self.sph.append((centre, radius, m))

    def moving_sphere(self, c0, c1, radius, m):
        self.msph.append((c0, c1, radius, m))

    def point_light(self, pos, colour):
        self.lights.append((pos, colour))

    def leaves(self):
        f = lambda rows, n: (np.array(rows, np.float32).reshape(-1, n))
        K = len(self.mats)
        out = dict(
            tri_v0=f([t[0] for t in self.tri], 3),
            tri_e1=f([t[1] for t in self.tri], 3),
            tri_e2=f([t[2] for t in self.tri], 3),
            tri_mat=np.array([t[3] for t in self.tri], np.int32),
            sph_center=f([s[0] for s in self.sph], 3),
            sph_radius=np.array([s[1] for s in self.sph], np.float32),
            sph_mat=np.array([s[2] for s in self.sph], np.int32),
            msph_c0=f([s[0] for s in self.msph], 3),
            msph_c1=f([s[1] for s in self.msph], 3),
            msph_radius=np.array([s[2] for s in self.msph], np.float32),
            msph_mat=np.array([s[3] for s in self.msph], np.int32),
            mat_type=np.array([m[0] for m in self.mats], np.int32),
            mat_albedo=f([m[1] for m in self.mats], 3),
            mat_spec=f([m[2] for m in self.mats], 3),
            mat_emissive=np.zeros((K, 3), np.float32),
            mat_rough=np.array([m[3] for m in self.mats], np.float32),
            mat_refidx=np.array([m[4] for m in self.mats], np.float32),
            mat_refract=f([m[5] for m in self.mats], 3),
            mat_stripe=np.zeros(K, bool),
            plight_pos=f([p for p, _ in self.lights], 3),
            plight_color=f([c for _, c in self.lights], 3),
            qlight_pos=np.zeros((0, 3), np.float32))
        for k in ("qlight_color", "qlight_e1", "qlight_e2"):
            out[k] = np.zeros((0, 3), np.float32)
        return out


def scene_leaves(cfg):
    """{leaf: NumPy array} of the scene the configuration's generator
    builds."""
    b = _Tables()
    importlib.import_module("portbench.scenes." + cfg["generator"]).build(
        b, cfg)
    return b.leaves()


def scene0_leaves():
    """{leaf: NumPy array} of scene 0 (P3D_RT.glsl:21-123)."""
    return scene_leaves({"generator": "pt_scene0"})


class PTRefScene:
    """The leaves as tensors on ``device``, floats in ``dtype``; the
    scene's sky is the gradient."""

    def __init__(self, leaves, device, dtype=torch.float32):
        for k in LEAVES:
            v = torch.as_tensor(np.asarray(leaves[k]), device=device)
            setattr(self, k, v.to(dtype) if k in FLOAT_LEAVES else v)
        self.dtype, self.device = dtype, torch.device(device)
        self.sky = "gradient"

    @property
    def counts(self):
        """(triangles, spheres, moving spheres)."""
        return (self.tri_v0.shape[0], self.sph_center.shape[0],
                self.msph_c0.shape[0])


def ref_scene(cfg, device, dtype=torch.float32):
    """The configuration's scene, held to the primitive and light counts
    the configuration states."""
    rs = PTRefScene(scene_leaves(cfg), device, dtype)
    if (sum(rs.counts) != cfg["primitives"]
            or rs.plight_pos.shape[0] != cfg["point_lights"]):
        raise ValueError(f"the scene has {rs.counts} primitives and "
                         f"{rs.plight_pos.shape[0]} point lights; the "
                         f"configuration states {cfg['primitives']} and "
                         f"{cfg['point_lights']}")
    return rs
