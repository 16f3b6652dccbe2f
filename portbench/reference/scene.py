"""The reference's scene: a recorder of the generator's builder calls and
its tensors.

``Recorder`` has the builder methods the generators in ``portbench/scenes``
call and keeps their arguments as NumPy arrays in insertion order, the
object ids the upstream renderer's linear scan uses (main.cpp:315-326).
``RefScene`` holds them as tensors of one floating type on one device.
"""

from __future__ import annotations

import math

import numpy as np
import torch

ACCEL_NONE, ACCEL_BVH = 0, 2


class Recorder:
    """Records ``set_camera``, ``add_material``, ``add_sphere``,
    ``add_triangles_bulk`` and ``add_point_light`` calls."""

    def __init__(self):
        self.accel = ACCEL_NONE
        self.spp = 0
        self.bg_color = np.zeros(3, np.float32)
        self.camera = None
        self.mats = []  # (cd3, kd, cs3, ks, shine, T, ior)
        self.spheres = []  # (gid, center3, radius, mat)
        self.tris = []  # (first gid, v0, e1, e2, mat)
        self.lights = []
        self.n_obj = 0

    def set_camera(self, eye, at, up, fovy, hither, res_x, res_y,
                   aperture_ratio, focal_ratio):
        self.camera = dict(eye=np.asarray(eye, np.float32),
                           at=np.asarray(at, np.float32),
                           up=np.asarray(up, np.float32), fovy=float(fovy),
                           res_x=int(res_x), res_y=int(res_y))

    def add_material(self, cd, kd, cs, ks, shine, T, ior):
        self.mats.append((np.asarray(cd, np.float32), float(kd),
                          np.asarray(cs, np.float32), float(ks),
                          float(shine), float(T), float(ior)))
        return len(self.mats) - 1

    def add_sphere(self, center, radius, mat):
        self.spheres.append((self.n_obj, np.asarray(center, np.float32),
                             float(radius), mat))
        self.n_obj += 1

    def add_triangles_bulk(self, verts, faces, mat):
        v0 = verts[faces[:, 0]].astype(np.float32)
        v1 = verts[faces[:, 1]].astype(np.float32)
        v2 = verts[faces[:, 2]].astype(np.float32)
        self.tris.append((self.n_obj, v0, v1 - v0, v2 - v0, mat))
        self.n_obj += len(faces)

    def add_point_light(self, pos, color):
        self.lights.append(np.asarray(pos, np.float32))


class RefScene:
    """Tensors of a recorded scene in ``dtype`` on ``device``."""

    def __init__(self, rec: Recorder, device, dtype=torch.float32):
        f = lambda a: torch.as_tensor(np.asarray(a, np.float32),
                                      device=device).to(dtype)
        i = lambda a: torch.as_tensor(np.asarray(a, np.int64), device=device)
        self.device, self.dtype = torch.device(device), dtype
        self.accel = rec.accel
        cam = rec.camera
        self.eye, self.at, self.up = f(cam["eye"]), f(cam["at"]), f(cam["up"])
        self.fovy, self.res_x, self.res_y = (cam["fovy"], cam["res_x"],
                                             cam["res_y"])
        self.bg = f(rec.bg_color)
        m = rec.mats
        self.cd = f(np.stack([x[0] for x in m]))
        self.kd = f([x[1] for x in m])
        self.cs = f(np.stack([x[2] for x in m]))
        self.ks = f([x[3] for x in m])
        self.shine = f([x[4] for x in m])
        self.T = f([x[5] for x in m])
        self.ior = f([x[6] for x in m])
        s = rec.spheres
        self.sph_gid = i([x[0] for x in s])
        self.sph_c = f(np.stack([x[1] for x in s]).reshape(-1, 3))
        self.sph_r = f([x[2] for x in s])
        self.sph_mat = i([x[3] for x in s])
        t = rec.tris
        if t:
            self.tri_gid = torch.cat([
                torch.arange(x[0], x[0] + len(x[1]), device=device)
                for x in t])
            self.tri_v0, self.tri_e1, self.tri_e2 = (
                f(np.concatenate([x[k] for x in t])) for k in (1, 2, 3))
            self.tri_mat = torch.cat([
                torch.full((len(x[1]),), x[4], dtype=torch.int64,
                           device=device) for x in t])
        else:
            self.tri_gid = i(np.zeros(0))
            self.tri_v0 = self.tri_e1 = self.tri_e2 = f(np.zeros((0, 3)))
            self.tri_mat = i(np.zeros(0))
        self.lights = f(np.stack(rec.lights))
        self.n_obj = rec.n_obj

    def with_eye(self, eye):
        """A shallow copy whose camera stands at ``eye``."""
        out = object.__new__(RefScene)
        out.__dict__.update(self.__dict__)
        out.eye = torch.as_tensor(np.asarray(eye, np.float32),
                                  device=self.device).to(self.dtype)
        return out

    def camera(self):
        """(eye, u, v, n, w, h, plane distance) of the pinhole camera
        (camera.h:44-57 of the upstream renderer)."""
        n = self.eye - self.at
        pd = torch.sqrt((n * n).sum())
        n = n / pd
        u = torch.linalg.cross(self.up, n)
        u = u / torch.sqrt((u * u).sum())
        v = torch.linalg.cross(n, u)
        h = 2.0 * pd * math.tan(math.radians(self.fovy) / 2.0)
        w = (self.res_x / self.res_y) * h
        return self.eye, u, v, n, w, h, pd

    def primary_rays(self, px, py):
        """Rays through viewport points (``px``, ``py``), y up from the
        bottom row (camera.h:74-83)."""
        eye, u, v, n, w, h, pd = self.camera()
        sx = (px / self.res_x - 0.5)[..., None]
        sy = (py / self.res_y - 0.5)[..., None]
        d = u * (w * sx) + v * (h * sy) - n * pd
        d = d / torch.sqrt((d * d).sum(-1, keepdim=True))
        return eye.expand(d.shape).contiguous(), d


def ref_scene(cfg, device, dtype=torch.float32):
    """The configuration's scene, from its generator, as reference
    tensors."""
    import importlib

    rec = Recorder()
    importlib.import_module("portbench.scenes." + cfg["generator"]).build(
        rec, cfg)
    return RefScene(rec, device, dtype)
