"""Path-tracer scenes: the five compile-time GLSL scenes as SoA tables.

Counterpart of ``distributionraytracer_tpu.scene.pt_scenes``.  ``hit_world``
in P3D_RT.glsl:16-481 hardcodes five scenes selected by ``#define SCENE n``:
0 = Shirley Weekend with moving spheres, 1 = Demofox dielectric-roughness
row, 2 = plastic balls, 3 = Cornell-like albedo box, 4 = metal/plastic
roughness ladder.  Each becomes a :class:`PTScene` of tensors: triangles
(quads split into two, preserving hit_quad's test order,
common.glsl:459-464), spheres (negative radius flips the normal,
common.glsl:545), moving spheres (lerped centers, common.glsl:500-505), a
per-primitive material table, the scene's light list and sky mode.

The numpy builders are the JAX package's, line for line, so the leaves
come out bit-identical.  Scene 0's random sphere field reproduces the GLSL
hash chain (baseHash/hash1/hash3, common.glsl:55-78); the moving spheres'
height offsets use ``hash1(gSeed)`` in GLSL, per-fragment state that
cannot be reproduced statically, so those take a fixed per-sphere uniform
draw instead.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

# Material types (common.glsl:171-174)
MT_DIFFUSE = 0
MT_METAL = 1
MT_DIELECTRIC = 2
MT_PLASTIC = 3

# Sky modes (P3D_RT.glsl:661-671)
SKY_GRADIENT = 0  # mix(white, blue) by 0.8*(d.y+1)
SKY_CUBEMAP = 1  # SRGBToLinear(texture(iChannel1, d))
SKY_CUBEMAP_X3 = 2  # same, times 3


# ------------------------------------------------------------- GLSL hashes
def _f32(x):
    return np.float32(x)


def _float_bits_to_uint(x: np.ndarray) -> np.ndarray:
    return np.asarray(x, np.float32).view(np.uint32)


def base_hash(p: np.ndarray) -> np.uint32:
    """baseHash(uvec2) (common.glsl:55-60)."""
    p = p.astype(np.uint32)
    with np.errstate(over="ignore"):
        q = (np.uint32(1103515245) * ((p >> np.uint32(1)) ^ p[::-1]))
        h32 = np.uint32(1103515245) * (q[0] ^ (q[1] >> np.uint32(3)))
    return h32 ^ (h32 >> np.uint32(16))


class GlslSeed:
    """Stateful float seed mimicking `inout float seed` (+= 0.1 per use)."""

    def __init__(self, seed: float):
        self.s = _f32(seed)

    def _advance2(self):
        a = _f32(self.s + _f32(0.1))
        b = _f32(a + _f32(0.1))
        self.s = b
        return np.array([a, b], np.float32)

    def hash1(self) -> float:
        n = base_hash(_float_bits_to_uint(self._advance2()))
        return float(np.float64(n) / 0xFFFFFFFF)

    def hash3(self) -> np.ndarray:
        n = base_hash(_float_bits_to_uint(self._advance2()))
        with np.errstate(over="ignore"):
            rz = np.array([n, n * np.uint32(16807), n * np.uint32(48271)],
                          np.uint32)
        return (rz & np.uint32(0x7FFFFFFF)).astype(np.float64) / 0x7FFFFFFF


# ----------------------------------------------------------------- PTScene
@dataclasses.dataclass
class PTScene:
    """SoA path-tracer scene of tensors (shapes as in the JAX package)."""

    # triangles (quads become 2)
    tri_v0: Any  # (T,3)
    tri_e1: Any
    tri_e2: Any
    tri_mat: Any  # (T,) i32
    # spheres (radius sign flips normal, common.glsl:545)
    sph_center: Any  # (S,3)
    sph_radius: Any  # (S,)
    sph_mat: Any
    # moving spheres (time0=0, time1=1 in all scenes)
    msph_c0: Any  # (M,3)
    msph_c1: Any
    msph_radius: Any  # (M,)
    msph_mat: Any
    # materials
    mat_type: Any  # (K,) i32
    mat_albedo: Any  # (K,3)
    mat_spec: Any  # (K,3)
    mat_emissive: Any  # (K,3)
    mat_rough: Any  # (K,)
    mat_refidx: Any  # (K,)
    mat_refract: Any  # (K,3)
    mat_stripe: Any  # (K,) bool: albedo = floor(mod(pos.x,1)*2)
    # lights: point (P3D_RT.glsl:600-606) and quad (610-626)
    plight_pos: Any  # (Lp,3)
    plight_color: Any  # (Lp,3)
    qlight_pos: Any  # (Lq,3)
    qlight_color: Any
    qlight_e1: Any  # = pos - v1 (common.glsl:633)
    qlight_e2: Any
    # sky
    sky_faces: Any  # (6,H,W,3)
    sky_res: Any  # (6,2) i32 (width, height)
    sky_mode: int = SKY_GRADIENT

    _LEAVES = ["tri_v0", "tri_e1", "tri_e2", "tri_mat",
               "sph_center", "sph_radius", "sph_mat",
               "msph_c0", "msph_c1", "msph_radius", "msph_mat",
               "mat_type", "mat_albedo", "mat_spec", "mat_emissive",
               "mat_rough", "mat_refidx", "mat_refract", "mat_stripe",
               "plight_pos", "plight_color",
               "qlight_pos", "qlight_color", "qlight_e1", "qlight_e2",
               "sky_faces", "sky_res"]

    @property
    def device(self) -> torch.device:
        return self.mat_albedo.device

    def to(self, device) -> "PTScene":
        """A copy with every leaf on ``device``."""
        return PTScene(**{n: getattr(self, n).to(device)
                          for n in self._LEAVES}, sky_mode=self.sky_mode)


def pt_scene_from_numpy(leaves: Dict[str, np.ndarray],
                        sky_mode: int) -> PTScene:
    """Build a CPU :class:`PTScene` from numpy leaves.

    Carries a scene across from the JAX package::

        leaves = {n: np.asarray(getattr(s, n)) for n in PTScene._LEAVES}
        scene = pt_scene_from_numpy(leaves, s.sky_mode)
    """
    missing = [n for n in PTScene._LEAVES if n not in leaves]
    if missing:
        raise ValueError(f"missing path-tracer scene leaves: {missing}")
    return PTScene(**{n: torch.from_numpy(np.array(leaves[n], copy=True))
                      for n in PTScene._LEAVES}, sky_mode=int(sky_mode))


class _PT:
    def __init__(self):
        self.tris: List = []
        self.tri_mat: List[int] = []
        self.sph: List = []
        self.sph_mat: List[int] = []
        self.msph: List = []
        self.msph_mat: List[int] = []
        self.mats: List[Tuple] = []
        self.plights: List = []
        self.qlights: List = []
        self.sky_mode = SKY_GRADIENT

    def mat(self, type_, albedo=(0, 0, 0), spec=(0, 0, 0), emissive=(0, 0, 0),
            rough=1.0, refidx=1.0, refract=(0, 0, 0), stripe=False):
        self.mats.append((type_, np.asarray(albedo, np.float32),
                          np.asarray(spec, np.float32),
                          np.asarray(emissive, np.float32),
                          float(rough), float(refidx),
                          np.asarray(refract, np.float32), bool(stripe)))
        return len(self.mats) - 1

    def diffuse(self, albedo, emissive=(0, 0, 0)):
        # createDiffuseMaterial (common.glsl:187-198): roughness 1
        return self.mat(MT_DIFFUSE, albedo=albedo, emissive=emissive,
                        rough=1.0)

    def metal(self, spec, rough):
        return self.mat(MT_METAL, spec=spec, rough=rough)

    def dielectric(self, refract, refidx, rough):
        # createDielectricMaterial: specColor = 0.04 (common.glsl:211-222)
        return self.mat(MT_DIELECTRIC, spec=(0.04, 0.04, 0.04),
                        refidx=refidx, rough=rough, refract=refract)

    def plastic(self, albedo, rough):
        return self.mat(MT_PLASTIC, albedo=albedo, spec=(0.04, 0.04, 0.04),
                        rough=rough)

    def quad(self, a, b, c, d, m):
        # hit_quad = triangle(a,b,c) then triangle(a,c,d) (common.glsl:461-462)
        a, b, c, d = [np.asarray(v, np.float32) for v in (a, b, c, d)]
        self.tris.append((a, b - a, c - a)); self.tri_mat.append(m)
        self.tris.append((a, c - a, d - a)); self.tri_mat.append(m)

    def sphere(self, center, radius, m):
        self.sph.append((np.asarray(center, np.float32), float(radius)))
        self.sph_mat.append(m)

    def moving_sphere(self, c0, c1, radius, m):
        self.msph.append((np.asarray(c0, np.float32),
                          np.asarray(c1, np.float32), float(radius)))
        self.msph_mat.append(m)

    def build(self, sky_faces=None, sky_res=None) -> PTScene:
        if sky_faces is None:
            sky_faces = np.zeros((6, 1, 1, 3), np.float32)
            sky_res = np.ones((6, 2), np.int32)

        def stk(rows, shape):
            return (np.stack(rows).astype(np.float32) if rows
                    else np.zeros(shape, np.float32))

        T, S, M = len(self.tri_mat), len(self.sph_mat), len(self.msph_mat)
        K = len(self.mats)
        leaves = dict(
            tri_v0=stk([t[0] for t in self.tris], (T, 3)),
            tri_e1=stk([t[1] for t in self.tris], (T, 3)),
            tri_e2=stk([t[2] for t in self.tris], (T, 3)),
            tri_mat=np.asarray(self.tri_mat, np.int32),
            sph_center=stk([s[0] for s in self.sph], (S, 3)),
            sph_radius=np.asarray([s[1] for s in self.sph], np.float32),
            sph_mat=np.asarray(self.sph_mat, np.int32),
            msph_c0=stk([s[0] for s in self.msph], (M, 3)),
            msph_c1=stk([s[1] for s in self.msph], (M, 3)),
            msph_radius=np.asarray([s[2] for s in self.msph], np.float32),
            msph_mat=np.asarray(self.msph_mat, np.int32),
            mat_type=np.asarray([m[0] for m in self.mats], np.int32),
            mat_albedo=stk([m[1] for m in self.mats], (K, 3)),
            mat_spec=stk([m[2] for m in self.mats], (K, 3)),
            mat_emissive=stk([m[3] for m in self.mats], (K, 3)),
            mat_rough=np.asarray([m[4] for m in self.mats], np.float32),
            mat_refidx=np.asarray([m[5] for m in self.mats], np.float32),
            mat_refract=stk([m[6] for m in self.mats], (K, 3)),
            mat_stripe=np.asarray([m[7] for m in self.mats], bool),
            plight_pos=stk([l[0] for l in self.plights],
                           (len(self.plights), 3)),
            plight_color=stk([l[1] for l in self.plights],
                             (len(self.plights), 3)),
            qlight_pos=stk([l[0] for l in self.qlights],
                           (len(self.qlights), 3)),
            qlight_color=stk([l[1] for l in self.qlights],
                             (len(self.qlights), 3)),
            qlight_e1=stk([l[2] for l in self.qlights],
                          (len(self.qlights), 3)),
            qlight_e2=stk([l[3] for l in self.qlights],
                          (len(self.qlights), 3)),
            sky_faces=sky_faces, sky_res=sky_res)
        return pt_scene_from_numpy(leaves, self.sky_mode)

    def point_light(self, pos, color):
        self.plights.append((np.asarray(pos, np.float32),
                             np.asarray(color, np.float32)))

    def quad_light(self, pos, color, v1, v2):
        # createQuadLight: e1 = pos - v1, e2 = pos - v2 (common.glsl:633-634)
        pos = np.asarray(pos, np.float32)
        self.qlights.append((pos, np.asarray(color, np.float32),
                             pos - np.asarray(v1, np.float32),
                             pos - np.asarray(v2, np.float32)))


def _demofox_walls(b: _PT, emissive_scale: float):
    """Shared floor/back/ceiling/light quads of scenes 1 and 2
    (P3D_RT.glsl:126-255)."""
    b.quad([-25, -12.5, 10], [25, -12.5, 10], [25, -12.5, -5],
           [-25, -12.5, -5], b.diffuse([0.7, 0.7, 0.7]))
    # striped background: albedo from hit position (P3D_RT.glsl:148-151)
    b.quad([-25, -10.5, -5], [25, -10.5, -5], [25, -1.5, -5],
           [-25, -1.5, -5],
           b.mat(MT_DIFFUSE, albedo=(1, 1, 1), rough=1.0, stripe=True))
    b.quad([-7.5, 12.5, 5], [7.5, 12.5, 5], [7.5, 12.5, -5],
           [-7.5, 12.5, -5], b.diffuse([0.7, 0.7, 0.7]))
    b.quad([-5, 12.3, 2.5], [5, 12.3, 2.5], [5, 12.3, -2.5],
           [-5, 12.3, -2.5],
           b.diffuse([0, 0, 0],
                     emissive=np.array([1.0, 0.9, 0.9]) * emissive_scale))


def scene0(seed_motion: int = 0) -> PTScene:
    """Shirley Weekend scene (P3D_RT.glsl:21-123)."""
    b = _PT()
    b.sky_mode = SKY_GRADIENT
    b.quad([-10, -0.05, 10], [10, -0.05, 10], [10, -0.05, -10],
           [-10, -0.05, -10], b.diffuse([0.2, 0.2, 0.2]))
    b.sphere([-4, 1, 0], 1.0, b.diffuse([0.2, 0.95, 0.1]))
    b.sphere([4, 1, 0], 1.0, b.metal([0.562, 0.565, 0.578], 0.4))
    b.sphere([-1.5, 1, 0], 1.0, b.dielectric([0, 0, 0], 1.33, 0.0))
    b.sphere([-1.5, 1, 0], -0.5, b.dielectric([0, 0, 0], 1.33, 0.0))
    b.sphere([1.5, 1, 0], 1.0, b.dielectric([0, 0.9, 0.9], 1.5, 0.0))

    rng = np.random.default_rng(seed_motion)
    for x in range(-5, 5):
        for y in range(-5, 5):
            seed = GlslSeed(np.float32(x) + np.float32(y) / np.float32(1000.0))
            rand1 = seed.hash3()
            center = np.array([x + 0.9 * rand1[0], 0.2, y + 0.9 * rand1[1]],
                              np.float32)
            choose = rand1[2]
            if np.linalg.norm(center - np.array([4.0, 0.2, 0.0])) <= 0.9:
                continue
            if choose < 0.3:
                # moving diffuse; height uses gSeed in GLSL (per-fragment) —
                # fixed draw here
                c1 = center + np.array([0.0, rng.random() * 0.5, 0.0],
                                       np.float32)
                alb = seed.hash3() * seed.hash3()
                b.moving_sphere(center, c1, 0.2, b.diffuse(alb))
            elif choose < 0.5:
                alb = seed.hash3() * seed.hash3()
                b.sphere(center, 0.2, b.diffuse(alb))
            elif choose < 0.7:
                spec = (seed.hash3() + 1.0) * 0.5
                b.sphere(center, 0.2, b.metal(spec, 0.0))
            elif choose < 0.9:
                spec = (seed.hash3() + 1.0) * 0.5
                b.sphere(center, 0.2, b.metal(spec, seed.hash1()))
            else:
                b.sphere(center, 0.2, b.dielectric(seed.hash3(), 1.33, 0.0))

    b.point_light([-10, 15, 0], [1, 1, 1])
    b.point_light([8, 15, 3], [1, 1, 1])
    b.point_light([1, 15, -9], [1, 1, 1])
    return b.build()


def _quad_light_1to4(b: _PT):
    b.quad_light([5, 12.3, 2.5], [1, 1, 1], [-5, 12.3, 2.5], [5, 12.3, -2.5])


def scene1(sky_faces=None, sky_res=None) -> PTScene:
    """Dielectric roughness row (P3D_RT.glsl:124-195)."""
    b = _PT()
    b.sky_mode = SKY_CUBEMAP
    _demofox_walls(b, 20.0)
    for i in range(7):
        r = i / 6.0 * 0.1
        b.sphere([-18 + 6 * i, -8, 0], 2.8,
                 b.dielectric([0.0, 0.5, 1.0], 1.1, r))
    _quad_light_1to4(b)
    return b.build(sky_faces, sky_res)


def scene2(sky_faces=None, sky_res=None) -> PTScene:
    """Plastic balls (P3D_RT.glsl:197-267)."""
    b = _PT()
    b.sky_mode = SKY_CUBEMAP_X3
    _demofox_walls(b, 30.0)
    for i in range(7):
        r = i / 6.0 * 0.1
        b.sphere([-18 + 6 * i, -8, 0], 2.8, b.plastic([0.9, 0.25, 0.25], r))
    _quad_light_1to4(b)
    return b.build(sky_faces, sky_res)


def scene3(sky_faces=None, sky_res=None) -> PTScene:
    """Cornell-like albedo box (P3D_RT.glsl:268-364)."""
    b = _PT()
    b.sky_mode = SKY_CUBEMAP
    b.quad([-12.6, -12.6, 25], [12.6, -12.6, 25], [12.6, 12.6, 25],
           [-12.6, 12.6, 25], b.diffuse([0.7, 0.7, 0.7]))
    b.quad([-12.6, -12.45, 25], [12.6, -12.45, 25], [12.6, -12.45, 15],
           [-12.6, -12.45, 15], b.diffuse([0.7, 0.7, 0.7]))
    b.quad([-12.6, 12.5, 25], [12.6, 12.5, 25], [12.6, 12.5, 15],
           [-12.6, 12.5, 15], b.diffuse([0.7, 0.7, 0.7]))
    b.quad([-12.5, -12.6, 25], [-12.5, -12.6, 15], [-12.5, 12.6, 15],
           [-12.5, 12.6, 25], b.diffuse([0.7, 0.1, 0.1]))
    b.quad([12.5, -12.6, 25], [12.5, -12.6, 15], [12.5, 12.6, 15],
           [12.5, 12.6, 25], b.diffuse([0.1, 0.7, 0.1]))
    b.quad([-5, 12.4, 22.5], [5, 12.4, 22.5], [5, 12.4, 17.5],
           [-5, 12.4, 17.5],
           b.diffuse([0, 0, 0], emissive=np.array([1.0, 0.9, 0.7]) * 20.0))
    b.sphere([-9, -9.5, 20], 3.0, b.diffuse([0.9, 0.9, 0.75]))
    b.sphere([0, -9.5, 20], 3.0, b.diffuse([0.9, 0.75, 0.9]))
    b.sphere([9, -9.5, 20], 3.0, b.diffuse([0.75, 0.9, 0.9]))
    _quad_light_1to4(b)
    return b.build(sky_faces, sky_res)


def scene4(sky_faces=None, sky_res=None) -> PTScene:
    """Roughness ladder (P3D_RT.glsl:366-476)."""
    b = _PT()
    b.sky_mode = SKY_CUBEMAP_X3
    w, far, near = 10.0, 24.0, 18.0
    b.quad([-w, -w, far], [w, -w, far], [w, w, far], [-w, w, far],
           b.diffuse([0.7, 0.7, 0.7]))
    b.quad([-w, -w, far], [w, -w, far], [w, -w, near], [-w, -w, near],
           b.diffuse([0.7, 0.7, 0.7]))
    b.quad([-w, w, far], [w, w, far], [w, w, near], [-w, w, near],
           b.diffuse([0.7, 0.7, 0.7]))
    b.quad([-w, -w, far], [-w, -w, near], [-w, w, near], [-w, w, far],
           b.diffuse([0.7, 0.1, 0.1]))
    b.quad([w, -w, far], [w, -w, near], [w, w, near], [w, w, far],
           b.diffuse([0.1, 0.7, 0.1]))
    pad = 2.0
    b.quad([-w + pad * 2, w - 0.1, far - pad], [w - pad * 2, w - 0.1, far - pad],
           [w - pad * 2, w - 0.1, near + pad], [-w + pad * 2, w - 0.1, near + pad],
           b.diffuse([0, 0, 0], emissive=np.array([1.0, 0.9, 0.7]) * 20.0))
    for i in range(5):
        b.sphere([-6 + i * 3, -7.5, 18], 1.5,
                 b.metal([0.8, 1.0, 1.0], i / 3.0))
    for i in range(5):
        b.sphere([-6 + i * 3, -3.5, 20], 1.5,
                 b.plastic([0.8, 1.0, 0.6], i / 3.0))
    for i in range(5):
        b.sphere([-6 + i * 3, 0.5, 22], 1.5,
                 b.plastic([1.0, 0.8, 0.7], 0.0))
    _quad_light_1to4(b)
    return b.build(sky_faces, sky_res)


SCENE_BUILDERS = {0: scene0, 1: scene1, 2: scene2, 3: scene3, 4: scene4}
