"""Scene representation: a dataclass of torch tensors in SoA layout.

Counterpart of ``distributionraytracer_tpu.scene.types``.  The layout is the
same, leaf for leaf, so a scene built by either package can be carried to
the other through numpy (:func:`scene_from_numpy`):

- per-primitive-type arrays (spheres / triangles / planes / aaboxes);
- a materials table indexed per primitive (``Material``, scene.h:34-66);
- a lights table (``Light``, scene.h:68-107);
- camera eye/at/up leaves, the uvn frame derived by :func:`derive_camera`;
- the skybox leaves (a (6,1,1,3) zero face table when there is none).

Static metadata (counts, accel type, resolution, spp, insertion order)
lives in the frozen, hashable :class:`SceneStatic`.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Tuple

import numpy as np
import torch

from distributionraytracer_tpu_torch.utils import spans

# Acceleration structure selector (scene.h:22)
ACCEL_NONE = 0
ACCEL_GRID = 1
ACCEL_BVH = 2

# Unified object type tags, in reference insertion order semantics
OBJ_SPHERE = 0
OBJ_TRIANGLE = 1
OBJ_PLANE = 2
OBJ_BOX = 3

# Light types (scene.h:16)
LIGHT_PUNCTUAL = 0
LIGHT_QUAD = 1


@dataclasses.dataclass(frozen=True)
class SceneStatic:
    """Hashable, shape-defining metadata for a scene."""

    n_spheres: int
    n_triangles: int
    n_planes: int
    n_boxes: int
    n_objects: int  # total, in reference insertion order
    n_lights: int
    n_materials: int
    accel: int  # ACCEL_NONE | ACCEL_GRID | ACCEL_BVH
    spp: int  # samples-per-pixel from the P3F 'spp' command
    res_x: int
    res_y: int
    # static camera scalars (camera.h:32-61)
    fovy: float
    hither: float
    yon: float
    aperture_ratio: float
    focal_ratio: float
    has_skybox: bool
    # object-id -> (type, per-type index)
    obj_types: Tuple[int, ...] = ()
    obj_tidx: Tuple[int, ...] = ()
    # per-light static structure
    light_quad: Tuple[bool, ...] = ()
    light_grid: Tuple[int, ...] = ()
    # static ray-tree pruning facts (some material has T == 1 / Ks > 0)
    any_refr: bool = True
    any_refl: bool = True

    @property
    def has_dof(self) -> bool:
        return self.aperture_ratio != 0.0


@dataclasses.dataclass
class SceneData:
    """SoA scene tensors + static metadata."""

    # --- spheres (scene.h:154-166) ---
    sph_center: Any  # (Ns,3) f32
    sph_radius: Any  # (Ns,)  f32
    sph_mat: Any  # (Ns,)  i32
    # --- triangles (scene.h:138-150); v0 and the two edges ---
    tri_v0: Any  # (Nt,3)
    tri_e1: Any  # (Nt,3)  = v1 - v0
    tri_e2: Any  # (Nt,3)  = v2 - v0
    tri_mat: Any  # (Nt,) i32
    # --- planes (scene.h:125-136), Hessian form PN.P + D = 0 ---
    pln_n: Any  # (Np,3)
    pln_d: Any  # (Np,)
    pln_mat: Any  # (Np,) i32
    # --- axis-aligned boxes (scene.h:168-180) ---
    box_min: Any  # (Nb,3)
    box_max: Any  # (Nb,3)
    box_mat: Any  # (Nb,) i32
    # --- materials (scene.h:34-66); m_Refl = Ks quirk preserved ---
    mat_cd: Any  # (M,3)
    mat_kd: Any  # (M,)
    mat_cs: Any  # (M,3)
    mat_ks: Any  # (M,)
    mat_shine: Any  # (M,)
    mat_kr: Any  # (M,)  == Ks at load (scene.h:42)
    mat_T: Any  # (M,)
    mat_ior: Any  # (M,)
    # --- lights (scene.h:68-107) ---
    light_pos: Any  # (L,3)
    light_color: Any  # (L,3)
    light_e1: Any  # (L,3)  = v1 - pos
    light_e2: Any  # (L,3)  = v2 - pos
    light_is_quad: Any  # (L,) bool
    light_grid_res: Any  # (L,) i32
    # --- camera pose ---
    cam_eye: Any  # (3,)
    cam_at: Any  # (3,)
    cam_up: Any  # (3,)
    # --- background / skybox ---
    bg_color: Any  # (3,)
    sky_faces: Any  # (6,H,W,3) f32, (6,1,1,3) zeros when disabled
    sky_res: Any  # (6,2) i32
    static: SceneStatic = None

    _LEAF_NAMES = [
        "sph_center", "sph_radius", "sph_mat",
        "tri_v0", "tri_e1", "tri_e2", "tri_mat",
        "pln_n", "pln_d", "pln_mat",
        "box_min", "box_max", "box_mat",
        "mat_cd", "mat_kd", "mat_cs", "mat_ks", "mat_shine", "mat_kr",
        "mat_T", "mat_ior",
        "light_pos", "light_color", "light_e1", "light_e2",
        "light_is_quad", "light_grid_res",
        "cam_eye", "cam_at", "cam_up",
        "bg_color", "sky_faces", "sky_res",
    ]

    @property
    def device(self) -> torch.device:
        return self.cam_eye.device

    def to(self, device) -> "SceneData":
        """A copy with every leaf on ``device``."""
        leaves = {n: getattr(self, n).to(device) for n in self._LEAF_NAMES}
        return SceneData(**leaves, static=self.static)

    def with_resolution(self, res_x: int, res_y: int) -> "SceneData":
        return dataclasses.replace(self, static=dataclasses.replace(
            self.static, res_x=int(res_x), res_y=int(res_y)))

    def packed_objects(self):
        """Unified ``(O, 12)`` primitive table in reference insertion order.

        Row layout by type:

        - sphere:   ``[cx, cy, cz, r, 0...]``
        - triangle: ``[v0, e1, e2]``
        - plane:    ``[nx, ny, nz, D, 0...]``
        - box:      ``[min, max, 0...]``

        Returns ``(data (O,12) f32, types (O,) i32, mats (O,) i32)`` on the
        scene's device (one zero row when the scene has no object).
        """
        spans.count("tables.builds.packed_objects")
        st = self.static
        dev = self.device
        O = st.n_objects
        data = torch.zeros((max(O, 1), 12), dtype=torch.float32, device=dev)
        mats = torch.zeros((max(O, 1),), dtype=torch.int32, device=dev)
        types = torch.as_tensor(
            np.array(st.obj_types, np.int32).reshape(-1) if O
            else np.zeros((1,), np.int32), device=dev)
        obj_types = np.array(st.obj_types, np.int64)
        obj_tidx = np.array(st.obj_tidx, np.int64)

        def place(typ, cols, mat):
            ids = np.nonzero(obj_types == typ)[0]
            if not len(ids):
                return
            sub = torch.as_tensor(obj_tidx[ids], device=dev)
            rows = torch.cat([c[sub].reshape(len(ids), -1) for c in cols], 1)
            idt = torch.as_tensor(ids, device=dev)
            data[idt, :rows.shape[1]] = rows.to(torch.float32)
            mats[idt] = mat[sub].to(torch.int32)

        place(OBJ_SPHERE, [self.sph_center, self.sph_radius], self.sph_mat)
        place(OBJ_TRIANGLE, [self.tri_v0, self.tri_e1, self.tri_e2],
              self.tri_mat)
        place(OBJ_PLANE, [self.pln_n, self.pln_d], self.pln_mat)
        place(OBJ_BOX, [self.box_min, self.box_max], self.box_mat)
        return data, types, mats


def scene_from_numpy(leaves: Dict[str, np.ndarray],
                     static: Dict[str, Any]) -> SceneData:
    """Build a CPU :class:`SceneData` from numpy leaves and a static dict.

    Carries a scene across from the JAX package::

        leaves = {n: np.asarray(getattr(s, n)) for n in SceneData._LEAF_NAMES}
        scene = scene_from_numpy(leaves, dataclasses.asdict(s.static))
    """
    missing = [n for n in SceneData._LEAF_NAMES if n not in leaves]
    if missing:
        raise ValueError(f"missing scene leaves: {missing}")
    st = {k: tuple(v) if isinstance(v, list) else v
          for k, v in static.items()}
    tensors = {n: torch.from_numpy(np.array(leaves[n], copy=True))
               for n in SceneData._LEAF_NAMES}
    return SceneData(**tensors, static=SceneStatic(**st))


@dataclasses.dataclass(frozen=True)
class CameraParams:
    """Derived camera frame (camera.h:44-57).

    ``n = normalize(eye - at)``, ``u = normalize(up x n)``, ``v = n x u``;
    window ``h = 2 * plane_dist * tan(fov/2)``, ``w = aspect * h``;
    lens ``aperture = aperture_ratio * (w / res_x)`` (camera.h:57).
    """

    eye: Any
    u: Any
    v: Any
    n: Any
    w: Any
    h: Any
    plane_dist: Any
    aperture: Any
    focal_ratio: float
    res_x: int
    res_y: int


def derive_camera(scene: SceneData) -> CameraParams:
    st = scene.static
    eye = scene.cam_eye.to(torch.float32)
    n = eye - scene.cam_at.to(torch.float32)
    plane_dist = torch.linalg.norm(n)
    n = n / plane_dist
    u = torch.linalg.cross(scene.cam_up.to(torch.float32), n)
    u = u / torch.linalg.norm(u)
    v = torch.linalg.cross(n, u)
    h = 2.0 * plane_dist * math.tan((math.pi * st.fovy / 180.0) / 2.0)
    w = (st.res_x / st.res_y) * h
    aperture = st.aperture_ratio * (w / st.res_x)
    return CameraParams(
        eye=eye, u=u, v=v, n=n, w=w, h=h, plane_dist=plane_dist,
        aperture=aperture, focal_ratio=st.focal_ratio,
        res_x=st.res_x, res_y=st.res_y)
