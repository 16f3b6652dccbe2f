"""P3F scene-file parser (counterpart of ``distributionraytracer_tpu.scene.p3f``).

Token-for-token equivalent of ``Scene::load_p3f`` (scene.cpp:474-740):

- ``accel none|grid|bvh``
- ``spp N``
- ``mat cd(3) Kd cs(3) Ks Shine T ior``  — sets the current material
- ``s cx cy cz r``                        — sphere
- ``box minx miny minz maxx maxy maxz``
- ``p 3`` + 9 floats                      — triangle
- ``mesh nV nF`` + vertices + 1-based (or negative, scene.cpp:578-593) faces
- ``npl nx ny nz D`` / ``pl`` + 9 floats  — planes
- ``light punctual pos color`` / ``light quad pos color v1 v2 gridRes``
- ``camera eye.. at.. up.. angle hither resolution aperture focal``
- ``bclr r g b``
- ``env skydir``                          — skybox (``scene/skybox.py``,
                                            which needs PIL)
- ``# ...``                               — comment to end of line

Parsing is whitespace-token based like ``ifstream >>`` so layouts with
numbers spread across lines parse identically.  Long runs of numbers (mesh
blocks: a 100k-triangle mesh is ~450k numbers) go through the native
tokenizer (``native.parse_floats_native``); short ones, and every number
where no C++ compiler is found, through ``float()``.
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np

from distributionraytracer_tpu_torch import native
from distributionraytracer_tpu_torch.scene.builder import SceneBuilder
from distributionraytracer_tpu_torch.scene.skybox import load_skybox
from distributionraytracer_tpu_torch.scene.types import (
    ACCEL_BVH, ACCEL_GRID, ACCEL_NONE, SceneData,
)

_WS = b" \t\r\n\f\v"
_NATIVE_MIN = 32  # below this many numbers, float() beats a ctypes call


class _Tokens:
    """Byte-position stream of whitespace tokens with `#` comment-to-eol
    handling.

    The reference handles comments only at command position
    (scene.cpp:724-727) and consumes to end of line; ``skip_line`` mirrors
    `ignore('\\n')`.  A byte cursor (rather than pre-split lines) lets bulk
    numeric reads drop into the native tokenizer.
    """

    def __init__(self, text: str):
        self._b = text.encode("utf-8")
        self._pos = 0

    def next(self) -> Optional[str]:
        b, n, i = self._b, len(self._b), self._pos
        while i < n and b[i] in _WS:
            i += 1
        if i >= n:
            self._pos = i
            return None
        j = i
        while j < n and b[j] not in _WS:
            j += 1
        self._pos = j
        return b[i:j].decode("utf-8")

    def skip_line(self):
        k = self._b.find(b"\n", self._pos)
        self._pos = len(self._b) if k < 0 else k + 1

    def _need(self) -> str:
        tok = self.next()
        if tok is None:
            raise ValueError("unexpected end of P3F input")
        return tok

    def float_array(self, n: int) -> np.ndarray:
        if n >= _NATIVE_MIN:
            res = native.parse_floats_native(self._b, self._pos, n)
            if res is not None:
                vals, self._pos = res
                return vals
        return np.array([float(self._need()) for _ in range(n)], np.float64)

    def floats(self, n: int) -> List[float]:
        return self.float_array(n).tolist()

    def int_array(self, n: int) -> np.ndarray:
        v = self.float_array(n)
        iv = v.astype(np.int64)
        if not (iv == v).all():
            raise ValueError("expected integers")
        return iv

    def ints(self, n: int) -> List[int]:
        return self.int_array(n).tolist()


def load_p3f(path: str) -> SceneData:
    with open(path, "r") as f:
        return parse_p3f(f.read(), os.path.dirname(os.path.abspath(path)))


def parse_p3f(text: str, base_dir: Optional[str] = None) -> SceneData:
    """Parse P3F text into a CPU :class:`SceneData`.

    ``env`` resolves its skybox directory against ``base_dir`` (the scene
    file's directory; the working directory when None), then its parent.
    """
    if base_dir is None:
        base_dir = os.getcwd()
    tk = _Tokens(text)
    b = SceneBuilder()

    while True:
        cmd = tk.next()
        if cmd is None:
            break
        if cmd.startswith("#"):
            tk.skip_line()
            continue
        if cmd == "accel":
            t = tk.next()
            b.accel = {"none": ACCEL_NONE, "grid": ACCEL_GRID,
                       "bvh": ACCEL_BVH}[t]
        elif cmd == "spp":
            b.spp = int(tk.next())
        elif cmd == "mat":
            v = tk.floats(11)
            b.add_material(v[0:3], v[3], v[4:7], v[7], v[8], v[9], v[10])
        elif cmd == "s":
            v = tk.floats(4)
            b.add_sphere(v[0:3], v[3])
        elif cmd == "box":
            v = tk.floats(6)
            b.add_box(v[0:3], v[3:6])
        elif cmd == "p":
            nv = int(tk.next())
            if nv != 3:
                raise ValueError("unsupported polygon vertex count")
            v = tk.floats(9)
            b.add_triangle(v[0:3], v[3:6], v[6:9])
        elif cmd == "mesh":
            nv, nf = tk.ints(2)
            verts = tk.float_array(3 * nv).astype(np.float32).reshape(nv, 3)
            faces = tk.int_array(3 * nf).reshape(nf, 3)
            # 1-based indices, or negative offsets from the end
            # (scene.cpp:578-593: P0 > 0 -> subtract 1; else add nV)
            faces = np.where(faces[:, :1] > 0, faces - 1, faces + nv)
            b.add_triangles_bulk(verts, faces)
        elif cmd == "npl":
            v = tk.floats(4)
            b.add_plane_hessian(v[0:3], v[3])
        elif cmd == "pl":
            v = tk.floats(9)
            b.add_plane_points(v[0:3], v[3:6], v[6:9])
        elif cmd == "light":
            t = tk.next()
            if t == "punctual":
                v = tk.floats(6)
                b.add_point_light(v[0:3], v[3:6])
            elif t == "quad":
                v = tk.floats(12)
                gr = int(tk.next())
                b.add_quad_light(v[0:3], v[3:6], v[6:9], v[9:12], gr)
            else:
                raise ValueError(f"unsupported light type {t}")
        elif cmd == "camera":
            def expect(name):
                got = tk.next()
                if got != name:
                    raise ValueError(f"'{name}' expected, got {got!r}")
            expect("eye"); eye = tk.floats(3)
            expect("at"); at = tk.floats(3)
            expect("up"); up = tk.floats(3)
            expect("angle"); fov = float(tk.next())
            expect("hither"); hither = float(tk.next())
            expect("resolution"); rx, ry = tk.ints(2)
            expect("aperture"); ap = float(tk.next())
            expect("focal"); fr = float(tk.next())
            b.set_camera(eye, at, up, fov, hither, rx, ry, ap, fr)
        elif cmd == "bclr":
            b.bg_color = np.array(tk.floats(3), np.float32)
        elif cmd == "env":
            sky_dir = tk.next()
            # the reference resolves the skybox dir relative to its CWD
            # (the project root), one level above P3D_Scenes/
            for root in (base_dir, os.path.dirname(base_dir)):
                cand = os.path.join(root, sky_dir)
                if os.path.isdir(cand):
                    b.sky_faces, b.sky_res = load_skybox(cand)
                    break
            else:
                raise FileNotFoundError(f"skybox dir {sky_dir!r}")
        else:
            raise ValueError(f"unknown P3F command {cmd!r}")

    return b.build()
