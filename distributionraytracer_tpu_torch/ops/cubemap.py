"""Skybox cubemap lookup (counterpart of ``distributionraytracer_tpu.ops.cubemap``).

Reproduces ``Scene::GetSkyboxColor`` (scene.cpp:380-458) exactly, including
its quirks:

- dominant-axis selection order: X beats Y, Z beats both only when strictly
  greater (scene.cpp:393-405);
- X >= 0 maps to LEFT and X < 0 to RIGHT (swapped vs OpenGL convention,
  scene.cpp:395);
- nearest-texel fetch at ``xp = int((width-1) * s)`` (scene.cpp:448-451).

Also provides the standard OpenGL cubemap convention used by the GLSL path
tracer's ``texture(iChannel1, dir)`` (P3D_RT.glsl:666-670), with
``int(width * s)``.  Both are plain torch gathers: the reference leaves the
lookup to XLA, so there is no kernel.
"""

from __future__ import annotations

import torch

# CubeMap enum order (scene.h:19)
RIGHT, LEFT, TOP, BOTTOM, FRONT, BACK = 0, 1, 2, 3, 4, 5


def _select(face, values, default):
    """``jnp.select([face == 0, ..., face == 4], values, default)``."""
    out = default
    for k in reversed(range(len(values))):
        out = torch.where(face == k, values[k], out)
    return out


def skybox_color(sky_faces, sky_res, direction):
    """Reference-convention lookup for rays (..., 3) -> colors (..., 3)."""
    x, y, z = direction[..., 0], direction[..., 1], direction[..., 2]
    ax, ay, az = x.abs(), y.abs(), z.abs()

    def pick(cond, a, b):
        return torch.where(cond, torch.as_tensor(a, device=x.device),
                           torch.as_tensor(b, device=x.device))

    xy_face = torch.where(ax > ay, pick(x >= 0, LEFT, RIGHT),
                          pick(y >= 0, TOP, BOTTOM))
    xy_ma = torch.where(ax > ay, ax, ay)
    face = torch.where(az > xy_ma, pick(z >= 0, FRONT, BACK), xy_face)
    ma = torch.where(az > xy_ma, az, xy_ma)

    # per-face (sc, tc) mapping (scene.cpp:407-438)
    sc = _select(face, [-z, z, -x, -x, -x], x)
    tc = _select(face, [y, y, -z, z, y], y)

    inv_ma = 1.0 / ma
    s = (sc * inv_ma + 1.0) / 2.0
    t = (tc * inv_ma + 1.0) / 2.0

    width, height = _face_res(sky_res, face)
    xp = ((width - 1).to(torch.float32) * s).to(torch.int32)
    yp = ((height - 1).to(torch.float32) * t).to(torch.int32)
    xp = torch.minimum(torch.clamp(xp, min=0), width - 1)
    yp = torch.minimum(torch.clamp(yp, min=0), height - 1)
    return _fetch(sky_faces, face, yp, xp)


def _face_res(sky_res, face):
    """Per-lane (width, height) of the lane's face."""
    wh = sky_res.to(torch.int32)[face.long()]
    return wh[..., 0], wh[..., 1]


def _fetch(sky_faces, face, yp, xp):
    """One flat single-index row gather.  Faces are padded to a common
    (H, W), so the flat index is exact for every face."""
    Hp, Wp = sky_faces.shape[1], sky_faces.shape[2]
    idx = face.long() * (Hp * Wp) + yp.long() * Wp + xp.long()
    return sky_faces.reshape(-1, 3)[idx]


def gl_cubemap_color(sky_faces, sky_res, direction):
    """Standard OpenGL cubemap fetch (for the GLSL path tracer's iChannel1).

    Face order is +X,-X,+Y,-Y,+Z,-Z in ``sky_faces``; nearest fetch.
    """
    x, y, z = direction[..., 0], direction[..., 1], direction[..., 2]
    ax, ay, az = x.abs(), y.abs(), z.abs()

    is_x = (ax >= ay) & (ax >= az)
    is_y = (ay > ax) & (ay >= az)

    def pick(cond, a, b):
        return torch.where(cond, torch.as_tensor(a, device=x.device),
                           torch.as_tensor(b, device=x.device))

    face = torch.where(is_x, pick(x > 0, 0, 1),
                       torch.where(is_y, pick(y > 0, 2, 3),
                                   pick(z > 0, 4, 5)))
    ma = torch.where(is_x, ax, torch.where(is_y, ay, az))

    sc = _select(face, [-z, z, x, x, x], -x)
    tc = _select(face, [-y, -y, z, -z, -y], -y)
    inv_ma = 1.0 / ma
    s = (sc * inv_ma + 1.0) * 0.5
    t = (tc * inv_ma + 1.0) * 0.5
    width, height = _face_res(sky_res, face)
    xp = (width.to(torch.float32) * s).to(torch.int32)
    yp = (height.to(torch.float32) * t).to(torch.int32)
    xp = torch.minimum(torch.clamp(xp, min=0), width - 1)
    yp = torch.minimum(torch.clamp(yp, min=0), height - 1)
    return _fetch(sky_faces, face, yp, xp)
