"""Skybox cubemap loading (counterpart of ``distributionraytracer_tpu.scene.skybox``).

The reference decodes 6 jpgs (right/left/top/bottom/front/back) with DevIL at
lower-left origin (scene.cpp:329-378).  Here PIL decodes them into one padded
``(6, H, W, 3)`` float32 array (u8 / 255.99, maths.h:133-136) plus a per-face
``(6, 2)`` (width, height) table so faces of different sizes coexist.  PIL is
imported only here, when a skybox is loaded.
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np

# Face order matches the CubeMap enum (scene.h:19)
FACE_FILES = ["right.jpg", "left.jpg", "top.jpg", "bottom.jpg",
              "front.jpg", "back.jpg"]


def load_skybox(sky_dir: str) -> Tuple[np.ndarray, np.ndarray]:
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(
            "loading a skybox needs PIL (the Pillow package) to decode its "
            f"JPEG faces; it is not installed (skybox dir {sky_dir!r})") from e

    imgs = []
    for name in FACE_FILES:
        img = Image.open(os.path.join(sky_dir, name)).convert("RGB")
        a = np.asarray(img, np.uint8)
        # DevIL loads with lower-left origin (scene.cpp:345-346); PIL gives
        # upper-left, so flip vertically.
        imgs.append(a[::-1].copy())
    H = max(a.shape[0] for a in imgs)
    W = max(a.shape[1] for a in imgs)
    faces = np.zeros((6, H, W, 3), np.float32)
    res = np.zeros((6, 2), np.int32)
    for i, a in enumerate(imgs):
        # u8tofloat: x / 255.99 (maths.h:133-136)
        faces[i, : a.shape[0], : a.shape[1]] = a.astype(np.float32) / 255.99
        res[i] = (a.shape[1], a.shape[0])  # (width, height)
    return faces, res
