"""The reference of the path tracer's progressive viewer: each request's
frame redrawn from the viewer's own generator, traced by the reference
path tracer (``reference.pt``), and held as the viewer holds it, a
running mean in linear float32 shown through gamma 2.2.

The viewer draws frame ``j``'s numbers from one ``torch.Generator`` on
its device seeded ``(seed << 32) + j``, in the program's documented order
(its ``render_pt`` and ``draw_bounces``): the pixel jitter (H, W, S, 2),
the camera rays' times (H, W, S), then for each tile of ``tile`` paths
in turn (the last shorter) and each bounce in turn the five uniforms
``uq`` (n, 2), ``uch`` (n,), ``u3a`` (n, 3), ``u3b`` (n, 3) and ``urr``
(n,).  Its orbit camera (main.cpp:811-895, with the path tracer's world
up +y and the scene's look-at point) stands at ``at + (r sin(alpha)
cos(beta), r sin(beta), -r cos(alpha) cos(beta))``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench.reference import pt as ref

GAMMA = 1.0 / 2.2
QUAD_UNIFORMS = 2  # uq's width: the scene has no quad light, one is drawn


def eye(at, alpha, beta, r):
    """The orbit camera's position, in float32 as the viewer keeps it."""
    a, b = math.radians(alpha), math.radians(beta)
    return np.asarray(at, np.float32) + np.array(
        [r * math.sin(a) * math.cos(b), r * math.sin(b),
         -r * math.cos(a) * math.cos(b)], np.float32)


def draws(seed, j, H, W, S, B, tile, device):
    """(jitter, time, ``ref.Uniforms`` over the frame's H * W * S paths)
    of frame ``j``, drawn as the module says."""
    g = torch.Generator(device=device).manual_seed((seed << 32) + j)
    u = lambda *shape: torch.rand(shape, generator=g, device=device)
    jitter, times = u(H, W, S, 2), u(H, W, S)
    R = H * W * S
    cols = [[] for _ in range(5)]
    for a in range(0, R, tile):
        n = min(a + tile, R) - a
        per = [[] for _ in range(5)]
        for _ in range(B):
            for k, x in enumerate((u(n, QUAD_UNIFORMS), u(n), u(n, 3),
                                   u(n, 3), u(n))):
                per[k].append(x)
        for k in range(5):
            cols[k].append(torch.stack(per[k]))
    return jitter, times, ref.Uniforms(*(torch.cat(c, 1) for c in cols))


def accumulator(rs, cfg, view, cam, seed, first, k, pick, tile,
                max_bounces=None, boost=True):
    """(n, 3) float32 of the viewer's displayed accumulator after request
    ``k`` at pixels ``pick`` (rows, columns; row 0 at the bottom): the
    running mean of frames ``first + 1`` to ``k + 1`` (the window's
    request i draws frame i + 1) at camera ``cam`` (alpha, beta, r), as
    linear float32, clipped at 0 and raised to 1 / 2.2.  ``view`` holds
    the orbit's look-at point ``at`` and ``fovy``; ``max_bounces`` and
    ``boost`` give the control's faults."""
    H, W, S = cfg["res_y"], cfg["res_x"], 1
    bounces = cfg["max_bounces"] if max_bounces is None else max_bounces
    camera = ref.Camera(eye(view["at"], *cam), view["at"], view["fovy"], W,
                        H)
    mean, count = None, 0.0
    for j in range(first + 1, k + 2):
        drawn = draws(seed, j, H, W, S, cfg["max_bounces"], tile, rs.device)
        with torch.no_grad():
            img = ref.render_pixels(rs, camera, *pick, *drawn, bounces,
                                    cfg["russian_roulette"], boost=boost)
        img = img.float().cpu().numpy()
        if mean is None:
            mean = np.zeros_like(img)
        n2 = count + S
        mean = mean + (img - mean) * (S / n2)
        count = n2
    return np.clip(mean, 0.0, None) ** GAMMA
