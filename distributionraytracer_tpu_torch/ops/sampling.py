"""Sampling for the distribution effects (counterpart of ``ops/sampling.py``).

Every random quantity comes from an explicit ``torch.Generator`` with
analytic disk sampling (polar transform, common.glsl:95-100).  The numbers
differ from the JAX package's threefry streams; tests feed both packages
the same explicit sample arrays instead.  Draws happen on the generator's
device.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def uniform(generator: torch.Generator, shape):
    return torch.rand(shape, generator=generator, device=generator.device,
                      dtype=torch.float32)


def unit_disk(generator: torch.Generator, shape):
    """Uniform on the unit disk, polar method (common.glsl:95-100)."""
    u = uniform(generator, tuple(shape) + (2,))
    r = torch.sqrt(u[..., 0])
    phi = u[..., 1] * (2.0 * math.pi)
    return torch.stack([r * torch.sin(phi), r * torch.cos(phi)], dim=-1)


def unit_sphere(generator: torch.Generator, shape):
    """Uniform inside the unit ball, polar method (common.glsl:102-108)."""
    h = uniform(generator, tuple(shape) + (3,))
    cos_theta = h[..., 0] * 2.0 - 1.0
    phi = h[..., 1] * (2.0 * math.pi)
    r = h[..., 2] ** (1.0 / 3.0)
    sin_theta = torch.sqrt(torch.clamp(1.0 - cos_theta * cos_theta, min=0.0))
    return r[..., None] * torch.stack(
        [sin_theta * torch.sin(phi), sin_theta * torch.cos(phi), cos_theta],
        dim=-1)


def unit_vector(generator: torch.Generator, shape):
    """Uniform direction (normalize of ball sample, common.glsl:110-113)."""
    v = unit_sphere(generator, shape)
    return v / torch.linalg.norm(v, dim=-1, keepdim=True)


def stratified_jitter(generator: torch.Generator, spp: int, shape):
    """n x n stratified jittered samples in [0,1)^2 (main.cpp:626-633).

    Returns ``shape + (spp, 2)``; sample p sits in cell (p % n, p // n).
    """
    n = int(spp ** 0.5)
    if n * n != spp:
        n = max(n, 1)
    eps = uniform(generator, tuple(shape) + (spp, 2))
    p = np.arange(spp)
    cell = torch.as_tensor(
        np.stack([p % n, p // n], axis=-1).astype(np.float32),
        device=eps.device)
    return (cell + eps) / n


def light_jitter_shuffled(generator: torch.Generator, spp: int, shape):
    """spp jittered light samples, shuffled per pixel (main.cpp:635-648)."""
    s = uniform(generator, tuple(shape) + (spp, 2))
    noise = uniform(generator, tuple(shape) + (spp,))
    order = torch.argsort(noise, dim=-1)
    return torch.take_along_dim(s, order[..., None], dim=-2)


def regular_grid(grid_res: int) -> np.ndarray:
    """gridRes regular light samples for the no-AA quad-light path
    (main.cpp:687-692): u = (s % g + .5)/g, v = (s // g + .5)/g."""
    g = int(grid_res ** 0.5)
    s = np.arange(grid_res)
    u = ((s % g + 0.5) / g).astype(np.float32)
    v = ((s // g + 0.5) / g).astype(np.float32)
    return np.stack([u, v], axis=-1)
