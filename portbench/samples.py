"""The inputs the benchmark makes from ``--seed`` and hands to both the
program and the reference: pixel samples and camera paths."""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench.harness import derive_seed


def stratified(seed, H, W, S, device):
    """(H, W, S, 2) jittered samples of an n x n stratification of each
    pixel (main.cpp:626-633): sample p in cell (p % n, p // n)."""
    n = math.isqrt(S)
    if n * n != S:
        raise ValueError(f"spp {S} is not a square")
    g = torch.Generator(device=device).manual_seed(seed)
    eps = torch.rand((H, W, S, 2), generator=g, device=device)
    p = torch.arange(S, device=device)
    cell = torch.stack([p % n, p // n], -1).to(torch.float32)
    return (cell + eps) / n


def centred(H, W, device):
    """(H, W, 1, 2) samples at the pixel centres (the no-AA branch,
    main.cpp:674-703)."""
    return torch.full((H, W, 1, 2), 0.5, device=device)


def frame_pixels(cfg, seed, i, device):
    """Frame ``i``'s pixel samples: fresh stratified ones drawn from the
    seed and the frame's index where the configuration antialiases, the
    pixel centres where its spp is 0."""
    H, W, S = cfg["res_y"], cfg["res_x"], cfg["spp"]
    if S > 0:
        return stratified(derive_seed(seed, 1, i), H, W, S, device)
    return centred(H, W, device)


def orbit_eye(eye, at, degrees):
    """``eye`` turned by ``degrees`` about the vertical axis through
    ``at``: the same radius and height."""
    a = math.radians(degrees)
    rel = np.asarray(eye, np.float64) - np.asarray(at, np.float64)
    x = rel[0] * math.cos(a) + rel[2] * math.sin(a)
    z = -rel[0] * math.sin(a) + rel[2] * math.cos(a)
    return (np.asarray(at, np.float64) + [x, rel[1], z]).astype(np.float32)


def viewer_eye(alpha, beta, r):
    """The viewer's orbit camera (main.cpp:811-895): degrees ``alpha``,
    ``beta`` and radius ``r`` about the origin."""
    a, b = math.radians(alpha), math.radians(beta)
    return np.array([r * math.sin(a) * math.cos(b), r * math.sin(b),
                     r * math.cos(a) * math.cos(b)], np.float32)


def cameras(seed, eye, offsets, every, count):
    """(alpha, beta, r) of requests 0..count-1: the scene camera's
    spherical coordinates moved by one of ``offsets`` ((alpha, beta)
    degrees) every ``every`` requests.  Every seed visits the same
    positions, each for ``every`` requests, cycling through them in an
    order the seed draws."""
    r = float(np.linalg.norm(eye))
    beta = math.degrees(math.asin(eye[1] / r))
    alpha = math.degrees(math.atan(eye[0] / eye[2]))
    order = np.random.default_rng(derive_seed(seed, 8)).permutation(
        len(offsets))
    out = []
    for k in range(count):
        da, db = offsets[order[(k // every) % len(offsets)]]
        out.append((round(alpha + da, 3), round(beta + db, 3), round(r, 3)))
    return out
