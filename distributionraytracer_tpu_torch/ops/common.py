"""Small batched vector helpers (counterpart of ``ops/common.py``).

Everything operates on ``(..., 3)`` float32 tensors; the last axis is xyz.
``EPSILON`` matches the reference (macros.h:1).
"""

from __future__ import annotations

import numpy as np
import torch

EPSILON = 1e-3
FLT_MAX = float(np.float32(3.402823466e38))
OFFSET = 1e-4  # secondary and shadow ray origin offset (main.cpp:378)


def dot(a, b):
    return torch.sum(a * b, dim=-1)


def cross(a, b):
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b)


def length(a):
    return torch.sqrt(dot(a, a))


def normalize(a):
    """Plain normalize; NaN/inf on zero vectors like ``Vector::normalize``."""
    return a / length(a)[..., None]


def safe_normalize(a, eps=1e-20):
    """Normalize with a zero-safe denominator (zero vectors stay zero)."""
    l2 = dot(a, a)
    ok = l2 > eps
    safe = torch.where(ok, l2, torch.ones_like(l2))
    return torch.where(ok[..., None], a / torch.sqrt(safe)[..., None],
                       torch.zeros_like(a))


def safe_sqrt(x, eps=0.0):
    """sqrt that returns ``eps`` for non-positive inputs."""
    ok = x > 0
    return torch.where(ok, torch.sqrt(torch.where(ok, x, torch.ones_like(x))),
                       torch.full_like(x, eps))


def safe_div(a, b, eps=1e-20):
    ok = torch.abs(b) > eps
    return torch.where(ok, a / torch.where(ok, b, torch.ones_like(b)),
                       torch.zeros_like(a))


def clamp_color(c):
    """``Color::clamp`` to [0,1] (color.h:38-43)."""
    return torch.clamp(c, 0.0, 1.0)


def u8fromfloat(x):
    """float -> byte with the reference's x*255.99 saturate (maths.h:126-130)."""
    v = x * 255.99
    return torch.where(v >= 255.0, 255, v.to(torch.uint8)).to(torch.uint8)
