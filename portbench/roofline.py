"""The yardstick's peaks and the operations and bytes of the work a cell
needs, counted from the reference's ray tree of the same inputs.

Peaks: one NVIDIA H100 SXM at its 700 W limit (NVIDIA's data sheet):
67 TFLOP/s FP32 outside the tensor cores and 3.35 TB/s of HBM3.

FP32 operations (add, sub, mul, div, sqrt, min, max: one each; compares and
selects not counted) of one object test, frozen from the program's kernel
sources as its chip smoke counted them: a sphere test whose discriminant is
non-negative 28, one that returns at a negative discriminant 20, a
triangle 46; a fold (a lane's closest hit, or its shadow ray) adds the
ray's d.d once, 5.  A fused Whitted level kernel tests every object for a
lane's closest hit and each shadow ray's objects in object order up to its
first occluder, skipping the shaded object.  Counting the tests alone keeps
the bound a floor.  A kernel that culls objects would need fewer tests
than these inputs need under brute force: the count would then be stale,
and only a change to the benchmark may correct it.
"""

from __future__ import annotations

import torch

MEM_BPS = 3.35e12
FP32_OPS = 67e12
SPHERE_OPS, SPHERE_MISS_OPS, TRI_OPS, FOLD_OPS = 28, 20, 46, 5

# A fused level reads a live lane's origin, direction, time, index of
# refraction, light sample and valid flag (11 f32) and writes the direct
# light and hit flag (4 f32), with both children's records on a level that
# spawns (29 f32 in all).  Its object rows (12 f32), type (i32) and
# material (13 f32), and its lights (9 f32 and a flag) are read once.
K3_IN, K3_OUT_SPAWN, K3_OUT_LEAF = 44, 116, 16
K3_OBJECT, K3_LIGHT = 104, 40
# A closest-hit query reads a ray's origin and direction and writes t, the
# normal and the object id; a shadow query reads origin, direction and
# distance and writes one flag.  An object's row is 12 f32.
CLOSEST_IN, CLOSEST_OUT, SHADOW_IN, SHADOW_OUT, OBJECT_ROW = 24, 20, 28, 1, 48


def sphere_ops(real):
    """Operations of every (ray, sphere) test; ``real``: discriminant >= 0."""
    return torch.where(real, float(SPHERE_OPS),
                       float(SPHERE_MISS_OPS)).sum(dtype=torch.float64)


def shadow_sphere_ops(real, hit, excluded):
    """Operations of shadow folds over spheres in object order: each ray
    tests up to its first occluder (all when none), not the object it
    skips, and takes its d.d once."""
    ops = torch.where(real, float(SPHERE_OPS), float(SPHERE_MISS_OPS))
    ops = torch.where(excluded, 0.0, ops).double().cumsum(1)
    last = torch.where(hit.any(1), hit.to(torch.int8).argmax(1),
                       hit.shape[1] - 1)
    return (ops.gather(1, last[:, None])[:, 0] + FOLD_OPS).sum()


def bound_s(nbytes, ops):
    """Least seconds: bytes over the memory rate or operations over the
    FP32 rate, whichever is longer."""
    return max(nbytes / MEM_BPS, ops / FP32_OPS)


def k3_bound_s(counts, max_depth, n_obj, n_lights):
    """The fused level kernel's least seconds for a reference tree's
    ``counts`` (per level: rays, shadow rays, operations), summed over the
    levels."""
    tables = n_obj * K3_OBJECT + n_lights * K3_LIGHT
    total = 0.0
    for level, c in counts.items():
        out = K3_OUT_SPAWN if level < max_depth else K3_OUT_LEAF
        nbytes = c["rays"] * (K3_IN + out) + tables
        total += bound_s(nbytes, float(c["closest_ops"])
                         + float(c["shadow_ops"]))
    return total


def accel_bytes_s(counts, n_obj):
    """A traversal's byte floor for a reference tree's ``counts``: each
    live ray's inputs read and outputs written once, and every object row
    once per level and query kind that has rays."""
    nbytes = 0
    for c in counts.values():
        nbytes += c["rays"] * (CLOSEST_IN + CLOSEST_OUT) + n_obj * OBJECT_ROW
        if c["shadow_rays"]:
            nbytes += (c["shadow_rays"] * (SHADOW_IN + SHADOW_OUT)
                       + n_obj * OBJECT_ROW)
    return nbytes / MEM_BPS
