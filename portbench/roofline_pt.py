"""K6's least time: the operations and bytes of the path tracer's bounce
kernel (``pt_bounce``) for the work a frame needs, counted from the
reference path tracer's live paths of the same inputs
(``portbench.reference.pt``, its ``counts``), at the peaks of
``portbench.roofline``.

FP32 operations (add, sub, mul, div, sqrt, min, max: one each; compares
and selects not counted) of one primitive test, frozen from the program's
kernel source as its chip smoke counted them: a triangle 46; a sphere
whose discriminant is non-negative 28, one that returns at a negative
discriminant 20; a moving sphere 53 and 45.  A fold (a live path's
closest hit, or one shadow ray) adds the ray's d.d once, 5.  A bounce
tests every primitive for each live path's closest hit, and for each
point light that a hit faces, the primitives in table order up to the
first occluder.  Only the tests are counted (not the shading, the
scatter nor the roulette), which keeps the bound a floor.

Bytes: a live path's state read and written (``STATE_ROWS`` f32 each
way) and its uniform rows read (``UNIFORM_ROWS`` f32); the primitive
table (12 f32 a row), the material rows (16 f32 a primitive) and the
point lights (6 f32) once a bounce: a bounce read in several launches
reads them again, which the floor leaves out.

A kernel that culled primitives would need fewer tests than these
inputs need under brute force: the count would then be stale, and only
a change to the benchmark may correct it.
"""

from __future__ import annotations

from portbench import roofline

# (triangle, sphere, moving sphere) with a non-negative discriminant, and
# with a negative one
TEST_OPS = (46, 28, 53)
MISS_TEST_OPS = (46, 20, 45)
FOLD_OPS = 5
STATE_ROWS, UNIFORM_ROWS = 20, 8
PRIM_ROW, MAT_ROW, LIGHT_ROW = 12, 16, 6


def ops(c):
    """FP32 operations of one bounce's counts ``c``."""
    return (c["tri"] * TEST_OPS[0] + c["sph"] * TEST_OPS[1]
            + c["sph_miss"] * MISS_TEST_OPS[1] + c["msph"] * TEST_OPS[2]
            + c["msph_miss"] * MISS_TEST_OPS[2] + c["folds"] * FOLD_OPS)


def nbytes(c, n_prims, n_lights):
    """Bytes of one bounce's counts ``c``."""
    return 4 * (c["paths"] * (2 * STATE_ROWS + UNIFORM_ROWS)
                + n_prims * (PRIM_ROW + MAT_ROW) + n_lights * LIGHT_ROW)


def k6_bound_s(counts, n_prims, n_lights):
    """The bounce kernel's least seconds for the reference's ``counts``
    (per bounce), summed over the bounces that have live paths."""
    return sum(roofline.bound_s(nbytes(c, n_prims, n_lights), float(ops(c)))
               for c in counts.values() if c["paths"])
