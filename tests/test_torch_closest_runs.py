"""K1's fold over its type runs (``ops/cuda_intersect.py::
closest_hit_runs``), held to the port's ``closest_hit_brute`` and to the JAX
package's ``closest_hit_brute`` and interpret-mode ``closest_hit_pallas``,
so that no behaviour of K1's tie rule lives only in the CUDA kernel.

K1 tests the objects in type runs (spheres, then triangles, planes, boxes)
and settles a tie in t by the lower object id, which gives the
insertion-order scan's first-wins winner.  The scenes hold such ties:
every sphere and triangle listed twice (the copies later, in other
materials), every object twice, and objects of every type meeting in one
plane, listed so that the lower id lies in a later run.  The card tests
(``test_torch_cuda.py``) hold the kernel to ``closest_hit_runs`` on every
lane.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributionraytracer_tpu.ops import intersect as jax_intersect
from distributionraytracer_tpu.ops import pallas_intersect as PI
from distributionraytracer_tpu.scene.builder import (
    SceneBuilder as JaxSceneBuilder,
)
from distributionraytracer_tpu.scene.procedural import (
    create_random_scene as jax_random_scene,
)
from distributionraytracer_tpu_torch.ops import cuda_intersect as CI
from distributionraytracer_tpu_torch.ops.intersect import closest_hit_brute

from torch_port_util import prim_scene, to_port
from torch_scenes import random_rays, tie_rays, tie_scene

torch.set_num_threads(1)

N_RAYS = 384

# JAX scenes and their rays: the built-in random scene (102 spheres), every
# sphere and triangle twice, every object twice, and exact ties across the
# type runs
SCENES = {
    "random": (lambda: jax_random_scene(0, 16, 12),
               lambda: random_rays(N_RAYS, seed=31, spread=5.0)),
    "mixed-ties": (lambda: prim_scene(ties=True),
                   lambda: random_rays(N_RAYS, seed=32)),
    "mixed-twice": (lambda: prim_scene(twice=True),
                    lambda: random_rays(N_RAYS, seed=33)),
    "tie-runs": (lambda: tie_scene(JaxSceneBuilder),
                 lambda: tie_rays(N_RAYS, seed=34)),
}


@pytest.mark.parametrize("mb", [False, True], ids=["static", "motion"])
@pytest.mark.parametrize("name", sorted(SCENES))
def test_run_fold_matches_plain_and_jax(name, mb):
    """The closest hit over the type runs equals the port's
    closest_hit_brute (object ids and t on every ray) and the JAX
    package's interpret-mode closest_hit_pallas and jnp brute scan
    (object ids on every ray, t within test_torch_intersect's 1e-4
    relative and absolute: XLA's rounding of the sphere quadratic)."""
    make_scene, make_rays = SCENES[name]
    js = make_scene()
    scene = to_port(js)
    o, d, t = make_rays()
    to = lambda a: torch.from_numpy(a)
    rt, rid = CI.closest_hit_runs(CI.object_tables(scene), to(o), to(d),
                                  to(t), mb)
    rt, rid = rt.numpy(), rid.numpy()
    brute = closest_hit_brute(scene, to(o), to(d), to(t), mb)
    hit = rid >= 0
    assert 0.2 < hit.mean() < 0.99
    np.testing.assert_array_equal(rid, brute.obj_id.numpy())
    np.testing.assert_array_equal(rt, brute.t.numpy())
    s = js.device_put()
    for ref in (PI.closest_hit_pallas(s, o, d, t, mb, interpret=True),
                jax_intersect.closest_hit_brute(
                    s, jnp.asarray(o), jnp.asarray(d), jnp.asarray(t), mb)):
        np.testing.assert_array_equal(rid, np.asarray(ref.obj_id))
        np.testing.assert_allclose(rt[hit], np.asarray(ref.t)[hit],
                                   rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("mb", [False, True], ids=["static", "motion"])
def test_run_fold_ties_take_the_lowest_id(mb):
    """On the tie scene, rays straight down meet the box (id 0), the
    triangle (2) and the plane (3) at t = 5: the box wins, though its run
    comes last.  Under motion blur the spheres rise by the ray's time, and
    of the two copies (1 and 4) the first wins; without it, a ray through
    their centre meets them at t = 5 too, where the box wins."""
    scene = to_port(tie_scene(JaxSceneBuilder))
    o, d, t = (torch.from_numpy(a) for a in tie_rays(N_RAYS, seed=35))
    rt, rid = CI.closest_hit_runs(CI.object_tables(scene), o, d, t, mb)
    k = N_RAYS // 3
    grid_x, grid_z = o[:k, 0], o[:k, 2]
    inside = (grid_x.abs() < 1) & (grid_z.abs() < 1)
    centre = slice(k, 2 * k)
    assert not bool((rid == 4).any())
    if mb:
        assert bool((rid[centre] == 1).all())
        assert bool((rt[centre][t[centre] > 0] < 5.0).all())
    else:
        assert bool((rid[centre] == 0).all())
        assert bool((rt[:2 * k] == 5.0).all())
    # a grid ray meets the box at t = 5 inside its footprint and the plane
    # outside it (the spheres under motion blur may rise above both)
    sph = (rid[:k] == 1) & mb
    assert bool(((rid[:k] == 0) | sph)[inside].all())
    assert bool(((rid[:k] == 3) | sph)[~inside].all())
