"""K2's type-run tables (``ops/cuda_intersect.py::type_runs``) and the plain
torch fold over them (``any_hit_runs``), held to the port's
``any_hit_brute`` and to the JAX package's ``any_hit_brute`` and
interpret-mode ``any_hit_pallas``, so that no behaviour of the tables lives
only in the CUDA kernel."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributionraytracer_tpu.ops import intersect as jax_intersect
from distributionraytracer_tpu.ops import pallas_intersect as PI
from distributionraytracer_tpu.scene.procedural import (
    create_random_scene as jax_random_scene,
)
from distributionraytracer_tpu_torch.ops import cuda_intersect as CI
from distributionraytracer_tpu_torch.ops.intersect import any_hit_brute
from distributionraytracer_tpu_torch.scene.types import (
    OBJ_BOX, OBJ_PLANE, OBJ_SPHERE, OBJ_TRIANGLE,
)

from torch_port_util import prim_scene, to_port
from torch_scenes import occlusion_inputs

torch.set_num_threads(1)

N_RAYS = 512

# JAX scenes: the built-in random scene (102 spheres, 3 point lights) and
# the scene of every primitive type, once and with every object twice
SCENES = {
    "random": lambda: jax_random_scene(0, 16, 12),
    "mixed": lambda: prim_scene(),
    "mixed-twice": lambda: prim_scene(twice=True),
}


@pytest.mark.parametrize("name", sorted(SCENES))
def test_type_runs_layout(name):
    """Runs in the order sphere, triangle, plane, box, each in insertion
    order; spheres as 16-byte [c, r] rows, the others as their 12-float
    packed rows; each row's object id; every row 16-byte aligned."""
    scene = to_port(SCENES[name]())
    tb = CI.object_tables(scene)
    types = np.array(scene.static.obj_types)
    assert CI.RUN_TYPES == (OBJ_SPHERE, OBJ_TRIANGLE, OBJ_PLANE, OBJ_BOX)
    assert tb.counts == tuple(int((types == t).sum()) for t in CI.RUN_TYPES)
    assert tb.runs.dtype == torch.float32 and tb.ids.dtype == torch.int32
    assert tb.ids.tolist() == [int(k) for t in CI.RUN_TYPES
                               for k in np.nonzero(types == t)[0]]
    offset = 0
    for typ, rows, ids in CI.run_rows(tb):
        assert offset % 4 == 0  # 16 bytes
        width = 4 if typ == OBJ_SPHERE else 12
        assert rows.shape == (int((types == typ).sum()), width)
        assert torch.equal(rows, tb.data[ids.long(), :width])
        offset += rows.numel()
    assert offset == tb.runs.numel()
    if name == "random":
        assert tb.counts == (102, 0, 0, 0)
    else:
        assert min(tb.counts) >= 2


@pytest.mark.parametrize("mode", ["none", "grid", "bvh"])
@pytest.mark.parametrize("name", sorted(SCENES))
def test_run_fold_matches_plain_and_jax(name, mode):
    """The fold over the type runs equals the port's any_hit_brute and the
    JAX package's any_hit_brute and interpret-mode any_hit_pallas on every
    ray, excluded ids included (the JAX brute scan in mode none, the only
    compare it has)."""
    js = SCENES[name]()
    scene = to_port(js)
    o, d, dist, ex = occlusion_inputs(scene.static.n_objects, N_RAYS, 74)
    occ = CI.any_hit_runs(CI.object_tables(scene), torch.from_numpy(o),
                          torch.from_numpy(d), torch.from_numpy(dist),
                          torch.from_numpy(ex), mode).numpy()
    brute = any_hit_brute(scene, torch.from_numpy(o), torch.from_numpy(d),
                          torch.zeros(N_RAYS), torch.from_numpy(dist),
                          torch.from_numpy(ex), False, mode=mode).numpy()
    jp = np.asarray(PI.any_hit_pallas(js.device_put(), o, d, dist, ex, False,
                                      interpret=True, mode=mode))
    assert 0.05 < occ.mean() < 0.95
    np.testing.assert_array_equal(occ, brute)
    np.testing.assert_array_equal(occ, jp)
    if mode == "none":  # the JAX package's brute scan has the NONE compare
        jb = np.asarray(jax_intersect.any_hit_brute(
            js.device_put(), jnp.asarray(o), jnp.asarray(d),
            jnp.zeros(N_RAYS), jnp.asarray(dist), jnp.asarray(ex), False))
        np.testing.assert_array_equal(occ, jb)
