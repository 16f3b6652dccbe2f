"""``RenderConfig.accel_backend`` and ``accel_intersectors``' table types.

- ``accel_backend``: its validation; the routes and labels it selects in
  ``Renderer`` for grid and BVH scenes (``grid-dda`` / ``bvh-threaded``
  under ``'traversal'``, the JAX package's ``grid-xla`` / ``bvh-xla``; the
  kernel routes under ``'auto'``); the traversal route's
  image equal to ``render_from_samples`` through the traversal itself
  (atol 1e-6) and within the reference's image budget
  (``assert_images_close``) of the kernel route's.
- ``accel_intersectors`` raising TypeError on tables of another type.
"""

import dataclasses

import numpy as np
import pytest
import torch

from distributionraytracer_tpu.config import RenderConfig as JaxConfig
from distributionraytracer_tpu.renderer import Renderer as JaxRenderer
from distributionraytracer_tpu.scene.builder import (
    SceneBuilder as JaxSceneBuilder,
)
from distributionraytracer_tpu_torch.accel import bvh as tbvh
from distributionraytracer_tpu_torch.config import RenderConfig
from distributionraytracer_tpu_torch.integrator.render import (
    render_from_samples,
)
from distributionraytracer_tpu_torch.parallel.mesh import accel_intersectors
from distributionraytracer_tpu_torch.renderer import Renderer
from distributionraytracer_tpu_torch.scene.types import (
    ACCEL_BVH, ACCEL_GRID,
)

from test_torch_render import shared_samples
from test_whitted import assert_images_close, small_scene
from torch_port_util import to_port, torch_samples
from torch_scenes import mesh_scene

torch.set_num_threads(1)


def test_accel_backend_routes_and_labels():
    with pytest.raises(ValueError, match="accel_backend"):
        RenderConfig(accel_backend="xla")
    samples = None
    for accel, kernel_label, label, jax_label in (
            (ACCEL_GRID, "binned-primary+grid-packet", "grid-dda",
             "grid-xla"),
            (ACCEL_BVH, "binned-primary+grouped-packet", "bvh-threaded",
             "bvh-xla")):
        js = mesh_scene(JaxSceneBuilder, n_tri=2000, accel=accel,
                        res=(16, 16), ground="box")
        ps = to_port(js)
        if samples is None:
            samples = torch_samples(shared_samples(js, 1, seed=3))
        assert JaxRenderer(js, JaxConfig(spp=0, accel_backend="xla")
                           ).executed_backend() == jax_label
        imgs = {}
        for backend in ("auto", "traversal"):
            cfg = RenderConfig(spp=0, accel_backend=backend)
            r = Renderer(ps, cfg, device="cpu")
            assert r.executed_backend() == (label if backend == "traversal"
                                            else kernel_label)
            imgs[backend] = r.render_with_samples(samples)
        # the traversal route is the traversal, tiles and all
        cfg = RenderConfig(spp=0)
        ref = render_from_samples(ps, cfg, samples, inter=accel_intersectors(
            ps, cfg, r.accel_build.host))
        np.testing.assert_allclose(imgs["traversal"].numpy(), ref.numpy(),
                                   rtol=0, atol=1e-6)
        assert_images_close(imgs["traversal"].numpy(), imgs["auto"].numpy())
        # a cost-brute sized scene keeps the traversal under 'traversal'
        small = mesh_scene(JaxSceneBuilder, n_tri=200, accel=accel,
                           res=(8, 8), ground="box")
        assert Renderer(to_port(small), RenderConfig(spp=0),
                        device="cpu").executed_backend() == "cost-brute"
        assert Renderer(to_port(small), RenderConfig(
            spp=0, accel_backend="traversal"),
            device="cpu").executed_backend() == label


def test_unknown_tables_raise_type_error():
    ps = to_port(dataclasses.replace(small_scene(), static=dataclasses.replace(
        small_scene().static, accel=ACCEL_BVH)))
    cfg = RenderConfig(spp=1)
    for tables in (object(), tbvh.build_bvh(ps)):  # BVHArrays: tests only
        for diff in (False, True):
            with pytest.raises(TypeError, match="unknown accel tables"):
                accel_intersectors(ps, cfg, tables, differentiable=diff)
