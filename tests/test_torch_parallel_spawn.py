"""Two gloo processes on the CPU (``test_torch_parallel.spawn``), split
from ``test_torch_parallel.py`` to keep each file's wall time short.

- The sharded render equal to the single-process
  ``render_from_samples(..., inter=accel_intersectors(...))`` on every
  rank (atol 1e-6): accel NONE on ``prim_scene``; ``mesh_scene`` (1,000
  triangles, 16x13, so that the rows pad) with a grid and a BVH, on the
  host tables (the DDA, the threaded walk) and the packet tables (the
  kernels' plain versions).  ``test_parallel.py``'s
  ``test_sharded_render_matches_single`` and
  ``test_sharded_accel_render_matches_single``.
- ``test_sharded_accel_train_step``'s check on a grid scene's
  ``CudaGrid`` tables: the loss falls at each of 4 steps.
"""

import dataclasses

import numpy as np
import pytest
import torch

from distributionraytracer_tpu_torch.config import RenderConfig
from distributionraytracer_tpu_torch.integrator.render import (
    make_samples, render_from_samples,
)
from distributionraytracer_tpu_torch.parallel.mesh import accel_intersectors
from distributionraytracer_tpu_torch.renderer import Renderer
from distributionraytracer_tpu_torch.scene import SceneBuilder
from distributionraytracer_tpu_torch.scene.types import ACCEL_BVH, ACCEL_GRID

from test_torch_parallel import mesh, spawn
from torch_scenes import prim_scene

torch.set_num_threads(1)


RENDER_CASES = {
    # case: (scene, table type)
    "none": (lambda: prim_scene(SceneBuilder), None),
    "grid-dda": (lambda: mesh(ACCEL_GRID), "host"),
    "grid-packet": (lambda: mesh(ACCEL_GRID), "tabs"),
    "bvh-threaded": (lambda: mesh(ACCEL_BVH), "host"),
    "bvh-packet": (lambda: mesh(ACCEL_BVH), "tabs"),
}


@pytest.mark.parametrize("case", sorted(RENDER_CASES))
def test_two_process_render_matches_single(tmp_path, case):
    make, kind = RENDER_CASES[case]
    sc = make()
    cfg = RenderConfig(spp=1)
    samples = make_samples(sc, cfg, torch.Generator().manual_seed(5))
    accel = None
    if kind is not None:
        ab = Renderer(sc, cfg, device="cpu").accel_build
        accel = ab.host if kind == "host" else ab.tabs
    ref = render_from_samples(sc, cfg, samples,
                              inter=accel_intersectors(sc, cfg, accel))
    out = spawn(tmp_path, "render", dict(scene=sc, cfg=cfg, samples=samples,
                                          accel=accel))
    assert float(ref.std()) > 0.02
    for res in out:  # every rank holds the whole image
        assert res["img"].shape == tuple(ref.shape)
        np.testing.assert_allclose(res["img"], ref.numpy(), rtol=0,
                                   atol=1e-6)


def test_two_process_grid_step_lowers_loss(tmp_path):
    """``test_sharded_accel_train_step``'s check on a grid scene's
    ``CudaGrid`` tables (K7's plain version picks the winners): the loss
    falls at each of 4 steps, by 5% over them."""
    sc = mesh(ACCEL_GRID)
    cfg = RenderConfig(spp=1)
    tabs = Renderer(sc, cfg, device="cpu").tabs
    samples = make_samples(sc, cfg, torch.Generator().manual_seed(7))
    goal = dataclasses.replace(sc, mat_cd=sc.mat_cd * 0.6)
    target = render_from_samples(goal, cfg, samples,
                                 inter=accel_intersectors(goal, cfg, tabs))
    out = spawn(tmp_path, "train", dict(
        scene=sc, cfg=cfg, samples=samples, target=target, lr=1.0, steps=4,
        accel=tabs))
    losses = out[0]["losses"]
    assert all(b < a for a, b in zip(losses, losses[1:])), losses
    assert losses[-1] < losses[0] * 0.95, losses
    np.testing.assert_array_equal(out[1]["losses"], losses)
