"""Shared helpers of the tests that hold the torch port against the JAX
package: scene carry-over and shared sample arrays."""

import dataclasses

import numpy as np
import torch

from distributionraytracer_tpu.scene import builder as jax_builder
from distributionraytracer_tpu.scene.types import SceneData as JaxSceneData
from distributionraytracer_tpu_torch.integrator.render import (
    SampleSet as TorchSampleSet,
)
from distributionraytracer_tpu_torch.scene.types import scene_from_numpy

import torch_scenes


def to_port(scene):
    """The JAX package's scene as a CPU scene of the port."""
    leaves = {n: np.asarray(getattr(scene, n))
              for n in JaxSceneData._LEAF_NAMES}
    return scene_from_numpy(leaves, dataclasses.asdict(scene.static))


def leaves_equal(jax_scene, port_scene):
    for n in JaxSceneData._LEAF_NAMES:
        a = np.asarray(getattr(jax_scene, n))
        b = getattr(port_scene, n).numpy()
        assert a.dtype == b.dtype, (n, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=n)
    assert dataclasses.asdict(jax_scene.static) == dataclasses.asdict(
        port_scene.static)


def torch_samples(samples) -> TorchSampleSet:
    """A JAX SampleSet's arrays as a CPU SampleSet of the port."""
    t = lambda a: torch.from_numpy(np.array(a, np.float32))
    return TorchSampleSet(t(samples.pixel), t(samples.light),
                          t(samples.lens), t(samples.time))


def prim_scene(ties=False, twice=False):
    """``torch_scenes.prim_scene`` built by the JAX package."""
    return torch_scenes.prim_scene(jax_builder.SceneBuilder, ties=ties,
                                   twice=twice)
