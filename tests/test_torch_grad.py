"""Gradients through the port's render against the JAX package's, on the
CPU: ``test_grad``'s cosine loss on ``small_scene(glass=True)`` at spp 1,
the same SampleSet given to both packages, both ``kernels`` modes (``auto``
runs the plain fused-level route, ``off`` the staged plain route)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributionraytracer_tpu.config import RenderConfig as JaxConfig
from distributionraytracer_tpu.integrator.render import (
    render_from_samples as jax_render,
)
from distributionraytracer_tpu_torch.config import RenderConfig
from distributionraytracer_tpu_torch.integrator.render import (
    render_from_samples,
)

from test_torch_render import shared_samples
from test_whitted import small_scene
from torch_port_util import to_port, torch_samples

torch.set_num_threads(1)

LEAVES = ("mat_cd", "mat_kd", "light_pos", "cam_eye", "sph_center")
# Both packages take the same f32 arithmetic in another operation order:
# each gradient element within RTOL of the largest |element| of JAX's.
RTOL = 1e-3


@pytest.fixture(scope="module")
def case():
    """The JAX scene, its SampleSet and JAX's gradients of the loss with
    respect to every leaf (one trace)."""
    scene = small_scene(glass=True)
    samples = shared_samples(scene, 1, seed=2)
    js = scene.device_put()
    cfg = JaxConfig(spp=1)

    def loss(leaves):
        img = jax_render(dataclasses.replace(js, **leaves), cfg, samples)
        return jnp.sum(img * jnp.cos(jnp.arange(img.size).reshape(img.shape)))

    grads = jax.jit(jax.grad(loss))({n: getattr(js, n) for n in LEAVES})
    return scene, samples, {n: np.asarray(g) for n, g in grads.items()}


@pytest.mark.parametrize("kernels", ["auto", "off"])
@pytest.mark.parametrize("leaf", LEAVES)
def test_port_grad_matches_jax(case, leaf, kernels):
    scene, samples, ref = case
    port = to_port(scene)
    x = getattr(port, leaf).clone().requires_grad_(True)
    img = render_from_samples(dataclasses.replace(port, **{leaf: x}),
                              RenderConfig(spp=1, kernels=kernels),
                              torch_samples(samples))
    w = torch.cos(torch.arange(img.numel(), dtype=torch.float32))
    (g,) = torch.autograd.grad((img * w.reshape(img.shape)).sum(), x)
    g, r = g.numpy(), ref[leaf]
    assert np.isfinite(g).all(), f"non-finite gradient for {leaf}"
    scale = float(np.abs(r).max())
    assert scale > 1e-2, (leaf, scale)
    np.testing.assert_allclose(g, r, rtol=0, atol=RTOL * scale)
