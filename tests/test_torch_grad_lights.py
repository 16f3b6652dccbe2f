"""Gradients through a quad light and through a skybox against ``jax.grad``.

``test_grad.py``'s quad-light-and-skybox test reads a reference scene file
that the repository does not hold; these hold the port to the JAX package
on in-repo scenes instead: ``small_scene(with_quad_light=True)`` (a 16-
sample quad light and a point light) and ``test_torch_render``'s
``sky_scene`` (a skybox with faces of unequal sizes, a quad and a point
light), spp 2, one SampleSet for both.  The gradients of ``mat_cd`` and
``light_pos`` of a positively weighted sum of the image (each channel by
``1.5 + cos(k)``), by plain autodiff on both ``kernels`` routes (``auto``:
K3's plain version; ``off``: the staged plain route), against ``jax.grad``
of the JAX render: the loss within rel 1e-5, each gradient within 1e-4 of
the largest element of JAX's."""

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

from test_torch_render import shared_samples, sky_scene
from test_whitted import small_scene
from torch_port_util import to_port, torch_samples

torch.set_num_threads(1)

SPP = 2
LEAVES = ("mat_cd", "light_pos")
SCENES = {"quad": lambda: small_scene(with_quad_light=True),
          "sky": sky_scene}


def _weights(shape, xp):
    return 1.5 + xp.cos(xp.arange(int(np.prod(shape)))).reshape(shape)


@pytest.fixture(scope="module", params=sorted(SCENES))
def case(request):
    js = SCENES[request.param]()
    samples = shared_samples(js, SPP, seed=6)
    jd = js.device_put()
    cfg = JaxConfig(spp=SPP)

    def loss(leaves):
        img = jax_render(dataclasses.replace(jd, **leaves), cfg, samples)
        return jnp.sum(img * _weights(img.shape, jnp))

    value, grads = jax.jit(jax.value_and_grad(loss))(
        {n: getattr(jd, n) for n in LEAVES})
    return (js, samples, float(value),
            {n: np.asarray(g) for n, g in grads.items()})


@pytest.mark.parametrize("kernels", ["auto", "off"])
@pytest.mark.parametrize("leaf", LEAVES)
def test_quad_light_and_skybox_gradients_match_jax(case, leaf, kernels):
    js, samples, ref_loss, ref = case
    port = to_port(js)
    x = getattr(port, leaf).clone().requires_grad_(True)
    img = render_from_samples(dataclasses.replace(port, **{leaf: x}),
                              RenderConfig(spp=SPP, kernels=kernels),
                              torch_samples(samples))
    loss = (img * _weights(img.shape, torch).to(torch.float32)).sum()
    assert abs(float(loss.detach()) - ref_loss) <= 1e-5 * abs(ref_loss)
    (g,) = torch.autograd.grad(loss, x)
    g, r = g.numpy(), ref[leaf]
    assert np.isfinite(g).all(), f"non-finite gradient for {leaf}"
    scale = float(np.abs(r).max())
    assert scale > 1e-2, (leaf, scale)
    np.testing.assert_allclose(g, r, rtol=0, atol=1e-4 * scale)
