"""The port's progressive accumulation vs the JAX package's
``Renderer.progressive_step``: the JAX draws of each frame's key (split
into four: pixel, light, lens, time) go through the port's
``Renderer.render_with_samples`` and ``progressive_update``."""

import jax
import numpy as np
import pytest
import torch

from distributionraytracer_tpu.config import RenderConfig as JaxConfig
from distributionraytracer_tpu.integrator.render import (
    SampleSet as JaxSampleSet,
)
from distributionraytracer_tpu.ops import sampling as jax_sampling
from distributionraytracer_tpu.renderer import Renderer as JaxRenderer
from distributionraytracer_tpu_torch.config import RenderConfig
from distributionraytracer_tpu_torch.integrator.render import (
    progressive_samples, progressive_update,
)
from distributionraytracer_tpu_torch.renderer import Renderer

from test_whitted import small_scene
from torch_port_util import to_port, torch_samples

torch.set_num_threads(1)

FRAMES = 3
# name: the configuration's knobs; cap2 stops updating after two frames
CASES = {
    "default": dict(spp=1),
    "cap2": dict(spp=1, max_samples=2),
    "motion": dict(spp=1, motion_blur=True),
}


def jax_frame_samples(scene, cfg, key):
    """The draws of ``distributionraytracer_tpu.renderer.Renderer.
    progressive_step`` (renderer.py:433-446) for ``key``."""
    st = scene.static
    H, W = st.res_y, st.res_x
    k1, k2, k3, k4 = jax.random.split(key, 4)
    return JaxSampleSet(
        pixel=jax.random.uniform(k1, (H, W, 1, 2)),
        light=jax.random.uniform(k2, (H, W, 1, 2)),
        lens=jax_sampling.unit_disk(k3, (H, W, 1)),
        time=(jax.random.uniform(k4, (H, W, 1)) if cfg.motion_blur
              else np.zeros((H, W, 1), np.float32)))


@pytest.mark.parametrize("case", sorted(CASES))
def test_progressive_step_matches_jax(case):
    scene = small_scene(with_quad_light=True, glass=True)
    jr = JaxRenderer(scene, JaxConfig(**CASES[case]))
    r = Renderer(to_port(scene), RenderConfig(**CASES[case]), device="cpu")
    jstate, state = jr.progressive_init(), r.progressive_init()
    key = jax.random.PRNGKey(7)
    for i in range(1, FRAMES + 1):
        fk = jax.random.fold_in(key, i)
        jstate = jr.progressive_step(jstate, fk)
        samples = torch_samples(jax_frame_samples(scene, jr.cfg, fk))
        state = progressive_update(r.cfg, state,
                                   r.render_with_samples(samples))
        assert float(state[1]) == float(jstate[1]) == min(
            i, CASES[case].get("max_samples", FRAMES))
        ref = np.asarray(jstate[0])
        assert ref.std() > 0.01
        np.testing.assert_allclose(state[0].numpy(), ref, atol=2e-3)


def test_progressive_step_is_its_samples_and_update():
    """``Renderer.progressive_step`` is ``progressive_update`` of the frame
    its generator's draws render, the decomposition the test above holds."""
    scene = to_port(small_scene())
    r = Renderer(scene, RenderConfig(spp=1, max_samples=2), device="cpu")
    s_a, s_b = r.progressive_init(), r.progressive_init()
    for i in range(3):
        s_a = r.progressive_step(s_a, torch.Generator().manual_seed(i))
        frame = r.render_with_samples(progressive_samples(
            r.scene, r.cfg, torch.Generator().manual_seed(i)))
        s_b = progressive_update(r.cfg, s_b, frame)
        assert torch.equal(s_a[0], s_b[0]) and torch.equal(s_a[1], s_b[1])
    assert float(s_a[1]) == 2.0
