"""The port's cubemap lookups vs the JAX package, on synthetic faces of
unequal sizes: the reference skybox convention (``skybox_color``) and the
OpenGL one of the path tracer (``gl_cubemap_color``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributionraytracer_tpu.ops import cubemap as JC
from distributionraytracer_tpu_torch.ops import cubemap as C

from torch_scenes import synthetic_faces

torch.set_num_threads(1)


def directions(n=4096, seed=0):
    """Random directions (some unnormalised), then the ties the lookups
    break by rule: |x| = |y|, |x| = |z|, |y| = |z|, axis rays of both signs,
    and signed zeros."""
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n, 3)) * rng.uniform(0.5, 2.0, (n, 1))
    ties = []
    for s in (1.0, -1.0):
        for a, b, c in ((1, 1, 0.3), (1, 0.3, 1), (0.3, 1, 1), (1, 1, 1)):
            ties += [[s * a, b, -c], [-a, s * b, c], [a, -b, s * c]]
        ties += [[s, 0, 0], [0, s, 0], [0, 0, s], [s * 0.0, 1e-3, 0]]
    return np.concatenate([d, ties]).astype(np.float32)


@pytest.mark.parametrize("which", ["skybox_color", "gl_cubemap_color"])
def test_cubemap_lookup_matches_jax(which):
    faces, res = synthetic_faces(1)
    d = directions()
    ref = np.asarray(getattr(JC, which)(jnp.asarray(faces), jnp.asarray(res),
                                        jnp.asarray(d)))
    got = getattr(C, which)(torch.from_numpy(faces), torch.from_numpy(res),
                            torch.from_numpy(d))
    assert got.dtype == torch.float32 and got.shape == d.shape
    np.testing.assert_array_equal(got.numpy(), ref)
    # every face is reached, and no lookup lands in a face's padding
    assert len(np.unique(ref.round(1), axis=0)) > 6
    assert (ref.max(-1) > 0).all()


def test_cubemap_lookups_keep_their_conventions():
    """+X is LEFT in the reference convention (scene.cpp:395) and face 0 in
    OpenGL's; the texel is int((w-1)*s) in the first, int(w*s) in the
    second."""
    faces, res = synthetic_faces(2)
    f, r = torch.from_numpy(faces), torch.from_numpy(res)
    px = torch.tensor([[1.0, 0.0, 0.0]])
    w1, h1 = res[C.LEFT]
    assert torch.equal(C.skybox_color(f, r, px)[0],
                       f[C.LEFT, int((h1 - 1) * 0.5), int((w1 - 1) * 0.5)])
    w0, h0 = res[0]
    assert torch.equal(C.gl_cubemap_color(f, r, px)[0],
                       f[0, int(h0 * 0.5), int(w0 * 0.5)])
