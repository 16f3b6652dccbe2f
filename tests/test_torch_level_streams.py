"""The tree loop's in-place expansion on the CPU: the plain K3's next-level
ray streams against the old ``interleave`` + ``flat`` + ``ray_streams``
chain (``torch_level_chain.py``), level by level; K3-route tiles against
the old expansion, bit for bit; a one-kind tree against the JAX
package."""

import numpy as np
import pytest
import torch

from distributionraytracer_tpu.config import RenderConfig as JaxConfig
from distributionraytracer_tpu.renderer import _render_none
from distributionraytracer_tpu.scene.builder import (
    SceneBuilder as JaxSceneBuilder,
)
from distributionraytracer_tpu_torch.config import RenderConfig
from distributionraytracer_tpu_torch.integrator.render import (
    _rays_from_samples, make_samples, render_from_samples,
)
from distributionraytracer_tpu_torch.integrator.whitted import (
    _tree_shape, levels_in_place, trace_whitted,
)
from distributionraytracer_tpu_torch.ops import cuda_intersect as CI
from distributionraytracer_tpu_torch.ops import cuda_whitted as CW
from distributionraytracer_tpu_torch.scene import (
    SceneBuilder, create_random_scene,
)
from distributionraytracer_tpu_torch.utils import spans

from test_torch_render import shared_samples
from torch_level_chain import old_next_streams, old_trace_k3
from torch_port_util import torch_samples
from torch_scenes import one_kind_scene, with_skybox

torch.set_num_threads(1)

SCENES = {
    "random": lambda: create_random_scene(0, 16, 12),
    "refl": lambda: one_kind_scene(SceneBuilder, "refl"),
    "refr": lambda: one_kind_scene(SceneBuilder, "refr"),
}
KINDS = {"random": ("refr", "refl"), "refl": ("refl",), "refr": ("refr",)}


def _tile(scene, cfg, seed=4):
    """The primary rays (o, d, time, light_sample) of the scene's frame."""
    samples = make_samples(scene, cfg, torch.Generator().manual_seed(seed))
    return _rays_from_samples(scene, cfg, samples)


def _level_args(rays):
    """``fused_level``'s arguments from a level's (11, n*R) streams."""
    return (rays[0:3].T.contiguous(), rays[3:6].T.contiguous(), rays[6],
            rays[7], rays[8:10].T.contiguous(), rays[10] != 0.0)


@pytest.mark.parametrize("name", sorted(SCENES))
def test_plain_next_streams_equal_the_old_chain(name):
    """Each spawn level's plain ``next`` streams equal those the old chain
    builds from the same level's dict, element for element on the valid
    lanes; the valid row equals it everywhere, 0 on dead children; the
    combine's rows are the dict's."""
    scene = SCENES[name]()
    cfg = RenderConfig(spp=2)
    kinds, levels = _tree_shape(scene, cfg)
    assert kinds == KINDS[name] and levels == 5
    o, d, t, ls = _tile(scene, cfg)
    R, tb = o.shape[0], CW.level_tables(scene)
    ones = torch.ones(R)
    rays = CI.ray_streams(R, o[:, 0], o[:, 1], o[:, 2], d[:, 0], d[:, 1],
                          d[:, 2], t, ones, ls[:, 0], ls[:, 1], ones)
    live = []
    for _ in range(levels - 1):
        nxt = torch.full((11, len(kinds) * rays.shape[1]), float("nan"))
        out = CW.level_into_plain(scene, cfg, rays, nxt, R, kinds, tb)
        res = CW.fused_level_plain(scene, cfg, *_level_args(rays),
                                   spawn=True, tables=tb)
        want = old_next_streams(res, kinds, R)
        v = want[10] != 0.0
        assert torch.equal(nxt[10], want[10])
        assert torch.equal(nxt[:, v], want[:, v])
        parent_dead = ~(rays[10] != 0.0)
        assert not bool(nxt[10].reshape(-1, len(kinds), R).transpose(
            1, 2).reshape(-1, len(kinds))[parent_dead].any())
        assert torch.equal(out[0:3], res["direct"].T)
        assert torch.equal(out[3] > 0.0, res["_hit"])
        assert torch.equal(out[4:7], res["refr_weight"].T)
        assert torch.equal(out[7:10], res["refl_weight"].T)
        live.append(int(v.sum()))
        rays = nxt
    assert all(n > 0 for n in live), live
    last = CW.level_into_plain(scene, cfg, rays, None, R, kinds, tb)
    res = CW.fused_level_plain(scene, cfg, *_level_args(rays), spawn=False,
                               tables=tb)
    assert last.shape == (4, rays.shape[1])
    assert torch.equal(last[0:3], res["direct"].T)


CASES = {
    "random": dict(),
    "refl": dict(),
    "refr": dict(),
    "random-skybox": dict(skybox=True),
    "random-grid": dict(grid=True),
    "random-grid-off": dict(grid=True, kernels="off"),
    "random-depth-2": dict(max_depth=2),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_k3_tiles_equal_the_old_expansion(case):
    """``trace_whitted``'s K3 route (plain K3 on the CPU) gives the old
    expansion's colours bit for bit, and counts ``whitted.levels_in_place``
    once a spawn level."""
    kw = dict(CASES[case])
    scene = SCENES[case.split("-")[0]]()
    if kw.pop("skybox", False):
        scene = with_skybox(scene)
    grid = kw.pop("grid", False)
    box = ((np.array([-12, -2, -12], np.float32),
            np.array([12, 3, 12], np.float32)) if grid else None)
    cfg = RenderConfig(spp=2, **kw)
    rays = _tile(scene, cfg, seed=len(case))
    tb = CW.level_tables(scene)
    want = old_trace_k3(scene, cfg, *rays, tb, box)
    spans.collect()
    spans.enable()
    try:
        with spans.span("render.tile"):
            got, _ = trace_whitted(scene, cfg, *rays, tables=tb,
                                   fused_grid=box)
    finally:
        spans.disable()
    counts = {c["name"]: c["n"] for c in spans.collect()["counts"]}
    assert torch.equal(got, want)
    assert float(got.std()) > 0.01
    spawning = cfg.max_depth
    assert counts["whitted.levels_in_place"] == spawning
    assert levels_in_place(scene, cfg) == spawning


@pytest.mark.parametrize("kind", ["refl", "refr"])
def test_one_kind_tree_matches_jax(kind):
    """A tree that spawns one child kind (``b = 1``) on the CPU's K3 route
    against the JAX package's frame."""
    scene = one_kind_scene(JaxSceneBuilder, kind)
    samples = shared_samples(scene, 2, seed=7)
    ref, ref_rays = _render_none(scene.device_put(), JaxConfig(spp=2),
                                 samples, True)
    port = one_kind_scene(SceneBuilder, kind)
    img, nrays = render_from_samples(port, RenderConfig(spp=2, tile_rays=96),
                                     torch_samples(samples),
                                     return_rays=True)
    ref = np.asarray(ref)
    assert img.shape == ref.shape and ref.std() > 0.01
    np.testing.assert_allclose(img.numpy(), ref, atol=2e-3)
    assert int(nrays) == int(ref_rays)
