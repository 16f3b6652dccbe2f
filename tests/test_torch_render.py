"""The port's Whitted slice vs the JAX package: render_from_samples on
shared SampleSets (with and without a skybox), ray counts, Renderer,
progressive checkpoints, the CLI, the no-jax import, the card as the
default device, and the kernels' refusal of CPU tensors."""

import dataclasses
import functools
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from distributionraytracer_tpu.config import RenderConfig as JaxConfig
from distributionraytracer_tpu.integrator.render import (
    SampleSet as JaxSampleSet, make_samples as jax_make_samples,
)
from distributionraytracer_tpu.renderer import Renderer as JaxRenderer
from distributionraytracer_tpu.renderer import _render_none
from distributionraytracer_tpu.scene.builder import (
    SceneBuilder as JaxSceneBuilder,
)
from distributionraytracer_tpu.scene.procedural import (
    create_random_scene as jax_random_scene,
)
from distributionraytracer_tpu_torch import cli
from distributionraytracer_tpu_torch.config import RenderConfig
from distributionraytracer_tpu_torch.integrator.render import (
    default_config, make_samples, render_from_samples,
)
from distributionraytracer_tpu_torch.integrator.whitted import (
    brute_intersectors, level_route,
)
from distributionraytracer_tpu_torch.ops import cuda_intersect as CI
from distributionraytracer_tpu_torch.ops import cuda_whitted as CW
from distributionraytracer_tpu_torch.renderer import Renderer
from distributionraytracer_tpu_torch.scene import (
    ACCEL_BVH, ACCEL_GRID, SceneBuilder, create_random_scene,
)
from distributionraytracer_tpu_torch.utils.image import read_png

from test_whitted import assert_images_close, small_scene
from torch_port_util import prim_scene, to_port, torch_samples
from torch_scenes import (
    crowd_scene, mesh_scene, stacked_scene, synthetic_faces,
)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def shared_samples(scene, spp, seed=0, motion=False):
    st = scene.static
    H, W, S = st.res_y, st.res_x, spp
    rng = np.random.default_rng(seed)
    f = lambda a: jnp.asarray(a, jnp.float32)
    return JaxSampleSet(
        pixel=f(rng.random((H, W, S, 2))), light=f(rng.random((H, W, S, 2))),
        lens=f(rng.random((H, W, S, 2)) * 2 - 1),
        time=f(rng.random((H, W, S)) if motion else np.zeros((H, W, S))))


SCENES = {
    "point": lambda: small_scene(),
    "quad": lambda: small_scene(with_quad_light=True),
    "glass": lambda: small_scene(glass=True),
    "random": lambda: jax_random_scene(0, 16, 12),
}


@pytest.mark.parametrize("kernels", ["auto", "off"])
@pytest.mark.parametrize("name", sorted(SCENES))
def test_render_from_samples_matches_jax(name, kernels):
    """Port vs JAX on the same SampleSet: kernels='auto' runs the fused
    level route (plain K3 on CPU), 'off' the staged plain route."""
    scene = SCENES[name]()
    spp = 4 if name == "quad" else 1
    samples = shared_samples(scene, spp, seed=len(name))
    ref, ref_rays = _render_none(scene.device_put(), JaxConfig(spp=spp),
                                 samples, True)
    cfg = RenderConfig(spp=spp, kernels=kernels, tile_rays=128)
    img, nrays = render_from_samples(to_port(scene), cfg,
                                     torch_samples(samples), return_rays=True)
    ref = np.asarray(ref)
    assert img.shape == ref.shape and ref.std() > 0.01
    np.testing.assert_allclose(img.numpy(), ref, atol=2e-3)
    assert int(nrays) == int(ref_rays)


# Whole-frame configurations: small_scene with a quad light and glass,
# given a lens (aperture 8 pixels, focus at 0.8 of the image plane) so that
# depth of field blurs.  name: the configuration's knobs.
CONFIG_CASES = {
    "dof": dict(spp=4, dof=True),
    "shadow-correct": dict(spp=4, shadow_mode="correct"),
    "spp0": dict(spp=0),
    "no-static-prune": dict(spp=4, static_prune=False),
    "max-depth-2": dict(spp=4, max_depth=2),
    "dof-motion-blur": dict(spp=4, dof=True, motion_blur=True),
}


@functools.lru_cache(maxsize=None)
def _config_case(name):
    """(scene, JAX SampleSet, JAX image, JAX ray count) of a case; the
    samples are the JAX package's make_samples draw (spp 0: pixel centres
    and the quad light's regular grid)."""
    scene = small_scene(with_quad_light=True, glass=True)
    scene = dataclasses.replace(scene, static=dataclasses.replace(
        scene.static, aperture_ratio=8.0, focal_ratio=0.8))
    js = scene.device_put()
    cfg = JaxConfig(**CONFIG_CASES[name])
    samples = jax_make_samples(js, cfg, jax.random.PRNGKey(len(name)))
    img, rays = _render_none(js, cfg, samples, True)
    return scene, samples, np.asarray(img), int(rays)


@pytest.mark.parametrize("kernels", ["auto", "off"])
@pytest.mark.parametrize("case", sorted(CONFIG_CASES))
def test_render_configurations_match_jax(case, kernels):
    """Port vs JAX on the same SampleSet, per whole-frame configuration."""
    scene, samples, ref, ref_rays = _config_case(case)
    cfg = RenderConfig(kernels=kernels, tile_rays=512, **CONFIG_CASES[case])
    img, nrays = render_from_samples(to_port(scene), cfg,
                                     torch_samples(samples), return_rays=True)
    assert img.shape == ref.shape and ref.std() > 0.01
    np.testing.assert_allclose(img.numpy(), ref, atol=2e-3)
    assert int(nrays) == ref_rays


def test_render_motion_blur_matches_jax():
    scene = small_scene()
    samples = shared_samples(scene, 2, seed=9, motion=True)
    ref = _render_none(scene.device_put(),
                       JaxConfig(spp=2, motion_blur=True), samples)
    img = render_from_samples(to_port(scene),
                              RenderConfig(spp=2, motion_blur=True),
                              torch_samples(samples))
    np.testing.assert_allclose(img.numpy(), np.asarray(ref), atol=2e-3)


def test_renderer_end_to_end():
    scene = create_random_scene(0, 24, 18)
    cfg = default_config(scene, spp=4)
    r = Renderer(scene, cfg, device="cpu")
    assert r.executed_backend() == "fused-level"
    img, nrays = r.render(torch.Generator().manual_seed(1), return_rays=True)
    assert img.shape == (18, 24, 3) and img.dtype == torch.float32
    assert torch.isfinite(img).all() and img.std() > 0.05
    assert int(nrays) > 24 * 18 * 4
    # the staged route (K1/K2 wrappers + _shade_node) on the same samples
    samples = make_samples(r.scene, cfg, torch.Generator().manual_seed(1))
    staged = render_from_samples(r.scene, cfg, samples,
                                 inter=brute_intersectors(r.scene, cfg))
    assert_images_close(img.numpy(), staged.numpy())
    off = Renderer(scene, cfg.replace(kernels="off"), device="cpu")
    assert off.executed_backend() == "plain"
    again = off.render(torch.Generator().manual_seed(1))
    assert_images_close(img.numpy(), again.numpy())


def test_no_object_bound_on_kernel_routes():
    """The CUDA kernels read their tables from global memory: a scene past
    the TPU kernels' 1024-object table keeps the kernel routes."""
    scene = crowd_scene(SceneBuilder)
    assert scene.static.n_objects > 1024
    assert level_route(scene, RenderConfig()) == "fused-level"
    dark = dataclasses.replace(scene, static=dataclasses.replace(
        scene.static, n_lights=0, light_quad=(), light_grid=()))
    assert level_route(dark, RenderConfig()) == "brute-kernel"
    assert level_route(scene, RenderConfig(kernels="off")) == "plain"


def test_brute_kernel_route_without_lights():
    scene = to_port(prim_scene())
    dark = dataclasses.replace(scene, static=dataclasses.replace(
        scene.static, n_lights=0, light_quad=(), light_grid=()))
    dark.light_pos = dark.light_pos[:0]
    dark.light_e1, dark.light_e2 = dark.light_e1[:0], dark.light_e2[:0]
    r = Renderer(dark, RenderConfig(spp=1), device="cpu")
    assert r.executed_backend() == "brute-kernel"
    img = r.render()
    off = Renderer(dark, RenderConfig(spp=1, kernels="off"),
                   device="cpu").render()
    assert torch.equal(img, off)


def test_progressive_checkpoint_round_trip(tmp_path):
    scene = create_random_scene(0, 16, 12)
    r = Renderer(scene, default_config(scene), device="cpu")
    g = torch.Generator().manual_seed(3)
    state = r.progressive_init()
    for _ in range(3):
        state = r.progressive_step(state, g)
    assert float(state[1]) == 3.0
    p = str(tmp_path / "ckpt.npz")
    r.save_progressive(p, state)
    state2 = r.load_progressive(p)
    assert torch.equal(state[0], state2[0])
    g_a = torch.Generator().manual_seed(4)
    g_b = torch.Generator().manual_seed(4)
    s_cont = r.progressive_step(state, g_a)
    s_res = r.progressive_step(state2, g_b)
    assert torch.equal(s_cont[0], s_res[0]) and float(s_res[1]) == 4.0


def test_cli_render_random_writes_png(tmp_path, capsys):
    out = str(tmp_path / "rt.png")
    cli.main(["render", "random", "--res", "16", "12", "--spp", "1",
              "--device", "cpu", "-o", out])
    assert "backend: fused-level" in capsys.readouterr().out
    img = read_png(out)
    assert img.shape == (12, 16, 3) and img.std() > 0.05
    assert Image.open(out).size == (16, 12)


def test_port_imports_without_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import distributionraytracer_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    if not m.name.endswith('__main__'):\n"
        "        importlib.import_module(m.name)\n"
        "bad = sorted(k for k in sys.modules if k == 'jax'\n"
        "             or k.startswith(('jax.', 'distributionraytracer_tpu.')))\n"
        "assert not bad, bad\n"
        "for m in ('ops.cuda_whitted', 'ops.cuda_pt', 'ops.cubemap',\n"
        "          'integrator.pathtracer', 'scene.pt_scenes', 'native',\n"
        "          'accel.cuda_packet', 'accel.cuda_binned',\n"
        "          'parallel.mesh', 'viewer'):\n"
        "    assert 'distributionraytracer_tpu_torch.' + m in sys.modules\n")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=120)


def test_kernels_refuse_cpu_tensors():
    scene = to_port(prim_scene())
    o = torch.zeros((8, 3))
    d = torch.ones((8, 3))
    z = torch.zeros(8)
    v = torch.ones(8, dtype=torch.bool)
    with pytest.raises(ValueError, match="CUDA tensors"):
        CI.closest_hit_kernel(scene, o, d, z, False)
    with pytest.raises(ValueError, match="CUDA tensors"):
        CI.any_hit_kernel(scene, o, d, z, None, False)
    with pytest.raises(ValueError, match="CUDA tensors"):
        CW.fused_level_kernel(scene, RenderConfig(), o, d, z, z + 1,
                              torch.zeros((8, 3)), v, spawn=True)


def test_renderer_refusals():
    scene = create_random_scene(0, 8, 6)
    for accel in (ACCEL_GRID, ACCEL_BVH):
        # grid and BVH scenes are ported: 102 spheres and no plane take the
        # brute kernels with the accel's gates, as in the JAX package
        s = dataclasses.replace(scene, static=dataclasses.replace(
            scene.static, accel=accel))
        assert Renderer(s, device="cpu").executed_backend() == "cost-brute"
    with pytest.raises(ValueError, match="kernels"):
        RenderConfig(kernels="on")
    with pytest.raises(ValueError, match="packet_kernel"):
        RenderConfig(packet_kernel="fast")
    with pytest.raises(ValueError, match="accel_backend"):
        RenderConfig(accel_backend="kernel")  # 'auto' is the kernel route
    if torch.cuda.is_available():
        return  # the refusals below are for machines without a card
    # the card is the default, and there is no quiet CPU fallback
    for kw in ({}, {"device": "cuda"}):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            Renderer(scene, **kw)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            Renderer(s, **kw)
    for cmd in (["render", "random"], ["pathtrace"]):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cli.main(cmd + ["--res", "8", "6", "--spp", "1"])


def sky_scene():
    """Spheres under a skybox with faces of unequal sizes, seen by a camera
    that sees sky in most pixels, and in the metal and glass spheres;
    a point and a quad light."""
    b = JaxSceneBuilder()
    b.set_camera([0, 1, 5], [0, 0, 0], [0, 1, 0], 60, 0.01, 24, 18, 0, 1)
    red = b.add_material([0.9, 0.1, 0.1], 0.9, [1, 1, 1], 0.3, 50, 0, 1)
    metal = b.add_material([0, 0, 0], 0.0, [0.9, 0.8, 0.7], 0.9, 200, 0, 1)
    glass = b.add_material([0.2, 0.9, 0.2], 0.0, [1, 1, 1], 0.5, 30, 1, 1.5)
    b.add_sphere([-1.2, 0, 0], 0.6, red)
    b.add_sphere([0.2, 0, 0.3], 0.5, metal)
    b.add_sphere([1.3, 0.2, 0], 0.5, glass)
    b.add_point_light([2, 4, 2], [1, 1, 1])
    b.add_quad_light([-2, 4, 2], [1, 1, 1], [-1, 4, 2], [-2, 4, 3], 4)
    b.bg_color = np.array([0.1, 0.2, 0.4], np.float32)
    b.sky_faces, b.sky_res = synthetic_faces(4)
    return b.build()


@pytest.mark.parametrize("kernels", ["auto", "off"])
def test_whitted_skybox_matches_jax(kernels):
    """Misses take the skybox texel, as in the JAX package: on the fused
    level route (plain K3, 'auto') and the staged plain route ('off'), with
    one shared SampleSet."""
    scene = sky_scene()
    assert scene.static.has_skybox
    port = to_port(scene)
    cfg = RenderConfig(spp=2, kernels=kernels, tile_rays=128)
    assert level_route(port, cfg) == ("fused-level" if kernels == "auto"
                                      else "plain")
    samples = shared_samples(scene, 2, seed=4)
    ref = np.asarray(_render_none(scene.device_put(), JaxConfig(spp=2),
                                  samples))
    img = render_from_samples(port, cfg, torch_samples(samples)).numpy()
    bg = np.abs(ref - np.array([0.1, 0.2, 0.4], np.float32)).max(-1) < 1e-3
    assert bg.mean() < 0.05  # the sky, not the background colour
    assert_images_close(img, ref)


# ------------------------------------------------------- grid and BVH scenes
def _mesh(accel, n_tri=2000, res=(16, 16)):
    return mesh_scene(JaxSceneBuilder, n_tri=n_tri, accel=accel, res=res)


def _with_accel(scene, accel):
    return dataclasses.replace(scene, static=dataclasses.replace(
        scene.static, accel=accel))


ROUTE_SCENES = {
    # case: (JAX scene, config overrides, the label both give)
    "bvh": (lambda: _mesh(ACCEL_BVH), {}, "binned-primary+grouped-packet"),
    "grid": (lambda: _mesh(ACCEL_GRID), {}, "binned-primary+grid-packet"),
    "legacy": (lambda: _mesh(ACCEL_BVH), {"packet_kernel": "legacy"},
               "legacy-packet"),
    # K8 on the grid emulation's tree: no bins without grouped tables
    "legacy-grid": (lambda: _mesh(ACCEL_GRID), {"packet_kernel": "legacy"},
                    "grid-packet"),
    "cost-brute": (lambda: _mesh(ACCEL_BVH, n_tri=600), {}, "cost-brute"),
    # an infinite plane: no binned route, no cost-brute
    "plane-bvh": (lambda: _with_accel(crowd_scene(JaxSceneBuilder),
                                      ACCEL_BVH), {}, "grouped-packet"),
    "plane-grid": (lambda: _with_accel(crowd_scene(JaxSceneBuilder),
                                       ACCEL_GRID), {}, "grid-packet"),
}


@pytest.mark.parametrize("case", sorted(ROUTE_SCENES))
def test_executed_backend_matches_jax(case):
    """Each grid/BVH scene takes the route the JAX package takes on a TPU
    (its ``accel_backend='pallas'``), chosen by the same predicates, and
    both name it alike."""
    make, over, label = ROUTE_SCENES[case]
    js = make()
    jr = JaxRenderer(js, JaxConfig(spp=0, accel_backend="pallas", **over))
    r = Renderer(to_port(js), RenderConfig(spp=0, **over), device="cpu")
    assert r.executed_backend() == jr.executed_backend() == label


def test_bvh_renderer_matches_jax():
    """The port's Renderer on a BVH scene (the binned route: plain K9 on
    the primary level, the plain K7 walk elsewhere) vs the JAX Renderer's
    threaded walk (``accel_backend='xla'``: the same winners) on one
    SampleSet; also the legacy (K8) route."""
    js = _mesh(ACCEL_BVH)
    samples = shared_samples(js, 1, seed=6)
    ref, ref_rays = JaxRenderer(js, JaxConfig(spp=0, accel_backend="xla")
                                ).render_with_samples(samples,
                                                      return_rays=True)
    ref = np.asarray(ref)
    assert ref.std() > 0.05
    for over in ({}, {"packet_kernel": "legacy"}):
        r = Renderer(to_port(js), RenderConfig(spp=0, **over), device="cpu")
        img, nrays = r.render_with_samples(torch_samples(samples),
                                           return_rays=True)
        assert_images_close(img.numpy(), ref)
        assert int(nrays) == int(ref_rays)


def test_accel_progressive_and_xla_trees():
    """A tree with a fallback leaf of 150 objects, which the JAX package's
    packers refuse (it walks it by XLA: ``bvh-xla``, ``grid-xla``), takes
    K8 in the port; the image equals the JAX package's on one SampleSet,
    and the progressive frame takes the same route."""
    cfg = dict(spp=0, accel_cost_threshold=0)
    for accel, jax_label, label in ((ACCEL_BVH, "bvh-xla", "legacy-packet"),
                                    (ACCEL_GRID, "grid-xla", "grid-packet")):
        js = stacked_scene(JaxSceneBuilder, accel)
        jr = JaxRenderer(js, JaxConfig(accel_backend="pallas", **cfg))
        r = Renderer(to_port(js), RenderConfig(**cfg), device="cpu")
        assert jr.executed_backend() == jax_label
        assert r.executed_backend() == label
        samples = shared_samples(js, 1, seed=2)
        ref, ref_rays = jr.render_with_samples(samples, return_rays=True)
        img, nrays = r.render_with_samples(torch_samples(samples),
                                           return_rays=True)
        assert_images_close(img.numpy(), np.asarray(ref))
        assert int(nrays) == int(ref_rays)
    state = r.progressive_step(r.progressive_init(),
                               torch.Generator().manual_seed(1))
    assert float(state[1]) == 1.0 and torch.isfinite(state[0]).all()


P3F_MESH = """accel bvh
camera eye 0.5 3.2 7.5 at 0 1 0 up 0 1 0 angle 45 hither 0.01
  resolution 16 16 aperture 0 focal 1
light punctual 6 12 6 1 1 1
mat 0.75 0.6 0.35 0.7 0.9 0.85 0.8 0.35 40 0 1
"""


def test_cli_renders_a_bvh_p3f(tmp_path, capsys):
    """A BVH P3F with a mesh block (parsed by the native tokenizer) loads
    as in the JAX package, and the CLI prints its accel build and backend
    before writing the PNG."""
    from distributionraytracer_tpu.scene import load_p3f as jax_load_p3f
    from distributionraytracer_tpu_torch.scene import load_p3f
    from torch_port_util import leaves_equal

    rng = np.random.default_rng(0)
    verts = rng.uniform(-1.5, 1.5, (60, 3)) + [0, 1, 0]
    faces = rng.integers(1, 61, (40, 3))
    text = (P3F_MESH + f"mesh {len(verts)} {len(faces)}\n"
            + "\n".join(" ".join(f"{x:.6f}" for x in v) for v in verts)
            + "\n" + "\n".join(" ".join(str(i) for i in f) for f in faces)
            + "\ns 0 -1000 0 1000\n")
    path = tmp_path / "mesh.p3f"
    path.write_text(text)
    leaves_equal(jax_load_p3f(str(path)), load_p3f(str(path)))
    out = str(tmp_path / "mesh.png")
    cli.main(["render", str(path), "--device", "cpu", "-o", out])
    printed = capsys.readouterr().out
    assert "BVH:" in printed and "accel build:" in printed
    assert "native builder" in printed
    assert "backend: cost-brute" in printed
    assert read_png(out).shape == (16, 16, 3)
